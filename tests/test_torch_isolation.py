"""The torch port stands alone: it imports neither JAX nor the JAX package,
and its entry points never drop quietly to the CPU."""
import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "deeplearning4j_torch"
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
for name in %r:
    sys.modules[name] = None  # any import of it now raises ImportError
import deeplearning4j_torch
names = [m.name for m in pkgutil.walk_packages(deeplearning4j_torch.__path__,
                                               "deeplearning4j_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
print(json.dumps(sorted(names + ["chip_smoke"])))
"""


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL % (FORBIDDEN,)], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    imported = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = {".".join(p.relative_to(ROOT).with_suffix("").parts)
                for p in PKG.rglob("*.py") if p.name != "__init__.py"}
    assert expected <= set(imported)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_init_without_device_raises_when_there_is_no_gpu(monkeypatch):
    from deeplearning4j_torch.models.zoo import LeNet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LeNet().init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LeNet().init(device="cuda")
    assert LeNet().init(device="cpu").params_tree[0]["W"].device.type == "cpu"


def test_graph_and_checkpoint_entry_points_default_to_the_gpu(monkeypatch):
    """ComputationGraph.init (through zoo GoogLeNet and ResNet50),
    restore_model and init_pretrained run on CUDA unless asked for the CPU,
    and raise without a GPU."""
    from deeplearning4j_torch.models.zoo import GoogLeNet, LeNet, ResNet50
    from deeplearning4j_torch.utils import model_serializer
    lenet_zip = str(ROOT / "tests" / "fixtures" / "pretrained" / "lenet_mnist.zip")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: GoogLeNet(num_labels=10, input_shape=(32, 32, 3)).init(),
                 lambda: ResNet50(num_labels=10, input_shape=(32, 32, 3)).init(),
                 lambda: model_serializer.restore_model(lenet_zip),
                 lambda: LeNet().init_pretrained(lenet_zip)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert model_serializer.restore_model(lenet_zip, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("name", ["TextGenerationLSTM", "InceptionResNetV1",
                                  "FaceNetNN4Small2"])
def test_recurrent_and_face_zoo_models_default_to_the_gpu(monkeypatch, name):
    """The zoo models of the recurrent slice and the face models run on
    CUDA unless asked for the CPU, and raise without a GPU; their modules
    (nn/layers/recurrent.py, nn/layers/pretrain.py, models/helpers.py) are
    among those imported above with JAX blocked."""
    from deeplearning4j_torch.models import zoo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = {"TextGenerationLSTM": {}, "InceptionResNetV1": dict(
        num_labels=3, input_shape=(64, 64, 3)), "FaceNetNN4Small2": dict(num_labels=3)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(zoo, name)(**small[name]).init()
    net = getattr(zoo, name)(**small[name]).init(device="cpu")
    assert net.device.type == "cpu"


@pytest.mark.parametrize("module", [
    "optimize/metrics.py", "optimize/tracing.py", "optimize/listeners.py",
    "optimize/resilience.py", "optimize/solvers.py", "eval/evaluation.py",
    "eval/roc.py", "earlystopping/termination.py", "earlystopping/savers.py",
    "earlystopping/config.py", "earlystopping/trainer.py",
    "nn/transfer_learning.py", "nn/stepping.py", "data/iterators.py",
    "data/padding.py"])
def test_fit_loop_modules_are_the_ports_own(module):
    """The fit loop's modules exist in the port (the walk above imports
    them with JAX blocked), and none reaches into the JAX package, its
    numpy-only modules included."""
    text = (PKG / module).read_text()
    assert "deeplearning4j_tpu" not in text.replace("`deeplearning4j_tpu/", "")


def test_staging_and_restores_default_to_the_gpu(monkeypatch, tmp_path):
    """Device prefetch, the pinned stager and the checkpoint and best-model
    restores run on CUDA unless asked for the CPU, and raise without a
    GPU rather than staging onto the CPU."""
    from deeplearning4j_torch.data.iterators import (DevicePrefetchIterator,
                                                     ExistingDataSetIterator,
                                                     PinnedStager)
    from deeplearning4j_torch.earlystopping import LocalFileModelSaver
    from deeplearning4j_torch.models.zoo import LeNet
    from deeplearning4j_torch.optimize.resilience import CheckpointManager
    net = LeNet().init(device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(net)
    saver = LocalFileModelSaver(str(tmp_path / "best"))
    saver.save_best_model(net, 1.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: PinnedStager(),
                 lambda: DevicePrefetchIterator(ExistingDataSetIterator([])),
                 lambda: mgr.restore_latest(),
                 lambda: LocalFileModelSaver(str(tmp_path / "best")).get_best_model()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert mgr.restore_latest(device="cpu")[0].device.type == "cpu"
    assert saver.get_best_model().device.type == "cpu"   # where it was saved from


@pytest.mark.parametrize("module", ["serving/__init__.py", "serving/decode.py",
                                    "ops/flash_attention.py",
                                    "parallel/inference.py"])
def test_decode_modules_are_the_ports_own(module):
    """The decode plane's modules and the wrapper of its kernel (K7,
    ops/csrc/decode_attention.cu) exist in the port, are among those the
    walk above imports with JAX blocked, and none reaches into the JAX
    package."""
    text = (PKG / module).read_text()
    assert "deeplearning4j_tpu" not in text.replace("`deeplearning4j_tpu/", "")
    assert (PKG / "ops" / "csrc" / "decode_attention.cu").exists()


def test_decode_entry_points_default_to_the_gpu(monkeypatch):
    """TransformerDecoder, PagedKVCache and DecodeEngine run on CUDA unless
    asked for the CPU, and raise without a GPU; the engine refuses an
    adapter on another device than its own."""
    from deeplearning4j_torch.serving.decode import (DecodeEngine, PagedKVCache,
                                                     TransformerAdapter,
                                                     TransformerDecoder)
    model = TransformerDecoder(vocab=8, layers=1, heads=1, head_dim=2, ff=4,
                               max_context=16, device="cpu")
    cache = PagedKVCache(layers=1, heads=1, head_dim=2, device="cpu")
    adapter = TransformerAdapter(model, cache, pack_bucket=8)
    assert model.top["emb"].device.type == "cpu" and cache.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TransformerDecoder(vocab=8, layers=1, heads=1, head_dim=2,
                                            ff=4),
                 lambda: PagedKVCache(layers=1, heads=1, head_dim=2),
                 lambda: DecodeEngine(adapter)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    eng = DecodeEngine(adapter, device="cpu")
    eng.shutdown()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="adapter runs on"):
        DecodeEngine(adapter, device="cuda")
