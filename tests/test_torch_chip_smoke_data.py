"""chip_smoke.py's data and pretraining phases, run on the CPU at a small size.

- `phase_image_directory_alexnet` on 24 PPMs of 72 px in 3 label folders,
  read at 60 px at batch 8 with 1 and 2 ETL workers into a narrow CNN in
  AlexNet's place (two convs, each followed by an LRN as in AlexNet; 10
  labels), K1 and K2 replaced by counting stand-ins (the plain versions,
  each call counting a launch as the kernels' wrappers do): it passes, and
  fails when an LRN call goes uncounted or the numpy ETL arm carries it.
- `phase_vae_mnist` at widths 16 (latent 2) over 512 synthesized MNIST
  images, and `phase_dbn_mnist` on a 64-32-16 RBM/AE stack over 512: both
  pass; `check_cd_step` fails on an RBM whose statistics are not its
  chain's.
- `phase_records_export` passes.

Kept apart from tests/test_torch_chip_smoke.py, whose run is the longest of
the suite on one worker.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_torch import (ConvolutionLayer, InputType,
                                  LocalResponseNormalization, MultiLayerNetwork,
                                  NeuralNetConfiguration, OutputLayer,
                                  SubsamplingLayer, native_etl)
from deeplearning4j_torch.models import zoo as port_zoo
from deeplearning4j_torch.nn.layers import pretrain as port_pretrain
from deeplearning4j_torch.ops import lrn as port_lrn

IMAGE_SMALL = dict(folders=3, images=24, src_px=72, out_px=60, batch=8,
                   classes=10, workers=(1, 2))
VAE_SMALL = dict(n_train=512, encoder=(16,), decoder=(16,), latent=2, batch=128,
                 profiled_steps=2)
DBN_SMALL = dict(n_train=512, widths=(64, 32, 16), batch=128)


class _NarrowCNN:
    """AlexNet's role at a CPU test's size: conv, LRN, pool twice, then a
    softmax head, built from the same arguments as zoo AlexNet."""

    def __init__(self, input_shape, num_labels):
        self.input_shape, self.num_labels = input_shape, num_labels

    def init(self, device=None):
        h, w, c = self.input_shape
        conf = (NeuralNetConfiguration.builder().seed(3).list()
                .layer(ConvolutionLayer(kernel_size=(5, 5), stride=(2, 2), n_out=8,
                                        activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(kernel_size=(3, 3), n_out=8,
                                        activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(OutputLayer(n_out=self.num_labels, activation="softmax"))
                .set_input_type(InputType.convolutional(h, w, c)).build())
        return MultiLayerNetwork(conf).init(device=device)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(chip_smoke, "profile_call",
                        lambda torch, label, fn, info, count=None: {})


def _counting_lrn(monkeypatch, uncounted=None):
    fwd, bwd = port_lrn.lrn_fwd, port_lrn.lrn_bwd

    def k1(*a):
        if uncounted != "forward":
            port_lrn.launches += 1
        return fwd(*a)

    def k2(*a):
        if uncounted != "backward":
            port_lrn.bwd_launches += 1
        return bwd(*a)

    monkeypatch.setattr(port_lrn, "lrn_fwd", k1)
    monkeypatch.setattr(port_lrn, "lrn_bwd", k2)


@pytest.mark.parametrize("case", ["counted", "uncounted_backward", "numpy_arm"])
def test_image_directory_phase(no_card, monkeypatch, case):
    monkeypatch.setattr(port_zoo, "AlexNet", _NarrowCNN)
    _counting_lrn(monkeypatch, "backward" if case == "uncounted_backward" else None)
    run = lambda: chip_smoke.phase_image_directory_alexnet(
        torch, "cpu run", device="cpu", size=IMAGE_SMALL)
    if case == "counted":
        out = run()
        assert out["launches"]["lrn_fwd"] == out["launches"]["lrn_bwd"] == 2 * 3
        assert out["etl_calls"]["numpy"] == 0 and out["etl_calls"]["native"] > 0
        assert out["arms"]["resize_max_grey_levels"] <= 1
        assert set(out["etl_ms_per_batch"]) == {"1", "2"}
        assert set(out["step_ms"]) == {"image_fed", "array_fed"}
        return
    if case == "uncounted_backward":
        with pytest.raises(RuntimeError, match="launches"):
            run()
        return
    with native_etl.numpy_arm(), pytest.raises(RuntimeError, match="native arm"):
        run()


def test_vae_phase(no_card):
    out = chip_smoke.phase_vae_mnist(torch, "cpu run", device="cpu", size=VAE_SMALL)
    assert out["steps"] == 4 and out["elbo_after"] < out["elbo_before"]
    assert out["step_vs_cpu"]["loss"] == 0.0


def test_dbn_phase(no_card):
    out = chip_smoke.phase_dbn_mnist(torch, "cpu run", device="cpu", size=DBN_SMALL)
    assert out["steps"] == 4 and len(out["recon_after"]) == 3
    assert out["cd_step"]["flipped"] == 0 and not any(out["launches"].values())


def test_cd_step_check_catches_a_wrong_statistic(monkeypatch):
    layer = port_pretrain.RBM(n_in=12, n_out=6)
    params = layer.init_params(torch.Generator().manual_seed(0))
    x = torch.from_numpy((np.random.default_rng(1).random((8, 12)) < 0.5)
                         .astype(np.float32))
    assert chip_smoke.check_cd_step(torch, layer, params, x)["flipped"] == 0
    given = port_pretrain.RBM.pretrain_grads_given

    def wrong(self, p, v, uniforms):
        loss, grads = given(self, p, v, uniforms)
        return loss, {**grads, "vb": -grads["vb"]}

    monkeypatch.setattr(port_pretrain.RBM, "pretrain_grads_given", wrong)
    with pytest.raises(RuntimeError, match="not the chain's"):
        chip_smoke.check_cd_step(torch, layer, params, x)


def test_records_export_phase():
    out = chip_smoke.phase_records_export(torch, "cpu run", device="cpu")
    assert out["csv_batches"] == 3 and out["fit_steps"] == 15
    assert out["exported_files"] == 5 and out["export_bitwise"]
