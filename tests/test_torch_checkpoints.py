"""Checkpoints both ways between the torch port and the JAX package
(utils/model_serializer.py).

- The JAX package's fixtures restore in the port: `lenet_mnist.zip` (its
  `output` against the JAX package's `restore_model(...).output`, rtol
  1e-5) and `graph_merge.zip` (against `expected.npz`, rtol 1e-5 / atol
  1e-6, its Adam state bitwise the JAX package's), and training resumes
  from the latter as the JAX package's does (2 `fit` steps, rtol 1e-5).
- Zips the port writes restore in the JAX package with bitwise parameters
  and optimizer state, and equal outputs (float32 rtol 1e-5; bfloat16 1e-2
  of the largest value, bfloat16 sums in another order): a small AlexNet
  with updater state, the mini-inception graph, and a bfloat16 network,
  which also goes back from the JAX package's writer to the port bitwise.
- Resume: save after 2 steps, restore, 2 more, bitwise the 4 uninterrupted
  steps (dropout off, the CPU's sums in a fixed order).
- Each corruption raises CheckpointCorruptError, an architecture mismatch
  ValueError (a layer state that does not fit too), and the
  `checkpoint.write` fault point leaves the earlier checkpoint whole.
- Layer state (state.npz): the JAX package's `mln_cnn.zip` (a populated
  BatchNormalization state and a NormalizerStandardize) restores bitwise,
  matches `expected.npz` and resumes 2 `fit` steps as the JAX package's
  restore does (parameters, Adam and BN state within 1e-5, relative or of
  the leaf's largest value); a mini ResNet's zip written by the port
  restores in the JAX package with bitwise parameters, RmsProp state and BN
  state, in float32 and bfloat16 (its state float32).
- The leaf order equals `zoo_param_manifest.json` for LeNet, AlexNet and
  GoogLeNet.
- Recurrent networks: the JAX package's `mln_rnn.zip` (LSTM + RnnOutputLayer,
  Adam) restores bitwise, with no carry and an empty state, matches
  `expected.npz` (rtol 1e-5, atol 1e-6) and resumes 2 `fit` steps as the
  JAX package's restore does (within 1e-5); the port's zips of a truncated-
  BPTT MLN (GravesLSTM + LSTM) and of a graph with a bidirectional node
  restore in the JAX package bitwise (outputs rtol 1e-5) and in the port.
"""
import hashlib
import io
import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.models import zoo as port_zoo
from deeplearning4j_torch.utils import faults as port_faults
from deeplearning4j_torch.utils import model_serializer as port_ser
from deeplearning4j_torch.utils import params as port_params
from deeplearning4j_tpu.utils import model_serializer as ref_ser
from test_torch_word2vec import one_torch_thread  # noqa: F401

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
LENET = os.path.join(FIX, "pretrained", "lenet_mnist.zip")
GRAPH_MERGE = os.path.join(FIX, "checkpoints", "graph_merge.zip")


def _images(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _onehot(n, classes, seed):
    return np.eye(classes, dtype=np.float32)[
        np.random.default_rng(seed).integers(0, classes, n)]


def _assert_tree_bitwise(port_tree, ref_tree, what):
    """A port tree (its layout, any type) against a JAX-package tree: the
    same leaf order and every leaf bitwise, bfloat16 by its bits."""
    got = [port_params.leaf_to_reference_bits(t)
           for t in port_params.tree_leaves(port_tree)]
    want = jax.tree_util.tree_leaves(ref_tree)
    assert len(got) == len(want), what
    for i, ((a, name), w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert name == w.dtype.name, (what, i)
        if name == "bfloat16":
            w = w.view(np.uint16)
        np.testing.assert_array_equal(a, w, err_msg=f"{what} leaf {i}")


def _assert_port_trees_equal(a, b):
    la, lb = port_params.tree_leaves(a), port_params.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------------- the JAX package's fixtures

def test_lenet_mnist_restores_and_matches_reference():
    net = port_ser.restore_model(LENET, device="cpu")
    ref_net = ref_ser.restore_model(LENET)
    assert isinstance(net, port.MultiLayerNetwork)
    assert (net.iteration, net.epoch) == (ref_net.iteration, ref_net.epoch) == (48, 3)
    _assert_tree_bitwise(net.params_tree, ref_net.params_tree, "params")
    x = _images((8, 28, 28, 1), seed=1)
    got, want = net.output(x), np.asarray(ref_net.output(x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert port_ser.restore_normalizer(LENET) is None


def test_lenet_init_pretrained_checks_checksum_and_architecture():
    with open(os.path.join(FIX, "pretrained", "manifest.json")) as f:
        sha = json.load(f)["sha256"]
    net = port_zoo.LeNet().init_pretrained(LENET, expected_sha256=sha, device="cpu")
    assert net.num_params() == port_zoo.LeNet().init(device="cpu").num_params()
    with pytest.raises(ValueError, match="checksum"):
        port_zoo.LeNet().init_pretrained(LENET, expected_sha256="0" * 64, device="cpu")
    with pytest.raises(ValueError, match="different architecture"):
        port_zoo.AlexNet().init_pretrained(LENET, device="cpu")
    with pytest.raises(ValueError, match="ComputationGraphConfiguration"):
        port_zoo.GoogLeNet().init_pretrained(LENET, device="cpu")
    with pytest.raises(FileNotFoundError):
        port_zoo.LeNet().init_pretrained(LENET + ".missing", device="cpu")


def test_graph_merge_restores_and_matches_expected():
    expected = np.load(os.path.join(FIX, "checkpoints", "expected.npz"))
    g = port_ser.ModelSerializer.restore_computation_graph(GRAPH_MERGE, device="cpu")
    ref_g = ref_ser.restore_model(GRAPH_MERGE)
    assert isinstance(g, port.ComputationGraph)
    assert (g.iteration, g.epoch) == (6, 3)
    np.testing.assert_allclose(g.output(expected["graph_merge_x"]),
                               expected["graph_merge_y"], rtol=1e-5, atol=1e-6)
    _assert_tree_bitwise(g.params_tree, ref_g.params_tree, "params")
    _assert_tree_bitwise(g.opt_state, ref_g.opt_state, "Adam state")
    with pytest.raises(ValueError, match="MultiLayerNetwork"):
        port_ser.ModelSerializer.restore_multi_layer_network(GRAPH_MERGE, device="cpu")


def test_graph_merge_resumes_training_as_the_reference():
    g = port_ser.restore_model(GRAPH_MERGE, device="cpu")
    ref_g = ref_ser.restore_model(GRAPH_MERGE)
    x, y = _images((8, 6), seed=2), _onehot(8, 3, seed=3)
    g.fit(x, y, batch_size=4)
    ref_g.fit(x, y, batch_size=4, use_async=False)
    assert g.iteration == ref_g.iteration == 8
    np.testing.assert_allclose(float(g.score_value), float(ref_g.score_value), rtol=1e-5)
    for mine, theirs in ((g.params_tree, ref_g.params_tree), (g.opt_state, ref_g.opt_state)):
        got = port_params.params_to_numpy(mine)
        for a, b in zip(port_params.tree_leaves(got), jax.tree_util.tree_leaves(theirs)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-9)


# ------------------------------------------------ the port's zips, both ways

def _small_alexnet(dtype=torch.float32):
    """AlexNet's layer kinds, updater, gradient normalization and L2 at a
    few channels and 33x33x3 (tests/test_torch_train.py), one step in."""
    from test_torch_train import _narrow_conf
    net = port.MultiLayerNetwork(_narrow_conf(port)).init(device="cpu", dtype=dtype)
    x, y = _images((4, 33, 33, 3), seed=4), _onehot(4, 5, seed=5)
    net.fit(x, y, batch_size=4)   # non-zero Nesterov velocities
    return net


def _mini_graph():
    from test_torch_graph import _mini_conf
    net = port.ComputationGraph(_mini_conf(port, port_zoo)).init(device="cpu")
    x, y = _images((4, 32, 32, 3), seed=6), _onehot(4, 5, seed=7)
    net.fit(x, y, batch_size=4)
    return net


@pytest.mark.parametrize("which", ["alexnet", "mini_inception", "alexnet_bfloat16"])
def test_port_zip_restores_in_reference(tmp_path, which):
    if which == "mini_inception":
        net, shape = _mini_graph(), (3, 32, 32, 3)
    else:
        net = _small_alexnet(torch.bfloat16 if which.endswith("bfloat16") else torch.float32)
        shape = (3, 33, 33, 3)
    path = str(tmp_path / "model.zip")
    port_ser.save_model(net, path)
    meta = port_ser.validate_checkpoint(path, deep=True)
    assert meta["dtype"] == ("bfloat16" if which.endswith("bfloat16") else "float32")
    with zipfile.ZipFile(path) as zf:
        assert port_ser.RNG_ENTRY not in zf.namelist()
    ref_net = ref_ser.restore_model(path)
    assert (ref_net.iteration, ref_net.epoch) == (net.iteration, net.epoch) == (1, 1)
    _assert_tree_bitwise(net.params_tree, ref_net.params_tree, "params")
    _assert_tree_bitwise(net.opt_state, ref_net.opt_state, "opt state")
    x = _images(shape, seed=8)
    got = net.output(x)
    if which.endswith("bfloat16"):
        # the JAX package's eager forward, fed bfloat16 images
        want = np.asarray(ref_net.feed_forward(jax.numpy.asarray(x, jax.numpy.bfloat16))[-1],
                          np.float32)
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
        # and back: the JAX package's zip of that network restores bitwise
        path2 = str(tmp_path / "from_reference.zip")
        ref_ser.save_model(ref_net, path2)
        again = port_ser.restore_model(path2, device="cpu")
        assert again._dtype == torch.bfloat16
        _assert_port_trees_equal(again.params_tree, net.params_tree)
        _assert_port_trees_equal(again.opt_state, net.opt_state)
    else:
        np.testing.assert_allclose(got, np.asarray(ref_net.output(x)), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("kind", ["graph", "mln"])
def test_round_trip_is_bitwise(tmp_path, kind):
    net = _mini_graph() if kind == "graph" else _small_alexnet()
    path = tmp_path / "m.zip"
    port_ser.ModelSerializer.write_model(net, path)
    back = port_ser.restore_model(path, device="cpu")
    assert type(back) is type(net)
    assert (back.iteration, back.epoch) == (net.iteration, net.epoch)
    _assert_port_trees_equal(back.params_tree, net.params_tree)
    _assert_port_trees_equal(back.opt_state, net.opt_state)
    x = _images((2, 32, 32, 3) if kind == "graph" else (2, 33, 33, 3), seed=9)
    np.testing.assert_array_equal(back.output(x), net.output(x))
    fresh = (port.ComputationGraph if kind == "graph" else port.MultiLayerNetwork)(
        net.conf).init(seed=5, device="cpu")
    meta = port_ser.load_checkpoint_state(fresh, str(path))
    assert meta["iteration"] == fresh.iteration == net.iteration
    _assert_port_trees_equal(fresh.params_tree, net.params_tree)


@pytest.mark.parametrize("kind", ["graph", "mln"])
def test_restore_draws_no_parameters(tmp_path, monkeypatch, kind):
    """restore_model takes each leaf's shape and type from the meta device:
    no init, no weight drawn; without the updater state it builds fresh
    (zero) state on the restore's device."""
    net = _mini_graph() if kind == "graph" else _small_alexnet()
    path = str(tmp_path / "m.zip")
    port_ser.save_model(net, path)
    drawn = []

    def recording(draw):
        def wrapped(*a, **k):
            t = draw(*a, **k)
            drawn.append(t.device.type)
            return t
        return wrapped

    from deeplearning4j_torch.nn import weights
    for name in ("_normal", "_uniform"):
        monkeypatch.setattr(weights, name, recording(getattr(weights, name)))
    monkeypatch.setattr(type(net), "init", None)
    back = port_ser.restore_model(path, load_updater=False, device="cpu")
    assert drawn and set(drawn) == {"meta"}
    _assert_port_trees_equal(back.params_tree, net.params_tree)
    state = port_params.tree_leaves(back.opt_state)
    assert len(state) == len(port_params.tree_leaves(net.opt_state))
    assert all(t.device.type == "cpu" and not t.any() for t in state)
    assert back._dropout_gen.device.type == "cpu"


def test_resume_after_two_steps_equals_four_uninterrupted(tmp_path):
    from test_torch_graph import _mini_conf
    x, y = _images((16, 32, 32, 3), seed=10), _onehot(16, 5, seed=11)
    whole = port.ComputationGraph(_mini_conf(port, port_zoo)).init(device="cpu")
    whole.fit(x, y, batch_size=4)
    first = port.ComputationGraph(_mini_conf(port, port_zoo)).init(device="cpu")
    first.fit(x[:8], y[:8], batch_size=4)
    path = str(tmp_path / "half.zip")
    port_ser.save_model(first, path)
    second = port_ser.restore_model(path, device="cpu")
    assert second.iteration == 2
    second.fit(x[8:], y[8:], batch_size=4)
    assert second.iteration == whole.iteration == 4
    _assert_port_trees_equal(second.params_tree, whole.params_tree)
    _assert_port_trees_equal(second.opt_state, whole.opt_state)


def test_restore_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_ser.restore_model(LENET)


# ------------------------------------------------------- faults and mismatches

def _rewrite(src, dst, drop=(), replace=None):
    """Copy the zip at `src` to `dst`, leaving out `drop` and replacing
    entries by name."""
    replace = replace or {}
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for name in zin.namelist():
            if name in drop:
                continue
            zout.writestr(name, replace.get(name, zin.read(name)))


@pytest.mark.parametrize("corruption", ["truncated", "missing_entry",
                                        "bad_format_version", "bad_crc"])
def test_corruption_raises_checkpoint_corrupt_error(tmp_path, corruption):
    path = str(tmp_path / "bad.zip")
    if corruption == "truncated":
        data = open(LENET, "rb").read()
        open(path, "wb").write(data[:len(data) // 2])
    elif corruption == "missing_entry":
        _rewrite(LENET, path, drop=(port_ser.STATE_ENTRY,))
    elif corruption == "bad_format_version":
        meta = json.loads(zipfile.ZipFile(LENET).read(port_ser.META_ENTRY))
        meta["format_version"] = 99
        _rewrite(LENET, path, replace={port_ser.META_ENTRY: json.dumps(meta)})
    else:  # one byte flipped inside the stored (uncompressed) parameters
        _rewrite(LENET, path)
        data = bytearray(open(path, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(path, "wb").write(bytes(data))
    with pytest.raises(port_ser.CheckpointCorruptError):
        port_ser.validate_checkpoint(path, deep=True)
    with pytest.raises(port_ser.CheckpointCorruptError):
        port_ser.restore_model(path, device="cpu")


def test_architecture_mismatch_raises_value_error():
    wrong_head = port_zoo.LeNet(num_labels=7).init(device="cpu")
    with pytest.raises(ValueError, match="shape"):
        port_ser.load_checkpoint_state(wrong_head, LENET)
    graph = port_ser.restore_model(GRAPH_MERGE, device="cpu")
    with pytest.raises(ValueError, match="arrays"):
        port_ser.load_checkpoint_state(graph, LENET)


def test_fault_point_keeps_the_write_atomic(tmp_path):
    path = str(tmp_path / "ckpt.zip")
    net = port_zoo.LeNet().init(device="cpu")
    with port_faults.injected("checkpoint.write", "fail:1"):
        with pytest.raises(port_faults.FaultInjected):
            port_ser.save_model(net, path)
    assert os.listdir(tmp_path) == []   # no torn file, no temporary left
    port_ser.save_model(net, path)
    digest = hashlib.sha256(open(path, "rb").read()).hexdigest()
    other = port_zoo.LeNet().init(seed=9, device="cpu")
    with port_faults.injected("checkpoint.write", "fail:1"):
        with pytest.raises(port_faults.FaultInjected):
            port_ser.save_model(other, path)
    assert os.listdir(tmp_path) == ["ckpt.zip"]
    assert hashlib.sha256(open(path, "rb").read()).hexdigest() == digest
    _assert_port_trees_equal(port_ser.restore_model(path, device="cpu").params_tree,
                             net.params_tree)


def test_state_that_does_not_fit_raises_value_error(tmp_path):
    """A state.npz whose leaves do not fit the configuration's layer state
    (LeNet has none) raises ValueError, as the parameters' do."""
    buf = io.BytesIO()
    np.savez(buf, leaf00000=np.ones(3, np.float32), __dtypes__=np.array(["float32"]))
    path = str(tmp_path / "bn.zip")
    _rewrite(LENET, path, replace={port_ser.STATE_ENTRY: buf.getvalue()})
    with pytest.raises(ValueError, match="arrays"):
        port_ser.restore_model(path, device="cpu")


# ---------------------------------------- layer state: mln_cnn.zip and BN zips

MLN_CNN = os.path.join(FIX, "checkpoints", "mln_cnn.zip")


def test_mln_cnn_restores_with_state_and_normalizer():
    expected = np.load(os.path.join(FIX, "checkpoints", "expected.npz"))
    net = port_ser.restore_model(MLN_CNN, device="cpu")
    ref_net = ref_ser.restore_model(MLN_CNN)
    assert isinstance(net, port.MultiLayerNetwork)
    assert (net.iteration, net.epoch) == (ref_net.iteration, ref_net.epoch)
    assert net.iteration > 0
    _assert_tree_bitwise(net.params_tree, ref_net.params_tree, "params")
    _assert_tree_bitwise(net.opt_state, ref_net.opt_state, "Adam state")
    _assert_tree_bitwise(net.state_tree, ref_net.state_tree, "BN state")
    assert net.state_tree[2]["mean"].abs().sum() > 0   # a populated state
    np.testing.assert_allclose(net.output(expected["mln_cnn_x"]), expected["mln_cnn_y"],
                               rtol=1e-5, atol=1e-6)
    norm = port_ser.restore_normalizer(MLN_CNN)
    assert isinstance(norm, port.NormalizerStandardize)
    assert len(norm.mean) == len(norm.std) == 144
    assert norm == port_ser.serde.from_json(
        ref_ser.serde.to_json(ref_ser.restore_normalizer(MLN_CNN)))


def test_mln_cnn_resumes_training_as_the_reference():
    expected = np.load(os.path.join(FIX, "checkpoints", "expected.npz"))
    net = port_ser.restore_model(MLN_CNN, device="cpu")
    ref_net = ref_ser.restore_model(MLN_CNN)
    x = expected["mln_cnn_x"]
    y = np.eye(4, dtype=np.float32)[np.arange(len(x)) % 4]
    it0 = net.iteration
    net.fit(x, y, epochs=2, batch_size=len(x))
    ref_net.fit(x, y, epochs=2, batch_size=len(x), use_async=False)
    assert net.iteration == ref_net.iteration == it0 + 2
    np.testing.assert_allclose(float(net.score_value), float(ref_net.score_value),
                               rtol=1e-5)
    for what, mine, theirs in (("params", net.params_tree, ref_net.params_tree),
                               ("Adam", net.opt_state, ref_net.opt_state),
                               ("BN state", net.state_tree, ref_net.state_tree)):
        got = port_params.tree_leaves(port_params.params_to_numpy(mine))
        want = jax.tree_util.tree_leaves(theirs)
        assert len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            b = np.asarray(b)
            # Adam's second moment squares the gradients' differences
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max(),
                                       err_msg=f"{what} leaf {i}")


def _mini_resnet(dtype):
    from test_torch_resnet import _data, _mini_conf
    net = port.ComputationGraph(_mini_conf(port, port_zoo)).init(device="cpu",
                                                                 dtype=dtype)
    x, y = _data(8, seed=44)
    net.fit(x, y, batch_size=4)   # a moved running state and RmsProp state
    return net, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_port_resnet_zip_restores_in_reference_with_state(tmp_path, dtype):
    net, x = _mini_resnet(dtype)
    assert {t.dtype for t in port_params.tree_leaves(net.state_tree)} == {torch.float32}
    path = str(tmp_path / "resnet.zip")
    port_ser.save_model(net, path)
    ref_net = ref_ser.restore_model(path)
    assert (ref_net.iteration, ref_net.epoch) == (net.iteration, net.epoch) == (2, 1)
    _assert_tree_bitwise(net.params_tree, ref_net.params_tree, "params")
    _assert_tree_bitwise(net.opt_state, ref_net.opt_state, "RmsProp state")
    _assert_tree_bitwise(net.state_tree, ref_net.state_tree, "BN state")
    # and back: the port's restore of its own zip, bitwise, state float32
    back = port_ser.restore_model(path, device="cpu")
    _assert_port_trees_equal(back.state_tree, net.state_tree)
    _assert_port_trees_equal(back.params_tree, net.params_tree)
    np.testing.assert_array_equal(back.output(x[:2]), net.output(x[:2]))
    fresh = port.ComputationGraph(net.conf).init(device="cpu", dtype=dtype, seed=3)
    port_ser.load_checkpoint_state(fresh, path)
    _assert_port_trees_equal(fresh.state_tree, net.state_tree)


# ------------------------------------------------------------- leaf order

@pytest.mark.parametrize("name", ["LeNet", "AlexNet", "GoogLeNet"])
def test_leaf_order_matches_manifest(name):
    """The order in which a checkpoint numbers the leaves
    (utils/params.py `tree_leaves`) against the JAX package's committed
    manifest: an MLN's layers by index, a graph's nodes sorted by name
    (its dicts hold them in topological order), each layer's parameters
    sorted. A wrong order would still load, since inception blocks hold
    many equal-shaped 1x1 kernels, into the wrong nodes."""
    with open(os.path.join(FIX, "zoo_param_manifest.json")) as f:
        manifest = json.load(f)[name]
    small = dict(num_labels=10, input_shape=(64, 64, 3) if name == "GoogLeNet"
                 else (32, 32, 3))
    tree = getattr(port_zoo, name)(**small).init(device="cpu").params_tree
    if isinstance(tree, dict):
        assert list(tree)[:3] == ["cnn1", "max1", "lrn1"]   # topological
        named = {k: {p: f"{k}/{p}" for p in lp} for k, lp in tree.items()}
    else:
        named = tuple({p: f"{i}/{p}" for p in lp} for i, lp in enumerate(tree))
    groups = {}
    for leaf in port_params.tree_leaves(named):
        key, pname = leaf.split("/")
        groups.setdefault(key, []).append(pname)
    assert [[k, v] for k, v in groups.items()] == \
        [[str(k), v] for k, v in manifest if v]
    keys = sorted(tree) if isinstance(tree, dict) else list(range(len(tree)))
    assert keys == [k for k, _ in manifest]


# ------------------------------------------- recurrent state: mln_rnn.zip

MLN_RNN = os.path.join(FIX, "checkpoints", "mln_rnn.zip")


def test_mln_rnn_restores_and_matches_expected():
    expected = np.load(os.path.join(FIX, "checkpoints", "expected.npz"))
    net = port_ser.restore_model(MLN_RNN, device="cpu")
    ref_net = ref_ser.restore_model(MLN_RNN)
    assert isinstance(net, port.MultiLayerNetwork)
    assert isinstance(net.layers[0], port.LSTM)
    assert (net.iteration, net.epoch) == (ref_net.iteration, ref_net.epoch)
    assert net.iteration > 0
    _assert_tree_bitwise(net.params_tree, ref_net.params_tree, "params")
    _assert_tree_bitwise(net.opt_state, ref_net.opt_state, "Adam state")
    assert port_params.tree_leaves(net.state_tree) == [] and net._rnn_carry is None
    np.testing.assert_allclose(net.output(expected["mln_rnn_x"]), expected["mln_rnn_y"],
                               rtol=1e-5, atol=1e-6)


def test_mln_rnn_resumes_training_as_the_reference():
    expected = np.load(os.path.join(FIX, "checkpoints", "expected.npz"))
    net = port_ser.restore_model(MLN_RNN, device="cpu")
    ref_net = ref_ser.restore_model(MLN_RNN)
    x = expected["mln_rnn_x"]
    y = np.eye(3, dtype=np.float32)[np.arange(x.shape[0] * x.shape[1]).reshape(
        x.shape[:2]) % 3]
    it0 = net.iteration
    net.fit(x, y, epochs=2, batch_size=len(x))
    ref_net.fit(x, y, epochs=2, batch_size=len(x), use_async=False)
    assert net.iteration == ref_net.iteration == it0 + 2
    np.testing.assert_allclose(float(net.score_value), float(ref_net.score_value),
                               rtol=1e-5)
    for what, mine, theirs in (("params", net.params_tree, ref_net.params_tree),
                               ("Adam", net.opt_state, ref_net.opt_state)):
        got = port_params.tree_leaves(port_params.params_to_numpy(mine))
        want = jax.tree_util.tree_leaves(theirs)
        assert len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max(),
                                       err_msg=f"{what} leaf {i}")


def _recurrent_net(kind):
    """A port network of each recurrent layer, trained one truncated-BPTT
    batch (3 windows): an MLN of GravesLSTM + LSTM, or a graph with a
    bidirectional node."""
    from test_torch_tbptt import _data, _mln_conf
    x, y, fm, lm = _data(seed=12)
    if kind == "mln":
        net = port.MultiLayerNetwork(_mln_conf(port)).init(device="cpu")
        net.fit(port.DataSet(x, y, fm, lm), batch_size=len(x))
        return net, x
    g = (port.NeuralNetConfiguration.builder().seed(9)
         .updater(port.RmsProp(learning_rate=1e-2)).graph_builder())
    g.add_inputs("in")
    g.set_input_types(port.InputType.recurrent(x.shape[2]))
    g.add_layer("bi", port.GravesBidirectionalLSTM(n_out=4, activation="tanh"), "in")
    g.add_layer("lstm", port.LSTM(n_out=5, activation="tanh"), "bi")
    g.add_layer("out", port.RnnOutputLayer(n_out=y.shape[2], activation="softmax",
                                           loss="mcxent"), "lstm")
    g.set_outputs("out")
    g.backprop_type(port.BackpropType.TRUNCATED_BPTT)
    g.tbptt_fwd_length(4)
    net = port.ComputationGraph(g.build()).init(device="cpu")
    net.fit(port.MultiDataSet([x], [y], [fm], [lm]), batch_size=len(x))
    return net, x


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_port_recurrent_zip_restores_in_reference(tmp_path, kind):
    net, x = _recurrent_net(kind)
    assert net.iteration == 3 and net._rnn_carry is None
    path = str(tmp_path / "rnn.zip")
    port_ser.save_model(net, path)
    ref_net = ref_ser.restore_model(path)
    assert (ref_net.iteration, ref_net.epoch) == (net.iteration, net.epoch)
    _assert_tree_bitwise(net.params_tree, ref_net.params_tree, "params")
    _assert_tree_bitwise(net.opt_state, ref_net.opt_state, "opt state")
    np.testing.assert_allclose(net.output(x), np.asarray(ref_net.output(x)),
                               rtol=1e-5, atol=1e-7)
    back = port_ser.restore_model(path, device="cpu")
    _assert_port_trees_equal(back.params_tree, net.params_tree)
    _assert_port_trees_equal(back.opt_state, net.opt_state)
    np.testing.assert_array_equal(back.output(x), net.output(x))
