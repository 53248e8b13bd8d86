"""Tensor and sequence parallelism across processes: two gloo ranks.

The counterpart of the JAX package's multi-host TP and SP checks
(tests/test_multihost.py, tests/multihost_worker.py phases 5 and 6), which
cannot run on its CPU backend. Their networks and batches: a 8-16-3 dense
net (Nesterovs) over a model axis of 4 (2 shards a rank), 3 steps on 16
rows; a causal attention net (width 16, 4 heads) over a seq axis of 4 (2
shards a rank, the ring crossing the ranks at two of its four hops), 2
steps on 4 x 16 steps. Each rank feeds the whole batch, as there.

- Two threads, each a rank of its own gloo group: the ranks agree within
  1e-4, and each matches the JAX package's single-process wrapper over 4
  virtual devices (carried parameters) within rtol 2e-4, atol 2e-5 per
  leaf; every rank holds only its blocks (TP) and every hop that crosses
  the ranks is timed.
- Two spawned ranks of the rank entry (`multihost.main --mode tp / sp`):
  the ranks agree within 1e-4 and match the JAX single-process wrapper
  within the JAX test's holds (1e-3 of the |params| sum for TP, 1e-2 for
  SP); the TP checkpoint the chief writes restores on both ranks to the
  trained parameters. Every spawned run is bounded by a timeout of 60 s."""
import json
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu as ref
from deeplearning4j_tpu.data.dataset import DataSet as RefDataSet
from deeplearning4j_tpu.nn.layers.attention import \
    SelfAttentionLayer as RefAttention
from deeplearning4j_tpu.parallel import SequenceParallelWrapper as RefSP
from deeplearning4j_tpu.parallel import TensorParallelWrapper as RefTP
from deeplearning4j_tpu.parallel import seq_parallel_mesh as ref_sp_mesh
from deeplearning4j_tpu.parallel import tensor_parallel_mesh as ref_tp_mesh
import deeplearning4j_torch as port
from deeplearning4j_torch.data.dataset import DataSet
from deeplearning4j_torch.nn import shards
from deeplearning4j_torch.nn.layers.attention import \
    SelfAttentionLayer as PortAttention
from deeplearning4j_torch.parallel import (SequenceParallelWrapper,
                                           TensorParallelWrapper)
from deeplearning4j_torch.parallel import mesh as port_mesh
from deeplearning4j_torch.parallel.mesh import ShardedLeaf
from deeplearning4j_torch.parallel.multihost import spawn_rank
from deeplearning4j_torch.utils import params as port_params

from test_torch_multihost import free_port, two_ranks_in_threads
from test_torch_parallel_wrapper import assert_trees_close
from test_torch_word2vec import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 60
TOL = dict(rtol=2e-4, atol=2e-5)


def tp_conf(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(7)
            .updater(pkg.Nesterovs(0.1, momentum=0.9)).list()
            .layer(pkg.DenseLayer(n_out=16, activation="tanh"))
            .layer(pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(8)).build())


def sp_conf(pkg):
    attn = RefAttention if pkg is ref else PortAttention
    return (pkg.NeuralNetConfiguration.builder().seed(21).updater(pkg.Sgd(0.1))
            .list()
            .layer(attn(n_out=16, n_heads=4, causal=True))
            .layer(pkg.RnnOutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(pkg.InputType.recurrent(8)).build())


def tp_data():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=16)]


def sp_data():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 16, 8)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, (4, 16))]


MODES = {"tp": (tp_conf, tp_data, 3, RefTP, ref_tp_mesh, "model_devices"),
         "sp": (sp_conf, sp_data, 2, RefSP, ref_sp_mesh, "seq_devices")}


def jax_reference(mode):
    """The JAX wrapper over 4 virtual devices from the port's initial
    parameters: its trained tree as numpy."""
    make, data, steps, wrapper, mesh, axis = MODES[mode]
    p = port.MultiLayerNetwork(make(port)).init(device="cpu")
    r = ref.MultiLayerNetwork(make(ref)).init()
    to = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    r.params_tree = to(port_params.params_to_numpy(p.params_tree))
    r.opt_state = to(port_params.opt_state_to_numpy(p.opt_state))
    w = wrapper(r, mesh(**{axis: 4}, devices=jax.devices()[:4]))
    x, y = data()
    for _ in range(steps):
        w.fit_batch(RefDataSet(x, y))
    if mode == "tp":
        w.materialize_local()
    return jax.tree_util.tree_map(np.asarray, r.params_tree)


def rank_fit(mode, rank, pg):
    make, data, steps, _, _, _ = MODES[mode]
    net = port.MultiLayerNetwork(make(port)).init(device="cpu")
    axis = "model" if mode == "tp" else "seq"
    mesh = port_mesh.create_mesh([1, 4], ("data", axis), ["cpu"] * 4,
                                 [0, 0, 1, 1])
    cls = TensorParallelWrapper if mode == "tp" else SequenceParallelWrapper
    w = cls(net, mesh, process_group=pg)
    x, y = data()
    for _ in range(steps):
        w.fit_batch(DataSet(x, y))
    held = None
    if mode == "tp":
        wl = net.params_tree[0]["W"]
        held = [s is not None for s in wl.slices]
        assert isinstance(wl, ShardedLeaf)
        w.materialize_local()
    return net, held


@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_two_ranks_in_threads_match_jax(mode):
    for k in shards.cross_ms:
        shards.cross_ms[k] = 0.0
    got = two_ranks_in_threads(lambda r, pg: rank_fit(mode, r, pg))
    want = jax_reference(mode)
    for net, _ in got:
        assert_trees_close(want, net.params_tree, **TOL)
    for a, b in zip(port_params.tree_leaves(got[0][0].params_tree),
                    port_params.tree_leaves(got[1][0].params_tree)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4)
    if mode == "tp":
        assert got[0][1] == [True, True, False, False]
        assert got[1][1] == [False, False, True, True]
        assert shards.cross_ms["param_gather"] > 0
    else:
        assert shards.cross_ms["hop"] > 0 and shards.cross_ms["score"] > 0


def _spawn(tmp, mode):
    """Two ranks of `multihost.main --mode <mode>` on the batch of the JAX
    worker's phase; returns their reports."""
    make, data, steps, _, _, _ = MODES[mode]
    conf_path = os.path.join(tmp, f"{mode}.json")
    with open(conf_path, "w") as f:
        f.write(make(port).to_json())
    x, y = data()
    npz = os.path.join(tmp, f"{mode}.npz")
    np.savez(npz, x=x, y=y)
    coord = f"127.0.0.1:{free_port()}"
    args = ["--conf", conf_path, "--data", npz, "--epochs", str(steps),
            "--batch-size", str(x.shape[0]), "--device", "cpu", "--mode", mode,
            "--out", os.path.join(tmp, "run")]
    env = {"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [spawn_rank(r, 2, coord, args, env=env, cwd=REPO,
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], outs
    reports = []
    for r in range(2):
        with open(os.path.join(tmp, f"run.{mode}.rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def _leaves(tmp, name):
    with np.load(os.path.join(tmp, name)) as z:
        return [z[k] for k in sorted(z.files)]


@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_rank_entry_modes(tmp_path, mode):
    tmp = str(tmp_path)
    reports = _spawn(tmp, mode)
    assert [r["iteration"] for r in reports] == [MODES[mode][2]] * 2
    assert all(r["backend"] == "gloo" and r["mesh"] == [1, 4] for r in reports)
    ranks = [_leaves(tmp, f"run.{mode}.rank{r}.npz") for r in range(2)]
    for a, b in zip(*ranks):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    want = sum(np.abs(a).sum() for a in jax.tree_util.tree_leaves(
        jax_reference(mode)))
    got = sum(np.abs(a).sum() for a in ranks[0])
    assert abs(got - want) < (1e-3 if mode == "tp" else 1e-2), (got, want)
    if mode == "tp":
        assert reports[0]["shards"]["0.W"] == [None, "model"]
        sizes = reports[0]["shard_bytes"]
        assert sizes["per_shard"][:2] != [0, 0] and sizes["per_shard"][2:] == [0, 0]
        assert reports[0]["cross_ms"]["param_gather"] > 0
        for r in range(2):
            for a, b in zip(_leaves(tmp, f"run.tp.rank{r}.restored.npz"),
                            ranks[0]):
                np.testing.assert_array_equal(a, b)
    else:
        assert all(r["cross_ms"]["hop"] > 0 for r in reports)
