"""The port's multi-process runner: two gloo ranks on the CPU.

The JAX package's multi-host tests cannot run here (its CPU backend has no
multi-process collectives), and its tests establish that its
single-process ParallelWrapper equals multi-host training on the same
global batch. So two ranks of the port's runner (spawned through the
package's worker entry, `multihost.main`), on a network with
BatchNormalization, are held against the JAX wrapper over two virtual
devices on the concatenated global batches: sync (gradient all-reduce, BN
moments over the global batch) and local SGD (average every 2 steps),
parameters within rtol 1e-4 and atol 1e-5. Two threads,
each a rank of its own gloo group, hold the cross-process meeting points
(BN moments, the labels-masked score) to the plain step on the global
batch (rtol 1e-5, atol 1e-6). Then the chaos drill: rank 1 SIGKILLs
itself mid-run, rank 0's health plane ends it with PeerLostError and exit
code 17, and a restarted job resumes from the chief's step checkpoint to
the uninterrupted run's parameters. Every spawned run is bounded by a
timeout of 60 s."""
import json
import os
import socket
import subprocess
import threading
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu as ref
from deeplearning4j_tpu.data.dataset import DataSet as RefDataSet
from deeplearning4j_tpu.parallel import ParallelWrapper as RefWrapper
from deeplearning4j_tpu.parallel import data_parallel_mesh as ref_mesh
import deeplearning4j_torch as port
from deeplearning4j_torch.parallel import MultiHostRunner
from deeplearning4j_torch.nn import shards
from deeplearning4j_torch.parallel.multihost import _synthetic, spawn_rank
from deeplearning4j_torch.utils import params as port_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, LOCAL_BATCH, EPOCHS = 64, 8, 2        # 4 global steps an epoch
TIMEOUT_S = 60


def conf(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(7)
            .updater(pkg.Nesterovs(0.1, momentum=0.9)).list()
            .layer(pkg.DenseLayer(n_out=16, activation="tanh"))
            .layer(pkg.BatchNormalization())
            .layer(pkg.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(8)).build())


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def run_job(tmp, tag, extra, env=None, expect=(0, 0)):
    """Two ranks of `multihost.main`; returns their outputs."""
    conf_path = os.path.join(tmp, "conf.json")
    if not os.path.exists(conf_path):
        with open(conf_path, "w") as f:
            f.write(conf(port).to_json())
    coord = f"127.0.0.1:{free_port()}"
    args = ["--conf", conf_path, "--rows", str(ROWS), "--epochs",
            str(EPOCHS), "--batch-size", str(LOCAL_BATCH), "--device", "cpu",
            "--out", os.path.join(tmp, tag)] + extra
    child_env = {"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", **(env or {})}
    procs = [spawn_rank(r, 2, coord, args, env=child_env, cwd=REPO,
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
    rcs = tuple(p.returncode for p in procs)
    assert rcs == expect, (rcs, outs)
    return outs


def rank_leaves(tmp, tag, freq, rank):
    with np.load(os.path.join(tmp, f"{tag}.f{freq}.rank{rank}.npz")) as z:
        return [z[k] for k in sorted(z.files)]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("multihost"))
    outs = run_job(tmp, "run", ["--averaging-frequency", "1,2"])
    return tmp, outs


def jax_reference(freq):
    """The JAX wrapper over two virtual devices on the global batches (rank
    0's local batch, then rank 1's), from the port's initial parameters."""
    p = port.MultiLayerNetwork(conf(port)).init(device="cpu")
    r = ref.MultiLayerNetwork(conf(ref)).init()
    to = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    r.params_tree = to(port_params.params_to_numpy(p.params_tree))
    r.opt_state = to(port_params.opt_state_to_numpy(p.opt_state))
    x, y = _synthetic(conf(port), ROWS, 0)
    half = ROWS // 2
    pw = RefWrapper(r, mesh=ref_mesh(2), averaging_frequency=freq)
    for _ in range(EPOCHS):
        for b in range(half // LOCAL_BATCH):
            s = slice(b * LOCAL_BATCH, (b + 1) * LOCAL_BATCH)
            gx = np.concatenate([x[:half][s], x[half:][s]])
            gy = np.concatenate([y[:half][s], y[half:][s]])
            pw.fit_batch(RefDataSet(gx, gy))
    pw.finalize()
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            r.params_tree))


@pytest.mark.parametrize("freq", [1, 2], ids=["sync", "local_sgd"])
def test_two_ranks_agree_and_match_jax_wrapper(job, freq):
    tmp, outs = job
    r0, r1 = (rank_leaves(tmp, "run", freq, r) for r in (0, 1))
    for a, b in zip(r0, r1):
        np.testing.assert_array_equal(a, b)   # the ranks agree bitwise
    want = jax_reference(freq)
    assert len(want) == len(r0)
    for got, w in zip(r0, want):
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-5)
    with open(os.path.join(tmp, f"run.f{freq}.rank0.json")) as f:
        stats = json.load(f)
    assert stats["iteration"] == EPOCHS * ROWS // (2 * LOCAL_BATCH)
    assert stats["backend"] == "gloo"
    timed = stats["allreduce_ms"]
    assert len(timed) == stats["iteration"] and all(t >= 0 for t in timed)
    if freq == 1:
        assert all(t > 0 for t in timed)   # one all-reduce a step


def test_kill_detected_then_resume_matches_uninterrupted(job, tmp_path):
    """Rank 1 SIGKILLs itself inside step 3; rank 0 leaves with exit code 17
    inside the beat timeout instead of hanging in the next collective. The
    restarted job resumes from the chief's checkpoint and ends where the
    uninterrupted run (the module's sync run) ended."""
    tmp, _ = job
    ck = str(tmp_path / "ckpt")
    env = {"DL4JTPU_HEARTBEAT_TIMEOUT_S": "5",
           "DL4JTPU_HEARTBEAT_INTERVAL_S": "0.2"}
    outs = run_job(tmp, "crash", ["--health", "--checkpoint-dir", ck,
                                  "--checkpoint-every", "1", "--crash-at", "3"],
                   env=env, expect=(17, -9))
    assert "PeerLostError" in outs[0] and "CRASHING 1 at 3" in outs[1]
    # the kill lands inside step 3, before its checkpoint: step 2 is newest
    assert sorted(f for f in os.listdir(ck) if f.endswith(".zip"))[-1] == \
        "checkpoint_step2.zip"
    outs = run_job(tmp, "resumed", ["--checkpoint-dir", ck])
    assert "STEP 0 3\n" in outs[0] and "STEP 0 2\n" not in outs[0]
    for got, want in zip(rank_leaves(tmp, "resumed", 1, 0),
                         rank_leaves(tmp, "run", 1, 0)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def two_ranks_in_threads(fn):
    """`fn(rank, process_group)` on two threads, each a rank of one gloo
    group over an in-memory store; returns their results."""
    store = torch.distributed.HashStore()
    out, errors = [None, None], []

    def go(r):
        try:
            pg = torch.distributed.ProcessGroupGloo(store, r, 2,
                                                    timedelta(seconds=TIMEOUT_S))
            out[r] = fn(r, pg)
        except BaseException as e:   # noqa: BLE001 -- re-raised below
            errors.append(e)

    threads = [threading.Thread(target=go, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
    assert not errors and not any(t.is_alive() for t in threads), errors
    return out


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "uneven_mask"])
def test_cross_process_moments_and_score_are_the_global_step(masked):
    """Two ranks, each with its half of a batch of 16 (one shard each, as
    MultiHostRunner gives them), through the BN network's loss and
    gradient: their averaged gradients and loss, and each rank's new BN
    statistics, equal the plain step's on the whole batch. With an uneven
    labels mask (rank 0 keeps 7 of its 8 rows, rank 1 keeps 2) the score
    divides by the global mask's sum, not each rank's. Process-local
    moments (no process group) miss."""
    net = port.MultiLayerNetwork(conf(port)).init(device="cpu")
    x, y = (torch.from_numpy(a) for a in _synthetic(conf(port), 16, 3))
    mask = torch.from_numpy(np.asarray([1] * 7 + [0] + [1] * 2 + [0] * 6,
                                       np.float32)[:, None]) if masked else None
    want_loss, want_g, want_state = net._value_and_grad(x, y, None, mask, True, None)

    def rank_step(r, pg):
        rows = slice(8 * r, 8 * r + 8)
        ctx = shards.ShardContext(0, 1, 8 * r, 8, 16, None, pg)
        with shards.sharded(ctx):
            return net._value_and_grad(x[rows], y[rows], None,
                                       None if mask is None else mask[rows],
                                       True, None)

    got = two_ranks_in_threads(rank_step)
    np.testing.assert_allclose(float(got[0][0] + got[1][0]) / 2, float(want_loss),
                               rtol=1e-5, atol=1e-6)
    flat = lambda tree: port_params.tree_leaves(tree)
    for g0, g1, w in zip(flat(got[0][1]), flat(got[1][1]), flat(want_g)):
        np.testing.assert_allclose(((g0 + g1) / 2).numpy(), w.numpy(),
                                   rtol=1e-5, atol=1e-6)
    for r in range(2):
        for a, w in zip(flat(got[r][2]), flat(want_state)):
            np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)
    local = [net._value_and_grad(x[8 * r:8 * r + 8], y[8 * r:8 * r + 8], None,
                                 None if mask is None else mask[8 * r:8 * r + 8],
                                 True, None) for r in range(2)]
    assert not np.allclose(flat(local[0][2])[0].numpy(), flat(want_state)[0].numpy(),
                           rtol=1e-5, atol=1e-6)


def test_balanced_partition_and_single_process_runner():
    parts = [MultiHostRunner.balanced_partition(10, 3, p) for p in range(3)]
    assert [(s.start, s.stop) for s in parts] == [(0, 4), (4, 7), (7, 10)]
    with pytest.raises(ValueError):
        MultiHostRunner.balanced_partition(10, 3, 3)
    runner = MultiHostRunner(device="cpu", health=False).initialize()
    assert runner.is_chief and runner.process_count == 1
    assert runner.mesh().shape == {"data": 1}
    x, y = _synthetic(conf(port), 16, 1)
    assert runner.my_partition(x).shape == x.shape
    net = port.MultiLayerNetwork(conf(port)).init(device="cpu")
    runner.fit(net, x, y, epochs=1, batch_size=8)
    assert net.iteration == 2
    ev = runner.evaluate(net, x, y)
    assert ev.accuracy() >= 0
    runner.shutdown()
