"""The port's fault-tolerance plane against the JAX package's.

- The fault points' flag-style `check` and `fired_count` (``step.nonfinite``)
  count as the JAX package's do.
- RetryPolicy's delays and `retry_call`'s attempts and sleeps on a fake
  clock: the JAX package's exactly.
- CheckpointManager: the manifest's records, retention (keep_last and
  pinned epochs) and a torn newest file skipped on restore.
- Resume across packages: a directory written by the JAX package's
  CheckpointManager in the middle of an epoch resumes in the port, and the
  other way round; either resumed run matches an uninterrupted run of the
  writer on parameters and optimizer state (rtol 1e-5, atol 1e-7), and a
  port run resumed from its own directory is bitwise its uninterrupted run.
- DivergenceSentinel: `skip_step` on an injected ``step.nonfinite`` leaves
  parameters, optimizer state and the dropout generator bitwise as a run
  that never saw the batch; `warn` counts a real NaN; `rollback` restores
  the newest checkpoint and halves every learning rate.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.data.dataset import DataSet
from deeplearning4j_torch.data.iterators import ExistingDataSetIterator
from deeplearning4j_torch.optimize import resilience as R
from deeplearning4j_torch.utils import faults
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.optimize import resilience as RR
from deeplearning4j_tpu.utils import faults as ref_faults


def _conf(pkg, dropout=0.0):
    return (pkg.NeuralNetConfiguration.builder().seed(8)
            .updater(pkg.Adam(learning_rate=0.01)).list()
            .layer(pkg.DenseLayer(n_out=7, activation="tanh",
                                  dropout_rate=dropout or None))
            .layer(pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(4)).build())


def _data(n=16, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _port(dropout=0.0):
    return port.MultiLayerNetwork(_conf(port, dropout)).init(device="cpu")


def _ref_like(port_net):
    net = ref.MultiLayerNetwork(_conf(ref)).init()
    net.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(port_net.params_tree))
    net.opt_state = jax.tree_util.tree_map(
        jnp.asarray, port_params.opt_state_to_numpy(port_net.opt_state))
    return net


def _close(port_tree, ref_tree, to_numpy=port_params.params_to_numpy):
    for g, w in zip(jax.tree_util.tree_leaves(to_numpy(port_tree)),
                    jax.tree_util.tree_leaves(ref_tree)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-7)


def _equal(a, b):
    for x, y in zip(port_params.tree_leaves(a), port_params.tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("spec", ["fail:2", "fail:1,3", "delay:2@1", "fail:5"])
def test_check_and_fired_count_match_reference(spec):
    got, want = [], []
    for mod, out in ((faults, got), (ref_faults, want)):
        with mod.injected("step.nonfinite", spec):
            out.extend(mod.check("step.nonfinite") for _ in range(4))
            out.append((mod.call_count("step.nonfinite"),
                        mod.fired_count("step.nonfinite")))
    assert got == want
    assert faults.check("step.nonfinite") is False   # disarmed


def test_retry_policy_and_retry_call_match_reference():
    import random
    p, rp = R.RetryPolicy(max_retries=4, deadline=1.0), RR.RetryPolicy(
        max_retries=4, deadline=1.0)
    assert [p.delay(k, random.Random(1)) for k in range(6)] == \
        [rp.delay(k, random.Random(1)) for k in range(6)]

    def run(mod, fail_times):
        clock, slept, calls = [0.0], [], [0]

        def fn():
            calls[0] += 1
            if calls[0] <= fail_times:
                raise OSError("flaky")
            return "ok"

        def sleep(d):
            slept.append(d)
            clock[0] += d

        try:
            out = mod.retry_call(fn, edge="test", policy=mod.RetryPolicy(
                max_retries=3, jitter=0.0, deadline=0.3),
                clock=lambda: clock[0], sleep=sleep)
        except OSError:
            out = "raised"
        return out, calls[0], slept

    for fail_times in (0, 2, 3, 9):
        assert run(R, fail_times) == run(RR, fail_times)


def test_checkpoint_manager_manifest_retention_and_torn_files(tmp_path):
    net = _port()
    x, y = _data()
    mgr = R.CheckpointManager(str(tmp_path), keep_last=2, keep_every_n_epochs=1,
                              save_every_n_iterations=3)
    net.fit(x, y, epochs=2, batch_size=4, checkpoint=mgr)
    recs = mgr.checkpoints()
    # mid-epoch saves at 3 and 6 pruned to the newest two, epoch ends pinned
    assert [(r["iteration"], r["epoch"], r["batches_into_epoch"]) for r in recs] == \
        [(4, 1, 0), (6, 1, 2), (8, 2, 0)]
    assert sorted(os.listdir(tmp_path)) == sorted(
        [r["file"] for r in recs] + ["manifest.json"])
    with open(tmp_path / recs[-1]["file"], "r+b") as f:   # tear the newest
        f.truncate(100)
    rec = mgr.latest_valid()
    assert rec["iteration"] == 6
    restored, rec2 = mgr.restore_latest(device="cpu")
    assert rec2 == rec and restored.iteration == 6 and restored.epoch == 1
    with open(tmp_path / "manifest.json") as f:
        assert json.load(f)["format_version"] == 1


def _interrupted(mgr_cls, net, x, y):
    """Fit one epoch of 4 batches saving every 3 iterations only: the newest
    checkpoint sits 3 batches into epoch 1."""
    fit_kw = {} if isinstance(net, port.MultiLayerNetwork) else {"use_async": False}
    mgr = mgr_cls(net._ckpt_dir, save_every_n_iterations=3, save_every_n_epochs=None)
    net.fit(x, y, epochs=1, batch_size=4, checkpoint=mgr, **fit_kw)
    return mgr


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_checkpoint_directory_resumes_in_the_other_package(tmp_path, writer):
    x, y = _data()
    base = _port()
    if writer == "jax":
        w_net, w_full = _ref_like(base), _ref_like(base)
        w_cls, r_cls = RR.CheckpointManager, R.CheckpointManager
        reader = _port()
        w_full.fit(x, y, epochs=2, batch_size=4, use_async=False)
    else:
        w_net, w_full = _port(), _port()
        w_cls, r_cls = R.CheckpointManager, RR.CheckpointManager
        reader = ref.MultiLayerNetwork(_conf(ref)).init()
        w_full.fit(x, y, epochs=2, batch_size=4)
    w_net._ckpt_dir = str(tmp_path)
    _interrupted(w_cls, w_net, x, y)
    kw = {} if writer == "jax" else {"use_async": False}
    reader.fit(x, y, epochs=2, batch_size=4, resume=True,
               checkpoint=r_cls(str(tmp_path), save_every_n_iterations=3), **kw)
    assert reader.iteration == w_full.iteration == 8
    assert reader.epoch == 2
    if writer == "jax":
        _close(reader.params_tree, w_full.params_tree)
        _close(reader.opt_state, w_full.opt_state, port_params.opt_state_to_numpy)
    else:
        _close(w_full.params_tree, reader.params_tree)
        _close(w_full.opt_state, reader.opt_state, port_params.opt_state_to_numpy)


def test_a_resumed_port_run_is_bitwise_its_uninterrupted_run(tmp_path):
    x, y = _data()
    full, first = _port(), _port()
    full.fit(x, y, epochs=2, batch_size=4)
    first._ckpt_dir = str(tmp_path)
    _interrupted(R.CheckpointManager, first, x, y)
    resumed = _port()
    resumed.fit(x, y, epochs=2, batch_size=4, resume=True,
                checkpoint=R.CheckpointManager(str(tmp_path)))
    assert resumed.iteration == 8 and resumed.epoch == 2
    _equal(resumed.params_tree, full.params_tree)
    _equal(resumed.opt_state, full.opt_state)


def test_skip_step_drops_the_batch_bitwise_dropout_generator_included():
    x, y = _data(16, seed=6)
    batches = [DataSet(x[i:i + 4], y[i:i + 4]) for i in range(0, 16, 4)]
    skipped, without = _port(dropout=0.3), _port(dropout=0.3)
    sentinel = R.DivergenceSentinel("skip_step")
    with faults.injected("step.nonfinite", "fail:2"):
        skipped.fit(ExistingDataSetIterator(batches), sentinel=sentinel)
    without.fit(ExistingDataSetIterator([batches[0]] + batches[2:]))
    assert sentinel.nonfinite_steps == 1
    assert skipped.iteration == without.iteration == 3
    _equal(skipped.params_tree, without.params_tree)
    _equal(skipped.opt_state, without.opt_state)
    assert torch.equal(skipped._dropout_gen.get_state(), without._dropout_gen.get_state())
    # the JAX package drops the same step (no dropout: its key stream differs)
    net = _port()
    ref_net = _ref_like(net)
    with faults.injected("step.nonfinite", "fail:2"):
        net.fit(ExistingDataSetIterator(batches), sentinel=R.DivergenceSentinel("skip_step"))
    with ref_faults.injected("step.nonfinite", "fail:2"):
        ref_net.fit(x, y, batch_size=4, use_async=False,
                    sentinel=RR.DivergenceSentinel("skip_step"))
    _close(net.params_tree, ref_net.params_tree)


def test_warn_counts_a_real_nan_and_rollback_backs_off(tmp_path):
    x, y = _data()
    net = _port()
    warn = R.DivergenceSentinel("warn")
    bad = x.copy()
    bad[5, 0] = np.nan
    net.fit(bad, y, batch_size=4, sentinel=warn)
    assert warn.nonfinite_steps >= 1
    net = _port()
    mgr = R.CheckpointManager(str(tmp_path), save_every_n_iterations=2)
    sentinel = R.DivergenceSentinel("rollback", checkpoint=mgr, lr_backoff=0.5)
    lrs = [l.updater.learning_rate for l in net.layers]
    with faults.injected("step.nonfinite", "fail:3"):
        net.fit(x, y, batch_size=4, checkpoint=mgr, sentinel=sentinel)
    assert sentinel.rollbacks == 1
    assert [l.updater.learning_rate for l in net.layers] == [lr * 0.5 for lr in lrs]
    with pytest.raises(ValueError, match="rollback"):
        R.DivergenceSentinel("rollback")
    with pytest.raises(ValueError, match="check_every=1"):
        R.DivergenceSentinel("skip_step", check_every=2)
