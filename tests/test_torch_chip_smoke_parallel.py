"""chip_smoke.py's scale-out phases (`phase_federation`,
`phase_parallel_wrapper`, `phase_param_server`, `phase_multihost`) run on
the CPU at a small size: the AlexNet-shaped net of
tests/test_torch_chip_smoke_gateway.py (a few channels wide at 15x15x3,
two LRN layers), LeNet at 28x28x1, the decoder at vocab 64, with counting
stand-ins for K1, K2 and K7 (the plain versions, each call counting one
launch as the kernels' wrappers do). The federation's replicas and the
runner's ranks are real subprocesses; a replica installs the same
stand-ins through `small_replica_builder`, and a rank on the CPU counts
nothing, as the port's wrappers count only kernel launches. Every spawned
run is bounded at 60 s.

- Each phase passes, with its launch counts, failovers, evictions, swap
  and exits as on the card.
- The wrapper phase fails on a wrong launch count (a K1 stand-in counting
  two launches a call).
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_torch.models import zoo as port_zoo
from deeplearning4j_torch.ops import flash_attention as port_fa
from deeplearning4j_torch.ops import lrn as port_lrn

from test_torch_chip_smoke_gateway import SMALL, _NarrowAlexNet

HERE = os.path.dirname(os.path.abspath(__file__))
SPAWN_S = 60
DECODE = SMALL["decode"]
FED_SMALL = dict(alexnet=((15, 15, 3), 10), clients=2, bodies=4, max_rows=2,
                 load_s=1.0, gen_clients=2, gen_prompts=2, kill_predict_clients=2,
                 kill_generate_clients=2, kill_new_tokens=24,
                 decode_step_delay_ms=20, train_batch=4,
                 train_steps=2, swap_clients=2, swap_inputs=2, batch_limit=4,
                 decode=DECODE)
WRAPPER_SMALL = dict(alexnet=((15, 15, 3), 10), batch=8, shards=2, sync_steps=2,
                     local_freq=2, local_steps=4, local_batches=2, timed_steps=1)
PS_SMALL = dict(alexnet=((15, 15, 3), 10), batch=8, seq_steps=2, async_batches=2,
                async_epochs=4, workers=2, staleness=(1, 0), lenet=((28, 28, 1), 10),
                lenet_batch=4)


def counting_standins(per_call=1):
    """(module, name, stand-in) for K1, K2 and K7: the plain versions, each
    call counting as the kernels' wrappers count."""
    lrn_plain, bwd_plain = port_lrn.lrn_reference, port_lrn.lrn_bwd_reference
    k7_plain = port_fa.decode_attention_reference

    def k1(x, *h):
        port_lrn.launches += per_call
        return lrn_plain(x, *h)

    def k2(x, g, *h):
        port_lrn.bwd_launches += 1
        return bwd_plain(x, g, *h)

    def k7(q, k, v, cache_len):
        port_fa.decode_launches += 1
        return k7_plain(q, k, v, cache_len)

    return [(port_lrn, "lrn_fwd", k1), (port_lrn, "lrn_bwd", k2),
            (port_fa, "decode_attention_reference", k7)]


def small_replica_builder(gateway):
    """A federation replica at the small size: the narrow AlexNet and the
    counting stand-ins, then chip_smoke's own builder."""
    for mod, name, fn in counting_standins():
        setattr(mod, name, fn)
    port_zoo.AlexNet = _NarrowAlexNet
    chip_smoke.federation_builder(gateway)


@pytest.fixture
def small(monkeypatch):
    """The narrow AlexNet, counting stand-ins and bounded waits."""
    monkeypatch.setattr(port_zoo, "AlexNet", _NarrowAlexNet)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the spawned replicas and ranks
    for attr in ("FEDERATION_JOIN_S", "FEDERATION_WAIT_S", "MULTIHOST_RUN_S"):
        monkeypatch.setattr(chip_smoke, attr, SPAWN_S)

    def setup(per_call=1):
        for mod, name, fn in counting_standins(per_call):
            monkeypatch.setattr(mod, name, fn)
    return setup


def test_federation_phase_passes(small, monkeypatch):
    small()
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [HERE, os.environ.get("PYTHONPATH", "")]))
    result = chip_smoke.phase_federation(
        torch, "cpu", device="cpu", size=FED_SMALL,
        builder="test_torch_chip_smoke_parallel:small_replica_builder")
    for rid, c in result["replica_launches"].items():
        assert c["lrn_fwd"] == 2 * c["forwards"]
        assert c["decode_attention"] == DECODE["layers"] * c["decode_steps"]
    assert min(result["dispatched"].values()) >= 1
    assert result["http"]["requests"] >= 2 and result["generate_answers"] >= 1
    kill = result["kill"]
    assert kill["failed_predicts"] == 0 and kill["failover_retries_ok"] >= 1
    assert kill["generate_cut"] >= 1 and kill["evictions"] >= 1
    assert result["respawn"]["states"][-1] == "healthy"
    assert "joining" in result["respawn"]["states"]
    assert result["swap"]["answers"]["after_swap"] >= 2


def test_parallel_wrapper_phase_passes(small):
    small()
    result = chip_smoke.phase_parallel_wrapper(torch, "cpu", device="cpu",
                                               size=WRAPPER_SMALL)
    assert result["sync"]["launches"]["lrn_fwd"] == 2 * 2 * 2
    assert result["sync"]["launches"]["lrn_bwd"] == 2 * 2 * 2
    assert result["sync"]["max_update_rel_err_step1"] <= chip_smoke.UPDATE_REL_STEP
    assert result["sync"]["max_update_rel_err"] <= chip_smoke.UPDATE_REL_FIT
    assert result["local_sgd"]["launches"]["lrn_fwd"] == 2 * 2 * 4
    assert result["local_sgd"]["bitwise"]
    assert set(result["step_ms"]) == {"sharded", "plain"}


def test_parallel_wrapper_phase_fails_on_a_wrong_launch_count(small):
    small(per_call=2)
    with pytest.raises(RuntimeError, match="wrapper sync: launches"):
        chip_smoke.phase_parallel_wrapper(torch, "cpu", device="cpu",
                                          size=WRAPPER_SMALL)


def test_param_server_phase_passes(small):
    small()
    result = chip_smoke.phase_param_server(torch, "cpu", device="cpu", size=PS_SMALL)
    assert result["one_worker"]["bitwise"]
    assert result["one_worker"]["launches"]["lrn_fwd"] == 2 * 2
    assert set(result["workers"]) == {"1", "0"}
    for w in result["workers"].values():
        assert w["applied"] == 8 and w["launches"]["lrn_bwd"] == \
            2 * (w["applied"] + w["stale_drops"])
        assert w["last_loss"] < w["first_loss"]
    assert result["http"]["remote_applied"] == 2


def test_multihost_phase_passes(small):
    small()
    conf = _NarrowAlexNet(input_shape=(15, 15, 3), num_labels=10).conf().to_json()
    result = chip_smoke.phase_multihost(torch, "cpu", device="cpu", size=dict(
        conf=conf, rank_batch=4, steps=3, health_timeout_s=5.0,
        health_interval_s=0.2, exit_slack_s=10.0, grace_delay_ms=300))
    sync = result["sync"]
    assert sync["steps"] == 3 and sync["backend"] == "gloo"
    assert sync["max_update_rel_err"] <= chip_smoke.UPDATE_REL_FIT
    assert len(sync["allreduce_ms"]) == 3
    assert result["kill"]["rank0_exit"] == 17
    assert 1 <= result["grace"]["checkpoint_step"] <= 3
