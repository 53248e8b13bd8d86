"""chip_smoke.py's tensor, sequence and pipeline parallel phases
(`phase_ring_kernels`, `phase_sequence_parallel`, `phase_tensor_parallel`,
`phase_pipeline`, `phase_multihost_tp_sp`) run on the CPU at a small size:
the char model at width 16 and t 32, the narrow AlexNet of
tests/test_torch_chip_smoke_gateway.py, a pipeline of 16-wide layers, with
counting stand-ins for K1-K5 (the plain versions, each call counting one
launch as the kernels' wrappers do; the ring phase's direct kernel calls
run the plain versions). The two ranks of the multi-process phase are real
subprocesses on the CPU, bounded at 60 s.

- Each phase passes, with its launch counts as on the card.
- The sequence-parallel phase fails on a wrong launch count (a K3 stand-in
  counting two launches a call) and on a wrong ring gradient (the lse's
  gradient dropped in the merge, or dq doubled), and the ring phase on a
  hop that the causal mask hides whole but that leaks a gradient.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_torch.models import zoo as port_zoo
from deeplearning4j_torch.ops import flash_attention as port_fa

from test_torch_chip_smoke_gateway import _NarrowAlexNet
from test_torch_chip_smoke_parallel import counting_standins
from test_torch_word2vec import one_torch_thread  # noqa: F401

RING_SMALL = dict(b=2, t=64, h=2, d=8, shards=2)
SP_SMALL = dict(t=32, batch=2, seq=2, bf16_steps=2, threed_t=16, width=16, heads=4,
                vocab=8)
TP_SMALL = dict(alexnet=((15, 15, 3), 10), batch=8, model=2, timed_steps=1)
PIPE_SMALL = dict(width=16, body=8, classes=10, stages=4, microbatches=8, batch=16,
                  timed_steps=1)


@pytest.fixture
def small(monkeypatch):
    """The narrow AlexNet and counting stand-ins for K1-K5."""
    monkeypatch.setattr(port_zoo, "AlexNet", _NarrowAlexNet)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the spawned ranks
    monkeypatch.setattr(chip_smoke, "MULTIHOST_RUN_S", 60)

    def setup(fwd_per_call=1):
        for mod, name, fn in counting_standins():
            monkeypatch.setattr(mod, name, fn)
        fwd_plain, bwd_plain = port_fa.flash_fwd_reference, port_fa.flash_bwd_reference

        def k3(*a):
            port_fa.fwd_launches += fwd_per_call
            return fwd_plain(*a)

        def k4_k5(*a):
            port_fa.bwd_dkv_launches += 1
            port_fa.bwd_dq_launches += 1
            return bwd_plain(*a)

        monkeypatch.setattr(port_fa, "flash_fwd", k3)
        monkeypatch.setattr(port_fa, "flash_bwd", k4_k5)
        monkeypatch.setattr(port_fa, "_launch_fwd", fwd_plain)
        monkeypatch.setattr(port_fa, "_launch_bwd_dkv",
                            port_fa.flash_bwd_dkv_reference)
        monkeypatch.setattr(port_fa, "_launch_bwd_dq", port_fa.flash_bwd_dq_reference)
    return setup


def test_ring_kernels_phase_passes(small):
    small()
    result = chip_smoke.phase_ring_kernels(torch, "cpu", device="cpu",
                                           size=RING_SMALL)
    hops = result["hops"]
    assert len(hops) == 2 * 4   # two types x every (my, src) of a 2-shard ring
    assert [h["exact_zero"] for h in hops if h["masked_whole"]] == [True, True]
    assert all(h["flash_bwd_dq_rel_err"] <= chip_smoke.FLASH_REL[h["dtype"]]
               for h in hops if not h["masked_whole"])


def test_ring_kernels_phase_fails_on_a_leaking_hidden_hop(small, monkeypatch):
    small()
    plain = port_fa.flash_bwd_dq_reference

    def leaking(*a):   # a gradient where the plain version's is all zero
        dq = plain(*a)
        return dq + 1e-3 if bool((dq == 0).all()) else dq

    monkeypatch.setattr(port_fa, "_launch_bwd_dq", leaking)
    with pytest.raises(RuntimeError, match="hides whole"):
        chip_smoke.phase_ring_kernels(torch, "cpu", device="cpu", size=RING_SMALL)


def test_sequence_parallel_phase_passes(small):
    small()
    result = chip_smoke.phase_sequence_parallel(torch, "cpu", device="cpu",
                                                size=SP_SMALL)
    step = result["f32_step"]
    assert step["launches"] == chip_smoke.ring_launches(2, 2, 1)
    assert step["max_grad_rel_err"] <= chip_smoke.UPDATE_REL_STEP
    assert {"0.Wq", "0.Wk", "1.Wq", "1.Wk"} <= set(step["grad_rel_errs"])
    assert all(step["unpinned_grad_rel_errs"][k] <= c + chip_smoke.UPDATE_REL_STEP
               for k, c in step["control_grad_rel_errs"].items())
    assert result["bf16"]["launches"] == chip_smoke.ring_launches(2, 2, 2)
    assert result["three_d"]["finite"] and result["three_d"]["mesh"] == [1, 2, 2]
    assert result["three_d"]["wq_blocks"] == [[8, 8], [8, 8]]   # [vocab, width / 2]


def test_sequence_parallel_phase_fails_on_a_wrong_launch_count(small):
    small(fwd_per_call=2)
    with pytest.raises(RuntimeError, match="sequence parallel f32 step: launches"):
        chip_smoke.phase_sequence_parallel(torch, "cpu", device="cpu", size=SP_SMALL)


@pytest.mark.parametrize("fault", ["lse_gradient_dropped", "dq_doubled"])
def test_sequence_parallel_phase_fails_on_a_wrong_ring_gradient(small, monkeypatch,
                                                                fault):
    """A ring whose merge drops the lse's gradient (g_lse into K4 and K5), or
    whose hops' dq is doubled, fails the float32 step's gradient hold."""
    small()
    flash = port_fa.flash_attention

    def hop(*a, **kw):   # the ring alone asks for the lse
        if not kw.get("with_lse"):
            return flash(*a, **kw)
        if fault == "lse_gradient_dropped":
            o, lse = flash(*a, **kw)
            return o, lse.detach()
        return flash(_Double.apply(a[0]), *a[1:], **kw)

    monkeypatch.setattr(port_fa, "flash_attention", hop)
    with pytest.raises(RuntimeError, match="sequence parallel f32 step: gradients"):
        chip_smoke.phase_sequence_parallel(torch, "cpu", device="cpu", size=SP_SMALL)


class _Double(torch.autograd.Function):
    """The identity whose backward doubles the gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return 2 * g


def test_tensor_parallel_phase_passes(small):
    small()
    result = chip_smoke.phase_tensor_parallel(torch, "cpu", device="cpu",
                                              size=TP_SMALL)
    step = result["step"]
    assert step["launches"]["lrn_fwd"] == step["launches"]["lrn_bwd"] == 2
    assert step["checkpoint_bitwise"] and step["sharded_params"] > 0
    assert step["max_update_rel_err"] <= chip_smoke.UPDATE_REL_STEP
    assert 0.5 <= step["shard_share"] < 0.75
    assert set(result["step_ms"]) == {"sharded", "plain"}


def test_pipeline_phase_passes(small):
    small()
    result = chip_smoke.phase_pipeline(torch, "cpu", device="cpu", size=PIPE_SMALL)
    assert result["stages_reported"] == [0, 1, 2, 3]
    assert result["bubble_fraction"] == 3 / 11
    assert result["max_update_rel_err"] <= chip_smoke.UPDATE_REL_STEP
    assert len(result["stage_bytes"]) == 4


def test_multihost_tp_sp_phase_passes(small):
    small()
    result = chip_smoke.phase_multihost_tp_sp(torch, "cpu", device="cpu")
    assert result["tp"]["checkpoint_restored_bitwise"]
    for mode in ("tp", "sp"):
        row = result[mode]
        assert row["backend"] == "gloo" and row["ranks_max_abs_diff"] <= 1e-4
        assert abs(row["params_abs_sum"] - row["single_process_abs_sum"]) <= row["hold"]
    assert all(c["hop"] > 0 for c in result["sp"]["cross_ms"])
    assert all(c["param_gather"] > 0 for c in result["tp"]["cross_ms"])
    assert np.isfinite(result["sp"]["params_abs_sum"])
