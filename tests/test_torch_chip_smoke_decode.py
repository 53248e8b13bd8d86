"""chip_smoke.py's decode phases, run on the CPU at a small size.

The four phases of the decode slice run here end to end, cut in size, with
counting stand-ins for the kernels (the plain versions, each call counting
one launch as the kernels' wrappers do): K7 for `decode_attention` and K3
for the packed char model's attention.

- `phase_decode_kernel` (edge cases at a few keys) passes, and fails on a
  stand-in K7 that reads one key past cache_len.
- `phase_decode_serving` (the engine at vocab 64, 2 layers, 2 heads of 8,
  2 clients x 2 prompts x 8 tokens) passes: tokens equal naive_generate's,
  K7 launches = layers x steps, the cache drained, the chaos fault isolated
  to one rider. It fails on that stand-in K7 too, and on a decode step that
  skips the scatter of the new token's K/V into its view.
- `phase_decode_stream` (TextGenerationLSTM at 8 units) passes.
- `phase_packed_admission` (the char model 16 wide, rows of 64 tokens)
  passes, and fails when a packed answer is taken from the wrong segment.

These are kept apart from tests/test_torch_chip_smoke.py, whose run is the
longest of the suite on one worker.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_torch.models import zoo as port_zoo
from deeplearning4j_torch.ops import flash_attention as port_fa
from deeplearning4j_torch.parallel.inference import ParallelInference
from deeplearning4j_torch.serving import decode as port_decode
from test_torch_word2vec import one_torch_thread  # noqa: F401


def _counting_k7(monkeypatch, extra_key=0):
    """K7 stand-ins, `_launch_decode` (what phase_decode_kernel calls) and the
    CPU route of `decode_attention` (what the engine calls), each call
    counting a launch; `extra_key` reads that many keys past cache_len."""
    plain = port_fa.decode_attention_reference

    def k7(q, k, v, cache_len):
        port_fa.decode_launches += 1
        return plain(q, k, v, cache_len + extra_key)

    monkeypatch.setattr(port_fa, "_launch_decode", k7)
    monkeypatch.setattr(port_fa, "decode_attention_reference", k7)
    return plain


def _counting_k3(monkeypatch):
    fwd = port_fa.flash_fwd_reference

    def k3(*a):
        port_fa.fwd_launches += 1
        return fwd(*a)

    monkeypatch.setattr(port_fa, "flash_fwd", k3)
    monkeypatch.setattr(port_fa, "_launch_fwd", k3)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "device_ms", lambda torch, fn, iters=20: 0.0)


# ------------------------------------------------------------ the kernel

SMALL_CASES = [
    ("engine_f32", 3, 32, 2, 8, "float32", 3, True),
    ("long_f32", 2, 64, 2, 16, "float32", 0, True),
    ("long_bf16", 2, 64, 2, 16, "bfloat16", 0, True),
    ("d19_f32", 2, 20, 1, 19, "float32", 0, False),
    ("b1_d8", 1, 16, 1, 8, "float32", 0, False),
]


@pytest.mark.parametrize("case", ["counted", "reads_past_cache_len"])
def test_decode_kernel_phase(no_card, monkeypatch, case):
    monkeypatch.setattr(chip_smoke, "DECODE_CASES", SMALL_CASES)
    plain = _counting_k7(monkeypatch, extra_key=int(case != "counted"))
    # the yardstick stays the plain version
    monkeypatch.setattr(port_fa, "decode_attention_reference", plain)
    _counting_k3(monkeypatch)
    if case != "counted":
        with pytest.raises(RuntimeError, match="decode engine_f32"):
            chip_smoke.phase_decode_kernel(torch, "cpu", device="cpu")
        return
    entry, rows = chip_smoke.phase_decode_kernel(torch, "cpu", device="cpu")
    assert entry["name"] == "decode_attention" and entry["route"] == "cuda"
    assert entry["replaces"] == "deeplearning4j_tpu/ops/flash_attention.py:573"
    assert entry["bound_by"] == "bytes" and entry["bound_ms"] > 0
    assert set(entry["long"]) == {"long_f32", "long_bf16"}
    assert rows["engine_f32"]["strided_view"] and rows["engine_f32"]["max_abs_err"] == 0
    assert rows["engine_f32"]["k3_q1_rel_err"] < 1e-5


def test_decode_edge_lens_straddle_the_split_edges():
    """At 8 splits of 32-key iterations: 1, S - 1, S, S + 1, then either
    side of 32 S and 64 S, and the bucket. A block of 4 warps takes 4 keys
    a lane group an iteration (16 groups of 8 lanes at d 32 in float32, 8
    of 16 at d 128 in bfloat16, 4 of 32 at d 128 in float32); from 512 keys
    of the bucket a block has 8 warps."""
    assert chip_smoke.decode_block_keys(32, 4, 128) == 64
    assert chip_smoke.decode_block_keys(128, 2, 128) == 32
    assert chip_smoke.decode_block_keys(128, 4, 511) == 16
    assert chip_smoke.decode_block_keys(128, 2, 512) == 64
    lens = chip_smoke.decode_edge_lens(12, 512, 8, 32)
    assert lens.tolist() == [1, 7, 8, 9, 255, 256, 257, 511, 512, 511, 512, 512]
    assert chip_smoke.decode_edge_lens(3, 16, 1, 128).tolist() == [1, 1, 1]


def test_decode_step_profile_counts_one_kernel_a_layer(small_decode, monkeypatch):
    """A step whose attention took two device kernels a call (a partial and
    a combine pass) fails the profile's count."""
    _counting_k7(monkeypatch)
    monkeypatch.setattr(chip_smoke, "profile_call", lambda torch, label, fn, info,
                        count=None: (fn(), {"rows": info["rows"], "counted_calls":
                                            2 * SMALL_DECODE["layers"]})[1])
    with pytest.raises(RuntimeError, match="2 layers"):
        chip_smoke.phase_decode_serving(torch, "cpu", device="cpu")


def test_decode_bound_counts_the_valid_prefixes():
    q = torch.zeros(2, 1, 4, 32)
    k = torch.zeros(2, 256, 4, 32)
    lens = torch.tensor([1, 300])   # the second past the bucket: 256 keys
    ms, by = chip_smoke.decode_bound_ms(q, k, lens)
    nbytes = (2 * 257 * 4 * 32 + 2 * 2 * 4 * 32) * 4 + 8
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)


# ------------------------------------------------------------ the engine

SMALL_DECODE = dict(vocab=64, layers=2, heads=2, head_dim=8, ff=32, max_context=64,
                    max_decode_batch=4, block_tokens=8, kv_max_blocks=64,
                    pack_bucket=32, clients=2, prompts_per_client=2,
                    max_new_tokens=8, prompt_lo=3, prompt_hi=10)


@pytest.fixture
def small_decode(no_card, monkeypatch):
    monkeypatch.setattr(chip_smoke, "DECODE_GEOMETRY", SMALL_DECODE)
    monkeypatch.setattr(chip_smoke, "profile_call", _profiled)
    monkeypatch.setattr(chip_smoke, "decode_engine",
                        lambda g, name, device=None: _engine(g, name))


def _profiled(torch, label, fn, info, count=None):
    """profile_call on the CPU: one call of `fn`; the counted kernel calls
    are the stand-in K7's launches in it."""
    before = port_fa.decode_launches
    fn()
    return {"rows": info["rows"], "counted_calls": port_fa.decode_launches - before}


def _engine(g, name, _real=chip_smoke.decode_engine):
    return _real(g, name, device="cpu")


def _skipping_scatter(q, k, v, cache_len, **kw):
    """decode_attention as if the step had not written the new token's K/V
    at cache_len - 1: that row of the view holds zeros, as the cache gave."""
    k, v = k.clone(), v.clone()
    rows = torch.arange(k.shape[0])
    k[rows, cache_len.long() - 1] = 0
    v[rows, cache_len.long() - 1] = 0
    return port_fa.decode_attention(q, k, v, cache_len, **kw)


@pytest.mark.parametrize("case", ["counted", "reads_past_cache_len", "skips_the_scatter"])
def test_decode_serving_phase(small_decode, monkeypatch, case):
    _counting_k7(monkeypatch, extra_key=int(case == "reads_past_cache_len"))
    if case == "skips_the_scatter":
        monkeypatch.setattr(port_decode, "decode_attention", _skipping_scatter)
    if case != "counted":
        with pytest.raises(RuntimeError, match="differ from naive_generate|full recompute"):
            chip_smoke.phase_decode_serving(torch, "cpu", device="cpu")
        return
    out = chip_smoke.phase_decode_serving(torch, "cpu", device="cpu")
    assert out["requests"] == 4 and out["tokens"] == 32 and out["steps"] >= 7
    assert out["launches"]["decode_attention"] == 2 * out["steps"]
    assert sum(out["launches"].values()) == out["launches"]["decode_attention"]
    assert out["all_equal_naive"] and out["kv_blocks_after"] == 0
    assert out["min_top2_margin"] > 0 and out["inter_token_samples"] == 4 * 7
    assert out["chaos"]["died"] == 1 and out["chaos"]["survivor_tokens"] == 8
    assert out["chaos"]["survivor_equals_naive"]
    assert out["step_logits_rel_vs_recompute"] < 1e-5
    assert out["step_profile"] == {"rows": 4, "counted_calls": 2}   # one a layer
    assert 0 < out["kv_utilization_peak"] <= 1


# ------------------------------------------------------------ the stream arm

class _SmallTextGenerationLSTM(port_zoo.TextGenerationLSTM):
    def __init__(self, **kw):
        super().__init__(hidden=8, **kw)


def test_decode_stream_phase(no_card, monkeypatch):
    monkeypatch.setattr(port_zoo, "TextGenerationLSTM", _SmallTextGenerationLSTM)
    for name, value in (("STREAM_PROMPTS", 4), ("STREAM_NEW", 4),
                        ("STREAM_CLIENTS", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.phase_decode_stream(torch, "cpu", device="cpu")
    assert out["rows"] == 16 and out["launches"] == dict.fromkeys(out["launches"], 0)
    assert out["max_abs_vs_direct_stream"] <= 1e-6


def test_decode_stream_phase_catches_a_lost_carry(no_card, monkeypatch):
    """A stream arm that forgets each request's carry between steps gives
    rows that no direct stream gives."""
    monkeypatch.setattr(port_zoo, "TextGenerationLSTM", _SmallTextGenerationLSTM)
    for name, value in (("STREAM_PROMPTS", 2), ("STREAM_NEW", 4),
                        ("STREAM_CLIENTS", 1)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(port_decode.RecurrentAdapter, "_carry_rows", staticmethod(
        lambda carry, i: tuple({k: torch.zeros_like(v[i:i + 1]) for k, v in c.items()}
                               for c in carry)))
    with pytest.raises(AssertionError):
        chip_smoke.phase_decode_stream(torch, "cpu", device="cpu")


# ------------------------------------------------------------ packed admission

@pytest.fixture
def small_packed(no_card, monkeypatch):
    for name, value in (("CHAR_WIDTH", 16), ("PACKED_BUCKET", 64),
                        ("PACKED_T_LO", 4), ("PACKED_T_HI", 20),
                        ("PACKED_CLIENTS", 2), ("PACKED_PER_CLIENT", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    # a row of 64 tokens takes the flash route only when asked (the card's
    # rows of 8192 take it by the dispatch rule)
    conf = chip_smoke.char_conf
    monkeypatch.setattr(chip_smoke, "char_conf",
                        lambda impl="auto", packed=False: conf("pallas", packed))
    _counting_k3(monkeypatch)


def _wrong_segment(self, xs, segmask, _real=ParallelInference._forward_packed):
    """Each request's answer taken from the next segment's rows."""
    out = _real(self, xs, segmask)
    first = int((np.asarray(segmask[0]) == 1).sum())
    return np.roll(out, -first, axis=1)


@pytest.mark.parametrize("case", ["counted", "wrong_segment"])
def test_packed_admission_phase(small_packed, monkeypatch, case):
    if case == "wrong_segment":
        monkeypatch.setattr(ParallelInference, "_forward_packed", _wrong_segment)
        with pytest.raises(RuntimeError, match="served alone"):
            chip_smoke.phase_packed_admission(torch, "cpu", device="cpu")
        return
    out = chip_smoke.phase_packed_admission(torch, "cpu", device="cpu")
    assert out["requests"] == 4 and 1 <= out["packed_forwards"] < 4
    want = dict.fromkeys(out["launches"], 0)
    want["flash_fwd"] = 2 * out["packed_forwards"]
    assert out["launches"] == want
    assert out["max_rel_vs_alone"] <= chip_smoke.PACKED_SERVE_REL
    assert out["chaos"]["failed"] == 1 and out["chaos"]["batch_failures"] >= 2
