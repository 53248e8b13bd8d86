"""chip_smoke.py's phases for heads wider than 128 and the bfloat16 backward
accumulator, run on the CPU at a small size.

The three phases run here end to end, cut in size, with counting stand-ins
for the kernels (the plain versions, each call counting one launch in the
counter of the arm the wrapper would take: the sliced arms above head_dim
128, the accumulator's arms where a JAX block is given):

- `phase_wide_kernels` (head_dim 160 and 300, the accumulator at blocks 32
  and 16, K7 at 160 and 300) passes, and fails on a stand-in accumulator
  that sums in float32 or rounds at the wrong block edges, and on a stand-in
  sliced K3 that drops the ragged last slice.
- `phase_char_model_wide` (2 heads of 136, t 32, batch 2, 2 steps) passes:
  the sliced K3 twice an `output`, K3-K5 twice a step, gradients equal to
  the plain versions' and to the CPU's.
- `phase_decode_wide` (2 layers x 2 heads of 136) passes: K7's sliced arm
  once a layer a step, every answer the plain version's and
  `naive_generate`'s.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_torch.ops import flash_attention as port_fa
from test_torch_word2vec import one_torch_thread  # noqa: F401


def _bump(name):
    setattr(port_fa, name, getattr(port_fa, name) + 1)


def _arm(kernel, d, acc_block):
    if acc_block:
        return f"bwd_{kernel}_acc16_launches"
    return f"bwd_{kernel}_wide_launches" if d > port_fa.MAX_HEAD_DIM \
        else f"bwd_{kernel}_launches"


@pytest.fixture
def kernels(monkeypatch):
    """Counting stand-ins for every launch wrapper and for the CPU routes the
    networks and the engine take (the plain versions, counted as the
    wrappers count). Returns the plain versions, for stand-ins of faults."""
    plain = {"fwd": port_fa.flash_fwd_reference, "dkv": port_fa.flash_bwd_dkv_reference,
             "dq": port_fa.flash_bwd_dq_reference, "bwd": port_fa.flash_bwd_reference,
             "decode": port_fa.decode_attention_reference}

    def launch_fwd(q, *a):
        _bump("fwd_wide_launches" if q.shape[-1] > port_fa.MAX_HEAD_DIM else "fwd_launches")
        return plain["fwd"](q, *a)

    def launch_dkv(*a, acc_block=0):
        _bump(_arm("dkv", a[0].shape[-1], acc_block))
        return plain["dkv"](*a, acc_block=acc_block)

    def launch_dq(*a, acc_block=0):
        _bump(_arm("dq", a[0].shape[-1], acc_block))
        return plain["dq"](*a, acc_block=acc_block)

    def bwd(*a, acc_blocks=(0, 0)):
        _bump(_arm("dkv", a[0].shape[-1], acc_blocks[0]))
        _bump(_arm("dq", a[0].shape[-1], acc_blocks[1]))
        return plain["bwd"](*a, acc_blocks=acc_blocks)

    def k7(q, k, v, cache_len, splits=None):
        _bump("decode_wide_launches" if q.shape[-1] > port_fa.MAX_HEAD_DIM
              else "decode_launches")
        return plain["decode"](q, k, v, cache_len)

    for name, fn in (("_launch_fwd", launch_fwd), ("_launch_bwd_dkv", launch_dkv),
                     ("_launch_bwd_dq", launch_dq), ("flash_fwd", launch_fwd),
                     ("flash_bwd", bwd), ("_launch_decode", k7),
                     ("decode_attention_reference", k7)):
        monkeypatch.setattr(port_fa, name, fn)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "device_ms", lambda torch, fn, iters=20: 0.0)
    monkeypatch.setattr(chip_smoke, "cuda_time_ms", lambda fn, iters=20, warm=3:
                        (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "profile_call", _profiled)
    return plain


def _profiled(torch, label, fn, info, count=None):
    """profile_call on the CPU: one call of `fn`; the counted kernel calls
    are the stand-in K7w's launches in it."""
    before = port_fa.decode_wide_launches
    fn()
    return {**info, "counted_calls": port_fa.decode_wide_launches - before}


# ------------------------------------------------------------ the kernels

#: every key of a kernel's entry in the `kernels` line
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
               "plain_ms", "bound_ms", "bound_by", "library_ms")

SMALL_FLASH = [
    ("wide_model_f32", 1, 40, 40, 2, 160, "float32", True, {}, True),
    ("d300_bfloat16_segments", 1, 48, 48, 1, 300, "bfloat16", True, {"segments": True},
     False),
    ("d300_float32_key_mask", 2, 24, 24, 1, 300, "float32", True, {"key_mask": True},
     False),
]
SMALL_ACC16 = [
    ("acc16_model_f32_128", 1, 64, 2, 160, "float32", 32, {}, True),
    ("acc16_d130_bf16_16", 2, 48, 1, 130, "bfloat16", 16, {"key_mask": True}, False),
    ("acc16_d136_f32_16_t32", 1, 32, 1, 136, "float32", 16,
     {"segments": True, "plain_bound": True}, False),
]
SMALL_DECODE = [
    ("wide_engine_f32", 3, 16, 2, 160, "float32", 2, True),
    ("d300_bf16", 2, 20, 1, 300, "bfloat16", 0, False),
    ("wide_engine_short_bf16", 3, 16, 2, 136, "bfloat16", 2, True),
]


@pytest.fixture
def small_kernels(kernels, monkeypatch):
    for name, value in (("FLASH_WIDE_CASES", SMALL_FLASH), ("ACC16_CASES", SMALL_ACC16),
                        ("DECODE_WIDE_CASES", SMALL_DECODE), ("CHAR_T", 32),
                        ("CHAR_BATCH", 1), ("WIDE_CHAR_HEADS", 2), ("WIDE_HEAD", 136)):
        monkeypatch.setattr(chip_smoke, name, value)
    return kernels


def test_wide_kernels_phase(small_kernels):
    entries, rows = chip_smoke.phase_wide_kernels(torch, "cpu", device="cpu")
    assert [e["name"] for e in entries] == list(chip_smoke.WIDE_COUNTS)
    for e in entries:
        assert e["route"] == "cuda" and e["bound_ms"] > 0 and e["max_abs_err"] == 0
        assert set(KERNEL_KEYS) <= set(e)
    assert {e["source"] for e in entries} == {
        "deeplearning4j_torch/ops/csrc/flash_attention.cu",
        "deeplearning4j_torch/ops/csrc/decode_attention.cu"}
    path = rows["acc16_path"]["launches"]
    assert {k: v for k, v in path.items() if v} == {
        "flash_fwd_wide": 1, "flash_bwd_dkv_acc16": 1, "flash_bwd_dq_acc16": 1}
    assert [e["launches"] for e in entries if "acc16" in e["name"]] == [1, 1]
    assert rows["acc16_d130_bf16_16"]["jax_block"] == 16
    held = rows["acc16_d136_f32_16_t32"]
    assert len(held["plain_bound"]) == 3 and all(m > 0 for m in held["plain_bound"])
    assert rows["wide_model_f32"]["fully_masked_rows"] == 0
    assert rows["d300_float32_key_mask"]["fully_masked_rows"] > 0
    # K7w: warm and cold times of the kernel, its plain version and SDPA;
    # the short case's lengths drawn in DECODE_WIDE_LENS' span
    k7w = next(e for e in entries if e["name"] == "decode_attention_wide")
    assert "ms_cold" in k7w and set(k7w["cases"]) == {"wide_engine_f32",
                                                      "wide_engine_short_bf16"}
    for label in k7w["cases"]:
        row = rows[label]
        assert {"ms_cold", "plain_ms_cold", "library_ms_cold"} <= set(row)
        assert row["cold_sets"] >= 2 and row["geometry"]["smem"] > 0
    lo, hi = chip_smoke.DECODE_WIDE_LENS["wide_engine_short_bf16"]
    assert all(lo <= n <= hi for n in rows["wide_engine_short_bf16"]["lens"][2:])


@pytest.mark.parametrize("fault", ["float32_sums", "twice_the_block"])
def test_wide_kernels_phase_fails_on_a_wrong_accumulator(small_kernels, monkeypatch,
                                                         fault):
    """A dq arm that ignores the bfloat16 accumulator, or rounds at the edges
    of blocks twice the JAX package's, differs in far more than
    ACC16_SHARE of its entries."""
    plain = small_kernels["dq"]

    def wrong(*a, acc_block=0):
        _bump(_arm("dq", a[0].shape[-1], acc_block))
        block = 0 if fault == "float32_sums" else 2 * acc_block
        return plain(*a, acc_block=block)

    monkeypatch.setattr(port_fa, "_launch_bwd_dq", wrong)
    with pytest.raises(RuntimeError, match="flash_bwd_dq_acc16 acc16_model_f32_128"):
        chip_smoke.phase_wide_kernels(torch, "cpu", device="cpu")


def test_wide_kernels_phase_fails_on_a_dropped_slice(small_kernels, monkeypatch):
    plain = small_kernels["fwd"]

    def dropped(q, *a):
        _bump("fwd_wide_launches")
        o, lse = plain(q, *a)
        o = o.clone()
        o[..., 128:] = 0
        return o, lse

    monkeypatch.setattr(port_fa, "_launch_fwd", dropped)
    with pytest.raises(RuntimeError, match="flash_fwd_wide wide_model_f32"):
        chip_smoke.phase_wide_kernels(torch, "cpu", device="cpu")


def test_wide_tolerances():
    """float32 grows with head_dim from 128 up; bfloat16 stays FLASH_REL's."""
    assert chip_smoke.flash_wide_rel(64, "float32") == 1e-5
    assert chip_smoke.flash_wide_rel(2688, "float32") == pytest.approx(21e-5)
    assert chip_smoke.flash_wide_rel(2688, "bfloat16") == 1e-2
    assert chip_smoke.ACC16_REL == 2.0 ** -7


def test_wide_cases_cover_the_issue_shapes():
    """Every head_dim of the sliced arms' checks, each in both types with a
    causal mask, a key mask and segments; the accumulator at blocks 128 and
    32; K7 at 256 and 2688."""
    cases = chip_smoke.FLASH_WIDE_CASES
    for d in (256, 160, 300, 512, 2688):
        for dtype in ("float32", "bfloat16"):
            opts = [c[8] for c in cases if c[5] == d and c[6] == dtype]
            assert {} in opts and {"key_mask": True} in opts and \
                {"segments": True} in opts, (d, dtype)
    model = next(c for c in cases if c[0] == "wide_model_f32")
    assert model[1:7] == (4, 8192, 8192, 4, 256, "float32") and model[-1]
    assert next(c for c in cases if c[5] == 2688)[2] == 128
    assert {c[6] for c in chip_smoke.ACC16_CASES} >= {128, 32}
    assert {c[4] for c in chip_smoke.DECODE_WIDE_CASES} >= {256, 2688}
    # the wide decoder is bench_serving_decode's engine with Gemma 2B's widths
    wide, base = chip_smoke.DECODE_WIDE_GEOMETRY, chip_smoke.DECODE_GEOMETRY
    assert {k for k in base if wide[k] != base[k]} == {"heads", "head_dim", "ff"}
    assert (wide["heads"], wide["head_dim"], wide["ff"]) == (8, 256, 16384)


#: PR 24's cases, which every later case list keeps
PR24_FLASH = {"wide_model_f32", "wide_model_bf16", "d300_float32_noncausal",
              "d300_float32_offsets", "d256_float32_tq1", "d2689_float32"} | {
    f"d{d}_{dtype}_{name}" for d in (256, 160, 300, 512, 2688)
    for dtype in ("float32", "bfloat16") for name in ("causal", "key_mask", "segments")}
PR24_ACC16 = {"acc16_model_f32_128", "acc16_d256_f32_32", "acc16_d256_bf16_128",
              "acc16_d256_bf16_32", "acc16_d300_f32_32", "acc16_d2688_f32_128",
              "acc16_d2688_bf16_32", "acc16_d64_bf16_128", "acc16_d100_f32_100"}


def test_wide_cases_keep_pr24_and_hold_the_cluster_edges():
    """Every PR 24 case stays; the clustered arms' edges are added in both
    types, for the sliced arms and the accumulator: head_dim 1024 (one
    cluster of 8, the portable size) and 1152 (9 chunks, two passes), and a
    bfloat16 head_dim 300 whose tensors sit 8 bytes into their storage."""
    flash = {c[0]: c for c in chip_smoke.FLASH_WIDE_CASES}
    acc16 = {c[0]: c for c in chip_smoke.ACC16_CASES}
    assert PR24_FLASH <= set(flash) and PR24_ACC16 <= set(acc16)
    for d, want in ((1024, (1, 8)), (1152, (2, 5))):
        g = port_fa.wide_geometry(d)
        assert (g["passes"], g["cluster"]) == want
        for dtype in ("float32", "bfloat16"):
            assert any(c[5] == d and c[6] == dtype for c in flash.values()), (d, dtype)
            assert any(c[4] == d and c[5] == dtype for c in acc16.values()), (d, dtype)
    off = flash["d300_bfloat16_offset8"]
    assert off[5:7] == (300, "bfloat16") and off[8] == {"offset": 4}


#: PR 25's cases, which every later case list keeps
PR25_FLASH = {"d1024_float32_segments", "d1024_bfloat16_segments",
              "d1152_float32_key_mask", "d1152_bfloat16_key_mask", "d300_bfloat16_offset8"}
PR25_ACC16 = {"acc16_d1024_f32_32", "acc16_d1024_bf16_128", "acc16_d1152_f32_128",
              "acc16_d1152_bf16_32"}


def test_wide_cases_keep_pr25_and_hold_k5a_at_t64_with_segments():
    """Every PR 24 and PR 25 case stays, each ACC16 case but the new one
    still held to ACC16_SHARE; the accumulator at head_dim 1024, b 1, t 64
    with segments joins in both types, held to the plain version's own
    spread (plain_bound)."""
    flash = {c[0] for c in chip_smoke.FLASH_WIDE_CASES}
    acc16 = {c[0]: c for c in chip_smoke.ACC16_CASES}
    assert PR24_FLASH | PR25_FLASH <= flash and PR24_ACC16 | PR25_ACC16 <= set(acc16)
    held = {name for name, c in acc16.items() if c[7].get("plain_bound")}
    assert held == {"acc16_d1024_f32_32_t64", "acc16_d1024_bf16_32_t64"}
    for name in held:
        label, b, t, h, d, dtype, jb, opts, timed = acc16[name]
        assert (b, t, d, jb, opts["segments"], timed) == (1, 64, 1024, 32, True, False)
    assert {acc16[n][5] for n in held} == {"float32", "bfloat16"}


def _t64_segments_case(dtype=torch.float32):
    """The new accumulator case's inputs on the CPU (b 1, t 64, 2 heads of
    1024, segments) and its backward's arguments."""
    gen = torch.Generator().manual_seed(26)
    q, k, v, do, km, qs, ks, qp, kp = chip_smoke._flash_inputs(
        torch, gen, 1, 64, 64, 2, 1024, dtype, {"segments": True}, device="cpu")
    scale = 1024 ** -0.5
    ow, lw = port_fa.flash_fwd_reference(q, k, v, km, qs, ks, qp, kp, scale, True)
    gl = torch.where(lw > port_fa.NEG / 2, torch.randn(lw.shape, generator=gen), 0.0)
    di = (ow.float() * do.float()).sum(-1)
    return (q, k, v, do, lw, di, gl, km, qs, ks, qp, kp, scale, True)


@pytest.mark.parametrize("fault", ["float32_sums", "other_block", "block_8"])
def test_acc16_plain_bound_refuses_a_wrong_accumulator(fault):
    """The plain-spread bound of the t-64 case passes the plain version at
    the case's block (32) and refuses a dq summed in float32, one rounded at
    the JAX package's default block there (64), and one rounded at 8: all
    within ACC16_REL of it, so the bound is what refuses them."""
    args = _t64_segments_case()
    bound, = chip_smoke.acc16_plain_bound(port_fa, args, 32, "dq")
    assert bound > 0
    want = port_fa.flash_bwd_dq_reference(*args, acc_block=32)
    chip_smoke._check_acc16(torch, "t64", want.clone(), want, {}, "dq", bound)
    got = port_fa.flash_bwd_dq_reference(
        *args, acc_block={"float32_sums": 0, "other_block": 64, "block_8": 8}[fault])
    assert chip_smoke._rel_err(got, want) <= chip_smoke.ACC16_REL
    assert (got - want).abs().mean().item() > 3 * bound
    with pytest.raises(RuntimeError, match="the plain version's spread"):
        chip_smoke._check_acc16(torch, "t64", got, want, {}, "dq", bound)


def _dq_ring_1152(rank, pass_):
    """The K5w ring order of the design at head_dim 1152 (9 chunks, two
    passes of 5 blocks): block r owns chunks r and r + 5 (block 4 only 4),
    the one of its output slice (r in pass 0, r + 5 in pass 1) last, each
    chunk dO's and V's, then Q's and K's."""
    order = [4] if rank == 4 else [rank + 5, rank] if pass_ == 0 else [rank, rank + 5]
    return [(c, ops) for c in order for ops in ("dO V", "Q K")]


@pytest.mark.parametrize("fault", [None, "chunks_reversed", "operands_swapped",
                                   "other_chunk", "one_pass_operands"])
def test_dq_ring_hold_refuses_a_wrong_order(monkeypatch, fault):
    """`check_dq_ring` (the card's hold of the order K5w's kernel reports)
    passes the design's order at head_dim 256 (one pass) and 1152 (two), and
    refuses a block that takes its chunks in the other order, dO's and V's
    after Q's and K's, another chunk, or Q's and K's in one pass."""
    def ring(d, rank, pass_):
        if d == 256:
            return [(rank, "Q K" if fault == "one_pass_operands" else "K V")]
        steps = _dq_ring_1152(rank, pass_)
        if (rank, pass_) == (1, 1):
            if fault == "chunks_reversed":
                steps = steps[2:] + steps[:2]
            elif fault == "operands_swapped":
                steps = [steps[1], steps[0], steps[3], steps[2]]
            elif fault == "other_chunk":
                steps = [(2, ops) for _, ops in steps[:2]] + steps[2:]
        return steps

    monkeypatch.setattr(port_fa, "kernel_dq_ring", ring)
    if fault is None:
        for d in (256, 1152):
            chip_smoke.check_dq_ring(port_fa, d)
        return
    with pytest.raises(RuntimeError, match="dq ring"):
        chip_smoke.check_dq_ring(port_fa, 256 if fault == "one_pass_operands" else 1152)


def test_offset_inputs_are_8_byte_aligned_views():
    """The offset option shifts q, k, v and do 4 bfloat16 elements into
    storages of their own: contiguous, 8-byte but not 16-byte aligned, so
    the arms' loads take 8 bytes a copy at head_dim 300."""
    gen = torch.Generator().manual_seed(0)
    ins = chip_smoke._flash_inputs(torch, gen, 1, 8, 8, 2, 300, torch.bfloat16,
                                   {"offset": 4}, device="cpu")
    for x in ins[:4]:
        assert x.is_contiguous() and x.data_ptr() % 8 == 0 and x.data_ptr() % 16 == 8
    geom = chip_smoke._wide_row_geometry(port_fa, 300, *ins[:4])
    assert geom == {"chunks": 3, "passes": 1, "cluster": 3, "load_width": 8}


def test_sdpa_backend_names_a_backend_or_says_unknown():
    q = torch.zeros(1, 2, 8, 256)
    name = chip_smoke.sdpa_backend(torch, q, q, q, True)
    assert isinstance(name, str) and name


# ------------------------------------------------------------ the char model

SMALL_CHAR = dict(width=272, heads=2, t=32, batch=2, steps=2, small_t=16)


def test_char_model_wide_phase(kernels):
    result = chip_smoke.phase_char_model_wide(torch, "cpu", device="cpu", size=SMALL_CHAR)
    assert result["head_dim"] == 136
    for name in ("f32", "bf16"):
        r = result[name]
        assert {k: v for k, v in r["output_launches"].items() if v} == {"flash_fwd_wide": 2}
        assert {k: v for k, v in r["launches"].items() if v} == {
            "flash_fwd_wide": 4, "flash_bwd_dkv_wide": 4, "flash_bwd_dq_wide": 4}
        assert len(r["scores"]) == 2 and r["tokens_per_s"] > 0
    assert result["grad_rel_vs_plain"]["worst_rel"] == 0
    assert result["grad_rel_vs_cpu"]["worst_rel"] == 0


def test_char_model_wide_phase_refuses_narrow_heads(kernels):
    with pytest.raises(RuntimeError, match="not the sliced arms"):
        chip_smoke.phase_char_model_wide(torch, "cpu", device="cpu",
                                         size=dict(SMALL_CHAR, width=256))


# ------------------------------------------------------------ the decoder

SMALL_DECODER = dict(vocab=64, layers=2, heads=2, head_dim=136, ff=32, max_context=64,
                     max_decode_batch=4, block_tokens=8, kv_max_blocks=64,
                     pack_bucket=32, clients=2, prompts_per_client=2, max_new_tokens=6,
                     prompt_lo=3, prompt_hi=10)


def test_decode_wide_phase(kernels):
    result = chip_smoke.phase_decode_wide(torch, "cpu", device="cpu", size=SMALL_DECODER)
    assert result["requests"] == 4 and result["tokens"] == 24
    assert {k: v for k, v in result["launches"].items() if v} == {
        "decode_attention_wide": 2 * result["steps"]}
    assert result["all_equal_plain"] and result["all_equal_naive"]
    assert np.isfinite(result["inter_token_p99_ms"])
    assert result["step_profile"] == {"rows": 4, "counted_calls": 2}   # one a layer


# ------------------------------------------------------------ K7w's holds

def test_no_spill_hold():
    """`check_no_spill` keeps the records of the named kernel and fails on
    a spill, a stack frame, or no record at all."""
    ok = {"kernel": "decode_wide_ring_kernel<float, 4, 8>", "registers": 149,
          "spill_stores": 0, "spill_loads": 0, "stack": 0}
    other = {"kernel": "decode_attention_kernel<float, 4, 8, 4>", "spill_stores": 8}
    assert chip_smoke.check_no_spill([ok, other], chip_smoke.K7W_KERNEL) == [ok]
    for bad in ({**ok, "spill_loads": 4}, {**ok, "stack": 16}):
        with pytest.raises(RuntimeError, match="ptxas"):
            chip_smoke.check_no_spill([ok, bad], chip_smoke.K7W_KERNEL)
    with pytest.raises(RuntimeError, match="no record"):
        chip_smoke.check_no_spill([other], chip_smoke.K7W_KERNEL)


def test_decode_wide_geometry_hold_refuses_a_wrong_cut(monkeypatch):
    """`check_decode_wide_geometry` holds the CUDA source's cut (here a
    stand-in reading the wrapper's) to `decode_wide_geometry`, and fails
    where one field differs."""
    monkeypatch.setattr(port_fa, "kernel_decode_wide_geometry",
                        port_fa.decode_wide_geometry)
    chip_smoke.check_decode_wide_geometry(port_fa, 2688)
    monkeypatch.setattr(port_fa, "kernel_decode_wide_geometry",
                        lambda d, dt, vec: {**port_fa.decode_wide_geometry(d, dt, vec),
                                            "stages": 1})
    with pytest.raises(RuntimeError, match="decode wide geometry"):
        chip_smoke.check_decode_wide_geometry(port_fa, 2688)


def test_cold_rotation_copies_in_memory_of_their_own():
    """A cold rotation's sets are the first tensors themselves and copies
    with the same sizes, strides and values in storage of their own, enough
    of them that their bytes exceed twice the L2 (2..64)."""
    base = torch.randn(2, 5, 3, 2, 8)
    k = base[:, :, 1]
    sets = chip_smoke.rotation(torch, (k,), 3)
    assert len(sets) == 3 and sets[0][0] is k
    for x, in sets[1:]:
        assert x.stride() == k.stride() and torch.equal(x, k)
        assert x.untyped_storage().data_ptr() != k.untyped_storage().data_ptr()
    l2 = chip_smoke.L2_BYTES
    assert chip_smoke.cold_copies(torch, l2, False) == 3
    assert chip_smoke.cold_copies(torch, 10 * l2, False) == 2
    assert chip_smoke.cold_copies(torch, 1, False) == 64
