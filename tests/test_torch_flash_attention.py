"""Flash attention in the torch port against the JAX package.

The port's `flash_attention`, run through its autograd Function on CPU
tensors (the plain versions `flash_fwd_reference` / `flash_bwd_reference`),
is held to the JAX package's `flash_attention` with its Pallas kernels in
interpret mode (blocks of 16, as tests/test_flash_attention.py runs them) and
to its `dense_attention`: (o, lse) forward, and (dq, dk, dv) through the
backward with an output cotangent and an lse cotangent. Inputs come from a
numpy seed, b = 2, t = 32, 2 heads, head_dim 8.

Tolerance in float32: rtol 1e-5 / atol 1e-6 for o and lse; rtol 1e-5 / atol
1e-5 for gradients, whose entries are sums of up to 32 products of O(1)
terms taken in another order (blocked online softmax against dense), so an
absolute 1e-5 is a few float32 ulps of the largest term. bfloat16 states its
own below.

The CUDA kernels run only on a GPU: the tests marked `cuda` skip without one
(``python -m pytest tests/test_torch_flash_attention.py -m cuda``).
"""
import numpy as np
import pytest
import torch

from deeplearning4j_torch.ops import flash_attention as port_fa
from test_torch_word2vec import one_torch_thread  # noqa: F401

B, T, H, D = 2, 32, 2, 8
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ref():
    """(jax.numpy, the JAX package's attention and flash_attention modules),
    imported here so the card-only tests also run where JAX is absent."""
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu.ops import attention, flash_attention
    return jax, jax.numpy, attention, flash_attention


def _inputs(seed, t=T, tk=None, d=D):
    rng = np.random.default_rng(seed)
    tk = t if tk is None else tk
    q = rng.standard_normal((B, t, H, d)).astype(np.float32)
    k = rng.standard_normal((B, tk, H, d)).astype(np.float32)
    v = rng.standard_normal((B, tk, H, d)).astype(np.float32)
    g_o = rng.standard_normal((B, t, H, d)).astype(np.float32)
    g_lse = rng.standard_normal((B, t, H)).astype(np.float32)
    return q, k, v, g_o, g_lse


def _key_mask(seed):
    km = (np.random.default_rng(seed).random((B, T)) > 0.3).astype(np.float32)
    km[:, :5] = 0.0   # under the causal mask, rows 0-4 see no key at all
    km[1, :] = 0.0    # and batch row 1 sees none anywhere
    return km


_SEG_1D = np.repeat([1, 2, 3], [10, 12, 10]).astype(np.int32)
_SEG_2D = np.stack([np.repeat([1, 2, 0], [14, 12, 6]),
                    np.repeat([1, 2, 3, 4], [5, 9, 9, 9])]).astype(np.int32)

# name -> flash_attention keywords (numpy), and whether g_lse is nonzero
CASES = {
    "noncausal": ({"causal": False}, False),
    "causal": ({"causal": True}, False),
    "key_mask_fully_masked_rows": ({"causal": True, "key_mask": _key_mask(3)}, False),
    "segment_ids_1d": ({"causal": True, "segment_ids": _SEG_1D}, False),
    "segment_ids_2d": ({"causal": False, "segment_ids": _SEG_2D,
                        "key_mask": (_SEG_2D > 0).astype(np.float32)}, False),
    "kv_segment_ids": ({"segment_ids": _SEG_2D,
                        "kv_segment_ids": _SEG_2D[::-1].copy()}, False),
    "positions": ({"causal": True, "q_pos": np.arange(T, dtype=np.int32) + 40,
                   "kv_pos": np.arange(T, dtype=np.int32) * 2 + 10}, False),
    "g_lse": ({"causal": True, "key_mask": _key_mask(4)}, True),
}


def _port(q, k, v, g_o, g_lse, dtype=torch.float32, **kw):
    """(o, lse, dq, dk, dv) from the port's flash_attention and autograd."""
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    args = {n: torch.from_numpy(np.asarray(a)) for n, a in kw.items()
            if isinstance(a, np.ndarray)}
    o, lse = port_fa.flash_attention(*ts, with_lse=True,
                                     **{**kw, **args})
    torch.autograd.backward([o, lse], [torch.from_numpy(g_o).to(dtype),
                                       torch.from_numpy(g_lse)])
    return [t.detach().float().numpy() for t in (o, lse)] + \
        [t.grad.float().numpy() for t in ts]


def _jax_flash(ref, q, k, v, g_o, g_lse, dtype=None, **kw):
    """(o, lse, dq, dk, dv) from the JAX package's Pallas kernels, interpreted."""
    jax, jnp, _, fa = ref
    dtype = dtype or jnp.float32
    args = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for n, a in kw.items()}
    (o, lse), vjp = jax.vjp(
        lambda a, b, c: fa.flash_attention(a, b, c, interpret=True,
                                           with_lse=True, q_block=16,
                                           kv_block=16, **args),
        *(jnp.asarray(x, dtype) for x in (q, k, v)))
    grads = vjp((jnp.asarray(g_o, dtype), jnp.asarray(g_lse)))
    return [np.asarray(x, np.float32) for x in (o, lse) + tuple(grads)]


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax_flash_interpret(ref, name):
    kw, with_glse = CASES[name]
    q, k, v, g_o, g_lse = _inputs(seed=len(name))
    if not with_glse:
        g_lse = np.zeros_like(g_lse)
    got = _port(q, k, v, g_o, g_lse, **kw)
    want = _jax_flash(ref, q, k, v, g_o, g_lse, **kw)
    for what, g, w in zip(("o", "lse"), got[:2], want[:2]):
        np.testing.assert_allclose(g, w, err_msg=what, **FWD)
    for what, g, w in zip(("dq", "dk", "dv"), got[2:], want[2:]):
        np.testing.assert_allclose(g, w, err_msg=what, **GRAD)
    if "key_mask" in kw and kw.get("causal"):
        # fully masked rows: exact zeros, lse NEG, no gradient through them
        assert np.all(got[0][:, :5] == 0.0) and np.all(got[0][1] == 0.0)
        assert np.all(got[1][:, :5] == port_fa.NEG)
        assert np.all(got[2][1] == 0.0)
        assert np.isfinite(got[2]).all()


@pytest.mark.parametrize("name", ["noncausal", "causal",
                                  "key_mask_fully_masked_rows",
                                  "segment_ids_1d", "segment_ids_2d",
                                  "kv_segment_ids"])
def test_matches_jax_dense_attention(ref, name):
    jax, jnp, att, _ = ref
    kw, _ = CASES[name]
    q, k, v, g_o, _ = _inputs(seed=7 + len(name))
    dense_kw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
                for n, a in kw.items()}
    for n in ("segment_ids", "kv_segment_ids"):  # dense takes [b, t] only
        if n in dense_kw and dense_kw[n].ndim == 1:
            dense_kw[n] = jnp.broadcast_to(dense_kw[n], (B, T))
    o, vjp = jax.vjp(lambda a, b, c: att.dense_attention(a, b, c, **dense_kw),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(g_o))]
    got = _port(q, k, v, g_o, np.zeros((B, T, H), np.float32), **kw)
    np.testing.assert_allclose(got[0], want[0], **FWD)
    for g, w in zip(got[2:], want[1:]):
        np.testing.assert_allclose(g, w, **GRAD)


def test_bfloat16_forward(ref):
    """Both round p to bfloat16 before the p.v product, the JAX kernel
    relative to its running maximum and the port's plain version relative
    to the row maximum, and both round o to bfloat16: o agrees to 2 bfloat16
    ulps (2 * 2^-8 relative) plus 2^-8 of |o|'s scale absolute; lse, a
    float32 sum of the same bfloat16 inputs, to float32 rounding."""
    _, jnp, _, _ = ref
    q, k, v, g_o, g_lse = _inputs(seed=21)
    kw = {"causal": True, "key_mask": _key_mask(5)}
    got = _port(q, k, v, g_o, np.zeros_like(g_lse), dtype=torch.bfloat16, **kw)
    want = _jax_flash(ref, q, k, v, g_o, np.zeros_like(g_lse),
                      dtype=jnp.bfloat16, **kw)
    np.testing.assert_allclose(got[0], want[0], rtol=2 ** -7, atol=2 ** -8)
    np.testing.assert_allclose(got[1], want[1], **FWD)


def test_indivisible_blocks_raise(ref):
    _, jnp, _, fa = ref
    q = np.zeros((1, 32, 1, 8), np.float32)
    with pytest.raises(ValueError, match="must divide"):
        fa.flash_attention(*(jnp.asarray(q),) * 3, q_block=24, interpret=True)
    with pytest.raises(ValueError, match="must divide"):
        port_fa.flash_attention(*(torch.from_numpy(q),) * 3, q_block=24)
    with pytest.raises(ValueError, match="must divide"):
        port_fa.flash_attention(*(torch.from_numpy(q),) * 3, kv_block=5)
    # the bfloat16 accumulator (once refused with NotImplementedError): the
    # port's plain version against the JAX kernels, both rounding at blocks
    # of 16; within two bfloat16 ulps of max|grad| (a block's float32 sum in
    # another order can tip a rounding), most entries equal
    q_, k_, v_, g_o, _ = _inputs(seed=31)
    zeros = np.zeros((B, T, H), np.float32)
    got = _port(q_, k_, v_, g_o, zeros, causal=True, q_block=16, kv_block=16,
                bwd_acc_dtype="bfloat16")
    want = _jax_flash(ref, q_, k_, v_, g_o, zeros, causal=True,
                      bwd_acc_dtype="bfloat16")
    f32 = _port(q_, k_, v_, g_o, zeros, causal=True)
    for what, g, w, f in zip(("dq", "dk", "dv"), got[2:], want[2:], f32[2:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=2 ** -7 * np.abs(w).max(),
                                   err_msg=what)
        assert np.mean(g != w) <= 0.05, what
        assert np.array_equal(g, g.astype(jnp.bfloat16).astype(np.float32)), what
        assert np.mean(f != w) > 0.5, what   # float32 sums would not pass
    with pytest.raises(ValueError, match="bwd_acc_dtype"):
        port_fa.flash_attention(*(torch.from_numpy(q),) * 3,
                                bwd_acc_dtype="float16")
    with pytest.raises(ValueError, match="requires segment_ids"):
        port_fa.flash_attention(*(torch.from_numpy(q),) * 3,
                                kv_segment_ids=np.zeros(32, np.int32))


def test_supported_checks_the_ports_kernel_limits(ref):
    """The port's gate is the JAX package's rule (exact tiling of its
    blocks, the VMEM estimate at head_dim padded to 128): head_dim 129 now
    passes (the sliced arms take it), 2688 is the last at 128-row blocks and
    2689 passes at shorter t."""
    _, _, _, fa = ref
    table = [((8192, 8192, 128), {}, True), ((1, 300, 8), {}, True),
             ((64, 64, 129), {}, True), ((0, 64, 64), {}, False),
             ((64, 64, 64), {"q_block": 48}, False),
             ((64, 64, 64), {"kv_block": 48}, False),
             ((64, 96, 64), {"q_block": 32, "kv_block": 48}, True),
             # no exact tiling needed by the port's kernels, but the rule's
             # own blocks always tile: 125 rows at t 1000, 1 at a prime t
             ((1000, 1000, 128), {}, True), ((8191, 1, 1), {}, True),
             ((128, 128, 2688), {}, True), ((128, 128, 2689), {}, False),
             ((64, 64, 2689), {}, True), ((4096, 4096, 512), {}, True),
             ((4096, 4096, 64), {"q_block": 4096, "kv_block": 4096}, False)]
    for args, kw, want in table:
        assert fa.flash_attention_supported(*args, **kw) is want, (args, kw)
        assert port_fa.flash_attention_supported(*args, **kw) is want, (args, kw)


def test_function_gradcheck_float64():
    """The autograd Function's backward (the plain version in float64)
    against finite differences, the lse cotangent included."""
    q, k, v, _, g_lse = _inputs(seed=2, t=12)
    ts = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    km = torch.from_numpy(_key_mask(6)[:, :12].astype(np.float64))
    gl = torch.from_numpy(g_lse[:, :12].astype(np.float64))

    def f(a, b, c):
        o, lse = port_fa.flash_attention(a, b, c, causal=True, key_mask=km,
                                         with_lse=True)
        return o, torch.where(lse > port_fa.NEG / 2, lse, 0.0) * gl

    assert torch.autograd.gradcheck(f, ts, eps=1e-6, atol=1e-6, rtol=1e-5)


def test_cpu_tensor_never_reaches_the_kernels(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU tensor was sent to a CUDA kernel")

    for name in ("_launch_fwd", "_launch_bwd_dkv", "_launch_bwd_dq"):
        monkeypatch.setattr(port_fa, name, boom)
    monkeypatch.setattr(port_fa.cuda_build, "load", boom)
    before = (port_fa.fwd_launches, port_fa.bwd_dkv_launches,
              port_fa.bwd_dq_launches)
    q, k, v, g_o, _ = _inputs(seed=1)
    qt = torch.from_numpy(q).requires_grad_()
    port_fa.flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                            causal=True).backward(torch.from_numpy(g_o))
    assert qt.grad.shape == qt.shape
    assert (port_fa.fwd_launches, port_fa.bwd_dkv_launches,
            port_fa.bwd_dq_launches) == before


def _card_case(gen, b, tq, tk, h, d, dtype, *, key_mask=False, segs=False,
               offset=0):
    dev = "cuda"
    mk = lambda *s: torch.randn(*s, device=dev, generator=gen).to(dtype)
    q, k, v, do = mk(b, tq, h, d), mk(b, tk, h, d), mk(b, tk, h, d), mk(b, tq, h, d)
    km = qs = ks = None
    if key_mask:
        km = (torch.rand(b, tk, device=dev, generator=gen) > 0.3).float()
        km[0] = 0.0
    if segs:
        qs = (torch.arange(tq, device=dev) * 3 // tq).int().expand(b, tq).contiguous()
        ks = (torch.arange(tk, device=dev) * 3 // tk).int().expand(b, tk).contiguous()
    qp = torch.arange(tq, device=dev, dtype=torch.int32) + offset
    kp = torch.arange(tk, device=dev, dtype=torch.int32)
    return q, k, v, do, km, qs, ks, qp, kp


def _close(got, want, rel):
    """max |got - want| <= rel * max |want|, on float32 views."""
    got, want = got.float(), want.float()
    assert (got - want).abs().max().item() <= rel * want.abs().max().clamp_min(1e-30).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_card(dtype):
    """f32: sums over up to 1000 keys in another order, 1e-5 of the largest
    entry; bf16: p, ds and the outputs rounded to bfloat16 at other running
    maxima, 1e-2 (a couple of bfloat16 ulps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    rel = 1e-5 if dtype == "float32" else 1e-2
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(2, 130, 130, 2, 64, True, dict()),
             (2, 70, 70, 3, 16, True, dict(key_mask=True)),
             (2, 150, 150, 2, 32, True, dict(segs=True)),
             (2, 64, 128, 2, 8, True, dict(offset=64)),
             (1, 1000, 1000, 2, 128, False, dict()),
             (3, 1, 300, 2, 64, False, dict(key_mask=True)),
             # rows of 19 elements: K3's element-wise tile loads
             (2, 90, 90, 2, 19, True, dict(key_mask=True))]
    for b, tq, tk, h, d, causal, kw in cases:
        q, k, v, do, km, qs, ks, qp, kp = _card_case(gen, b, tq, tk, h, d, dt, **kw)
        scale = d ** -0.5
        before = (port_fa.fwd_launches, port_fa.bwd_dkv_launches,
                  port_fa.bwd_dq_launches)
        o, lse = port_fa.flash_fwd(q, k, v, km, qs, ks, qp, kp, scale, causal)
        ow, lw = port_fa.flash_fwd_reference(q, k, v, km, qs, ks, qp, kp, scale,
                                             causal)
        _close(o, ow, rel)
        assert torch.equal(lse <= port_fa.NEG / 2, lw <= port_fa.NEG / 2)
        live = lw > port_fa.NEG / 2
        torch.testing.assert_close(lse[live], lw[live], rtol=1e-5, atol=1e-5)
        gl = torch.where(live, torch.randn(lw.shape, device="cuda",
                                           generator=gen), 0.0)
        di = (ow.float() * do.float()).sum(-1)
        got = port_fa.flash_bwd(q, k, v, do, lw, di, gl, km, qs, ks, qp, kp,
                                scale, causal)
        torch.cuda.synchronize()
        want = port_fa.flash_bwd_reference(q, k, v, do, lw, di, gl, km, qs, ks,
                                           qp, kp, scale, causal)
        for g, w in zip(got, want):
            _close(g, w, rel)
        assert (port_fa.fwd_launches, port_fa.bwd_dkv_launches,
                port_fa.bwd_dq_launches) == tuple(n + 1 for n in before)


@pytest.mark.cuda
def test_autograd_reaches_all_three_kernels_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    q, k, v, g_o, _ = _inputs(seed=9, t=100, d=32)
    ts = [torch.from_numpy(a).cuda().requires_grad_() for a in (q, k, v)]
    before = (port_fa.fwd_launches, port_fa.bwd_dkv_launches,
              port_fa.bwd_dq_launches)
    port_fa.flash_attention(*ts, causal=True).backward(torch.from_numpy(g_o).cuda())
    torch.cuda.synchronize()
    assert (port_fa.fwd_launches, port_fa.bwd_dkv_launches,
            port_fa.bwd_dq_launches) == tuple(n + 1 for n in before)
    cpu = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    port_fa.flash_attention(*cpu, causal=True).backward(torch.from_numpy(g_o))
    for g, c in zip(ts, cpu):
        torch.testing.assert_close(g.grad.cpu(), c.grad, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Why K3 splits its float32 products (3xTF32): an emulation on the CPU.
# ---------------------------------------------------------------------------

def _tf32(x):
    """float32 x rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as the kernel's cvt.rna.tf32.f32 does: add half of the
    13 dropped bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(x):
    """float32 x with its 13 low mantissa bits cleared: how the tensor cores
    read a TF32 operand that carries them (K3's small parts)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b on TF32 operands with float32 sums, as the tensor cores take
    them: one pass (big big), or K3's 3xTF32 split (big = tf32(x), small =
    x - big read as TF32; small big + big small + big big, small small
    dropped)."""
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab @ bb
    small = lambda x, big: _tf32_truncated(x - big)
    return small(a, ab) @ bb + ab @ small(b, bb) + ab @ bb


def _causal_fwd(q, k, v, mm):
    """o of causal attention over one head [t, d] with both products by `mm`."""
    t = q.shape[0]
    s = mm(q, k.T) * q.shape[1] ** -0.5
    s = torch.where(torch.ones(t, t, dtype=torch.bool).tril(), s, port_fa.NEG)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return mm(p, v) / p.sum(-1, keepdim=True)


def _tf32_errors(t, seed):
    """o's error relative to max|o| against float64 at d 128, causal: (one
    TF32 pass, 3xTF32, plain float32 products)."""
    import chip_smoke
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((t, 128)).astype(np.float32))
               for _ in range(3))
    want = _causal_fwd(q.double(), k.double(), v.double(), torch.matmul)
    scale = want.abs().max().item()
    err = lambda o: (o.double() - want).abs().max().item() / scale
    errs = (err(_causal_fwd(q, k, v, lambda a, b: _mm_tf32(a, b, 1))),
            err(_causal_fwd(q, k, v, lambda a, b: _mm_tf32(a, b, 3))),
            err(_causal_fwd(q, k, v, torch.matmul)))
    return errs, chip_smoke.FLASH_REL["float32"]


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -11 - 2 ** -23, -(1 + 2 ** -11),
                      1 + 3 * 2 ** -11, 3.0, -0.0], dtype=torch.float32)
    want = [1 + 2 ** -10, 1.0, -(1 + 2 ** -10), 1 + 2 ** -9, 3.0, -0.0]
    assert _tf32(x).tolist() == want
    assert _tf32_truncated(x).tolist() == [1.0, 1.0, -1.0, 1 + 2 ** -10, 3.0, -0.0]


@pytest.mark.parametrize("t", [1024, 2048])
def test_3xtf32_keeps_float32_accuracy(t):
    """The split product holds o within the card check's float32 limit (1e-5
    of max|o|) of float64, as close as plain float32 products come (at t
    1024, 2.6e-7 against float32's 2.9e-7)."""
    (_, three, plain), limit = _tf32_errors(t, seed=t)
    assert three <= limit
    assert three <= 4 * plain


@pytest.mark.parametrize("t", [1024, 2048])
def test_one_tf32_pass_would_fail_the_float32_check(t):
    """One TF32 pass keeps about 3 digits (4.3e-4 of max|o| at t 1024): a
    kernel that took it would fail the card's float32 check. This is why K3
    pays three tensor-core products for each float32 one."""
    (one, _, _), limit = _tf32_errors(t, seed=t + 1)
    assert one > 10 * limit


def _causal_bwd(q, k, v, do, g, lse, di, mm):
    """(dq, dk, dv) of causal attention over one head [t, d] with the lse
    cotangent g, as K4 and K5 compute them from the saved lse and di, with
    all four products (S, dP, and dQ, dK, dV from ds and p) by `mm`."""
    t = q.shape[0]
    scale = q.shape[1] ** -0.5
    keep = torch.ones(t, t, dtype=torch.bool).tril()
    p = torch.where(keep, torch.exp(mm(q, k.T) * scale - lse[:, None]), 0.0)
    ds = p * (mm(do, v.T) - di[:, None] + g[:, None])
    return mm(ds, k) * scale, mm(ds.T, q) * scale, mm(p.T, do)


def _tf32_bwd_errors(t, seed):
    """dq's, dk's and dv's errors relative to their max against float64 at d
    128, causal, from the float64 lse and di: (one TF32 pass, 3xTF32, plain
    float32 products), each a list of three."""
    import chip_smoke
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((t, 128)).astype(np.float32))
                   for _ in range(4))
    g = torch.from_numpy(rng.standard_normal(t).astype(np.float32))
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    s = torch.where(torch.ones(t, t, dtype=torch.bool).tril(),
                    q64 @ k64.T * 128 ** -0.5, port_fa.NEG)
    lse = torch.logsumexp(s, -1)
    di = ((torch.exp(s - lse[:, None]) @ v64) * do64).sum(-1)
    want = _causal_bwd(q64, k64, v64, do64, g.double(), lse, di, torch.matmul)

    def errs(mm):
        got = _causal_bwd(q, k, v, do, g, lse.float(), di.float(), mm)
        return [((x.double() - w).abs().max() / w.abs().max()).item()
                for x, w in zip(got, want)]
    return (errs(lambda a, b: _mm_tf32(a, b, 1)), errs(lambda a, b: _mm_tf32(a, b, 3)),
            errs(torch.matmul)), chip_smoke.FLASH_REL["float32"]


@pytest.mark.parametrize("t", [1024, 2048])
def test_3xtf32_keeps_float32_accuracy_in_the_backward(t):
    """K4's and K5's split products hold dq, dk and dv within the card
    check's float32 limit (1e-5 of their max) of float64, as close as plain
    float32 products come (about 1e-6 at t 1024 and 2048)."""
    (_, three, plain), limit = _tf32_bwd_errors(t, seed=t + 2)
    for e3, ep in zip(three, plain):
        assert e3 <= limit
        assert e3 <= 4 * ep


@pytest.mark.parametrize("t", [1024, 2048])
def test_one_tf32_pass_would_fail_the_backward_check(t):
    """One TF32 pass for the backward's products puts dq, dk and dv 4e-4 to
    1e-3 of their max from float64: each would fail the card's float32
    check, which is why K4 and K5 take three products per float32 one."""
    (one, _, _), limit = _tf32_bwd_errors(t, seed=t + 3)
    assert all(e > 10 * limit for e in one)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dq_arm_fits_its_blocks_an_sm(dtype):
    """K5w (`dq`, `dq_acc16`) within a block's 232,448 bytes at every
    head_dim 129-2689; in bfloat16 (one warpgroup a block) two blocks an SM
    fit in one pass (228 KB, 1 KB reserved a block), without the
    accumulator, which one warpgroup keeps in shared memory; float32 (two
    warpgroups) keeps it in registers."""
    split = port_fa.DQ_SPLIT[dtype]
    assert split == (dtype == torch.float32)
    for d in range(129, 2690):
        smem = port_fa.wide_smem(d, dtype)
        assert max(smem["dq"], smem["dq_acc16"]) <= port_fa.SMEM_LIMIT, (d, smem)
        assert (smem["dq_acc16"] == smem["dq"]) == split
        if not split and d <= 1024:
            assert 2 * (smem["dq"] + 1024) <= 233_472, (d, smem)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sliced_arms_match_plain_on_card(dtype):
    """The sliced arms (head_dim > 128) and the bfloat16 accumulator's arms
    against the plain versions, each launch counted in its own arm's count.
    f32: 1e-5 of the largest entry per 128 of head_dim (sums over head_dim in
    another order); bf16 1e-2; the accumulator two bfloat16 ulps (2^-7) of
    the largest entry, at most 5% of entries different (at head_dim 1024, t
    64 with segments instead the mean difference within the plain version's
    own spread, `chip_smoke.acc16_plain_bound`), each entry a bfloat16
    value. K7's sliced arm: 1e-5 in float32, 1e-2 in bfloat16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for b, tq, tk, h, d, causal, kw in [(2, 130, 130, 2, 160, True, dict()),
                                        (2, 96, 96, 1, 300, True, dict(key_mask=True)),
                                        (1, 128, 128, 2, 512, True, dict(segs=True)),
                                        (1, 64, 64, 1, 2688, False, dict()),
                                        # the clustered arms' edges: one cluster
                                        # of 8 blocks; two passes of 5 (at t 64
                                        # a segment's first row, whose dq is
                                        # rounding noise, is 1/21 of the rows)
                                        (1, 128, 128, 1, 1024, True, dict(segs=True)),
                                        (2, 64, 64, 1, 1152, True, dict(key_mask=True)),
                                        # K5a at t 64 with segments: held to the
                                        # plain version's own spread
                                        (1, 64, 64, 2, 1024, True,
                                         dict(segs=True, plain_bound=True))]:
        kw = dict(kw)
        plain_bound = kw.pop("plain_bound", False)
        rel = (1e-5 * d / 128) if dtype == "float32" else 1e-2
        q, k, v, do, km, qs, ks, qp, kp = _card_case(gen, b, tq, tk, h, d, dt, **kw)
        scale = d ** -0.5
        before = (port_fa.fwd_wide_launches, port_fa.bwd_dkv_wide_launches,
                  port_fa.bwd_dq_wide_launches)
        o, lse = port_fa.flash_fwd(q, k, v, km, qs, ks, qp, kp, scale, causal)
        ow, lw = port_fa.flash_fwd_reference(q, k, v, km, qs, ks, qp, kp, scale, causal)
        _close(o, ow, rel)
        live = lw > port_fa.NEG / 2
        di = (ow.float() * do.float()).sum(-1)
        gl = torch.zeros_like(lw)
        args = (q, k, v, do, lw, di, gl, km, qs, ks, qp, kp, scale, causal)
        for g, w in zip(port_fa.flash_bwd(*args), port_fa.flash_bwd_reference(*args)):
            _close(g, w, rel)
        assert (port_fa.fwd_wide_launches, port_fa.bwd_dkv_wide_launches,
                port_fa.bwd_dq_wide_launches) == tuple(n + 1 for n in before)
        assert torch.equal(lse <= port_fa.NEG / 2, ~live)
        blk = 32 if tq % 32 == 0 else tq
        bounds = [None] * 3
        if plain_bound:  # (dq, dk, dv), chip_smoke.acc16_plain_bound's
            import chip_smoke
            bounds = chip_smoke.acc16_plain_bound(port_fa, args, blk, "dq") + \
                chip_smoke.acc16_plain_bound(port_fa, args, blk, "dkv")
        for g, w, bound in zip(port_fa.flash_bwd(*args, acc_blocks=(blk, blk)),
                               port_fa.flash_bwd_reference(*args, acc_blocks=(blk, blk)),
                               bounds):
            _close(g, w, 2 ** -7)
            # a kernel summing in float32, or rounding at other blocks,
            # differs in most entries by much less than 2^-7 of the largest
            if bound is None:
                assert (g != w).float().mean().item() <= 0.05
            else:
                assert (g.float() - w.float()).abs().mean().item() <= bound
            gf = g.float()
            assert torch.equal(gf, gf.to(torch.bfloat16).float())
        qd = torch.randn(b, 1, h, d, device="cuda", generator=gen).to(dt)
        lens = torch.randint(1, tk + 1, (b,), device="cuda", generator=gen)
        _close(port_fa.decode_attention(qd, k, v, lens),
               port_fa.decode_attention_reference(qd, k, v, lens),
               1e-5 if dtype == "float32" else 1e-2)
    torch.cuda.synchronize()
