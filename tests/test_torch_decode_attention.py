"""Single-query decode attention in the torch port against the JAX package.

The port's `decode_attention` on CPU tensors runs its plain version
(`decode_attention_reference`), which is held to the JAX package's
`decode_attention` with `impl="auto"` (its dense einsum arm on the CPU) and
with `impl="flash", interpret=True` (the Pallas kernel `_fwd_kernel` with one
query row, in interpret mode). Inputs come from a numpy seed: b 3, 2 heads,
head_dim 8, t_kv 8/16/64, cache_len 1, a middle length and t_kv.

Tolerance: float32 rtol 1e-5 / atol 1e-6 (a softmax over at most 64 keys,
sums in another order). bfloat16: the JAX dense arm rounds the weights to
bfloat16 before the product with v and returns a bfloat16 sum, where the
port sums in float32 and rounds once; both sit within 2e-2 of max|o| (a few
bfloat16 ulps).

K7 itself runs only on a GPU: the test marked `cuda` skips without one
(``python -m pytest tests/test_torch_decode_attention.py -m cuda
--noconftest``).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_torch.ops import flash_attention as port_fa

B, H, D = 3, 2, 8
F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_fa():
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu.ops import flash_attention
    return jax, flash_attention


def _inputs(tk, seed=1, d=D):
    rng = np.random.default_rng(seed + tk)
    q = rng.standard_normal((B, 1, H, d)).astype(np.float32)
    k = rng.standard_normal((B, tk, H, d)).astype(np.float32)
    v = rng.standard_normal((B, tk, H, d)).astype(np.float32)
    lens = np.array([1, tk // 2 + 1, tk], np.int32)
    return q, k, v, lens


def _port(q, k, v, lens, **kw):
    return port_fa.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    torch.from_numpy(lens), **kw).numpy()


@pytest.mark.parametrize("tk", [8, 16, 64])
@pytest.mark.parametrize("jax_impl", ["auto", "flash"])
def test_plain_version_matches_jax(jax_fa, tk, jax_impl):
    _, fa = jax_fa
    q, k, v, lens = _inputs(tk)
    kw = {"interpret": True} if jax_impl == "flash" else {}
    want = np.asarray(fa.decode_attention(q, k, v, lens, impl=jax_impl, **kw))
    got = _port(q, k, v, lens)
    assert got.shape == (B, 1, H, D)
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("tk", [8, 64])
def test_dense_arm_matches_jax_dense_arm(jax_fa, tk):
    _, fa = jax_fa
    q, k, v, lens = _inputs(tk, seed=5)
    want = np.asarray(fa.decode_attention(q, k, v, lens, impl="dense"))
    np.testing.assert_allclose(_port(q, k, v, lens, impl="dense"), want, **F32)


def test_plain_version_is_the_masked_softmax():
    """Each row against a per-head numpy softmax over its first cache_len
    keys: the keys past it never weigh (garbage there changes nothing)."""
    q, k, v, lens = _inputs(16, seed=3)
    got = _port(q, k, v, lens)
    k2, v2 = k.copy(), v.copy()
    for i, n in enumerate(lens):
        k2[i, n:] = 1e6
        v2[i, n:] = np.nan
        for hh in range(H):
            s = q[i, 0, hh] @ k[i, :n, hh].T / np.sqrt(D)
            w = np.exp(s - s.max())
            np.testing.assert_allclose(got[i, 0, hh], (w / w.sum()) @ v[i, :n, hh],
                                       rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(_port(q, k2, v2, lens), got)


def test_bfloat16_matches_jax(jax_fa):
    jax, fa = jax_fa
    q, k, v, lens = _inputs(16, seed=7)
    jb = jax.numpy.bfloat16
    want = np.asarray(fa.decode_attention(*(jax.numpy.asarray(a, jb) for a in (q, k, v)),
                                          lens)).astype(np.float32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = port_fa.decode_attention(bf(q), bf(k), bf(v), torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_zero_length_row_outputs_zero():
    """cache_len 0 (a row no key may see) gives 0, as a fully masked row of
    the flash arm; a cache_len past the bucket takes every key."""
    q, k, v, _ = _inputs(8, seed=9)
    lens = np.array([0, 99, 8], np.int32)
    got = _port(q, k, v, lens)
    assert (got[0] == 0).all()
    np.testing.assert_array_equal(got[1], _port(q, k, v, np.array([8, 8, 8],
                                                                   np.int32))[1])


def test_rejects_multi_query_rows_and_unknown_impl():
    z = torch.zeros(1, 2, 1, 4)
    with pytest.raises(ValueError, match="one query row"):
        port_fa.decode_attention(z, z, z, torch.ones(1, dtype=torch.int32))
    z1 = torch.zeros(1, 1, 1, 4)
    with pytest.raises(ValueError, match="unknown decode_attention impl"):
        port_fa.decode_attention(z1, z1, z1, torch.ones(1, dtype=torch.int32),
                                 impl="pallas")


def test_strided_layer_view_matches_contiguous():
    """The decode step reads a layer's slice of its [b, t, layers, h, d]
    view in place; the answer is that of the contiguous copy."""
    rng = np.random.default_rng(11)
    view = torch.from_numpy(rng.standard_normal((B, 16, 3, H, D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((B, 1, H, D)).astype(np.float32))
    lens = torch.tensor([1, 9, 16], dtype=torch.int32)
    got = port_fa.decode_attention(q, view[:, :, 1], view[:, :, 2], lens)
    want = port_fa.decode_attention(q, view[:, :, 1].contiguous(),
                                    view[:, :, 2].contiguous(), lens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cpu_tensors_never_launch_the_kernel():
    before = port_fa.decode_launches
    q, k, v, lens = _inputs(8)
    _port(q, k, v, lens)
    assert port_fa.decode_launches == before


@pytest.mark.parametrize("sms", [1, 78, 132, 144])
def test_decode_splits_between_one_and_eight(monkeypatch, sms):
    """K7's split count is 1..8 (a portable cluster) at any SM count,
    b * h and bucket, and the same for the same arguments: it reads no
    device tensor."""
    dev = torch.device("cuda", 0)
    monkeypatch.setitem(port_fa._sm_count, 0, sms)
    for bh in (1, 3, 32, 64, 500, 10_000):
        for t_kv in (1, 16, 63, 64, 65, 256, 8192, 1 << 20):
            s = port_fa.decode_splits(dev, bh, t_kv)
            assert 1 <= s <= port_fa.DECODE_MAX_SPLITS == 8
            assert s == port_fa.decode_splits(dev, bh, t_kv)
            assert s <= max(1, -(-t_kv // port_fa.DECODE_MIN_CHUNK))


def test_decode_splits_follow_the_rule(monkeypatch):
    """At 132 SMs: the engine's 32 (row, head) pairs take 2 blocks each at
    a 256-key bucket and 1 at 64 keys; 64 pairs at 8192 keys take the 8 of
    a full cluster; b * h past the card's blocks takes one."""
    dev = torch.device("cuda", 0)
    monkeypatch.setitem(port_fa._sm_count, 0, 132)
    want = lambda bh, t: max(1, min(-(-port_fa.DECODE_BLOCKS_PER_SM * 132 // bh),
                                    -(-t // port_fa.DECODE_MIN_CHUNK), 8))
    for bh, t in ((32, 256), (32, 64), (64, 8192), (4096, 8192), (1, 1)):
        assert port_fa.decode_splits(dev, bh, t) == want(bh, t)
    assert port_fa.decode_splits(dev, 32, 256) == 2
    assert port_fa.decode_splits(dev, 32, 64) == 1
    assert port_fa.decode_splits(dev, 64, 8192) == 8
    assert port_fa.decode_splits(dev, 4096, 8192) == 1


@pytest.mark.parametrize("sms", [1, 78, 132, 144])
def test_decode_wide_splits_between_one_and_eight(monkeypatch, sms):
    """K7w's split count is 1..8 (a portable cluster) at any SM count, b * h,
    bucket and head_dim, and the same for the same arguments (it reads no
    device tensor); it never gives a block less than DECODE_WIDE_MIN_BYTES
    of the bucket's K and V where more than one block takes a (row, head)."""
    dev = torch.device("cuda", 0)
    monkeypatch.setitem(port_fa._sm_count, 0, sms)
    for bh in (1, 3, 8, 64, 500, 10_000):
        for t_kv in (1, 16, 128, 256, 8192, 1 << 20):
            for d in (129, 256, 2688, 4096):
                for item in (2, 4):
                    s = port_fa.decode_wide_splits(dev, bh, t_kv, d, item)
                    assert 1 <= s <= port_fa.DECODE_MAX_SPLITS == 8
                    assert s == port_fa.decode_wide_splits(dev, bh, t_kv, d, item)
                    if s > 1:
                        assert t_kv * 2 * d * item > (s - 1) * port_fa.DECODE_WIDE_MIN_BYTES
                        assert s * bh <= port_fa.DECODE_WIDE_BLOCKS_PER_SM * sms


def test_decode_wide_splits_follow_the_rule(monkeypatch):
    """At 132 SMs: the wide engine's 64 (row, head) pairs of 256-wide heads
    at a 256-key bucket take 2 blocks each in float32 and 1 in bfloat16; its
    128-key bucket takes 1 in both types; 8 pairs at head_dim 2688 take the
    8 of a full cluster; b * h past the card's SMs takes one."""
    dev = torch.device("cuda", 0)
    monkeypatch.setitem(port_fa._sm_count, 0, 132)
    split = port_fa.decode_wide_splits
    assert split(dev, 64, 256, 256, 4) == 2 and split(dev, 64, 256, 256, 2) == 1
    assert split(dev, 64, 128, 256, 4) == split(dev, 64, 128, 256, 2) == 1
    assert split(dev, 8, 256, 2688, 4) == split(dev, 8, 256, 2688, 2) == 8
    assert split(dev, 256, 8192, 256, 4) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_wide_geometry_fits_shared_memory(dtype):
    """K7w's cut (`decode_wide_geometry`, the CUDA source's `wide_geometry`)
    at every head_dim 129-4096 on both routes (the 16-byte one where head_dim
    is whole pieces): shared memory within SMEM_LIMIT, groups of 8-256 lanes,
    a lane's pieces covering the row in at most 32 floats, one or two keys a
    group a tile, a ring of 2-6 stages; head_dim 128 and 4097 refused."""
    vw = 16 // (4 if dtype == torch.float32 else 2)
    for d in range(129, 4097):
        for vec in {False, d % vw == 0}:
            g = port_fa.decode_wide_geometry(d, dtype, vec)
            assert 0 < g["smem"] <= port_fa.SMEM_LIMIT, (d, vec, g)
            assert g["group"] in (8, 16, 32, 64, 128, 256) and g["threads"] == 256
            pieces = -(-d // (vw if vec else 1))
            assert g["per"] * g["group"] >= pieces and g["per"] * (vw if vec else 1) <= 32
            assert g["keys"] in (1, 2) and g["tile"] * g["group"] == 256 * g["keys"]
            assert 2 <= g["stages"] <= 6
    for d in (128, 4097):
        assert port_fa.decode_wide_geometry(d, dtype)["smem"] == 0


def test_wide_launch_refuses_head_dim_past_4096():
    """Past DECODE_WIDE_MAX_HEAD_DIM the launch wrapper raises before it
    reaches the kernel (checked on CPU tensors: nothing is launched)."""
    q = torch.zeros(1, 1, 1, 4100)
    k = torch.zeros(1, 4, 1, 4100)
    with pytest.raises(ValueError, match="head_dim <= 4096"):
        port_fa._launch_decode(q, k, k, torch.tensor([2]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    """K7 against its plain version on the card: float32 within 1e-5 of
    max|plain| (sums in another order), bfloat16 within 1e-2 (the output
    rounded once); a strided layer view, head_dim 19 (one element a lane)
    and 128, cache_len 0 and past the bucket, and lengths on the edges of
    the per-row split (`chip_smoke.decode_edge_lens`) at 1-8 splits; on the
    wide arm (K7w) head_dim 160, 300 in bfloat16 (600-byte rows: the element
    route), 2688, and the wide decoder's own lengths (a 128-key bucket,
    cache_len 5-80, 8 heads of 256 from a layer of the step's view), at
    every split count. Each call counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    rel = 1e-5 if dtype == "float32" else 1e-2
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, t, h, d, layers in ((4, 256, 4, 32, 3), (3, 300, 2, 19, 0),
                               (2, 1000, 2, 128, 0)):
        mk = lambda *s: torch.randn(*s, device="cuda", generator=gen).to(dt)
        q = mk(b, 1, h, d)
        k, v = ((mk(b, t, layers, h, d)[:, :, 1], mk(b, t, layers, h, d)[:, :, 1])
                if layers else (mk(b, t, h, d), mk(b, t, h, d)))
        lens = torch.tensor([0, t + 3] + [t // 3 + 1] * (b - 2), dtype=torch.int32,
                            device="cuda")
        before = port_fa.decode_launches
        got = port_fa.decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        assert port_fa.decode_launches == before + 1
        want = port_fa.decode_attention_reference(q.float(), k.float(), v.float(), lens)
        assert (got[0] == 0).all()
        err = (got.float() - want).abs().max().item()
        assert err <= rel * want.abs().max().item()
    # cache_len on the edges of the per-row split, at every split count
    for b, t, h, d, layers in ((12, 512, 4, 32, 4), (12, 4096, 2, 128, 0)):
        mk = lambda *s: torch.randn(*s, device="cuda", generator=gen).to(dt)
        q = mk(b, 1, h, d)
        k, v = ((mk(b, t, layers, h, d)[:, :, 1], mk(b, t, layers, h, d)[:, :, 1])
                if layers else (mk(b, t, h, d), mk(b, t, h, d)))
        want_splits = port_fa.decode_splits(q.device, b * h, t)
        for splits in sorted({1, 2, 3, 4, 8, want_splits}):
            unit = chip_smoke.decode_block_keys(d, q.element_size(), -(-t // splits))
            lens = torch.from_numpy(chip_smoke.decode_edge_lens(b, t, splits, unit)).cuda()
            got = port_fa._launch_decode(q, k, v, lens, splits=splits)
            want = port_fa.decode_attention_reference(q.float(), k.float(), v.float(),
                                                      lens)
            err = (got.float() - want).abs().max().item()
            assert err <= rel * want.abs().max().item(), (splits, lens.tolist())
    # head_dim above 128 takes the wide arm, K7w (one launch a call)
    rng = np.random.default_rng(0)
    for b, t, h, d, layers, lens in (
            (2, 40, 2, 160, 0, [7, 40]),
            (3, 300, 2, 300, 0, [0, 305, 150]),
            (3, 256, 2, 2688, 0, [0, 256, 97]),
            (8, 128, 8, 256, 4, rng.integers(5, 81, 8).tolist())):
        mk = lambda *s: torch.randn(*s, device="cuda", generator=gen).to(dt)
        q = mk(b, 1, h, d)
        k, v = ((mk(b, t, layers, h, d)[:, :, 1], mk(b, t, layers, h, d)[:, :, 1])
                if layers else (mk(b, t, h, d), mk(b, t, h, d)))
        lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
        want = port_fa.decode_attention_reference(q.float(), k.float(), v.float(), lens)
        for splits in (None, 1, 2, 3, 8):
            before = port_fa.decode_wide_launches
            got = (port_fa.decode_attention(q, k, v, lens) if splits is None
                   else port_fa._launch_decode(q, k, v, lens, splits=splits))
            torch.cuda.synchronize()
            assert port_fa.decode_wide_launches == before + 1
            assert torch.isfinite(got).all() and ((got[lens == 0] == 0).all())
            err = (got.float() - want).abs().max().item()
            assert err <= rel * want.abs().max().item(), (d, splits, err)
