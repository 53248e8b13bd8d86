"""The port's PagedKVCache against the JAX package's, driven by one script.

The same sequence of prompt writes, single-token appends, batched appends,
views, frees and exhaustions (data from a numpy seed) goes through both
caches, and after every step their views (bitwise: the port gathers the
same float32 values), lengths, block counts, free counts and utilization
must agree. The port's arena lives on an explicit device (the CPU here).
"""
import numpy as np
import pytest
import torch

from deeplearning4j_torch.parallel.inference import (KVCacheExhaustedError,
                                                     QueueFullError)
from deeplearning4j_torch.serving.decode import PagedKVCache

L, H, D = 2, 2, 4


@pytest.fixture(scope="module")
def jax_cache_cls():
    pytest.importorskip("jax")
    from deeplearning4j_tpu.parallel.inference import \
        KVCacheExhaustedError as JaxExhausted
    from deeplearning4j_tpu.serving.decode import PagedKVCache as JaxCache
    return JaxCache, JaxExhausted


def _pair(cls, **kw):
    kw.setdefault("block_tokens", 4)
    kw.setdefault("max_blocks", 8)
    return (cls(layers=L, heads=H, head_dim=D, **kw),
            PagedKVCache(layers=L, heads=H, head_dim=D, device="cpu", **kw))


def _same(jc, pc, rids=(), bucket=None):
    assert pc.blocks_in_use() == jc.blocks_in_use()
    assert pc.free_blocks() == jc.free_blocks()
    assert pc.utilization() == pytest.approx(jc.utilization(), rel=1e-12)
    for rid in rids:
        assert pc.length(rid) == jc.length(rid)
        assert pc.blocks_of(rid) == jc.blocks_of(rid)
    if rids and bucket:
        jk, jv, jl = jc.batch_view(list(rids), bucket)
        pk, pv, pl = pc.batch_view(list(rids), bucket)
        assert pk.shape == jk.shape and pk.dtype == torch.float32
        np.testing.assert_array_equal(pk.numpy(), jk)
        np.testing.assert_array_equal(pv.numpy(), jv)
        assert pl.dtype == torch.int32
        np.testing.assert_array_equal(pl.numpy(), jl)


def test_one_script_through_both_caches(jax_cache_cls):
    JaxCache, JaxExhausted = jax_cache_cls
    jc, pc = _pair(JaxCache)
    assert pc.block_tokens == jc.block_tokens == 4
    rng = np.random.default_rng(0)
    kv = lambda *s: rng.standard_normal(s).astype(np.float32)

    # prompts of 6, 1 and 4 tokens: 2, 1 and 1 blocks
    for rid, t in ((7, 6), (3, 1), (5, 4)):
        k, v = kv(t, L, H, D), kv(t, L, H, D)
        jc.write_prompt(rid, k, v)
        pc.write_prompt(rid, torch.from_numpy(k), v)   # tensors and arrays alike
    _same(jc, pc, (7, 3, 5), 8)
    # single appends: rid 7 fills its second block, rid 5 grows a block
    for rid in (7, 5, 7):
        k, v = kv(L, H, D), kv(L, H, D)
        jc.append(rid, k, v)
        pc.append(rid, k, v)
    _same(jc, pc, (7, 3, 5), 8)
    _same(jc, pc, (5, 7), 16)
    # a batched append (the adapter's path) against appends one by one
    k, v = kv(3, L, H, D), kv(3, L, H, D)
    for i, rid in enumerate((3, 5, 7)):
        jc.append(rid, k[i], v[i])
    assert pc.append_batch([3, 5, 7], torch.from_numpy(k), torch.from_numpy(v)) == {}
    _same(jc, pc, (7, 3, 5), 16)
    # repeated rows (a step's pad rows repeat row 0)
    _same(jc, pc, (3, 3, 7, 3), 16)
    # exhaustion: 8 blocks, 3 + 1 + 2 in use (rid 7 holds 9 tokens)
    assert jc.blocks_in_use() == 6
    big = kv(9, L, H, D)
    with pytest.raises(JaxExhausted):
        jc.write_prompt(9, big, big)
    with pytest.raises(KVCacheExhaustedError):
        pc.write_prompt(9, big, big)
    _same(jc, pc, (7, 3, 5), 16)
    assert pc.length(9) == 0 and pc.blocks_of(9) == 0   # all or nothing
    # rids 3 and 5 grow into the last two blocks
    for rid, n in ((3, 4), (5, 3)):
        for _ in range(n):
            k, v = kv(L, H, D), kv(L, H, D)
            jc.append(rid, k, v)
            pc.append(rid, k, v)
    _same(jc, pc, (7, 3, 5), 16)
    assert pc.free_blocks() == 0
    for _ in range(3):   # rid 7 fills its 12 slots
        k, v = kv(L, H, D), kv(L, H, D)
        jc.append(7, k, v)
        pc.append(7, k, v)
    k, v = kv(L, H, D), kv(L, H, D)
    with pytest.raises(JaxExhausted):
        jc.append(7, k, v)
    with pytest.raises(KVCacheExhaustedError):
        pc.append(7, k, v)
    _same(jc, pc, (7, 3, 5), 16)   # the failed grow left the table intact
    k, v = kv(2, L, H, D), kv(2, L, H, D)
    fails = pc.append_batch([5, 7], torch.from_numpy(k), torch.from_numpy(v))
    jc.append(5, k[0], v[0])
    assert list(fails) == [7] and isinstance(fails[7], KVCacheExhaustedError)
    _same(jc, pc, (7, 3, 5), 16)
    # frees (idempotent) hand the blocks back; a new prompt reuses them
    for rid in (7, 7, 3):
        jc.free(rid)
        pc.free(rid)
    _same(jc, pc, (5,), 16)
    k, v = kv(9, L, H, D), kv(9, L, H, D)
    jc.write_prompt(9, k, v)
    pc.write_prompt(9, k, v)
    _same(jc, pc, (9, 5), 16)
    for rid in (9, 5):
        jc.free(rid)
        pc.free(rid)
    _same(jc, pc)
    assert pc.blocks_in_use() == 0 and pc.utilization() == 0.0


def test_block_size_goes_through_the_bucket_rule():
    c = PagedKVCache(layers=1, heads=1, head_dim=2, block_tokens=12,
                     max_blocks=2, device="cpu")
    assert c.block_tokens == 16
    assert (c.blocks_needed(1), c.blocks_needed(16), c.blocks_needed(17)) == (1, 1, 2)


def test_exhaustion_is_typed_backpressure():
    assert issubclass(KVCacheExhaustedError, QueueFullError)
    c = PagedKVCache(layers=1, heads=1, head_dim=2, block_tokens=4,
                     max_blocks=2, device="cpu")
    z = np.zeros((12, 1, 1, 2), np.float32)
    with pytest.raises(KVCacheExhaustedError, match="needs 3 block"):
        c.write_prompt(1, z, z)
    assert c.free_blocks() == 2 and c.length(1) == 0
    c.write_prompt(1, z[:5], z[:5])
    with pytest.raises(ValueError, match="already cached"):
        c.write_prompt(1, z[:1], z[:1])


def test_view_rejects_a_bucket_off_the_block_grid():
    c = PagedKVCache(layers=1, heads=1, head_dim=2, block_tokens=4,
                     max_blocks=2, device="cpu")
    c.write_prompt(1, np.ones((2, 1, 1, 2), np.float32), np.ones((2, 1, 1, 2), np.float32))
    with pytest.raises(ValueError, match="not a multiple"):
        c.batch_view([1], 6)
    k, _, _ = c.batch_view([1], 8)
    assert (k[0, 2:] == 0).all() and (k[0, :2] == 1).all()


def test_empty_prompt_takes_one_block_as_in_jax(jax_cache_cls):
    JaxCache, _ = jax_cache_cls
    jc, pc = _pair(JaxCache)
    z = np.zeros((0, L, H, D), np.float32)
    jc.write_prompt(1, z, z)
    pc.write_prompt(1, z, z)
    _same(jc, pc, (1,), 4)
    assert pc.blocks_of(1) == 1 and pc.length(1) == 0
