"""The device-corpus engine (deeplearning4j_torch/nlp/distributed.py) against
the JAX package's, on the CPU.

The port draws its chunk randomness from a torch generator, the JAX package
from `jax.random`, so the parity tests feed the port's pure chunk the JAX
package's own draws, rebuilt from its key as distributed.py does it (split
the call's key for each chunk, split that into window, negative and keep
keys, then randint / uniform / randint). Tolerances: the tables after one
chunk and after a 3-chunk call within 1e-5 of max|table|; a 2- and 4-shard
CPU mesh against one shard within rtol 2e-4, atol 2e-5 after 2 epochs, the
JAX package's own tolerance for its mesh (tests/test_distributed_nlp.py).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_torch.nlp import distributed as port_dist
from deeplearning4j_torch.nlp.vocab import VocabCache as PortVocabCache
from deeplearning4j_torch.parallel.mesh import data_parallel_mesh
from deeplearning4j_tpu.nlp import distributed as ref_dist
from deeplearning4j_tpu.nlp.vocab import VocabCache as RefVocabCache

from test_torch_word2vec import assert_tables_close, carry, one_torch_thread  # noqa: F401

TOL = 1e-5   # of max|table|
N_CLUSTER_WORDS = 60


def cluster_corpus(cache_cls, n_sent=600, seed=0, length=12):
    """Two 30-word topic clusters that only co-occur internally
    (tests/test_distributed_nlp.py's corpus)."""
    rng = np.random.default_rng(seed)
    half = N_CLUSTER_WORDS // 2
    sents = [rng.integers(half * c, half * (c + 1), length).astype(np.int32)
             for c in (rng.integers(0, 2) for _ in range(n_sent))]
    cache = cache_cls()
    flat, counts = np.unique(np.concatenate(sents), return_counts=True)
    for w, c in zip(flat, counts):
        cache.add_token(str(w), count=int(c))
    cache.finish(min_word_frequency=1)
    remap = np.zeros(N_CLUSTER_WORDS, np.int32)
    for w in flat:
        remap[w] = cache.index_of(str(w))
    return cache, [remap[s] for s in sents]


def cluster_score(cache, vectors):
    """mean(within-cluster cos) - mean(cross-cluster cos)."""
    idx = {int(w): cache.index_of(w) for w in cache.index2word}
    v = vectors / np.clip(np.linalg.norm(vectors, axis=1, keepdims=True), 1e-12, None)
    half = N_CLUSTER_WORDS // 2
    within, cross = [], []
    for a in range(N_CLUSTER_WORDS):
        for b in range(a + 1, N_CLUSTER_WORDS):
            if a in idx and b in idx:
                (within if (a < half) == (b < half) else cross).append(
                    float(v[idx[a]] @ v[idx[b]]))
    return np.mean(within) - np.mean(cross)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def jax_draws(key, steps, chunk, window, negative, table_len):
    """The draws of `steps` chunks of the JAX package's superstep from the
    call's key (distributed.py:157 and :76-99)."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        k_win, k_neg, k_keep = jax.random.split(sub, 3)
        out.append((jax.random.randint(k_win, (chunk,), 1, window + 1),
                    jax.random.uniform(k_keep, (chunk, 2 * window + 1)),
                    jax.random.randint(k_neg, (chunk, negative), 0, table_len)))
    return out


def feed_jax_draws(port, ref_key, steps):
    """Make `port` draw the JAX package's numbers for its next `steps`
    chunks."""
    draws = jax_draws(ref_key, steps, port.chunk, port.window, port.negative,
                      len(port._unigram))
    it = iter([tuple(torch.as_tensor(np.array(a)) for a in d) for d in draws])
    port._draw = lambda: next(it)


def twins(n_sent=40, seed=3, sampling=0.0, **kw):
    ref_cache, idx = cluster_corpus(RefVocabCache, n_sent=n_sent, seed=seed)
    port_cache, _ = cluster_corpus(PortVocabCache, n_sent=n_sent, seed=seed)
    kw = dict(dict(layer_size=8, window=3, negative=4, learning_rate=0.1, seed=11,
                   sampling=sampling), **kw)
    ref = ref_dist.ShardedWord2Vec(ref_cache, **kw)
    port = port_dist.ShardedWord2Vec(port_cache, device="cpu", **kw)
    port.tables = carry(ref.tables)
    return ref, port, ref_dist.corpus_arrays(idx)


@pytest.mark.parametrize("sampling", [0.0, 2e-2], ids=["all_kept", "subsampled"])
def test_one_chunk_on_jax_draws(sampling):
    ref, port, (toks, sids) = twins(chunk=512, steps_per_call=1, sampling=sampling)
    assert len(toks) <= 512
    draws = jax_draws(ref._key, 1, 512, 3, 4, len(port._unigram))[0]
    ref.fit_corpus(toks, sids, epochs=1)
    port._device_corpus(toks, sids)
    loss = port_dist.one_chunk(port._replicas, port._shard_devices, 0, 0.1,
                               *(torch.as_tensor(np.array(a)) for a in draws), 3)
    assert_tables_close(port.tables, ref.tables, TOL)
    np.testing.assert_allclose(float(loss), float(ref.last_losses[0]), rtol=1e-5)


def test_three_chunk_call_on_jax_draws():
    ref, port, (toks, sids) = twins(chunk=160, steps_per_call=3)
    assert 320 < len(toks) <= 480   # one call of three chunks, the last ragged
    feed_jax_draws(port, ref._key, 3)
    ref.fit_corpus(toks, sids, epochs=1)
    port.fit_corpus(toks, sids, epochs=1)
    assert_tables_close(port.tables, ref.tables, TOL)
    np.testing.assert_allclose(port.last_losses.numpy(), np.asarray(ref.last_losses),
                               rtol=1e-5)


def test_two_calls_with_decaying_rate_on_jax_draws():
    """Two calls of two chunks over two epochs: the host's learning rates
    and the key carried across calls as the JAX package carries them."""
    ref, port, (toks, sids) = twins(chunk=128, steps_per_call=2, n_sent=20)
    key = ref._key
    draws = []
    for _ in range(4):   # the key after each call is the last split's
        draws += jax_draws(key, 2, 128, 3, 4, len(port._unigram))
        for _ in range(2):
            key, _ = jax.random.split(key)
    it = iter([tuple(torch.as_tensor(np.array(a)) for a in d) for d in draws])
    port._draw = lambda: next(it)
    ref.fit_corpus(toks, sids, epochs=2)
    port.fit_corpus(toks, sids, epochs=2)
    assert_tables_close(port.tables, ref.tables, TOL)


# tests/test_distributed_nlp.py's mesh settings at lr 0.1, where a shard
# that divides by its own touch counts only moves rows 3e-4 beyond the
# tolerance (at 0.025, 2e-6 inside it)
MESH_KW = dict(layer_size=16, window=3, negative=4, chunk=1024, steps_per_call=2,
               seed=5, learning_rate=0.1, device="cpu")


@pytest.mark.parametrize("shards", [2, 4])
def test_cpu_mesh_matches_one_shard(shards):
    cache, idx = cluster_corpus(PortVocabCache, n_sent=200, seed=1)
    toks, sids = port_dist.corpus_arrays(idx)
    kw = MESH_KW
    single = port_dist.ShardedWord2Vec(cache, **kw).fit_corpus(toks, sids, epochs=2)
    mesh = data_parallel_mesh(devices=["cpu"] * shards)
    sharded = port_dist.ShardedWord2Vec(cache, mesh=mesh, **kw)
    sharded.fit_corpus(toks, sids, epochs=2)
    np.testing.assert_allclose(single.vectors(), sharded.vectors(), rtol=2e-4,
                               atol=2e-5)
    assert len(sharded._shard_devices) == shards


def test_shards_that_count_alone_disagree(monkeypatch):
    """A shard dividing by its own touch counts only is a different update:
    the mesh comparison above would catch it."""
    cache, idx = cluster_corpus(PortVocabCache, n_sent=200, seed=1)
    toks, sids = port_dist.corpus_arrays(idx)
    kw = MESH_KW
    single = port_dist.ShardedWord2Vec(cache, **kw).fit_corpus(toks, sids, epochs=2)
    monkeypatch.setattr(port_dist, "meet_counts", lambda parts, group=None: [
        {k: p[k] for k in ("syn0_counts", "syn1_counts")} for p in parts])
    alone = port_dist.ShardedWord2Vec(
        cache, mesh=data_parallel_mesh(devices=["cpu"] * 2), **kw).fit_corpus(
            toks, sids, epochs=2)
    assert not np.allclose(single.vectors(), alone.vectors(), rtol=2e-4, atol=2e-5)


def test_chunk_must_divide_evenly_word_for_word():
    from deeplearning4j_tpu.parallel.mesh import data_parallel_mesh as ref_mesh
    ref_cache, _ = cluster_corpus(RefVocabCache, n_sent=50)
    port_cache, _ = cluster_corpus(PortVocabCache, n_sent=50)
    with pytest.raises(ValueError, match="divide evenly") as want:
        ref_dist.ShardedWord2Vec(ref_cache, chunk=1001, mesh=ref_mesh(8))
    with pytest.raises(ValueError, match="divide evenly") as got:
        port_dist.ShardedWord2Vec(port_cache, chunk=1001,
                                  mesh=data_parallel_mesh(devices=["cpu"] * 8))
    assert str(got.value) == str(want.value)


def test_hierarchical_softmax_is_refused():
    cache, _ = cluster_corpus(PortVocabCache, n_sent=10)
    with pytest.raises(NotImplementedError, match="hierarchical softmax"):
        port_dist.ShardedWord2Vec(cache, negative=0, device="cpu")


def test_learns_cluster_structure():
    cache, idx = cluster_corpus(PortVocabCache)
    toks, sids = port_dist.corpus_arrays(idx)
    tr = port_dist.ShardedWord2Vec(cache, layer_size=32, window=4, negative=5,
                                   learning_rate=0.1, chunk=256, steps_per_call=8,
                                   seed=3, device="cpu")
    tr.fit_corpus(toks, sids, epochs=15)
    assert cluster_score(cache, tr.vectors()) > 0.3


def test_pairs_never_cross_a_sentence_boundary():
    """Every valid pair of `chunk_pairs` lies in one sentence, and the
    valid pairs are exactly those a direct numpy enumeration finds."""
    rng = np.random.default_rng(7)
    sents = [rng.integers(0, 12, rng.integers(1, 7)).astype(np.int32)
             for _ in range(60)]
    toks, sids = port_dist.corpus_arrays(sents)
    cache = PortVocabCache()
    for t in range(12):
        cache.add_token(str(t))
    cache.finish()
    tr = port_dist.ShardedWord2Vec(cache, layer_size=4, window=4, negative=2,
                                   chunk=256, device="cpu")
    tr._device_corpus(toks, sids)
    rep = tr._replicas[tr.device]
    n = len(toks)
    idx = torch.arange(256)
    b = torch.as_tensor(rng.integers(1, 5, 256))
    u = torch.zeros((256, 9))
    _, _, valid = port_dist.chunk_pairs(rep, idx, b, u, 4)
    offs = np.array([-4, -3, -2, -1, 1, 2, 3, 4])
    want = np.zeros((256, 8), bool)
    for i in range(min(n, 256)):
        for j, o in enumerate(offs):
            p = i + o
            want[i, j] = abs(o) <= int(b[i]) and 0 <= p < n and sids[p] == sids[i]
    np.testing.assert_array_equal(valid.numpy(), want)


def test_sentence_boundaries_respected_in_training():
    """tests/test_distributed_nlp.py's check: tokens 0 and 1 only ever sit in
    adjacent sentences, so their similarity stays near chance."""
    rng = np.random.default_rng(7)
    sents = []
    for _ in range(300):
        sents += [np.full(6, 0, np.int32), np.full(6, 1, np.int32),
                  rng.integers(2, 12, 8).astype(np.int32)]
    cache = PortVocabCache()
    flat, counts = np.unique(np.concatenate(sents), return_counts=True)
    for w, c in zip(flat, counts):
        cache.add_token(str(w), count=int(c))
    cache.finish()
    remap = np.zeros(12, np.int32)
    for w in flat:
        remap[w] = cache.index_of(str(w))
    toks, sids = port_dist.corpus_arrays([remap[s] for s in sents])
    tr = port_dist.ShardedWord2Vec(cache, layer_size=16, window=5, negative=4,
                                   chunk=1024, steps_per_call=2, seed=9, device="cpu")
    v = tr.fit_corpus(toks, sids, epochs=4).vectors()
    v = v / np.clip(np.linalg.norm(v, axis=1, keepdims=True), 1e-12, None)
    assert float(v[cache.index_of("0")] @ v[cache.index_of("1")]) < 0.5


def test_corpus_cache_keys_on_content():
    cache, idx = cluster_corpus(PortVocabCache, n_sent=40, seed=3)
    toks, sids = port_dist.corpus_arrays(idx)
    tr = port_dist.ShardedWord2Vec(cache, layer_size=8, window=2, negative=2,
                                   chunk=256, steps_per_call=1, seed=1, device="cpu")
    c1 = tr._device_corpus(toks, sids)
    c1b = tr._device_corpus(toks.copy(), sids.copy())
    assert c1[0] is c1b[0]   # same content: the same device buffers
    assert c1[0].dtype == torch.int32
    toks2 = toks.copy()
    toks2[0] = (toks2[0] + 1) % len(cache)
    c2 = tr._device_corpus(toks2, sids)
    assert c2[0] is not c1[0] and int(c2[0][0]) == int(toks2[0])


def test_tables_setter_reaches_every_replica():
    cache, _ = cluster_corpus(PortVocabCache, n_sent=10)
    mesh = data_parallel_mesh(devices=["cpu", "cpu"])
    tr = port_dist.ShardedWord2Vec(cache, layer_size=4, chunk=64, mesh=mesh)
    t = {"syn0": torch.ones(len(cache), 4), "syn1neg": torch.full((len(cache), 4), 2.0)}
    tr.tables = t
    assert all(torch.equal(rep.tables["syn1neg"], t["syn1neg"])
               for rep in tr._replicas.values())
    assert tr.tables["syn0"] is not t["syn0"]


def test_word2vec_device_corpus_facade():
    from deeplearning4j_torch.nlp.word2vec import Word2Vec
    rng = np.random.default_rng(4)
    animals = ["cat", "dog", "horse", "cow", "sheep"]
    tools = ["hammer", "saw", "drill", "wrench", "pliers"]
    sents = [" ".join(rng.choice(animals if rng.integers(0, 2) else tools, 8))
             for _ in range(300)]
    for extra in ({"device_corpus": True, "device": "cpu"},
                  {"mesh": data_parallel_mesh(devices=["cpu"] * 2)}):
        b = (Word2Vec.builder().iterate(sents).layer_size(16).window_size(3)
             .negative_sample(4).use_hierarchic_softmax(False).chunk(256)
             .learning_rate(0.1).epochs(12).seed(12))
        for k, v in extra.items():
            getattr(b, k)(v)
        w2v = b.build().fit()
        assert w2v.similarity("saw", "drill") > w2v.similarity("saw", "cow")
