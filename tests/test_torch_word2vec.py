"""The host-pair engine (deeplearning4j_torch/nlp/embeddings.py) and the
Word2Vec facade against the JAX package, on the CPU at toy sizes.

Tolerances: one step from carried tables within 1e-6 of max|table| (both
packages divide each row's summed gradient by its count; the sums run in
another order); an
epoch of `fit_sentences` and a whole `Word2Vec.fit` within 1e-5 of
max|table|. A whole fit starts from the JAX package's own init: the test
replaces `embeddings.init_syn0` by the `jax.random` draw, carried by
`utils/params.py:params_from_numpy`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.nlp import embeddings as port_emb
from deeplearning4j_torch.nlp import vocab as port_vocab
from deeplearning4j_torch.nlp.word2vec import Word2Vec as PortWord2Vec
from deeplearning4j_torch.nlp.word2vec import WordVectors as PortWordVectors
from deeplearning4j_torch.utils.params import params_from_numpy
from deeplearning4j_tpu.nlp import embeddings as ref_emb
from deeplearning4j_tpu.nlp import vocab as ref_vocab
from deeplearning4j_tpu.nlp.word2vec import Word2Vec as RefWord2Vec
from deeplearning4j_tpu.nlp.word2vec import WordVectors as RefWordVectors

STEP_TOL = 1e-6    # of max|table|: one step from the same tables
FIT_TOL = 1e-5     # of max|table|: an epoch, a whole fit


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These steps are many small ops: on a loaded machine (the suite's
    parallel workers) torch's intra-op threads wait on each other far
    longer than the ops take, so each test runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def two_topic_corpus(n=40, seed=0, length=6):
    """Sentences drawn from two disjoint topical vocabularies
    (tests/test_nlp.py's corpus)."""
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "bird", "horse", "fish"]
    foods = ["bread", "cheese", "apple", "rice", "soup"]
    return [" ".join(rng.choice(animals if i % 2 == 0 else foods, size=length))
            for i in range(n)]


def jax_init_syn0(seed, V, D, dtype, device):
    """The JAX package's syn0 draw (embeddings.py:268), carried."""
    a = jax.random.uniform(jax.random.PRNGKey(seed), (V, D), jnp.float32,
                           -0.5 / D, 0.5 / D)
    return params_from_numpy({"syn0": np.asarray(a)}, device)["syn0"].to(dtype)


@pytest.fixture
def jax_init(monkeypatch):
    monkeypatch.setattr(port_emb, "init_syn0", jax_init_syn0)


def carry(tables):
    """A JAX table dict as the port's, on the CPU."""
    return params_from_numpy({k: np.asarray(v) for k, v in tables.items()}, "cpu")


def assert_tables_close(got, want, tol, what=""):
    assert set(got) == set(want), (set(got), set(want))
    for k in want:
        w = np.asarray(want[k], np.float32)
        g = got[k].detach().float().cpu().numpy()
        err = float(np.abs(g - w).max())
        assert err <= tol * float(np.abs(w).max()), (what, k, err, np.abs(w).max())


# ----------------------------------------------------------------- steps


def step_inputs(seed=0, V=30, D=8, B=16, K=3, L=5, W=4):
    rng = np.random.default_rng(seed)
    t = {"syn0": (rng.standard_normal((V, D)) * 2).astype(np.float32),
         "syn1": (rng.standard_normal((V - 1, D)) * 2).astype(np.float32),
         "syn1neg": (rng.standard_normal((V, D)) * 0.5).astype(np.float32)}
    codes = rng.integers(-1, 2, (B, L)).astype(np.int32)
    codes[:, 0] = np.maximum(codes[:, 0], 0)
    # padding at the end of each path, as codes_points_arrays pads
    codes = np.where(np.cumsum(codes < 0, axis=1) > 0, -1, codes).astype(np.int32)
    return dict(
        tables=t, centers=rng.integers(0, V, B).astype(np.int32),
        ctx_sg=rng.integers(0, V, B).astype(np.int32),
        ctx_cbow=np.where(rng.random((B, W)) < 0.3, -1,
                          rng.integers(0, V, (B, W))).astype(np.int32),
        negs=rng.integers(0, V, (B, K)).astype(np.int32), codes=codes,
        points=np.where(codes >= 0, rng.integers(0, V - 1, (B, L)), -1).astype(np.int32))


@pytest.mark.parametrize("cbow", [False, True], ids=["skipgram", "cbow"])
@pytest.mark.parametrize("objective", ["ns", "hs"])
def test_one_step_matches_jax(objective, cbow):
    s = step_inputs(seed=int(cbow) + 2 * (objective == "hs"))
    ctx = s["ctx_cbow"] if cbow else s["ctx_sg"]
    drop = "syn1" if objective == "ns" else "syn1neg"
    tables = {k: v for k, v in s["tables"].items() if k != drop}
    lr = 0.05
    jt = {k: jnp.asarray(v) for k, v in tables.items()}
    if objective == "ns":
        want, wl = ref_emb._ns_step(jt, jnp.asarray(s["centers"]), jnp.asarray(ctx),
                                    jnp.asarray(s["negs"]),
                                    jnp.asarray(lr, jnp.float32), cbow=cbow)
        got, gl = port_emb._ns_step(carry(tables), torch.as_tensor(s["centers"]),
                                    torch.as_tensor(ctx), torch.as_tensor(s["negs"]),
                                    lr, cbow=cbow)
    else:
        # this batch holds code bits on both sides of the |score| < 6 window
        h = (s["tables"]["syn0"][s["centers"]] if not cbow else None)
        if h is not None:
            score = np.einsum("bd,bld->bl", h, s["tables"]["syn1"][
                np.maximum(s["points"], 0)])[s["codes"] >= 0]
            assert (np.abs(score) >= 6).any() and (np.abs(score) < 6).any()
        want, wl = ref_emb._hs_step(jt, jnp.asarray(s["centers"]), jnp.asarray(ctx),
                                    jnp.asarray(s["codes"]), jnp.asarray(s["points"]),
                                    jnp.asarray(lr, jnp.float32), cbow=cbow)
        got, gl = port_emb._hs_step(carry(tables), torch.as_tensor(s["centers"]),
                                    torch.as_tensor(ctx), torch.as_tensor(s["codes"]),
                                    torch.as_tensor(s["points"]), lr, cbow=cbow)
    assert_tables_close(got, want, STEP_TOL, (objective, cbow))
    assert abs(float(gl) - float(wl)) <= 1e-6 * abs(float(wl))
    moved = max(float(np.abs(np.asarray(want[k]) - tables[k]).max()) for k in tables)
    assert moved > 1e-3   # the step did something to compare


def test_hs_skip_rule_matters():
    """Without the MAX_EXP skip the step above would differ: the batch's
    out-of-window bits carry real gradient."""
    s = step_inputs(seed=2)
    tables = {k: v for k, v in s["tables"].items() if k != "syn1neg"}
    args = (torch.as_tensor(s["centers"]), torch.as_tensor(s["ctx_sg"]),
            torch.as_tensor(s["codes"]), torch.as_tensor(s["points"]), 0.05)
    with_skip, _ = port_emb._hs_step(carry(tables), *args)
    orig = port_emb.MAX_EXP
    try:
        port_emb.MAX_EXP = float("inf")
        without, _ = port_emb._hs_step(carry(tables), *args)
    finally:
        port_emb.MAX_EXP = orig
    assert float((with_skip["syn1"] - without["syn1"]).abs().max()) > 1e-3


def test_bfloat16_tables_stay_bfloat16():
    """bfloat16 tables train in bfloat16 (the JAX package promotes them to
    float32 in their first step): one NS step within 1e-2 of max|table| of
    the JAX step on the same bfloat16 tables."""
    s = step_inputs(seed=5)
    tables = {k: v for k, v in s["tables"].items() if k != "syn1"}
    bf = {k: jnp.asarray(v, jnp.bfloat16) for k, v in tables.items()}
    want, _ = ref_emb._ns_step(dict(bf), jnp.asarray(s["centers"]),
                               jnp.asarray(s["ctx_sg"]), jnp.asarray(s["negs"]),
                               jnp.asarray(0.05, jnp.float32))
    got, _ = port_emb._ns_step(
        {k: torch.as_tensor(np.asarray(v, np.float32)).bfloat16() for k, v in bf.items()},
        torch.as_tensor(s["centers"]), torch.as_tensor(s["ctx_sg"]),
        torch.as_tensor(s["negs"]), 0.05)
    assert all(t.dtype == torch.bfloat16 for t in got.values())
    assert_tables_close(got, {k: np.asarray(v, np.float32) for k, v in want.items()},
                        1e-2)


# ----------------------------------------------------------------- epochs


def _caches(sentences):
    from deeplearning4j_torch.nlp.tokenization import DefaultTokenizerFactory
    toks = [DefaultTokenizerFactory().create(s).get_tokens() for s in sentences]
    return (toks, ref_vocab.VocabConstructor().build(toks),
            port_vocab.VocabConstructor().build(toks))


TRAINER_CASES = {
    "sg_ns": dict(negative=3),
    "sg_hs": dict(negative=0, use_hierarchic_softmax=True),
    "cbow_hs_ns": dict(negative=2, use_hierarchic_softmax=True, cbow=True),
    "sg_hs_ns_sampled": dict(negative=2, use_hierarchic_softmax=True, sampling=0.05),
}


@pytest.mark.parametrize("case", sorted(TRAINER_CASES))
def test_fit_sentences_epoch_matches_jax(case):
    toks, ref_cache, port_cache = _caches(two_topic_corpus(n=30, seed=1))
    kw = dict(layer_size=8, window=3, learning_rate=0.1, batch_size=48, seed=3,
              **TRAINER_CASES[case])
    ref = ref_emb.BatchedEmbeddingTrainer(ref_cache, **kw)
    port = port_emb.BatchedEmbeddingTrainer(port_cache, device="cpu", **kw)
    port.tables = carry(ref.tables)
    idx = ref_emb.sentences_to_indices(toks, ref_cache)
    ref.fit_sentences(idx, epochs=1)
    port.fit_sentences(port_emb.sentences_to_indices(toks, port_cache), epochs=1)
    assert_tables_close(port.tables, ref.tables, FIT_TOL, case)
    assert abs(port.last_loss - ref.last_loss) <= 1e-5 * abs(ref.last_loss)


def _fit_both(**kw):
    corpus = two_topic_corpus(n=30, seed=2)
    out = []
    for cls, extra in ((RefWord2Vec, {}), (PortWord2Vec, {"device": "cpu"})):
        b = cls.builder().iterate(corpus)
        for k, v in dict(kw, **extra).items():
            getattr(b, k)(v)
        out.append(b.build().fit())
    return out


@pytest.mark.parametrize("kw", [
    dict(layer_size=8, window_size=3, epochs=2, batch_size=64, learning_rate=0.1,
         seed=7),
    dict(layer_size=8, window_size=2, epochs=1, batch_size=64, negative_sample=3,
         use_hierarchic_softmax=False, elements_learning_algorithm="CBOW", seed=5),
], ids=["hs_default", "cbow_ns"])
def test_word2vec_fit_matches_jax(jax_init, kw):
    ref, port = _fit_both(**kw)
    assert port.vocab.index2word == ref.vocab.index2word
    want = ref.get_word_vector_matrix()
    err = float(np.abs(port.get_word_vector_matrix() - want).max())
    assert err <= FIT_TOL * float(np.abs(want).max()), err
    assert_tables_close(port._trainer.tables, ref._trainer.tables, FIT_TOL)


@pytest.mark.parametrize("kw", [
    dict(device_corpus=True),   # HS on by default
    dict(device_corpus=True, use_hierarchic_softmax=False),   # negative 0
    dict(device_corpus=True, use_hierarchic_softmax=False, negative_sample=2,
         elements_learning_algorithm="cbow"),
], ids=["hs", "no_negative", "cbow"])
def test_sharded_config_errors_word_for_word(kw):
    msgs = []
    for cls, extra in ((RefWord2Vec, {}), (PortWord2Vec, {"device": "cpu"})):
        b = cls.builder().iterate(["a b c", "b c d"])
        for k, v in dict(kw, **extra).items():
            getattr(b, k)(v)
        with pytest.raises(ValueError) as e:
            b.build().fit()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_builder_needs_iterate():
    with pytest.raises(ValueError, match="iterate"):
        PortWord2Vec.builder().build()


def test_queries_match_jax():
    """similarity, words_nearest and words_nearest_sum on the same vectors
    give the same answers (numpy on host copies in both packages)."""
    _, ref_cache, port_cache = _caches(two_topic_corpus(n=20, seed=4))
    vecs = np.random.default_rng(0).standard_normal((len(ref_cache), 6)).astype(
        np.float32)
    ref, port = RefWordVectors(ref_cache, vecs), PortWordVectors(port_cache, vecs)
    words = ref_cache.index2word
    for a in words:
        assert port.words_nearest(a, 4) == ref.words_nearest(a, 4)
        for b in words:
            assert port.similarity(a, b) == ref.similarity(a, b)
    assert (port.words_nearest_sum(["cat", "rice"], ["dog"], 3)
            == ref.words_nearest_sum(["cat", "rice"], ["dog"], 3))
    assert port.words_nearest(vecs[2], 5) == ref.words_nearest(vecs[2], 5)
    assert port.words_nearest("unknown") == [] and np.isnan(port.similarity("x", "cat"))


def test_trainers_raise_without_a_gpu(monkeypatch):
    """device=None means CUDA: with no GPU every trainer raises instead of
    training on the CPU."""
    from deeplearning4j_torch.graph import DeepWalk, Graph
    from deeplearning4j_torch.nlp import (Glove, ParagraphVectors, SequenceVectors,
                                          ShardedWord2Vec)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, cache = _caches(two_topic_corpus(n=4))
    calls = [lambda: port_emb.BatchedEmbeddingTrainer(cache),
             lambda: ShardedWord2Vec(cache),
             lambda: PortWord2Vec.builder().iterate(["a b", "b c"]).build().fit(),
             lambda: Glove.builder().iterate(["a b c", "b c a"]).build().fit(),
             lambda: ParagraphVectors.builder().iterate(["a b", "b c"]).build().fit(),
             lambda: SequenceVectors().fit([[1, 2, 3]]),
             lambda: DeepWalk().initialize(Graph(3))]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
