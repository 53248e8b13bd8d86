"""ParagraphVectors and GloVe of the port (deeplearning4j_torch/nlp/
paragraph_vectors.py, glove.py) against the JAX package's, on the CPU.

Tolerances, all of max|table|: one PV-DM step from carried tables 1e-6;
whole DBOW and DM fits (NS and HS) 1e-5, from the JAX package's own inits
(`embeddings.init_syn0` and `paragraph_vectors.init_doc_table` replaced by
its `jax.random` draws, carried); `infer_vector` on carried tables 1e-5
(its HS form has no MAX_EXP skip in either package); GloVe over 2 epochs
1e-5 from its numpy init, which both packages draw alike.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.nlp import embeddings as port_emb
from deeplearning4j_torch.nlp import glove as port_glove
from deeplearning4j_torch.nlp import paragraph_vectors as port_pv
from deeplearning4j_torch.utils.params import params_from_numpy
from deeplearning4j_tpu.nlp import glove as ref_glove
from deeplearning4j_tpu.nlp import paragraph_vectors as ref_pv

from test_torch_word2vec import (assert_tables_close, carry, jax_init_syn0,  # noqa: F401
                                 one_torch_thread, step_inputs, two_topic_corpus)

STEP_TOL, FIT_TOL = 1e-6, 1e-5


def jax_init_doc_table(seed, n_docs, D, device):
    """The JAX package's doc table draw (paragraph_vectors.py:257), carried."""
    a = jax.random.uniform(jax.random.PRNGKey(seed), (n_docs, D), jnp.float32,
                           -0.5 / D, 0.5 / D)
    return params_from_numpy({"docs": np.asarray(a)}, device)["docs"]


@pytest.fixture
def jax_inits(monkeypatch):
    monkeypatch.setattr(port_emb, "init_syn0", jax_init_syn0)
    monkeypatch.setattr(port_pv, "init_doc_table", jax_init_doc_table)


@pytest.mark.parametrize("objective", ["ns", "hs"])
def test_dm_step_matches_jax(objective):
    s = step_inputs(seed=11)
    rng = np.random.default_rng(12)
    docs = (rng.standard_normal((7, 8)) * 2).astype(np.float32)
    docids = rng.integers(0, 7, len(s["centers"])).astype(np.int32)
    drop = "syn1" if objective == "ns" else "syn1neg"
    tables = {k: v for k, v in s["tables"].items() if k != drop}
    tables["docs"] = docs
    jt = {k: jnp.asarray(v) for k, v in tables.items()}
    lr = 0.05
    if objective == "ns":
        want, wl = ref_pv._dm_ns_step(jt, jnp.asarray(docids), jnp.asarray(s["ctx_cbow"]),
                                      jnp.asarray(s["centers"]), jnp.asarray(s["negs"]),
                                      jnp.asarray(lr, jnp.float32))
        got, gl = port_pv._dm_ns_step(carry(tables), torch.as_tensor(docids),
                                      torch.as_tensor(s["ctx_cbow"]),
                                      torch.as_tensor(s["centers"]),
                                      torch.as_tensor(s["negs"]), lr)
    else:
        want, wl = ref_pv._dm_hs_step(jt, jnp.asarray(docids), jnp.asarray(s["ctx_cbow"]),
                                      jnp.asarray(s["codes"]), jnp.asarray(s["points"]),
                                      jnp.asarray(lr, jnp.float32))
        got, gl = port_pv._dm_hs_step(carry(tables), torch.as_tensor(docids),
                                      torch.as_tensor(s["ctx_cbow"]),
                                      torch.as_tensor(s["codes"]),
                                      torch.as_tensor(s["points"]), lr)
    assert_tables_close(got, want, STEP_TOL, objective)
    assert abs(float(gl) - float(wl)) <= 1e-6 * abs(float(wl))
    assert float(np.abs(np.asarray(want["docs"]) - docs).max()) > 1e-3


def _fit_both(algo, **kw):
    docs = two_topic_corpus(n=16, seed=1)
    labels = [f"DOC_{i}" for i in range(len(docs))]
    base = dict(layer_size=8, window_size=2, epochs=2, batch_size=64,
                learning_rate=0.1, min_learning_rate=0.01, seed=7)
    base.update(kw)
    out = []
    for mod, extra in ((ref_pv, {}), (port_pv, {"device": "cpu"})):
        b = (mod.ParagraphVectors.builder().iterate(docs).labels(labels)
             .sequence_learning_algorithm(algo))
        for k, v in dict(base, **extra).items():
            getattr(b, k)(v)
        out.append(b.build().fit())
    return out


PV_CASES = {
    "dbow_ns": ("dbow", dict(negative_sample=3, use_hierarchic_softmax=False)),
    "dbow_hs": ("dbow", dict(negative_sample=0, use_hierarchic_softmax=True)),
    "dm_ns": ("dm", dict(negative_sample=3, use_hierarchic_softmax=False)),
    "dm_hs_ns": ("dm", dict(negative_sample=2, use_hierarchic_softmax=True)),
}


@pytest.mark.parametrize("case", sorted(PV_CASES))
def test_paragraph_vectors_fit_and_infer_match_jax(jax_inits, case):
    algo, kw = PV_CASES[case]
    ref, port = _fit_both(algo, **kw)
    assert port.labels_source.labels == ref.labels_source.labels
    for a, b in ((port._doc_vectors, ref._doc_vectors),
                 (port.get_word_vector_matrix(), ref.get_word_vector_matrix())):
        assert float(np.abs(a - b).max()) <= FIT_TOL * float(np.abs(b).max()), case
    assert_tables_close(port._trainer.tables, ref._trainer.tables, FIT_TOL, case)
    # inference from the very same tables
    port._trainer.tables = carry(ref._trainer.tables)
    for text in ("cat dog horse fish bird cat", "bread soup", "unknown words"):
        want = ref.infer_vector(text, iterations=12)
        got = port.infer_vector(text, iterations=12)
        assert float(np.abs(got - want).max()) <= FIT_TOL * float(np.abs(want).max()), \
            (case, text)
    assert port.doc_vector("DOC_3").shape == (8,) and port.doc_vector("nope") is None
    assert port.similarity_docs("DOC_0", "DOC_2") == pytest.approx(
        ref.similarity_docs("DOC_0", "DOC_2"), abs=1e-4)


def test_infer_hs_has_no_skip_window():
    """Inference on HS keeps every code bit, |score| >= 6 included, as the
    JAX package's `_infer_hs` does (training skips them)."""
    s = step_inputs(seed=2)
    syn1 = s["tables"]["syn1"]
    doc = s["tables"]["syn0"][0] * 3
    codes, points = s["codes"][:6], s["points"][:6]
    lrs = np.full(4, 0.05, np.float32)
    want = ref_pv._infer_hs(jnp.asarray(doc), jnp.asarray(syn1), jnp.asarray(codes),
                            jnp.asarray(points), jnp.asarray(lrs), 4)
    got = port_pv._infer_hs(torch.as_tensor(doc), torch.as_tensor(syn1),
                            torch.as_tensor(codes), torch.as_tensor(points),
                            torch.as_tensor(lrs), 4)
    score = np.einsum("d,nld->nl", doc, syn1[np.maximum(points, 0)])[codes >= 0]
    assert (np.abs(score) >= 6).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_builder_errors():
    with pytest.raises(ValueError, match="iterate"):
        port_pv.ParagraphVectors.builder().build()
    pv = port_pv.ParagraphVectors.builder().iterate(["a b"]).labels(["x", "y"]) \
        .device("cpu").build()
    with pytest.raises(ValueError, match="2 labels for 1 docs"):
        pv.fit()
    with pytest.raises(RuntimeError, match="fit"):
        port_pv.ParagraphVectors.builder().iterate(["a b"]).build().infer_vector("a")


@pytest.mark.parametrize("symmetric", [True, False])
def test_glove_two_epochs_match_jax(symmetric):
    corpus = two_topic_corpus(n=40, seed=2)
    out = []
    for mod, extra in ((ref_glove, {}), (port_glove, {"device": "cpu"})):
        b = (mod.Glove.builder().iterate(corpus).layer_size(8).window_size(3)
             .epochs(2).batch_size(64).learning_rate(0.05).symmetric(symmetric)
             .seed(11))
        for k, v in extra.items():
            getattr(b, k)(v)
        out.append(b.build().fit())
    ref, port = out
    want = ref.get_word_vector_matrix()
    assert port.vocab.index2word == ref.vocab.index2word
    assert float(np.abs(port.get_word_vector_matrix() - want).max()) <= \
        FIT_TOL * float(np.abs(want).max())
    assert port.last_loss == pytest.approx(ref.last_loss, rel=1e-5)


def test_glove_step_matches_jax():
    rng = np.random.default_rng(3)
    V, D, B = 12, 6, 40
    tables = {"W": rng.standard_normal((V, D)).astype(np.float32),
              "Wt": rng.standard_normal((V, D)).astype(np.float32),
              "b": rng.standard_normal(V).astype(np.float32),
              "bt": rng.standard_normal(V).astype(np.float32)}
    accum = {k: rng.random(v.shape).astype(np.float32) for k, v in tables.items()}
    rows, cols = rng.integers(0, V, B), rng.integers(0, V, B)   # repeats included
    logx = rng.random(B).astype(np.float32)
    fx = rng.random(B).astype(np.float32)
    wt, wa, wl = ref_glove._glove_step(
        {k: jnp.asarray(v) for k, v in tables.items()},
        {k: jnp.asarray(v) for k, v in accum.items()}, jnp.asarray(rows),
        jnp.asarray(cols), jnp.asarray(logx), jnp.asarray(fx),
        jnp.asarray(0.05, jnp.float32))
    gt, ga, gl = port_glove._glove_step(carry(tables), carry(accum),
                                        torch.as_tensor(rows), torch.as_tensor(cols),
                                        torch.as_tensor(logx), torch.as_tensor(fx), 0.05)
    assert_tables_close(gt, wt, STEP_TOL)
    assert_tables_close(ga, wa, STEP_TOL)
    assert float(gl) == pytest.approx(float(wl), rel=1e-6)


def test_cooccurrence_counts_equal():
    rng = np.random.default_rng(0)
    sents = [rng.integers(0, 9, rng.integers(1, 10)) for _ in range(30)]
    for kw in (dict(), dict(window=2, symmetric=False), dict(distance_weighted=False)):
        assert port_glove.cooccurrence_counts(sents, **kw) == \
            ref_glove.cooccurrence_counts(sents, **kw)
