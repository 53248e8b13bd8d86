"""The port's serializer, vectorizers, text iterators and graph/ package
against the JAX package's, on the CPU.

- WordVectorSerializer: a file written by either package is byte for byte
  the other's, and reads back in either to the same words and bitwise the
  same matrix (binary and header text; the headerless text keeps 6
  significant digits in both, so its matrix is compared to the other
  package's read of the same file).
- BagOfWords / TF-IDF rows, CnnSentenceDataSetIterator and
  Word2VecDataSetIterator DataSets: equal.
- Random walks and node2vec walks: identical (numpy in both).
- DeepWalk, Node2Vec and SequenceVectors fits from the JAX package's init
  (`embeddings.init_syn0` replaced by its draw, carried): within 1e-5 of
  max|table|.
"""
import numpy as np
import pytest

from deeplearning4j_torch.graph import core as port_core
from deeplearning4j_torch.graph import deepwalk as port_dw
from deeplearning4j_torch.graph import node2vec as port_n2v
from deeplearning4j_torch.nlp import serializer as port_ser
from deeplearning4j_torch.nlp import vectorizers as port_vec
from deeplearning4j_torch.nlp import word2vec as port_w2v
from deeplearning4j_torch.nlp.sequence_vectors import SequenceVectors as PortSV
from deeplearning4j_torch.nlp.vocab import VocabConstructor as PortVC
from deeplearning4j_tpu.graph import core as ref_core
from deeplearning4j_tpu.graph import deepwalk as ref_dw
from deeplearning4j_tpu.graph import node2vec as ref_n2v
from deeplearning4j_tpu.nlp import serializer as ref_ser
from deeplearning4j_tpu.nlp import vectorizers as ref_vec
from deeplearning4j_tpu.nlp import word2vec as ref_w2v
from deeplearning4j_tpu.nlp.sequence_vectors import SequenceVectors as RefSV
from deeplearning4j_tpu.nlp.vocab import VocabConstructor as RefVC

from test_torch_word2vec import (FIT_TOL, assert_tables_close, jax_init,  # noqa: F401
                                 one_torch_thread, two_topic_corpus)

WORDS = [["alpha", "beta", "gamma", "delta", "ünï", "x"] * 3 + ["beta"] * 4]


def _word_vectors(seed=0, D=5):
    vecs = np.random.default_rng(seed).standard_normal((6, D)).astype(np.float32)
    vecs[0, 0] = np.float32(1e-38)        # subnormal-adjacent and exact values
    vecs[1, 1] = np.float32(-0.0)
    vecs[2, 2] = np.float32(3.4e38)
    return (ref_w2v.WordVectors(RefVC().build(WORDS), vecs),
            port_w2v.WordVectors(PortVC().build(WORDS), vecs))


WRITERS = {
    "text": lambda S, wv, p: S.write_word_vectors(wv, p),
    "binary": lambda S, wv, p: S.write_word2vec_model(wv, p, binary=True),
    "header_text": lambda S, wv, p: S.write_word2vec_model(wv, p, binary=False),
}
READERS = {
    "text": lambda S, p: S.load_txt_vectors(p),
    "binary": lambda S, p: S.load_google_model(p, binary=True),
    "header_text": lambda S, p: S.load_google_model(p, binary=False),
}


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_serializer_files_cross_read(tmp_path, fmt, gz):
    ref_wv, port_wv = _word_vectors()
    suffix = ".gz" if gz else ""
    a, b = str(tmp_path / f"ref{suffix}"), str(tmp_path / f"port{suffix}")
    WRITERS[fmt](ref_ser.WordVectorSerializer, ref_wv, a)
    WRITERS[fmt](port_ser.WordVectorSerializer, port_wv, b)
    if gz:   # gzip headers carry a file name and time: compare the content
        import gzip
        assert gzip.open(a).read() == gzip.open(b).read()
    else:
        assert open(a, "rb").read() == open(b, "rb").read()
    for path in (a, b):
        want = READERS[fmt](ref_ser.WordVectorSerializer, path)
        got = READERS[fmt](port_ser.WordVectorSerializer, path)
        assert got.vocab.index2word == want.vocab.index2word
        np.testing.assert_array_equal(got.get_word_vector_matrix(),
                                      want.get_word_vector_matrix())
        if fmt != "text":   # bitwise the vectors written
            np.testing.assert_array_equal(got.get_word_vector_matrix().view(np.uint32),
                                          port_wv.get_word_vector_matrix().view(np.uint32))


DOCS = ["the cat sat on the mat", "the dog ate my homework",
        "cats and dogs are animals", "homework is due tomorrow", "the end the end"]


@pytest.mark.parametrize("cls", ["BagOfWordsVectorizer", "TfidfVectorizer"])
@pytest.mark.parametrize("stop", [False, True])
def test_vectorizer_rows_equal(cls, stop):
    kw = {"stop_words": port_vec.ENGLISH_STOP_WORDS} if stop else {}
    ref = getattr(ref_vec, cls)(min_word_frequency=1, **kw).fit(DOCS)
    port = getattr(port_vec, cls)(min_word_frequency=1, **kw).fit(DOCS)
    assert port.vocab.index2word == ref.vocab.index2word
    for text in DOCS + ["the cat and the dog", "nothing known", ""]:
        np.testing.assert_array_equal(port.transform(text), ref.transform(text))
    ds_r, ds_p = ref.vectorize("cat cat dog", 1, 3), port.vectorize("cat cat dog", 1, 3)
    np.testing.assert_array_equal(ds_p.features, ds_r.features)
    np.testing.assert_array_equal(ds_p.labels, ds_r.labels)


@pytest.mark.parametrize("cls", ["CnnSentenceDataSetIterator", "Word2VecDataSetIterator"])
def test_text_iterators_yield_equal_datasets(cls):
    corpus = two_topic_corpus(n=14, seed=5) + ["zzz unknown", "cat"]
    data = [(s, "animal" if i % 2 == 0 else "food") for i, s in enumerate(corpus)]
    toks = [s.split() for s in corpus[:-2]]   # "zzz" and "unknown" out of vocabulary
    vecs = np.random.default_rng(1).standard_normal((10, 4)).astype(np.float32)
    ref_wv = ref_w2v.WordVectors(RefVC().build(toks), vecs)
    port_wv = port_w2v.WordVectors(PortVC().build(toks), vecs)
    from deeplearning4j_torch.data.dataset import DataSet
    for max_length in (None, 4):
        ref = getattr(ref_vec, cls)(ref_wv, data, ["animal", "food"], batch_size=5,
                                    max_length=max_length)
        port = getattr(port_vec, cls)(port_wv, data, ["animal", "food"], batch_size=5,
                                      max_length=max_length)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 4
        assert port.total_examples() == ref.total_examples() and port.batch_size() == 5
        for g, w in zip(got, want):
            assert isinstance(g, DataSet)
            for field in ("features", "labels", "features_mask", "labels_mask"):
                a, b = getattr(g, field), getattr(w, field)
                assert (a is None) == (b is None), field
                if a is not None:
                    np.testing.assert_array_equal(a, b)
        assert len(list(port)) == 4   # restartable


def _planted_graph(core, n=24, seed=8, directed=False):
    rng = np.random.default_rng(seed)
    g = core.Graph(n, directed=directed)
    half = n // 2
    for base in (0, half):
        for i in range(half):
            for j in range(i + 1, half):
                if rng.random() < 0.4:
                    g.add_edge(base + i, base + j, weight=float(rng.integers(1, 4)))
    g.add_edge(0, half)
    return g    # directed, each half's last vertex has no out-edge: a dead end


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("directed", [False, True])
def test_random_walks_identical(weighted, directed):
    walks = []
    for core in (ref_core, port_core):
        g = _planted_graph(core, directed=directed)
        g.add_edge(3, 3)
        it = core.RandomWalkIterator(g, walk_length=9, seed=4, weighted=weighted)
        walks.append((list(it), list(it)))
    assert walks[0] == walks[1]


def test_node2vec_walks_identical():
    out = []
    for core, n2v in ((ref_core, ref_n2v), (port_core, port_n2v)):
        g = _planted_graph(core)
        out.append(n2v.Node2VecWalker(g, p=0.5, q=2.0, walk_length=12, seed=1)
                   .generate(3))
    assert out[0] == out[1] and len(out[0]) == 3 * 24


def test_edge_list_file(tmp_path):
    p = tmp_path / "edges.csv"
    p.write_text("# comment\n0,1\n1,2\n\n2,5\n")
    a = ref_core.Graph.load_edge_list_file(str(p))
    b = port_core.Graph.load_edge_list_file(str(p))
    assert b.n == a.n and [b.neighbors(v) for v in range(b.n)] == \
        [a.neighbors(v) for v in range(a.n)]
    assert [b.degree(v) for v in range(b.n)] == [a.degree(v) for v in range(a.n)]


@pytest.mark.parametrize("negative", [0, 3], ids=["hs", "ns"])
def test_deepwalk_fit_matches_jax(jax_init, tmp_path, negative):
    kw = dict(vector_size=8, window_size=3, learning_rate=0.05, seed=3,
              negative=negative, batch_size=128)
    ref = ref_dw.DeepWalk(**kw).fit(_planted_graph(ref_core), walk_length=8,
                                    walks_per_vertex=2)
    port = port_dw.DeepWalk(device="cpu", **kw).fit(_planted_graph(port_core),
                                                    walk_length=8, walks_per_vertex=2)
    assert port._trainer.cache.index2word == ref._trainer.cache.index2word
    assert_tables_close(port._trainer.tables, ref._trainer.tables, FIT_TOL)
    for v in (0, 5, 13):
        assert port.verticies_nearest(v, 4) == ref.verticies_nearest(v, 4)
    ref.save(str(tmp_path / "ref.txt"))
    port.save(str(tmp_path / "port.txt"))
    a = ref_dw.DeepWalk.load_vectors(str(tmp_path / "port.txt"))
    b = port_dw.DeepWalk.load_vectors(str(tmp_path / "ref.txt"))
    assert sorted(a) == sorted(b) == list(range(24))
    np.testing.assert_allclose(a[7], b[7], rtol=1e-4, atol=1e-5)


def test_deepwalk_on_given_walks_needs_initialize():
    with pytest.raises(RuntimeError, match="initialize"):
        port_dw.DeepWalk(device="cpu").fit([[0, 1, 2]])


def test_node2vec_fit_matches_jax(jax_init):
    kw = dict(p=0.5, q=2.0, vector_size=8, window_size=3, learning_rate=0.05, seed=3,
              batch_size=128)
    ref = ref_n2v.Node2Vec(**kw).fit(_planted_graph(ref_core), walk_length=8,
                                     walks_per_vertex=2)
    port = port_n2v.Node2Vec(device="cpu", **kw).fit(_planted_graph(port_core),
                                                     walk_length=8, walks_per_vertex=2)
    assert_tables_close(port._trainer.tables, ref._trainer.tables, FIT_TOL)
    assert port.similarity(1, 2) == pytest.approx(ref.similarity(1, 2), abs=1e-4)


def test_sequence_vectors_fit_matches_jax(jax_init):
    rng = np.random.default_rng(4)
    group_a = [("item", i) for i in range(5)]
    group_b = [("user", i) for i in range(5)]
    seqs = [[(group_a if i % 2 == 0 else group_b)[j] for j in rng.integers(0, 5, 6)]
            for i in range(30)]
    kw = dict(layer_size=8, window_size=3, negative=3, use_hierarchic_softmax=False,
              epochs=2, learning_rate=0.1, batch_size=64, seed=3)
    ref = RefSV(**kw).fit(seqs)
    port = PortSV(device="cpu", **kw).fit(seqs)
    assert port._keys == ref._keys
    assert_tables_close(port._trainer.tables, ref._trainer.tables, FIT_TOL)
    np.testing.assert_allclose(port.element_vector(("user", 3)),
                               ref.element_vector(("user", 3)), rtol=0,
                               atol=FIT_TOL * float(np.abs(ref._vectors).max()))
    assert port.element_vector(("nobody", 0)) is None
