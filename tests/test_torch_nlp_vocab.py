"""The port's host side of nlp/ (deeplearning4j_torch.nlp: tokenization,
sentence iterators, vocab, Huffman tree, unigram table, pair generation)
against the JAX package's. All of it is host code made by the same numpy
calls, so every comparison here is EXACT: equal tokens, equal word order,
equal codes and points, equal tables and equal pairs from the same seed
(with the generator's state equal afterwards)."""
import numpy as np
import pytest

from deeplearning4j_torch.nlp import embeddings as port_emb
from deeplearning4j_torch.nlp import sentence_iterator as port_it
from deeplearning4j_torch.nlp import tokenization as port_tok
from deeplearning4j_torch.nlp import vocab as port_vocab
from deeplearning4j_tpu.nlp import embeddings as ref_emb
from deeplearning4j_tpu.nlp import sentence_iterator as ref_it
from deeplearning4j_tpu.nlp import tokenization as ref_tok
from deeplearning4j_tpu.nlp import vocab as ref_vocab

TEXTS = ["The cat's toys (3) are: GONE!", "running quickly, jumped & played",
         "a b c d e f g", "  spaced   out\ttabs\nnewline ", "", "x",
         "Ünïcode wörds 和 汉字 mixed", "the the the end."]


def zipf_sentences(n=80, vocab=40, seed=0, lo=1, hi=12):
    """Integer-token sentences with Zipf-like counts and many count ties."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [[f"w{t}" for t in rng.choice(vocab, size=rng.integers(lo, hi), p=p)]
            for _ in range(n)]


def _factories(mod):
    return {
        "default": mod.DefaultTokenizerFactory(),
        "common": mod.DefaultTokenizerFactory().set_token_pre_processor(
            mod.CommonPreprocessor()),
        "lower": mod.DefaultTokenizerFactory().set_token_pre_processor(
            mod.LowCasePreProcessor()),
        "ending": mod.DefaultTokenizerFactory().set_token_pre_processor(
            mod.EndingPreProcessor()),
        "ngram": mod.NGramTokenizerFactory(mod.DefaultTokenizerFactory(), 1, 3),
        "char": mod.CharacterTokenizerFactory(),
        "char_ws": mod.CharacterTokenizerFactory(keep_whitespace=True),
        "regex": mod.RegexTokenizerFactory(),
        "regex_digits": mod.RegexTokenizerFactory(r"\d+|[a-z]+"),
    }


@pytest.mark.parametrize("name", sorted(_factories(ref_tok)))
def test_tokenizers_equal(name):
    ref, port = _factories(ref_tok)[name], _factories(port_tok)[name]
    for text in TEXTS:
        assert port.create(text).get_tokens() == ref.create(text).get_tokens(), text


def test_stop_words_equal():
    assert port_tok.STOP_WORDS == ref_tok.STOP_WORDS


def test_collection_iterator_with_pre_processor():
    ref = ref_it.CollectionSentenceIterator(TEXTS)
    port = port_it.CollectionSentenceIterator(TEXTS)
    ref.pre_processor = port.pre_processor = str.upper
    assert list(port) == list(ref)
    assert list(port) == list(ref)   # restartable


def test_file_iterators(tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "b.txt").write_text("\n".join(TEXTS))
    (tmp_path / "sub" / "a.txt").write_text("one\n\n two \nthree")
    path = str(tmp_path / "b.txt")
    assert list(port_it.BasicLineIterator(path)) == list(ref_it.BasicLineIterator(path))
    assert (list(port_it.FileSentenceIterator(str(tmp_path)))
            == list(ref_it.FileSentenceIterator(str(tmp_path))))


def test_labels_source_and_label_aware_iterator():
    ref, port = ref_it.LabelsSource("D%d"), port_it.LabelsSource("D%d")
    for src in (ref, port):
        src.next_label()
        src.store_label("x")
        src.store_label("x")
        src.next_label()
    assert port.labels == ref.labels
    docs = [("a b", ["l1"]), ("c", ["l2", "l3"])]
    got = [(d.content, d.labels) for d in port_it.SimpleLabelAwareIterator(
        [port_it.LabelledDocument(c, lb) for c, lb in docs])]
    want = [(d.content, d.labels) for d in ref_it.SimpleLabelAwareIterator(
        [ref_it.LabelledDocument(c, lb) for c, lb in docs])]
    assert got == want


def _caches(sentences, min_freq=1, huffman=True):
    return (ref_vocab.VocabConstructor(min_freq, huffman).build(sentences),
            port_vocab.VocabConstructor(min_freq, huffman).build(sentences))


@pytest.mark.parametrize("min_freq", [1, 2, 5])
def test_vocab_order_counts_and_huffman(min_freq):
    ref, port = _caches(zipf_sentences(), min_freq)
    assert port.index2word == ref.index2word
    assert port.total_word_count == ref.total_word_count
    for w in ref.index2word:
        a, b = ref.words[w], port.words[w]
        assert (b.count, b.index, b.code, b.points) == (a.count, a.index, a.code,
                                                         a.points), w
    assert port.index_of("nope") == ref.index_of("nope") == -1


def test_huffman_ties():
    """Every count tied: the heap's (count, id) order decides the whole tree."""
    sents = [[f"t{i}" for i in range(13)] for _ in range(3)]
    ref, port = _caches(sents)
    assert [port.words[w].code for w in port.index2word] == \
        [ref.words[w].code for w in ref.index2word]
    assert [port.words[w].points for w in port.index2word] == \
        [ref.words[w].points for w in ref.index2word]
    codes_r, points_r = ref_emb.codes_points_arrays(ref)
    codes_p, points_p = port_emb.codes_points_arrays(port)
    np.testing.assert_array_equal(codes_p, codes_r)
    np.testing.assert_array_equal(points_p, points_r)


@pytest.mark.parametrize("table_size,power", [(1 << 20, 0.75), (1000, 0.5)])
def test_unigram_table_equal(table_size, power):
    ref, port = _caches(zipf_sentences(seed=3))
    np.testing.assert_array_equal(
        port_vocab.unigram_table(port, table_size, power),
        ref_vocab.unigram_table(ref, table_size, power))


def _indexed(seed=1):
    sents = zipf_sentences(seed=seed)
    ref, port = _caches(sents)
    a = ref_emb.sentences_to_indices(sents, ref)
    b = port_emb.sentences_to_indices(sents, port)
    assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    return ref, port, b


@pytest.mark.parametrize("window,sampling", [(1, 0.0), (3, 0.0), (5, 1e-2)])
def test_generate_pairs_equal(window, sampling):
    ref, port, idx = _indexed()
    r_rng, p_rng = np.random.default_rng(9), np.random.default_rng(9)
    want = ref_emb.generate_pairs(idx, window, r_rng, ref, sampling)
    got = port_emb.generate_pairs(idx, window, p_rng, port, sampling)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert p_rng.random() == r_rng.random()   # the same draws consumed


@pytest.mark.parametrize("window,sampling", [(2, 0.0), (4, 1e-2)])
def test_generate_cbow_equal(window, sampling):
    ref, port, idx = _indexed(seed=2)
    r_rng, p_rng = np.random.default_rng(4), np.random.default_rng(4)
    want = ref_emb.generate_cbow(idx, window, r_rng, ref, sampling)
    got = port_emb.generate_cbow(idx, window, p_rng, port, sampling)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.shape == b.shape and a.dtype == b.dtype
    assert p_rng.random() == r_rng.random()


def test_pair_generation_of_nothing():
    rng = np.random.default_rng(0)
    for fn in ("generate_pairs", "generate_cbow"):
        got = getattr(port_emb, fn)([np.array([3], np.int32)], 2, rng)
        want = getattr(ref_emb, fn)([np.array([3], np.int32)], 2, rng)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype
