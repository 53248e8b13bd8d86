"""chip_smoke.py's word and graph embedding phases (`phase_word2vec_device_corpus`,
`phase_word2vec_builder`, `phase_doc_and_graph_embeddings`) on the CPU at
toy sizes: small Zipf vocabularies and corpora, small graphs, no profiler.
The card-against-CPU holds compare the CPU with itself here; the holds
against the phases' dense float64 references are what these tests can see
fail:

- the device-corpus chunk and the builder's batch fail with the touch-count
  division dropped;
- the builder's batch fails with the HS skip window removed;
- the two-shard check fails when a shard divides by its own touch counts.
"""
import pytest
import torch

import chip_smoke
from deeplearning4j_torch.nlp import distributed as port_dist
from deeplearning4j_torch.nlp import embeddings as port_emb

from test_torch_word2vec import one_torch_thread  # noqa: F401

# lr 0.1 on the two-shard run: at 0.025 and this size a shard counting
# alone stays inside the tolerance (tests/test_torch_sharded_word2vec.py)
DC_SMALL = dict(vocab=2000, sentences=120, sent_len=40, layer=16, chunk=512, steps=4,
                shard_vocab=500, shard_sentences=100, shard_lr=0.1, profile=False)
BUILDER_SMALL = dict(vocab=2000, sentences=120, profile=False)
# The graphs of 200 vertices train 6 (DeepWalk) and 5 (Node2Vec) epochs: at
# this size one epoch leaves a vertex's nearest neighbours about 16% in its
# community, and Node2Vec's 3 about 60%
DOC_GRAPH_SMALL = dict(glove_topics=4, glove_words=10, glove_sentences=600,
                       glove_epochs=10, dw_vertices=200, dw_community=50, dw_epochs=6,
                       n2v_vertices=200, n2v_community=50, n2v_epochs=5)


def test_device_corpus_phase_passes():
    r = chip_smoke.phase_word2vec_device_corpus(torch, "cpu", device="cpu", size=DC_SMALL)
    assert r["hold"]["chunk_moved_rel"] > 0
    assert max(r["hold"]["card_vs_dense"].values()) <= chip_smoke.W2V_HOLD_REL
    assert r["two_shards"]["shards"] == 2 and r["planted_separation"] > 0.3
    assert r["tables_bytes"] == 2 * r["vocab_size"] * 16 * 4


def test_device_corpus_hold_fails_without_the_count_division(monkeypatch):
    monkeypatch.setattr(port_dist, "meet_counts", lambda parts, group=None: [
        {k: torch.zeros_like(p[k]) for k in ("syn0_counts", "syn1_counts")}
        for p in parts])
    with pytest.raises(RuntimeError, match="one chunk off by"):
        chip_smoke.phase_word2vec_device_corpus(torch, "cpu", device="cpu", size=DC_SMALL)


def test_two_shard_check_fails_when_a_shard_counts_alone(monkeypatch):
    monkeypatch.setattr(port_dist, "meet_counts", lambda parts, group=None: [
        {k: p[k] for k in ("syn0_counts", "syn1_counts")} for p in parts])
    with pytest.raises(RuntimeError, match="two shards"):
        chip_smoke.phase_word2vec_device_corpus(torch, "cpu", device="cpu", size=DC_SMALL)


def test_builder_phase_passes():
    r = chip_smoke.phase_word2vec_builder(torch, "cpu", device="cpu", size=BUILDER_SMALL)
    assert 0 < r["hold"]["syn1_scaled"]["hs_bits_skipped_share"] < 1
    assert r["steps"]["_hs_step"] == r["steps"]["_ns_step"] > 0
    assert all(r["round_trips_bitwise"].values())


def test_skip_window_scale_keeps_every_score_off_the_edge():
    """Scores whose median is a tie (a pair seen twice in a batch, or two
    bits within a rounding of each other): 6 / median puts both on the
    |score| < 6 window's edge; the scale used puts every score at least half
    the widest gap near the median from it, and about half outside."""
    gen = torch.Generator().manual_seed(20)
    score = torch.rand(1001, generator=gen) * 4 + 0.5
    score[500:502] = score.median()   # the median twice
    assert ((score * (6.0 / float(score.median())) - 6).abs() < 1e-6).sum() >= 2
    scaled = score.double() * chip_smoke.skip_window_scale(score)
    assert ((scaled - 6).abs() / 6).min() > 1e-5
    assert 0.4 < (scaled >= 6).double().mean() < 0.6


def test_builder_hold_fails_without_the_count_division(monkeypatch):
    monkeypatch.setattr(port_emb, "row_counts",
                        lambda n, idx, w=None: torch.zeros(n, device=idx.device))
    with pytest.raises(RuntimeError, match="one HS \\+ NS batch off by"):
        chip_smoke.phase_word2vec_builder(torch, "cpu", device="cpu", size=BUILDER_SMALL)


def test_builder_hold_fails_without_the_skip_window(monkeypatch):
    monkeypatch.setattr(port_emb, "MAX_EXP", float("inf"))
    with pytest.raises(RuntimeError, match="one HS \\+ NS batch off by"):
        chip_smoke.phase_word2vec_builder(torch, "cpu", device="cpu", size=BUILDER_SMALL)


def test_doc_and_graph_phase_passes():
    r = chip_smoke.phase_doc_and_graph_embeddings(torch, "cpu", device="cpu",
                                                  size=DOC_GRAPH_SMALL)
    assert r["pv_dbow"]["purity"] >= 8 and r["pv_dm"]["purity"] >= 8
    assert r["pv_dbow"]["infer"]["card_vs_cpu"] == 0.0   # the CPU against itself
    assert r["pv_dm"]["steps"]["_dm_ns_step"] > 0
    assert r["glove"]["nearest_same_topic_share"] >= 0.75
    for label in ("deepwalk", "node2vec"):
        assert r[label]["same_minus_cross"] > 0 and r[label]["steps"]["_hs_step"] > 0
