"""The device-corpus engine on a mesh that spans processes: two gloo ranks
in threads.

The JAX package's ShardedWord2Vec shards the position axis over a mesh that
may span hosts. The port's runs each rank's shards, all-reduces the touch
counts and all-gathers the shards' (rows, contributions) in mesh order
before the segment sum, so every rank applies the one-process update:
- two ranks over meshes of 2 and 4 CPU shards (the owners in blocks or
  interleaved) end with the one-process mesh's tables and losses, bitwise,
  after 2 epochs of 2-chunk calls (the counts are sums of whole numbers,
  exact in any order; everything else is summed in mesh order);
- fed the JAX package's draws, two ranks end within 1e-5 of max|table| of
  the JAX package's engine on a 2-device mesh of the conftest's virtual CPU
  devices (tests/test_torch_sharded_word2vec.py's TOL);
- a mesh that spans processes without a group, or that gives the ranks
  unequal shares of positions, is refused.
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_torch.nlp import distributed as port_dist
from deeplearning4j_torch.nlp.vocab import VocabCache as PortVocabCache
from deeplearning4j_torch.nn import shards
from deeplearning4j_torch.parallel.mesh import create_mesh, data_parallel_mesh
from deeplearning4j_tpu.nlp import distributed as ref_dist
from deeplearning4j_tpu.parallel.mesh import data_parallel_mesh as ref_mesh

from test_torch_multihost import two_ranks_in_threads
from test_torch_sharded_word2vec import (MESH_KW, TOL, cluster_corpus, feed_jax_draws,
                                         twins)
from test_torch_word2vec import assert_tables_close, one_torch_thread  # noqa: F401

OWNERS = {"2_shards": [0, 1], "4_shards_blocked": [0, 0, 1, 1],
          "4_shards_interleaved": [0, 1, 0, 1]}


def corpus():
    cache, idx = cluster_corpus(PortVocabCache, n_sent=200, seed=1)
    return (cache,) + port_dist.corpus_arrays(idx)


@pytest.mark.parametrize("owners", sorted(OWNERS))
def test_two_ranks_equal_the_one_process_mesh_bitwise(owners):
    owners = OWNERS[owners]
    cache, toks, sids = corpus()
    devices = ["cpu"] * len(owners)
    one = port_dist.ShardedWord2Vec(cache, mesh=data_parallel_mesh(devices=devices),
                                    **MESH_KW).fit_corpus(toks, sids, epochs=2)
    shards.cross_ms["word2vec"] = 0.0

    def rank(r, pg):
        mesh = create_mesh(devices=devices, processes=owners)
        tr = port_dist.ShardedWord2Vec(cache, mesh=mesh, process_group=pg, **MESH_KW)
        assert tr._positions == [i for i, p in enumerate(owners) if p == r]
        return tr.fit_corpus(toks, sids, epochs=2)

    for tr in two_ranks_in_threads(rank):
        for name in ("syn0", "syn1neg"):
            assert torch.equal(tr.tables[name], one.tables[name]), name
        assert torch.equal(tr.last_losses, one.last_losses)
    assert shards.cross_ms["word2vec"] > 0


def test_two_ranks_on_jax_draws_match_jax():
    """Three chunks of one call over a 2-device mesh in each package, the
    port's ranks fed the JAX package's draws."""
    ref, port, (toks, sids) = twins(chunk=160, steps_per_call=3)
    kw = dict(layer_size=8, window=3, negative=4, learning_rate=0.1, seed=11,
              chunk=160, steps_per_call=3)
    ref = ref_dist.ShardedWord2Vec(ref.cache, mesh=ref_mesh(2, jax.devices()[:2]), **kw)
    tables = {k: v.clone() for k, v in port.tables.items()}
    ref.tables = {k: jax.numpy.asarray(v.numpy()) for k, v in tables.items()}
    key = ref._key
    ref.fit_corpus(toks, sids, epochs=1)

    def rank(r, pg):
        mesh = create_mesh(devices=["cpu", "cpu"], processes=[0, 1])
        tr = port_dist.ShardedWord2Vec(port.cache, mesh=mesh, process_group=pg,
                                       device="cpu", **kw)
        tr.tables = tables
        feed_jax_draws(tr, key, 3)
        return tr.fit_corpus(toks, sids, epochs=1)

    for tr in two_ranks_in_threads(rank):
        assert_tables_close(tr.tables, ref.tables, TOL)
        np.testing.assert_allclose(tr.last_losses.numpy(), np.asarray(ref.last_losses),
                                   rtol=1e-5)


def test_a_mesh_across_processes_needs_a_group():
    cache, _, _ = corpus()
    mesh = create_mesh(devices=["cpu", "cpu"], processes=[0, 1])
    with pytest.raises(ValueError, match="span processes"):
        port_dist.ShardedWord2Vec(cache, chunk=64, mesh=mesh)


def test_unequal_shares_of_positions_are_refused():
    cache, _, _ = corpus()

    def rank(r, pg):
        mesh = create_mesh(devices=["cpu"] * 3, processes=[0, 0, 1])
        with pytest.raises(ValueError, match="same number of mesh positions"):
            port_dist.ShardedWord2Vec(cache, chunk=66, mesh=mesh, process_group=pg)
        pg.allreduce([torch.zeros(1)]).wait()   # no rank leaves before both are up
        return True

    assert two_ranks_in_threads(rank) == [True, True]
