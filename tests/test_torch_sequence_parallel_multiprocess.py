"""Sequence-parallel inference across processes: two gloo ranks in threads.

The JAX package's SequenceParallelWrapper answers `output`/`outputs` on a
mesh that spans hosts (its multi-host worker runs SP over a 2x2 global
device set, tests/multihost_worker.py). Here two threads, each a rank of
its own gloo group, run the port's wrapper on a mesh of four CPU shards,
two a rank: a 1 x 4 (data x seq) mesh, whose ring crosses the ranks and
whose output blocks are cut in time, and a 2 x 2 mesh, whose row blocks
are the ranks'. Each rank's answer, with a features mask that zeroes the
last quarter of the steps, is held against the JAX wrapper's `output` on
the conftest's virtual CPU devices and against the port's one-process SP
output, at rtol 1e-4, atol 1e-5 (tests/test_torch_sequence_parallel.py);
the two ranks return the same whole output, bitwise.
"""
import copy

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import SequenceParallelWrapper as RefSP
from deeplearning4j_tpu.parallel import seq_parallel_mesh as ref_mesh
import deeplearning4j_torch as port
from deeplearning4j_torch.nn import shards
from deeplearning4j_torch.parallel import SequenceParallelWrapper
from deeplearning4j_torch.parallel import mesh as port_mesh

from test_torch_multihost import two_ranks_in_threads
from test_torch_parallel_wrapper import twins
from test_torch_sequence_parallel import conf, cpu_mesh, data, graph_conf
from test_torch_word2vec import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)
MESHES = {"seq4": [1, 4], "data2_seq2": [2, 2]}


def masked_batch(seed):
    x, _ = data(seed=seed)
    fmask = np.ones((8, 16), np.float32)
    fmask[:, 12:] = 0.0
    return x, fmask


def across_ranks(net, shape, answer):
    """`answer(wrapper)` on each of two ranks, each with its own copy of
    `net` and a wrapper over ["cpu"] * 4 owned [0, 0, 1, 1]."""
    for k in shards.cross_ms:
        shards.cross_ms[k] = 0.0

    def rank(r, pg):
        mesh = port_mesh.create_mesh(shape, ("data", "seq"), ["cpu"] * 4, [0, 0, 1, 1])
        return answer(SequenceParallelWrapper(copy.deepcopy(net), mesh,
                                              process_group=pg))

    got = two_ranks_in_threads(rank)
    assert shards.cross_ms["output"] > 0
    return got


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_output_across_ranks(mesh):
    x, fmask = masked_batch(seed=5)
    r, p = twins(lambda pkg: conf(pkg, causal=True))
    shape = MESHES[mesh]
    want = RefSP(r, ref_mesh(data_devices=shape[0])).output(x, features_mask=fmask)
    one = SequenceParallelWrapper(p, cpu_mesh(data_devices=shape[0])).output(
        x, features_mask=fmask)
    got = across_ranks(p, shape, lambda w: w.output(x, features_mask=fmask))
    np.testing.assert_array_equal(got[0], got[1])
    for g in got:
        assert g.shape == (8, 16, 3)
        np.testing.assert_allclose(g, want, **TOL)
        np.testing.assert_allclose(g, one, **TOL)


def test_graph_outputs_across_ranks():
    x, fmask = masked_batch(seed=15)
    r, p = twins(lambda pkg: graph_conf(pkg, seed=21), graph=True)
    want = RefSP(r, ref_mesh()).outputs(x, features_masks=[fmask])
    one = SequenceParallelWrapper(p, cpu_mesh()).outputs(x, features_masks=[fmask])
    got = across_ranks(p, [1, 4], lambda w: w.outputs(x, features_masks=[fmask]))
    for outs in got:
        assert len(outs) == len(want) == 1
        np.testing.assert_allclose(outs[0], want[0], **TOL)
        np.testing.assert_allclose(outs[0], one[0], **TOL)
    np.testing.assert_array_equal(got[0][0], got[1][0])


def test_three_d_across_processes_is_still_refused():
    net = port.MultiLayerNetwork(conf(port)).init(device="cpu")

    def rank(r, pg):
        mesh = port_mesh.create_mesh([1, 2, 2], ("data", "model", "seq"), ["cpu"] * 4,
                                     [0, 0, 1, 1])
        with pytest.raises(NotImplementedError, match="3-D"):
            SequenceParallelWrapper(net, mesh, process_group=pg)
        pg.allreduce([torch.zeros(1)]).wait()   # no rank leaves before both are up
        return True

    assert two_ranks_in_threads(rank) == [True, True]
