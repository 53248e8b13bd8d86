"""AlexNet in bfloat16 with the torch port, on the CPU, against the JAX
package: the network of bench.py's AlexNet arms
(`AlexNet(num_labels=1000).init(dtype=jnp.bfloat16)`) cut to 60x60x3 and
10 labels (as tests/test_torch_mln.py cuts it), with the same bfloat16
parameters in both packages (the port's draws carried with
`params_to_numpy` and cast to `jnp.bfloat16`) and the same bfloat16 images.

- Layer by layer (`feed_forward`) and at the output, the port agrees with
  the JAX package's eager forward to 1e-2 of each layer's largest value
  (measured: at most 1.8e-3, at fc7, where a bfloat16 product summed in
  another order rounds a few values to the other neighbour; 3.7e-9 at the
  softmax). numpy has no bfloat16, so the port hands bfloat16 activations
  back as float32, which holds them exactly.
- `output` is also held to the JAX package's jitted `output` at 1e-2 of
  max|ref| (measured 1.7e-3): XLA's CPU compiler drops the bfloat16
  rounding of the conv outputs there (ROADMAP Queue C).
- The score of `compute_gradient_and_score` within rtol 1e-2 of the JAX
  package's `score` on the same rows (measured 4.6e-4). Whole-net
  gradients are not compared: bfloat16 rounding through ReLU and max-pool
  decisions moves conv1's by up to 20% relative norm between the two
  packages; tests/test_torch_lrn.py holds the LRN backward itself.
- Every LRN takes a contiguous bfloat16 tensor, forward and backward (K1
  and K2 on the card); `fit` keeps the parameters bfloat16; ParallelInference
  serves the net with float32 answers, as `output` gives them.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.data.dataset import DataSet
from deeplearning4j_torch.models import zoo as port_zoo
from deeplearning4j_torch.ops import lrn as port_lrn
from deeplearning4j_torch.parallel import inference as pinf
from deeplearning4j_torch.utils import params as port_params
from deeplearning4j_tpu.data.dataset import DataSet as RefDataSet
from deeplearning4j_tpu.models import zoo as ref_zoo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as RefNetwork

REL = 1e-2   # of the largest reference value: bfloat16 roundings summed in another order


@pytest.fixture(scope="module")
def nets():
    port_net = port_zoo.AlexNet(input_shape=(60, 60, 3), num_labels=10).init(
        dtype=torch.bfloat16, device="cpu")
    ref_net = RefNetwork(ref_zoo.AlexNet(input_shape=(60, 60, 3), num_labels=10).conf())
    ref_net.init(dtype=jnp.bfloat16)
    ref_net.params_tree = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16),
        port_params.params_to_numpy(port_net.params_tree))
    return port_net, ref_net


def _data(seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 60, 60, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 2)]
    return x, y


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_bf16_alexnet_layers_match_eager_reference(nets):
    port_net, ref_net = nets
    x, _ = _data()
    got = port_net.feed_forward(x)
    want = ref_net.feed_forward(jnp.asarray(x, jnp.bfloat16))
    assert len(got) == len(want) == 14
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.float32 and g.shape == w.shape, i
        assert _rel(g, w) <= REL, (i, _rel(g, w))
    # conv and LRN activations are bfloat16 in both packages, the dense
    # layers' float32 (matmul_any's float32 epilogue)
    assert [str(np.asarray(w).dtype) for w in want[1:3]] == ["bfloat16"] * 2
    assert all(np.array_equal(g, g.astype(jnp.bfloat16).astype(np.float32))
               for g in got[:11])


def test_bf16_alexnet_output_matches_reference(nets):
    port_net, ref_net = nets
    x, _ = _data()
    got = port_net.output(x)
    assert got.dtype == np.float32 and got.shape == (2, 10)
    eager = ref_net.feed_forward(jnp.asarray(x, jnp.bfloat16))[-1]
    assert _rel(got, eager) <= REL
    assert _rel(got, ref_net.output(jnp.asarray(x, jnp.bfloat16))) <= REL


def test_bf16_alexnet_score_matches_reference(nets):
    port_net, ref_net = nets
    x, y = _data(6)
    grads, score = port_net.compute_gradient_and_score(DataSet(x, y))
    want = float(ref_net.score(RefDataSet(x, y)))
    np.testing.assert_allclose(score, want, rtol=REL)
    for lg, lp in zip(grads, port_net.params_tree):
        for k, g in lg.items():
            assert g.dtype == lp[k].dtype == torch.bfloat16, k
            assert torch.isfinite(g.float()).all(), k


def test_bf16_alexnet_lrn_takes_contiguous_bfloat16(nets, monkeypatch):
    """Each LRN's input and cotangent reach the LRN function as contiguous
    bfloat16 NHWC tensors (what K1 and K2 take on the card), and `fit`
    keeps the parameters bfloat16 and moves them."""
    port_net, _ = nets
    seen = []
    fwd, bwd = port_lrn.lrn_fwd, port_lrn.lrn_bwd

    def lrn_fwd(x, *a):
        seen.append(("fwd", x.dtype, x.is_contiguous(), x.shape[-1]))
        return fwd(x, *a)

    def lrn_bwd(x, g, *a):
        seen.append(("bwd", g.dtype, x.is_contiguous(), x.shape[-1]))
        return bwd(x, g, *a)

    monkeypatch.setattr(port_lrn, "lrn_fwd", lrn_fwd)
    monkeypatch.setattr(port_lrn, "lrn_bwd", lrn_bwd)
    x, y = _data(7)
    before = port_net.params_tree
    try:
        port_net.fit(x, y, batch_size=2)
        after = port_net.params_tree
    finally:
        port_net.params_tree = before
    assert sorted(seen) == sorted(
        [(d, torch.bfloat16, True, c) for d in ("fwd", "bwd") for c in (64, 192)])
    assert np.isfinite(float(port_net.score_value))
    assert all(a[k].dtype == torch.bfloat16 for a in after for k in a)
    assert any(not torch.equal(a[k], b[k]) for a, b in zip(after, before) for k in a)


def test_parallel_inference_serves_the_bf16_net(nets):
    """BATCHED serving of the bfloat16 net: float32 answers, each within
    one bfloat16 ulp-share (rtol 2e-3, README) of `output` on its own rows,
    which a batch of other size can round differently."""
    net, _ = nets
    rng = np.random.default_rng(8)
    reqs = [[rng.standard_normal((int(rng.integers(1, 4)), 60, 60, 3)).astype(np.float32)
             for _ in range(3)] for _ in range(3)]
    got, errors = {}, []

    def client(c):
        try:
            for j, x in enumerate(reqs[c]):
                got[(c, j)] = pi.output(x)
        except BaseException as e:  # surfaced by the assert below
            errors.append(e)

    pi = pinf.ParallelInference(net, inference_mode=pinf.InferenceMode.BATCHED,
                                batch_limit=8)
    with pi:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    assert not errors, errors
    for (c, j), out in got.items():
        assert out.dtype == np.float32 and out.shape == (reqs[c][j].shape[0], 10)
        np.testing.assert_allclose(out, net.output(reqs[c][j]), rtol=2e-3, atol=1e-6)
