"""Quantized serving with the torch port, on the CPU: zoo AlexNet at 60x60x3
and 10 classes (as tests/test_torch_mln.py builds it) with its tree
quantized to int8 (dense layers int8, conv kernels bfloat16) or bf16.

- Layer by layer and at the output, the port agrees with the JAX package's
  eager forward (`feed_forward`) of the same quantized tree to float32
  rounding: both round each bfloat16 conv output, quantize each dense input
  per row the same way and sum int8 products exactly.
- The JAX package's jitted `output` differs from its own eager forward:
  XLA's CPU compiler runs the bfloat16 conv in float32 and drops the
  rounding of its output to bfloat16 (a convert pair it removes). On this
  net that moves the softmax outputs (0.03-0.3) by up to 6.4e-4; the port
  is held to `output` at atol 2e-3 and to the eager forward tightly.
- ParallelInference's answers for the int8 net are the rows of its direct
  `output`, and every dense layer of every executed forward went through
  the int8 product.
- quantize_tree leaves the training tree as it was.
"""
import threading

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_torch import quantize as port_q
from deeplearning4j_torch.models import zoo as port_zoo
from deeplearning4j_torch.ops import quant_matmul as port_qmm
from deeplearning4j_torch.parallel import inference as pinf
from deeplearning4j_tpu import quantize as ref_q
from deeplearning4j_tpu.models import zoo as ref_zoo
from deeplearning4j_tpu.ops import pallas_kernels
from test_torch_mln import _images, _pair


@pytest.fixture(scope="module")
def nets():
    port_net = port_zoo.AlexNet(input_shape=(60, 60, 3), num_labels=10).init(device="cpu")
    ref_net = _pair(ref_zoo.AlexNet(input_shape=(60, 60, 3), num_labels=10).conf(),
                    port_net)
    return port_net, ref_net


@pytest.fixture
def xla_arm(monkeypatch):
    """Pin the JAX package's int8 dispatch to its XLA arm (its native arm is
    broken on this tree, ROADMAP Queue C)."""
    monkeypatch.setitem(pallas_kernels._quant_impl, jax.default_backend(), "xla")


# Relative tolerance of each activation: float32 rounding for int8 trees;
# for bf16 trees one bfloat16 ulp (2^-7 of the value at most), since a dense
# layer's bfloat16 product is rounded to bfloat16 after a float32 sum whose
# order differs between the two packages, and a few of its 16384 outputs
# round to the other neighbour.
LAYER_RTOL = {"int8": 1e-5, "bf16": 2.0 ** -7}


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_alexnet_matches_reference(nets, xla_arm, mode):
    port_net, ref_net = nets
    port_tree, ref_tree = port_net.params_tree, ref_net.params_tree
    x = _images((4, 60, 60, 3))
    try:
        port_net.params_tree = port_q.quantize_tree(port_tree, mode)
        ref_net.params_tree = ref_q.quantize_tree(ref_tree, mode)
        got = port_net.feed_forward(x)
        want = ref_net.feed_forward(x)
        out = port_net.output(x)
        jitted = ref_net.output(x)
    finally:
        port_net.params_tree, ref_net.params_tree = port_tree, ref_tree
    assert len(got) == len(want) == 14
    for i, (g, w) in enumerate(zip(got, want)):
        # every activation float32: the bfloat16 convs return it, so the
        # LRNs after them take float32 (K1 on the card)
        assert g.dtype == np.float32 and g.shape == w.shape, i
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=LAYER_RTOL[mode], atol=2e-5 * scale,
                                   err_msg=f"layer {i}")
    np.testing.assert_array_equal(out, got[-1])
    np.testing.assert_allclose(out, want[-1], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(out, jitted, atol=2e-3)


def test_parallel_inference_serves_the_int8_net(nets, monkeypatch):
    net = nets[0]
    tree = net.params_tree
    calls = []
    plain = port_qmm.quant_matmul
    monkeypatch.setattr(port_qmm, "quant_matmul",
                        lambda x, w: calls.append(x.shape[0]) or plain(x, w))
    rng = np.random.default_rng(3)
    reqs = [[rng.standard_normal((int(rng.integers(1, 4)), 60, 60, 3)).astype(np.float32)
             for _ in range(4)] for _ in range(4)]
    got, errors = {}, []

    def client(c):
        try:
            for j, x in enumerate(reqs[c]):
                got[(c, j)] = pi.output(x)
        except BaseException as e:  # surfaced by the assert below
            errors.append(e)

    try:
        net.params_tree = port_q.quantize_tree(tree, "int8")
        pi = pinf.ParallelInference(net, inference_mode=pinf.InferenceMode.BATCHED,
                                    batch_limit=8)
        with pi:
            threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
            forwards = pi.total_forwards
        assert not errors, errors
        assert forwards >= 1 and len(calls) == 3 * forwards
        for (c, j), out in got.items():
            # per-row activation scales: a row's codes do not depend on the
            # batch it was served in, up to the float32 conv's sum order
            np.testing.assert_allclose(out, net.output(reqs[c][j]), rtol=1e-5,
                                       atol=1e-7)
    finally:
        net.params_tree = tree


def test_quantize_tree_leaves_the_training_tree_unchanged(nets):
    net = nets[0]
    before = [(k, t.dtype, t.clone()) for layer in net.params_tree
              for k, t in layer.items()]
    for spec in ("int8", port_q.QuantSpec("int8", zero_point=True), "bf16"):
        q = port_q.quantize_tree(net.params_tree, spec)
        assert port_q.tree_precision(q) == port_q.QuantSpec.coerce(spec).mode
    after = [(k, t) for layer in net.params_tree for k, t in layer.items()]
    assert port_q.tree_precision(net.params_tree) == "fp32"
    for (k, dtype, old), (k2, new) in zip(before, after):
        assert k == k2 and new.dtype == dtype and torch.equal(new, old), k
