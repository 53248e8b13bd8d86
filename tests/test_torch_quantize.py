"""The torch port's quantization (deeplearning4j_torch/quantize, ops/quant_matmul)
against the JAX package's, on the CPU.

- The int8 product's plain version is bitwise the JAX package's XLA arm and
  its Pallas kernel in interpret mode at the JAX test shapes, and exact at
  the extremes (K 4096 of -128 and 127).
- quantize_tree, dequantize_tree, sidecar_scales and tree_precision give the
  JAX package's trees bit for bit (int8 with and without zero points, bf16,
  and int8 mode's bf16 routing of conv and attention leaves), and raise the
  same typed errors on re-quantization.
- dense_qforward and embedding_qlookup give the JAX package's values bit
  for bit: both run the same float32 operations in the same order, each
  correctly rounded.
- params_from_numpy/params_to_numpy carry quantized trees both ways bitwise.

The JAX package picks its int8 arm by a timed probe; its native arm is
broken on this tree (ROADMAP Queue C), so every oracle call here pins the
XLA arm. The kernel K6 itself runs only on a GPU: the tests marked `cuda`
skip here.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deeplearning4j_torch import quantize as port_q
from deeplearning4j_torch.nn.layers import core as port_core
from deeplearning4j_torch.ops import quant_matmul as port_qmm
from deeplearning4j_torch.utils import params as port_params

# tests/test_quantize.py SHAPES: (B, K, N) around the TPU tiles
SHAPES = [(1, 1, 1), (3, 5, 7), (8, 64, 16), (7, 127, 13),
          (8, 128, 256), (9, 130, 33), (32, 256, 10), (5, 1024, 8)]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's side, imported here and not at the top, so that the
    `cuda` tests also run on a machine without JAX."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from deeplearning4j_tpu import quantize
    from deeplearning4j_tpu.nn.layers import core
    from deeplearning4j_tpu.ops import pallas_kernels
    return SimpleNamespace(jax=jax, jnp=jnp, q=quantize, core=core, pk=pallas_kernels)


@pytest.fixture
def xla_arm(ref, monkeypatch):
    """Pin the JAX package's int8 dispatch to its XLA arm."""
    monkeypatch.setitem(ref.pk._quant_impl, ref.jax.default_backend(), "xla")


def _int8(shape, seed):
    return np.random.default_rng(seed).integers(-128, 128, shape, dtype=np.int8)


def _f32(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


# --------------------------------------------------------------- int8 product
@pytest.mark.parametrize("b,k,n", SHAPES)
def test_plain_product_matches_xla_and_pallas(ref, b, k, n):
    x, w = _int8((b, k), b * 1000 + k + n), _int8((n, k), b + k * 7 + n)
    got = port_qmm.int8_matmul_reference(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.shape == (b, n)
    xla = ref.pk.int8_matmul_xla(ref.jnp.asarray(x), ref.jnp.asarray(w))
    pallas = ref.pk.int8_matmul_pallas(ref.jnp.asarray(x), ref.jnp.asarray(w),
                                       interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("xv,wv", [(-128, -128), (127, 127), (-128, 127)])
def test_plain_product_exact_at_the_extremes(ref, xv, wv):
    x = np.full((3, 4096), xv, np.int8)
    w = np.full((5, 4096), wv, np.int8)
    got = port_qmm.quant_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert (got == 4096 * xv * wv).all()  # 67,108,864 for -128 x -128
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.pk.int8_matmul_xla(ref.jnp.asarray(x),
                                                       ref.jnp.asarray(w))))


@pytest.mark.parametrize("xv,wv", [(-128, -128), (127, 127), (-128, 127)])
def test_plain_product_exact_at_max_k(ref, xv, wv):
    """At K = MAX_K the sums reach 2,147,467,264 (-128 x -128), the largest
    that K6's split partials and the plain version must carry exactly."""
    k = port_qmm.MAX_K
    x = np.full((3, k), xv, np.int8)
    w = np.full((5, k), wv, np.int8)
    got = port_qmm.quant_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert (got == k * xv * wv).all()
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.pk.int8_matmul_xla(ref.jnp.asarray(x),
                                                       ref.jnp.asarray(w))))


# the chip smoke's edge shapes for K6: batch sizes around its 8-row
# n-fragment, N not a multiple of 16 on the 16-byte path
EDGE_SHAPES = [(7, 1024, 200), (8, 1024, 200), (9, 1024, 200), (17, 1024, 200),
               (31, 1024, 200), (17, 512, 77)]


@pytest.mark.parametrize("b,k,n", EDGE_SHAPES)
def test_plain_product_matches_xla_at_the_kernel_edges(ref, b, k, n):
    x, w = _int8((b, k), b * 31 + n), _int8((n, k), b + n * 3)
    got = port_qmm.quant_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.pk.int8_matmul_xla(ref.jnp.asarray(x),
                                                       ref.jnp.asarray(w))))


def test_offset_views_are_contiguous_and_unaligned():
    """The chip smoke's unaligned operands: one byte into their buffers, yet
    contiguous, so the wrapper passes them and K6 takes its byte path."""
    import chip_smoke
    gen = torch.Generator().manual_seed(0)
    for fill, which in (("x+1", 0), ("w+1", 1)):
        ops = chip_smoke.int8_operands(torch, gen, 9, 1024, 200, fill, "cpu")
        assert [t.shape for t in ops] == [(9, 1024), (200, 1024)]
        assert all(t.is_contiguous() and t.dtype == torch.int8 for t in ops)
        assert ops[which].data_ptr() % 16 != 0
        assert ops[1 - which].storage_offset() == 0
        torch.testing.assert_close(port_qmm.quant_matmul(*ops),
                                   ops[0].int() @ ops[1].int().T)
    x, w = chip_smoke.int8_operands(torch, gen, 2, 16, 3, (-128, 127), "cpu")
    assert (x == -128).all() and (w == 127).all()


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the CUDA kernel was asked for on the CPU")

    monkeypatch.setattr(port_qmm.cuda_build, "load", boom)
    before = port_qmm.launches
    x, w = torch.from_numpy(_int8((4, 32), 1)), torch.from_numpy(_int8((6, 32), 2))
    torch.testing.assert_close(port_qmm.quant_matmul(x, w), x.int() @ w.int().T)
    assert port_qmm.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        port_qmm.int8_matmul(x, w)


@pytest.mark.parametrize("case", ["strided_w", "strided_x", "3d", "float",
                                  "k_mismatch", "empty", "k_too_large"])
def test_contract_violations_raise(case):
    x, w = torch.zeros(2, 8, dtype=torch.int8), torch.zeros(3, 8, dtype=torch.int8)
    if case == "strided_w":
        w = torch.zeros(8, 3, dtype=torch.int8).T
    elif case == "strided_x":
        x = torch.zeros(8, 2, dtype=torch.int8).T
    elif case == "3d":
        x = torch.zeros(2, 4, 8, dtype=torch.int8)
    elif case == "float":
        x = x.float()
    elif case == "k_mismatch":
        w = torch.zeros(3, 9, dtype=torch.int8)
    elif case == "empty":
        x = torch.zeros(0, 8, dtype=torch.int8)
    else:
        k = port_qmm.MAX_K + 1
        x, w = torch.zeros(1, k, dtype=torch.int8), torch.zeros(1, k, dtype=torch.int8)
    with pytest.raises((ValueError, TypeError)):
        port_qmm.quant_matmul(x, w)


# ------------------------------------------------------------------ the trees
def _np_tree(seed=0):
    """A per-layer tuple as a network holds it: a conv (HWIO), a
    parameterless layer, an attention-shaped dict, two dense layers (one with
    a dead output channel, all-zero weights) and an embedding table."""
    dense2 = _f32((12, 5), seed + 3)
    dense2[:, 2] = 0.0
    return ({"W": _f32((3, 3, 2, 4), seed), "b": _f32((4,), seed + 1)},
            {},
            {"Wq": _f32((8, 8), seed + 4), "bq": np.zeros(8, np.float32)},
            {"W": _f32((8, 12), seed + 2), "b": _f32((12,), seed + 5)},
            {"W": dense2, "b": _f32((5,), seed + 6)},
            {"W": _f32((20, 6), seed + 7, 0.3), "b": _f32((6,), seed + 8)})


def _ref_numpy(ref, tree):
    """The JAX package's tree as numpy, bfloat16 widened to float32."""
    jnp = ref.jnp
    return ref.jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                             else a), tree)


def _assert_trees_bitwise(port_np, ref_np):
    assert len(port_np) == len(ref_np)
    for i, (p, r) in enumerate(zip(port_np, ref_np)):
        assert sorted(p) == sorted(r), i
        for k in r:
            assert p[k].dtype == r[k].dtype and p[k].shape == r[k].shape, (i, k)
            np.testing.assert_array_equal(p[k], r[k], err_msg=f"{i}.{k}")


SPECS = [("int8", False), ("int8", True), ("bf16", False)]


@pytest.mark.parametrize("mode,zp", SPECS, ids=["int8", "int8_zp", "bf16"])
def test_quantize_tree_matches_reference_bitwise(ref, mode, zp):
    tree = _np_tree()
    port_tree = port_params.params_from_numpy(tree, "cpu")
    got = port_q.quantize_tree(port_tree, port_q.QuantSpec(mode, zp))
    want = ref.q.quantize_tree(ref.jax.tree_util.tree_map(ref.jnp.asarray, tree),
                               ref.q.QuantSpec(mode, zp))
    _assert_trees_bitwise(port_params.params_to_numpy(got), _ref_numpy(ref, want))
    assert port_q.tree_precision(got) == ref.q.tree_precision(want) == mode
    # the JAX package's tree carried into the port is the port's own tree
    carried = port_params.params_from_numpy(
        ref.jax.tree_util.tree_map(np.asarray, want), "cpu")
    for c, g in zip(carried, got):
        assert sorted(c) == sorted(g)
        for k in g:
            assert c[k].dtype == g[k].dtype and torch.equal(c[k], g[k]), k
    if mode == "int8":
        # W_q is [n_out, n_in], contiguous: each output channel one row
        assert got[3]["W_q"].shape == (12, 8) and got[3]["W_q"].is_contiguous()
        assert got[0]["W"].dtype == got[2]["Wq"].dtype == torch.bfloat16
        assert got[0]["W"].is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("mode,zp", SPECS, ids=["int8", "int8_zp", "bf16"])
def test_dequantize_and_sidecar_match_reference_bitwise(ref, mode, zp):
    tree = _np_tree(seed=10)
    got = port_q.quantize_tree(port_params.params_from_numpy(tree, "cpu"),
                               port_q.QuantSpec(mode, zp))
    want = ref.q.quantize_tree(ref.jax.tree_util.tree_map(ref.jnp.asarray, tree),
                               ref.q.QuantSpec(mode, zp))
    _assert_trees_bitwise(port_params.params_to_numpy(port_q.dequantize_tree(got)),
                          _ref_numpy(ref, ref.q.dequantize_tree(want)))
    side_p, side_r = port_q.sidecar_scales(got), ref.q.sidecar_scales(want)
    for p, r in zip(side_p, side_r):
        if r is None or not any(v is not None for v in r.values()):
            assert all(v is None for v in p.values())
            continue
        for k, v in r.items():
            if v is None:
                assert p[k] is None
            else:
                np.testing.assert_array_equal(p[k].numpy(), np.asarray(v))


def test_tree_precision_labels():
    tree = port_params.params_from_numpy(_np_tree(), "cpu")
    assert port_q.tree_precision(tree) == "fp32"
    assert port_q.tree_precision(port_q.quantize_tree(tree, "bf16")) == "bf16"
    assert port_q.tree_precision(port_q.quantize_tree(tree, "int8")) == "int8"


@pytest.mark.parametrize("first,second", [("int8", "int8"), ("int8", "bf16"),
                                          ("bf16", "bf16"), ("bf16", "int8")])
def test_requantization_raises_the_typed_error(ref, first, second):
    tree = _np_tree()
    port_first = port_q.quantize_tree(port_params.params_from_numpy(tree, "cpu"), first)
    ref_first = ref.q.quantize_tree(ref.jax.tree_util.tree_map(ref.jnp.asarray, tree), first)
    with pytest.raises(ref.q.AlreadyQuantizedError):
        ref.q.quantize_tree(ref_first, second)
    with pytest.raises(port_q.AlreadyQuantizedError):
        port_q.quantize_tree(port_first, second)
    assert issubclass(port_q.AlreadyQuantizedError, TypeError)


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        port_q.QuantSpec("int4")
    with pytest.raises(ValueError):
        port_q.quantize_tree(({"W": torch.ones(2, 2)},), "fp8")


def test_quantized_tree_round_trips_through_numpy_bitwise(ref):
    got = port_q.quantize_tree(port_params.params_from_numpy(_np_tree(), "cpu"),
                               "int8")
    back = port_params.params_from_numpy(
        ref.jax.tree_util.tree_map(
            lambda a: np.asarray(ref.jnp.asarray(a).astype(ref.jnp.bfloat16))
            if a.dtype == np.float32 and a.ndim >= 2 else a,
            port_params.params_to_numpy(got)), "cpu")
    for b, g in zip(back, got):
        for k in g:
            assert b[k].dtype == g[k].dtype and torch.equal(b[k], g[k]), k
            assert b[k].is_contiguous(memory_format=torch.channels_last) == \
                g[k].is_contiguous(memory_format=torch.channels_last)


# ------------------------------------------------------------------ forwards
@pytest.mark.parametrize("b,n_in,n_out", [(1, 8, 3), (5, 33, 17), (8, 128, 64),
                                          (4, 256, 40)])
@pytest.mark.parametrize("zp", [False, True], ids=["sym", "zp"])
def test_dense_qforward_matches_reference_bitwise(ref, xla_arm, b, n_in, n_out, zp):
    w, bias = _f32((n_in, n_out), 4), _f32((n_out,), 5)
    x = _f32((b, n_in), 6, scale=3.0)
    x[0] = 0.0  # a row of zeros: x_scale 1, every code 0
    spec = ref.q.QuantSpec("int8", zero_point=zp)
    want = ref.q.dense_qforward(
        ref.q.quantize_tree({"W": ref.jnp.asarray(w), "b": ref.jnp.asarray(bias)}, spec),
        ref.jnp.asarray(x))
    qp = port_q.quantize_tree({"W": torch.from_numpy(w), "b": torch.from_numpy(bias)},
                              port_q.QuantSpec("int8", zero_point=zp))
    got = port_q.dense_qforward(qp, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and within the envelope of tests/test_quantize.py of the float32 preout
    tol = 2.0 * np.sqrt(n_in) * np.abs(x).max() * qp["W_scale"].max().item()
    np.testing.assert_allclose(got.numpy(), x @ w + bias, atol=max(tol, 1e-3))


@pytest.mark.parametrize("shape", [(2, 4, 16), (16,)])
def test_dense_qforward_raises_on_input_that_is_not_2d(shape):
    """The JAX package hands a 3-D x to its matmul, which contracts the time
    axis (ROADMAP Queue C); the port refuses."""
    qp = port_q.quantize_tree({"W": torch.randn(16, 8), "b": torch.zeros(8)}, "int8")
    with pytest.raises(ValueError, match="batch, n_in"):
        port_q.dense_qforward(qp, torch.randn(shape))


@pytest.mark.parametrize("zp", [False, True], ids=["sym", "zp"])
def test_embedding_qlookup_matches_reference_bitwise(ref, zp):
    w, bias = _f32((20, 6), 7, 0.3), _f32((6,), 8)
    idx = np.array([0, 19, 3, 3, 7], np.int32)
    spec = ref.q.QuantSpec("int8", zero_point=zp)
    want = ref.q.embedding_qlookup(
        ref.q.quantize_tree({"W": ref.jnp.asarray(w), "b": ref.jnp.asarray(bias)}, spec),
        ref.jnp.asarray(idx))
    qp = port_q.quantize_tree({"W": torch.from_numpy(w), "b": torch.from_numpy(bias)},
                              port_q.QuantSpec("int8", zero_point=zp))
    got = port_q.embedding_qlookup(qp, torch.from_numpy(idx).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("shape", [(5,), (5, 1)], ids=["flat", "column"])
def test_embedding_layer_matches_reference(ref, xla_arm, quantized, shape):
    w, bias = _f32((20, 6), 7, 0.3), _f32((6,), 8)
    x = np.array([0, 19, 3, 3, 7], np.float32).reshape(shape)
    ref_layer = ref.core.EmbeddingLayer(n_in=20, n_out=6, activation="tanh")
    port_layer = port_core.EmbeddingLayer(n_in=20, n_out=6, activation="tanh")
    ref_p = {"W": ref.jnp.asarray(w), "b": ref.jnp.asarray(bias)}
    port_p = {"W": torch.from_numpy(w), "b": torch.from_numpy(bias)}
    if quantized:
        ref_p, port_p = ref.q.quantize_tree(ref_p), port_q.quantize_tree(port_p)
    want, _ = ref_layer.forward(ref_p, {}, ref.jnp.asarray(x))
    got = port_layer.forward(port_p, torch.from_numpy(x))
    assert got.shape == (5, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_dense_layer_takes_the_int8_branch(ref, xla_arm, monkeypatch):
    calls = []
    plain = port_qmm.quant_matmul
    monkeypatch.setattr(port_qmm, "quant_matmul",
                        lambda x, w: calls.append(x.shape) or plain(x, w))
    layer = port_core.DenseLayer(n_in=16, n_out=8, activation="relu")
    w, bias, x = _f32((16, 8), 1), _f32((8,), 2), _f32((3, 16), 3)
    got = layer.forward(port_q.quantize_tree({"W": torch.from_numpy(w),
                                              "b": torch.from_numpy(bias)}),
                        torch.from_numpy(x))
    want, _ = ref.core.DenseLayer(n_in=16, n_out=8, activation="relu").forward(
        ref.q.quantize_tree({"W": ref.jnp.asarray(w), "b": ref.jnp.asarray(bias)}), {},
        ref.jnp.asarray(x))
    assert calls == [(3, 16)]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------- the kernel
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    _need_cuda()
    for b, k, n in SHAPES + EDGE_SHAPES + [(32, 4096, 1000), (33, 256, 4096),
                                           (129, 130, 33)]:
        x = torch.from_numpy(_int8((b, k), b + k)).cuda()
        w = torch.from_numpy(_int8((n, k), n + k)).cuda()
        before = port_qmm.launches
        got = port_qmm.quant_matmul(x, w)
        torch.cuda.synchronize()
        assert port_qmm.launches == before + 1
        assert torch.equal(got, port_qmm.int8_matmul_reference(x, w)), (b, k, n)


@pytest.mark.cuda
def test_kernel_refuses_a_strided_weight_on_card():
    _need_cuda()
    x = torch.zeros(4, 64, dtype=torch.int8, device="cuda")
    w = torch.zeros(64, 16, dtype=torch.int8, device="cuda").T
    before = port_qmm.launches
    with pytest.raises(ValueError, match="contiguous"):
        port_qmm.quant_matmul(x, w)
    assert port_qmm.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("xv,wv", [(-128, -128), (127, 127)])
@pytest.mark.parametrize("k", [port_qmm.MAX_K, port_qmm.MAX_K // 16 * 16],
                         ids=["bytes", "vec"])
def test_kernel_split_k_exact_at_max_k_on_card(xv, wv, k):
    """K split over a cluster of 8 blocks at the largest K: every partial and
    the sum (2,147,467,264 at MAX_K) stay exact."""
    _need_cuda()
    x = torch.full((32, k), xv, dtype=torch.int8, device="cuda")
    w = torch.full((80, k), wv, dtype=torch.int8, device="cuda")
    got = port_qmm.quant_matmul(x, w)
    torch.cuda.synchronize()
    assert (got == k * xv * wv).all()


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["x", "w"])
def test_kernel_takes_unaligned_operands_on_card(which):
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    import chip_smoke
    x, w = chip_smoke.int8_operands(torch, gen, 9, 1024, 200, f"{which}+1", "cuda")
    got = port_qmm.quant_matmul(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, port_qmm.int8_matmul_reference(x, w))
