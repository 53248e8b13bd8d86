"""The conv layers of the BatchNormalization slice against the JAX package:
ZeroPaddingLayer (2- and 4-int padding), Convolution1DLayer and
Subsampling1DLayer, forward and gradients from the same parameters (float32,
rtol 1e-5 forward, 1e-5 relative norm for gradients: convs summed in
another order); and the "mask" max pool's backward (ties split equally)
against the JAX package's `_max_pool_mask` on inputs with forced ties, for
SAME, VALID and truncating geometries (rtol 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.ops import pooling as port_pool
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.nn.layers import convolution as ref_conv
from deeplearning4j_tpu.ops import pooling as ref_pool


def _rel_err(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _both(make, shape, seed=0, params_seed=1):
    """(port output, ref output, port grads, ref grads) of the layer `make`
    builds in each package, on x of `shape` and the cotangent g, the
    parameters drawn by the port and carried to the JAX package."""
    pl, rl = make(port), make(ref)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    p_port = pl.init_params(torch.Generator().manual_seed(params_seed))
    p_ref = {k: jnp.asarray(v) for k, v in
             port_params.params_to_numpy(p_port).items()}
    xt = torch.from_numpy(x).requires_grad_()
    pt = {k: v.clone().requires_grad_() for k, v in p_port.items()}
    got = pl.forward(pt, xt)
    g = rng.standard_normal(tuple(got.shape)).astype(np.float32)
    (got * torch.from_numpy(g)).sum().backward()

    def f(p, xx):
        y, _ = rl.forward(p, {}, xx)
        return y, jnp.sum(y * g)

    want = f(p_ref, jnp.asarray(x))[0]
    gp, gx = jax.grad(lambda p, xx: f(p, xx)[1], argnums=(0, 1))(p_ref, jnp.asarray(x))
    got_gp = port_params.params_to_numpy({k: v.grad for k, v in pt.items()})
    return (got.detach().numpy(), np.asarray(want), xt.grad.numpy(),
            np.asarray(gx), got_gp, {k: np.asarray(v) for k, v in gp.items()})


@pytest.mark.parametrize("padding", [(1, 2), (2, 0, 1, 3)], ids=["2int", "4int"])
def test_zero_padding_matches_reference(padding):
    got, want, gx, wx, _, _ = _both(
        lambda pkg: pkg.ZeroPaddingLayer(padding=padding), (2, 5, 4, 3))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gx, wx)
    it = port.InputType.convolutional(5, 4, 3)
    rit = ref.InputType.convolutional(5, 4, 3)
    out = port.ZeroPaddingLayer(padding=padding).set_input_type(it)
    rout = ref.ZeroPaddingLayer(padding=padding).set_input_type(rit)
    assert (out.height, out.width, out.channels) == \
        (rout.height, rout.width, rout.channels) == tuple(got.shape[1:])


CONV1D = [
    dict(kernel_size=(3,), stride=(1,), padding=(0,)),
    dict(kernel_size=(4,), stride=(2,), padding=(1,)),
    dict(kernel_size=(3,), stride=(2,), dilation=(2,),
         convolution_mode="SAME"),
]


@pytest.mark.parametrize("kw", CONV1D, ids=["valid", "strided_pad", "same_dilated"])
def test_conv1d_matches_reference(kw):
    def make(pkg):
        k = dict(kw)
        if "convolution_mode" in k:
            k["convolution_mode"] = getattr(pkg.ConvolutionMode, k["convolution_mode"])
        return pkg.Convolution1DLayer(n_in=5, n_out=6, activation="tanh",
                                      bias_init=0.1, **k)

    got, want, gx, wx, gp, wp = _both(make, (3, 11, 5))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert _rel_err(gx, wx) < 1e-5
    for k in wp:
        assert gp[k].shape == wp[k].shape
        assert _rel_err(gp[k], wp[k]) < 1e-5, k
    # the JAX package's HWIO kernel is [k, 1, n_in, n_out]
    assert wp["W"].shape == (kw["kernel_size"][0], 1, 5, 6)
    it = make(port).set_input_type(port.InputType.recurrent(5, 11))
    rit = make(ref).set_input_type(ref.InputType.recurrent(5, 11))
    assert (it.size, it.timeseries_length) == (rit.size, rit.timeseries_length) \
        == (6, got.shape[1])


@pytest.mark.parametrize("ptype", ["MAX", "AVG", "SUM", "PNORM"])
@pytest.mark.parametrize("mode", ["TRUNCATE", "SAME"])
def test_subsampling1d_matches_reference(ptype, mode):
    def make(pkg):
        return pkg.Subsampling1DLayer(
            kernel_size=(3,), stride=(2,), padding=(1,) if mode == "TRUNCATE" else (0,),
            pooling_type=getattr(pkg.PoolingType, ptype),
            convolution_mode=getattr(pkg.ConvolutionMode, mode),
            pooling_impl="sns" if ptype == "MAX" else "auto")

    got, want, gx, wx, _, _ = _both(make, (2, 10, 4))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert _rel_err(gx, wx) < 1e-5
    it = make(port).set_input_type(port.InputType.recurrent(4, 10))
    rit = make(ref).set_input_type(ref.InputType.recurrent(4, 10))
    assert it.timeseries_length == rit.timeseries_length == got.shape[1]


# (window, strides, pads, H, W): SAME 3x3/1 (GoogLeNet's inception pool),
# VALID 2x2/2, a truncating 3x3/2 whose last window reaches past the high
# pad (the extent rule of the backward), and AlexNet's padded 3x3/2
MASK_CASES = [
    ((3, 3), (1, 1), ((1, 1), (1, 1)), 7, 7),
    ((2, 2), (2, 2), ((0, 0), (0, 0)), 8, 8),
    ((3, 3), (2, 2), ((0, 0), (0, 0)), 8, 9),
    ((3, 3), (2, 2), ((1, 1), (1, 1)), 9, 9),
    ((3, 2), (2, 3), ((1, 0), (0, 1)), 7, 10),
]


@pytest.mark.parametrize("case", MASK_CASES,
                         ids=["same3x3s1", "valid2x2s2", "trunc3x3s2",
                              "padded3x3s2", "asym"])
def test_max_pool_mask_backward_matches_reference(case):
    window, strides, pads, h, w = case
    rng = np.random.default_rng(5)
    # small integers: most windows hold tied maxima
    x = rng.integers(0, 3, (2, h, w, 3)).astype(np.float32)
    want_y, vjp = jax.vjp(lambda v: ref_pool._max_pool_mask(v, window, strides, pads),
                          jnp.asarray(x))
    g = rng.standard_normal(want_y.shape).astype(np.float32)
    want, = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    y = port_pool.max_pool(xt, window, strides, pads, impl="mask")
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the cotangent is split, not dropped: every window's share adds up
    np.testing.assert_allclose(xt.grad.sum().item(), g.sum(), rtol=1e-5)


def test_subsampling_layer_takes_mask_impl():
    """A SubsamplingLayer(pooling_impl="mask") gives the JAX package's
    gradient where windows tie; "auto" keeps the first-maximum rule."""
    x = np.zeros((1, 4, 4, 1), np.float32)   # every window tied
    layer = port.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                  pooling_type=port.PoolingType.MAX,
                                  pooling_impl="mask")
    xt = torch.from_numpy(x).requires_grad_()
    layer.forward({}, xt).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.full_like(x, 0.25))
    layer.pooling_impl = "auto"
    xt.grad = None
    layer.forward({}, xt).sum().backward()
    assert xt.grad.sum().item() == 4.0 and xt.grad.max().item() == 1.0
    with pytest.raises(ValueError):
        port_pool.max_pool(xt, (2, 2), (2, 2), ((0, 0), (0, 0)), impl="conv")


def test_layer_json_matches_reference():
    for name in ("ZeroPaddingLayer", "Convolution1DLayer", "Subsampling1DLayer",
                 "BatchNormalization"):
        got = port.utils.serde.to_dict(getattr(port, name)())
        want = ref_conv.serde.to_dict(getattr(ref, name)())
        assert got == want, name
