"""The recurrent layers of the torch port (nn/layers/recurrent.py) against
the JAX package's: LSTM, GravesLSTM and GravesBidirectionalLSTM.

- Forward on [3, 7, 5] inputs, with and without a features mask, and a
  stateful [B, F] single step (output and new carry): rtol 1e-5, atol 1e-6,
  from the JAX package's parameters carried by utils/params.py.
- Gradients of sum(y * r) with respect to every parameter and the input
  against `jax.grad`, masked: rtol 1e-4 (atol 1e-6).
- The init: the forget-gate bias (b[H:2H]) at `forget_gate_bias_init`, the
  rest of b zero, W, RW and the peepholes drawn at Xavier's scale with
  fan_in H and fan_out n_in + H (the sample std within 2%).
- A masked step zeroes both h and c; the bidirectional pass masks in
  reverse too.
- A bfloat16 tree (`quantize_tree`'s serving form: bfloat16 weights,
  float32 features and carry) within one bfloat16 ulp of the largest
  output of the JAX package's.
- Configuration JSON equals the JAX package's; a non-recurrent input type
  raises; the bidirectional layer's regularization strips its prefix.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.nn.layers import recurrent as port_rec
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.nn.layers import recurrent as ref_rec

KINDS = ["LSTM", "GravesLSTM", "GravesBidirectionalLSTM"]
BF16_ULP = 2.0 ** -7


def _pair(kind, n_in=5, n_out=4, seed=1, dtype=jnp.float32, **kw):
    """(JAX layer, its parameters, port layer, the same parameters)."""
    r = getattr(ref_rec, kind)(n_in=n_in, n_out=n_out, activation="tanh", **kw)
    p = getattr(port_rec, kind)(n_in=n_in, n_out=n_out, activation="tanh", **kw)
    rp = r.init_params(jax.random.PRNGKey(seed), dtype)
    pp = port_params.params_from_numpy(
        (jax.tree_util.tree_map(np.asarray, rp),), "cpu")[0]
    return r, rp, p, pp


def _inputs(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _mask(b, t, seed=3):
    m = (np.random.default_rng(seed).random((b, t)) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    return m


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_reference(kind, masked):
    r, rp, p, pp = _pair(kind)
    x = _inputs((3, 7, 5))
    m = _mask(3, 7) if masked else None
    want, _ = r.forward(rp, {}, jnp.asarray(x), mask=None if m is None else jnp.asarray(m))
    got = p.forward(pp, torch.from_numpy(x), mask=None if m is None else torch.from_numpy(m))
    assert got.shape == (3, 7, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["LSTM", "GravesLSTM"])
def test_stateful_single_step_matches_reference(kind):
    r, rp, p, pp = _pair(kind)
    x = _inputs((3, 5), seed=4)
    h, c = _inputs((3, 4), seed=5), _inputs((3, 4), seed=6)
    want, want_state = r.forward(rp, {"h": jnp.asarray(h), "c": jnp.asarray(c)},
                                 jnp.asarray(x))
    got, got_state = p.forward_with_state(
        pp, {"h": torch.from_numpy(h), "c": torch.from_numpy(c)}, torch.from_numpy(x))
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for k in ("h", "c"):
        np.testing.assert_allclose(got_state[k].numpy(), np.asarray(want_state[k]),
                                   rtol=1e-5, atol=1e-6)
    # stateless: zeros in, the state handed back as it came
    empty = {}
    _, st = p.forward_with_state(pp, empty, torch.from_numpy(x))
    assert st is empty


@pytest.mark.parametrize("kind", KINDS)
def test_gradients_match_jax_grad(kind):
    r, rp, p, pp = _pair(kind, seed=2)
    x, m = _inputs((3, 6, 5), seed=7), _mask(3, 6, seed=8)
    w = _inputs((3, 6, 4), seed=9)

    def loss(params, xx):
        y, _ = r.forward(params, {}, xx, mask=jnp.asarray(m))
        return jnp.sum(y * jnp.asarray(w))

    want_p, want_x = jax.grad(loss, argnums=(0, 1))(rp, jnp.asarray(x))
    leaves = {k: v.detach().clone().requires_grad_() for k, v in pp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y = p.forward(leaves, xt, mask=torch.from_numpy(m))
    torch.sum(y * torch.from_numpy(w)).backward()
    assert sorted(leaves) == sorted(want_p)
    for k, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_p[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_init_forget_bias_and_scale(kind):
    n_in, H = 64, 256
    layer = getattr(port_rec, kind)(n_in=n_in, n_out=H, forget_gate_bias_init=0.75)
    params = layer.init_params(torch.Generator().manual_seed(0))
    ref_params = getattr(ref_rec, kind)(n_in=n_in, n_out=H, forget_gate_bias_init=0.75
                                        ).init_params(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in ref_params.items()}
    std = np.sqrt(2.0 / (H + n_in + H))   # Xavier: fan_in H, fan_out n_in + H
    for k, v in params.items():
        if k.endswith("b"):
            assert torch.equal(v[H:2 * H], torch.full((H,), 0.75))
            assert not v[:H].any() and not v[2 * H:].any()
        else:
            assert abs(float(v.std()) / std - 1.0) < 0.02 if v.numel() > 10000 \
                else abs(float(v.std()) / std - 1.0) < 0.2, k


@pytest.mark.parametrize("kind", ["LSTM", "GravesLSTM"])
def test_masked_steps_zero_h_and_c(kind):
    _, _, p, pp = _pair(kind)
    x = torch.from_numpy(_inputs((2, 5, 5), seed=10))
    m = torch.ones(2, 5)
    m[0, 2] = m[0, 4] = m[1, 4] = 0.0
    state = {"h": torch.ones(2, 4), "c": torch.ones(2, 4)}
    y, new = p.forward_with_state(pp, state, x, mask=m)
    assert not y[0, 2].any() and not y[0, 4].any() and not y[1, 4].any()
    assert not new["h"].any() and not new["c"].any()   # the last step is masked
    # the step after a masked one starts from zeros: the same as a fresh start
    y3 = p.forward(pp, x[:, 3:4])
    torch.testing.assert_close(y[0, 3], y3[0, 0], rtol=1e-6, atol=0.0)


def test_bidirectional_reverse_pass_is_aligned_and_masked():
    _, _, p, pp = _pair("GravesBidirectionalLSTM")
    x = torch.from_numpy(_inputs((2, 6, 5), seed=11))
    m = torch.ones(2, 6)
    m[1, 4:] = 0.0
    y = p.forward(pp, x, mask=m)
    fwd_only = {k[1:]: v for k, v in pp.items() if k.startswith("F")}
    bwd_only = {k[1:]: v for k, v in pp.items() if k.startswith("B")}
    g = port_rec.GravesLSTM(n_in=5, n_out=4, activation="tanh")
    f = g.forward(fwd_only, x, mask=m)
    # the reversed pass over row 1's 4 present steps is the forward pass
    # over them reversed, aligned back to the input positions
    b1 = g.forward(bwd_only, x[1:, :4].flip(1)).flip(1)
    torch.testing.assert_close(y[1, :4], f[1, :4] + b1[0], rtol=1e-6, atol=1e-7)
    assert not y[1, 4:].any()


def test_bfloat16_tree_within_one_ulp():
    r, rp, p, pp = _pair("GravesLSTM", n_in=16, n_out=32, dtype=jnp.bfloat16)
    assert {t.dtype for t in pp.values()} == {torch.bfloat16}
    x = _inputs((4, 9, 16), seed=12)
    want, _ = r.forward(rp, {}, jnp.asarray(x))
    got = p.forward(pp, torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= BF16_ULP * np.abs(want).max()


def _conf(pkg, kind):
    return (pkg.NeuralNetConfiguration.builder().seed(3).list()
            .layer(getattr(pkg, kind)(n_out=4, activation="tanh",
                                      forget_gate_bias_init=0.5))
            .layer(pkg.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.recurrent(5)).build())


@pytest.mark.parametrize("kind", KINDS)
def test_configuration_json_matches_reference(kind):
    mine, theirs = _conf(port, kind), _conf(ref, kind)
    assert json.loads(mine.to_json()) == json.loads(theirs.to_json())
    back = port.MultiLayerConfiguration.from_json(theirs.to_json())
    assert type(back.layers[0]) is getattr(port, kind) and back.layers[0].n_in == 5


def test_non_recurrent_input_raises_and_regularization():
    with pytest.raises(ValueError, match="RNN input"):
        port.LSTM(n_out=4).set_input_type(port.InputType.feed_forward(5))
    bi = port.GravesBidirectionalLSTM(n_out=4, l2=0.1, l2_bias=0.2)
    assert bi.param_reg("FRW") == (0.0, 0.1) and bi.param_reg("Bb") == (0.0, 0.2)
    assert bi.param_reg("FwF") == (0.0, 0.0)
    assert not bi.supports_streaming() and port.GravesLSTM(n_out=4).supports_streaming()
