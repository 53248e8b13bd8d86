"""Every registered loss of the torch port against the JAX package.

For each loss (with the activation it is used with, the fused
softmax+MCXENT/NLL and sigmoid+XENT pairs included) and each mask kind (none,
per-example [batch], time-series [batch, time] on rank-3 inputs), the same
numpy inputs go through `score_array`, `score` and the gradient of `score`
with respect to `preout` in both packages. Tolerance rtol 1e-5 / atol 1e-6:
float32 on both sides, reductions in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.ops import losses as port_losses
from deeplearning4j_tpu.ops import losses as ref_losses

RTOL, ATOL = 1e-5, 1e-6

# (loss name, activation, label kind)
CASES = [
    ("mse", "identity", "real"), ("squared_loss", "tanh", "real"),
    ("l2", "identity", "real"), ("l1", "identity", "real"),
    ("mae", "identity", "real"),
    ("xent", "sigmoid", "binary"), ("xent", "softmax", "binary"),
    ("mcxent", "softmax", "onehot"), ("mcxent", "sigmoid", "onehot"),
    ("negativeloglikelihood", "softmax", "onehot"),
    ("negativeloglikelihood", "sigmoid", "onehot"),
    ("hinge", "identity", "sign"), ("squared_hinge", "identity", "sign"),
    ("kl_divergence", "softmax", "probs"),
    ("mean_absolute_percentage_error", "identity", "positive"),
    ("mape", "identity", "positive"),
    ("mean_squared_logarithmic_error", "sigmoid", "positive"),
    ("msle", "sigmoid", "positive"), ("poisson", "sigmoid", "positive"),
    ("cosine_proximity", "identity", "real"),
]


def _labels(kind, shape, rng):
    if kind == "real":
        return rng.standard_normal(shape)
    if kind == "binary":
        return (rng.random(shape) < 0.5).astype(np.float64)
    if kind == "onehot":
        return np.eye(shape[-1])[rng.integers(0, shape[-1], shape[:-1])]
    if kind == "sign":
        return np.where(rng.random(shape) < 0.5, -1.0, 1.0)
    if kind == "probs":
        e = np.exp(rng.standard_normal(shape))
        return e / e.sum(-1, keepdims=True)
    return rng.random(shape) + 0.5  # positive


def _inputs(kind, label_kind, seed):
    rng = np.random.default_rng(seed)
    shape = (6, 4, 5) if kind == "timeseries" else (6, 5)
    preout = rng.standard_normal(shape).astype(np.float32)
    labels = _labels(label_kind, shape, rng).astype(np.float32)
    if kind == "none":
        mask = None
    elif kind == "example":
        mask = (rng.random(shape[0]) < 0.7).astype(np.float32)
    else:
        mask = (rng.random(shape[:2]) < 0.7).astype(np.float32)
    return preout, labels, mask


@pytest.mark.parametrize("mask_kind", ["none", "example", "timeseries"])
@pytest.mark.parametrize("name,act,label_kind", CASES,
                         ids=[f"{n}-{a}" for n, a, _ in CASES])
def test_loss_matches_reference(name, act, label_kind, mask_kind):
    preout, labels, mask = _inputs(mask_kind, label_kind,
                                   seed=len(name) * 31 + len(act))
    ref, port = ref_losses.resolve(name), port_losses.resolve(name)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    jl, tl = jnp.asarray(labels), torch.from_numpy(labels)

    want_sa = ref.score_array(jl, jnp.asarray(preout), act, jm)
    want_s, want_g = jax.value_and_grad(
        lambda p: ref.score(jl, p, act, jm))(jnp.asarray(preout))

    tp = torch.from_numpy(preout).requires_grad_()
    got_sa = port.score_array(tl, tp, act, tm)
    got_s = port.score(tl, tp, act, tm)
    got_s.backward()

    np.testing.assert_allclose(got_sa.detach().numpy(), np.asarray(want_sa),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_s.item(), float(want_s), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(want_g),
                               rtol=RTOL, atol=ATOL)


def test_registry_names_and_resolve():
    assert sorted(port_losses.LOSSES) == sorted(ref_losses.LOSSES)
    assert port_losses.resolve("MCXENT") is port_losses.LOSSES["mcxent"]
    with pytest.raises(ValueError, match="Unknown loss"):
        port_losses.resolve("nope")
    custom = port_losses.Loss("twice_l1", lambda l, o: 2.0 * torch.abs(o - l))
    port_losses.register_loss("Twice_L1", custom)
    try:
        assert port_losses.resolve("twice_l1") is custom
        s = custom.score(torch.zeros(2, 3), torch.ones(2, 3))
        assert s.item() == pytest.approx(6.0)
    finally:
        del port_losses.LOSSES["twice_l1"]
