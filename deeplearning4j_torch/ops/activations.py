"""Activation functions.

Port of `deeplearning4j_tpu/ops/activations.py`: the same names with the
same math, as torch functions. Configs carry the string name so JSON
round-trips; `resolve` turns name -> fn.
"""
from __future__ import annotations

from typing import Callable, Union

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _identity(x):
    return x


def _leakyrelu(x, alpha=0.01):
    return torch.where(x >= 0, x, alpha * x)


def _rationaltanh(x):
    # tanh approximation 1.7159 * tanh(2x/3) (LeCun), as in nd4j RationalTanh.
    a = torch.abs(2.0 * x / 3.0)
    approx = 1.0 - 1.0 / (1.0 + a + a * a + 1.41645 * a**4)
    return 1.7159 * torch.sign(x) * approx


ACTIVATIONS: dict[str, Callable[[Tensor], Tensor]] = {
    "identity": _identity,
    "linear": _identity,
    "relu": F.relu,
    "relu6": lambda x: torch.clamp(F.relu(x), max=6.0),
    "leakyrelu": _leakyrelu,
    "elu": F.elu,
    "selu": F.selu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "hardsigmoid": lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
    "tanh": torch.tanh,
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "rationaltanh": _rationaltanh,
    "rectifiedtanh": lambda x: torch.clamp(torch.tanh(x), min=0.0),
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "logsoftmax": lambda x: torch.log_softmax(x, dim=-1),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "cube": lambda x: x * x * x,
    "swish": F.silu,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    # RRELU: deterministic leaky-relu with the RReLU mean alpha (l+u)/2=0.25,
    # the JAX package's documented divergence from the reference.
    "rrelu": lambda x: _leakyrelu(x, 0.25),
}

ActivationLike = Union[str, Callable[[Tensor], Tensor], None]


def resolve(act: ActivationLike) -> Callable[[Tensor], Tensor]:
    """Name-or-callable -> callable. None means identity."""
    if act is None:
        return _identity
    if callable(act):
        return act
    key = act.lower()
    if key not in ACTIVATIONS:
        raise ValueError(f"Unknown activation {act!r}. Known: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]


def register_activation(name: str, fn: Callable[[Tensor], Tensor]) -> None:
    """Custom-activation extension point (reference TestCustomActivation):
    a configuration names it by `name`, so its JSON round-trips; the
    function must be registered in the process that loads it."""
    ACTIVATIONS[name.lower()] = fn
