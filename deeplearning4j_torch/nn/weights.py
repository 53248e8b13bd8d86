"""Weight initialization schemes.

Port of `deeplearning4j_tpu/nn/weights.py` (reference WeightInit.java +
WeightInitUtil.java). The schemes and their scales are the same; the draws
come from an explicit `torch.Generator` instead of a JAX key, so the values
differ from the JAX package's and only the distributions agree.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Sequence

import torch

from ..utils import serde


@serde.register
class WeightInit(enum.Enum):
    DISTRIBUTION = "distribution"
    ZERO = "zero"
    ONES = "ones"
    UNIFORM = "uniform"
    SIGMOID_UNIFORM = "sigmoid_uniform"
    XAVIER = "xavier"
    XAVIER_UNIFORM = "xavier_uniform"
    XAVIER_FAN_IN = "xavier_fan_in"
    XAVIER_LEGACY = "xavier_legacy"
    RELU = "relu"
    RELU_UNIFORM = "relu_uniform"
    LECUN_NORMAL = "lecun_normal"
    LECUN_UNIFORM = "lecun_uniform"
    NORMAL = "normal"


def _normal(gen, shape, dtype):
    return torch.randn(shape, generator=gen, dtype=dtype)


def _uniform(gen, shape, dtype, lo, hi):
    return torch.rand(shape, generator=gen, dtype=dtype) * (hi - lo) + lo


@serde.register
@dataclass
class Distribution:
    """Explicit distribution for WeightInit.DISTRIBUTION."""

    kind: str = "normal"  # normal | uniform
    mean: float = 0.0
    std: float = 1.0
    lower: float = -1.0
    upper: float = 1.0

    def sample(self, gen: torch.Generator, shape, dtype) -> torch.Tensor:
        if self.kind == "normal":
            return self.mean + self.std * _normal(gen, shape, dtype)
        if self.kind == "uniform":
            return _uniform(gen, shape, dtype, self.lower, self.upper)
        raise ValueError(f"Unknown distribution kind {self.kind!r}")


def init_weights(
    gen: torch.Generator,
    shape: Sequence[int],
    fan_in: int,
    fan_out: int,
    scheme: WeightInit,
    distribution: Distribution | None = None,
    dtype=torch.float32,
) -> torch.Tensor:
    """Draw one weight tensor from `gen` (a CPU generator: the same seed
    gives the same weights whatever device the network then runs on)."""
    shape = tuple(int(s) for s in shape)
    s = scheme
    if s == WeightInit.ZERO:
        return torch.zeros(shape, dtype=dtype)
    if s == WeightInit.ONES:
        return torch.ones(shape, dtype=dtype)
    if s == WeightInit.DISTRIBUTION:
        if distribution is None:
            raise ValueError("WeightInit.DISTRIBUTION requires a Distribution")
        return distribution.sample(gen, shape, dtype)
    if s == WeightInit.UNIFORM:
        a = 1.0 / math.sqrt(fan_in)
        return _uniform(gen, shape, dtype, -a, a)
    if s == WeightInit.SIGMOID_UNIFORM:
        a = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, dtype, -a, a)
    if s == WeightInit.XAVIER:
        return math.sqrt(2.0 / (fan_in + fan_out)) * _normal(gen, shape, dtype)
    if s == WeightInit.XAVIER_UNIFORM:
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, dtype, -a, a)
    if s == WeightInit.XAVIER_FAN_IN:
        return math.sqrt(1.0 / fan_in) * _normal(gen, shape, dtype)
    if s == WeightInit.XAVIER_LEGACY:
        return math.sqrt(1.0 / (fan_in + fan_out)) * _normal(gen, shape, dtype)
    if s == WeightInit.RELU:
        return math.sqrt(2.0 / fan_in) * _normal(gen, shape, dtype)
    if s == WeightInit.RELU_UNIFORM:
        a = math.sqrt(6.0 / fan_in)
        return _uniform(gen, shape, dtype, -a, a)
    if s == WeightInit.LECUN_NORMAL:
        return math.sqrt(1.0 / fan_in) * _normal(gen, shape, dtype)
    if s == WeightInit.LECUN_UNIFORM:
        a = math.sqrt(3.0 / fan_in)
        return _uniform(gen, shape, dtype, -a, a)
    if s == WeightInit.NORMAL:
        return _normal(gen, shape, dtype)
    raise ValueError(f"Unknown weight init scheme {scheme}")
