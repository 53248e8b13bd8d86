"""Updater, schedule and gradient-normalization configs.

Port of the config half of `deeplearning4j_tpu/nn/updaters.py`: the
dataclasses a configuration's JSON names, with the same fields and
registered names, so a configuration round-trips between the packages. The
step math (apply/update, the schedules' rates, normalize_layer_gradients)
comes with the training slice.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict

from ..utils import serde


@serde.register
@dataclass
class Schedule:
    """Base: constant learning rate."""


@serde.register
@dataclass
class ExponentialSchedule(Schedule):
    decay_rate: float = 0.99


@serde.register
@dataclass
class InverseSchedule(Schedule):
    gamma: float = 1e-3
    power: float = 1.0


@serde.register
@dataclass
class PolySchedule(Schedule):
    power: float = 1.0
    max_iterations: int = 10000


@serde.register
@dataclass
class SigmoidSchedule(Schedule):
    gamma: float = 1e-2
    step_size: int = 1000


@serde.register
@dataclass
class StepSchedule(Schedule):
    decay_rate: float = 0.1
    step_size: int = 1000


@serde.register
@dataclass
class MapSchedule(Schedule):
    """Iteration -> rate map (piecewise constant)."""

    schedule: Dict[int, float] = field(default_factory=dict)


@serde.register
@dataclass
class Updater:
    """Base updater config."""

    learning_rate: float = 0.1
    schedule: Schedule | None = None


@serde.register
@dataclass
class Sgd(Updater):
    learning_rate: float = 0.1


@serde.register
@dataclass
class NoOp(Updater):
    """Updater.NONE — pass gradient through unscaled."""


@serde.register
@dataclass
class Nesterovs(Updater):
    learning_rate: float = 0.1
    momentum: float = 0.9


@serde.register
@dataclass
class Adam(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8


@serde.register
@dataclass
class AdaMax(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8


@serde.register
@dataclass
class AdaGrad(Updater):
    learning_rate: float = 1e-1
    epsilon: float = 1e-6


@serde.register
@dataclass
class AdaDelta(Updater):
    rho: float = 0.95
    epsilon: float = 1e-6


@serde.register
@dataclass
class RmsProp(Updater):
    learning_rate: float = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8


@serde.register
class GradientNormalization(enum.Enum):
    NONE = "none"
    RENORMALIZE_L2_PER_LAYER = "renormalize_l2_per_layer"
    RENORMALIZE_L2_PER_PARAM_TYPE = "renormalize_l2_per_param_type"
    CLIP_ELEMENT_WISE_ABSOLUTE_VALUE = "clip_element_wise_absolute_value"
    CLIP_L2_PER_LAYER = "clip_l2_per_layer"
    CLIP_L2_PER_PARAM_TYPE = "clip_l2_per_param_type"
