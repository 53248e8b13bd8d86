"""Optimizer (updater) math, learning-rate schedules, gradient normalization.

Port of `deeplearning4j_tpu/nn/updaters.py`: the dataclasses a
configuration's JSON names, with the same fields and registered names, and
their step math with the JAX package's formulas, written as plain tensor
arithmetic (not `torch.optim`, whose Nesterov and AdaDelta differ):

    state = updater.init(params)                       # per-param dict
    updates, state = updater.update(grads, state, iteration)
    new_params = params - updates

`iteration` is the step count BEFORE the step (a Python int); schedules
return a float32 rate, and the bias corrections use ``iteration + 1``.
Gradient normalization (`normalize_layer_gradients`) runs per layer before
the updater, as the reference's BaseMultiLayerUpdater.preApply does.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from ..utils import serde

Tensor = torch.Tensor


def _f32(v) -> Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Learning rate schedules (reference nn/conf/LearningRatePolicy.java)
# ---------------------------------------------------------------------------


@serde.register
@dataclass
class Schedule:
    """Base: constant learning rate."""

    def rate(self, base_lr, iteration) -> Tensor:
        return _f32(base_lr)


@serde.register
@dataclass
class ExponentialSchedule(Schedule):
    decay_rate: float = 0.99

    def rate(self, base_lr, iteration):
        return base_lr * torch.pow(_f32(self.decay_rate), _f32(iteration))


@serde.register
@dataclass
class InverseSchedule(Schedule):
    gamma: float = 1e-3
    power: float = 1.0

    def rate(self, base_lr, iteration):
        return base_lr / torch.pow(1.0 + self.gamma * _f32(iteration), self.power)


@serde.register
@dataclass
class PolySchedule(Schedule):
    power: float = 1.0
    max_iterations: int = 10000

    def rate(self, base_lr, iteration):
        frac = torch.clamp(_f32(iteration) / float(self.max_iterations), 0.0, 1.0)
        return base_lr * torch.pow(1.0 - frac, self.power)


@serde.register
@dataclass
class SigmoidSchedule(Schedule):
    gamma: float = 1e-2
    step_size: int = 1000

    def rate(self, base_lr, iteration):
        return base_lr / (1.0 + torch.exp(
            self.gamma * (_f32(iteration) - self.step_size)))


@serde.register
@dataclass
class StepSchedule(Schedule):
    decay_rate: float = 0.1
    step_size: int = 1000

    def rate(self, base_lr, iteration):
        return base_lr * torch.pow(
            _f32(self.decay_rate),
            torch.floor(_f32(iteration) / float(self.step_size)))


@serde.register
@dataclass
class MapSchedule(Schedule):
    """Iteration -> rate map (piecewise constant)."""

    schedule: Dict[int, float] = field(default_factory=dict)

    def rate(self, base_lr, iteration):
        rate = _f32(base_lr)
        for threshold in sorted(self.schedule):
            if int(iteration) >= threshold:
                rate = _f32(self.schedule[threshold])
        return rate


# ---------------------------------------------------------------------------
# Updaters (reference nn/conf/Updater.java: SGD, ADAM, ADAMAX, ADADELTA,
# NESTEROVS, ADAGRAD, RMSPROP, NONE)
# ---------------------------------------------------------------------------


@serde.register
@dataclass
class Updater:
    """Base updater config. Subclasses implement per-parameter math."""

    learning_rate: float = 0.1
    schedule: Schedule | None = None

    # -- per-parameter state -------------------------------------------------
    def init_state(self, param: Tensor) -> Any:
        return ()

    def apply(self, grad: Tensor, state: Any, lr: Tensor, step: int):
        """Return (update_to_subtract, new_state)."""
        raise NotImplementedError

    # -- per-layer entry points used by the train step -----------------------
    def init(self, params: Dict[str, Tensor]) -> Dict[str, Any]:
        return {name: self.init_state(p) for name, p in params.items()}

    def current_rate(self, iteration: int) -> Tensor:
        return (self.schedule or Schedule()).rate(self.learning_rate, iteration)

    def update(self, grads: Dict[str, Tensor], state: Dict[str, Any],
               iteration: int):
        """(updates, new_state) for one layer's dict of gradients. The new
        state keeps the old state's dtype, as in the JAX package."""
        lr = self.current_rate(iteration)

        def one(g, old):
            u, s = self.apply(g, old, lr, iteration)
            return u, (tuple(n.to(o.dtype) for n, o in zip(s, old))
                       if isinstance(old, tuple) else s.to(old.dtype))
        updates, new_state = {}, {}
        for name, g in grads.items():
            updates[name], new_state[name] = leafwise(one, g, state[name])
        return updates, new_state


@serde.register
@dataclass
class Sgd(Updater):
    learning_rate: float = 0.1

    def apply(self, grad, state, lr, step):
        return lr * grad, state


@serde.register
@dataclass
class NoOp(Updater):
    """Updater.NONE — pass gradient through unscaled."""

    def apply(self, grad, state, lr, step):
        return grad, state


@serde.register
@dataclass
class Nesterovs(Updater):
    learning_rate: float = 0.1
    momentum: float = 0.9

    def init_state(self, param):
        return torch.zeros_like(param)

    def apply(self, grad, v, lr, step):
        # nd4j NesterovsUpdater: v_new = mu*v - lr*g; the subtracted update
        # is mu*v - (1+mu)*v_new (plain SGD at mu = 0).
        mu = self.momentum
        v_new = mu * v - lr * grad
        return mu * v - (1.0 + mu) * v_new, v_new


@serde.register
@dataclass
class Adam(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, param):
        return (torch.zeros_like(param), torch.zeros_like(param))

    def apply(self, grad, state, lr, step):
        m, v = state
        t = _f32(step) + 1.0
        m = self.beta1 * m + (1.0 - self.beta1) * grad
        v = self.beta2 * v + (1.0 - self.beta2) * grad * grad
        alpha = lr * torch.sqrt(1.0 - torch.pow(_f32(self.beta2), t)) / (
            1.0 - torch.pow(_f32(self.beta1), t))
        return alpha * m / (torch.sqrt(v) + self.epsilon), (m, v)


@serde.register
@dataclass
class AdaMax(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, param):
        return (torch.zeros_like(param), torch.zeros_like(param))

    def apply(self, grad, state, lr, step):
        m, u = state
        t = _f32(step) + 1.0
        m = self.beta1 * m + (1.0 - self.beta1) * grad
        u = torch.maximum(self.beta2 * u, torch.abs(grad))
        alpha = lr / (1.0 - torch.pow(_f32(self.beta1), t))
        return alpha * m / (u + self.epsilon), (m, u)


@serde.register
@dataclass
class AdaGrad(Updater):
    learning_rate: float = 1e-1
    epsilon: float = 1e-6

    def init_state(self, param):
        return torch.zeros_like(param)

    def apply(self, grad, h, lr, step):
        h = h + grad * grad
        return lr * grad / (torch.sqrt(h) + self.epsilon), h


@serde.register
@dataclass
class AdaDelta(Updater):
    """Ignores the learning rate, as the reference does."""

    rho: float = 0.95
    epsilon: float = 1e-6

    def init_state(self, param):
        return (torch.zeros_like(param), torch.zeros_like(param))

    def apply(self, grad, state, lr, step):
        eg, ex = state
        eg = self.rho * eg + (1.0 - self.rho) * grad * grad
        update = grad * torch.sqrt(ex + self.epsilon) / torch.sqrt(eg + self.epsilon)
        ex = self.rho * ex + (1.0 - self.rho) * update * update
        return update, (eg, ex)


@serde.register
@dataclass
class RmsProp(Updater):
    learning_rate: float = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def init_state(self, param):
        return torch.zeros_like(param)

    def apply(self, grad, g2, lr, step):
        g2 = self.rms_decay * g2 + (1.0 - self.rms_decay) * grad * grad
        return lr * grad / (torch.sqrt(g2) + self.epsilon), g2


# ---------------------------------------------------------------------------
# Gradient normalization (reference nn/conf/GradientNormalization.java,
# applied in BaseMultiLayerUpdater.preApply)
# ---------------------------------------------------------------------------


@serde.register
class GradientNormalization(enum.Enum):
    NONE = "none"
    RENORMALIZE_L2_PER_LAYER = "renormalize_l2_per_layer"
    RENORMALIZE_L2_PER_PARAM_TYPE = "renormalize_l2_per_param_type"
    CLIP_ELEMENT_WISE_ABSOLUTE_VALUE = "clip_element_wise_absolute_value"
    CLIP_L2_PER_LAYER = "clip_l2_per_layer"
    CLIP_L2_PER_PARAM_TYPE = "clip_l2_per_param_type"


# A leaf may be held in blocks (`parallel/mesh.py:ShardedLeaf`, a leaf that
# tensor parallelism cuts): a norm is taken over all its blocks, and the
# element-wise rest of a step (normalization's scaling, the updaters) runs
# block by block.

def leafwise(fn, leaf, *more):
    """`fn(leaf, *more)`; for a leaf held in blocks, `fn` of each block (and
    of `more`'s blocks), as a leaf held alike (a tuple of such leaves where
    `fn` returns a tuple)."""
    return fn(leaf, *more) if isinstance(leaf, Tensor) else leaf.map(fn, *more)


def _l2(g) -> Tensor:
    return torch.linalg.vector_norm(g) if isinstance(g, Tensor) else \
        torch.sqrt(g.sq_norm())


def _global_l2(tensors) -> Tensor:
    sq = [torch.sum(t.float() ** 2) if isinstance(t, Tensor) else t.sq_norm()
          for t in tensors]
    return torch.sqrt(sum(s.to(sq[0].device) for s in sq))


def _times(g, f: Tensor):
    return leafwise(lambda b: b * f.to(b.device), g)


def _clip_scale(norm: Tensor, threshold: float) -> Tensor:
    return torch.where(norm > threshold,
                       threshold / torch.clamp(norm, min=1e-8),
                       torch.ones_like(norm))


def normalize_layer_gradients(layer_grads: Dict[str, Tensor],
                              mode: GradientNormalization | None,
                              threshold: float = 1.0) -> Dict[str, Tensor]:
    """Apply one layer's gradient normalization to its dict of gradients,
    before the updater. A layer without parameters passes through."""
    if mode is None or mode == GradientNormalization.NONE or not layer_grads:
        return layer_grads
    G = GradientNormalization
    if mode == G.RENORMALIZE_L2_PER_LAYER:
        norm = torch.clamp(_global_l2(layer_grads.values()), min=1e-8)
        return {k: leafwise(lambda b: b / norm.to(b.device), g)
                for k, g in layer_grads.items()}
    if mode == G.RENORMALIZE_L2_PER_PARAM_TYPE:
        return {k: leafwise(lambda b, n=torch.clamp(_l2(g), min=1e-8):
                            b / n.to(b.device), g)
                for k, g in layer_grads.items()}
    if mode == G.CLIP_ELEMENT_WISE_ABSOLUTE_VALUE:
        return {k: leafwise(lambda b: torch.clamp(b, -threshold, threshold), g)
                for k, g in layer_grads.items()}
    if mode == G.CLIP_L2_PER_LAYER:
        scale = _clip_scale(_global_l2(layer_grads.values()), threshold)
        return {k: _times(g, scale) for k, g in layer_grads.items()}
    if mode == G.CLIP_L2_PER_PARAM_TYPE:
        return {k: _times(g, _clip_scale(_l2(g), threshold))
                for k, g in layer_grads.items()}
    raise ValueError(f"Unknown gradient normalization {mode}")
