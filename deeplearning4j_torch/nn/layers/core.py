"""Core layer abstraction + feed-forward layers.

Port of `deeplearning4j_tpu/nn/layers/core.py`. As there, one dataclass per
layer carries both the serializable config (same fields, same registered
names) and the math:

    params = layer.init_params(gen, dtype)          # dict of named tensors
    state  = layer.init_state(dtype)                # dict, {} for most layers
    y      = layer.forward(params, x, train=..., generator=..., mask=...)
    y, new_state = layer.forward_with_state(params, state, x, train=..., ...)

A dense layer given a quantized dict (`quantize.quantize_tree`) takes the
int8 forward; an embedding layer, the int8 lookup.

Layer state (BatchNormalization's running mean and variance) is threaded
beside the parameters, as the JAX package's ``forward(params, state, x) ->
(y, new_state)`` threads it. Here the stateless signature stays the
layer's own `forward`, and the networks call `forward_with_state`, which
for a stateless layer is `forward` with the state passed through; only a
stateful layer overrides it. State tensors are never autograd leaves: they
are detached, live outside ``params_tree``, and no updater or
regularization sees them.

Parameters are drawn on the CPU from an explicit `torch.Generator`; the
network moves them to its device. Dropout follows the reference:
inverted, applied to the layer's INPUT, identity at inference; its mask is
drawn from a generator on the input's device (the network's own dropout
generator, MultiLayerNetwork.init). Every layer's forward takes the features
mask ([batch, time]) as `mask`, as in the JAX package; the layers that have
no use for it ignore it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ...ops import activations as act_ops
from ...ops import losses as loss_ops
from ...quantize import quantize as quantize_mod
from ...utils import serde
from .. import shards
from ..conf.inputs import FeedForwardType, InputType
from ..updaters import GradientNormalization, Updater
from ..weights import Distribution, WeightInit, init_weights

Tensor = torch.Tensor
Params = Dict[str, Tensor]
State = Dict[str, Tensor]

# Parameter-type tags (reference DefaultParamInitializer.WEIGHT_KEY/BIAS_KEY).
WEIGHT = "W"
BIAS = "b"


def dropout(x: Tensor, rate: Optional[float], train: bool,
            generator: Optional[torch.Generator]) -> Tensor:
    """Inverted dropout on layer input (reference util/Dropout.java). The
    generator must live on `x`'s device."""
    if not train or rate is None or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("Dropout requires a generator during training")
    if generator.device.type != x.device.type:
        raise ValueError(f"dropout on a {x.device} tensor needs a generator on "
                         f"that device, got one on {generator.device}")
    keep = 1.0 - rate
    mask = shards.dropout_keep_mask(x, keep, generator)
    return torch.where(mask, x / keep, torch.zeros_like(x))


@serde.register
@dataclass
class Layer:
    """Base config for all layers. Fields default to None = 'inherit the
    global default from NeuralNetConfiguration.Builder'."""

    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[WeightInit] = None
    dist: Optional[Distribution] = None
    bias_init: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    dropout_rate: Optional[float] = None
    updater: Optional[Updater] = None
    gradient_normalization: Optional[GradientNormalization] = None
    gradient_normalization_threshold: float = 1.0
    frozen: bool = False  # transfer-learning freeze (reference FrozenLayer)

    # ---- shape inference -------------------------------------------------
    def input_kind(self) -> str:
        """Expected input family: 'ff' | 'cnn' | 'rnn' | 'any'. Drives
        automatic preprocessor insertion."""
        return "ff"

    def set_input_type(self, input_type: InputType) -> InputType:
        """Bind input shape (infer n_in etc.); return this layer's output
        type."""
        return input_type

    # ---- layerwise pretraining (reference Layer.fit / pretrain) ----------
    def is_pretrainable(self) -> bool:
        """True for the unsupervised-pretrainable layers (AE, VAE, RBM)."""
        return False

    def pretrain_loss(self, params: Params, x: Tensor,
                      generator: Optional[torch.Generator] = None) -> Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} has no pretraining objective")

    def pretrain_grads(self, params: Params, x: Tensor,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[Tensor, Params]:
        """(loss, grads) of one pretrain step: by default one autograd
        backward of `pretrain_loss` (a parameter it does not reach gets
        zeros); RBM overrides it with CD-k statistics."""
        leaves = {k: t.detach().requires_grad_() for k, t in params.items()}
        with torch.enable_grad():
            loss = self.pretrain_loss(leaves, x, generator)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(t) if g is None else g
                               for (k, t), g in zip(leaves.items(), grads)}

    # ---- params ----------------------------------------------------------
    def init_params(self, gen: torch.Generator, dtype=torch.float32) -> Params:
        return {}

    def has_params(self) -> bool:
        return False

    def init_state(self, dtype=torch.float32) -> State:
        """Non-trainable layer state (running statistics), {} by default."""
        return {}

    def param_reg(self, pname: str) -> Tuple[float, float]:
        """(l1, l2) applied to the named parameter."""
        if pname == BIAS:
            return (self.l1_bias or 0.0, self.l2_bias or 0.0)
        if pname == WEIGHT:
            return (self.l1 or 0.0, self.l2 or 0.0)
        return (0.0, 0.0)

    # ---- forward ---------------------------------------------------------
    def forward(self, params: Params, x: Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                mask: Optional[Tensor] = None) -> Tensor:
        raise NotImplementedError

    def forward_with_state(self, params: Params, state: State, x: Tensor, *,
                           train: bool = False,
                           generator: Optional[torch.Generator] = None,
                           mask: Optional[Tensor] = None
                           ) -> Tuple[Tensor, State]:
        """(y, new state): the JAX package's forward. A stateless layer runs
        `forward` and hands its state back as it came."""
        return self.forward(params, x, train=train, generator=generator,
                            mask=mask), state

    # ---- helpers ---------------------------------------------------------
    def _act(self):
        return act_ops.resolve(self.activation)

    def is_output_layer(self) -> bool:
        return False

    def is_recurrent(self) -> bool:
        """True for a layer that keeps a streaming carry (the LSTMs)."""
        return False

    def supports_streaming(self) -> bool:
        """False for a layer that needs the whole sequence (the
        bidirectional LSTM, attention): `rnn_time_step` raises for it."""
        return True

    def _winit(self, gen, shape, fan_in, fan_out, dtype):
        return init_weights(gen, shape, fan_in, fan_out,
                            self.weight_init or WeightInit.XAVIER,
                            self.dist, dtype)


@serde.register
@dataclass
class DenseLayer(Layer):
    """Fully connected layer: z = xW + b, a = act(z). W is [n_in, n_out],
    the JAX package's layout."""

    n_in: int = 0
    n_out: int = 0

    def set_input_type(self, input_type):
        if isinstance(input_type, FeedForwardType):
            if self.n_in == 0:
                self.n_in = input_type.size
        else:
            raise ValueError(f"DenseLayer needs FeedForward input, got {input_type}")
        return FeedForwardType(size=self.n_out)

    def has_params(self):
        return True

    def init_params(self, gen, dtype=torch.float32):
        w = self._winit(gen, (self.n_in, self.n_out), self.n_in, self.n_out, dtype)
        b = torch.full((self.n_out,), self.bias_init or 0.0, dtype=dtype)
        return {WEIGHT: w, BIAS: b}

    def preout(self, params, x):
        # A serving tree may hold a quantized dict (W_q/W_scale in W's
        # place; quantize.quantize_tree): the int8 forward, K6 on CUDA.
        if quantize_mod.QUANT_WEIGHT in params:
            return quantize_mod.dense_qforward(params, x)
        return quantize_mod.matmul_any(x, params[WEIGHT], params[BIAS])

    def forward(self, params, x, *, train=False, generator=None, mask=None):
        x = dropout(x, self.dropout_rate, train, generator)
        return self._act()(self.preout(params, x))


@serde.register
@dataclass
class EmbeddingLayer(Layer):
    """Lookup layer: integer indices -> rows of W, plus b (reference
    nn/conf/layers/EmbeddingLayer). Input is [batch] or [batch, 1] indices
    (any numeric type, truncated to integers). A negative index in range
    wraps; one outside [-n_in, n_in) raises IndexError before the gather,
    on the CPU and on CUDA alike (`quantize.check_indices`). The JAX
    package's gather fills such a row with NaN instead."""

    n_in: int = 0  # vocabulary size
    n_out: int = 0

    def set_input_type(self, input_type):
        if isinstance(input_type, FeedForwardType) and self.n_in == 0:
            self.n_in = input_type.size
        return FeedForwardType(size=self.n_out)

    def has_params(self):
        return True

    def init_params(self, gen, dtype=torch.float32):
        w = self._winit(gen, (self.n_in, self.n_out), self.n_in, self.n_out, dtype)
        b = torch.full((self.n_out,), self.bias_init or 0.0, dtype=dtype)
        return {WEIGHT: w, BIAS: b}

    def forward(self, params, x, *, train=False, generator=None, mask=None):
        idx = x.to(torch.int64)
        if idx.ndim == 2 and idx.shape[-1] == 1:
            idx = idx[:, 0]
        if quantize_mod.QUANT_WEIGHT in params:
            out = quantize_mod.embedding_qlookup(params, idx)
        else:
            quantize_mod.check_indices(idx, params[WEIGHT].shape[0])
            out = params[WEIGHT][idx] + params[BIAS]
        return self._act()(out)


@serde.register
@dataclass
class ActivationLayer(Layer):
    """Pure activation (reference nn/conf/layers/ActivationLayer)."""

    def input_kind(self):
        return "any"

    def forward(self, params, x, *, train=False, generator=None, mask=None):
        return self._act()(x)


@serde.register
@dataclass
class DropoutLayer(Layer):
    """Standalone dropout (reference nn/conf/layers/DropoutLayer)."""

    def input_kind(self):
        return "any"

    def forward(self, params, x, *, train=False, generator=None, mask=None):
        return dropout(x, self.dropout_rate, train, generator)


@serde.register
@dataclass
class BaseOutputLayer(DenseLayer):
    """Dense + loss head (reference nn/conf/layers/BaseOutputLayer).
    `compute_score_array` is the per-example score; loss gradients come
    from autograd of `compute_score`."""

    loss: str = "mcxent"

    def is_output_layer(self):
        return True

    def compute_score(self, params, x, labels, mask=None) -> Tensor:
        return loss_ops.resolve(self.loss).score(
            labels, self.preout(params, x), self.activation or "identity", mask)

    def compute_score_array(self, params, x, labels, mask=None) -> Tensor:
        return loss_ops.resolve(self.loss).score_array(
            labels, self.preout(params, x), self.activation or "identity", mask)


@serde.register
@dataclass
class OutputLayer(BaseOutputLayer):
    pass


@serde.register
@dataclass
class LossLayer(Layer):
    """Parameterless loss head (reference nn/conf/layers/LossLayer): applies
    activation + loss to its input without a weight matrix."""

    loss: str = "mse"

    def input_kind(self):
        return "any"

    def is_output_layer(self):
        return True

    def forward(self, params, x, *, train=False, generator=None, mask=None):
        return self._act()(x)

    def compute_score(self, params, x, labels, mask=None):
        return loss_ops.resolve(self.loss).score(
            labels, x, self.activation or "identity", mask)

    def compute_score_array(self, params, x, labels, mask=None):
        return loss_ops.resolve(self.loss).score_array(
            labels, x, self.activation or "identity", mask)
