"""Graph vertices: the parameterless DAG building blocks of ComputationGraph.

Port of `deeplearning4j_tpu/nn/graph/vertices.py` (reference
nn/graph/vertex/impl/{MergeVertex, ElementWiseVertex, SubsetVertex,
StackVertex, UnstackVertex, ScaleVertex, ShiftVertex, PoolHelperVertex,
ReshapeVertex, L2NormalizeVertex, L2Vertex, PreprocessorVertex,
rnn/LastTimeStepVertex, rnn/DuplicateToTimeSeriesVertex}), registered under
the same names with the same fields, so a graph configuration's JSON loads
in either package.

A vertex is a function of its input activations,
``forward(inputs, train=..., generator=..., masks=...)``; autograd takes its
backward. The feature axis is last everywhere (NHWC, [batch, time,
features]), as in the JAX package, so merges and subsets work on axis -1
where the reference uses axis 1 of NCHW.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from ...utils import serde
from ..conf.inputs import (ConvolutionalType, FeedForwardType, InputPreProcessor,
                           InputType, RecurrentType)

Tensor = torch.Tensor


def _feature_size(t: InputType) -> int:
    if isinstance(t, (FeedForwardType, RecurrentType)):
        return t.size
    if isinstance(t, ConvolutionalType):
        return t.channels
    raise ValueError(f"No feature size for {t}")


def _with_feature_size(t: InputType, n: int) -> InputType:
    if isinstance(t, FeedForwardType):
        return FeedForwardType(size=n)
    if isinstance(t, RecurrentType):
        return RecurrentType(size=n, timeseries_length=t.timeseries_length)
    if isinstance(t, ConvolutionalType):
        return ConvolutionalType(height=t.height, width=t.width, channels=n)
    raise ValueError(f"Cannot set feature size on {t}")


@serde.register
@dataclass
class GraphVertex:
    """Parameterless vertex. Subclasses override forward/output_type."""

    def n_inputs(self) -> Optional[int]:
        return None  # None = any

    def forward(self, inputs: List[Tensor], *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                masks: Optional[List[Optional[Tensor]]] = None) -> Tensor:
        raise NotImplementedError

    def output_type(self, input_types: List[InputType]) -> InputType:
        raise NotImplementedError

    def output_mask(self, masks: List[Optional[Tensor]]) -> Optional[Tensor]:
        """The per-timestep mask of the output (reference
        GraphVertex.feedForwardMaskArrays): the first input's that has one."""
        for m in masks:
            if m is not None:
                return m
        return None


@serde.register
@dataclass
class MergeVertex(GraphVertex):
    """Concatenate along the feature axis (the channels of NHWC)."""

    def forward(self, inputs, *, train=False, generator=None, masks=None):
        return torch.cat(inputs, dim=-1)

    def output_type(self, input_types):
        return _with_feature_size(input_types[0],
                                  sum(_feature_size(t) for t in input_types))


@serde.register
@dataclass
class ElementWiseVertex(GraphVertex):
    """Elementwise add | subtract | product | average | max (reference
    ElementWiseVertex.Op)."""

    op: str = "add"

    def forward(self, inputs, *, train=False, generator=None, masks=None):
        op = self.op.lower()
        if op == "subtract":
            if len(inputs) != 2:
                raise ValueError("subtract needs exactly 2 inputs")
            return inputs[0] - inputs[1]
        out = inputs[0]
        for x in inputs[1:]:
            if op in ("add", "average"):
                out = out + x
            elif op == "product":
                out = out * x
            elif op == "max":
                out = torch.maximum(out, x)
            else:
                raise ValueError(f"Unknown ElementWiseVertex op {self.op!r}")
        if op == "average":
            out = out / len(inputs)
        return out

    def output_type(self, input_types):
        return input_types[0]


@serde.register
@dataclass
class SubsetVertex(GraphVertex):
    """Feature range [from_idx, to_idx], inclusive."""

    from_idx: int = 0
    to_idx: int = 0

    def forward(self, inputs, *, train=False, generator=None, masks=None):
        return inputs[0][..., self.from_idx:self.to_idx + 1]

    def output_type(self, input_types):
        return _with_feature_size(input_types[0], self.to_idx - self.from_idx + 1)


@serde.register
@dataclass
class StackVertex(GraphVertex):
    """Stack minibatches along the batch axis."""

    def forward(self, inputs, *, train=False, generator=None, masks=None):
        return torch.cat(inputs, dim=0)

    def output_type(self, input_types):
        return input_types[0]

    def output_mask(self, masks):
        if all(m is None for m in masks):
            return None
        if any(m is None for m in masks):
            raise ValueError("StackVertex: all or none of the inputs must "
                             "have masks")
        return torch.cat(masks, dim=0)


@serde.register
@dataclass
class UnstackVertex(GraphVertex):
    """The from_idx-th of stack_size equal batch slices."""

    from_idx: int = 0
    stack_size: int = 1

    def _slice(self, x):
        step = x.shape[0] // self.stack_size
        return x[self.from_idx * step:(self.from_idx + 1) * step]

    def forward(self, inputs, *, train=False, generator=None, masks=None):
        return self._slice(inputs[0])

    def output_type(self, input_types):
        return input_types[0]

    def output_mask(self, masks):
        return None if masks[0] is None else self._slice(masks[0])


@serde.register
@dataclass
class ScaleVertex(GraphVertex):
    scale_factor: float = 1.0

    def forward(self, inputs, *, train=False, generator=None, masks=None):
        return inputs[0] * self.scale_factor

    def output_type(self, input_types):
        return input_types[0]


@serde.register
@dataclass
class ShiftVertex(GraphVertex):
    shift_factor: float = 0.0

    def forward(self, inputs, *, train=False, generator=None, masks=None):
        return inputs[0] + self.shift_factor

    def output_type(self, input_types):
        return input_types[0]


@serde.register
@dataclass
class PoolHelperVertex(GraphVertex):
    """Drop the first spatial row and column of NHWC input (reference
    PoolHelperVertex: Caffe's ceil-mode pooling gives one leading row and
    column too many in imported GoogLeNet-style models)."""

    def forward(self, inputs, *, train=False, generator=None, masks=None):
        if len(inputs) != 1:
            raise ValueError("PoolHelperVertex requires a single input")
        return inputs[0][:, 1:, 1:, :]

    def output_type(self, input_types):
        t = input_types[0]
        if not isinstance(t, ConvolutionalType):
            raise ValueError(f"PoolHelperVertex needs CNN input, got {t}")
        return ConvolutionalType(height=t.height - 1, width=t.width - 1,
                                 channels=t.channels)


@serde.register
@dataclass
class ReshapeVertex(GraphVertex):
    """Reshape to [batch, *new_shape]."""

    new_shape: Sequence[int] = ()

    def forward(self, inputs, *, train=False, generator=None, masks=None):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.new_shape))

    def output_type(self, input_types):
        shape = tuple(self.new_shape)
        if len(shape) == 1:
            return FeedForwardType(size=shape[0])
        if len(shape) == 2:
            return RecurrentType(size=shape[1], timeseries_length=shape[0])
        if len(shape) == 3:
            return ConvolutionalType(height=shape[0], width=shape[1],
                                     channels=shape[2])
        raise ValueError(f"Unsupported reshape target {shape}")


@serde.register
@dataclass
class L2NormalizeVertex(GraphVertex):
    """x / ||x||_2 over all but the batch axis, the norm clipped below at
    eps."""

    eps: float = 1e-8

    def forward(self, inputs, *, train=False, generator=None, masks=None):
        x = inputs[0]
        norm = torch.sqrt(torch.sum((x * x).reshape(x.shape[0], -1), dim=-1))
        norm = torch.clamp(norm, min=self.eps)
        return x / norm.reshape((-1,) + (1,) * (x.ndim - 1))

    def output_type(self, input_types):
        return input_types[0]


@serde.register
@dataclass
class L2Vertex(GraphVertex):
    """Per-example L2 distance between two activations, [batch, 1]."""

    eps: float = 1e-8

    def forward(self, inputs, *, train=False, generator=None, masks=None):
        a, b = inputs
        d = (a - b).reshape(a.shape[0], -1)
        return torch.sqrt(torch.sum(d * d, dim=-1) + self.eps)[:, None]

    def output_type(self, input_types):
        return FeedForwardType(size=1)


@serde.register
@dataclass
class PreprocessorVertex(GraphVertex):
    """An InputPreProcessor as a vertex of its own."""

    preprocessor: Optional[InputPreProcessor] = None

    def forward(self, inputs, *, train=False, generator=None, masks=None):
        return self.preprocessor(inputs[0])

    def output_type(self, input_types):
        return self.preprocessor.output_type(input_types[0])


@serde.register
@dataclass
class LastTimeStepVertex(GraphVertex):
    """[b, t, f] -> [b, f] at each example's last unmasked step.
    `mask_input` names the network input whose mask applies (the graph's
    walk hands that mask over)."""

    mask_input: Optional[str] = None

    def forward(self, inputs, *, train=False, generator=None, masks=None):
        x = inputs[0]
        mask = masks[0] if masks else None
        if mask is None:
            return x[:, -1, :]
        # the last non-zero step of each row (interior gaps allowed)
        t = x.shape[1]
        idx = t - 1 - torch.argmax((torch.flip(mask, (1,)) > 0).to(torch.int32), dim=1)
        return torch.take_along_dim(x, idx[:, None, None], dim=1)[:, 0, :]

    def output_type(self, input_types):
        t = input_types[0]
        if not isinstance(t, RecurrentType):
            raise ValueError(f"LastTimeStepVertex needs RNN input, got {t}")
        return FeedForwardType(size=t.size)

    def output_mask(self, masks):
        return None  # no longer a time series


@serde.register
@dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """[b, f] -> [b, t, f] by repetition, t from the second input."""

    reference_input: Optional[str] = None
    timeseries_length: Optional[int] = None

    def forward(self, inputs, *, train=False, generator=None, masks=None):
        x, ref = inputs[0], inputs[1]
        return x[:, None, :].expand(x.shape[0], ref.shape[1], x.shape[1])

    def n_inputs(self):
        return 2

    def output_type(self, input_types):
        ref = input_types[1]
        tlen = ref.timeseries_length if isinstance(ref, RecurrentType) else None
        return RecurrentType(size=_feature_size(input_types[0]),
                             timeseries_length=tlen)
