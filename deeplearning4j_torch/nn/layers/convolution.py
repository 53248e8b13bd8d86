"""Convolutional layer family of the serving and training slices.

Port of `deeplearning4j_tpu/nn/layers/convolution.py`: ConvolutionLayer,
SubsamplingLayer, LocalResponseNormalization and GlobalPoolingLayer, with
the same config fields, the same output-size rule and the same explicit
SAME pads.

Layout: activations are NHWC at every layer boundary, as in the JAX package.
Inside a layer the tensor is viewed as channels-last NCHW
(``x.permute(0, 3, 1, 2)``), so cuDNN works on NHWC memory, and the kernels
are OIHW tensors in channels-last memory (see utils/params.py). Convs stay
cuDNN, as the JAX package leaves them to XLA; LRN runs the hand-written
kernels of ops/lrn.py on CUDA tensors, K1 forward and K2 backward.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ...ops import lrn as lrn_ops
from ...ops import pooling as pool_ops
from ...utils import serde
from ..conf.inputs import ConvolutionalType, FeedForwardType, RecurrentType
from .core import BIAS, WEIGHT, Layer, dropout


@serde.register
class ConvolutionMode(enum.Enum):
    """STRICT errors when sizes don't divide exactly; TRUNCATE floors; SAME
    pads to ceil(in/stride)."""

    STRICT = "strict"
    TRUNCATE = "truncate"
    SAME = "same"


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        if len(v) == 1:
            return (int(v[0]), int(v[0]))
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def conv_output_size(in_size: int, kernel: int, stride: int, pad: int,
                     mode: ConvolutionMode, dilation: int = 1) -> int:
    """Output spatial extent (reference ConvolutionUtils.getOutputSize)."""
    eff_k = kernel + (kernel - 1) * (dilation - 1)
    if mode == ConvolutionMode.SAME:
        return -(-in_size // stride)  # ceil
    out = (in_size + 2 * pad - eff_k) // stride + 1
    if mode == ConvolutionMode.STRICT and (in_size + 2 * pad - eff_k) % stride != 0:
        raise ValueError(
            f"ConvolutionMode.STRICT: (in={in_size} + 2*pad={pad} - k={eff_k}) "
            f"not divisible by stride={stride}; use TRUNCATE or SAME")
    return out


def _same_pads(in_size: int, kernel: int, stride: int, dilation: int = 1):
    """Explicit SAME padding (TF convention): (before, after), the extra
    cell going after when the total is odd."""
    eff_k = kernel + (kernel - 1) * (dilation - 1)
    out = -(-in_size // stride)
    total = max(0, (out - 1) * stride + eff_k - in_size)
    return (total // 2, total - total // 2)


@serde.register
@dataclass
class ConvolutionLayer(Layer):
    """2D convolution. Config kernel shape is HWIO [kh, kw, c_in, c_out] as
    in the JAX package; the port stores it as OIHW (utils/params.py)."""

    n_in: int = 0   # input channels
    n_out: int = 0  # output channels / filters
    kernel_size: Sequence[int] = (5, 5)
    stride: Sequence[int] = (1, 1)
    padding: Sequence[int] = (0, 0)
    dilation: Sequence[int] = (1, 1)
    convolution_mode: Optional[ConvolutionMode] = None  # None -> inherit/Truncate
    # Kept so configurations round-trip with the JAX package. cuDNN picks
    # its own algorithm, and the JAX package's space-to-depth stem is an
    # exact reparametrisation of the plain conv run here.
    cudnn_algo_mode: str = "PREFER_FASTEST"
    conv_algo: str = "auto"

    def input_kind(self):
        return "cnn"

    def _mode(self) -> ConvolutionMode:
        return self.convolution_mode or ConvolutionMode.TRUNCATE

    def set_input_type(self, input_type):
        if not isinstance(input_type, ConvolutionalType):
            raise ValueError(f"ConvolutionLayer needs CNN input, got {input_type}")
        if self.n_in == 0:
            self.n_in = input_type.channels
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        dh, dw = _pair(self.dilation)
        oh = conv_output_size(input_type.height, kh, sh, ph, self._mode(), dh)
        ow = conv_output_size(input_type.width, kw, sw, pw, self._mode(), dw)
        return ConvolutionalType(height=oh, width=ow, channels=self.n_out)

    def has_params(self):
        return True

    def init_params(self, gen, dtype=torch.float32):
        kh, kw = _pair(self.kernel_size)
        fan_in = self.n_in * kh * kw
        fan_out = self.n_out * kh * kw
        w = self._winit(gen, (self.n_out, self.n_in, kh, kw), fan_in, fan_out,
                        dtype)
        b = torch.full((self.n_out,), self.bias_init or 0.0, dtype=dtype)
        return {WEIGHT: w, BIAS: b}

    def _pads(self, x, w):
        sh, sw = _pair(self.stride)
        dh, dw = _pair(self.dilation)
        if self._mode() == ConvolutionMode.SAME:
            return (_same_pads(x.shape[1], w.shape[2], sh, dh),
                    _same_pads(x.shape[2], w.shape[3], sw, dw))
        ph, pw = _pair(self.padding)
        return ((ph, ph), (pw, pw))

    def forward(self, params, x, *, train=False, generator=None, mask=None):
        x = dropout(x, self.dropout_rate, train, generator)
        w = params[WEIGHT]
        (pt, pb), (pl, pr) = self._pads(x, w)
        xc = x.permute(0, 3, 1, 2)
        if pt == pb and pl == pr:
            pad = (pt, pl)
        else:  # SAME with a stride: asymmetric, so pad explicitly
            xc = F.pad(xc, (pl, pr, pt, pb))
            pad = (0, 0)
        conv = dict(stride=_pair(self.stride), padding=pad,
                    dilation=_pair(self.dilation))
        if w.dtype == torch.bfloat16:
            # bfloat16 kernels (quantize.quantize_tree): the conv runs in
            # bfloat16, its result goes to float32 before the bias, and the
            # layer returns x's type, as in the JAX package, so a float32
            # LRN after it still runs K1.
            out = F.conv2d(xc.to(torch.bfloat16), w, None, **conv)
            out = (out.permute(0, 2, 3, 1).float() + params[BIAS]).to(x.dtype)
        else:
            out = F.conv2d(xc, w, params[BIAS], **conv).permute(0, 2, 3, 1)
        return self._act()(out)


@serde.register
class PoolingType(enum.Enum):
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"


@serde.register
@dataclass
class SubsamplingLayer(Layer):
    """Spatial pooling (reference nn/conf/layers/SubsamplingLayer)."""

    kernel_size: Sequence[int] = (2, 2)
    stride: Sequence[int] = (2, 2)
    padding: Sequence[int] = (0, 0)
    pooling_type: PoolingType = PoolingType.MAX
    convolution_mode: Optional[ConvolutionMode] = None  # None -> inherit/Truncate
    pnorm: int = 2
    eps: float = 1e-8
    # The JAX package's backward-emitter knob. For MAX, "auto"/"sns" give
    # torch's first-maximum backward and "mask" raises (ops/pooling.py);
    # for the other types it only round-trips.
    pooling_impl: str = "auto"

    def input_kind(self):
        return "cnn"

    def _mode(self) -> ConvolutionMode:
        return self.convolution_mode or ConvolutionMode.TRUNCATE

    def set_input_type(self, input_type):
        if not isinstance(input_type, ConvolutionalType):
            raise ValueError(f"SubsamplingLayer needs CNN input, got {input_type}")
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        oh = conv_output_size(input_type.height, kh, sh, ph, self._mode())
        ow = conv_output_size(input_type.width, kw, sw, pw, self._mode())
        return ConvolutionalType(height=oh, width=ow, channels=input_type.channels)

    def forward(self, params, x, *, train=False, generator=None, mask=None):
        x = dropout(x, self.dropout_rate, train, generator)
        window = _pair(self.kernel_size)
        strides = _pair(self.stride)
        if self._mode() == ConvolutionMode.SAME:
            pads = (_same_pads(x.shape[1], window[0], strides[0]),
                    _same_pads(x.shape[2], window[1], strides[1]))
        else:
            ph, pw = _pair(self.padding)
            pads = ((ph, ph), (pw, pw))
        pt = self.pooling_type
        if pt == PoolingType.MAX:
            return pool_ops.max_pool(x, window, strides, pads,
                                     impl=self.pooling_impl)
        if pt == PoolingType.AVG:
            return pool_ops.avg_pool(x, window, strides, pads)
        if pt == PoolingType.SUM:
            return pool_ops.sum_pool(x, window, strides, pads)
        if pt == PoolingType.PNORM:
            p = float(self.pnorm)
            s = pool_ops.sum_pool(torch.abs(x) ** p, window, strides, pads)
            return (s + self.eps) ** (1.0 / p)
        raise ValueError(f"Unknown pooling type {pt}")


@serde.register
@dataclass
class LocalResponseNormalization(Layer):
    """Cross-channel LRN: out = x / (k + alpha * sum_{window} x^2)^beta.
    On a CUDA tensor it always runs the hand-written kernels (ops/lrn.py):
    K1 forward and, through `LRNFunction`, K2 for autograd's backward."""

    k: float = 2.0
    alpha: float = 1e-4
    beta: float = 0.75
    n: int = 5  # window size over channels

    def input_kind(self):
        return "cnn"

    # Kept only so configurations round-trip with the JAX package, where it
    # chooses between its Pallas kernel and XLA. The port has one path.
    use_pallas: bool = False

    def forward(self, params, x, *, train=False, generator=None, mask=None):
        return lrn_ops.lrn(x.contiguous(), self.k, self.alpha, self.beta,
                           self.n)


@serde.register
@dataclass
class GlobalPoolingLayer(Layer):
    """Global pooling over the spatial axes of NHWC input (CNN -> FF) or
    the time axis of [batch, time, features] input (RNN -> FF), masked
    time steps left out (reference nn/conf/layers/GlobalPoolingLayer and
    util/MaskedReductionUtil). As in the JAX package the output is always
    collapsed to [batch, features]; `collapse_dimensions` only
    round-trips."""

    pooling_type: PoolingType = PoolingType.MAX
    pnorm: int = 2
    collapse_dimensions: bool = True

    def input_kind(self):
        return "any"

    def set_input_type(self, input_type):
        if isinstance(input_type, ConvolutionalType):
            return FeedForwardType(size=input_type.channels)
        if isinstance(input_type, RecurrentType):
            return FeedForwardType(size=input_type.size)
        raise ValueError(f"GlobalPoolingLayer: unsupported {input_type}")

    def forward(self, params, x, *, train=False, generator=None, mask=None):
        if x.ndim == 4:      # NHWC: pool over H, W
            axes, m = (1, 2), None
        elif x.ndim == 3:    # [batch, time, features]: pool over time
            axes = (1,)
            m = None if mask is None else mask.to(x.dtype)[..., None]
        else:
            raise ValueError(f"GlobalPoolingLayer: rank {x.ndim} unsupported")
        pt = self.pooling_type
        if m is not None:
            if pt == PoolingType.MAX:
                x = torch.where(m > 0, x, torch.full_like(x, float("-inf")))
            else:
                x = x * m
        if pt == PoolingType.MAX:
            out = torch.amax(x, axes)
        elif pt == PoolingType.SUM:
            out = torch.sum(x, axes)
        elif pt == PoolingType.AVG:
            if m is not None:
                out = torch.sum(x, axes) / torch.clamp(torch.sum(m, axes), min=1e-8)
            else:
                out = torch.mean(x, axes)
        elif pt == PoolingType.PNORM:
            p = float(self.pnorm)
            out = torch.sum(torch.abs(x) ** p, axes) ** (1.0 / p)
        else:
            raise ValueError(f"Unknown pooling type {pt}")
        return self._act()(out)
