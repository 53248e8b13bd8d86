"""Convolutional layer family.

Port of `deeplearning4j_tpu/nn/layers/convolution.py`: ConvolutionLayer,
Convolution1DLayer, SubsamplingLayer, Subsampling1DLayer, ZeroPaddingLayer,
BatchNormalization, LocalResponseNormalization and GlobalPoolingLayer, with
the same config fields, the same output-size rule and the same explicit
SAME pads. The 1-D layers view [batch, time, features] as NHWC
[batch, time, 1, features] and run their 2-D counterparts, as there.

BatchNormalization is the one stateful layer: its running mean and
variance (float32 whatever the network's type) travel in the state tree
through `forward_with_state` (nn/layers/core.py). It is plain torch ops,
not ``F.batch_norm``: the JAX package's statistics are single-pass and
pivoted on the running mean, and its running variance is the biased batch
variance, where cuDNN's is the unbiased one (n/(n-1) away on every step).

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
from .. import shards
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
        out = _conv_nhwc(x, w, params[BIAS], _pair(self.stride),
                         _pair(self.dilation), self._pads(x, w))
        return self._act()(out)


def _conv_nhwc(x, w, b, stride, dilation, pads):
    """NHWC conv of `x` with the OIHW kernel `w` plus bias `b`, explicit
    pads ((top, bottom), (left, right))."""
    (pt, pb), (pl, pr) = pads
    xc = x.permute(0, 3, 1, 2)
    if pt == pb and pl == pr:
        pad = (pt, pl)
    else:  # SAME with a stride: asymmetric, so pad explicitly
        xc = F.pad(xc, (pl, pr, pt, pb))
        pad = (0, 0)
    conv = dict(stride=stride, padding=pad, dilation=dilation)
    if w.dtype == torch.bfloat16:
        # bfloat16 kernels (quantize.quantize_tree, or a bfloat16 network):
        # the conv runs in bfloat16, its result goes to float32 before the
        # bias, and the layer returns x's type, as in the JAX package, so a
        # float32 LRN after it still runs K1.
        out = F.conv2d(xc.to(torch.bfloat16), w, None, **conv)
        return (out.permute(0, 2, 3, 1).float() + b).to(x.dtype)
    return F.conv2d(xc, w, b, **conv).permute(0, 2, 3, 1)


@serde.register
@dataclass
class Convolution1DLayer(ConvolutionLayer):
    """1D convolution over [batch, time, features] (reference
    nn/conf/layers/Convolution1DLayer). The JAX package's kernel is HWIO
    [k, 1, n_in, n_out]; the port stores OIHW [n_out, n_in, k, 1]."""

    kernel_size: Sequence[int] = (3,)
    stride: Sequence[int] = (1,)
    padding: Sequence[int] = (0,)
    dilation: Sequence[int] = (1,)

    def input_kind(self):
        return "rnn"

    def set_input_type(self, input_type):
        if not isinstance(input_type, RecurrentType):
            raise ValueError(f"Convolution1DLayer needs RNN input, got {input_type}")
        if self.n_in == 0:
            self.n_in = input_type.size
        k, s = _pair(self.kernel_size)[0], _pair(self.stride)[0]
        p, d = _pair(self.padding)[0], _pair(self.dilation)[0]
        t = input_type.timeseries_length
        out_t = None if t is None else conv_output_size(t, k, s, p, self._mode(), d)
        return RecurrentType(size=self.n_out, timeseries_length=out_t)

    def init_params(self, gen, dtype=torch.float32):
        k = _pair(self.kernel_size)[0]
        w = self._winit(gen, (self.n_out, self.n_in, k, 1), self.n_in * k,
                        self.n_out * k, dtype)
        b = torch.full((self.n_out,), self.bias_init or 0.0, dtype=dtype)
        return {WEIGHT: w, BIAS: b}

    def forward(self, params, x, *, train=False, generator=None, mask=None):
        x = dropout(x, self.dropout_rate, train, generator)
        w = params[WEIGHT]
        s, d = _pair(self.stride)[0], _pair(self.dilation)[0]
        if self._mode() == ConvolutionMode.SAME:
            pads = (_same_pads(x.shape[1], w.shape[2], s, d), (0, 0))
        else:
            p = _pair(self.padding)[0]
            pads = ((p, p), (0, 0))
        out = _conv_nhwc(x[:, :, None, :], w, params[BIAS], (s, 1), (d, 1), pads)
        return self._act()(out[:, :, 0, :])


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
    # torch's first-maximum backward and "mask" splits a window's cotangent
    # among its tied maxima (ops/pooling.py); for the other types it only
    # round-trips.
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
class Subsampling1DLayer(SubsamplingLayer):
    """1D pooling over [batch, time, features] (reference
    Subsampling1DLayer): the 2-D pool with a (k, 1) window."""

    kernel_size: Sequence[int] = (2,)
    stride: Sequence[int] = (2,)
    padding: Sequence[int] = (0,)

    def input_kind(self):
        return "rnn"

    def set_input_type(self, input_type):
        if not isinstance(input_type, RecurrentType):
            raise ValueError(f"Subsampling1DLayer needs RNN input, got {input_type}")
        k, s = _pair(self.kernel_size)[0], _pair(self.stride)[0]
        p = _pair(self.padding)[0]
        t = input_type.timeseries_length
        out_t = None if t is None else conv_output_size(t, k, s, p, self._mode())
        return RecurrentType(size=input_type.size, timeseries_length=out_t)

    def forward(self, params, x, *, train=False, generator=None, mask=None):
        layer2d = SubsamplingLayer(
            kernel_size=(_pair(self.kernel_size)[0], 1),
            stride=(_pair(self.stride)[0], 1),
            padding=(_pair(self.padding)[0], 0),
            pooling_type=self.pooling_type, convolution_mode=self._mode(),
            pnorm=self.pnorm, eps=self.eps, dropout_rate=self.dropout_rate,
            pooling_impl=self.pooling_impl)
        out = layer2d.forward(params, x[:, :, None, :], train=train,
                              generator=generator, mask=mask)
        return out[:, :, 0, :]


@serde.register
@dataclass
class ZeroPaddingLayer(Layer):
    """Spatial zero padding of NHWC input (reference
    nn/conf/layers/ZeroPaddingLayer): (top=bottom, left=right) or (top,
    bottom, left, right)."""

    padding: Sequence[int] = (1, 1)

    def input_kind(self):
        return "cnn"

    def _pads(self):
        p = list(self.padding)
        if len(p) == 2:
            return (p[0], p[0], p[1], p[1])
        if len(p) == 4:
            return tuple(p)
        raise ValueError("padding must be 2 or 4 ints")

    def set_input_type(self, input_type):
        if not isinstance(input_type, ConvolutionalType):
            raise ValueError(f"ZeroPaddingLayer needs CNN input, got {input_type}")
        t, b, l, r = self._pads()
        return ConvolutionalType(height=input_type.height + t + b,
                                 width=input_type.width + l + r,
                                 channels=input_type.channels)

    def forward(self, params, x, *, train=False, generator=None, mask=None):
        t, b, l, r = self._pads()
        return F.pad(x, (0, 0, l, r, t, b))


@serde.register
@dataclass
class BatchNormalization(Layer):
    """Batch normalization over the last axis (channels of NHWC input, the
    features of FF or RNN input; reference nn/conf/layers/BatchNormalization).
    Training normalizes by the batch's statistics and moves the running
    ones, ``running = decay * running + (1 - decay) * batch``; evaluation
    normalizes by the running ones and leaves them as they are."""

    n_out: int = 0  # feature count, inferred
    decay: float = 0.9
    eps: float = 1e-5
    gamma_init: float = 1.0
    beta_init: float = 0.0
    lock_gamma_beta: bool = False

    def input_kind(self):
        return "any"

    def set_input_type(self, input_type):
        if isinstance(input_type, ConvolutionalType):
            self.n_out = input_type.channels
        elif isinstance(input_type, (FeedForwardType, RecurrentType)):
            self.n_out = input_type.size
        else:
            raise ValueError(f"BatchNormalization: unsupported {input_type}")
        return input_type

    def has_params(self):
        return not self.lock_gamma_beta

    def init_params(self, gen, dtype=torch.float32):
        if self.lock_gamma_beta:
            return {}
        return {"gamma": torch.full((self.n_out,), self.gamma_init, dtype=dtype),
                "beta": torch.full((self.n_out,), self.beta_init, dtype=dtype)}

    def init_state(self, dtype=torch.float32):
        # float32 in a bfloat16 network too, as the JAX package keeps it
        return {"mean": torch.zeros((self.n_out,), dtype=torch.float32),
                "var": torch.ones((self.n_out,), dtype=torch.float32)}

    def param_reg(self, pname):
        return (0.0, 0.0)  # reference: no l1/l2 on gamma/beta

    def forward(self, params, x, *, train=False, generator=None, mask=None):
        raise TypeError("BatchNormalization keeps running statistics: call "
                        "forward_with_state(params, state, x, ...)")

    def forward_with_state(self, params, state, x, *, train=False,
                           generator=None, mask=None):
        x = dropout(x, self.dropout_rate, train, generator)
        axes = tuple(range(x.ndim - 1))  # all but the feature axis
        if train:
            # The JAX package's single-pass statistics, pivoted on the
            # running mean (which bounds the float32 cancellation of
            # E[x^2] - E[x]^2 once the running mean has converged).
            pivot = state["mean"]
            xc = x.float() - pivot
            mean_c, sq = shards.batch_moments(xc, axes)
            var = torch.clamp_min(sq - mean_c * mean_c, 0.0)
            mean = mean_c + pivot
            with torch.no_grad():
                new_state = {
                    "mean": self.decay * state["mean"] + (1 - self.decay) * mean,
                    "var": self.decay * state["var"] + (1 - self.decay) * var}
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        out = (x - mean) * torch.rsqrt(var + self.eps)
        if not self.lock_gamma_beta:
            out = out * params["gamma"] + params["beta"]
        return self._act()(out.to(x.dtype)), new_state


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
