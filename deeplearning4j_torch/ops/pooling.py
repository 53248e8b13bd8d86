"""Spatial pooling over NHWC tensors with explicit pads, and its backward.

Port of `deeplearning4j_tpu/ops/pooling.py`. Pads are ((top, bottom),
(left, right)) and may be asymmetric (SAME with a stride), which torch's
symmetric ``padding=`` cannot express, so every pool pads explicitly with
``F.pad`` first: max pools pad with -inf (the JAX package's ``reduce_window``
init value), sums with 0. The backward is autograd's.

Max-pool tie rule: the backward of ``F.max_pool2d`` sends a window's whole
cotangent to its FIRST maximal element (row-major within the window). That
is the JAX package's ``impl="sns"`` rule (XLA's select-and-scatter, its TPU
default), NOT its CPU default ``"mask"``, which splits the cotangent equally
among tied maxima. The two agree wherever window maxima are unique. A layer
that asks for ``"mask"`` raises NotImplementedError until a later slice
ports it. Average pools have one backward whatever the JAX package's
"window"/"conv" emitter choice, which only changes how XLA lowers it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Pads2D = Tuple[Tuple[int, int], Tuple[int, int]]


def _nchw_padded(x: Tensor, pads: Pads2D, value: float) -> Tensor:
    """NHWC -> a channels-last NCHW view, padded on H and W."""
    (pt, pb), (pl, pr) = pads
    xc = x.permute(0, 3, 1, 2)
    if pt or pb or pl or pr:
        xc = F.pad(xc, (pl, pr, pt, pb), value=value)
    return xc


MAX_IMPLS = ("auto", "sns")


def max_pool(x: Tensor, window, strides, pads: Pads2D, *,
             impl: str = "auto") -> Tensor:
    """NHWC max pool; padding cells hold -inf so they never win. The
    backward follows the "sns" tie rule (module docstring); `impl` "auto"
    and "sns" both mean that, "mask" raises NotImplementedError."""
    if impl == "mask":
        raise NotImplementedError(
            "max_pool impl 'mask' (ties split equally in the backward) is not "
            "ported yet; use 'auto' or 'sns' (the first maximum takes all)")
    if impl not in MAX_IMPLS:
        raise ValueError(f"max_pool impl {impl!r} not in {MAX_IMPLS + ('mask',)}")
    y = F.max_pool2d(_nchw_padded(x, pads, float("-inf")), tuple(window),
                     tuple(strides))
    return y.permute(0, 2, 3, 1)


def sum_pool(x: Tensor, window, strides, pads: Pads2D) -> Tensor:
    """NHWC sum over each window, zero padding."""
    kh, kw = window
    y = F.avg_pool2d(_nchw_padded(x, pads, 0.0), (kh, kw), tuple(strides))
    return (y * float(kh * kw)).permute(0, 2, 3, 1)


def inbounds_count(x: Tensor, window, strides, pads: Pads2D) -> Tensor:
    """Per-output-window count of in-bounds input elements, [1, OH, OW, 1]
    (the count-exclude-pad divisor of the reference average pool)."""
    ones = torch.ones((1, x.shape[1], x.shape[2], 1), dtype=x.dtype,
                      device=x.device)
    return sum_pool(ones, window, strides, pads)


def avg_pool(x: Tensor, window, strides, pads: Pads2D) -> Tensor:
    """NHWC average pool, divisor counting in-bounds elements only."""
    return sum_pool(x, window, strides, pads) / inbounds_count(
        x, window, strides, pads)
