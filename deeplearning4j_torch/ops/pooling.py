"""Spatial pooling over NHWC tensors with explicit pads, and its backward.

Port of `deeplearning4j_tpu/ops/pooling.py`. Pads are ((top, bottom),
(left, right)) and may be asymmetric (SAME with a stride), which torch's
symmetric ``padding=`` cannot express, so every pool pads explicitly with
``F.pad`` first: max pools pad with -inf (the JAX package's ``reduce_window``
init value), sums with 0. The backward is autograd's.

Max-pool tie rules, the JAX package's two ``impl``s:

- ``"sns"`` (and ``"auto"``): the backward of ``F.max_pool2d`` sends a
  window's whole cotangent to its FIRST maximal element (row-major within
  the window), as XLA's select-and-scatter, the JAX package's TPU default.
- ``"mask"``: `MaxPoolMask`, the JAX package's ``_max_pool_mask``, splits
  a window's cotangent equally among its tied maxima, in plain torch ops
  (it is XLA, not Pallas, there), with the same padded extents and -inf
  fill. It is the JAX package's CPU default.

The two agree wherever window maxima are unique. The port's ``"auto"``
means ``"sns"`` on every device: the JAX package's per-backend rule
(``select_pooling_impl``) was measured on a TPU and a CPU rig. Average
pools have one backward whatever the JAX package's "window"/"conv" emitter
choice, which only changes how XLA lowers it.
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


MAX_IMPLS = ("auto", "sns", "mask")


def _max_pool_sns(x: Tensor, window, strides, pads: Pads2D) -> Tensor:
    y = F.max_pool2d(_nchw_padded(x, pads, float("-inf")), tuple(window),
                     tuple(strides))
    return y.permute(0, 2, 3, 1)


class MaxPoolMask(torch.autograd.Function):
    """NHWC max pool whose backward splits each window's cotangent equally
    among the window's maxima (JAX ``ops/pooling.py:_max_pool_mask``):

        dx = sum over window offsets (p, q) of
             place_pq(g * (x_pq == y) / ties)

    where x_pq is the strided view of the padded x at offset (p, q), aligned
    to the output grid, and ties counts the offsets equal to y. The
    offsets are summed in the JAX package's order."""

    @staticmethod
    def forward(ctx, x, window, strides, pads):
        y = _max_pool_sns(x, window, strides, pads)
        ctx.save_for_backward(x, y)
        ctx.geometry = (tuple(window), tuple(strides), pads)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        (kh, kw), (sh, sw), ((pt, pb), (pl, pr)) = ctx.geometry
        B, H, W, C = x.shape
        OH, OW = y.shape[1], y.shape[2]
        # the padded extents cover the furthest window, which can reach past
        # H + pt + pb when a truncating stride leaves the high pad short
        hp = max(H + pt + pb, (OH - 1) * sh + kh)
        wp = max(W + pl + pr, (OW - 1) * sw + kw)
        # -inf fill: a padding cell equals y only where the whole window is
        # padding, and its share lands in the margin sliced away below
        xp = F.pad(x, (0, 0, pl, wp - W - pl, pt, hp - H - pt),
                   value=float("-inf"))
        views = [(slice(p, p + (OH - 1) * sh + 1, sh),
                  slice(q, q + (OW - 1) * sw + 1, sw))
                 for p in range(kh) for q in range(kw)]
        eqs = [xp[:, vh, vw, :] == y for vh, vw in views]
        ties = eqs[0].to(g.dtype)
        for eq in eqs[1:]:
            ties = ties + eq.to(g.dtype)
        share = g / ties
        dxp = torch.zeros((B, hp, wp, C), dtype=g.dtype, device=g.device)
        for (vh, vw), eq in zip(views, eqs):
            dxp[:, vh, vw, :] += share * eq.to(g.dtype)
        return dxp[:, pt:pt + H, pl:pl + W, :].to(x.dtype), None, None, None


def max_pool(x: Tensor, window, strides, pads: Pads2D, *,
             impl: str = "auto") -> Tensor:
    """NHWC max pool; padding cells hold -inf so they never win. `impl`
    picks the backward's tie rule (module docstring): "auto" and "sns" the
    first maximum, "mask" an equal split among tied maxima."""
    if impl not in MAX_IMPLS:
        raise ValueError(f"max_pool impl {impl!r} not in {MAX_IMPLS}")
    if impl == "mask":
        return MaxPoolMask.apply(x, tuple(window), tuple(strides),
                                 (tuple(pads[0]), tuple(pads[1])))
    return _max_pool_sns(x, window, strides, pads)


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
