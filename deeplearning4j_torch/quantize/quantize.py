"""Post-training quantization of inference parameter trees.

Port of `deeplearning4j_tpu/quantize/quantize.py`: per-output-channel int8
weights (Jacob et al., CVPR 2018) and a bfloat16 cast, behind one spec.

* ``quantize_tree(params, spec)`` / ``dequantize_tree(qparams)`` are pure
  functions over the port's tree (a tuple of per-layer dicts of tensors, or
  any nesting of dicts, lists and tuples). Training trees stay float32;
  quantization is a serving decision.
* int8 mode: a dict whose keys are within the dense ``W``/``b`` pair and
  whose ``W`` is a 2-D float tensor (DenseLayer, the output layers,
  EmbeddingLayer) gets symmetric per-output-channel int8:
  ``W_scale[n] = max_k |W[k, n]| / 127`` and ``W_q = round(W / W_scale)``,
  stored transposed and contiguous as int8 [n_out, n_in], each output
  channel one row, the layout the int8 kernel (ops/quant_matmul.py) reads.
  With ``spec.zero_point`` an int32 ``W_zp`` per channel makes it
  asymmetric. Every other float leaf of 2 or more dimensions (conv kernels,
  attention projections) is cast to bfloat16; biases and other 1-D leaves
  stay as they are.
* bf16 mode: every float leaf of 2 or more dimensions is cast to bfloat16.

Re-quantizing a quantized tree raises ``AlreadyQuantizedError``. The
forwards over quantized dicts are here too: ``dense_qforward`` quantizes
its input per row on the fly (no calibration) and runs the int8 product with
a float32 scale-and-bias epilogue; ``embedding_qlookup`` gathers int8 rows.

The float32 operations run in the JAX package's order (``amax / 127.0``,
``x / x_scale``, round half to even, clip to +-127, ``acc * (x_scale *
scale)``, then the bias), so on the CPU the port gives the JAX package's
values bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Union

import torch

from ..ops import quant_matmul as qmm

Tensor = torch.Tensor

__all__ = [
    "QuantSpec", "AlreadyQuantizedError", "MODES",
    "QUANT_WEIGHT", "QUANT_SCALE", "QUANT_ZERO",
    "quantize_tree", "dequantize_tree", "sidecar_scales",
    "tree_precision", "dense_qforward", "embedding_qlookup", "check_indices",
    "matmul_any",
]

#: reserved keys a quantized dense dict carries instead of ``W``
QUANT_WEIGHT = "W_q"
QUANT_SCALE = "W_scale"
QUANT_ZERO = "W_zp"

MODES = ("int8", "bf16")

_DENSE_KEYS = {"W", "b"}


class AlreadyQuantizedError(TypeError):
    """quantize_tree was given a tree that already holds quantized leaves:
    quantizing twice would stack scales (int8) or round twice (bfloat16), so
    it is an error, not a no-op."""


@dataclass(frozen=True)
class QuantSpec:
    """What to do to a parameter tree: ``mode`` is "int8" or "bf16";
    ``zero_point`` makes int8 asymmetric (an int32 zero point per
    channel)."""

    mode: str = "int8"
    zero_point: bool = False

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"QuantSpec.mode must be one of {MODES}, got {self.mode!r}")

    @staticmethod
    def coerce(spec: Union["QuantSpec", str]) -> "QuantSpec":
        if isinstance(spec, QuantSpec):
            return spec
        return QuantSpec(mode=str(spec))


def _is_float(leaf) -> bool:
    return isinstance(leaf, Tensor) and leaf.is_floating_point()


def _check_not_quantized(leaf) -> None:
    if isinstance(leaf, Tensor) and leaf.dtype in (torch.int8, torch.bfloat16):
        raise AlreadyQuantizedError(
            f"leaf dtype {leaf.dtype} is already quantized; dequantize_tree first")


def _quantize_dense(d: Dict[str, Tensor], spec: QuantSpec) -> Dict[str, Tensor]:
    w = d["W"]
    if spec.zero_point:
        wmax = torch.amax(w, dim=0)
        wmin = torch.amin(w, dim=0)
        span = torch.clamp_min(wmax - wmin, 1e-12)
        scale = (span / 254.0).to(torch.float32)
        # the middle of the range maps to q = 0; 254 codes cover the span,
        # so rounding never clips
        zp = torch.round((wmax + wmin) / (2.0 * scale)).to(torch.int32)
        q = torch.clamp(torch.round(w / scale) - zp, -127, 127)
        out = {QUANT_WEIGHT: q.to(torch.int8).T.contiguous(),
               QUANT_SCALE: scale, QUANT_ZERO: zp}
    else:
        amax = torch.amax(torch.abs(w), dim=0)
        scale = torch.where(amax > 0, amax / 127.0, 1.0).to(torch.float32)
        q = torch.clamp(torch.round(w / scale), -127, 127)
        out = {QUANT_WEIGHT: q.to(torch.int8).T.contiguous(), QUANT_SCALE: scale}
    if "b" in d:
        out["b"] = d["b"]
    return out


def quantize_tree(params, spec: Union[QuantSpec, str] = "int8"):
    """The tree quantized per ``spec``, as a new tree; the input is left as
    it was. Raises AlreadyQuantizedError on quantized material anywhere."""
    spec = QuantSpec.coerce(spec)

    def walk(node):
        if isinstance(node, dict):
            if QUANT_WEIGHT in node or QUANT_SCALE in node:
                raise AlreadyQuantizedError(
                    "tree already carries W_q/W_scale sidecar keys; "
                    "dequantize_tree first")
            if (spec.mode == "int8" and set(node) <= _DENSE_KEYS
                    and "W" in node and _is_float(node["W"])
                    and node["W"].ndim == 2):
                _check_not_quantized(node["W"])  # a bfloat16 W is float too
                return _quantize_dense(node, spec)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        _check_not_quantized(node)
        if _is_float(node) and node.ndim >= 2:
            return node.to(torch.bfloat16)
        return node

    return walk(params)


def dequantize_tree(qparams):
    """A float32 tree rebuilt from a quantized one: exact for bfloat16
    leaves, within scale / 2 of the original per element for int8."""

    def walk(node):
        if isinstance(node, dict):
            if QUANT_WEIGHT in node:
                q = node[QUANT_WEIGHT].to(torch.float32)
                if QUANT_ZERO in node:
                    q = q + node[QUANT_ZERO].to(torch.float32)[:, None]
                out = {"W": (q * node[QUANT_SCALE][:, None]).T.contiguous()}
                if "b" in node:
                    out["b"] = node["b"]
                return out
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if isinstance(node, Tensor) and node.dtype == torch.bfloat16:
            return node.to(torch.float32)
        return node

    return walk(qparams)


def sidecar_scales(qparams):
    """The scale and zero-point sidecar as its own tree: the same nesting,
    each quantized dict reduced to its W_scale (and W_zp), every other leaf
    None."""

    def walk(node):
        if isinstance(node, dict):
            if QUANT_WEIGHT in node:
                out = {QUANT_SCALE: node[QUANT_SCALE]}
                if QUANT_ZERO in node:
                    out[QUANT_ZERO] = node[QUANT_ZERO]
                return out
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return None

    return walk(qparams)


def _leaves(node) -> Iterator[Any]:
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _leaves(v)
    elif node is not None:
        yield node


def tree_precision(params) -> str:
    """'int8' if any leaf is int8, else 'bf16' if any is bfloat16, else
    'fp32': the serving precision of a tree."""
    has_bf16 = False
    for leaf in _leaves(params):
        dt = getattr(leaf, "dtype", None)
        if dt == torch.int8:
            return "int8"
        if dt == torch.bfloat16:
            has_bf16 = True
    return "bf16" if has_bf16 else "fp32"


# ---------------------------------------------------------------------------
# Forwards over quantized dicts (the layers branch on the dict's keys)
# ---------------------------------------------------------------------------

def matmul_any(x: Tensor, w: Tensor, b: Optional[Tensor] = None) -> Tensor:
    """x @ w (+ b) with a float32 epilogue for bfloat16 weights: x is cast
    to bfloat16 for the product, which returns float32 before the bias;
    other weights take the plain product. Integer features (kept integer
    by the networks' input cast, for embedding indices) are promoted to
    the weight's type first, as JAX's ``x @ w`` promotes them."""
    if not x.is_floating_point():
        x = x.to(w.dtype)
    if w.dtype == torch.bfloat16:
        y = torch.matmul(x.to(torch.bfloat16), w).to(torch.float32)
    else:
        y = torch.matmul(x, w)
    return y if b is None else y + b


def dense_qforward(params: Dict[str, Tensor], x: Tensor) -> Tensor:
    """Dense pre-activation from an int8 dict, for x [batch, n_in]:

        x_scale[b] = max_k |x[b, k]| / 127           (per row, on the fly)
        acc[b, n]  = sum_k x_q[b, k] W_q[n, k]       (exact int32, K6 on CUDA)
        out[b, n]  = acc x_scale[b] W_scale[n] + bias[n]

    With zero points, W[k, n] = (W_q[n, k] + zp[n]) W_scale[n] adds
    zp[n] sum_k x_q[b, k] to the integer sum. Raises on x that is not 2-D:
    the JAX package hands a 3-D x straight to its matmul, which then
    contracts the time axis (ROADMAP Queue C)."""
    if x.ndim != 2:
        raise ValueError(f"dense_qforward takes x [batch, n_in], got "
                         f"{tuple(x.shape)}")
    w_q = params[QUANT_WEIGHT]
    scale = params[QUANT_SCALE]
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    x_scale = torch.where(amax > 0, amax / 127.0, 1.0)
    x_q = torch.clamp(torch.round(x / x_scale), -127, 127).to(torch.int8)
    acc = qmm.quant_matmul(x_q, w_q)
    if QUANT_ZERO in params:
        rowsum = torch.sum(x_q.to(torch.int32), dim=-1, keepdim=True,
                           dtype=torch.int32)
        acc = acc + params[QUANT_ZERO][None, :] * rowsum
    out = acc.to(torch.float32) * (x_scale * scale[None, :])
    b = params.get("b")
    return out if b is None else out + b


def check_indices(idx: Tensor, n: int) -> None:
    """Raise IndexError unless every index lies in [-n, n), before a gather
    of a table of n rows. On a CUDA tensor an index out of range would trip
    a device-side assert in the gather, which leaves the process's CUDA
    context unusable: every later call would fail, not only this one."""
    if idx.numel():
        lo, hi = torch.stack(torch.aminmax(idx)).tolist()
        if lo < -n or hi >= n:
            raise IndexError(f"embedding index out of range [{-n}, {n}): "
                             f"min {lo}, max {hi}")


def embedding_qlookup(params: Dict[str, Tensor], idx: Tensor) -> Tensor:
    """Embedding rows [batch, n_out] from an int8 table for indices
    [batch]: gather columns of W_q [n_out, vocab], dequantize only those
    (per-channel scale), add the float32 bias. An index outside [-vocab,
    vocab) raises IndexError (`check_indices`)."""
    if idx.ndim != 1:
        raise ValueError(f"embedding_qlookup takes indices [batch], got "
                         f"{tuple(idx.shape)}")
    check_indices(idx, params[QUANT_WEIGHT].shape[1])
    cols = params[QUANT_WEIGHT][:, idx].to(torch.float32)
    if QUANT_ZERO in params:
        cols = cols + params[QUANT_ZERO].to(torch.float32)[:, None]
    out = (cols * params[QUANT_SCALE][:, None]).T
    b = params.get("b")
    return out if b is None else out + b
