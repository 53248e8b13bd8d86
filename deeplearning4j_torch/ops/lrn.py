"""Cross-channel local response normalization over NHWC tensors.

Port of the forward half of `deeplearning4j_tpu/ops/pallas_kernels.py`
(`lrn` / `_lrn_kernel`, and `lrn_reference` as the plain version):

    y_c = x_c / (k + alpha * sum_{j=c-n//2}^{c+n-1-n//2} x_j^2)^beta

with channels outside [0, C) counted as zero. On a CUDA tensor `lrn`
launches the hand-written kernel in ``csrc/lrn.cu`` (float32, sm_90a; see
the note there for what bounds it and how it is laid out). On a CPU tensor
it computes `lrn_reference`. There is no fallback from one to the other: a
CUDA tensor the kernel does not take raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from . import cuda_build

Tensor = torch.Tensor

#: Largest channel count the kernel stages in shared memory (8 rows of
#: MAX_CHANNELS float32 per block = 64 KiB).
MAX_CHANNELS = 2048

#: Kernel launches made by `lrn` in this process. Tests and the chip smoke
#: reset it to 0 and read it to show a path ran through the kernel.
launches = 0
_launches_lock = threading.Lock()


_fn = None


def _kernel_fn():
    """The C entry point of ``csrc/lrn.cu``, built and typed at first use."""
    global _fn
    if _fn is None:
        fn = cuda_build.load("lrn").dl4j_lrn_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_float, ctypes.c_float,
                       ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def lrn_reference(x: Tensor, k: float, alpha: float, beta: float,
                  n: int) -> Tensor:
    """Plain torch LRN over the last axis: squares, zero-padded window sum,
    pow. The CPU path and the kernel's yardstick on the card."""
    up = n // 2
    sq = F.pad(x * x, (up, n - 1 - up))
    s = sq.unfold(-1, n, 1).sum(-1)
    return x / torch.pow(k + alpha * s, beta)


def _launch_kernel(x: Tensor, k: float, alpha: float, beta: float,
                   n: int) -> Tensor:
    global launches
    if x.dtype != torch.float32:
        raise TypeError(f"lrn kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("lrn kernel needs a contiguous NHWC tensor")
    c = x.shape[-1]
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"lrn kernel takes 1..{MAX_CHANNELS} channels, got {c}")
    y = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return y
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), rows, c, float(k), float(alpha),
                 float(beta), int(n), stream)
    if err != 0:
        raise RuntimeError(f"lrn kernel launch failed: CUDA error {err}")
    with _launches_lock:
        launches += 1
    return y


def lrn(x: Tensor, k: float = 2.0, alpha: float = 1e-4, beta: float = 0.75,
        n: int = 5) -> Tensor:
    """LRN over the channel (last) axis of an NHWC tensor: the CUDA kernel
    for a CUDA tensor, `lrn_reference` for a CPU tensor."""
    if int(n) < 1:
        raise ValueError(f"lrn window n must be >= 1, got {n}")
    if x.device.type == "cuda":
        return _launch_kernel(x, k, alpha, beta, int(n))
    if x.device.type == "cpu":
        return lrn_reference(x, k, alpha, beta, int(n))
    raise ValueError(f"lrn runs on cuda or cpu tensors, got {x.device}")
