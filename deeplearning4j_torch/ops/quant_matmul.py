"""The int8 matrix product of the quantized serving path.

Port of the int8 section of `deeplearning4j_tpu/ops/pallas_kernels.py`
(`quant_matmul`, `int8_matmul_pallas` with its `_int8_matmul_kernel`, and
the numpy s32 product as the plain version). The contract is the JAX
package's:

    s8[B, K] x s8[N, K] -> s32[B, N],   out[b, n] = sum_k x[b, k] w[n, k]

exact, weights transposed so that each output channel is one contiguous row
(the layout `quantize_tree` stores as ``W_q``). Any B, K, N >= 1; -128 is
allowed. K is at most MAX_K, so that no sum can leave int32.

On a CUDA tensor `quant_matmul` launches the hand-written kernel K6
(``csrc/int8_matmul.cu``, sm_90a; see the note there for what bounds it and
how it is laid out). On a CPU tensor it computes `int8_matmul_reference`.
There is no fallback from one to the other: a CUDA tensor the kernel does not
take raises. The JAX package picks among three arms by a timed probe
(`select_quant_impl`, overridable by ``DL4JTPU_QUANT_MATMUL``); the port has
one arm per device and measures nothing at run time, so no probe can route
the card's work away from the kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build

Tensor = torch.Tensor

#: Largest contraction length: K * 128 * 128 must stay under 2**31, so that
#: the int32 sums (and the plain version's float64 ones) are exact.
MAX_K = (2 ** 31 - 1) // (128 * 128)

#: K6 launches made in this process. Tests and the chip smoke reset it to 0
#: and read it to show a path ran through the kernel.
launches = 0
_launches_lock = threading.Lock()

_fn = None


def _kernel_fn():
    """``dl4j_int8_matmul`` of ``csrc/int8_matmul.cu``, built and typed at
    first use."""
    global _fn
    if _fn is None:
        fn = cuda_build.load("int8_matmul").dl4j_int8_matmul
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x_q: Tensor, w_q: Tensor) -> None:
    """Raise on anything the contract does not take."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8 matmul takes int8 x and w, got {x_q.dtype} "
                        f"and {w_q.dtype}")
    if x_q.ndim != 2 or w_q.ndim != 2:
        raise ValueError(f"int8 matmul takes x [B, K] and w [N, K], got "
                         f"{tuple(x_q.shape)} and {tuple(w_q.shape)}")
    if x_q.shape[1] != w_q.shape[1]:
        raise ValueError(f"int8 matmul: x {tuple(x_q.shape)} and w "
                         f"{tuple(w_q.shape)} differ in K")
    if min(*x_q.shape, w_q.shape[0]) < 1 or x_q.shape[1] > MAX_K:
        raise ValueError(f"int8 matmul takes B, N >= 1 and 1 <= K <= {MAX_K}, "
                         f"got x {tuple(x_q.shape)}, w {tuple(w_q.shape)}")
    if not (x_q.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("int8 matmul takes contiguous x and w (a transposed "
                         "view of W_q is not one)")
    if x_q.device != w_q.device:
        raise ValueError(f"int8 matmul: x on {x_q.device}, w on {w_q.device}")


def int8_matmul_reference(x_q: Tensor, w_q: Tensor) -> Tensor:
    """The plain version, on either device: int32 sums on the CPU (an int8
    product would come back int8 and wrap); float64 on the card, which has no
    int32 matmul and is exact there, since |sum| <= K 128^2 < 2^53."""
    if x_q.device.type == "cpu":
        return x_q.int() @ w_q.int().T
    return (x_q.double() @ w_q.double().T).int()


def int8_matmul(x_q: Tensor, w_q: Tensor) -> Tensor:
    """K6 on CUDA tensors: the int32 product, written to a new tensor."""
    global launches
    _check(x_q, w_q)
    if x_q.device.type != "cuda":
        raise ValueError(f"the int8 kernel runs on CUDA tensors, got {x_q.device}")
    b, k = x_q.shape
    n = w_q.shape[0]
    out = torch.empty((b, n), dtype=torch.int32, device=x_q.device)
    fn = _kernel_fn()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        err = fn(x_q.data_ptr(), w_q.data_ptr(), out.data_ptr(), b, k, n, stream)
    if err != 0:
        raise RuntimeError(f"int8 matmul kernel launch failed: CUDA error {err}")
    with _launches_lock:
        launches += 1
    return out


def quant_matmul(x_q: Tensor, w_q: Tensor) -> Tensor:
    """s8[B, K] x s8[N, K] -> s32[B, N]: K6 for CUDA tensors,
    `int8_matmul_reference` for CPU tensors."""
    if x_q.device.type == "cuda":
        return int8_matmul(x_q, w_q)
    _check(x_q, w_q)
    if x_q.device.type == "cpu":
        return int8_matmul_reference(x_q, w_q)
    raise ValueError(f"int8 matmul runs on cuda or cpu tensors, got {x_q.device}")
