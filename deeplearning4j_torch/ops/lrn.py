"""Cross-channel local response normalization over NHWC tensors.

Port of `deeplearning4j_tpu/ops/pallas_kernels.py` (`lrn` with its custom
VJP: `_lrn_kernel` forward, `_lrn_bwd_kernel` backward, and `lrn_reference`
as the plain version):

    y_c  = x_c d_c^-beta,   d_c = k + alpha * sum_{j=c-n//2}^{c+n-1-n//2} x_j^2
    dx_i = g_i d_i^-beta - 2 alpha beta x_i sum_{c in N*(i)} g_c x_c d_c^(-beta-1)

with channels outside [0, C) counted as zero and N*(i) the transposed window
(c is in it iff i is in c's window). `lrn` is differentiable through
`LRNFunction`, which saves only `x` and recomputes `d` in the backward, as
the JAX package's backward kernel does.

On a CUDA tensor the forward launches the hand-written kernel K1 and the
backward K2, both in ``csrc/lrn.cu`` (float32 and bfloat16, sm_90a; see the
note there for what bounds them and how they are laid out). On a CPU tensor
they compute `lrn_reference` and `lrn_bwd_reference`, in the tensor's own
type. There is no fallback from one to the other: a CUDA tensor the kernels
do not take (float16, float64) raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import cuda_build

Tensor = torch.Tensor

#: Largest channel count the kernels take: K2 stages tiles of 8 KiB of x in
#: shared memory, 2048 // C rows in float32 and 4096 // C in bfloat16.
MAX_CHANNELS = 2048

#: The element types the kernels take. Both compute in float32 registers; a
#: bfloat16 result is rounded once, on its store.
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

#: Kernel launches made in this process: `launches` counts the forward
#: kernel (K1), `bwd_launches` the backward kernel (K2). Tests and the chip
#: smoke reset them to 0 and read them to show a path ran through the kernels.
launches = 0
bwd_launches = 0
_launches_lock = threading.Lock()


_fns = {}


def _kernel_fn(name: str):
    """A C entry point of ``csrc/lrn.cu`` (``dl4j_lrn_fwd`` or
    ``dl4j_lrn_bwd``), built and typed at first use. Both take the element
    type as their last argument before the stream: 1 for bfloat16, 0 for
    float32."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(cuda_build.load("lrn"), name)
        ptrs = 2 if name == "dl4j_lrn_fwd" else 3
        fn.argtypes = [ctypes.c_void_p] * ptrs + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def window_sum(a: Tensor, left: int, right: int) -> Tensor:
    """out[..., c] = sum(a[..., c-left : c+right+1]), zero outside [0, C)."""
    return F.pad(a, (left, right)).unfold(-1, left + right + 1, 1).sum(-1)


def lrn_reference(x: Tensor, k: float, alpha: float, beta: float,
                  n: int) -> Tensor:
    """Plain torch LRN over the last axis: squares, zero-padded window sum,
    then x / d^beta, op by op in x's type, as the JAX package's
    `lrn_reference` does. The CPU path and the forward kernel's yardstick on
    the card, where a bfloat16 kernel is held to it in float32 on the upcast
    input, rounded once."""
    up = n // 2
    return x / torch.pow(k + alpha * window_sum(x * x, up, n - 1 - up), beta)


def lrn_bwd_reference(x: Tensor, g: Tensor, k: float, alpha: float,
                      beta: float, n: int) -> Tensor:
    """Plain torch LRN backward, the formula of the JAX package's
    `_lrn_bwd_kernel`, op by op in x's type. The CPU path and the backward
    kernel's yardstick on the card (in float32 for a bfloat16 kernel, as
    for the forward)."""
    up = n // 2
    down = n - 1 - up
    d = k + alpha * window_sum(x * x, up, down)
    p = torch.pow(d, -beta)
    u = window_sum(g * x * p / d, down, up)  # the transposed window
    return g * p - 2.0 * alpha * beta * x * u


def _check_kernel_input(name: str, t: Tensor) -> int:
    if t.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} kernel needs a contiguous NHWC tensor")
    c = t.shape[-1]
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"{name} kernel takes 1..{MAX_CHANNELS} channels, got {c}")
    return c


def _launch_kernel(x: Tensor, k: float, alpha: float, beta: float,
                   n: int) -> Tensor:
    global launches
    c = _check_kernel_input("lrn", x)
    y = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return y
    fn = _kernel_fn("dl4j_lrn_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), rows, c, float(k), float(alpha),
                 float(beta), int(n), int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"lrn kernel launch failed: CUDA error {err}")
    with _launches_lock:
        launches += 1
    return y


def _launch_bwd_kernel(x: Tensor, g: Tensor, k: float, alpha: float,
                       beta: float, n: int) -> Tensor:
    global bwd_launches
    c = _check_kernel_input("lrn backward", x)
    _check_kernel_input("lrn backward", g)
    if g.shape != x.shape or g.device != x.device or g.dtype != x.dtype:
        raise ValueError(f"lrn backward: cotangent {tuple(g.shape)} {g.dtype} "
                         f"on {g.device} does not match x {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    dx = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return dx
    fn = _kernel_fn("dl4j_lrn_bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), dx.data_ptr(), rows, c, float(k),
                 float(alpha), float(beta), int(n), int(x.dtype == torch.bfloat16),
                 stream)
    if err != 0:
        raise RuntimeError(f"lrn backward kernel launch failed: CUDA error {err}")
    with _launches_lock:
        bwd_launches += 1
    return dx


def _check_device(x: Tensor):
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"lrn runs on cuda or cpu tensors, got {x.device}")


def lrn_fwd(x: Tensor, k: float, alpha: float, beta: float, n: int) -> Tensor:
    """The forward without autograd: K1 for a CUDA tensor, `lrn_reference`
    for a CPU tensor."""
    _check_device(x)
    if x.device.type == "cuda":
        return _launch_kernel(x, k, alpha, beta, n)
    return lrn_reference(x, k, alpha, beta, n)


def lrn_bwd(x: Tensor, g: Tensor, k: float, alpha: float, beta: float,
            n: int) -> Tensor:
    """dL/dx from x and the cotangent g: K2 for CUDA tensors,
    `lrn_bwd_reference` for CPU tensors. A cotangent that is not contiguous
    (autograd may hand one over as a strided view) is copied first."""
    _check_device(x)
    if x.device.type == "cuda":
        return _launch_bwd_kernel(x, g.contiguous(), k, alpha, beta, n)
    return lrn_bwd_reference(x, g, k, alpha, beta, n)


class LRNFunction(torch.autograd.Function):
    """LRN with its backward: saves only `x`; forward and backward dispatch
    on the device through `lrn_fwd` and `lrn_bwd`."""

    @staticmethod
    def forward(ctx, x, k, alpha, beta, n):
        ctx.save_for_backward(x)
        ctx.hyper = (k, alpha, beta, n)
        return lrn_fwd(x, k, alpha, beta, n)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return (lrn_bwd(x, g, *ctx.hyper), None, None, None, None)


def lrn(x: Tensor, k: float = 2.0, alpha: float = 1e-4, beta: float = 0.75,
        n: int = 5) -> Tensor:
    """Differentiable LRN over the channel (last) axis of an NHWC tensor:
    the CUDA kernels for a CUDA tensor, the plain versions for a CPU one."""
    if int(n) < 1:
        raise ValueError(f"lrn window n must be >= 1, got {n}")
    return LRNFunction.apply(x, float(k), float(alpha), float(beta), int(n))
