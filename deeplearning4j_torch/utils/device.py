"""Where the port's entry points run.

Entry points (`MultiLayerNetwork.init`, `ZooModel.init`, `ParallelInference`
through the network it serves) run on the GPU unless the caller asks for the
CPU. With no GPU and no explicit ``device="cpu"`` they raise: a serving or
training run never drops quietly to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA device; a CUDA device without a
    usable GPU raises instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deeplearning4j_torch runs on CUDA by default, but no CUDA device "
            "is available; pass device='cpu' to run on the CPU")
    return dev


def canonical(device: DeviceLike) -> torch.device:
    """`device` with its index spelled out (``cuda`` is the current CUDA
    device), so two names of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def exact_float32(deterministic: bool = False) -> None:
    """Float32 computed in float32: TF32 off in cuDNN's convolutions and in
    CUDA products (cuDNN's default has it on), and bfloat16 products reduced
    in float32. With `deterministic`, cuDNN's deterministic algorithms too,
    so two runs of one computation round alike. Process-wide; for runs whose
    results are held to another's."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if deterministic:
        torch.backends.cudnn.deterministic = True
