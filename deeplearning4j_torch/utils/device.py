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
