"""Batch padding rules shared by the serving engine.

Port of `next_pow2_bucket` and `repeat_tail_rows` from
`deeplearning4j_tpu/data/padding.py`. In the port a bucket is no longer a
compile boundary (torch runs eagerly), but it is still the set of batch
sizes the server warms (cuDNN picks its algorithms per shape) and the unit
of its launch accounting.
"""
from __future__ import annotations

import numpy as np
import torch


def next_pow2_bucket(n: int) -> int:
    """Smallest power of two >= n: the canonical batch bucket."""
    if n < 1:
        raise ValueError(f"bucket size needs n >= 1, got {n}")
    return 1 << (int(n) - 1).bit_length()


def repeat_tail_rows(a, pad: int):
    """Append `pad` copies of the last row (None-safe). Tensors pad with
    torch ops on their own device; host arrays stay numpy."""
    if a is None or pad == 0:
        return a
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))], 0)
    a = np.asarray(a)
    return np.concatenate(
        [a, np.broadcast_to(a[-1:], (pad,) + a.shape[1:])], 0)
