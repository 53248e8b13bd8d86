"""Parameter trees carried between the JAX package and the port.

The JAX package keeps a network's parameters as a tuple of per-layer dicts
(``params_tree``) with HWIO convolution kernels and ``[n_in, n_out]`` dense
weights, NHWC being its layout (docs/design.md §7). The port stores
convolution kernels as OIHW in channels-last memory, which is what
``F.conv2d`` hands to cuDNN for NHWC activations, and keeps dense weights as
``[n_in, n_out]``. This module is the only place that knows the difference;
the round trip is bitwise (a permutation moves no bits). Optimizer state
(``opt_state``: one dict per layer, parameter name -> ``()``, one array, or a
tuple of arrays shaped like the parameter) follows the same rule.

Quantized trees (``quantize/quantize.py``) carry across too: int8 ``W_q``
[n_out, n_in], float32 ``W_scale``, int32 ``W_zp`` (all 1-D or 2-D, so never
permuted) and bfloat16 leaves, 4-D conv kernels among them. numpy has no
bfloat16 of its own: the JAX package's arrays arrive with the ``bfloat16``
dtype of ``ml_dtypes``, which ``torch.from_numpy`` refuses, so their bits are
carried as uint16 (this module does not import ``ml_dtypes``). On the way
back bfloat16 leaves become float32 numpy arrays, which holds every bfloat16
value exactly; a caller casts them back with its own bfloat16 type.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device


def place(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One port-layout parameter on `device`: OIHW kernels in channels-last
    memory, everything else contiguous."""
    t = t.to(device)
    if t.ndim == 4:
        return t.contiguous(memory_format=torch.channels_last)
    return t.contiguous()


def _to_port(a: np.ndarray, device: torch.device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16), copy=True)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if t.ndim == 4:  # HWIO -> OIHW
        t = t.permute(3, 2, 0, 1)
    return place(t, device)


def _to_reference(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    if t.ndim == 4:  # OIHW -> HWIO
        t = t.permute(2, 3, 1, 0)
    return t.contiguous().numpy().copy()


def params_from_numpy(tree: Sequence[Dict[str, Any]],
                      device: DeviceLike = None) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Reference ``params_tree`` (numpy or any array convertible by
    ``np.asarray``) -> the port's per-layer dicts of tensors on `device`."""
    dev = resolve_device(device)
    return tuple({name: _to_port(np.asarray(a), dev) for name, a in layer.items()}
                 for layer in tree)


def params_to_numpy(tree: Sequence[Dict[str, torch.Tensor]]
                    ) -> Tuple[Dict[str, np.ndarray], ...]:
    """Inverse of :func:`params_from_numpy`: the reference's layout, numpy."""
    return tuple({name: _to_reference(t) for name, t in layer.items()}
                 for layer in tree)


def _map_state(s, fn):
    return tuple(fn(a) for a in s) if isinstance(s, (tuple, list)) else fn(s)


def opt_state_from_numpy(tree: Sequence[Dict[str, Any]],
                         device: DeviceLike = None) -> Tuple[Dict[str, Any], ...]:
    """Reference ``opt_state`` -> the port's, on `device`."""
    dev = resolve_device(device)
    return tuple({name: _map_state(s, lambda a: _to_port(np.asarray(a), dev))
                  for name, s in layer.items()} for layer in tree)


def opt_state_to_numpy(tree: Sequence[Dict[str, Any]]
                       ) -> Tuple[Dict[str, Any], ...]:
    """Inverse of :func:`opt_state_from_numpy`: the reference's layout."""
    return tuple({name: _map_state(s, _to_reference) for name, s in layer.items()}
                 for layer in tree)


def num_params(tree: Sequence[Dict[str, torch.Tensor]]) -> int:
    return sum(t.numel() for layer in tree for t in layer.values())
