"""Parameter trees carried between the JAX package and the port.

The JAX package keeps a network's parameters as a tuple of per-layer dicts
(``params_tree``) with HWIO convolution kernels and ``[n_in, n_out]`` dense
weights, NHWC being its layout (docs/design.md §7). The port stores
convolution kernels as OIHW in channels-last memory, which is what
``F.conv2d`` hands to cuDNN for NHWC activations, and keeps dense weights as
``[n_in, n_out]``. This module is the only place that knows the difference;
the round trip is bitwise (a permutation moves no bits). Optimizer state
(``opt_state``: one dict per layer, parameter name -> ``()``, one array, or a
tuple of arrays shaped like the parameter) follows the same rule, and so
does layer state (``state_tree``: BatchNormalization's 1-D running
statistics, never permuted).

Quantized trees (``quantize/quantize.py``) carry across too: int8 ``W_q``
[n_out, n_in], float32 ``W_scale``, int32 ``W_zp`` (all 1-D or 2-D, so never
permuted) and bfloat16 leaves, 4-D conv kernels among them. numpy has no
bfloat16 of its own: the JAX package's arrays arrive with the ``bfloat16``
dtype of ``ml_dtypes``, which ``torch.from_numpy`` refuses, so their bits are
carried as uint16 (this module does not import ``ml_dtypes``). On the way
back bfloat16 leaves become float32 numpy arrays, which holds every bfloat16
value exactly; a caller casts them back with its own bfloat16 type.

A ComputationGraph's trees are dicts keyed by node name instead of tuples;
every function here takes either. Checkpoints number the leaves of a tree
in ``jax.tree_util`` order (utils/model_serializer.py), which
:func:`tree_leaves` reproduces without JAX: dict keys sorted whatever the
insertion order (a graph's dicts follow its topological order, so
GoogLeNet's ``3a-cnn1`` must be sorted ahead of ``cnn1``), tuples and lists
in order, and ``None``, ``()`` and ``{}`` giving no leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

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


def tree_map(fn: Callable, tree):
    """`fn` applied to every leaf, the structure kept: dicts (in their own
    key order), tuples and lists; ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def tree_copy(tree):
    """Every tensor leaf cloned (its memory format kept): a tree that crosses
    a network boundary (clone, early-stopping savers) shares no storage with
    the network it came from."""
    return tree_map(torch.clone, tree)


def tree_leaves(tree) -> List[Any]:
    """The leaves in ``jax.tree_util`` order: dict keys sorted, tuples and
    lists in order, ``None`` and empty containers giving none."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    if tree is None:
        return []
    return [tree]


def tree_unflatten(template, leaves: Sequence[Any]):
    """`template`'s structure (dicts in its own key order) filled with
    `leaves`, taken in :func:`tree_leaves` order; the inverse of
    ``tree_leaves(template)``. Raises ValueError on a count mismatch."""
    it = iter(leaves)
    count = [0]

    def build(t):
        if isinstance(t, dict):
            filled = {k: build(t[k]) for k in sorted(t)}
            return {k: filled[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        if t is None:
            return None
        count[0] += 1
        try:
            return next(it)
        except StopIteration:
            raise ValueError(f"tree_unflatten: fewer leaves than the template's "
                             f"{len(tree_leaves(template))}") from None

    out = build(template)
    if next(it, None) is not None:
        raise ValueError(f"tree_unflatten: more leaves than the template's {count[0]}")
    return out


def _top(tree):
    """A sequence of per-layer dicts comes back as a tuple, as before."""
    return tuple(tree) if isinstance(tree, list) else tree


def params_from_numpy(tree, device: DeviceLike = None):
    """Reference ``params_tree`` (numpy or any array convertible by
    ``np.asarray``; per-layer dicts in a sequence, or per-node dicts in a
    dict) -> the port's tree of tensors on `device`."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_port(np.asarray(a), dev), _top(tree))


def transformer_decoder_from_numpy(tree, *, heads: int, max_context: int,
                                   device: DeviceLike = None):
    """The JAX package's ``TransformerDecoder.params_tree`` (numpy arrays or
    anything ``np.asarray`` takes: {"emb", "lnf_s", "lnf_b", "layers": [...]})
    as the port's ``serving.decode.TransformerDecoder`` on `device`, with
    vocab, depth, head_dim and ff read from the shapes; `heads` and
    `max_context` are not in the tree."""
    from ..serving.decode import TransformerDecoder
    vocab, d = np.asarray(tree["emb"]).shape
    if d % heads:
        raise ValueError(f"d_model {d} is not a multiple of heads {heads}")
    model = TransformerDecoder(vocab=vocab, layers=len(tree["layers"]),
                               heads=heads, head_dim=d // heads,
                               ff=np.asarray(tree["layers"][0]["w1"]).shape[1]
                               if tree["layers"] else 1,
                               max_context=max_context, device=device)
    model.params_tree = tree_map(np.asarray, tree)
    return model


def params_to_numpy(tree):
    """Inverse of :func:`params_from_numpy`: the reference's layout, numpy."""
    return tree_map(_to_reference, _top(tree))


def opt_state_from_numpy(tree, device: DeviceLike = None):
    """Reference ``opt_state`` (per parameter ``()``, one array, or a tuple
    of arrays shaped like the parameter) -> the port's, on `device`."""
    return params_from_numpy(tree, device)


def opt_state_to_numpy(tree):
    """Inverse of :func:`opt_state_from_numpy`: the reference's layout."""
    return params_to_numpy(tree)


def state_from_numpy(tree, device: DeviceLike = None):
    """Reference ``state_tree`` (per layer a dict of running statistics,
    BatchNormalization's float32 ``mean`` and ``var``, or ``{}``) -> the
    port's, on `device`. Leaves keep their type: float32 in a bfloat16
    network too."""
    return params_from_numpy(tree, device)


def state_to_numpy(tree):
    """Inverse of :func:`state_from_numpy`: the reference's layout."""
    return params_to_numpy(tree)


def leaf_to_reference_bits(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """One port leaf as a checkpoint stores it: the reference's layout
    (HWIO for a 4-D kernel) and the tensor's own type, bfloat16 as its
    uint16 bits; with the type's name ("float32", "bfloat16", "int8", ...)."""
    t = t.detach().cpu()
    if t.ndim == 4:  # OIHW -> HWIO
        t = t.permute(2, 3, 1, 0)
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy(), "bfloat16"
    a = t.numpy().copy()
    return a, a.dtype.name


def leaf_from_reference_bits(a: np.ndarray, dtype_name: str,
                             device: torch.device) -> torch.Tensor:
    """Inverse of :func:`leaf_to_reference_bits`: a stored array (bfloat16
    as uint16 bits under the name "bfloat16") -> a port leaf on `device`."""
    if dtype_name == "bfloat16":
        if a.dtype != np.uint16:
            raise ValueError(f"a bfloat16 leaf stored as {a.dtype}, not uint16 bits")
        t = torch.from_numpy(np.array(a.view(np.int16), copy=True)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if t.ndim == 4:  # HWIO -> OIHW
        t = t.permute(3, 2, 0, 1)
    return place(t, device)


def num_params(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree))


def flatten_params(tree) -> np.ndarray:
    """The flat parameter vector of the reference's ``params()``: leaves in
    :func:`tree_leaves` order, each in the reference's layout, row-major."""
    leaves = [_to_reference(t).ravel() for t in tree_leaves(tree)]
    return np.concatenate(leaves) if leaves else np.zeros((0,), np.float32)


def unflatten_params(template, flat, device: torch.device):
    """Inverse of :func:`flatten_params` on `template`'s structure, shapes
    and types."""
    flat = np.asarray(flat).ravel()
    out, offset = [], 0
    for t in tree_leaves(template):
        n = t.numel()
        if offset + n > flat.shape[0]:
            raise ValueError(f"flat vector of {flat.shape[0]} values is shorter "
                             f"than the parameters")
        shape = tuple(t.permute(2, 3, 1, 0).shape) if t.ndim == 4 else tuple(t.shape)
        leaf = _to_port(flat[offset:offset + n].reshape(shape), device)
        out.append(leaf.to(t.dtype))
        offset += n
    if offset != flat.shape[0]:
        raise ValueError(f"flat vector length {flat.shape[0]} != parameter count "
                         f"{offset}")
    return tree_unflatten(template, out)
