"""Device meshes: the substrate of data-parallel training.

Port of the data axis of `deeplearning4j_tpu/parallel/mesh.py`. Where the
JAX package builds a `jax.sharding.Mesh` and lets XLA place shards, a mesh
here is a list of devices, one per data shard, each tagged with the
process that owns it: the current process only, or, in a
`torch.distributed` process group, every rank's devices in rank order.
A device may stand in a mesh more than once, which puts several data
shards on one device, as the JAX package's tests do with virtual CPU
devices and as a one-card machine runs a data-parallel step; the mesh says
so explicitly (``create_mesh(devices=[dev, dev])``), never by a silent
fallback to one shard.

Axis names are the JAX package's: "data" (data parallelism, the batch
axis), "model" (tensor parallelism), "seq" (sequence parallelism) and
"stage" (pipeline stages). Only the data axis has a wrapper here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, canonical, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
STAGE_AXIS = "stage"


def process_index() -> int:
    """This process's rank in the process group (0 without one)."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def process_count() -> int:
    """The process group's size (1 without one)."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def local_devices() -> List[torch.device]:
    """This process's devices: every visible GPU, or the CPU when none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


@dataclass
class Mesh:
    """A grid of devices (one per shard) with named axes and, per device,
    the rank of the process that owns it."""

    devices: List[torch.device]
    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]
    processes: List[int]

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    def local_positions(self) -> List[int]:
        """Indices of this process's entries, in mesh order."""
        me = process_index()
        return [i for i, p in enumerate(self.processes) if p == me]

    def local_devices(self) -> List[torch.device]:
        return [self.devices[i] for i in self.local_positions()]


def create_mesh(shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = (DATA_AXIS,),
                devices: Optional[Sequence[DeviceLike]] = None,
                processes: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over `devices` (default: `local_devices()` of every process
    of the group, rank by rank). `shape=None` puts every device on the
    first axis (pure data parallelism). `processes` names the owner of
    each device (default: the current process for explicit devices;
    rank by rank for the default)."""
    if devices is None:
        mine = local_devices()
        n = process_count()
        devices = mine * n
        processes = [r for r in range(n) for _ in mine]
    devices = [canonical(resolve_device(d)) for d in devices]
    if processes is None:
        processes = [process_index()] * len(devices)
    if shape is None:
        shape = [len(devices)] + [1] * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"Mesh shape {tuple(shape)} needs {n} devices, "
                         f"have {len(devices)}")
    return Mesh(list(devices[:n]), tuple(axis_names),
                tuple(int(s) for s in shape), list(processes[:n]))


def data_parallel_mesh(num_devices: Optional[int] = None,
                       devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A data-axis mesh over `devices` (default: every local device), cut
    to the first `num_devices`."""
    if devices is None:
        default = create_mesh()
        devices, procs = default.devices, default.processes
    else:
        devices, procs = list(devices), None
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"Requested a {num_devices}-device data-parallel mesh but only "
                f"{len(devices)} devices are listed: {devices}; list a device "
                "more than once to put several shards on it")
        devices = devices[:num_devices]
        procs = None if procs is None else procs[:num_devices]
    return create_mesh([len(devices)], (DATA_AXIS,), devices, procs)


def is_multiprocess(mesh: Mesh) -> bool:
    """True when the mesh spans devices of more than one process."""
    return process_count() > 1 and \
        any(p != process_index() for p in mesh.processes)


@dataclass
class BatchSharding:
    """The batch axis cut over a mesh axis: this process's shards, in
    order, take contiguous equal row blocks of its local batch. `device`
    is where a whole local batch is staged before it is cut (the first
    local device)."""

    mesh: Mesh
    axis: str = DATA_AXIS

    @property
    def device(self) -> torch.device:
        return self.mesh.local_devices()[0]


@dataclass
class Replicated:
    """Every device of the mesh holds the whole value."""

    mesh: Mesh


def batch_sharded(mesh: Mesh, axis: str = DATA_AXIS) -> BatchSharding:
    """Shard the leading (batch) dimension across `axis`."""
    return BatchSharding(mesh, axis)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree, axis: str = DATA_AXIS):
    """This process's shards of a tree of host or device arrays: per leaf,
    a list with one tensor per local shard (contiguous equal row blocks,
    each on its shard's device). In a multi-process mesh each process
    passes its local partition. The rows must divide evenly; pad first
    (`pad_batch_to_multiple`)."""
    devs = mesh.local_devices()

    def cut(a):
        t = torch.as_tensor(a)
        if t.shape[0] % len(devs):
            raise ValueError(
                f"batch of {t.shape[0]} rows does not divide over "
                f"{len(devs)} local shards; pad it (pad_batch_to_multiple)")
        return [c.to(d) for c, d in zip(t.chunk(len(devs)), devs)]
    return _map(cut, tree)


def replicate(mesh: Mesh, tree):
    """A copy of a tree of tensors on every distinct local device of the
    mesh: {device: tree}; the device already holding a leaf keeps it."""
    out = {}
    for d in mesh.local_devices():
        if d not in out:
            out[d] = _map(lambda t: t.to(d), tree)
    return out


def pad_batch_to_multiple(arr, multiple: int) -> Tuple[object, int]:
    """Pad the batch dim up to a multiple, repeating the last example so
    batch statistics stay finite; returns (padded, original n). Callers
    zero-weight the pad rows in the loss (data/padding.py)."""
    n = arr.shape[0]
    pad = (-n) % int(multiple)
    if pad == 0:
        return arr, n
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr[-1:].expand((pad,) + tuple(arr.shape[1:]))],
                         0), n
    arr = np.asarray(arr)
    return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], 0), n
