"""Device meshes: the substrate of every parallelism strategy.

Port of `deeplearning4j_tpu/parallel/mesh.py`. Where the JAX package builds
a `jax.sharding.Mesh` and lets XLA place shards, a mesh here is a list of
devices in row-major order over its named axes, one per shard, each tagged
with the process that owns it: the current process only, or, in a
`torch.distributed` process group, every rank's devices in rank order.
A device may stand in a mesh more than once, which puts several data
shards on one device, as the JAX package's tests do with virtual CPU
devices and as a one-card machine runs a data-parallel step; the mesh says
so explicitly (``create_mesh(devices=[dev, dev])``), never by a silent
fallback to one shard.

Axis names are the JAX package's: "data" (data parallelism, the batch
axis), "model" (tensor parallelism), "seq" (sequence parallelism) and
"stage" (pipeline stages). `Mesh.coords(i)` is position i's index on each
axis. The JAX package's placement helpers have counterparts that do what
they do on plain tensors: `shard_slice` (a position's block of a value every
process holds whole, `place_global`), `gather_replicated` (a tree of
sharded leaves back to whole tensors) and `nn/shards.py:run` (one thread per
shard, meeting at collectives, where the JAX package's `shard_map` runs one
program per device).
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

    def axis_size(self, name: str) -> int:
        """The size of axis `name`, 1 for an axis the mesh does not have."""
        return int(self.shape.get(name, 1))

    def coords(self, i: int) -> dict:
        """{axis name: index} of position i (row-major over the axes)."""
        out = {}
        for name, d in zip(reversed(self.axis_names), reversed(self.dims)):
            i, out[name] = divmod(i, d)
        return {name: out[name] for name in self.axis_names}

    def position(self, **index) -> int:
        """The position at the given axis indices (0 on every axis not
        named)."""
        i = 0
        for name, d in zip(self.axis_names, self.dims):
            i = i * d + int(index.get(name, 0))
        return i


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


def shard_slice(t, dim: int, index: int, count: int):
    """Block `index` of `count` equal blocks of `t` along `dim`: what one
    position holds of a value that every process holds whole (the JAX
    package's `place_global`, where each process slices out its own
    shards)."""
    n = t.shape[dim]
    if n % count:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not divide "
                         f"into {count} shards")
    c = n // count
    return t.narrow(dim, index * c, c)


class ShardedLeaf:
    """A tensor cut along `dim` into equal blocks, block j held on the
    device of model shard j (`slices[j]`; None for a block another process
    holds). A placed network's tree holds these where tensor parallelism
    shards a leaf; `full()` is the whole tensor on one device."""

    def __init__(self, slices, dim: int, shape, ranks=None, group=None):
        self.slices = list(slices)
        self.dim = int(dim)
        self.shape = torch.Size(shape)
        #: the process rank holding each block (None: this process, all)
        self.ranks = ranks
        #: the process group over which the blocks are spread (None: all
        #: are in this process)
        self.group = group

    def like(self, slices) -> "ShardedLeaf":
        """A leaf cut the same way holding `slices`."""
        return ShardedLeaf(slices, self.dim, self.shape, self.ranks, self.group)

    def map(self, fn, *others):
        """`fn(block j, *(block j of each of others))` for every block this
        process holds, as a leaf cut alike (a tuple of such leaves where
        `fn` returns a tuple). Each of `others` is a leaf cut alike or a
        tuple of them (an updater's state)."""
        pick = lambda o, j: tuple(pick(x, j) for x in o) \
            if isinstance(o, tuple) else o.slices[j]
        return self._joined([None if b is None else
                             fn(b, *(pick(o, j) for o in others))
                             for j, b in enumerate(self.slices)])

    def _joined(self, outs):
        first = next(o for o in outs if o is not None)
        if isinstance(first, tuple):
            return tuple(self._joined([None if o is None else o[k] for o in outs])
                         for k in range(len(first)))
        return self.like(outs)

    def sq_norm(self) -> torch.Tensor:
        """The squared L2 norm over every block, in float32, on the first
        block's device here (summed over the group, host-staged on gloo,
        where blocks live in other processes)."""
        local = [b for _, b in self.local()]
        dev = local[0].device
        s = sum(torch.sum(b.float() ** 2).to(dev) for b in local)
        if self.group is not None:
            from ..nn.shards import _host_staged
            s = s.reshape(1).to("cpu" if _host_staged(self.group) else dev)
            self.group.allreduce([s]).wait()
            s = s[0].to(dev)
        return s

    @property
    def dtype(self):
        return next(s for s in self.slices if s is not None).dtype

    def local(self):
        """[(j, block)] of the blocks this process holds."""
        return [(j, s) for j, s in enumerate(self.slices) if s is not None]

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on `device` (default: block 0's); every block
        must be in this process (gather across processes first)."""
        if any(s is None for s in self.slices):
            raise RuntimeError("a block of this leaf lives in another process; "
                               "gather it over the process group first")
        dev = device or self.slices[0].device
        return torch.cat([s.to(dev) for s in self.slices], self.dim)

    def nbytes(self, j: int) -> int:
        s = self.slices[j]
        return 0 if s is None else s.numel() * s.element_size()


def gather_replicated(tree, device=None):
    """A tree with every `ShardedLeaf` replaced by its whole tensor on
    `device` (default: its block 0's device); the counterpart of the JAX
    package's `gather_replicated`, for blocks held in this process."""
    return _map(lambda t: t.full(device) if isinstance(t, ShardedLeaf) else t,
                tree)


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
