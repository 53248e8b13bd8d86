"""The data shards of one training step.

A data-parallel step splits its batch into shards of contiguous rows and
runs each shard's forward on its own device (parallel/wrapper.py,
parallel/multihost.py). Most of a network is row-wise, so a shard computes
its rows alone. Three points couple the rows of a batch, and a sharded step
must give them the whole batch to keep the step the same function as one
step on the global batch, as the JAX package's sharded jit keeps it:

* dropout draws its mask over the batch's shape from one generator: a
  shard draws the global batch's mask from a copy of that generator and
  keeps its own rows (`dropout_keep_mask`), so every shard, and every
  process, draws exactly the mask the whole batch would;
* BatchNormalization normalizes by the batch's moments: the shards of one
  process meet in a `ShardGroup`, which concatenates their inputs and
  hands each the moments of the whole (`batch_moments`);
* an output layer's score is a mean over the batch, labels mask included:
  the group scores the concatenation once and hands that score to shard 0
  (`score`).

Outside a sharded step (`current()` is None) each of these is what the
plain step computes. A step of several processes (`ShardContext.processes`,
the process group) averages the processes' gradients, and the two meeting
points that reach across processes meet over the process group too:

* the moments are all-reduced as sums (with their row count), and so is
  their gradient in the backward, as SyncBatchNorm does, so each process
  normalizes by the global batch's moments and every row's gradient sees
  what its moments did to the other processes' rows;
* a process's score is its rows' score weighted by its share of the
  global batch's weight (the labels mask's sum where the loss divides by
  it, else its rows), so the processes' average is the global batch's
  score and the averaged gradient its gradient.

A sequence-parallel step (parallel/sequence.py) cuts time too: its shards
form a (data, model, seq) `Grid`, and shard (d, m, s) holds rows block d
and time block s. Its context adds the time slice and the grid, and the
meeting points follow the cut:

* the dropout mask is the global batch's, cut to the shard's rows and time;
* the score concatenates the shards' outputs, labels and labels masks
  along time and rows (the copies that model shards m > 0 hold of a block
  are left out);
* `ring_hop` hands each shard its ring predecessor's key/value block (seq
  index s - 1, the same d and m), moved to its device; across processes
  the block goes over the process group, host-staged (gloo carries no
  CUDA point-to-point), and its backward sends the gradient back;
* `gather_time` gives a layer that needs the whole sequence (a recurrent
  layer, `forward_layer`) the concatenation of its row block's time
  blocks, and `gather_heads` gives every model shard the attention output
  of every head.

The shards of one process run in threads and build one autograd graph;
one `torch.autograd.grad` from shard 0's score runs the whole backward,
the reverse ring included (a backward per thread would meet other
threads' nodes on a device's one autograd worker and deadlock it).
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

Tensor = torch.Tensor

_local = threading.local()


class ShardGroup:
    """The shards of one step in one process, each on a thread of its own,
    meeting at collectives: every shard hands in a value, the last to
    arrive runs the reduction (the first shard's function over all the
    values) and each shard takes its own result. All shards run the same
    layers, so they meet at the same collectives in the same order."""

    def __init__(self, count: int, timeout_s: float = 600.0):
        self.count = int(count)
        self._values: List = [None] * self.count
        self._fns: List[Optional[Callable]] = [None] * self.count
        self._results: List = [None] * self.count
        self.error: Optional[BaseException] = None
        self._barrier = threading.Barrier(self.count, action=self._reduce,
                                          timeout=timeout_s)

    def _reduce(self):
        try:
            self._results = list(self._fns[0](self._values))
        except BaseException as e:
            self.error = e
            raise

    def collective(self, index: int, value, fn: Callable):
        """Hand in `value`; returns this shard's part of `fn(values)`."""
        self._values[index] = value
        self._fns[index] = fn
        self._barrier.wait()
        return self._results[index]

    def abort(self):
        self._barrier.abort()


@dataclass
class Grid:
    """Where the local shards of a sequence-parallel step sit: the (data,
    model, seq) extents, each local shard's coordinates and device,
    whether attention heads split over the model axis, and across
    processes every position's (process rank, coordinates) in mesh order
    with this process's rank."""

    dims: Tuple[int, int, int]
    coords: List[Tuple[int, int, int]]
    devices: List[torch.device]
    heads: bool = False
    positions: Optional[List[Tuple[int, Tuple[int, int, int]]]] = None
    rank: int = 0
    #: the last score a meeting computed, whole (across processes each
    #: process's shard 0 carries its share, 1/P of it)
    last_score: Optional[torch.Tensor] = None

    def local_index(self, c) -> Optional[int]:
        return self.coords.index(c) if c in self.coords else None

    def owner(self, c) -> int:
        """The rank of the process holding position `c`."""
        if self.positions is None:
            return self.rank
        return next(p for p, pc in self.positions if pc == c)

    def tag(self, c) -> int:
        """Position `c`'s mesh index: the tag of a block sent to it."""
        d, m, s = c
        return (d * self.dims[1] + m) * self.dims[2] + s


@dataclass
class ShardContext:
    """Shard `index` of `count`: rows [start, start + rows) of a global
    batch of `total` rows, meeting its sibling shards in `group` (None when
    each process holds one shard, or the moments and score stay local).
    In a sequence-parallel step it also holds time steps [t_start, t_start
    + t_len) of `t_total` (t_len 0: time is not cut) at its place in
    `grid`."""

    index: int
    count: int
    start: int
    rows: int
    total: int
    group: Optional[ShardGroup] = None
    processes: Optional[object] = None   # a torch.distributed ProcessGroup
    grid: Optional[Grid] = None
    t_start: int = 0
    t_len: int = 0
    t_total: int = 0


def current() -> Optional[ShardContext]:
    return getattr(_local, "ctx", None)


@contextmanager
def sharded(ctx: ShardContext):
    """Run this thread's forward as shard `ctx`."""
    prev = current()
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev


def dropout_keep_mask(x: Tensor, keep: float,
                      generator: torch.Generator) -> Tensor:
    """The keep mask of inverted dropout on `x`: in a sharded step, this
    shard's rows of the global batch's mask, drawn from the generator's
    device as the whole batch's would be."""
    ctx = current()
    if ctx is None:
        return torch.rand(x.shape, generator=generator, device=x.device) < keep
    cut_time = _time_cut(ctx, x)
    shape = (ctx.total,) + ((ctx.t_total,) if cut_time else ()) + \
        tuple(x.shape[1 + cut_time:])
    r = torch.rand(shape, generator=generator, device=generator.device)
    r = r[ctx.start:ctx.start + x.shape[0]]
    if cut_time:
        r = r[:, ctx.t_start:ctx.t_start + ctx.t_len]
    return (r < keep).to(x.device)


def _time_cut(ctx: ShardContext, t: Tensor, mask: bool = False) -> bool:
    """Whether `t` ([rows, time, features], or a [rows, time] mask) holds
    the shard's time block of a sequence cut over the seq axis (a recurrent
    layer's gathered input holds the whole sequence)."""
    return bool(ctx.t_len) and ctx.t_len < ctx.t_total and \
        (t.ndim >= 3 or (mask and t.ndim == 2)) and t.shape[1] == ctx.t_len


def _allreduce_sum(t: Tensor, processes) -> Tensor:
    """`t` summed over the process group, no gradient."""
    out = t.detach().clone().contiguous()
    processes.allreduce([out]).wait()
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the process group; the backward sums the gradients too."""

    @staticmethod
    def forward(ctx, t, processes):
        ctx.processes = processes
        return _allreduce_sum(t, processes)

    @staticmethod
    def backward(ctx, g):
        return _allreduce_sum(g, ctx.processes), None


def _moments(xc: Tensor, axes, processes):
    """(mean, mean of squares) of `xc` over `axes`: of these rows, or of
    every process's rows through one differentiable all-reduce of
    (sum, sum of squares, count)."""
    if processes is None:
        return torch.mean(xc, axes), torch.mean(xc * xc, axes)
    s1, s2 = torch.sum(xc, axes), torch.sum(xc * xc, axes)
    k = s1.numel()
    count = xc.new_full((1,), float(xc.numel() // k))
    sums = _AllReduceSum.apply(torch.cat([s1.reshape(-1), s2.reshape(-1), count]),
                               processes)
    n = sums[2 * k:].detach()
    return (sums[:k] / n).view_as(s1), (sums[k:2 * k] / n).view_as(s2)


def batch_moments(xc: Tensor, axes):
    """(mean, mean of squares) of `xc` over `axes`, which include the batch
    axis: over the whole batch in a sharded step's group, and over every
    process's rows in a step of several processes."""
    ctx = current()
    if ctx is None:
        return _moments(xc, axes, None)
    if ctx.grid is not None:
        raise NotImplementedError(
            "batch statistics under a seq axis: BatchNormalization is not "
            "supported by sequence parallelism")
    if ctx.group is None:
        return _moments(xc, axes, ctx.processes)
    processes = ctx.processes

    def reduce(values):
        dev = values[0].device
        m, sq = _moments(torch.cat([v.to(dev) for v in values], 0), axes,
                         processes)
        return [(m.to(v.device), sq.to(v.device)) for v in values]

    return ctx.group.collective(ctx.index, xc, reduce)


def _process_share(s: Tensor, rows: int, lmask: Optional[Tensor],
                   processes) -> Tensor:
    """Score `s` of this process's `rows` rows weighted so that the average
    over the process group is the global batch's score (losses.Loss.score:
    the sum over rows over the labels mask's sum, clamped at 1, with a mask
    of 2 or more axes, else the mean over rows)."""
    if lmask is not None and lmask.ndim >= 2:
        w = torch.sum(lmask.detach().float())
        den = torch.clamp(w, min=1.0)
    else:
        w = den = torch.tensor(float(rows), device=s.device)
    total = torch.clamp(_allreduce_sum(w.reshape(1), processes), min=1.0)[0]
    return s * (den * processes.size() / total).to(s.dtype)


def score(layer, params, a: Tensor, y: Tensor, lmask: Optional[Tensor]):
    """`layer.compute_score(params, a, y, lmask)`; in a sharded step's group,
    the score of the concatenated shards, held by shard 0 (the others get
    a zero, so only shard 0's loss carries it); in a step of several
    processes, weighted by the process's share of the global batch
    (`_process_share`)."""
    ctx = current()
    if ctx is None:
        return layer.compute_score(params, a, y, lmask)
    if ctx.grid is not None:
        return _grid_score(ctx, layer, params, a, y, lmask)
    processes = ctx.processes
    if ctx.group is None:
        s = layer.compute_score(params, a, y, lmask)
        return s if processes is None else \
            _process_share(s, a.shape[0], lmask, processes)

    def reduce(values):
        dev = values[0][0].device
        cat = lambda ts: torch.cat([t.to(dev) for t in ts], 0)
        masks = [m for _, _, m in values]
        mask = None if masks[0] is None else cat(masks)
        whole = cat([v[0] for v in values])
        s = layer.compute_score(params, whole, cat([v[1] for v in values]), mask)
        if processes is not None:
            s = _process_share(s, whole.shape[0], mask, processes)
        return [s] + [torch.zeros((), dtype=s.dtype, device=v[0].device)
                      for v in values[1:]]

    return ctx.group.collective(ctx.index, (a, y, lmask), reduce)

# ---------------------------------------------------------------------------
# Sequence-parallel meeting points (a Grid of (data, model, seq) shards)
# ---------------------------------------------------------------------------

#: Wall milliseconds spent in this process's cross-process transports:
#: "hop" (the ring's blocks and their gradients), "score" (the score's
#: all-gather and its backward), "param_gather" (tensor parallelism's
#: all-gather of a leaf's blocks, parallel/tensor.py), "output" (the
#: all-gather of sequence-parallel inference's output blocks) and "word2vec"
#: (the device-corpus engine's gather of its shards' updates,
#: nlp/distributed.py). Tests and the chip smoke reset and read them.
cross_ms = {"hop": 0.0, "score": 0.0, "param_gather": 0.0, "output": 0.0,
            "word2vec": 0.0}
_cross_lock = threading.Lock()


@contextmanager
def timed_transport(kind: str):
    """Add the wall time of the enclosed transport to `cross_ms[kind]`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        with _cross_lock:
            cross_ms[kind] += (time.perf_counter() - t0) * 1000.0


def _meet(ctx: ShardContext, value, fn: Callable):
    """`fn` over every local shard's value; this shard's part."""
    if ctx.group is None:
        return fn([value])[0]
    return ctx.group.collective(ctx.index, value, fn)


def _host_staged(pg) -> bool:
    """Whether `pg` carries host tensors (gloo) rather than device tensors
    (NCCL, where each rank has a GPU of its own)."""
    try:
        return torch.distributed.get_backend(pg) != "nccl"
    except (RuntimeError, ValueError):
        return True   # a group made outside the default one (gloo in tests)


def _wire(t: Tensor, host: bool = True) -> Tensor:
    """`t` as a contiguous tensor the group carries: on the host for gloo,
    where it is for NCCL; bfloat16 by its bits."""
    t = t.detach()
    t = (t.to("cpu") if host else t).contiguous()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _unwire(w: Tensor, dtype, device) -> Tensor:
    if dtype == torch.bfloat16:
        w = w.view(torch.bfloat16)
    return w.to(device=device, dtype=dtype)


def _p2p(pg, sends, recvs):
    """Point-to-point over `pg`: `sends` [(tensor, dst rank, tag)] and
    `recvs` [(src rank, tag, shape, dtype, device)], all posted before any
    wait; returns the received tensors in `recvs` order."""
    with timed_transport("hop"):
        return _p2p_untimed(pg, sends, recvs)


def _p2p_untimed(pg, sends, recvs):
    host = _host_staged(pg)
    works, bufs = [], []
    for src, tag, shape, dtype, device in recvs:
        buf = _wire(torch.empty(shape, dtype=dtype,
                                device="cpu" if host else device), host)
        bufs.append((buf, dtype, device))
        works.append(pg.recv([buf], src, tag))
    keep = []
    for t, dst, tag in sends:
        w = _wire(t, host)
        keep.append(w)
        works.append(pg.send([w], dst, tag))
    for w in works:
        w.wait()
    return [_unwire(b, dt, dev) for b, dt, dev in bufs]


def gather_positions(values: List[Tensor], pg, owners, device,
                     kind: str = "output") -> List[Tensor]:
    """Every mesh position's tensor in mesh order, on `device`, no
    gradient: `values` are this process's positions' (all of one shape, in
    mesh order), `owners` the process of every position; every process
    holds the same number of positions. One all-gather over `pg`,
    host-staged for gloo, timed as `cross_ms[kind]`."""
    with timed_transport(kind):
        mine = torch.stack([v.detach() for v in values])
        w = _wire(mine, _host_staged(pg))
        outs = [torch.empty_like(w) for _ in range(pg.size())]
        pg.allgather([outs], [w]).wait()
        got = [_unwire(o, mine.dtype, device) for o in outs]
    taken = [0] * pg.size()
    ordered = []
    for r in owners:
        ordered.append(got[r][taken[r]])
        taken[r] += 1
    return ordered


class _Exchange(torch.autograd.Function):
    """Blocks sent to and received from other processes; the backward sends
    each received block's gradient back to its source and takes the sent
    blocks' gradients from their destinations (the inverse permutation)."""

    @staticmethod
    def forward(ctx, pg, sends, recvs, *sent):
        ctx.pg, ctx.sends, ctx.recvs = pg, sends, recvs
        ctx.meta = [(t.shape, t.dtype, t.device) for t in sent]
        return tuple(_p2p(pg, [(t, dst, tag) for t, (dst, tag) in zip(sent, sends)],
                          recvs))

    @staticmethod
    def backward(ctx, *grads):
        back = [(torch.zeros(shape, dtype=dtype, device=dev) if g is None else g,
                 src, tag)
                for g, (src, tag, shape, dtype, dev) in zip(grads, ctx.recvs)]
        got = _p2p(ctx.pg, back, [(dst, tag, shape, dtype, dev) for (dst, tag),
                                  (shape, dtype, dev) in zip(ctx.sends, ctx.meta)])
        return (None, None, None) + tuple(got)


class _AllGather(torch.autograd.Function):
    """[P, ...] from every process's [...] (host-staged); the backward sums
    the gradient over the processes and keeps this process's part."""

    @staticmethod
    def forward(ctx, t, pg):
        ctx.pg = pg
        with timed_transport("score"):
            w = _wire(t, _host_staged(pg))
            outs = [torch.empty_like(w) for _ in range(pg.size())]
            pg.allgather([outs], [w]).wait()
            return torch.stack([_unwire(o, t.dtype, t.device) for o in outs])

    @staticmethod
    def backward(ctx, g):
        with timed_transport("score"):
            w = g.detach().to("cpu" if _host_staged(ctx.pg) else g.device,
                              torch.float32).contiguous()
            ctx.pg.allreduce([w]).wait()
            return w[ctx.pg.rank()].to(g.device, g.dtype), None


def _exchange_blocks(grid: Grid, pg, values, dst_of, src_of):
    """The cross-process half of a permutation collective: local shard i's
    block goes to `dst_of(i)` (a remote position or None) and local shard
    i takes `src_of(i)`'s (remote or None). Every value is a tuple of
    tensors (or Nones) of one shape across the grid. Returns {local index:
    tuple received}."""
    sends, sent, recvs, slots = [], [], [], []
    tag = lambda c, k: grid.tag(c) * len(values[0]) + k
    for i, v in enumerate(values):
        c = dst_of(i)
        if c is not None:
            for k, t in enumerate(v):
                if t is not None:
                    sends.append((grid.owner(c), tag(c, k)))
                    sent.append(t)
    for i, v in enumerate(values):
        c = src_of(i)
        if c is not None:
            for k, t in enumerate(v):
                if t is not None:
                    recvs.append((grid.owner(c), tag(grid.coords[i], k),
                                  tuple(t.shape), t.dtype, grid.devices[i]))
                    slots.append((i, k))
    got = _Exchange.apply(pg, sends, recvs, *sent) if (sends or recvs) else ()
    out = {i: list(values[i]) for i, _ in slots}
    for (i, k), t in zip(slots, got):
        out[i][k] = t
    return {i: tuple(v) for i, v in out.items()}


def ring_hop(block: Tuple):
    """This shard's ring predecessor's `block` (a tuple of tensors or Nones:
    key, value, key mask), on this shard's device: the predecessor is the
    shard with the same data and model index and seq index s - 1 (mod the
    seq axis), as the JAX package's ring `ppermute`s (i -> i + 1)."""
    ctx = current()
    grid = ctx.grid
    n_seq = grid.dims[2]
    pred = lambda c: (c[0], c[1], (c[2] - 1) % n_seq)
    succ = lambda c: (c[0], c[1], (c[2] + 1) % n_seq)

    def reduce(values):
        remote = {}
        if ctx.processes is not None:
            far = lambda c: None if grid.local_index(c) is not None else c
            remote = _exchange_blocks(
                grid, ctx.processes, values,
                lambda i: far(succ(grid.coords[i])),
                lambda i: far(pred(grid.coords[i])))
        out = []
        for i, c in enumerate(grid.coords):
            j = grid.local_index(pred(c))
            if j is None:
                out.append(remote[i])
            else:
                out.append(tuple(None if t is None else t.to(grid.devices[i])
                                 for t in values[j]))
        return out

    return _meet(ctx, tuple(block), reduce)


def _gather_axis(t: Tensor, axis: int, dim: int) -> Tensor:
    """The concatenation along `dim` of the blocks `t` of every local shard
    that differs from this one only on grid axis `axis` (0 data, 1 model,
    2 seq), in index order, on this shard's device."""
    ctx = current()
    grid = ctx.grid

    def reduce(values):
        out = []
        for i, c in enumerate(grid.coords):
            parts = []
            for k in range(grid.dims[axis]):
                j = grid.local_index(c[:axis] + (k,) + c[axis + 1:])
                if j is None:
                    raise NotImplementedError(
                        "gathering a sequence or the heads across processes "
                        "is not supported; keep the seq and model axes of a "
                        "row block in one process")
                parts.append(values[j].to(grid.devices[i]))
            out.append(torch.cat(parts, dim))
        return out

    return _meet(ctx, t, reduce)


def gather_time(t: Tensor) -> Tensor:
    """[rows, t_len, ...] -> [rows, t_total, ...]: this row block's whole
    sequence from its seq shards."""
    return _gather_axis(t, 2, 1)


def gather_heads(o: Tensor) -> Tensor:
    """[rows, time, heads / M, d] -> [rows, time, heads, d]: every model
    shard's heads of this block."""
    return _gather_axis(o, 1, 2)


def forward_layer(layer, params, state, x: Tensor, *, train: bool,
                  generator, mask):
    """`layer.forward_with_state`; in a sequence-parallel shard, a layer
    that needs the whole sequence (a recurrent layer) runs on its row
    block's gathered sequence (masks too) and keeps its own time block of
    the output. Every seq shard of the block runs it, each keeping the
    gradient of its own block."""
    ctx = current()
    if ctx is None or not layer.is_recurrent() or not _time_cut(ctx, x) \
            or x.ndim != 3:
        return layer.forward_with_state(params, state, x, train=train,
                                        generator=generator, mask=mask)
    xs = gather_time(x)
    ms = gather_time(mask) if mask is not None and _time_cut(ctx, mask, True) \
        else mask
    y, st = layer.forward_with_state(params, state, xs, train=train,
                                     generator=generator, mask=ms)
    return y[:, ctx.t_start:ctx.t_start + ctx.t_len], st


def _grid_score(ctx: ShardContext, layer, params, a, y, lmask):
    """The score of the whole batch from a grid's blocks: outputs, labels
    and labels masks concatenated along time (where they are cut) and rows,
    the model shards' copies left out, scored once and held by shard 0 (the
    others get zeros). Across processes the blocks are all-gathered (the
    outputs differentiably) and each process's shard 0 holds 1/P of the
    score, so that the gradients summed over the processes are the whole
    batch's; `grid.last_score` keeps the whole score."""
    grid = ctx.grid
    timed = _time_cut(ctx, a)
    pg = ctx.processes

    def reduce(values):
        dev = values[0][0].device
        owns = lambda c: c[1] == 0 and (timed or c[2] == 0)
        blocks = {c: v for c, v in zip(grid.coords, values) if owns(c)}
        if pg is not None:
            mine = [c for c in grid.coords if owns(c)]
            ranks = sorted({p for p, _ in grid.positions})
            theirs = {p: [c for q, c in grid.positions if q == p and owns(c)]
                      for p in ranks}
            parts = []
            for k in range(3):
                if blocks[mine[0]][k] is None:
                    parts.append(None)
                    continue
                stack = torch.stack([blocks[c][k].to(dev) for c in mine])
                parts.append(_AllGather.apply(stack, pg))
            for p in ranks:
                for n, c in enumerate(theirs[p]):
                    blocks[c] = tuple(None if g is None else g[p][n] for g in parts)

        def whole(k):
            if blocks[next(iter(blocks))][k] is None:
                return None
            rows = []
            for d in range(grid.dims[0]):
                seq = [blocks[(d, 0, s)][k].to(dev) for s in range(grid.dims[2])
                       if (d, 0, s) in blocks]
                rows.append(torch.cat(seq, 1) if timed and (
                    k < 2 or _time_cut(ctx, seq[0], True)) else seq[0])
            return torch.cat(rows, 0)

        s = layer.compute_score(params, whole(0), whole(1), whole(2))
        grid.last_score = s.detach()
        if pg is not None:
            s = s / pg.size()
        return [s] + [torch.zeros((), dtype=s.dtype, device=v[0].device)
                      for v in values[1:]]

    return _meet(ctx, (a, y, lmask), reduce)


def run(count: int, body: Callable[[int], object], contexts: List[ShardContext]):
    """Run `body(i)` for every shard, each on a thread of its own under
    `contexts[i]` with autograd on; returns their results in order. A
    failing shard breaks the group's barrier, and the first real error is
    raised here."""
    if count == 1:
        with torch.enable_grad(), sharded(contexts[0]):
            return [body(0)]
    results: List = [None] * count
    errors: List[Optional[BaseException]] = [None] * count
    group = contexts[0].group

    def go(i):
        try:
            with torch.enable_grad(), sharded(contexts[i]):
                results[i] = body(i)
        except BaseException as e:
            errors[i] = e
            if group is not None:
                group.abort()

    threads = [threading.Thread(target=go, args=(i,), daemon=True,
                                name=f"shard-{i}") for i in range(count)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if group is not None and group.error is not None:
        raise group.error
    real = [e for e in errors
            if e is not None and not isinstance(e, threading.BrokenBarrierError)]
    if real:
        raise real[0]
    if any(e is not None for e in errors):
        raise errors[0]
    return results
