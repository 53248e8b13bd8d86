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
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, List, Optional

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
class ShardContext:
    """Shard `index` of `count`: rows [start, start + rows) of a global
    batch of `total` rows, meeting its sibling shards in `group` (None when
    each process holds one shard, or the moments and score stay local)."""

    index: int
    count: int
    start: int
    rows: int
    total: int
    group: Optional[ShardGroup] = None
    processes: Optional[object] = None   # a torch.distributed ProcessGroup


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
    shape = (ctx.total,) + tuple(x.shape[1:])
    r = torch.rand(shape, generator=generator, device=generator.device)
    return (r[ctx.start:ctx.start + x.shape[0]] < keep).to(x.device)


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
