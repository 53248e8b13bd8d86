"""ParallelWrapper: data-parallel training over a device mesh.

Port of `deeplearning4j_tpu/parallel/wrapper.py` (reference
parallelism/ParallelWrapper.java:48-264): the same builder, `fit`,
`fit_batch`, `finalize`, `shutdown`, `step_hooks` and metric families.

**Sync mode** (`averaging_frequency=1`) is one step on the global batch,
computed shard by shard. The batch (padded to a multiple of the shard
count with zero-weight rows, `_pad_lmask`) is cut into contiguous row
blocks, one per data shard of the mesh; each shard runs the network's own
forward on its block, on its device, on a thread of its own, with the
parameters of its device as autograd leaves (shards on one device share
them). Where rows meet, the shards meet (nn/shards.py): dropout draws the
global batch's mask and each shard keeps its rows, BatchNormalization
normalizes by the moments of the whole batch, and the output layers score
the concatenation once. One backward from that score reaches every
shard's forward; the gradients of each device's leaves are summed onto the
network's device (the all-reduce of the JAX package's sharded jit), and
the network's own update (`_apply_step`) takes them. So the step is the
global-batch step, BN statistics and dropout masks included, with every
row-wise layer (convolutions, LRN through K1 and K2, attention) run once
per shard. Under truncated BPTT each shard carries its own rows of the
recurrent carry.

In a multi-process mesh (parallel/multihost.py) each process runs its
own shards as above and the processes then average their gradients over
the process group (`torch.distributed.all_reduce`). The meeting points
reach across the processes too (nn/shards.py): the dropout mask is the
global batch's, BatchNormalization's moments and their gradient are
all-reduced as SyncBatchNorm's are, and each process's score is weighted
by its share of the global batch's labels-mask weight, so the step is
still the global-batch step.

**Local SGD** (`averaging_frequency > 1`, ParallelWrapper.java:417-424) keeps
one replica per shard: parameters, updater state, layer state, dropout
generator and recurrent carry. Each round every replica takes the
network's own step on its block (so a replica is bitwise an independent
network fitted on its shard), and every F rounds the parameters, updater
state and layer state are averaged (the recurrent carry stays each
replica's, `avg_keep_carry`) and handed back to every replica. The
network's trees follow replica 0 between averages.
"""
from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from typing import List, Optional

import numpy as np
import torch

from ..data.padding import pad_lmask_zero_weight, repeat_tail_rows
from ..nn import shards
from ..nn.layers.recurrent import RECURRENT_CARRY_KEYS
from ..optimize import metrics as metrics_mod
from ..utils import params as param_utils
from ..utils.device import canonical
from . import mesh as mesh_lib

log = logging.getLogger(__name__)

Tensor = torch.Tensor


def _cut(t, lo: int, hi: int, dev: torch.device):
    """Rows [lo, hi) of a tensor, a dict of tensors or None, on `dev`."""
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _cut(v, lo, hi, dev) for k, v in t.items()}
    return t[lo:hi].to(dev)


def _pad_rows(t, pad: int):
    if isinstance(t, dict):
        return {k: _pad_rows(v, pad) for k, v in t.items()}
    return repeat_tail_rows(t, pad)


def _state_items(state):
    """(key, per-layer state dict) pairs of an MLN tuple or a graph dict."""
    return state.items() if isinstance(state, dict) else enumerate(state)


def _rebuild(like, items):
    if isinstance(like, dict):
        return dict(items)
    return tuple(v for _, v in items)


def _cut_state(state, lo: int, hi: int, dev: torch.device):
    """A shard's layer state: its rows of every recurrent carry, the rest
    whole, on `dev`."""
    return _rebuild(state, [
        (k, {n: (v[lo:hi] if n in RECURRENT_CARRY_KEYS else v).to(dev)
             for n, v in st.items()}) for k, st in _state_items(state)])


def _merge_states(states, dev: torch.device):
    """The shards' new states as one: the carries concatenated by rows,
    everything else from shard 0 (equal on every shard of a group)."""
    first = states[0]
    items = []
    for k, st in _state_items(first):
        per = [s[k] for s in states]
        items.append((k, {n: (torch.cat([p[n].to(dev) for p in per], 0)
                              if n in RECURRENT_CARRY_KEYS else v.to(dev))
                          for n, v in st.items()}))
    return _rebuild(first, items)


def _leaves(tree) -> List[Tensor]:
    return [t for _, lp in _state_items(tree) for t in lp.values()]


def allreduce_mean_(tensors: List[Tensor]) -> float:
    """Average `tensors` in place over the process group, one flat buffer
    per type (gloo and NCCL both take CUDA tensors for all_reduce); returns
    the milliseconds it took."""
    dist = torch.distributed
    n = dist.get_world_size()
    t0 = time.perf_counter()
    by_type = {}
    for t in tensors:
        by_type.setdefault((t.dtype, t.device), []).append(t)
    for group in by_type.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat /= n
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    return (time.perf_counter() - t0) * 1000.0


class ParallelWrapper:
    """Data-parallel trainer for MultiLayerNetwork and ComputationGraph
    (reference ParallelWrapper.Builder surface)."""

    def __init__(self, model, mesh: Optional[mesh_lib.Mesh] = None,
                 workers: Optional[int] = None,
                 averaging_frequency: int = 1,
                 prefetch_buffer: int = 8):
        self.model = model
        self.mesh = mesh if mesh is not None else \
            mesh_lib.data_parallel_mesh(workers)
        if mesh_lib.DATA_AXIS not in self.mesh.axis_names:
            raise ValueError(
                f"ParallelWrapper needs a mesh with a '{mesh_lib.DATA_AXIS}' "
                f"axis; got axes {self.mesh.axis_names}")
        self.data_shards = int(self.mesh.shape[mesh_lib.DATA_AXIS])
        # Multi-process: every process feeds its LOCAL partition; the
        # global batch is their concatenation in rank order.
        self.multiprocess = mesh_lib.is_multiprocess(self.mesh)
        positions = self.mesh.local_positions()
        if self.multiprocess:
            nproc = mesh_lib.process_count()
            if self.data_shards % nproc != 0 or self.data_shards < nproc:
                raise ValueError(
                    f"multi-host mesh: data axis size ({self.data_shards}) "
                    f"must be a positive multiple of the process count "
                    f"({nproc}) so every process owns an equal slice")
        self.local_shards = len(positions)
        self._first_shard = positions[0]
        self.devices = self.mesh.local_devices()
        if int(averaging_frequency) < 1:
            raise ValueError("averaging_frequency must be >= 1")
        self.averaging_frequency = int(averaging_frequency)
        self.prefetch_buffer = prefetch_buffer
        # Called with the model's iteration after every fit_batch: the
        # cluster health plane wires its step-progress watchdog here
        # (parallel/cluster_health.py).
        self.step_hooks = []
        #: milliseconds of the last step's gradient (or average) all-reduce
        #: over the process group; 0 in one process
        self.last_allreduce_ms = 0.0
        self._warned_pad = False
        # ---- local SGD (averaging_frequency > 1) ----
        self._replicas: Optional[List[dict]] = None
        self._synced_params_ref = None
        self._since_avg = 0

    @staticmethod
    def builder(model) -> "ParallelWrapperBuilder":
        return ParallelWrapperBuilder(model)

    def _check_device(self):
        net = self.model
        if canonical(net.device) != self.devices[0]:
            raise ValueError(
                f"the network lives on {net.device}, but the mesh's first "
                f"local shard is on {self.devices[0]}; init the network "
                "there")

    def _check_local_divisible(self, n: int):
        """A multi-process step needs every process to run the same shapes,
        so a local batch must divide over the local shards (the reference
        repartitions to balance, BalancedPartitioner)."""
        if n % self.local_shards != 0:
            raise ValueError(
                f"multi-host training requires the per-process batch ({n}) "
                f"to be divisible by the process-local shard count "
                f"({self.local_shards}); repartition your data")

    def _pad_rows_for(self, n: int) -> int:
        """Rows to append to a batch of `n`: a multi-process batch must
        divide over the local shards, a truncated-BPTT batch over the mesh
        (its carry is sized to the batch); any other batch pads to a
        multiple of the shard count."""
        if self.multiprocess:
            self._check_local_divisible(n)
            return 0
        pad = (-n) % self.data_shards
        if pad and self.model._rnn_carry is not None:
            raise ValueError(
                f"truncated-BPTT batch size {n} must divide the "
                f"{self.data_shards}-way data mesh")
        return pad

    def _pad_lmask(self, lmask, n: int, pad: int):
        """A zero-weight labels mask over `pad` appended rows (data/padding.py's
        contract: the loss, numerator and normalization, is the unpadded
        batch's). Pad rows still run the forward, so BatchNormalization's
        batch statistics and shape-dependent dropout draws include them:
        use divisible batches for an exact match on BN or dropout models."""
        if pad == 0:
            return lmask
        if not self._warned_pad:
            log.warning(
                "Batch size %d not divisible by %d data shards; padding with "
                "zero-loss-weight copies of the tail example. Loss/gradients "
                "match single-device exactly, but BatchNorm batch statistics "
                "and dropout draws include the pad rows — use divisible "
                "batch sizes for bit-exact equivalence", n, self.data_shards)
            self._warned_pad = True
        if isinstance(lmask, Tensor):
            lmask = lmask.cpu().numpy()
        return pad_lmask_zero_weight(lmask, n, pad)

    def _prep_mln(self, x, y, fmask, lmask):
        """A MultiLayerNetwork batch on the network's device, padded: (rows,
        (x, y, fmask, lmask))."""
        net = self.model
        n = np.shape(x)[0]
        pad = self._pad_rows_for(n)
        lmask = net._as_mask(self._pad_lmask(lmask, n, pad))
        x, y, fmask = net._as_input(x), net._as_labels(y), net._as_mask(fmask)
        x, y, fmask = (repeat_tail_rows(t, pad) for t in (x, y, fmask))
        return n + pad, (x, y, fmask, lmask)

    def _prep_graph(self, inputs, labels, fmasks, lmasks):
        """A packed ComputationGraph batch, padded: (rows, (inputs, labels,
        fmasks, lmasks))."""
        net = self.model
        n = next(iter(inputs.values())).shape[0]
        pad = self._pad_rows_for(n)
        lmasks = {name: self._pad_lmask(lmasks.get(name), n, pad)
                  for name in labels}
        lmasks = {k: net._as_mask(m) for k, m in lmasks.items() if m is not None}
        return n + pad, (_pad_rows(inputs, pad), _pad_rows(labels, pad),
                         _pad_rows(fmasks, pad) if fmasks else fmasks, lmasks)

    # -------------------------------------------------------------------- fit
    def fit(self, data, labels=None, *, epochs: int = 1,
            batch_size: int = 128) -> "ParallelWrapper":
        """The network's own epoch/listener loop with the sharded step
        substituted. Batches are prefetched onto the mesh's first local
        device (`prefetch_sharding`), where the step cuts its shards; a
        batch the shard count does not divide stays on the host for the
        zero-weight pad. A multi-process mesh feeds from the host."""
        self.model._check_init()
        prefetch = dict(prefetch_to_device=not self.multiprocess,
                        prefetch_sharding=None if self.multiprocess
                        else mesh_lib.batch_sharded(self.mesh),
                        prefetch_divisor=self.data_shards)
        if hasattr(self.model, "_pack"):  # ComputationGraph
            self.model.fit(data, labels, epochs=epochs,
                           batch_size=batch_size, step_fn=self.fit_batch,
                           **prefetch)
        else:
            self.model.fit(data, labels, epochs=epochs, batch_size=batch_size,
                           async_queue_size=self.prefetch_buffer,
                           step_fn=self.fit_batch, **prefetch)
        self.finalize()
        return self

    def fit_batch(self, ds) -> None:
        """One data-parallel batch: with averaging_frequency == 1 one
        synchronous sharded step (a step per window under truncated BPTT);
        otherwise one local step per replica (see the module docstring).
        A DataSet for MultiLayerNetwork, a MultiDataSet or DataSet for
        ComputationGraph."""
        net = self.model
        net._check_init()
        self._check_device()
        graph = hasattr(net, "_pack")
        if self.averaging_frequency > 1:
            self._ensure_replicas()
            for r in self._replicas:
                r["carry"] = None
            if graph:
                net.fit_batch(ds, do_step=self._local_graph_step)
            else:
                net._fit_batch(ds, do_step=self._local_step)
            for r in self._replicas:
                r["carry"] = None
            self._fire_step_hooks()
            return
        metrics_mod.registry().counter(
            "data_parallel_steps_total",
            "ParallelWrapper optimizer steps by mode"
            ).labels(mode="sync", workers=str(self.data_shards)).inc()
        if graph:
            net.fit_batch(ds, do_step=self._sync_graph_step)
        else:
            net._fit_batch(ds, do_step=self._sync_step)
        self._fire_step_hooks()

    def _fire_step_hooks(self):
        if not self.step_hooks:
            return
        it = int(self.model.iteration)
        for h in list(self.step_hooks):
            h(it)

    # ------------------------------------------------------------- sync mode
    def _sync_step(self, *batch) -> None:
        net = self.model
        rows, (x, y, fmask, lmask) = self._prep_mln(*batch)
        self._sharded_step(rows, lambda params, state, cut, gen: net._loss(
            params, state, cut(x), cut(y), cut(fmask), cut(lmask), True, gen))

    def _sync_graph_step(self, *batch) -> None:
        net = self.model
        rows, (inputs, labels, fmasks, lmasks) = self._prep_graph(*batch)
        self._sharded_step(rows, lambda params, state, cut, gen: net._loss(
            params, state, cut(inputs), cut(labels), cut(fmasks),
            cut(lmasks), True, gen))

    def _sharded_step(self, rows: int, loss_fn) -> None:
        """One synchronous step over `rows` local rows: every local shard
        runs `loss_fn(its device's parameter leaves, its state, cut, its
        generator)` on its thread (`cut(t)` gives its rows of t on its
        device), one backward from shard 0's score, the leaves' gradients
        summed onto the network's device (and averaged over the process
        group), then the network's own update."""
        net = self.model
        L = self.local_shards
        c = rows // L
        dev0 = net.device
        trees = {}
        for d in self.devices:
            if d not in trees:
                trees[d] = param_utils.tree_map(
                    lambda t: t.detach().to(d).requires_grad_(),
                    net.params_tree)
        state = net._merged_state()
        gen_state = net._dropout_gen.get_state()
        gens = []
        for _ in range(L):
            g = torch.Generator(device=net._dropout_gen.device)
            g.set_state(gen_state)
            gens.append(g)
        group = shards.ShardGroup(L) if L > 1 else None
        base, total = self._first_shard * c, c * self.data_shards
        processes = torch.distributed.group.WORLD if self.multiprocess else None
        ctxs = [shards.ShardContext(i, L, base + i * c, c, total, group,
                                    processes) for i in range(L)]

        def body(i):
            d = self.devices[i]
            cut = lambda t: _cut(t, i * c, (i + 1) * c, d)
            return loss_fn(trees[d], _cut_state(state, i * c, (i + 1) * c, d),
                           cut, gens[i])

        outs = shards.run(L, body, ctxs)
        loss = outs[0][0]
        devs = list(trees)
        flat = [t for d in devs for t in _leaves(trees[d])]
        grads = torch.autograd.grad(loss, flat, allow_unused=True) \
            if flat else ()
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, flat)]
        per = len(flat) // len(devs)
        summed = grads[:per]
        for k in range(1, len(devs)):
            summed = [a + b.to(dev0)
                      for a, b in zip(summed, grads[k * per:(k + 1) * per])]
        loss = loss.detach()
        if self.multiprocess:
            self.last_allreduce_ms = allreduce_mean_(summed + [loss.reshape(1)])
            metrics_mod.registry().histogram(
                "data_parallel_allreduce_ms",
                "Gradient all-reduce over the process group per step"
                ).observe(self.last_allreduce_ms)
        it = iter(summed)
        grad_tree = _rebuild(net.params_tree, [
            (k, {n: next(it) for n in lp})
            for k, lp in _state_items(net.params_tree)])
        new_state = _merge_states([o[1] for o in outs], dev0)
        net._dropout_gen.set_state(gens[0].get_state())
        net._apply_step(loss, grad_tree, new_state)
        metrics_mod.record_train_step(1)
        for lst in net.listeners:
            lst.iteration_done(net, net.iteration)

    # ------------------------------------------------- local SGD (freq > 1)
    def _ensure_replicas(self):
        """One replica per local shard, copied from the network; rebuilt if
        the network's parameters were replaced behind the wrapper's back
        (a checkpoint restore, a direct net.fit)."""
        net = self.model
        if self._replicas is not None and \
                net.params_tree is self._synced_params_ref:
            return
        gen_state = net._dropout_gen.get_state()
        reps = []
        for d in self.devices:
            copy = lambda tree: param_utils.tree_map(
                lambda t: t.detach().to(d, copy=True), tree)
            g = torch.Generator(device=net._dropout_gen.device)
            g.set_state(gen_state)
            reps.append({"params": copy(net.params_tree),
                         "opt": copy(net.opt_state),
                         "state": copy(net.state_tree), "carry": None,
                         "gen": g, "device": d})
        self._replicas = reps
        self._synced_params_ref = net.params_tree
        self._since_avg = 0

    @contextmanager
    def _as_replica(self, rep: dict):
        """Lend the network replica `rep`'s trees, carry, generator and
        device for one of its own steps, then take them back."""
        net = self.model
        saved = (net.params_tree, net.opt_state, net.state_tree,
                 net._rnn_carry, net._dropout_gen, net.device, net.iteration,
                 net.score_value)
        net.params_tree, net.opt_state = rep["params"], rep["opt"]
        net.state_tree, net._rnn_carry = rep["state"], rep["carry"]
        net._dropout_gen, net.device = rep["gen"], rep["device"]
        try:
            yield
        finally:
            rep["params"], rep["opt"] = net.params_tree, net.opt_state
            rep["state"], rep["carry"] = net.state_tree, net._rnn_carry
            (net.params_tree, net.opt_state, net.state_tree, net._rnn_carry,
             net._dropout_gen, net.device, net.iteration,
             net.score_value) = saved

    def _local_step(self, *batch) -> None:
        self._local_round(*self._prep_mln(*batch))

    def _local_graph_step(self, *batch) -> None:
        self._local_round(*self._prep_graph(*batch))

    def _local_round(self, rows: int, data) -> None:
        """One local step on every replica, each on its rows of `data` (the
        arguments of the network's `_train_step`), on its device."""
        net = self.model
        c = rows // self.local_shards
        tbptt = net._rnn_carry is not None
        losses = []
        for i, rep in enumerate(self._replicas):
            with self._as_replica(rep):
                if tbptt:
                    net._seed_recurrent_states(c)
                losses.append(net._train_step(*(
                    _cut(t, i * c, (i + 1) * c, rep["device"]) for t in data)))
        self._after_local_round([l.to(self.devices[0]) for l in losses])

    def _after_local_round(self, losses):
        net = self.model
        self._since_avg += 1
        net.iteration += 1
        net.score_value = torch.stack(losses).mean()
        reg = metrics_mod.registry()
        c = reg.counter("data_parallel_worker_steps_total",
                        "Local-SGD steps per replica (worker-labeled)")
        for w in range(self.local_shards):
            c.labels(worker=str(self._first_shard + w)).inc()
        reg.counter("data_parallel_steps_total",
                    "ParallelWrapper optimizer steps by mode"
                    ).labels(mode="local_sgd",
                             workers=str(self.data_shards)).inc()
        metrics_mod.record_train_step(1)
        if self._since_avg >= self.averaging_frequency:
            self._average()
        self._sync_net_from_replicas()
        for lst in net.listeners:
            lst.iteration_done(net, net.iteration)

    def _average(self):
        """averageAndPropagate: the replicas' parameters, updater state and
        layer state (never a recurrent carry) averaged, over the process
        group too, and handed back to every replica."""
        reps = self._replicas
        dev0 = self.devices[0]

        def mean(ts):
            if not isinstance(ts[0], Tensor) or not ts[0].is_floating_point():
                return ts[0]
            m = torch.stack([t.to(dev0) for t in ts]).mean(0)
            return torch.empty_like(ts[0], device=dev0).copy_(m)

        avg = {}
        for key in ("params", "opt", "state"):
            leaves = [param_utils.tree_leaves(r[key]) for r in reps]
            avg[key] = [mean(list(ts)) for ts in zip(*leaves)]
        if self.multiprocess:
            floats = [t for key in avg for t in avg[key]
                      if isinstance(t, Tensor) and t.is_floating_point()]
            self.last_allreduce_ms = allreduce_mean_(floats)
        for r in reps:
            for key in ("params", "opt", "state"):
                r[key] = param_utils.tree_unflatten(r[key], [
                    t.to(r["device"], copy=True) if isinstance(t, Tensor)
                    else t for t in avg[key]])
        self._since_avg = 0
        metrics_mod.registry().counter(
            "data_parallel_averages_total",
            "Parameter averages across replicas (averageAndPropagate)"
            ).labels(workers=str(self.data_shards)).inc()

    def _sync_net_from_replicas(self):
        """The network's trees follow replica 0 (the averaged values right
        after an average), so listeners and checkpoints never see a tree a
        whole window old."""
        net, rep = self.model, self._replicas[0]
        net.params_tree, net.opt_state = rep["params"], rep["opt"]
        net.state_tree = rep["state"]
        net._dropout_gen.set_state(rep["gen"].get_state())
        self._synced_params_ref = net.params_tree

    def finalize(self):
        """Average a partial window and sync the network (the reference
        averages once more when fit() drains, ParallelWrapper.java:231-263)."""
        if self._replicas is not None and self._since_avg > 0:
            self._average()
            self._sync_net_from_replicas()

    def shutdown(self):
        """Reference ParallelWrapper.shutdown(): averages a pending local
        window, then drops the replicas."""
        self.finalize()
        self._replicas = None
        self._synced_params_ref = None


class ParallelWrapperBuilder:
    """Fluent builder mirroring reference ParallelWrapper.Builder."""

    def __init__(self, model):
        self._model = model
        self._workers = None
        self._avg_freq = 1
        self._prefetch = 8
        self._mesh = None

    def workers(self, n: int):
        self._workers = int(n)
        return self

    def averaging_frequency(self, n: int):
        self._avg_freq = int(n)
        return self

    def prefetch_buffer(self, n: int):
        self._prefetch = int(n)
        return self

    def mesh(self, m: mesh_lib.Mesh):
        self._mesh = m
        return self

    def build(self) -> ParallelWrapper:
        return ParallelWrapper(self._model, mesh=self._mesh,
                               workers=self._workers,
                               averaging_frequency=self._avg_freq,
                               prefetch_buffer=self._prefetch)
