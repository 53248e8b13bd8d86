"""The fit loop shared by MultiLayerNetwork and ComputationGraph.

Port of the loop body of the JAX package's `MultiLayerNetwork.fit` and
`ComputationGraph.fit` (nn/multilayer.py:485, nn/graph/graph.py:467), which
the JAX package writes out twice, and of its `_commit_multi`. (Its
nn/stepping.py caches the step counter on the device for its jitted step;
the port's step reads the counter as a Python int, so there is nothing to
cache and this module holds the loop instead.)

The input pipeline (`data_pipeline`): the base iterator, padded to the
epoch's batch shape under the zero-weight mask contract
(`PadToBucketIterator`, not under truncated BPTT), then prefetched on a
producer thread (`AsyncDataSetIterator`) or staged onto the network's
device by it (`DevicePrefetchIterator`), unless `use_async` is off or the
iterator opts out (AsyncShield).

The loop (`run_fit`): per batch, the `step` span (its `etl` child timed
around the iterator poll, `last_etl_ms` / `last_etl_host_ms` /
`last_etl_h2d_ms`), the sentinel's pre-step snapshot, the `dispatch` span
(one step, or the batch joins a group of `steps_per_dispatch` same-shaped
batches that `fit_batches` runs in one call; a batch of another shape
flushes the group first), `train_step_dispatch_ms`, the sampled device
fence (`device_fence_wait_ms`), the sentinel's check and the checkpoint
cadence. An epoch ends by flushing the partial group, counting
`train_epochs_total`, the listeners' `on_epoch_end` and the checkpoint's
epoch hook. `resume` restores the newest valid checkpoint and skips the
batches it covers; `epochs` counts the run's total epochs.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, List

from ..data.iterators import (AsyncDataSetIterator, AsyncMultiDataSetIterator,
                              DevicePrefetchIterator, PadToBucketIterator)
from ..optimize import metrics as metrics_mod
from ..optimize import tracing

log = logging.getLogger(__name__)


def check_fit_args(net, epochs: int, steps_per_dispatch: int, step_fn,
                   checkpoint, resume: bool, sentinel):
    """Validate `fit`'s hooks and, with `resume`, restore the newest valid
    checkpoint into `net`. Returns (epochs still to run, batches of the
    first of them already covered)."""
    spd = int(steps_per_dispatch)
    if spd > 1 and step_fn is not None:
        raise ValueError("steps_per_dispatch cannot combine with a "
                         "custom step_fn")
    if spd > 1 and (checkpoint is not None or sentinel is not None):
        raise ValueError("checkpoint=/sentinel= need per-step hooks; "
                         "use steps_per_dispatch=1")
    if resume and checkpoint is None:
        raise ValueError("resume=True requires checkpoint=a "
                         "CheckpointManager to resume from")
    skip_batches = 0
    if resume:
        rec = checkpoint.restore_into(net)
        if rec is not None:
            epochs = max(0, int(epochs) - int(net.epoch))
            skip_batches = int(rec.get("batches_into_epoch", 0) or 0)
            log.info("auto-resume: restored %s (iteration %d, %d epoch(s) "
                     "done, %d batch(es) into the next); %d epoch(s) remain",
                     rec.get("file"), net.iteration, net.epoch, skip_batches,
                     epochs)
    return int(epochs), skip_batches


def data_pipeline(net, it, *, pad: bool, use_async: bool, queue_size: int,
                  prefetch_to_device: bool, prefetch_depth: int,
                  prefetch_sharding, prefetch_divisor: int, multi: bool):
    """`it` padded to bucket (`pad`) and wrapped for prefetch, as above."""
    if pad:
        it = PadToBucketIterator(it)
    if not (use_async and getattr(it, "async_supported", lambda: True)()):
        return it
    if prefetch_to_device:
        return DevicePrefetchIterator(
            it, depth=max(1, int(prefetch_depth)), sharding=prefetch_sharding,
            batch_divisor=prefetch_divisor, cast_dtype=net._dtype,
            device=net.device)
    return (AsyncMultiDataSetIterator if multi else AsyncDataSetIterator)(
        it, queue_size)


def group_signature(ds):
    """What batches must share to run in one group: the shapes of every
    array and which masks are present (shape metadata only)."""
    if hasattr(ds, "features_masks"):   # MultiDataSet
        return (tuple(tuple(f.shape) for f in ds.features),
                tuple(tuple(l.shape) for l in ds.labels),
                ds.features_masks is None, ds.labels_masks is None)
    return (tuple(ds.features.shape), tuple(ds.labels.shape),
            ds.features_mask is None, ds.labels_mask is None)


def register_fit_metrics(reg) -> tuple:
    """The fit loop's families on `reg`, constructed once a `fit` call:
    (per-batch dispatch histogram, fence-wait gauge, epoch counter)."""
    return (reg.histogram("train_step_dispatch_ms",
                          "Host-side enqueue time per fit-loop batch "
                          "(device time needs the fence)"),
            reg.gauge("device_fence_wait_ms",
                      "Queue drain at the last sampled fence "
                      "(device-compute backlog)"),
            reg.counter("train_epochs_total", "Completed fit epochs"))


def run_fit(net, wrapped, *, epochs: int, step: Callable, spd: int,
            checkpoint, sentinel, skip_batches: int,
            coerce: Callable = lambda ds: ds):
    """The epochs of `fit` over the pipeline `wrapped` (see the module
    docstring). `step(batch)` runs one batch; `coerce` turns a batch from
    the iterator into what `step` and `net.fit_batches` take."""
    group: List = []

    def flush_group():
        if not group:
            return
        if len(group) == 1:
            step(group[0])
        else:
            net.fit_batches(group)
        group.clear()

    reg = metrics_mod.registry()
    dispatch_ms, fence_wait_ms, epochs_total = register_fit_metrics(reg)
    fit_sp = tracing.begin("fit", epochs=epochs)
    try:
        for _ in range(epochs):
            epoch_sp = tracing.begin("epoch", epoch=net.epoch)
            # Resumed run: re-consume (and discard) the batches the
            # restored checkpoint already covers, first epoch only.
            to_skip, skip_batches = skip_batches, 0
            batches_done = to_skip
            it_epoch = iter(wrapped)
            while True:
                # The step span opens BEFORE the iterator is polled so its
                # etl child nests inside it; an exhausted iterator cancels
                # the empty span.
                step_sp = tracing.begin("step", step_num=net.iteration)
                t0 = time.perf_counter()
                try:
                    ds = next(it_epoch)
                except StopIteration:
                    step_sp.cancel()
                    break
                if to_skip > 0:
                    to_skip -= 1
                    step_sp.cancel()
                    continue
                etl_s = time.perf_counter() - t0
                net.last_etl_ms = etl_s * 1000.0
                # Device-prefetched batches carry the producer-side split:
                # host wait (base iterator) vs h2d (pinned copy and its
                # wait). Host-fed batches attribute the whole wait to the
                # host side.
                net.last_etl_host_ms = getattr(ds, "_etl_host_ms", net.last_etl_ms)
                net.last_etl_h2d_ms = getattr(ds, "_etl_h2d_ms", 0.0)
                tracing.add_span("etl", t0, etl_s)
                ds = coerce(ds)
                metrics_mod.record_etl(
                    reg, net.last_etl_ms, net.last_etl_host_ms,
                    net.last_etl_h2d_ms, metrics_mod.batch_rows(ds))
                t1 = time.perf_counter()
                if sentinel is not None:
                    sentinel.before_step(net)
                with tracing.span("dispatch"):
                    if spd <= 1:
                        step(ds)
                    else:
                        if group and group_signature(ds) != group_signature(group[0]):
                            flush_group()
                        group.append(ds)
                        if len(group) >= spd:
                            flush_group()
                dispatch_ms.observe((time.perf_counter() - t1) * 1000.0)
                w = tracing.fence(net.iteration, net.score_value)
                if w is not None:
                    fence_wait_ms.set(w)
                if sentinel is not None:
                    sentinel.after_step(net)
                batches_done += 1
                if checkpoint is not None:
                    checkpoint.on_batch(net, batches_done)
                step_sp.end()
            if group:  # end of epoch: run the partial group
                with tracing.span("dispatch", flush="epoch_tail"):
                    flush_group()
            net.epoch += 1
            epochs_total.inc()
            for lst in net.listeners:
                if hasattr(lst, "on_epoch_end"):
                    lst.on_epoch_end(net, net.epoch)
            if checkpoint is not None:
                checkpoint.on_epoch(net)
            epoch_sp.end()
    finally:
        fit_sp.end()
        if isinstance(wrapped, AsyncDataSetIterator):
            wrapped.shutdown()


def commit_multi(net, losses, steps: int, listener_events=None) -> None:
    """Publish a group's results: `steps` optimizer iterations were taken
    (the counter has moved already), `losses` holds one 0-d loss per
    listener event (a truncated-BPTT repeat records the loss of its last
    window while taking several window steps). Listeners fire once per
    event, numbered `per = steps // events` apart, with `score_value` that
    event's loss; it ends as the last one."""
    events = steps if listener_events is None else listener_events
    metrics_mod.record_train_step(steps)
    net.score_value = losses[-1]
    if net.listeners:
        per = steps // max(events, 1)
        for k in range(events):
            net.score_value = losses[k]
            for lst in net.listeners:
                lst.iteration_done(net, net.iteration - steps + (k + 1) * per)
        net.score_value = losses[-1]
