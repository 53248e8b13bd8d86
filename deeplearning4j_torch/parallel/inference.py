"""ParallelInference: multi-client serving with dynamic batching.

Port of `deeplearning4j_tpu/parallel/inference.py` (reference
parallelism/ParallelInference.java). BATCHED mode is the headline path: a
collector thread drains the request queue, pads the coalesced batch to a
power-of-two bucket, runs ONE forward of the network on its device, and
hands each waiting caller its rows. SEQUENTIAL mode runs each request as its
own forward under a lock.

Kept from the JAX package: both modes, the typed errors, deadline shedding,
the finite-output check, batch-failure isolation (a failed batch is retried
request by request so only the offender fails), warmup over the bucket set,
shutdown that serves queued stragglers and fails whatever it cannot, and
packed admission: short single-sequence requests coalesce into ONE
``[1, pack_bucket]`` row separated by segment ids (the features mask of a
model whose attention layers run ``packed_segments=True``), which reaches
the flash kernels (K3) with segment ids on the GPU.

The serving plane (serving/model_pool.py, serving/gateway.py) drives it
through the JAX package's hooks: `on_shed(request, reason)`,
`on_batch(requests, rows, bucket, dur_s)` and `on_batch_error(exc,
n_requests)`; a `scheduler` (serving/scheduler.DeviceScheduler) whose slot
every forward holds, entered inside the engine lock; `paused()`, the
hot-swap window; `queue_depth()` and `estimate_wait_s()` (an EWMA of the
batch time) for admission; and `output(transform=, tag=, trace=)`: a
per-request view of its rows (a fused member's columns), a name for
failure attribution (`BatchExecutionError.request_tags`) and a
flight-recorder trace whose phases the engine marks.

A coalesced batch reaches the card through the same pinned staging as the
fit loop's device prefetch (data/iterators.PinnedStager): a copy into a
pinned host buffer, a `non_blocking` copy on the stager's stream and a wait
for it, then the forward on the device tensor.
"""
from __future__ import annotations

import collections
import contextlib
import enum
import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..data.iterators import PinnedStager
from ..data.padding import next_pow2_bucket, record_packing, repeat_tail_rows
from ..utils import faults


class InferenceMode(enum.Enum):
    """Reference parallelism/inference/InferenceMode.java."""
    SEQUENTIAL = "sequential"
    BATCHED = "batched"


class ServerClosedError(RuntimeError):
    """The server was shut down while (or before) this request was
    queued — the caller gets this instead of hanging forever."""


class BatchExecutionError(RuntimeError):
    """A coalesced forward raised: only the requests riding THAT batch
    fail (``__cause__`` carries the original exception); batchmates of a
    poisoned request are retried alone and the collector survives."""


class NonFiniteOutputError(BatchExecutionError):
    """A forward returned NaN/Inf rows with `check_finite` on."""


class QueueFullError(RuntimeError):
    """Admission queue at capacity: the backpressure signal."""


class DeadlineExceededError(RuntimeError):
    """The request's deadline passed before a forward could serve it."""


class DecodeStepError(BatchExecutionError):
    """One iteration-level decode step failed for the requests riding it:
    the victims get this typed wrapper (their KV blocks freed), decode
    batchmates keep generating on the next step."""


class KVCacheExhaustedError(QueueFullError):
    """The paged KV cache has no free blocks for this admission or growth
    step: the decode plane's backpressure signal."""


class _Request:
    __slots__ = ("x", "event", "result", "error", "deadline", "transform",
                 "tag", "trace")

    def __init__(self, x: np.ndarray, deadline: Optional[float] = None,
                 transform: Optional[Callable] = None,
                 tag: Optional[str] = None, trace=None):
        self.x = x
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        # Absolute time.monotonic() seconds; None = no SLO.
        self.deadline = deadline
        # Applied to this request's rows after the scatter (a fused
        # member's column slice); a raising transform fails only this
        # request.
        self.transform = transform
        # Routing identity for failure attribution (request_tags).
        self.tag = tag
        # Flight-recorder RequestTrace or None (every touch point is one
        # `is None` branch).
        self.trace = trace

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and \
            (now if now is not None else time.monotonic()) > self.deadline


class ParallelInference:
    """Thread-safe serving facade over an initialized MultiLayerNetwork or
    single-input, single-output ComputationGraph, which runs on the device
    it was initialized on. Both answer `output(x)` and `warmup(b)`."""

    def __init__(self, model, *, inference_mode: InferenceMode = InferenceMode.BATCHED,
                 batch_limit: int = 32, queue_limit: int = 64,
                 batch_timeout_ms: float = 2.0, check_finite: bool = False,
                 packed_admission: bool = False, pack_bucket: int = 0):
        if not getattr(model, "_initialized", False):
            raise RuntimeError("Model must be init()ed before serving")
        conf = model.conf
        if hasattr(conf, "network_inputs") and (
                len(conf.network_inputs) != 1 or len(conf.network_outputs) != 1):
            raise ValueError(
                f"ParallelInference serves a graph of one input and one output; "
                f"this one has {len(conf.network_inputs)} and "
                f"{len(conf.network_outputs)}")
        self.model = model
        self.inference_mode = inference_mode
        self.batch_limit = int(batch_limit)
        self.batch_timeout_ms = float(batch_timeout_ms)
        # Packed admission: capacity is tokens of one [1, pack_bucket] row,
        # not batch rows; an ineligible request (not one sequence, or too
        # long) takes the row path and is counted.
        self.packed_admission = bool(packed_admission)
        self.pack_bucket = int(pack_bucket)
        if self.packed_admission:
            if inference_mode != InferenceMode.BATCHED:
                raise ValueError(
                    "packed_admission requires InferenceMode.BATCHED")
            if self.pack_bucket < 1:
                raise ValueError(
                    "packed_admission needs pack_bucket >= 1 (the token "
                    "capacity of the packed row)")
        self.total_packed_requests = 0
        self.total_pack_fallbacks = 0
        self.check_finite = bool(check_finite)
        self._lock = threading.Lock()
        # used under self._lock only: one forward at a time stages
        self._stager = PinnedStager(model.device)
        self._enqueue_lock = threading.Lock()
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue(
            maxsize=queue_limit)
        self._shutdown = False
        self._worker: Optional[threading.Thread] = None
        # Observability: recent executed batch sizes (bounded) and lifetime
        # counters, bumped from caller threads and the collector alike.
        self.executed_batch_sizes = collections.deque(maxlen=1024)
        self.total_forwards = 0
        self.total_shed = 0
        self.total_batch_failures = 0
        self._stats_lock = threading.Lock()
        # EWMA of one coalesced forward's wall time, written under
        # self._lock; the admission estimate reads it without a lock.
        self._ewma_batch_s = 0.0
        self.warmed_buckets: List[int] = []
        # Gateway hooks (a broken hook never takes the server down):
        # on_shed(request, reason) on every deadline drop; on_batch(requests,
        # rows, bucket, dur_s) after every forward; on_batch_error(exc,
        # n_requests) after every failed forward attempt, solo retries
        # included.
        self.on_shed: Optional[Callable] = None
        self.on_batch: Optional[Callable] = None
        self.on_batch_error: Optional[Callable] = None
        # Cross-model device arbitration: with a DeviceScheduler attached
        # every forward holds one of its slots; None keeps the single-model
        # path.
        self.scheduler = None
        self.sched_name: Optional[str] = None
        if inference_mode == InferenceMode.BATCHED:
            self._worker = threading.Thread(
                target=self._collector_loop, name="ParallelInference-collector",
                daemon=True)
            self._worker.start()

    def _pack_eligible(self, x: np.ndarray) -> bool:
        """A request can ride a packed row iff it is a single sequence: one
        batch row of [1, t, features] with 1 <= t <= pack_bucket."""
        return (x.ndim == 3 and x.shape[0] == 1
                and 0 < x.shape[1] <= self.pack_bucket)

    @staticmethod
    def builder(model) -> "ParallelInferenceBuilder":
        return ParallelInferenceBuilder(model)

    # ----------------------------------------------------------------- warmup
    def warmup(self, *, max_bucket: Optional[int] = None,
               time_steps: Optional[int] = None) -> "ParallelInference":
        """Run one forward at every power-of-two bucket this server can
        coalesce to (1, 2, 4, ... batch_limit's bucket), so the first client
        request at any bucket finds its kernels built and cuDNN's choice
        made."""
        top = next_pow2_bucket(max_bucket or self.batch_limit)
        b = 1
        while b <= top:
            self.model.warmup(b, time_steps=time_steps)
            if b not in self.warmed_buckets:
                self.warmed_buckets.append(b)
            b <<= 1
        if self.packed_admission:
            # the packed forward carries a features mask (the segment ids)
            x_s = self.model._feature_struct(1, self.pack_bucket)
            dev = self.model.device
            self.model.output(torch.zeros(x_s.shape, dtype=x_s.dtype, device=dev),
                              features_mask=torch.zeros((1, self.pack_bucket),
                                                        device=dev))
        return self

    # -------------------------------------------------------------- admission
    def queue_depth(self) -> int:
        """Requests currently queued (a gauge: qsize races the collector)."""
        return self._queue.qsize()

    def estimate_wait_s(self) -> float:
        """Expected time until a request admitted now completes: the queued
        batches ahead of it plus its own forward, at the EWMA batch time.
        0.0 until the first forward seeds the EWMA."""
        svc = self._ewma_batch_s
        if svc <= 0.0:
            return 0.0
        batches_ahead = self.queue_depth() // max(1, self.batch_limit)
        return (batches_ahead + 1) * svc

    def _sched_slot(self, cost: float = 1.0):
        """The device-budget gate of one forward: a WFQ slot when a
        DeviceScheduler is attached, a no-op otherwise. Entered INSIDE
        self._lock, so a paused() hot swap never parks holding the shared
        slot, and the scheduler takes no engine lock (no deadlock)."""
        if self.scheduler is None:
            return contextlib.nullcontext()
        return self.scheduler.slot(self.sched_name or "?", cost=cost)

    @contextlib.contextmanager
    def paused(self):
        """Hold the execution lock: the forward in flight completes, then
        dispatch stalls; queued requests wait, none is dropped. The hot-swap
        window: the pool assigns new parameters inside it."""
        with self._lock:
            yield self

    # ----------------------------------------------------------------- output
    def output(self, x, *, deadline: Optional[float] = None,
               transform: Optional[Callable] = None,
               tag: Optional[str] = None, trace=None) -> np.ndarray:
        """Predict for one request (any leading batch size). Thread-safe;
        in BATCHED mode blocks until the coalesced forward containing this
        request completes.

        `deadline` is an absolute time.monotonic() second count: a request
        still unserved past it fails with :class:`DeadlineExceededError`. A
        full admission queue raises :class:`QueueFullError`, a closed server
        :class:`ServerClosedError`. `transform` maps this request's rows
        before the caller sees them (a raising transform fails only this
        request); `tag` names the request in ``err.request_tags``; `trace`
        is a flight-recorder RequestTrace whose phase cut points the engine
        marks (None records nothing)."""
        x = np.asarray(x)
        if x.ndim == 0:
            raise ValueError("Request must have a leading batch dimension")
        if self.inference_mode == InferenceMode.SEQUENTIAL:
            with self._enqueue_lock:
                closed = self._shutdown
            if closed:
                raise ServerClosedError("ParallelInference has been shut down")
            with self._lock:
                req = _Request(x, deadline, transform, tag, trace)
                if req.expired():
                    self._shed(req, "expired")
                    raise DeadlineExceededError("deadline passed before dispatch")
                try:
                    with self._sched_slot(float(x.shape[0])):
                        if trace is not None:
                            # no coalescing here: no queue or pack phases
                            trace.mark("sched_wait")
                            trace.mark("dispatch")
                        # swap-pause design: _lock held through the
                        # forward so hot-swap can quiesce the device
                        out = self._forward(x)  # jaxlint: disable=JL403
                        if trace is not None:
                            trace.mark("device")
                    self._require_finite(out)
                    if transform is not None:
                        out = transform(out)
                    if trace is not None:
                        trace.mark("unpack")
                except BaseException as e:
                    raise self._batch_failure(e, 1, reqs=[req])
                with self._stats_lock:
                    self.total_forwards += 1
                return out
        req = _Request(x, deadline, transform, tag, trace)
        # Enqueue under the same lock shutdown() uses to place its sentinel,
        # so no request can ever land BEHIND the sentinel and starve.
        with self._enqueue_lock:
            if self._shutdown:
                raise ServerClosedError("ParallelInference has been shut down")
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                raise QueueFullError(
                    f"ParallelInference queue limit ({self._queue.maxsize}) "
                    "exceeded — server overloaded") from None
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def _shed(self, req: _Request, reason: str) -> None:
        with self._stats_lock:
            self.total_shed += 1
        cb = self.on_shed
        if cb is not None:
            try:
                cb(req, reason)
            except Exception:
                pass  # a broken hook must never take the server down

    def _finish(self, r: _Request, rows) -> None:
        """Deliver one request's rows, through its transform when it has
        one; a raising transform fails only this request. The unpack mark
        lands before event.set(): once the caller wakes it owns the
        trace."""
        if r.transform is not None:
            try:
                rows = r.transform(rows)
            except BaseException as te:
                if r.trace is not None:
                    r.trace.mark("unpack")
                r.error = self._batch_failure(te, 1, reqs=[r])
                r.event.set()
                return
        r.result = rows
        if r.trace is not None:
            r.trace.mark("unpack")
        r.event.set()

    def _forward(self, x: np.ndarray) -> np.ndarray:
        # Chaos seam: armed "serve.forward" plans fail or delay this
        # forward deterministically by call ordinal.
        faults.fire("serve.forward")
        return self.model.output(self._stager.stage([x], [False])[0])

    def _require_finite(self, out) -> None:
        if self.check_finite and not np.isfinite(out).all():
            raise NonFiniteOutputError(
                "forward returned non-finite (NaN/Inf) outputs")

    def _batch_failure(self, e: BaseException, n_requests: int,
                       reqs: Optional[List[_Request]] = None
                       ) -> BatchExecutionError:
        """Record one failed forward attempt and return the typed error the
        affected callers see (original exception chained). The failed
        requests' tags ride along as ``err.request_tags``, so a shared
        engine's hook (a fused group) can charge the right members."""
        if isinstance(e, BatchExecutionError):
            err = e
        else:
            err = BatchExecutionError(
                f"forward failed for a {n_requests}-request batch: {e}")
            err.__cause__ = e
        if reqs is not None and not hasattr(err, "request_tags"):
            err.request_tags = [r.tag for r in reqs]
        with self._stats_lock:
            self.total_batch_failures += 1
        cb = self.on_batch_error
        if cb is not None:
            try:
                cb(err, n_requests)
            except Exception:
                pass  # a broken hook must never take the server down
        return err

    # -------------------------------------------------------------- collector
    def _collector_loop(self):
        try:
            if self.packed_admission:
                self._collect_packed()
            else:
                self._collect()
        except BaseException as e:
            # Collector must never die silently: mark the server down (under
            # the enqueue lock so no request can slip in after the drain)
            # and fail every queued caller so nobody waits forever.
            with self._enqueue_lock:
                self._shutdown = True
                self._fail_pending(e)
            raise

    def _collect(self):
        # Coalescing never assembles a batch past the bucket warmup() ran:
        # a request that would overflow is carried to the next batch.
        cap = next_pow2_bucket(self.batch_limit)
        carry: Optional[_Request] = None
        while True:
            if carry is not None:
                first, carry = carry, None
            else:
                try:
                    first = self._queue.get(timeout=0.1)
                except queue.Empty:
                    if self._shutdown:  # jaxlint: atomic
                        return
                    continue
            if first is None:  # shutdown sentinel: serve stragglers, exit
                self._drain_and_exit()
                return
            batch = [first]
            rows = first.x.shape[0]
            # Linger briefly for co-arriving requests unless this request
            # alone already fills the batch, then drain whatever is queued.
            if rows < self.batch_limit:
                time.sleep(self.batch_timeout_ms / 1000.0)
            saw_sentinel = False
            while rows < self.batch_limit:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    saw_sentinel = True
                    break
                if rows + nxt.x.shape[0] > cap:
                    carry = nxt
                    break
                batch.append(nxt)
                rows += nxt.x.shape[0]
            self._run_batch(batch)
            if saw_sentinel:
                self._drain_and_exit(carry)
                return

    def _drain_and_exit(self, carry: Optional[_Request] = None):
        """Serve every request still queued at shutdown, in cap-sized
        batches so even the shutdown flush stays on warmed buckets."""
        leftovers = [] if carry is None else [carry]
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if r is not None:
                leftovers.append(r)
        cap = next_pow2_bucket(self.batch_limit)
        batch: List[_Request] = []
        rows = 0
        for r in leftovers:
            if batch and rows + r.x.shape[0] > cap:
                self._run_batch(batch)
                batch, rows = [], 0
            batch.append(r)
            rows += r.x.shape[0]
        if batch:
            self._run_batch(batch)

    def _live(self, batch: List[_Request]) -> List[_Request]:
        """SLO late-shed: a request whose deadline passed while queued is
        failed now rather than spending forward rows on it."""
        now = time.monotonic()
        live = []
        for r in batch:
            if r.expired(now):
                self._shed(r, "expired")
                if r.trace is not None:
                    r.trace.mark("queue_wait")  # died waiting: show where
                r.error = DeadlineExceededError("deadline passed while queued")
                r.event.set()
            else:
                live.append(r)
        return live

    @staticmethod
    def _mark_all(traced: List[_Request], phase: str, **ctx) -> None:
        """One timestamp per phase boundary for every traced batchmate (they
        ride the same forward, so they share the timeline from here)."""
        t = time.perf_counter()
        for r in traced:
            r.trace.mark(phase, t)
            r.trace.ctx.update(ctx)

    def _dispatch(self, traced: List[_Request], cost: float, forward):
        """Run `forward()` under the engine lock and a scheduler slot,
        marking sched_wait / dispatch / device on the traced requests and
        updating the batch-time EWMA. Returns (output, seconds)."""
        t0 = time.perf_counter()
        with self._lock:
            with self._sched_slot(cost):
                if traced:
                    po = (self.scheduler.last_passovers(self.sched_name)
                          if self.scheduler is not None else 0)
                    self._mark_all(traced, "sched_wait",
                                   **({"sched_passovers": po} if po else {}))
                    for r in traced:
                        r.trace.mark("dispatch")
                out = forward()
                if traced:
                    self._mark_all(traced, "device")
            dur = time.perf_counter() - t0
            # seeded by the first forward, then smoothed at 0.2
            self._ewma_batch_s = dur if self._ewma_batch_s <= 0.0 \
                else 0.8 * self._ewma_batch_s + 0.2 * dur
        return out, dur

    def _on_batch(self, batch: List[_Request], rows: int, bucket: int,
                  dur: float) -> None:
        cb = self.on_batch
        if cb is not None:
            try:
                cb(batch, rows, bucket, dur)
            except Exception:
                pass  # a broken hook must never take the server down

    def _close_failed(self, err, batch: List[_Request],
                      traced: List[_Request]) -> bool:
        """After a failed forward: close the attempt's window on the traced
        requests (the solo retries add fresh segments) and fail a lone
        request. Returns whether the batch must be retried request by
        request, so only the offender fails."""
        for r in traced:
            r.trace.mark("device")
            r.trace.ctx["failed_attempts"] = \
                r.trace.ctx.get("failed_attempts", 0) + 1
        if len(batch) == 1:
            batch[0].error = err
            batch[0].event.set()
            return False
        return True

    def _run_batch(self, batch: List[_Request]):
        batch = self._live(batch)
        if not batch:
            return
        traced = [r for r in batch if r.trace is not None]
        if traced:
            self._mark_all(traced, "queue_wait")
        try:
            xs = np.concatenate([r.x for r in batch], axis=0)
            n = xs.shape[0]
            bucket = next_pow2_bucket(n)
            # Pad to the bucket by repeating the tail row; pad rows are
            # sliced off before any caller sees them.
            xs = repeat_tail_rows(xs, bucket - n)
            if traced:
                self._mark_all(traced, "pack", batch_rows=n, bucket=bucket)
            out, dur = self._dispatch(traced, float(n),
                                      lambda: self._forward(xs))
            self._require_finite(out[:n])
            self.executed_batch_sizes.append(n)
            with self._stats_lock:
                self.total_forwards += 1
            self._on_batch(batch, n, bucket, dur)
            ofs = 0
            for r in batch:
                k = r.x.shape[0]
                self._finish(r, out[ofs:ofs + k])
                ofs += k
        except BaseException as e:
            # Batch-failure isolation: the affected callers fail with a
            # TYPED error and the collector survives. One bad request must
            # not poison its batchmates, so a failed multi-request batch is
            # retried request by request.
            err = self._batch_failure(e, len(batch), reqs=batch)
            if not self._close_failed(err, batch, traced):
                return
            for r in batch:
                self._run_batch([r])

    # ---------------------------------------------------------------- packed
    def _collect_packed(self):
        """Packed-admission collector: eligible requests coalesce by
        first-come token fit into one [1, pack_bucket] row (carried to the
        next row on overflow); an ineligible request runs alone through the
        row path. Deadline, isolation and shutdown semantics are those of
        _collect."""
        cap = self.pack_bucket
        carry: Optional[_Request] = None
        while True:
            if carry is not None:
                first, carry = carry, None
            else:
                try:
                    first = self._queue.get(timeout=0.1)
                except queue.Empty:
                    if self._shutdown:  # jaxlint: atomic
                        return
                    continue
            if first is None:  # shutdown sentinel: serve stragglers, exit
                self._drain_and_exit_packed()
                return
            if not self._pack_eligible(first.x):
                self._note_pack_fallback(1)
                self._run_batch([first])
                continue
            batch = [first]
            toks = first.x.shape[1]
            if toks < cap:
                time.sleep(self.batch_timeout_ms / 1000.0)
            saw_sentinel = False
            while toks < cap:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    saw_sentinel = True
                    break
                if not self._pack_eligible(nxt.x) or \
                        toks + nxt.x.shape[1] > cap:
                    carry = nxt
                    break
                batch.append(nxt)
                toks += nxt.x.shape[1]
            self._run_packed(batch)
            if saw_sentinel:
                self._drain_and_exit_packed(carry)
                return

    def _drain_and_exit_packed(self, carry: Optional[_Request] = None):
        """Shutdown flush for packed mode: queued stragglers in
        token-capacity packed rows; ineligible ones alone through the row
        path."""
        leftovers = [] if carry is None else [carry]
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if r is not None:
                leftovers.append(r)
        batch: List[_Request] = []
        toks = 0
        for r in leftovers:
            if not self._pack_eligible(r.x):
                self._note_pack_fallback(1)
                self._run_batch([r])
                continue
            if batch and toks + r.x.shape[1] > self.pack_bucket:
                self._run_packed(batch)
                batch, toks = [], 0
            batch.append(r)
            toks += r.x.shape[1]
        if batch:
            self._run_packed(batch)

    def _note_pack_fallback(self, n: int) -> None:
        with self._stats_lock:
            self.total_pack_fallbacks += n
        record_packing("serve", fallbacks=n)

    def _forward_packed(self, xs: np.ndarray, segmask: np.ndarray) -> np.ndarray:
        faults.fire("serve.forward")
        x, seg = self._stager.stage([xs, segmask], [False, False])
        return self.model.output(x, features_mask=seg)

    def _run_packed(self, batch: List[_Request]):
        batch = self._live(batch)
        if not batch:
            return
        traced = [r for r in batch if r.trace is not None]
        if traced:
            self._mark_all(traced, "queue_wait")
        try:
            # Chaos seam: an armed "serve.pack" plan fails the assembly (and,
            # below, the unpack) of a packed row.
            faults.fire("serve.pack")
            feat = batch[0].x.shape[2]
            xs = np.zeros((1, self.pack_bucket, feat), batch[0].x.dtype)
            segmask = np.zeros((1, self.pack_bucket), np.float32)
            ofs = 0
            for s, r in enumerate(batch, start=1):
                t_i = r.x.shape[1]
                xs[0, ofs:ofs + t_i] = r.x[0]
                segmask[0, ofs:ofs + t_i] = s
                ofs += t_i
            if traced:
                self._mark_all(traced, "pack", packed_with=len(batch),
                               packed_tokens=ofs, pack_bucket=self.pack_bucket)
            out, dur = self._dispatch(traced, float(len(batch)),
                                      lambda: self._forward_packed(xs, segmask))
            self._require_finite(out)
            self.executed_batch_sizes.append(len(batch))
            with self._stats_lock:
                self.total_forwards += 1
                self.total_packed_requests += len(batch)
            record_packing("serve", items=len(batch), real_tokens=ofs,
                           padded_tokens=self.pack_bucket)
            self._on_batch(batch, len(batch), self.pack_bucket, dur)
            faults.fire("serve.pack")
            ofs = 0
            for r in batch:
                t_i = r.x.shape[1]
                self._finish(r, out[:, ofs:ofs + t_i])
                ofs += t_i
        except BaseException as e:
            err = self._batch_failure(e, len(batch), reqs=batch)
            if not self._close_failed(err, batch, traced):
                return
            # as in _run_batch: each request in its own packed row, so only
            # the offender fails
            for r in batch:
                self._run_packed([r])

    # --------------------------------------------------------------- shutdown
    def _fail_pending(self, exc: BaseException) -> None:
        """Fail every request still queued so no caller is stranded."""
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                return
            if r is not None:
                r.error = exc
                r.event.set()

    def shutdown(self, join_timeout: float = 5.0):
        """Close the server: stragglers already queued are SERVED by the
        collector's drain pass; anything it could not serve within the join
        window is failed with :class:`ServerClosedError`."""
        with self._enqueue_lock:
            already = self._shutdown
            self._shutdown = True
        if not already and self._worker is not None:
            # Sentinel goes in OUTSIDE the lock: with a full queue this put
            # blocks until the collector drains a slot. Admission is already
            # fenced by _shutdown.
            self._queue.put(None)
            self._worker.join(timeout=join_timeout)
        self._fail_pending(ServerClosedError(
            "ParallelInference was shut down before this request ran"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


class ParallelInferenceBuilder:
    """Fluent builder mirroring reference ParallelInference.Builder."""

    def __init__(self, model):
        self._model = model
        self._mode = InferenceMode.BATCHED
        self._batch_limit = 32
        self._queue_limit = 64
        self._timeout_ms = 2.0
        self._check_finite = False
        self._packed_admission = False
        self._pack_bucket = 0

    def inference_mode(self, mode: InferenceMode):
        self._mode = mode
        return self

    def batch_limit(self, n: int):
        self._batch_limit = int(n)
        return self

    def queue_limit(self, n: int):
        self._queue_limit = int(n)
        return self

    def batch_timeout_ms(self, ms: float):
        self._timeout_ms = float(ms)
        return self

    def check_finite(self, enabled: bool = True):
        self._check_finite = bool(enabled)
        return self

    def packed_admission(self, bucket: int):
        """Coalesce short sequence requests into one [1, bucket] packed row
        (segment ids through the features mask). The served model's
        attention layers must run packed_segments=True."""
        self._packed_admission = True
        self._pack_bucket = int(bucket)
        return self

    def build(self) -> ParallelInference:
        return ParallelInference(
            self._model, inference_mode=self._mode,
            batch_limit=self._batch_limit, queue_limit=self._queue_limit,
            batch_timeout_ms=self._timeout_ms,
            check_finite=self._check_finite,
            packed_admission=self._packed_admission,
            pack_bucket=self._pack_bucket)
