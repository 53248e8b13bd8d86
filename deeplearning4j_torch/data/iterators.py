"""DataSet iterators, host-side prefetch, pad/pack to bucket and device
prefetch.

Port of `deeplearning4j_tpu/data/iterators.py` (reference nd4j
`DataSetIterator` SPI and DL4J's iterator stack: `ListDataSetIterator`,
`ExistingDataSetIterator`, `IteratorDataSetIterator`,
`MultipleEpochsIterator`, and the async prefetch wrappers
`AsyncDataSetIterator` / `AsyncMultiDataSetIterator` that every fit()
wraps). Iterators produce host-side numpy DataSets; AsyncDataSetIterator
runs a producer thread with a bounded queue so host ETL overlaps with the
card's work.

`DevicePrefetchIterator` is the port's counterpart of the JAX package's
`jax.device_put` plus its producer-side fence: its producer thread copies
each batch into a ring of pinned host buffers, issues `non_blocking`
copies on its own CUDA stream, casts floating features to the network's
type there, and waits for that stream before it enqueues the batch, so the
training thread never inherits a copy in flight (`PinnedStager`, which
ParallelInference's batch upload shares).
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..optimize import metrics as metrics_mod
from ..utils import faults
from ..utils.device import DeviceLike, resolve_device
from .dataset import DataSet, MultiDataSet
from .padding import (first_fit_pack, next_pow2_bucket, pack_sequences,
                      pad_dataset_rows, pad_lmask_zero_weight,
                      pad_multidataset_rows, record_packing)

log = logging.getLogger(__name__)


class DataSetIterator:
    """Iterator SPI (reference nd4j DataSetIterator). Subclasses implement
    `reset` and `__next__`; `__iter__` restarts by default."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def batch_size(self) -> int:
        raise NotImplementedError

    def total_examples(self) -> Optional[int]:
        return None

    def async_supported(self) -> bool:
        return True

    # Normalizer hook (reference DataSetIterator.setPreProcessor)
    pre_processor: Optional[Callable[[DataSet], DataSet]] = None

    def _maybe_preprocess(self, ds: DataSet) -> DataSet:
        if self.pre_processor is not None:
            out = self.pre_processor(ds)
            return ds if out is None else out
        return ds


class ListDataSetIterator(DataSetIterator):
    """Iterate a DataSet in minibatches (reference ListDataSetIterator); the
    last batch is ragged unless `drop_last`."""

    def __init__(self, data: DataSet, batch_size: int = 32, shuffle: bool = False,
                 seed: Optional[int] = None, drop_last: bool = False):
        self._data = data
        self._batch = int(batch_size)
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._drop_last = drop_last
        self._cursor = 0
        self._view = data

    def reset(self):
        self._cursor = 0
        if self._shuffle:
            self._view = self._data.shuffle(
                None if self._seed is None else self._seed + self._epoch)
            self._epoch += 1

    def __next__(self) -> DataSet:
        n = self._view.num_examples()
        if self._cursor >= n:
            raise StopIteration
        end = min(self._cursor + self._batch, n)
        if self._drop_last and end - self._cursor < self._batch:
            raise StopIteration
        v, a = self._view, self._cursor
        ds = DataSet(v.features[a:end], v.labels[a:end],
                     None if v.features_mask is None else v.features_mask[a:end],
                     None if v.labels_mask is None else v.labels_mask[a:end])
        self._cursor = end
        return self._maybe_preprocess(ds)

    def batch_size(self):
        return self._batch

    def total_examples(self):
        return self._data.num_examples()


class ExistingDataSetIterator(DataSetIterator):
    """Wrap an existing iterable of DataSets (reference
    ExistingDataSetIterator)."""

    def __init__(self, datasets: Iterable[DataSet]):
        self._datasets = list(datasets)
        self._i = 0

    def reset(self):
        self._i = 0

    def __next__(self):
        if self._i >= len(self._datasets):
            raise StopIteration
        ds = self._datasets[self._i]
        self._i += 1
        return self._maybe_preprocess(ds)

    def batch_size(self):
        return self._datasets[0].num_examples() if self._datasets else 0


class MultipleEpochsIterator(DataSetIterator):
    """Replay an iterator for N epochs as one pass (reference
    MultipleEpochsIterator)."""

    def __init__(self, epochs: int, base: DataSetIterator):
        self._epochs = int(epochs)
        self._base = base
        self._epoch = 0
        self._inner: Optional[Iterator] = None

    def reset(self):
        self._epoch = 0
        self._inner = None

    def __next__(self):
        while True:
            if self._inner is None:
                if self._epoch >= self._epochs:
                    raise StopIteration
                self._base.reset()
                self._inner = iter(self._base)
                self._epoch += 1
            try:
                return next(self._inner)
            except StopIteration:
                self._inner = None

    def batch_size(self):
        return self._base.batch_size()


class _StreamEnd:
    """Queue-carried end-of-stream marker, optionally holding the
    producer's error. Shipping the error inside the queue item (instead
    of on a shared instance attribute) ties each epoch's error to its
    own queue: a stale producer that outlived its 5s join timeout can
    only write to the old queue, never poison the next epoch."""

    __slots__ = ("error",)

    def __init__(self, error: Optional[BaseException] = None):
        self.error = error


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch with a bounded queue (reference
    datasets/iterator/AsyncDataSetIterator.java). `queue_size` mirrors the
    reference's buffer size (default 8). A producer error re-raises in the
    consumer; `shutdown` (and a new epoch) stops the producer and joins it
    with a 5 s bound."""

    #: seconds between the consumer's checks that its producer still runs
    POLL_S = 1.0

    def __init__(self, base: DataSetIterator, queue_size: int = 8):
        self._base = base
        self._queue_size = max(1, int(queue_size))
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._shutdown = threading.Event()

    def _produce_item(self, ds, host_ms: float):
        """Hook for subclasses (DevicePrefetchIterator): transform a batch
        on the producer thread before it enters the queue. `host_ms` is
        the time the producer just spent pulling the batch from the base
        iterator (host ETL)."""
        return ds

    def _next_resilient(self, it):
        """One base-iterator poll with ONE transparent retry on transient
        failure (the ``etl.next`` fault point fires per attempt). A second
        consecutive failure propagates to the consumer as usual."""
        try:
            faults.fire("etl.next")
            return next(it)
        except StopIteration:
            raise
        except Exception as e:
            metrics_mod.registry().counter(
                "retries_total",
                "Transient-failure retries per distributed edge"
                ).labels(edge="etl.next").inc()
            log.warning("prefetch producer: base iterator failed (%s: %s); "
                        "retrying once", type(e).__name__, e)
            faults.fire("etl.next")
            return next(it)

    def _on_producer_start(self):
        """Hook for subclasses: runs first on the producer thread; an error
        here reaches the consumer like any other."""

    def _producer(self, q: queue.Queue):
        try:
            self._on_producer_start()
            it = iter(self._base)
            while True:
                t0 = time.perf_counter()
                try:
                    ds = self._next_resilient(it)
                except StopIteration:
                    break
                host_ms = (time.perf_counter() - t0) * 1000.0
                if self._shutdown.is_set():
                    return
                q.put(self._produce_item(ds, host_ms))
            q.put(_StreamEnd())
        except BaseException as e:  # propagate to consumer via the queue
            q.put(_StreamEnd(e))

    def reset(self):
        self._stop_thread()
        self._shutdown.clear()
        self._queue = queue.Queue(maxsize=self._queue_size)
        self._thread = threading.Thread(
            target=self._producer, args=(self._queue,), daemon=True)
        self._thread.start()

    def _stop_thread(self):
        if self._thread is not None and self._thread.is_alive():
            self._shutdown.set()
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5.0)
        self._thread = None

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        if self._queue is None:
            self.reset()
        while True:
            try:
                item = self._queue.get(timeout=self.POLL_S)
                break
            except queue.Empty:
                # a producer always ends its stream with a _StreamEnd; one
                # that is gone without it cannot feed this queue any more
                if self._thread is None or not self._thread.is_alive():
                    if self._queue.empty():
                        raise RuntimeError(
                            "prefetch producer ended without closing its "
                            "stream") from None
        if isinstance(item, _StreamEnd):
            self._thread = None
            if item.error is not None:
                raise item.error
            raise StopIteration
        return item

    def batch_size(self):
        return self._base.batch_size()

    def shutdown(self):
        self._stop_thread()


class AsyncMultiDataSetIterator(AsyncDataSetIterator):
    """Background prefetch over MultiDataSet streams (reference
    datasets/iterator/AsyncMultiDataSetIterator.java) — same bounded-queue
    machinery; ComputationGraph.fit wraps with this (reference
    ComputationGraph.java:867)."""

    def __init__(self, base, queue_size: int = 8):
        # `base` may be any (re-)iterable of MultiDataSets, incl. a list.
        super().__init__(base, queue_size)

    def batch_size(self):
        return self._base.batch_size() if hasattr(self._base, "batch_size") \
            else None


class IteratorDataSetIterator(DataSetIterator):
    """Re-batch a stream of DataSets to a fixed minibatch size (reference
    IteratorDataSetIterator, used by the Spark worker loop)."""

    def __init__(self, base: Iterable[DataSet], batch_size: int):
        self._base_iterable = base
        self._batch = int(batch_size)
        self._iter: Optional[Iterator[DataSet]] = None
        self._buffer: List[DataSet] = []
        self._buffered = 0

    def reset(self):
        self._iter = iter(self._base_iterable)
        self._buffer = []
        self._buffered = 0

    def __next__(self) -> DataSet:
        if self._iter is None:
            self.reset()
        while self._buffered < self._batch:
            try:
                ds = next(self._iter)
            except StopIteration:
                break
            self._buffer.append(ds)
            self._buffered += ds.num_examples()
        if not self._buffer:
            raise StopIteration
        merged = DataSet.merge(self._buffer)
        out = DataSet(merged.features[:self._batch], merged.labels[:self._batch],
                      None if merged.features_mask is None
                      else merged.features_mask[:self._batch],
                      None if merged.labels_mask is None
                      else merged.labels_mask[:self._batch])
        rest = merged.features.shape[0] - self._batch
        if rest > 0:
            self._buffer = [DataSet(
                merged.features[self._batch:], merged.labels[self._batch:],
                None if merged.features_mask is None
                else merged.features_mask[self._batch:],
                None if merged.labels_mask is None
                else merged.labels_mask[self._batch:])]
            self._buffered = rest
        else:
            self._buffer = []
            self._buffered = 0
        return out

    def batch_size(self):
        return self._batch


def as_iterator(data, labels=None, batch_size: int = 32) -> DataSetIterator:
    """Coerce (features, labels) / DataSet / iterator to a DataSetIterator."""
    if isinstance(data, DataSetIterator):
        return data
    if isinstance(data, DataSet):
        return ListDataSetIterator(data, batch_size or data.num_examples())
    if labels is None:
        raise ValueError("labels required when passing a raw feature array")
    ds = DataSet(np.asarray(data), np.asarray(labels))
    return ListDataSetIterator(ds, batch_size or ds.num_examples())


class AsyncShieldDataSetIterator(DataSetIterator):
    """Opt-out wrapper: guarantees fit() will NOT wrap the underlying
    iterator in background prefetch (reference
    AsyncShieldDataSetIterator — for sources whose batches must not be
    consumed ahead of the training step, e.g. externally synchronized
    or stateful readers)."""

    def __init__(self, underlying):
        # same iterable tolerance as the async wrapper it opts OUT of:
        # plain lists/generators are accepted (materialized so repeat
        # epochs see the data)
        if not hasattr(underlying, "reset"):
            underlying = list(underlying)
        self.underlying = underlying
        self._it = None

    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if self._it is None:
            self.reset()
        return self._maybe_preprocess(next(self._it))

    def reset(self):
        if hasattr(self.underlying, "reset"):
            self.underlying.reset()
        self._it = iter(self.underlying)

    def batch_size(self):
        return self.underlying.batch_size() \
            if hasattr(self.underlying, "batch_size") else None

    def total_examples(self):
        return self.underlying.total_examples() \
            if hasattr(self.underlying, "total_examples") else None

    def async_supported(self) -> bool:
        return False  # the whole point


class AsyncShieldMultiDataSetIterator(AsyncShieldDataSetIterator):
    """Multi-dataset flavor (reference AsyncShieldMultiDataSetIterator)."""


class PadToBucketIterator(DataSetIterator):
    """Pad ragged batches up to the epoch's canonical batch shape (the
    tf.data pad-to-bucket idea), as the JAX package's fit does by default:
    with it the port's fit takes the same steps on the same rows as the
    JAX package's, BatchNormalization's batch statistics over the pad rows
    included, and the card sees one batch shape per epoch.

    The canonical row count is the first batch's (the full-size batches
    lead; only tails are ragged), so a dataset that fits in a single
    batch is never padded and existing single-batch behavior is
    untouched. Pad rows repeat the tail example and carry a zero-weight
    labels mask (created when absent — data/padding.py contract), so
    loss and gradients match the unpadded batch EXACTLY; score
    normalization divides by real rows. BatchNorm train-mode statistics
    and dropout draws still see pad rows (documented caveat).

    Time-axis raggedness (variable sequence tails) pads only when the
    batch already carries BOTH masks: zero-padding a rank>=2 mask leaves
    sum(mask) — the loss denominator — unchanged, so the math stays
    exact; synthesizing a time mask where none exists would flip the
    normalization semantics, so maskless ragged-time batches pass
    through unpadded.

    `bucket_rows="pow2"` switches the row target from the first batch's
    count to the shared power-of-two bucket rule
    (data/padding.next_pow2_bucket, the same rounding ParallelInference
    uses), for streams whose batch sizes vary throughout rather than only
    at the tail: at most log2(max_batch) distinct shapes."""

    def __init__(self, base, batch_size: Optional[int] = None,
                 bucket_rows: str = "first"):
        if bucket_rows not in ("first", "pow2"):
            raise ValueError(
                f"bucket_rows must be 'first' or 'pow2', got {bucket_rows!r}")
        self._base = base
        self._fixed_target = batch_size
        self._target: Optional[int] = batch_size
        self._target_t: Optional[int] = None
        self._bucket_rows = bucket_rows
        self._it: Optional[Iterator] = None

    def reset(self):
        self._it = iter(self._base)
        self._target = self._fixed_target
        self._target_t = None

    def __iter__(self):
        self.reset()
        return self

    @staticmethod
    def _pad_time(ds: DataSet, target_t: int) -> DataSet:
        t = ds.features.shape[1]
        pad = target_t - t
        if pad <= 0:
            return ds
        def pad_axis1(a, val=0.0):
            if a is None:
                return None
            a = np.asarray(a)
            width = [(0, 0)] * a.ndim
            width[1] = (0, pad)
            return np.pad(a, width, constant_values=val)
        return DataSet(pad_axis1(ds.features), pad_axis1(ds.labels),
                       pad_axis1(ds.features_mask), pad_axis1(ds.labels_mask))

    def _row_target(self, n: int) -> int:
        if self._bucket_rows == "pow2" and self._fixed_target is None:
            return next_pow2_bucket(n)
        if self._target is None:
            self._target = n
        return self._target

    def __next__(self) -> DataSet:
        if self._it is None:
            self.reset()
        ds = next(self._it)
        # Uniform mask structure across the epoch, as in the JAX package:
        # every maskless batch gets the ones (n,1) mask, which the
        # zero-weight contract guarantees is loss-exact (the rank-2 mask
        # path divides by sum(mask) = n), so every batch of the epoch has
        # the same structure and steps_per_dispatch can group them.
        if isinstance(ds, MultiDataSet):
            if ds.labels_masks is None or any(m is None
                                              for m in ds.labels_masks):
                masks = ds.labels_masks or [None] * len(ds.labels)
                ds = MultiDataSet(
                    ds.features, ds.labels, ds.features_masks,
                    [m if m is not None
                     else pad_lmask_zero_weight(None, len(l), 0)
                     for m, l in zip(masks, ds.labels)])
            return pad_multidataset_rows(ds, self._row_target(
                ds.num_examples()))
        if ds.labels_mask is None:
            ds = DataSet(ds.features, ds.labels, ds.features_mask,
                         pad_lmask_zero_weight(None, ds.num_examples(), 0))
        # Ragged time tail: pad up to the canonical length when both
        # masks are present (exactness requires them, see class doc).
        if np.ndim(ds.features) == 3:
            t = ds.features.shape[1]
            if self._target_t is None:
                self._target_t = t
            elif t < self._target_t and ds.features_mask is not None \
                    and ds.labels_mask is not None \
                    and np.ndim(ds.labels_mask) >= 2:
                ds = self._pad_time(ds, self._target_t)
        return pad_dataset_rows(ds, self._row_target(ds.num_examples()))

    def batch_size(self):
        return self._base.batch_size() if hasattr(self._base, "batch_size") \
            else self._fixed_target

    def total_examples(self):
        return self._base.total_examples() \
            if hasattr(self._base, "total_examples") else None

    def async_supported(self) -> bool:
        base_ok = getattr(self._base, "async_supported", lambda: True)
        return base_ok()


class PackToBucketIterator(DataSetIterator):
    """Pack ragged sequences MULTIPLE-per-row instead of padding each to
    its own row (the varlen/segment-mask sibling of PadToBucketIterator):
    every emitted batch has the one canonical ``(rows, bucket_len)``
    shape, but the time axis is dense with real tokens, so at ragged
    length mixes the same step processes 2-3x the real tokens of the
    padded layout.

    The emitted feature mask carries SEGMENT IDS (0 = pad, 1..k = the
    k sequences sharing the row); an attention layer with
    ``packed_segments=True`` reads them through the ordinary mask
    plumbing and forbids cross-segment attention, so per-token outputs
    match the unpacked batch exactly. The labels mask is the rank-2
    zero-weight contract (data/padding.py): loss numerator AND
    denominator (sum(mask) = real tokens) are identical to training on
    the unpacked ragged batch — loss-exact, not approximately so.
    Per-segment 0-based positions ride along as ``packed_positions``
    for position-consuming consumers (attention itself needs only ids).

    `bucket_len` defaults to the pow2 bucket of the first batch's
    longest sequence (the shared next_pow2_bucket rule); `rows` defaults
    to the first batch's first-fit bin count. Later batches that need
    more bins split into several emitted packed batches (same shape);
    leftover bins pad with fully-masked all-zero rows. A sequence longer
    than `bucket_len` raises — choose the bucket for the corpus.

    Requires [batch, time, features] features and per-timestep rank-3
    labels; lengths come from the batch's features_mask row sums (a
    maskless batch packs as full-length rows). Masks must be contiguous
    from t=0 — mid-sequence holes have no packed representation."""

    def __init__(self, base, bucket_len: Optional[int] = None,
                 rows: Optional[int] = None):
        self._base = base
        self._fixed_bucket = bucket_len
        self._fixed_rows = rows
        self._bucket = bucket_len
        self._rows = rows
        self._it: Optional[Iterator] = None
        self._pending: List[DataSet] = []

    def reset(self):
        self._it = iter(self._base)
        self._bucket = self._fixed_bucket
        self._rows = self._fixed_rows
        self._pending = []

    def __iter__(self):
        self.reset()
        return self

    def _lengths(self, ds: DataSet, n: int, t: int) -> np.ndarray:
        if ds.features_mask is None:
            return np.full(n, t, dtype=np.int64)
        fm = np.asarray(ds.features_mask) > 0
        lengths = fm.sum(axis=1).astype(np.int64)
        contiguous = np.arange(t)[None, :] < lengths[:, None]
        if not np.array_equal(fm, contiguous):
            raise ValueError(
                "PackToBucketIterator needs contiguous-from-start "
                "feature masks (no mid-sequence holes)")
        return lengths

    def _pack_batch(self, ds: DataSet) -> List[DataSet]:
        f = np.asarray(ds.features)
        if f.ndim != 3:
            raise ValueError(
                "PackToBucketIterator needs [batch, time, features] "
                f"features, got shape {f.shape}")
        lab = np.asarray(ds.labels)
        if lab.ndim != 3:
            raise ValueError(
                "PackToBucketIterator needs per-timestep (rank-3) "
                f"labels, got shape {lab.shape}")
        n, t = f.shape[0], f.shape[1]
        lengths = self._lengths(ds, n, t)
        if self._bucket is None:
            self._bucket = next_pow2_bucket(int(lengths.max()))
        lmask = None if ds.labels_mask is None \
            else np.asarray(ds.labels_mask)
        if lmask is not None and lmask.ndim != 2:
            raise ValueError(
                "PackToBucketIterator needs a per-token rank-2 labels "
                f"mask, got shape {lmask.shape}")
        bins = first_fit_pack(lengths, self._bucket)
        if self._rows is None:
            self._rows = len(bins)
        out: List[DataSet] = []
        for c0 in range(0, len(bins), self._rows):
            chunk = bins[c0:c0 + self._rows]
            pf, pl, seg, plm, pos = pack_sequences(
                f, lab, lengths, self._bucket, bins=chunk,
                rows=self._rows, labels_mask=lmask)
            packed = DataSet(pf, pl, seg, plm)
            packed.packed_positions = pos
            out.append(packed)
            record_packing(
                "fit", items=sum(len(b) for b in chunk),
                real_tokens=int(sum(int(lengths[i])
                                    for b in chunk for i in b)),
                padded_tokens=self._rows * self._bucket)
        return out

    def __next__(self) -> DataSet:
        if self._it is None:
            self.reset()
        while not self._pending:
            self._pending = self._pack_batch(next(self._it))
        return self._maybe_preprocess(self._pending.pop(0))

    def batch_size(self):
        return self._rows

    def total_examples(self):
        return self._base.total_examples() \
            if hasattr(self._base, "total_examples") else None

    def async_supported(self) -> bool:
        base_ok = getattr(self._base, "async_supported", lambda: True)
        return base_ok()




def _host_tensor(a) -> torch.Tensor:
    """A CPU tensor over host array `a` (numpy, or a CPU tensor as it is)."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


class PinnedStager:
    """Host-to-device staging through pinned memory, on a stream of its own.

    `stage` copies a batch's host arrays into one slot of a ring of pinned
    host buffers (`slots` deep; a slot keeps its buffers while the shapes
    repeat), issues `non_blocking` copies on the stager's CUDA stream,
    casts the floating arrays marked as features to `cast_dtype` on that
    stream, and then waits for the batch's event: the caller gets tensors
    whose copies have landed, so a consumer never inherits a transfer in
    flight, and a slot is written again only after the event of its last
    batch has completed. The device tensors are allocated on the stager's
    stream and used on the consumer's, so each is marked with
    `record_stream(consumer)`: the caching allocator then keeps its memory
    until the consumer's work queued before the free has run.

    On a CPU device there is nothing to copy: arrays become tensors (cast
    alike) and no thread, stream or pinned buffer is involved. A tensor
    already on the device is only cast."""

    def __init__(self, device: DeviceLike = None, slots: int = 2):
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:   # the current device
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._slots: List[dict] = [{} for _ in range(max(1, int(slots)))]
        self._events: List[Optional[torch.cuda.Event]] = [None] * len(self._slots)
        self._next = 0
        self._stream = None

    def _pinned(self, slot: dict, i: int, t: torch.Tensor) -> torch.Tensor:
        buf = slot.get(i)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = slot[i] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        return buf

    def stage(self, arrays: Sequence, features: Sequence[bool],
              cast_dtype=None, consumer=None) -> List[Optional[torch.Tensor]]:
        """`arrays` (host arrays, tensors or None) on the device, each
        floating one marked in `features` cast to `cast_dtype`. `consumer`
        is the CUDA stream that will use them (default: the calling
        thread's current stream)."""

        def cast(t, is_feature):
            if is_feature and cast_dtype is not None and t.is_floating_point():
                return t.to(cast_dtype)
            return t

        if not self._cuda:
            return [None if a is None else cast(_host_tensor(a).to(self.device), f)
                    for a, f in zip(arrays, features)]
        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            consumer = consumer or torch.cuda.current_stream(self.device)
            k = self._next
            self._next = (k + 1) % len(self._slots)
            if self._events[k] is not None:
                self._events[k].synchronize()   # the slot's last copy landed
            out = []
            with torch.cuda.stream(self._stream):
                for i, (a, is_feature) in enumerate(zip(arrays, features)):
                    if a is None:
                        out.append(None)
                        continue
                    if isinstance(a, torch.Tensor) and a.device == self.device:
                        t = a
                    else:
                        t = self._pinned(self._slots[k], i, _host_tensor(a)).to(
                            self.device, non_blocking=True)
                    t = cast(t, is_feature)
                    t.record_stream(consumer)
                    out.append(t)
                ev = self._events[k] = torch.cuda.Event()
                ev.record(self._stream)
            ev.synchronize()
        return out


class DevicePrefetchIterator(AsyncDataSetIterator):
    """Background prefetch that stages batches ONTO THE DEVICE: the producer
    thread runs each batch through a `PinnedStager` (pinned host ring,
    `non_blocking` copies and the feature cast on its own stream, then a
    wait for that stream), so the training thread dequeues device-resident
    tensors and never pays the host-to-device copy inside the step loop:
    the prefetch_to_device stage of tf.data (Murray et al., VLDB 2021).
    Shutdown/reset/error semantics are AsyncDataSetIterator's (same bounded
    queue and sentinel protocol): a failing copy re-raises in the consumer.

    `depth` bounds how many staged batches may be device-resident at once
    (device memory: depth x batch bytes); the pinned ring is `depth + 1`
    slots. `cast_dtype` casts floating FEATURE arrays to the network's type
    on the producer (the step's own cast then does nothing); labels and
    masks go as they are. `device` is the network's (default: CUDA, raising
    without a GPU); on the CPU the producer only makes tensors.
    `sharding` (parallel/mesh.py's `batch_sharded(mesh)`, ParallelWrapper's)
    stages each batch on the mesh's first local device, where the wrapper
    cuts its shards from it by rows (moving a shard to its own device
    device to device); a batch whose row count `batch_divisor` does not
    divide is handed on unstaged, for the wrapper's zero-weight pad.

    Each staged batch carries its ETL breakdown as `_etl_host_ms` (time
    the producer spent pulling it from the base iterator) and
    `_etl_h2d_ms` (pinned copy, transfer and the wait for it); fit()
    surfaces them as model.last_etl_host_ms / last_etl_h2d_ms next to the
    consumer-side last_etl_ms stall clock."""

    def __init__(self, base, depth: int = 2, sharding=None,
                 batch_divisor: int = 1, cast_dtype=None,
                 device: DeviceLike = None):
        if sharding is not None:
            device = sharding.device
        super().__init__(base, queue_size=depth)
        self._cast_dtype = cast_dtype
        self._divisor = max(1, int(batch_divisor))
        self._stager = PinnedStager(device, slots=max(1, int(depth)) + 1)
        self._consumer = None

    def reset(self):
        # reset runs on the consumer's thread: its stream uses the batches
        if self._stager.device.type == "cuda":
            self._consumer = torch.cuda.current_stream(self._stager.device)
        super().reset()

    def _on_producer_start(self):
        if self._stager.device.type == "cuda":
            torch.cuda.set_device(self._stager.device)

    def _stage(self, ds):
        if isinstance(ds, (DataSet, MultiDataSet)) and \
                metrics_mod.batch_rows(ds) % self._divisor:
            return ds
        put = lambda arrays, features: self._stager.stage(
            arrays, features, self._cast_dtype, self._consumer)
        if isinstance(ds, MultiDataSet):
            n_f, n_l = len(ds.features), len(ds.labels)
            fm = ds.features_masks or []
            lm = ds.labels_masks or []
            t = put(list(ds.features) + list(ds.labels) + list(fm) + list(lm),
                    [True] * n_f + [False] * (n_l + len(fm) + len(lm)))
            out = MultiDataSet(
                t[:n_f], t[n_f:n_f + n_l],
                None if ds.features_masks is None
                else t[n_f + n_l:n_f + n_l + len(fm)],
                None if ds.labels_masks is None else t[n_f + n_l + len(fm):])
        elif isinstance(ds, DataSet):
            out = DataSet(*put([ds.features, ds.labels, ds.features_mask,
                                ds.labels_mask], [True, False, False, False]))
            pos = getattr(ds, "packed_positions", None)
            if pos is not None:
                out.packed_positions = pos
        else:
            return ds
        return out

    def _produce_item(self, ds, host_ms: float):
        t0 = time.perf_counter()
        staged = self._stage(ds)
        h2d_ms = (time.perf_counter() - t0) * 1000.0
        try:
            staged._etl_host_ms = host_ms
            staged._etl_h2d_ms = h2d_ms
        except AttributeError:
            pass  # foreign batch type without attribute support
        return staged

    def async_supported(self) -> bool:
        return False  # already threaded; fit() must not double-wrap
