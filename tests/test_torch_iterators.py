"""The port's iterators against the JAX package's.

- The synchronous iterators (list with and without shuffling, multiple
  epochs, re-batching, existing, AsyncShield) yield the JAX package's
  batches exactly.
- AsyncDataSetIterator and AsyncMultiDataSetIterator yield the base's
  batches; a producer error re-raises in the consumer; one transient
  failure is retried through the ``etl.next`` fault point; `shutdown` mid
  epoch and a producer gone without closing its stream end promptly.
- PadToBucketIterator: rows to the first batch's count or the pow2 bucket,
  the time tail under both masks, MultiDataSets: the JAX package's arrays
  exactly.
- DevicePrefetchIterator and PinnedStager on the CPU (tensors, feature
  cast, timings); their pinned path on the card is in
  tests/test_torch_device_prefetch.py, which imports no JAX.

Every wait in these tests is bounded (`_bounded`): a hang fails the test
instead of stalling the suite.
"""
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_torch.data import iterators as it
from deeplearning4j_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_torch.optimize import metrics as port_metrics
from deeplearning4j_torch.utils import faults
from deeplearning4j_tpu.data import iterators as ref_it
from deeplearning4j_tpu.data.dataset import DataSet as RefDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as RefMultiDataSet

WAIT_S = 30.0


def _bounded(fn, timeout=WAIT_S):
    """fn() on a helper thread, joined with a timeout; its result or its
    exception."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # re-raised on the test's thread
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"did not finish within {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def _ds(pkg_ds, n=10, t=None, seed=0, masks=False):
    rng = np.random.default_rng(seed)
    shape = (n, 3) if t is None else (n, t, 3)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.standard_normal(shape[:-1] + (2,)).astype(np.float32)
    fm = lm = None
    if masks:
        fm = (rng.random((n, t)) > 0.3).astype(np.float32)
        lm = fm.copy()
    return pkg_ds(x, y, fm, lm)


def _arrays(ds):
    conv = lambda a: None if a is None else (
        a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a))
    if hasattr(ds, "features_masks"):
        return ([conv(a) for a in ds.features], [conv(a) for a in ds.labels],
                None if ds.features_masks is None else [conv(a) for a in ds.features_masks],
                None if ds.labels_masks is None else [conv(a) for a in ds.labels_masks])
    return (conv(ds.features), conv(ds.labels), conv(ds.features_mask),
            conv(ds.labels_mask))


def _assert_same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(_arrays(g), _arrays(w)):
            if isinstance(b, list):
                for c, d in zip(a, b):
                    np.testing.assert_array_equal(c, d)
            elif b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


SYNC_CASES = {
    "list": lambda m, ds: m.ListDataSetIterator(ds(), 4),
    "list_shuffled": lambda m, ds: m.ListDataSetIterator(ds(), 3, shuffle=True, seed=5),
    "list_drop_last": lambda m, ds: m.ListDataSetIterator(ds(), 4, drop_last=True),
    "multiple_epochs": lambda m, ds: m.MultipleEpochsIterator(
        3, m.ListDataSetIterator(ds(), 4)),
    "rebatch": lambda m, ds: m.IteratorDataSetIterator(
        list(m.ListDataSetIterator(ds(), 3)), 4),
    "existing": lambda m, ds: m.ExistingDataSetIterator(
        list(m.ListDataSetIterator(ds(), 4))),
    "shield": lambda m, ds: m.AsyncShieldDataSetIterator(
        m.ListDataSetIterator(ds(), 4)),
}


@pytest.mark.parametrize("case", sorted(SYNC_CASES))
def test_sync_iterators_match_reference(case):
    make = SYNC_CASES[case]
    port_iter = make(it, lambda: _ds(DataSet))
    ref_iter = make(ref_it, lambda: _ds(RefDataSet))
    for _ in range(2):   # a second epoch resets (and reshuffles) alike
        _assert_same(list(port_iter), list(ref_iter))
    assert port_iter.async_supported() == ref_iter.async_supported()


@pytest.mark.parametrize("queue_size", [1, 3, 8])
def test_async_iterator_yields_the_base_batches(queue_size):
    base = it.ListDataSetIterator(_ds(DataSet, n=11), 2)
    a = it.AsyncDataSetIterator(base, queue_size)
    try:
        for _ in range(2):
            _assert_same(_bounded(lambda: list(a)), list(base))
    finally:
        _bounded(a.shutdown)
    multi = [MultiDataSet([np.full((2, 3), i, np.float32)], [np.zeros((2, 1))])
             for i in range(4)]
    am = it.AsyncMultiDataSetIterator(multi, queue_size)
    try:
        _assert_same(_bounded(lambda: list(am)), multi)
    finally:
        _bounded(am.shutdown)
    assert am.batch_size() is None


class _Flaky(it.DataSetIterator):
    """Batches of one row; raises on the polls in `fail_at` (1-based)."""

    def __init__(self, n, fail_at=(), error=KeyError):
        self.n, self.fail_at, self.error = n, set(fail_at), error
        self.polls = 0
        self.i = 0

    def reset(self):
        self.i = 0

    def __next__(self):
        self.polls += 1
        if self.polls in self.fail_at:
            raise self.error(f"poll {self.polls}")
        if self.i >= self.n:
            raise StopIteration
        self.i += 1
        return DataSet(np.full((1, 2), self.i, np.float32), np.zeros((1, 1)))


def test_producer_error_reraises_in_the_consumer():
    a = it.AsyncDataSetIterator(_Flaky(5, fail_at=(3, 4)), 2)
    got = []

    def drain():
        for ds in a:
            got.append(ds)

    with pytest.raises(KeyError, match="poll 4"):
        _bounded(drain)
    assert len(got) == 2
    _bounded(a.shutdown)


def test_one_transient_failure_is_retried_through_etl_next():
    reg = port_metrics.registry()
    retries = reg.counter("retries_total").labels(edge="etl.next")
    before = retries.value()
    a = it.AsyncDataSetIterator(_Flaky(4, fail_at=(2,)), 2)
    assert len(_bounded(lambda: list(a))) == 4
    assert retries.value() == before + 1
    with faults.injected("etl.next", "fail:2,3"):
        b = it.AsyncDataSetIterator(_Flaky(4), 2)
        with pytest.raises(faults.FaultInjected, match="call #3"):
            _bounded(lambda: list(b))
        assert faults.call_count("etl.next") == 3
        assert faults.fired_count("etl.next") == 2
    _bounded(b.shutdown)


def test_shutdown_mid_epoch_stops_the_producer():
    a = it.AsyncDataSetIterator(_Flaky(1000), 2)
    first = _bounded(lambda: next(iter(a)))
    assert float(first.features[0, 0]) == 1.0
    thread = a._thread
    _bounded(a.shutdown, timeout=10.0)
    assert thread is not None and not thread.is_alive()
    # a new epoch starts from the first batch again
    assert float(_bounded(lambda: next(iter(a))).features[0, 0]) == 1.0
    _bounded(a.shutdown, timeout=10.0)


def test_a_producer_gone_without_a_stream_end_raises(monkeypatch):
    a = it.AsyncDataSetIterator(_Flaky(3), 2)
    monkeypatch.setattr(a, "_producer", lambda q: None)
    monkeypatch.setattr(a, "POLL_S", 0.05)
    with pytest.raises(RuntimeError, match="without closing its stream"):
        _bounded(lambda: list(a))


PAD_CASES = {
    "first_rows": (dict(), lambda ds: ds(n=10), 4),
    "pow2_rows": (dict(bucket_rows="pow2"), lambda ds: ds(n=11), 3),
    "fixed_rows": (dict(batch_size=6), lambda ds: ds(n=10), 4),
    "time_tail": (dict(), lambda ds: ds(n=7, t=5, masks=True), 4),
    "time_no_masks": (dict(), lambda ds: ds(n=7, t=5), 4),
}


@pytest.mark.parametrize("case", sorted(PAD_CASES))
def test_pad_to_bucket_matches_reference(case):
    kw, data, batch = PAD_CASES[case]

    def batches(m, ds):
        d = data(lambda **k: _ds(ds, **k))
        rows = m.ListDataSetIterator(d, batch)
        if case.startswith("time"):   # a shorter time tail in the last batch
            rows = [m.DataSet(b.features[:, :3], b.labels[:, :3],
                              None if b.features_mask is None else b.features_mask[:, :3],
                              None if b.labels_mask is None else b.labels_mask[:, :3])
                    if i == 1 else b for i, b in enumerate(rows)]
        return m.PadToBucketIterator(rows, **kw)

    port_out, ref_out = list(batches(it, DataSet)), list(batches(ref_it, RefDataSet))
    _assert_same(port_out, ref_out)
    assert all(b.labels_mask is not None for b in port_out)


def test_pad_to_bucket_pads_multidatasets_like_reference():
    rng = np.random.default_rng(4)
    make = lambda cls, i, n: cls([rng_arrays[i][0][:n]], [rng_arrays[i][1][:n]])
    rng_arrays = [(rng.standard_normal((4, 3)).astype(np.float32),
                   rng.standard_normal((4, 2)).astype(np.float32)) for _ in range(2)]
    port_b = [make(MultiDataSet, 0, 4), make(MultiDataSet, 1, 3)]
    ref_b = [make(RefMultiDataSet, 0, 4), make(RefMultiDataSet, 1, 3)]
    _assert_same(list(it.PadToBucketIterator(port_b)),
                 list(ref_it.PadToBucketIterator(ref_b)))


def test_device_prefetch_on_the_cpu_casts_features_and_times():
    base = it.PadToBucketIterator(it.ListDataSetIterator(_ds(DataSet, n=5), 2))
    a = it.DevicePrefetchIterator(base, depth=2, cast_dtype=torch.float64,
                                  device="cpu")
    try:
        got = _bounded(lambda: list(a))
    finally:
        _bounded(a.shutdown)
    want = list(base)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert isinstance(g.features, torch.Tensor) and g.features.dtype == torch.float64
        assert g.labels.dtype == torch.float32   # labels and masks as they are
        np.testing.assert_array_equal(g.features.numpy(), w.features.astype(np.float64))
        np.testing.assert_array_equal(g.labels_mask.numpy(), w.labels_mask)
        assert g._etl_host_ms >= 0 and g._etl_h2d_ms >= 0
    assert not a.async_supported()


def test_pinned_stager_on_the_cpu_makes_tensors():
    st = it.PinnedStager("cpu")
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    f, m, none = st.stage([x, x.astype(np.int64), None], [True, True, False],
                          cast_dtype=torch.bfloat16)
    assert f.dtype == torch.bfloat16 and m.dtype == torch.int64 and none is None
    assert torch.equal(m, torch.from_numpy(x.astype(np.int64)))


def test_a_failing_producer_start_reraises_in_the_consumer(monkeypatch):
    a = it.DevicePrefetchIterator(it.ListDataSetIterator(_ds(DataSet), 4),
                                  device="cpu")

    def broken():
        raise ValueError("no such device")

    monkeypatch.setattr(a, "_on_producer_start", broken)
    with pytest.raises(ValueError, match="no such device"):
        _bounded(lambda: list(a))
