"""The port's metrics registry and span tracing against the JAX package's.

- The same operations on a fresh registry of each package (counters with
  and without labels, gauges, histograms with the default and custom
  buckets, exemplars, touch) export the same Prometheus text and snapshot
  (the runtime samplers' families left out: host RSS differs by process
  and device memory by backend), and the same quantiles, windowed on a
  fake clock, totals and label filters.
- `record_train_step`, `record_etl` and `batch_rows` move the same
  families.
- `device_memory_stats` is empty without a GPU (on the card:
  tests/test_torch_device_prefetch.py).
- Tracing: spans, begin/end/cancel, add_span and the sampled fence give
  the JAX package's Chrome trace events (names, categories, args, nesting
  order); disabled, nothing is recorded; annotate enters
  record_function. The fence's wait on the card is in
  tests/test_torch_device_prefetch.py.
"""
import json
import time

import numpy as np
import pytest
import torch

from deeplearning4j_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_torch.optimize import metrics as M
from deeplearning4j_torch.optimize import tracing as T
from deeplearning4j_tpu.optimize import metrics as RM
from deeplearning4j_tpu.optimize import tracing as RT

RUNTIME = ("host_rss_bytes", "device_bytes_in_use", "device_peak_bytes_in_use",
           "process_start_time_seconds", "jit_cache_size",
           "xla_compilations_total")


def _drive(mod):
    reg = mod.MetricsRegistry()
    reg.counter("requests_total", "Requests").inc()
    reg.counter("requests_total").labels(route="a", code="200").inc(3)
    reg.counter("requests_total").touch(route="b", code="500")
    g = reg.gauge("queue_depth", "Depth")
    g.set(4)
    g.labels(pool="x").inc(2.5)
    h = reg.histogram("lat_ms", "Latency")
    for i, v in enumerate([0.5, 3, 7, 12, 600, 30000]):
        h.observe(v, t=100.0 + i)
    h.exemplar("req-7", 12)
    c = reg.histogram("size", "Sizes", buckets=(1, 10, 100))
    c.labels(kind="k").observe(5, t=1.0)
    c.labels(kind="k").observe(50, t=2.0)
    text = "\n".join(l for l in reg.prometheus_text().splitlines()
                     if not any(n in l for n in RUNTIME))
    snap = {k: v for k, v in reg.snapshot().items()
            if not any(k.startswith(n) for n in RUNTIME)}
    stats = (h.quantile(0.5), h.quantile(0.99), h.quantile(0.5, window_s=3.5, now=105.0),
             h.window_values(2.0, now=103.0), h.count, h.sum,
             reg.counter("requests_total").total(), reg.counter("requests_total").total(
                 route="a"), g.value(pool="x"), c.total())
    with pytest.raises(ValueError):
        reg.counter("requests_total").inc(-1)
    with pytest.raises(TypeError):
        reg.gauge("requests_total")
    return text, snap, stats


def test_registry_exports_match_reference():
    assert _drive(M) == _drive(RM)


def test_record_helpers_move_the_same_families():
    def run(mod, ds):
        reg = mod.MetricsRegistry()
        mod._registry, saved = reg, mod._registry
        try:
            mod.record_train_step(3, samples=12)
            mod.record_etl(reg, 2.5, 1.5, 1.0, samples=mod.batch_rows(ds))
        finally:
            mod._registry = saved
        return {k: v for k, v in reg.snapshot().items()
                if not any(k.startswith(n) for n in RUNTIME)}
    ds = DataSet(np.zeros((7, 2)), np.zeros((7, 1)))
    assert run(M, ds) == run(RM, ds)
    assert M.batch_rows(MultiDataSet([torch.zeros(5, 2)], [np.zeros((5, 1))])) == 5
    assert M.batch_rows(object()) == 0


def test_device_memory_stats_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert M.device_memory_stats() == []
    assert "device_bytes_in_use" in M.registry().prometheus_text()
    assert M.host_rss_bytes() > 0


def _events(mod, fence_value):
    mod.clear()
    mod.enable(ring_size=64, fence_every=2)
    try:
        with mod.span("fit", epochs=1):
            sp = mod.begin("step", step_num=4)
            mod.add_span("etl", time.perf_counter(), 0.001, cat="data", rows=8)
            with mod.span("dispatch"):
                pass
            sp.end()
            sp.end()    # a second end records nothing
            mod.begin("step", step_num=5).cancel()
            waits = [mod.fence(1, fence_value), mod.fence(2, fence_value),
                     mod.fence(2, None)]
    finally:
        mod.disable()
    with mod.span("after"):   # disabled: nothing recorded
        pass
    events = mod.export_trace_events()
    mod.clear()
    return ([(e["name"], e["cat"], e.get("args"), e["ph"]) for e in events["traceEvents"]],
            events["displayTimeUnit"], [w is None for w in waits])


def test_trace_events_match_reference():
    import jax.numpy as jnp
    got = _events(T, torch.tensor(1.0))
    want = _events(RT, jnp.float32(1.0))
    assert got == want
    assert [n for n, *_ in got[0]] == ["fit", "step", "etl", "dispatch", "device"]


def test_annotate_enters_record_function(monkeypatch):
    names = []

    class Recorder:
        def __init__(self, name):
            names.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Recorder)
    T.enable(annotate=True)
    try:
        with T.span("dispatch"):
            pass
        T.begin("step", step_num=7).end()
    finally:
        T.disable()
        T.clear()
    assert names == ["dispatch", "step#7"]


def test_dump_writes_the_ring(tmp_path):
    T.enable()
    try:
        with T.span("epoch", epoch=0):
            pass
    finally:
        T.disable()
    path = T.dump(str(tmp_path / "trace.json"))
    T.clear()
    with open(path) as f:
        assert [e["name"] for e in json.load(f)["traceEvents"]] == ["epoch"]
