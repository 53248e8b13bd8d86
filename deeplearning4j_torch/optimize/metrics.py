"""Process-global metrics registry: the single source of truth for
training telemetry.

Port of `deeplearning4j_tpu/optimize/metrics.py` (the reference routes every
number through BaseStatsListener -> StatsStorage): one thread-safe registry
of labeled Counter / Gauge / Histogram families, exported two ways:

* `registry().prometheus_text()`: Prometheus text exposition format.
* `registry().snapshot()`: a flat {name{labels}: value} dict.

Device visibility: a runtime collector samples `torch.cuda.memory_stats`
of every visible GPU at scrape time into per-device `device_bytes_in_use` /
`device_peak_bytes_in_use` gauges (none without a GPU), plus host RSS with
the platform-correct `ru_maxrss` units (KiB on Linux, bytes on Darwin).

Not ported: `register_jit_probe` and the `jit_cache_size` gauge, which read
XLA's per-shape compile caches; torch runs eagerly and has none.

Overhead: a counter bump is a dict lookup + lock; sampling happens only at
scrape/snapshot time, never in the step loop. Nothing here syncs the
device.
"""
from __future__ import annotations

import collections
import resource
import sys
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "host_rss_bytes", "device_memory_stats", "record_train_step",
    "record_etl", "batch_rows",
]

# Invalid label/metric characters are the caller's problem — names here
# are all code-authored. Prometheus escaping rules for label VALUES are
# applied on export (backslash, quote, newline).
_LABEL_ESCAPES = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}


def _escape_label(v: str) -> str:
    return "".join(_LABEL_ESCAPES.get(c, c) for c in str(v))


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)
    return "{" + inner + "}"


class _Family:
    """One named metric family; children keyed by their label set.
    Unlabeled use (`family.inc()`) operates on the empty-label child."""

    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.RLock):
        self.name = name
        self.help = help
        self._lock = lock
        self._children: Dict[Tuple[Tuple[str, str], ...], "_Family"] = {}
        self._value = 0.0

    def labels(self, **labels) -> "_Family":
        key = _label_key(labels)
        if not key:
            return self
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = type(self)(self.name, self.help, self._lock)
                self._children[key] = child
            return child

    def touch(self, **labels) -> "_Family":
        """Materialize the labeled child at its zero value without
        changing it — pre-registration, so a snapshot can distinguish
        'this label set never fired' (exported 0) from 'this code path
        never ran' (absent)."""
        return self.labels(**labels)

    # ---- iteration over (label_key, child) incl. the bare child --------
    def _cells(self):
        with self._lock:
            items = list(self._children.items())
        out = []
        if not items or self._touched():
            out.append(((), self))
        out.extend(items)
        return out

    def _touched(self) -> bool:
        return not self._children  # bare families always export

    def items(self) -> List[Tuple[Dict[str, str], "_Family"]]:
        """[(labels_dict, child)] snapshot including the bare child when
        it exports — the scrape-side iteration surface the gateway's
        percentile collector and the SLO monitor walk."""
        return [(dict(key), child) for key, child in self._cells()]

    def value(self, **labels) -> float:
        child = self.labels(**labels)
        with self._lock:
            return child._value

    def total(self, **labels) -> float:
        """Sum of this family's value across every label set (the
        label-blind aggregate bench extras and health summaries want:
        e.g. breaker transitions regardless of target state).
        Histograms aggregate their observation counts. A label filter
        (`total(outcome="canary_rejected")`) sums only the children
        whose label set carries every given pair — the bare child never
        matches a non-empty filter."""
        want = {(k, str(v)) for k, v in labels.items()}
        with self._lock:
            cells = [((), self)] + list(self._children.items())
            tot = 0.0
            for key, c in cells:
                if want and not want.issubset(set(key)):
                    continue
                tot += c._n if isinstance(self, Histogram) else c._value
            return float(tot)


class Counter(_Family):
    """Monotonic counter (Prometheus counter semantics)."""

    kind = "counter"

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount


class Gauge(_Family):
    """Set-anytime value (scores, queue depths, memory bytes)."""

    kind = "gauge"

    def __init__(self, name, help, lock):
        super().__init__(name, help, lock)
        self._set = False

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
            self._set = True

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount
            self._set = True

    def _touched(self) -> bool:
        return self._set or not self._children


DEFAULT_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   500.0, 1000.0, 2500.0, 10000.0)


class Histogram(_Family):
    """Cumulative-bucket histogram (Prometheus histogram exposition:
    `_bucket{le=...}`, `_sum`, `_count`) plus a bounded ring of recent
    (timestamp, value) observations for *windowed* quantiles — the
    cumulative buckets answer "over the process lifetime", the ring
    answers "over the last N seconds" (what an SLO verdict needs)."""

    kind = "histogram"

    # Ring capacity per child: at 2048 the window math matches the
    # recent-latency deques it replaced; beyond it the OLDEST
    # observations drop first, so a saturated ring under-reports the
    # window span, never the recency.
    RING = 2048

    def __init__(self, name, help, lock,
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, lock)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self._sum = 0.0
        self._n = 0
        self._ring: "collections.deque" = collections.deque(maxlen=self.RING)
        self._exemplar: Optional[Tuple[str, float]] = None

    def labels(self, **labels) -> "Histogram":
        key = _label_key(labels)
        if not key:
            return self
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = Histogram(self.name, self.help, self._lock,
                                  self.buckets)
                self._children[key] = child
            return child

    def observe(self, value: float, t: Optional[float] = None) -> None:
        """Record one observation. `t` overrides the ring timestamp
        (time.monotonic() by default) — the fake-clock seam windowed
        tests inject through, paired with `now=` on quantile()."""
        v = float(value)
        ts = time.monotonic() if t is None else float(t)
        with self._lock:
            self._sum += v
            self._n += 1
            self._ring.append((ts, v))
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def window_values(self, window_s: Optional[float] = None,
                      now: Optional[float] = None) -> List[float]:
        """Observations from the last `window_s` seconds (ring-bounded;
        None = everything still in the ring), oldest first. `now`
        defaults to time.monotonic() — pass the same clock observe()
        was stamped with when injecting a fake one. The window is
        two-sided, (now - window_s, now]: an observation stamped AFTER
        `now` is on a different clock (a fake-clock test sharing the
        process-global registry with a real-clock reader) and must not
        leak into this reader's view of "recent"."""
        cutoff = None
        if window_s is not None:
            ref = time.monotonic() if now is None else float(now)
            cutoff = (ref - float(window_s), ref)
        with self._lock:
            if cutoff is None:
                return [v for _, v in self._ring]
            return [v for ts, v in self._ring
                    if cutoff[0] <= ts <= cutoff[1]]

    def quantile(self, q: float, window_s: Optional[float] = None,
                 now: Optional[float] = None) -> float:
        """Nearest-rank quantile over the windowed ring (0.0 when no
        observation lands in the window) — the ONE latency-percentile
        definition the scrape gauges, /stats, and the SLO monitor all
        share."""
        vals = sorted(self.window_values(window_s, now=now))
        if not vals:
            return 0.0
        qf = min(1.0, max(0.0, float(q)))
        idx = min(len(vals) - 1, int(round(qf * (len(vals) - 1))))
        return float(vals[idx])

    def exemplar(self, trace_id: str, value: float) -> None:
        """Attach the most recent exemplar observation (a request id the
        flight recorder holds a full phase timeline for). Exposed as an
        OpenMetrics-style comment after the `_count` line so a scrape
        links a tail bucket to `GET /debug/requests`."""
        with self._lock:
            self._exemplar = (str(trace_id), float(value))

    def _touched(self) -> bool:
        return self._n > 0 or not self._children

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


class MetricsRegistry:
    """Thread-safe named-family registry with pluggable collectors
    (callbacks run before every export/snapshot to sample lazy sources:
    device memory, host RSS)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []

    # ------------------------------------------------------- registration
    def _family(self, cls, name: str, help: str, **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(name, help, self._lock, **kw)
                self._families[name] = fam
            elif not isinstance(fam, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {fam.kind}")
            return fam

    def counter(self, name: str, help: str = "") -> Counter:
        return self._family(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._family(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._family(Histogram, name, help, buckets=buckets)

    def register_collector(self, fn: Callable[["MetricsRegistry"], None]):
        with self._lock:
            self._collectors.append(fn)
        return fn

    def collect(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn(self)
            except Exception:
                pass  # a broken sampler must never fail a scrape

    # ------------------------------------------------------------ export
    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        self.collect()
        with self._lock:
            families = sorted(self._families.values(),
                              key=lambda f: f.name)
        lines: List[str] = []
        for fam in families:
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in fam._cells():
                if isinstance(child, Histogram):
                    cum = 0
                    for b, c in zip(child.buckets, child._counts):
                        cum += c
                        bkey = key + (("le", _fmt(b)),)
                        lines.append(
                            f"{fam.name}_bucket{_label_str(bkey)} {cum}")
                    cum += child._counts[-1]
                    ikey = key + (("le", "+Inf"),)
                    lines.append(
                        f"{fam.name}_bucket{_label_str(ikey)} {cum}")
                    lines.append(
                        f"{fam.name}_sum{_label_str(key)} "
                        f"{_fmt(child._sum)}")
                    lines.append(
                        f"{fam.name}_count{_label_str(key)} {child._n}")
                    if child._exemplar is not None:
                        tid, val = child._exemplar
                        lines.append(
                            f"# EXEMPLAR {fam.name}{_label_str(key)} "
                            f'trace_id="{_escape_label(tid)}" '
                            f"value={_fmt(val)} see=/debug/requests")
                else:
                    lines.append(
                        f"{fam.name}{_label_str(key)} "
                        f"{_fmt(child._value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, float]:
        """Flat {name{labels}: value}; histograms contribute _count and
        _sum. The bench-JSON embedding format."""
        self.collect()
        out: Dict[str, float] = {}
        with self._lock:
            families = sorted(self._families.values(),
                              key=lambda f: f.name)
        for fam in families:
            for key, child in fam._cells():
                ls = _label_str(key)
                if isinstance(child, Histogram):
                    out[f"{fam.name}_count{ls}"] = child._n
                    out[f"{fam.name}_sum{ls}"] = round(child._sum, 3)
                else:
                    out[f"{fam.name}{ls}"] = round(child._value, 6)
        return out


# ---------------------------------------------------------------------------
# Runtime samplers (host RSS, device memory)
# ---------------------------------------------------------------------------
def host_rss_bytes() -> float:
    """Peak resident set size in BYTES. getrusage reports ru_maxrss in
    KiB on Linux but BYTES on macOS."""
    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return float(ru) if sys.platform == "darwin" else float(ru) * 1024.0


def device_memory_stats() -> List[Dict[str, float]]:
    """Per-GPU {device, bytes_in_use, peak_bytes_in_use} from the caching
    allocator's `torch.cuda.memory_stats` ("allocated_bytes.all.current" /
    ".peak"); an empty list without a GPU. A device that was never
    initialized reports 0s rather than creating a context."""
    import torch
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(i) if torch.cuda.is_initialized() \
                else {}
        except Exception:
            stats = {}
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": float(
                stats.get("allocated_bytes.all.peak", 0)),
        })
    return out


def _sample_runtime(reg: MetricsRegistry) -> None:
    reg.gauge("host_rss_bytes",
              "Peak host resident set size (platform-correct units)"
              ).set(host_rss_bytes())
    g_use = reg.gauge("device_bytes_in_use",
                      "Device bytes currently allocated by the caching "
                      "allocator")
    g_peak = reg.gauge("device_peak_bytes_in_use",
                       "Peak device bytes allocated by the caching allocator")
    for d in device_memory_stats():
        g_use.labels(device=d["device"]).set(d["bytes_in_use"])
        g_peak.labels(device=d["device"]).set(d["peak_bytes_in_use"])


# ---------------------------------------------------------------------------
# Process-global registry
# ---------------------------------------------------------------------------
_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def registry() -> MetricsRegistry:
    """The process-global registry (created on first use, with the
    runtime samplers installed)."""
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                reg = MetricsRegistry()
                reg.register_collector(_sample_runtime)
                reg.gauge("process_start_time_seconds",
                          "Unix time this registry was created"
                          ).set(time.time())
                _registry = reg
    return _registry


def record_train_step(steps: int = 1, samples: int = 0) -> None:
    """One-call hot-loop hook for the networks' commit paths: bumps
    train_iterations_total (and train_samples_total when the caller
    knows the batch rows). Shape metadata only, never a device value."""
    reg = registry()
    reg.counter("train_iterations_total",
                "Optimizer steps taken (all networks)").inc(steps)
    if samples:
        reg.counter("train_samples_total",
                    "Training examples consumed").inc(samples)


def record_etl(reg: MetricsRegistry, etl_ms: float, host_ms: float,
               h2d_ms: float, samples: int = 0) -> None:
    """Per-batch data-pipeline wait (the fit loops' lastEtlTime signal),
    host/h2d split included."""
    reg.gauge("etl_ms", "Data-pipeline wait for the last batch"
              ).set(etl_ms)
    reg.gauge("etl_host_ms",
              "Host-side (producer) share of the last ETL wait"
              ).set(host_ms)
    reg.gauge("etl_h2d_ms",
              "Host-to-device transfer share of the last ETL wait"
              ).set(h2d_ms)
    reg.histogram("etl_wait_ms",
                  "Distribution of per-batch data-pipeline waits"
                  ).observe(etl_ms)
    if samples:
        reg.counter("train_samples_total",
                    "Training examples consumed").inc(samples)


def batch_rows(ds) -> int:
    """Batch size of a DataSet / MultiDataSet from shape metadata only."""
    try:
        f = getattr(ds, "features", None)
        if f is None:
            return 0
        if isinstance(f, (list, tuple)):
            f = f[0] if f else None
        shape = getattr(f, "shape", None)
        return int(shape[0]) if shape else 0
    except Exception:
        return 0
