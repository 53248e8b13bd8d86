"""Nestable span tracing over the training loop, with a Chrome
trace-event exporter.

Port of `deeplearning4j_tpu/optimize/tracing.py`. The fit loops emit the
span taxonomy `fit / epoch / step / {etl, dispatch, device}`. Spans are
`time.perf_counter` intervals recorded into a bounded ring buffer (O(1)
memory however long training runs) and export as Chrome trace-event-format
JSON (`ph:"X"` complete events; load in chrome://tracing or Perfetto).

Three design points keep steady-state overhead negligible:

* Disabled (the default), `span()` returns a shared no-op context
  manager: one branch per call site, nothing recorded.
* CUDA launches are asynchronous, so a `dispatch` span measures host-side
  enqueue time only. The sampled FENCE (`fence(step, value)`, every
  `fence_every`-th step) records a CUDA event on the value's device and
  waits for it, and records the wait as a `device` span: the drain of the
  card's queue, the dispatch-side vs device-compute split. It adds no
  computation.
* `annotate=True` additionally enters `torch.profiler.record_function`
  (named ``step#N`` for spans carrying a `step_num` arg) so spans line up
  with the kernels in a torch.profiler capture.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

__all__ = ["enable", "disable", "is_enabled", "clear", "span", "begin",
           "add_span", "add_spans", "fence", "export_trace_events", "dump",
           "DEFAULT_FENCE_EVERY"]

# Default fence sampling once tracing is enabled: 1 fenced step in 16
# bounds the pipelining loss to ~1/16 of one step's dispatch-ahead.
# With tracing disabled there is NO fencing at all.
DEFAULT_FENCE_EVERY = 16

_lock = threading.Lock()
_enabled = False
_annotate = False
_fence_every = 0
_ring: deque = deque(maxlen=4096)


class _NullSpan:
    """Reusable no-op: the disabled-path return of span()/begin()."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self):
        pass

    def cancel(self):
        pass


_NULL = _NullSpan()


class Span:
    """One live interval; use as a context manager or via begin()/end().
    cancel() discards it (a `step` span opened before the iterator
    reported exhaustion)."""

    __slots__ = ("name", "args", "cat", "_t0", "_ann", "_done")

    def __init__(self, name: str, args: Dict[str, Any],
                 cat: Optional[str] = None):
        self.name = name
        self.args = args
        self.cat = cat
        self._ann = None
        self._done = False
        if _annotate:
            self._ann = _make_annotation(name, args)
            if self._ann is not None:
                self._ann.__enter__()
        self._t0 = time.perf_counter()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def end(self):
        if self._done:
            return
        self._done = True
        dur = time.perf_counter() - self._t0
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
        _record(self.name, self._t0, dur, self.args, self.cat)

    def cancel(self):
        if self._done:
            return
        self._done = True
        if self._ann is not None:
            self._ann.__exit__(None, None, None)


def _make_annotation(name: str, args: Dict[str, Any]):
    try:
        import torch
        if "step_num" in args:
            name = f"{name}#{int(args['step_num'])}"
        return torch.profiler.record_function(name)
    except Exception:
        return None


def _record(name: str, t0: float, dur: float,
            args: Optional[Dict[str, Any]], cat: Optional[str] = None):
    ev = {"name": name, "ts": t0 * 1e6, "dur": dur * 1e6,
          "tid": threading.get_ident()}
    if cat:
        ev["cat"] = cat
    if args:
        ev["args"] = args
    _ring.append(ev)  # deque.append is atomic; maxlen bounds memory


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------
def enable(ring_size: int = 4096, annotate: bool = False,
           fence_every: int = DEFAULT_FENCE_EVERY) -> None:
    """Turn tracing on. `fence_every=0` disables the sampled device
    fence (dispatch-side timings only); `annotate=True` mirrors spans
    into torch.profiler.record_function ranges."""
    global _enabled, _annotate, _fence_every, _ring
    with _lock:
        _ring = deque(_ring, maxlen=int(ring_size))
        _annotate = bool(annotate)
        _fence_every = max(0, int(fence_every))
        _enabled = True


def disable() -> None:
    global _enabled, _annotate, _fence_every
    with _lock:
        _enabled = False
        _annotate = False
        _fence_every = 0


def is_enabled() -> bool:
    return _enabled


def clear() -> None:
    _ring.clear()


def span(name: str, cat: Optional[str] = None, **args):
    """Context manager for one interval; no-op (shared singleton) when
    tracing is disabled. `cat` tags the Chrome-export category ("train"
    when omitted)."""
    if not _enabled:
        return _NULL
    return Span(name, args, cat)


def begin(name: str, cat: Optional[str] = None, **args):
    """Explicitly-ended span for intervals that cannot nest lexically
    (the step span opened before the iterator is polled)."""
    if not _enabled:
        return _NULL
    return Span(name, args, cat)


def add_span(name: str, start: float, dur_s: float,
             cat: Optional[str] = None, **args) -> None:
    """Record a retroactive span from an already-measured interval
    (`start` in time.perf_counter seconds): the fit loops time ETL with
    perf_counter anyway, so the span costs nothing extra. `cat` tags the
    event category in the Chrome export ("train" when omitted)."""
    if not _enabled:
        return
    _record(name, start, dur_s, args or None, cat)


def add_spans(spans, cat: Optional[str] = None, **args) -> None:
    """Bulk `add_span`: `spans` is [(name, start_s, dur_s)], recorded with
    one enabled check and ONE shared args dict (the serving flight recorder
    emits a span per phase of every request). The shared dict is stored by
    reference; callers must not change it afterwards."""
    if not _enabled:
        return
    shared = args or None
    tid = threading.get_ident()
    for name, start, dur_s in spans:
        ev = {"name": name, "ts": start * 1e6, "dur": dur_s * 1e6, "tid": tid}
        if cat:
            ev["cat"] = cat
        if shared:
            ev["args"] = shared
        _ring.append(ev)


def fence(step: int, value) -> Optional[float]:
    """Sampled drain of the card's queue: every `fence_every`-th step,
    record a CUDA event on the current stream of `value`'s device
    (typically the committed loss) and wait for it; the wait is recorded as
    a `device` span. A value on the CPU has nothing queued and records a
    span of the host's own wait (none). Returns the wait in ms when it ran,
    else None. No-op when tracing is off or fence_every == 0."""
    if not _enabled or _fence_every <= 0 or value is None:
        return None
    if step % _fence_every != 0:
        return None
    t0 = time.perf_counter()
    try:
        import torch
        if isinstance(value, torch.Tensor) and value.is_cuda:
            with torch.cuda.device(value.device):
                ev = torch.cuda.Event()
                ev.record()
                ev.synchronize()
    except Exception:
        return None
    dur = time.perf_counter() - t0
    _record("device", t0, dur, {"step": int(step)})
    return dur * 1000.0


def export_trace_events() -> Dict[str, Any]:
    """Chrome trace-event-format dict: {"traceEvents": [...],
    "displayTimeUnit": "ms"}. Events are ph:"X" completes; nesting is
    derived by the viewer from ts/dur containment per tid."""
    pid = os.getpid()
    events = []
    for ev in list(_ring):
        out = {"name": ev["name"], "ph": "X", "pid": pid,
               "tid": ev["tid"], "ts": round(ev["ts"], 3),
               "dur": round(ev["dur"], 3), "cat": ev.get("cat", "train")}
        if "args" in ev:
            out["args"] = ev["args"]
        events.append(out)
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump(path: str) -> str:
    """Write the current ring as trace-event JSON; returns the path."""
    with open(path, "w") as f:
        json.dump(export_trace_events(), f)
    return path
