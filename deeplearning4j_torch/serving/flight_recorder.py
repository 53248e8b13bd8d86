"""Per-request flight recorder for the serving plane: phase-attributed
tail latency, slow-request exemplars, and Chrome-trace serving spans.

Port of `deeplearning4j_tpu/serving/flight_recorder.py` over the port's
optimize/tracing.py and optimize/metrics.py.

A request crosses six layers on its way through the gateway — admission,
WFQ scheduler arbitration, coalesced/packed collection, (fused) forward,
device fence, unslice — and the aggregate families in `ModelPool` can
say a tier's p99 breached its SLO but not *which phase ate the budget*.
This module closes that gap with a Dapper-style trace that costs one
small object per request and zero host syncs:

* `RequestTrace` holds a `perf_counter` origin plus an append-only list
  of **cut-point marks** `(phase, t)`. A mark means "this phase ended
  now"; the phase's start is the previous mark (or the origin). Phases
  are therefore contiguous, monotonic, non-overlapping, and sum to the
  traced wall time *by construction* — no per-phase begin/end pairing
  to get wrong under retries.
* The recorder is process-global and OFF by default. Disabled,
  `new_trace()` returns None and every downstream touch point is one
  `is None` branch: the untraced serving path stays bitwise- and
  compile-count-identical.
* `complete()` runs once per request at response time, off the engine's
  forward lock: it folds the marks into `serving_phase_ms` histograms,
  emits retroactive `tracing.add_span` events (cat="serve") into the
  bounded ring `export_trace_events()` already serves, and — for
  requests that breached their tier SLO, errored, or were shed —
  captures the full timeline + context into a bounded exemplar ring
  surfaced at `GET /debug/requests` and linked from the histogram
  exposition via OpenMetrics-style exemplar comments.

Phase taxonomy:

  admission   gateway entry → engine handoff (breaker/tier/SLO checks)
  queue_wait  collector queue: linger + any prior batch's execution
  pack        batch assembly: concatenate/pad or varlen splice+mask
  sched_wait  engine lock + DeviceScheduler slot wait (incl. swap pause)
  dispatch    slot grant → forward call (host-side submit bookkeeping)
  device      the forward itself, up to its result on the host
  prefill     decode only: packed segment-masked prompt forward + KV fill
  decode_step decode only: the iteration-level token loop (per-step marks
              aggregate — the phase sum stays cut-point exact)
  unpack      per-request scatter/unslice + member transform
  respond     the engine's result handed back: the caller's wake-up and
              the gateway's own bookkeeping, up to the instant it reads
              its wall clock (the port's addition, see below)

One-shot requests walk ONESHOT_PHASES; decode requests route device
time through `prefill`/`decode_step` instead of `device`.

The gateway starts a trace at the instant it starts its wall clock and
closes it with `respond` at the instant it stops it, so an exemplar's
phases sum to its `wall_ms`. The reference stops at `unpack` and leaves
the caller's wake-up outside every phase; on a host whose threads share
few cores that wake-up can wait a GIL switch interval (5 ms), so the
port names it instead of leaving it unaccounted.

`device` opens at the forward CALL, not at a mid-forward fence: the
enqueue cost belongs with the computation it enqueues, and the serving
plane inserts no extra syncs (the port's forward hands back host arrays,
so its end is the device's end) — so a fat `dispatch` always means
host-side submit overhead, by definition.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..optimize import tracing
from ..optimize.metrics import registry

__all__ = [
    "RequestTrace", "PHASES", "ONESHOT_PHASES", "enable", "disable",
    "is_enabled", "clear", "new_trace", "complete", "exemplars",
    "register_metrics", "maybe_enable_from_env", "DEFAULT_EXEMPLAR_RING",
    "ENV_FLAG",
]

#: The full phase taxonomy in path order. Error/shed paths legitimately
#: stop early (a breaker fast-fail has only `admission`); one-shot
#: requests never mark `prefill`/`decode_step` (see ONESHOT_PHASES) and
#: decode requests never mark the one-shot `pack`..`device` window.
PHASES = ("admission", "queue_wait", "pack", "sched_wait", "dispatch",
          "device", "prefill", "decode_step", "unpack", "respond")

#: The seven phases every fully-served ONE-SHOT request decomposes into
#: — what `ParallelInference.output()` walks end to end (the gateway
#: closes the timeline with `respond` after them).
ONESHOT_PHASES = ("admission", "queue_wait", "pack", "sched_wait",
                  "dispatch", "device", "unpack")

DEFAULT_EXEMPLAR_RING = 64
ENV_FLAG = "DL4JTPU_FLIGHT_RECORDER"

# Phase durations are small (sub-ms linger to ~SLO); reuse the serving
# latency bucket geometry but extend downward for the fast phases.
PHASE_BUCKETS_MS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                    50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0)

_lock = threading.Lock()
_enabled = False
_owns_tracing = False  # did enable() turn the span ring on itself?
_exemplars: deque = deque(maxlen=DEFAULT_EXEMPLAR_RING)
_ids = itertools.count(1)

_PHASE_HELP = ("Per-request phase attribution (flight recorder): where "
               "a request's wall latency went")
# complete() runs per response: cache the labeled histogram children so
# the steady state pays one dict read instead of a sorted label-key
# build + registry lock per phase (the registry is a process-global
# singleton, so cached children can never go stale). Plain dict
# get/set — last-writer-wins races just re-do one cheap lookup.
_hist_cache: Dict[Tuple[str, str, str], Any] = {}
_SPAN_NAMES = {p: "serve/" + p for p in PHASES}


def _phase_hist(model: str, tier: str, phase: str):
    key = (model, tier, phase)
    child = _hist_cache.get(key)
    if child is None:
        child = registry().histogram(
            "serving_phase_ms", _PHASE_HELP,
            buckets=PHASE_BUCKETS_MS).labels(
                model=model, tier=tier, phase=phase)
        _hist_cache[key] = child
    return child


class RequestTrace:
    """One request's phase timeline: a perf_counter origin and an
    append-only list of cut-point marks. Allocated at gateway admission,
    threaded through the engine on the `_Request`, finalized by
    `complete()` at response time. The hot path only ever calls
    `mark()` (a perf_counter read + list append) and writes `ctx` keys —
    no locks, no syncs, no allocation beyond this object."""

    __slots__ = ("rid", "model", "tier", "t0", "marks", "ctx")

    def __init__(self, rid: int, model: str, tier: str,
                 t0: Optional[float] = None):
        self.rid = rid
        self.model = model
        self.tier = tier
        self.t0 = time.perf_counter() if t0 is None else t0
        self.marks: List[Tuple[str, float]] = []
        self.ctx: Dict[str, Any] = {}

    def mark(self, phase: str, t: Optional[float] = None) -> None:
        """Record that `phase` ended now (or at perf_counter `t`). The
        phase's start is implicitly the previous mark — repeated marks
        of the same phase (solo-retry attempts) just add segments."""
        self.marks.append(
            (phase, time.perf_counter() if t is None else t))

    def segments(self) -> List[Tuple[str, float, float]]:
        """[(phase, abs_start_s, dur_s)] — contiguous by construction."""
        out = []
        prev = self.t0
        for phase, t in self.marks:
            out.append((phase, prev, max(0.0, t - prev)))
            prev = t
        return out

    def phase_ms(self) -> Dict[str, float]:
        """Total ms per phase (segments of one phase aggregate)."""
        out: Dict[str, float] = {}
        for phase, _, dur in self.segments():
            out[phase] = out.get(phase, 0.0) + dur * 1000.0
        return out

    def summary(self) -> Dict[str, Any]:
        """JSON-ready timeline for response embedding / exemplars."""
        return {
            "id": self.rid,
            "model": self.model,
            "tier": self.tier,
            "phases": [
                {"phase": p,
                 "start_ms": round((s - self.t0) * 1000.0, 4),
                 "ms": round(d * 1000.0, 4)}
                for p, s, d in self.segments()],
            "context": dict(self.ctx),
        }


# ---------------------------------------------------------------------------
# Recorder lifecycle
# ---------------------------------------------------------------------------
def enable(exemplar_ring: int = DEFAULT_EXEMPLAR_RING) -> None:
    """Turn the recorder on. Also enables the span ring (fence_every=0:
    serving never wants the training loop's sampled device fence) if the
    caller hasn't already, and remembers that it did so `disable()`
    restores the prior tracing state."""
    global _enabled, _owns_tracing, _exemplars
    with _lock:
        _exemplars = deque(_exemplars, maxlen=max(1, int(exemplar_ring)))
        if not tracing.is_enabled():
            tracing.enable(fence_every=0)
            _owns_tracing = True
        _enabled = True


def disable() -> None:
    global _enabled, _owns_tracing
    with _lock:
        _enabled = False
        if _owns_tracing:
            tracing.disable()
            _owns_tracing = False


def is_enabled() -> bool:
    return _enabled


def clear() -> None:
    _exemplars.clear()


def maybe_enable_from_env() -> bool:
    """Arm from the environment (`DL4JTPU_FLIGHT_RECORDER=1` or `=N` for
    an N-deep exemplar ring) — the gateway calls this at construction so
    an operator can trace a misbehaving deployment without a code
    change. Returns whether the recorder is enabled afterwards."""
    spec = os.environ.get(ENV_FLAG, "").strip()
    if spec and spec != "0":
        try:
            n = int(spec)
        except ValueError:
            n = DEFAULT_EXEMPLAR_RING
        enable(exemplar_ring=n if n > 1 else DEFAULT_EXEMPLAR_RING)
    return _enabled


# ---------------------------------------------------------------------------
# Per-request API (gateway-facing)
# ---------------------------------------------------------------------------
def new_trace(model: str, tier: str = "standard",
              t0: Optional[float] = None) -> Optional[RequestTrace]:
    """Allocate a trace at admission; None when the recorder is off (the
    single branch the disabled path pays). `t0` is the caller's own
    perf_counter start, so the timeline and its wall clock share an
    origin."""
    if not _enabled:
        return None
    return RequestTrace(next(_ids), model, tier, t0)


def complete(trace: Optional[RequestTrace], status: str,
             wall_ms: float, slo_ms: Optional[float] = None,
             want_summary: bool = False) -> Optional[Dict[str, Any]]:
    """Finalize a trace at response time: fold marks into the
    `serving_phase_ms` histograms, emit retroactive serving spans, and
    capture an exemplar when the request breached its SLO, errored, or
    was shed. The JSON-ready summary is built only when an exemplar is
    captured or the caller asks (`want_summary` — the HTTP /predict
    embed); healthy in-process requests skip it. Returns the summary
    when built, else None."""
    if trace is None:
        return None
    segs = trace.segments()
    phase_ms: Dict[str, float] = {}
    for phase, _, dur in segs:
        phase_ms[phase] = phase_ms.get(phase, 0.0) + dur * 1000.0
    model, tier = trace.model, trace.tier
    for phase, ms in phase_ms.items():
        _phase_hist(model, tier, phase).observe(ms)
    if tracing.is_enabled():
        names = _SPAN_NAMES
        tracing.add_spans(
            [(names.get(phase) or "serve/" + phase, start, dur)
             for phase, start, dur in segs],
            cat="serve", model=model, rid=trace.rid)
    slow = slo_ms is not None and wall_ms > slo_ms
    capture = status != "ok" or slow
    if not (capture or want_summary):
        return None
    summary = trace.summary()
    summary["status"] = status
    summary["wall_ms"] = round(float(wall_ms), 4)
    if slo_ms is not None:
        summary["slo_ms"] = float(slo_ms)
    if capture:
        _exemplars.append(summary)  # deque.append is atomic
        # link the scrape surface to the exemplar store: the slowest
        # phase carries this request's id in the exposition comment
        if phase_ms:
            worst = max(phase_ms, key=phase_ms.get)
            _phase_hist(model, tier, worst).exemplar(
                str(trace.rid), phase_ms[worst])
    return summary


def exemplars(model: Optional[str] = None, tier: Optional[str] = None
              ) -> List[Dict[str, Any]]:
    """Captured slow/errored/shed request timelines, newest last,
    optionally filtered (the `GET /debug/requests?model=&tier=`
    surface)."""
    out = list(_exemplars)
    if model:
        out = [e for e in out if e.get("model") == model]
    if tier:
        out = [e for e in out if e.get("tier") == tier]
    return out


def register_metrics() -> None:
    """Pre-register the recorder's families so a scrape distinguishes
    'recorder never fired' from 'families absent'."""
    reg = registry()
    reg.histogram("serving_phase_ms", _PHASE_HELP,
                  buckets=PHASE_BUCKETS_MS)
    reg.counter(
        "serving_slo_breach_total",
        "Requests whose wall latency exceeded their tier's "
        "serving_tier_slo_ms, counted at response time")
