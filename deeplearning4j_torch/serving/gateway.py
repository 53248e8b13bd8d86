"""Serving gateway: admission, continuous batching, SLO shedding,
per-model routing, and checkpoint-gated hot-swap over one HTTP surface.

Port of `deeplearning4j_tpu/serving/gateway.py`: the same routes, the same
HTTP status and reason for every typed error, the same windowed
percentiles and `/stats`, over the port's engines on CUDA (or the CPU
where the caller put the model). One difference: a non-finite answer is
refused with 500 ``nonfinite`` before anything is serialized, also where
the entry runs without ``check_finite`` (``json.dumps`` would write
``NaN``, which is not JSON).

The request lifecycle:

    POST /predict ──► route (ModelPool) ──► ADMISSION
        │  deadline hopeless (EWMA wait estimate) ──► SHED 503
        │  queue full ──────────────────────────────► SHED 429
        ▼
    continuous-batching engine (ParallelInference): concurrent
    requests coalesce into ONE forward padded to the shared pow2
    bucket (data/padding.next_pow2_bucket), at the buckets warmup()
    ran — steady state meets no new shape.
        │  deadline passed while queued ──► SHED 503 (late)
        ▼
    row slices scattered back ──► 200 {"predictions", "model",
                                       "version", "latency_ms"}

Adapted from continuous batching (Orca, OSDI '22 — requests join the
next forward, no epoch barriers) and SLO-aware adaptive shedding
(Clipper, NSDI '17 — reject early what cannot make its deadline),
with the batch axis quantized to power-of-two buckets so the set of
shapes is finite and warmed.

Resilience: each model's circuit breaker
(serving/breaker.py) sits in front of admission — open state fast-fails
/predict with a distinct 503 `breaker_open` status, and `/health`
reports `degraded` while any breaker is not closed. Forward failures
surface as typed 5xx statuses (`batch_failed` / `nonfinite`), never
hangs.

Multi-model scale: when the pool carries
a DeviceScheduler, admission adds a TIER check — a lower-tier request is
shed with a typed 503 `tier_shed` while a strictly-higher tier's queue
is saturated — and per-tier latency rides
`serving_latency_ms{tier=...}` histograms plus scrape-time
`serving_tier_p99_ms{tier}` gauges (judged against the scheduler's
`serving_tier_slo_ms{tier}`). Fused-group members route exactly like
ordinary models: `/predict` carries the member name, the entry's
transform slices its columns out of the shared fused forward.

Generative entries: a model registered via
`add_decode_model` serves POST /generate through a DecodeEngine —
token-granularity continuous batching over a paged KV cache — behind
the SAME admission sequence (breaker → tier shed → deadline estimate)
and the same typed error surface, plus two decode-specific statuses:
429 `queue_full` when the KV cache itself is exhausted
(KVCacheExhaustedError) and 500 `batch_failed` for a mid-generation
step failure (DecodeStepError — batchmates keep generating).

Endpoints: POST /predict, POST /generate, POST /swap, POST /config (live
reconfiguration: per-entry tier/weight/packed-admission/
batch_timeout_ms plus scheduler-level quantum/shed_depth/
starvation_budget/tier_slo_ms, typed 400s on unknown or invalid
knobs), GET /health, GET /models, GET /stats, GET /metrics (Prometheus
exposition of the port's registry), plus the flight-recorder surfaces
GET /debug/requests?model=&tier= (slow-request exemplars) and
GET /trace (Chrome trace export of serving spans) — both 404 until
`serving.flight_recorder.enable()` (or DL4JTPU_FLIGHT_RECORDER=1) arms
the recorder — and GET /debug/tuner (the AutoTuner decision trail,
404 until `attach_tuner()` arms the serving control loop). Metrics:
`serving_requests_total{model,status}`, `serving_admitted_total`,
`serving_shed_total{model,reason}`, `serving_swaps_total{model,outcome,precision}`,
`serving_queue_depth{model}`, `serving_batch_failures_total{model}`,
`serving_breaker_state{model}`,
`serving_breaker_transitions_total{model,to}`,
`serving_slo_breach_total{model,tier}` (always on — a transient SLO
breach between scrapes is invisible to the p99 gauges),
`serving_latency_ms{model}` histogram plus scrape-time
`serving_latency_p50_ms`/`serving_latency_p99_ms` gauges (computed
from the histogram's windowed ring — ONE percentile definition shared
with /stats and the SLO monitor), with the recorder enabled
`serving_phase_ms{model,tier,phase}`, and with a tuner attached the `serving_tuner_*` /
`serving_slo_verdict{tier}` families (serving/autotuner.py).
Every request runs inside a `serve/request` tracing span.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional

import numpy as np

from ..optimize import tracing
from ..optimize.metrics import registry
from ..parallel.inference import (BatchExecutionError, DeadlineExceededError,
                                  NonFiniteOutputError, QueueFullError,
                                  ServerClosedError)
from ..utils.http_server import JsonHttpServer
from . import flight_recorder
from .breaker import BreakerOpenError
from .model_pool import ModelPool, SwapError
from .scheduler import DEFAULT_TIER_SLO_MS, TierShedError

__all__ = ["ServingGateway"]

# Latency histogram buckets in ms — sub-ms to 10 s.
LATENCY_BUCKETS_MS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                      250.0, 500.0, 1000.0, 2500.0, 10000.0)


def _percentile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return float(sorted_vals[idx])


def register_metrics() -> None:
    """Pre-register the gateway's request/latency families: a scrape
    taken before any traffic must already show them."""
    reg = registry()
    reg.counter("serving_requests_total",
                "Gateway requests by terminal status (ok/shed/error)")
    reg.counter("serving_admitted_total",
                "Requests admitted past SLO/backpressure checks")
    reg.counter("serving_shed_total",
                "Requests shed before a forward served them, by reason")
    reg.histogram("serving_latency_ms",
                  "End-to-end request latency through the gateway",
                  buckets=LATENCY_BUCKETS_MS)
    reg.gauge("serving_latency_p50_ms",
              "p50 gateway latency over the recent window")
    reg.gauge("serving_latency_p99_ms",
              "p99 gateway latency over the recent window")
    reg.gauge("serving_tier_p99_ms",
              "p99 gateway latency per priority tier over the recent "
              "window (compare against serving_tier_slo_ms)")


class ServingGateway(JsonHttpServer):
    """HTTP + in-process serving facade over a ModelPool.

    `default_deadline_ms` applies to requests that carry no deadline
    (None = no SLO, never shed on time). `shed_headroom` scales the
    admission wait estimate (>1.0 sheds earlier, trading recall of the
    SLO for fewer wasted queue slots)."""

    def __init__(self, pool: Optional[ModelPool] = None, *, port: int = 0,
                 pool_size: int = 8,
                 default_deadline_ms: Optional[float] = None,
                 shed_headroom: float = 1.0,
                 latency_window_s: float = 60.0):
        super().__init__(
            get_routes={"/health": self._health_route,
                        "/models": self._models_route,
                        "/stats": self._stats_route,
                        "/debug/requests": self._debug_requests_route,
                        "/debug/tuner": self._debug_tuner_route},
            post_routes={"/predict": self._predict_route,
                         "/generate": self._generate_route,
                         "/swap": self._swap_route,
                         "/config": self._config_route},
            raw_get_routes={"/trace": self._trace_route},
            port=port, pool_size=pool_size, expose_metrics=True)
        self.pool = pool if pool is not None else ModelPool()
        # Operator escape hatch: DL4JTPU_FLIGHT_RECORDER=1 arms the
        # per-request recorder without a code change.
        flight_recorder.maybe_enable_from_env()
        self.default_deadline_ms = default_deadline_ms
        self.shed_headroom = float(shed_headroom)
        # ONE latency-percentile definition: /stats, the scrape gauges, and the
        # SLO monitor all read the serving_latency_ms histogram's
        # windowed ring over this many recent seconds.
        self.latency_window_s = float(latency_window_s)
        # Window floor: the registry (and its histogram rings) is
        # process-global but THIS gateway is not — observations stamped
        # before it existed (a previous gateway in the same process)
        # must never leak into its percentiles.
        self._born = time.monotonic()
        # AutoTuner attachment point (serving/autotuner.py). None by
        # default: no monitor, no thread, no ledger — today's serving
        # path bitwise.
        self.tuner = None
        reg = registry()
        self._req_c = reg.counter(
            "serving_requests_total",
            "Gateway requests by terminal status (ok/shed/error)")
        self._admit_c = reg.counter(
            "serving_admitted_total",
            "Requests admitted past SLO/backpressure checks")
        self._shed_c = reg.counter(
            "serving_shed_total",
            "Requests shed before a forward served them, by reason")
        self._lat_h = reg.histogram(
            "serving_latency_ms",
            "End-to-end request latency through the gateway",
            buckets=LATENCY_BUCKETS_MS)
        self._slo_breach_c = reg.counter(
            "serving_slo_breach_total",
            "Requests whose wall latency exceeded their tier's "
            "serving_tier_slo_ms, counted at response time")
        reg.register_collector(self._collect_percentiles)

    # ------------------------------------------------------------ model mgmt
    def add_model(self, name: str, model, **kw):
        """pool.add passthrough (see ModelPool.add for knobs)."""
        return self.pool.add(name, model, **kw)

    def add_decode_model(self, name: str, model, **kw):
        """pool.add_decode passthrough: register a generative entry
        behind a DecodeEngine, served via generate()/POST /generate
        (see ModelPool.add_decode for knobs)."""
        return self.pool.add_decode(name, model, **kw)

    def add_fused_group(self, group_name: str, members, **kw):
        """pool.add_fused_group passthrough: N same-geometry models
        behind one fused forward (falls back to independent entries
        when the member set cannot merge)."""
        return self.pool.add_fused_group(group_name, members, **kw)

    def warmup(self, name: Optional[str] = None, **kw) -> "ServingGateway":
        self.pool.warmup(name, **kw)
        return self

    def swap(self, name: str, **kw) -> Dict[str, Any]:
        """Checkpoint-gated hot-swap (ModelPool.swap protocol)."""
        return self.pool.swap(name, **kw)

    def load(self) -> Dict[str, float]:
        """Admission load across every entry: the queued requests summed
        and the worst EWMA wait estimate. A federation replica rides it on
        its beats, so the front end's least-loaded dispatch sees each
        replica's pressure (serving/federation.py); an engine without an
        estimator adds its depth only."""
        depth = 0
        wait = 0.0
        for e in self.pool.entries():
            try:
                depth += int(e.engine.queue_depth())
            except Exception:
                continue
            est = getattr(e.engine, "estimate_wait_s", None)
            if est is not None:
                try:
                    wait = max(wait, float(est()))
                except Exception:
                    pass
        return {"queue_depth": depth, "est_wait_s": wait}

    # -------------------------------------------------------------- predict
    def predict(self, name: str, x, *,
                deadline_ms: Optional[float] = None,
                _trace_sink: Optional[list] = None) -> np.ndarray:
        """In-process entry point (the HTTP route is a thin wrapper).
        Raises DeadlineExceededError / QueueFullError on shed,
        BreakerOpenError when the model's circuit breaker fast-fails
        the request, BatchExecutionError (NonFiniteOutputError for
        NaN/Inf outputs) when the forward itself failed, KeyError on
        unknown model.

        `_trace_sink` (private: the /predict route) receives the
        completed flight-recorder summary when the recorder is enabled,
        so the HTTP response can embed the phase timeline."""
        # Unknown model: plain KeyError, no metrics — client-supplied
        # junk names must not mint unbounded label cardinality.
        entry = self.pool.get(name)
        t0 = time.perf_counter()
        status = "error"
        # Flight recorder: disabled (default)
        # this is None and every touch below is one branch.
        tr = flight_recorder.new_trace(name, entry.tier, t0)
        try:
            if deadline_ms is None:
                deadline_ms = self.default_deadline_ms
            deadline = None if deadline_ms is None else \
                time.monotonic() + float(deadline_ms) / 1000.0
            with tracing.span("serve/request", cat="serve", model=name):
                # Circuit breaker: an open breaker
                # fast-fails BEFORE admission — no queue slot, no
                # forward rows, a distinct terminal status. Half-open
                # admits one probe; its forward outcome re-closes or
                # re-opens the breaker via the engine hooks.
                br = entry.breaker
                if br is not None and not br.allow():
                    status = "breaker_open"
                    raise BreakerOpenError(
                        f"model {name!r} circuit breaker is "
                        f"{br.state} — fast-failing without queuing")
                # Tier shed: under
                # saturation a lower-tier request must not take a queue
                # slot behind traffic that always outranks it — typed
                # 503, immediately, never a hang.
                sch = self.pool.scheduler
                if sch is not None:
                    sname = entry.engine.sched_name or name
                    shed_reason = sch.should_shed(sname)
                    if shed_reason is not None:
                        self._shed_c.labels(model=name,
                                            reason=shed_reason).inc()
                        status = "shed"
                        raise TierShedError(
                            f"model {name!r} (tier {entry.tier!r}) shed: "
                            "a higher tier's backlog saturates the "
                            "shared device budget")
                if deadline is not None:
                    # SLO-aware admission: estimated completion past the
                    # deadline means this request can only waste a queue
                    # slot — shed it NOW with a distinct status.
                    est = entry.engine.estimate_wait_s() * self.shed_headroom
                    if time.monotonic() + est > deadline:
                        self._shed_c.labels(model=name,
                                            reason="admission").inc()
                        status = "shed"
                        raise DeadlineExceededError(
                            f"estimated wait {est * 1000:.1f}ms cannot "
                            f"meet deadline {deadline_ms}ms — shed at "
                            "admission")
                self._admit_c.labels(model=name).inc()
                if tr is not None:
                    # admission = gateway entry → engine handoff
                    # (breaker / tier-shed / SLO-estimate checks)
                    tr.mark("admission")
                    # precision the forward will run at — makes the
                    # quant A/B attributable per-phase in exemplars
                    tr.ctx["precision"] = entry.precision
                    gname = entry.engine.sched_name
                    if gname and gname != name:
                        tr.ctx["fused_group"] = gname
                try:
                    out = entry.engine.output(
                        x, deadline=deadline, transform=entry.transform,
                        tag=name, trace=tr)
                except QueueFullError:
                    self._shed_c.labels(model=name,
                                        reason="queue_full").inc()
                    status = "shed"
                    raise
                except DeadlineExceededError:
                    # late shed: counted by the engine's on_shed hook
                    # (reason="expired") — only the status lands here.
                    status = "shed"
                    raise
            status = "ok"
            return out
        finally:
            t_end = time.perf_counter()
            dur_ms = (t_end - t0) * 1000.0
            self._req_c.labels(model=name, status=status).inc()
            self._lat_h.labels(model=name).observe(dur_ms)
            # Tier-labeled children only exist when a scheduler ranks
            # the pool (keeps the default single-model scrape bitwise).
            tiered = self.pool.scheduler is not None
            if tiered:
                self._lat_h.labels(tier=entry.tier).observe(dur_ms)
            # SLO burn counter (always on, recorder or not): a breach
            # between scrapes must leave a durable count behind.
            slo_ms = self._tier_slo(entry.tier)
            if slo_ms is not None and dur_ms > slo_ms:
                self._slo_breach_c.labels(model=name,
                                          tier=entry.tier).inc()
            if tr is not None:
                # close the timeline at the wall clock's own end: a
                # request that died in the admission checks (breaker
                # fast-fail / tier shed / hopeless deadline) is all
                # admission, any other ends in `respond`
                tr.mark("respond" if tr.marks else "admission", t_end)
                if "precision" not in tr.ctx:
                    # fast-fail paths skip the admitted-path stamp; the
                    # exemplar ring must label precision consistently
                    tr.ctx["precision"] = entry.precision
                if entry.breaker is not None:
                    tr.ctx["breaker"] = entry.breaker.state
                summary = flight_recorder.complete(
                    tr, status, dur_ms, slo_ms,
                    want_summary=_trace_sink is not None)
                if _trace_sink is not None and summary is not None:
                    _trace_sink.append(summary)

    # ------------------------------------------------------------- generate
    def generate(self, name: str, prompt, *,
                 max_new_tokens: int = 32,
                 deadline_ms: Optional[float] = None,
                 _trace_sink: Optional[list] = None):
        """In-process decode entry point (POST /generate is the thin
        wrapper): run `prompt` through `name`'s DecodeEngine — admitted
        between decode steps, riding the token-granularity continuous
        batch — and return the generated sequence (token-id list for
        the transformer arm, [steps, features] array for the stream
        arm).

        The admission sequence is predict()'s, verbatim: breaker
        fast-fail, tier shed, EWMA deadline estimate, then the engine.
        Raises the same typed taxonomy plus DecodeStepError (a
        mid-generation step failure — KV freed, batchmates unharmed)
        and KVCacheExhaustedError (KV backpressure, a QueueFullError
        subtype). The flight-recorder timeline routes device time
        through the `prefill`/`decode_step` phases, with
        `tokens_generated`/`kv_blocks` in the exemplar ctx."""
        entry = self.pool.get(name)
        t0 = time.perf_counter()
        status = "error"
        tr = flight_recorder.new_trace(name, entry.tier, t0)
        try:
            if deadline_ms is None:
                deadline_ms = self.default_deadline_ms
            deadline = None if deadline_ms is None else \
                time.monotonic() + float(deadline_ms) / 1000.0
            with tracing.span("serve/generate", cat="serve", model=name):
                br = entry.breaker
                if br is not None and not br.allow():
                    status = "breaker_open"
                    raise BreakerOpenError(
                        f"model {name!r} circuit breaker is "
                        f"{br.state} — fast-failing without queuing")
                sch = self.pool.scheduler
                if sch is not None:
                    sname = entry.engine.sched_name or name
                    shed_reason = sch.should_shed(sname)
                    if shed_reason is not None:
                        self._shed_c.labels(model=name,
                                            reason=shed_reason).inc()
                        status = "shed"
                        raise TierShedError(
                            f"model {name!r} (tier {entry.tier!r}) shed: "
                            "a higher tier's backlog saturates the "
                            "shared device budget")
                if deadline is not None:
                    est = entry.engine.estimate_wait_s() * self.shed_headroom
                    if time.monotonic() + est > deadline:
                        self._shed_c.labels(model=name,
                                            reason="admission").inc()
                        status = "shed"
                        raise DeadlineExceededError(
                            f"estimated wait {est * 1000:.1f}ms cannot "
                            f"meet deadline {deadline_ms}ms — shed at "
                            "admission")
                self._admit_c.labels(model=name).inc()
                if tr is not None:
                    tr.mark("admission")
                    tr.ctx["precision"] = entry.precision
                try:
                    out = entry.engine.generate(
                        prompt, max_new_tokens=max_new_tokens,
                        deadline=deadline, trace=tr)
                except QueueFullError:
                    # KVCacheExhaustedError lands here too (subclass) —
                    # both are backpressure, both 429 at the route.
                    self._shed_c.labels(model=name,
                                        reason="queue_full").inc()
                    status = "shed"
                    raise
                except DeadlineExceededError:
                    status = "shed"
                    raise
            status = "ok"
            return out
        finally:
            t_end = time.perf_counter()
            dur_ms = (t_end - t0) * 1000.0
            self._req_c.labels(model=name, status=status).inc()
            self._lat_h.labels(model=name).observe(dur_ms)
            tiered = self.pool.scheduler is not None
            if tiered:
                self._lat_h.labels(tier=entry.tier).observe(dur_ms)
            slo_ms = self._tier_slo(entry.tier)
            if slo_ms is not None and dur_ms > slo_ms:
                self._slo_breach_c.labels(model=name,
                                          tier=entry.tier).inc()
            if tr is not None:
                tr.mark("respond" if tr.marks else "admission", t_end)
                if "precision" not in tr.ctx:
                    tr.ctx["precision"] = entry.precision
                if entry.breaker is not None:
                    tr.ctx["breaker"] = entry.breaker.state
                summary = flight_recorder.complete(
                    tr, status, dur_ms, slo_ms,
                    want_summary=_trace_sink is not None)
                if _trace_sink is not None and summary is not None:
                    _trace_sink.append(summary)

    def _tier_slo(self, tier: Optional[str]) -> Optional[float]:
        """The latency SLO a request of `tier` is judged against: the
        scheduler's live per-tier config when the pool runs one, else
        the documented defaults (an untiered pool still burns against
        the standard-tier budget)."""
        sch = self.pool.scheduler
        if sch is not None:
            return sch.tier_slo_ms.get(tier)
        return DEFAULT_TIER_SLO_MS.get(tier)

    # ---------------------------------------------------------------- stats
    def _windowed_latencies(self):
        """([(model, sorted_vals)], [(tier, sorted_vals)]) from the
        serving_latency_ms histogram rings over the last
        `latency_window_s` seconds — the single percentile source
        /stats, the scrape gauges, and the SLO monitor share (the
        recent-latency deques this replaced had their own, subtly
        different, definition)."""
        now = time.monotonic()
        w = min(self.latency_window_s, max(0.0, now - self._born))
        items, titems = [], []
        for labels, child in self._lat_h.items():
            vals = child.window_values(w, now=now)
            if not vals:
                continue
            if "model" in labels:
                items.append((labels["model"], sorted(vals)))
            elif "tier" in labels:
                titems.append((labels["tier"], sorted(vals)))
        return sorted(items), sorted(titems)

    def stats(self) -> Dict[str, Any]:
        """Per-model {p50_ms, p99_ms, count} over the windowed latency
        ring plus the pool description."""
        out: Dict[str, Any] = {"models": self.pool.describe()}
        items, titems = self._windowed_latencies()
        out["latency"] = {
            name: {"p50_ms": round(_percentile(vals, 0.50), 3),
                   "p99_ms": round(_percentile(vals, 0.99), 3),
                   "count": len(vals)}
            for name, vals in items}
        if titems:
            out["tiers"] = {
                t: {"p50_ms": round(_percentile(v, 0.50), 3),
                    "p99_ms": round(_percentile(v, 0.99), 3),
                    "count": len(v)}
                for t, v in titems}
        return out

    def _collect_percentiles(self, reg) -> None:
        g50 = reg.gauge("serving_latency_p50_ms",
                        "p50 gateway latency over the recent window")
        g99 = reg.gauge("serving_latency_p99_ms",
                        "p99 gateway latency over the recent window")
        items, titems = self._windowed_latencies()
        for name, vals in items:
            g50.labels(model=name).set(_percentile(vals, 0.50))
            g99.labels(model=name).set(_percentile(vals, 0.99))
        if titems:
            tg = reg.gauge(
                "serving_tier_p99_ms",
                "p99 gateway latency per priority tier over the recent "
                "window (compare against serving_tier_slo_ms)")
            for t, vals in titems:
                tg.labels(tier=t).set(_percentile(vals, 0.99))

    # ------------------------------------------------------------ lifecycle
    def attach_tuner(self, tuner=None, *, start: bool = True, **kw):
        """Arm the serving control loop (serving/autotuner.py): attach
        an AutoTuner over this gateway's pool — built from `kw`
        (interval_s, ledger_path, knobs, monitor, ...) when none is
        passed — and start its tick thread by default. Until this is
        called the gateway runs the exact untuned path."""
        from .autotuner import AutoTuner
        if tuner is None:
            tuner = AutoTuner(self.pool, **kw)
        self.tuner = tuner
        if start:
            tuner.start()
        return tuner

    def stop(self):
        """Graceful: finish in-flight HTTP handlers (JsonHttpServer),
        stop the tuner thread if one is attached, then drain the
        engines (stragglers served, stranded callers failed with
        ServerClosedError — never hung)."""
        super().stop()
        if self.tuner is not None:
            self.tuner.stop()
        self.pool.shutdown()

    # --------------------------------------------------------------- routes
    def _health_route(self, _):
        # Degraded = any model's breaker is not closed: the gateway is
        # up, but some traffic is being fast-failed.
        breakers = {e.name: e.breaker.state
                    for e in self.pool.entries() if e.breaker is not None}
        degraded = sorted(n for n, s in breakers.items() if s != "closed")
        return 200, {"status": "degraded" if degraded else "ok",
                     "models": sorted(self.pool.names()),
                     "breakers": breakers, "degraded": degraded}

    def _models_route(self, _):
        return 200, {"models": self.pool.describe()}

    def _stats_route(self, _):
        return 200, self.stats()

    def _debug_requests_route(self, params):
        """GET /debug/requests?model=&tier= — the slow-request exemplar
        store: full phase timelines + context of the last N over-SLO /
        errored / shed requests (flight_recorder ring)."""
        if not flight_recorder.is_enabled():
            return 404, {"status": "error", "enabled": False,
                         "error": "flight recorder disabled — enable "
                                  "serving.flight_recorder or set "
                                  "DL4JTPU_FLIGHT_RECORDER=1"}
        params = params or {}
        reqs = flight_recorder.exemplars(model=params.get("model"),
                                         tier=params.get("tier"))
        return 200, {"status": "ok", "enabled": True,
                     "count": len(reqs), "requests": reqs}

    def _trace_route(self):
        """GET /trace — Chrome trace-event export of the span ring
        (serving spans carry cat="serve"); gated behind the recorder
        enable flag."""
        if not flight_recorder.is_enabled():
            body = json.dumps(
                {"status": "error", "enabled": False,
                 "error": "flight recorder disabled — enable "
                          "serving.flight_recorder or set "
                          "DL4JTPU_FLIGHT_RECORDER=1"}).encode()
            return 404, "application/json", body
        body = json.dumps(tracing.export_trace_events()).encode()
        return 200, "application/json", body

    def _predict_route(self, req: dict):
        name = req.get("model", "default")
        x = np.asarray(req["features"], np.float32)
        deadline_ms = req.get("deadline_ms")
        sink = [] if flight_recorder.is_enabled() else None
        try:
            out = self.predict(name, x, deadline_ms=deadline_ms,
                               _trace_sink=sink)
            # inside the try: a concurrent remove() between the forward
            # and this lookup must surface as the typed 404, not a 500
            version = self.pool.get(name).version.get("file", "initial")
        except KeyError as e:
            return 404, {"status": "error", "error": str(e)}
        except BreakerOpenError as e:
            return 503, {"status": "unavailable", "reason": "breaker_open",
                         "error": str(e)}
        except TierShedError as e:
            return 503, {"status": "shed", "reason": "tier_shed",
                         "error": str(e)}
        except QueueFullError as e:
            return 429, {"status": "shed", "reason": "queue_full",
                         "error": str(e)}
        except DeadlineExceededError as e:
            return 503, {"status": "shed", "reason": "deadline",
                         "error": str(e)}
        except NonFiniteOutputError as e:
            return 500, {"status": "error", "reason": "nonfinite",
                         "error": str(e)}
        except BatchExecutionError as e:
            return 500, {"status": "error", "reason": "batch_failed",
                         "error": str(e)}
        except ServerClosedError as e:
            return 503, {"status": "error", "error": str(e)}
        out = np.asarray(out)
        if not np.isfinite(out).all():
            return 500, {"status": "error", "reason": "nonfinite",
                         "error": "the forward returned non-finite "
                                  "(NaN/Inf) outputs"}
        resp = {"status": "ok", "model": name, "version": version,
                "predictions": out.tolist()}
        if sink:
            resp["trace"] = sink[0]
        return 200, resp

    def _generate_route(self, req: dict):
        """POST /generate {"model", "prompt", "max_new_tokens",
        "deadline_ms"} — the decode twin of /predict with the same
        typed status chain. A ValueError from prompt validation (wrong
        shape, out-of-vocab tokens, exceeds max_context) is the
        client's fault: typed 400."""
        name = req.get("model", "default")
        if "prompt" not in req:
            return 400, {"status": "error", "reason": "bad_prompt",
                         "error": "request body needs a 'prompt' field"}
        deadline_ms = req.get("deadline_ms")
        sink = [] if flight_recorder.is_enabled() else None
        try:
            out = self.generate(
                name, req["prompt"],
                max_new_tokens=int(req.get("max_new_tokens", 32)),
                deadline_ms=deadline_ms, _trace_sink=sink)
            # inside the try: a concurrent remove() between the decode
            # and this lookup must surface as the typed 404, not a 500
            version = self.pool.get(name).version.get("file", "initial")
        except KeyError as e:
            return 404, {"status": "error", "error": str(e)}
        except ValueError as e:
            return 400, {"status": "error", "reason": "bad_prompt",
                         "error": str(e)}
        except BreakerOpenError as e:
            return 503, {"status": "unavailable", "reason": "breaker_open",
                         "error": str(e)}
        except TierShedError as e:
            return 503, {"status": "shed", "reason": "tier_shed",
                         "error": str(e)}
        except QueueFullError as e:
            # KVCacheExhaustedError inherits this arm: KV backpressure
            # is a retryable 429, never a 500.
            return 429, {"status": "shed", "reason": "queue_full",
                         "error": str(e)}
        except DeadlineExceededError as e:
            return 503, {"status": "shed", "reason": "deadline",
                         "error": str(e)}
        except NonFiniteOutputError as e:
            return 500, {"status": "error", "reason": "nonfinite",
                         "error": str(e)}
        except BatchExecutionError as e:
            # DecodeStepError inherits this arm: a failed step is a
            # server-side 500 with the victim's KV already freed.
            return 500, {"status": "error", "reason": "batch_failed",
                         "error": str(e)}
        except ServerClosedError as e:
            return 503, {"status": "error", "error": str(e)}
        resp = {"status": "ok", "model": name, "version": version,
                "tokens": np.asarray(out).tolist()}
        if sink:
            resp["trace"] = sink[0]
        return 200, resp

    def _swap_route(self, req: dict):
        name = req.get("model", "default")
        kw = {}
        if req.get("quantize"):
            # {"quantize": "int8" | "bf16" | "fp32"} promotes the
            # checkpoint at that precision behind the canary gate
            kw["quantize"] = str(req["quantize"])
        try:
            return 200, self.swap(name, **kw)
        except KeyError as e:
            return 404, {"status": "error", "error": str(e)}
        except SwapError as e:
            return 409, {"status": "swap_failed", "error": str(e)}

    # Live-reconfigurable knobs POST /config accepts: per-entry
    # (routed at req["model"]) and scheduler-level (no model needed).
    _ENTRY_KNOBS = ("packed_admission", "pack_bucket", "tier", "weight",
                    "batch_timeout_ms", "breaker_threshold",
                    "breaker_reset_s")
    _SCHED_KNOBS = ("quantum", "shed_depth", "starvation_budget",
                    "tier_slo_ms")

    def _config_route(self, req: dict):
        """Live reconfiguration. Per-entry knobs (packed_admission /
        pack_bucket / tier / weight / batch_timeout_ms /
        breaker_threshold / breaker_reset_s) route at
        req["model"]; scheduler-level knobs (quantum / shed_depth /
        starvation_budget / tier_slo_ms) need no model and create the
        shared scheduler on first use. Typed 400 on unknown knobs or
        invalid values (reason: unknown_knob / invalid_value), 404 on
        unknown model, 409 on invalid per-entry combinations (unknown
        tier, fused-group member)."""
        unknown = sorted(set(req) - set(self._ENTRY_KNOBS)
                         - set(self._SCHED_KNOBS) - {"model"})
        if unknown:
            return 400, {"status": "error", "reason": "unknown_knob",
                         "error": "unknown config knob(s): "
                                  + ", ".join(unknown)}
        try:
            entry_kw: Dict[str, Any] = {}
            if "packed_admission" in req:
                entry_kw["packed_admission"] = bool(req["packed_admission"])
            if "pack_bucket" in req:
                entry_kw["pack_bucket"] = int(req["pack_bucket"])
            if "tier" in req:
                entry_kw["tier"] = req["tier"]
            if "weight" in req:
                entry_kw["weight"] = float(req["weight"])
            if "batch_timeout_ms" in req:
                entry_kw["batch_timeout_ms"] = float(req["batch_timeout_ms"])
            if "breaker_threshold" in req:
                entry_kw["breaker_threshold"] = int(req["breaker_threshold"])
            if "breaker_reset_s" in req:
                entry_kw["breaker_reset_s"] = float(req["breaker_reset_s"])
            sched_kw: Dict[str, Any] = {}
            if "quantum" in req:
                sched_kw["quantum"] = float(req["quantum"])
            if "shed_depth" in req:
                sched_kw["shed_depth"] = int(req["shed_depth"])
            if "starvation_budget" in req:
                sched_kw["starvation_budget"] = int(
                    req["starvation_budget"])
            if "tier_slo_ms" in req:
                slo = req["tier_slo_ms"]
                if not isinstance(slo, dict):
                    raise TypeError("tier_slo_ms must be a "
                                    "{tier: slo_ms} object")
                sched_kw["tier_slo_ms"] = {
                    str(t): float(v) for t, v in slo.items()}
        except (TypeError, ValueError) as e:
            return 400, {"status": "error", "reason": "invalid_value",
                         "error": str(e)}
        if not entry_kw and not sched_kw:
            return 400, {"status": "error",
                         "error": "no reconfigurable knob in request "
                                  "(packed_admission/pack_bucket/tier/"
                                  "weight/batch_timeout_ms/"
                                  "breaker_threshold/breaker_reset_s/"
                                  "quantum/shed_depth/starvation_budget/"
                                  "tier_slo_ms)"}
        out: Dict[str, Any] = {"status": "ok"}
        if sched_kw:
            try:
                out["scheduler"] = self.pool.reconfigure_scheduler(
                    **sched_kw)
            except ValueError as e:
                return 400, {"status": "error", "reason": "invalid_value",
                             "error": str(e)}
        if entry_kw:
            name = req.get("model", "default")
            try:
                out.update(self.pool.reconfigure(name, **entry_kw))
            except KeyError as e:
                return 404, {"status": "error", "error": str(e)}
            except ValueError as e:
                return 409, {"status": "error", "error": str(e)}
        return 200, out

    def _debug_tuner_route(self, _):
        """GET /debug/tuner — the AutoTuner decision trail: state,
        knob table with guardrails, known-good snapshot, and the last
        ledger rows. 404 until attach_tuner() arms the control loop
        (flight-recorder route pattern)."""
        if self.tuner is None:
            return 404, {"status": "error", "enabled": False,
                         "error": "no AutoTuner attached — "
                                  "gateway.attach_tuner() arms the "
                                  "serving control loop"}
        body = self.tuner.describe()
        body.update({"status": "ok", "enabled": True})
        return 200, body
