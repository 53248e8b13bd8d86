"""Self-tuning serving: the SLO watchtower + auditable AutoTuner.

Port of `deeplearning4j_tpu/serving/autotuner.py`, with one deliberate
difference: the default ledger is ``~/.deeplearning4j_torch/
autotune_ledger.jsonl`` (or ``$DL4JTORCH_AUTOTUNE_LEDGER``), never the
repository's ``autotune_ledger.jsonl``, which belongs to the JAX package.

The flight recorder attributes tail latency to phases and the reconfigure
seam changes every serving knob live. This module closes the loop:

* :class:`SLOMonitor` scrapes the metrics registry on a cadence and turns
  it into *windowed* per-tier verdicts: p99 over the last N seconds
  (Histogram.quantile ring, NOT lifetime buckets) vs the scheduler's
  ``serving_tier_slo_ms``, shed rate from counter deltas between ticks,
  and the dominant flight-recorder phase — the hint that picks WHICH
  knob to move. Injectable clock throughout, fake-clock testable like
  the breaker and the cluster watchdog.

* :class:`AutoTuner` hill-climbs ONE knob at a time through the
  existing actuators (``ModelPool.reconfigure`` /
  ``reconfigure_scheduler`` — the same seam ``POST /config`` drives)
  inside hard per-knob guardrails. Every decision is appended to
  the ledger with a strict schema
  (unknown fields and kinds REJECTED): the knob, old→new, the windowed
  evidence that motivated the move, the observed outcome after a settle
  window, and the revert when the move regressed. The tuner FREEZES —
  reverting every knob to the last known-good snapshot — on
  breaker-open, canary rejection, or a hard SLO breach
  (p99 ≥ ``breach_freeze_factor`` × SLO: a *mild* breach is the
  hill-climb signal, a hard one is an incident the tuner must not
  chase), and thaws only after ``freeze_cooldown_s`` of continuous
  health.

A gateway without a tuner attached runs today's serving path bitwise:
nothing here touches admission or dispatch — the monitor reads the
scrape surface, the tuner writes through the reconfigure seam.

Metric families (pre-registered by ``register_metrics()``):
``serving_tuner_moves_total{knob,outcome}``
(applied/kept/reverted/neutral/refused), ``serving_tuner_frozen``,
``serving_tuner_state`` (0=watching, 1=settling, 2=frozen),
``serving_tuner_reverts_total``,
``serving_tuner_freezes_total{reason}``,
``serving_tuner_errors_total``, and the monitor's per-tier
``serving_slo_verdict{tier}``.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..optimize.metrics import registry
from .scheduler import DEFAULT_TIER_SLO_MS

__all__ = [
    "SLOMonitor", "AutoTuner", "Knob", "TierVerdict", "MonitorReport",
    "default_knobs", "register_metrics", "validate_entry", "append_entry",
    "read_ledger", "default_ledger_path", "LEDGER_SCHEMA_VERSION",
    "MOVE_OUTCOMES", "FREEZE_REASONS",
]

# ---------------------------------------------------------------------------
# Ledger: append-only jsonl, strict schema
# ---------------------------------------------------------------------------
LEDGER_SCHEMA_VERSION = 1
LEDGER_ENV = "DL4JTORCH_AUTOTUNE_LEDGER"

# Terminal outcomes of an applied move after its settle window.
MOVE_OUTCOMES = ("kept", "reverted", "neutral")
# Typed freeze triggers — every freeze is one of these, counted in
# serving_tuner_freezes_total{reason}.
FREEZE_REASONS = ("breaker_open", "canary_rejected", "slo_breach", "manual")

_NUM = (int, float)
# Required fields per row, common first. Unknown kinds and unknown
# fields are REJECTED: the ledger is an audit
# artifact — a row that doesn't parse against the schema is a bug, not
# a forward-compat extension point.
_COMMON_FIELDS: Dict[str, Any] = {
    "schema": int, "ts": _NUM, "seq": int, "kind": str}
_KIND_FIELDS: Dict[str, Dict[str, Any]] = {
    "move": {"knob": str, "old": _NUM, "new": _NUM, "direction": int,
             "evidence": dict},
    "outcome": {"ref": int, "knob": str, "outcome": str, "old": _NUM,
                "new": _NUM, "before_score": _NUM, "after_score": _NUM,
                "reverted": bool, "evidence": dict},
    "refusal": {"knob": str, "candidate": _NUM, "lo": _NUM, "hi": _NUM,
                "reason": str},
    "freeze": {"reason": str, "evidence": dict, "restored": dict},
    "unfreeze": {"healthy_s": _NUM},
}


def default_ledger_path() -> str:
    """$DL4JTORCH_AUTOTUNE_LEDGER, else
    ~/.deeplearning4j_torch/autotune_ledger.jsonl (its directory made on
    first use). Never a file of the repository: the JAX package owns the
    repository's autotune_ledger.jsonl."""
    env = os.environ.get(LEDGER_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".deeplearning4j_torch",
                        "autotune_ledger.jsonl")


def validate_entry(entry: Any) -> List[str]:
    """Schema problems for one ledger row ([] = valid). Strict: unknown
    kind, unknown field, missing field, wrong type, out-of-vocabulary
    outcome/reason all reject."""
    if not isinstance(entry, dict):
        return ["entry is not a dict"]
    problems: List[str] = []
    kind = entry.get("kind")
    if kind not in _KIND_FIELDS:
        problems.append(f"unknown kind {kind!r}; one of "
                        f"{tuple(_KIND_FIELDS)}")
        return problems
    want = dict(_COMMON_FIELDS)
    want.update(_KIND_FIELDS[kind])
    for field, typ in want.items():
        if field not in entry:
            problems.append(f"missing field {field!r}")
        elif not isinstance(entry[field], typ):
            problems.append(
                f"field {field!r} has type {type(entry[field]).__name__}")
    for field in entry:
        if field not in want:
            problems.append(f"unknown field {field!r} for kind {kind!r}")
    if not problems:
        if entry["schema"] != LEDGER_SCHEMA_VERSION:
            problems.append(f"schema {entry['schema']!r} != "
                            f"{LEDGER_SCHEMA_VERSION}")
        if kind == "outcome" and entry["outcome"] not in MOVE_OUTCOMES:
            problems.append(f"outcome {entry['outcome']!r}; one of "
                            f"{MOVE_OUTCOMES}")
        if kind == "freeze" and entry["reason"] not in FREEZE_REASONS:
            problems.append(f"freeze reason {entry['reason']!r}; one of "
                            f"{FREEZE_REASONS}")
    return problems


def append_entry(entry: Dict[str, Any],
                 path: Optional[str] = None) -> Dict[str, Any]:
    """Validate + append one row (flush + fsync: a row either fully
    lands or tears, and read_ledger tolerates the tear). Raises
    ValueError on a schema-invalid row — the writer's bug, caught
    loudly, never a silently-corrupt audit trail."""
    problems = validate_entry(entry)
    if problems:
        raise ValueError("invalid autotune ledger row: "
                         + "; ".join(problems))
    path = path or default_ledger_path()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    line = json.dumps(entry, sort_keys=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(line + "\n")
        f.flush()
        os.fsync(f.fileno())
    return entry


def read_ledger(path: Optional[str] = None) -> List[Dict[str, Any]]:
    """All parseable rows, in file order. Torn/corrupt lines (a crash
    mid-append) are skipped, never fatal."""
    path = path or default_ledger_path()
    rows: List[Dict[str, Any]] = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except (ValueError, TypeError):
                    continue  # torn tail line
                if isinstance(row, dict):
                    rows.append(row)
    except OSError:
        return []
    return rows


# ---------------------------------------------------------------------------
# Monitor: windowed per-tier verdicts
# ---------------------------------------------------------------------------
class TierVerdict:
    """Windowed judgment of one priority tier against its SLO."""

    __slots__ = ("tier", "p99_ms", "slo_ms", "requests", "shed_rate",
                 "top_phase", "breach")

    def __init__(self, tier: str, p99_ms: float, slo_ms: float, *,
                 requests: int = 0, shed_rate: float = 0.0,
                 top_phase: Optional[str] = None,
                 breach: Optional[bool] = None):
        self.tier = tier
        self.p99_ms = float(p99_ms)
        self.slo_ms = float(slo_ms)
        self.requests = int(requests)
        self.shed_rate = float(shed_rate)
        self.top_phase = top_phase
        self.breach = (self.p99_ms > self.slo_ms) if breach is None \
            else bool(breach)

    @property
    def ratio(self) -> float:
        """p99 / SLO — >1.0 is a breach; the hill-climb's per-tier
        badness term."""
        return self.p99_ms / self.slo_ms if self.slo_ms > 0 else 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {"tier": self.tier, "p99_ms": round(self.p99_ms, 3),
                "slo_ms": round(self.slo_ms, 3),
                "requests": self.requests,
                "shed_rate": round(self.shed_rate, 4),
                "top_phase": self.top_phase, "breach": self.breach}


class MonitorReport:
    """One monitor tick: per-tier verdicts + pool-level health signals
    (open breakers, canary rejections since the previous tick)."""

    def __init__(self, ts: float, verdicts: Dict[str, TierVerdict], *,
                 breakers_open=(), canary_rejections: int = 0,
                 min_samples: int = 1):
        self.ts = float(ts)
        self.verdicts = dict(verdicts)
        self.breakers_open = list(breakers_open)
        self.canary_rejections = int(canary_rejections)
        self.min_samples = int(min_samples)

    def sampled(self) -> List[TierVerdict]:
        """Verdicts with enough windowed traffic to act on — a tier
        with 2 requests has no p99 worth chasing."""
        return [v for v in self.verdicts.values()
                if v.requests >= self.min_samples]

    @property
    def score(self) -> float:
        """Scalar badness the hill-climb minimizes: worst windowed
        p99/SLO ratio across sampled tiers, plus a 2× shed-rate
        penalty (shedding half the traffic to make the p99 is not a
        win)."""
        s = self.sampled()
        ratio = max((v.ratio for v in s), default=0.0)
        shed = max((v.shed_rate for v in s), default=0.0)
        return ratio + 2.0 * shed

    @property
    def worst(self) -> Optional[TierVerdict]:
        s = self.sampled()
        if not s:
            return None
        return max(s, key=lambda v: v.ratio + 2.0 * v.shed_rate)

    @property
    def healthy(self) -> bool:
        return (not self.breakers_open
                and self.canary_rejections == 0
                and not any(v.breach for v in self.sampled())
                and max((v.shed_rate for v in self.sampled()),
                        default=0.0) < 0.01)

    def evidence(self) -> Dict[str, Any]:
        """The windowed facts a ledger row records as the motivation
        for a decision."""
        return {"ts": round(self.ts, 3),
                "score": round(self.score, 4),
                "tiers": {t: v.as_dict() for t, v in self.verdicts.items()},
                "breakers_open": list(self.breakers_open),
                "canary_rejections": self.canary_rejections}


class SLOMonitor:
    """Scrapes the registry into windowed per-tier verdicts on demand.

    ``window_s`` bounds every quantile/rate to the recent past —
    verdicts answer "how is serving NOW", not "since process start".
    ``clock`` is injectable (breaker/cluster-watchdog pattern): tests
    drive tick() with a fake clock paired with explicit ``t=``-stamped
    histogram observations. Shed rates and canary-rejection counts are
    deltas between consecutive ticks (zero on the first tick — no
    baseline yet)."""

    def __init__(self, pool, *, window_s: float = 30.0,
                 min_samples: int = 5,
                 clock: Callable[[], float] = time.monotonic):
        self.pool = pool
        self.window_s = float(window_s)
        self.min_samples = int(min_samples)
        self._clock = clock
        # Window floor: the registry rings are process-global but this
        # monitor is not — observations stamped before it existed (an
        # earlier gateway in the same process) never count.
        self._born = float(clock())
        self._lock = threading.Lock()
        self._last: Optional[Dict[str, float]] = None
        self._verdict_g = registry().gauge(
            "serving_slo_verdict",
            "Windowed per-tier SLO verdict (1 = p99 over budget)")

    # ------------------------------------------------------------ helpers
    def _tier_slos(self) -> Dict[str, float]:
        sch = self.pool.scheduler
        if sch is not None:
            return dict(sch.tier_slo_ms)
        return dict(DEFAULT_TIER_SLO_MS)

    def _model_tiers(self) -> Dict[str, str]:
        return {e.name: e.tier for e in self.pool.entries()}

    # --------------------------------------------------------------- tick
    def tick(self) -> MonitorReport:
        now = self._clock()
        window = min(self.window_s, max(0.0, now - self._born))
        reg = registry()
        tiers_of = self._model_tiers()
        slos = self._tier_slos()

        # Windowed latency values per tier. When a scheduler labels the
        # pool, requests land in BOTH model- and tier-labeled children —
        # use only the tier cells then (folding both would double-count);
        # an untiered pool folds model cells through the tier map.
        lat = reg.histogram("serving_latency_ms")
        vals: Dict[str, List[float]] = {}
        cells = lat.items()
        tier_cells = [(labels["tier"], child) for labels, child in cells
                      if "tier" in labels]
        if tier_cells:
            for t, child in tier_cells:
                vals.setdefault(t, []).extend(
                    child.window_values(window, now=now))
        else:
            for labels, child in cells:
                t = tiers_of.get(labels.get("model"))
                if t is not None:
                    vals.setdefault(t, []).extend(
                        child.window_values(window, now=now))

        # Per-tier request/shed deltas since the previous tick.
        cur: Dict[str, float] = {}
        for labels, child in reg.counter("serving_requests_total").items():
            t = tiers_of.get(labels.get("model"))
            if t is not None:
                cur[f"req:{t}"] = cur.get(f"req:{t}", 0.0) + child.value()
        for labels, child in reg.counter("serving_shed_total").items():
            t = tiers_of.get(labels.get("model"))
            if t is not None:
                cur[f"shed:{t}"] = cur.get(f"shed:{t}", 0.0) + child.value()
        cur["canary"] = reg.counter("serving_swaps_total").total(
            outcome="canary_rejected")
        with self._lock:
            prev = self._last
            self._last = cur

        def _delta(key: str) -> float:
            if prev is None:
                return 0.0
            return max(0.0, cur.get(key, 0.0) - prev.get(key, 0.0))

        # Phase attribution: the dominant windowed flight-recorder phase
        # per tier (absent unless the recorder is enabled).
        phase_ms: Dict[str, Dict[str, float]] = {}
        for labels, child in reg.histogram("serving_phase_ms").items():
            t, p = labels.get("tier"), labels.get("phase")
            if t is None or p is None:
                continue
            tot = sum(child.window_values(window, now=now))
            if tot > 0:
                d = phase_ms.setdefault(t, {})
                d[p] = d.get(p, 0.0) + tot

        verdicts: Dict[str, TierVerdict] = {}
        for tier in sorted(set(tiers_of.values()) | set(vals)):
            tvals = sorted(vals.get(tier, ()))
            n = len(tvals)
            p99 = 0.0
            if n:
                p99 = tvals[min(n - 1, int(round(0.99 * (n - 1))))]
            req_d = _delta(f"req:{tier}")
            shed_d = _delta(f"shed:{tier}")
            shed_rate = shed_d / req_d if req_d > 0 else 0.0
            phases = phase_ms.get(tier)
            top = max(phases, key=phases.get) if phases else None
            slo = float(slos.get(tier, DEFAULT_TIER_SLO_MS["standard"]))
            v = TierVerdict(tier, p99, slo, requests=n,
                            shed_rate=min(1.0, shed_rate), top_phase=top)
            verdicts[tier] = v
            if n >= self.min_samples:
                self._verdict_g.labels(tier=tier).set(
                    1.0 if v.breach else 0.0)

        breakers_open = [e.name for e in self.pool.entries()
                         if e.breaker is not None
                         and e.breaker.state != "closed"]
        return MonitorReport(now, verdicts, breakers_open=breakers_open,
                             canary_rejections=int(_delta("canary")),
                             min_samples=self.min_samples)


# ---------------------------------------------------------------------------
# Knobs
# ---------------------------------------------------------------------------
class Knob:
    """One tunable serving parameter: read/apply closures over the
    reconfigure seam, HARD guardrails [lo, hi], and the hill-climb step
    rule (``mode="add"``: cur ± step; ``mode="mul"``: cur ×/÷ step).
    ``direction`` is the current climb direction (+1 up / -1 down) —
    flipped by the tuner on reverts and guardrail refusals. ``tier``
    tags which tier the knob most affects (phase-hint routing)."""

    def __init__(self, name: str, get: Callable[[], float],
                 set: Callable[[float], Any], *, lo: float, hi: float,
                 step: float, mode: str = "mul", integer: bool = False,
                 direction: int = -1, tier: Optional[str] = None):
        if mode not in ("mul", "add"):
            raise ValueError(f"knob mode {mode!r}; one of ('mul', 'add')")
        if mode == "mul" and step <= 1.0:
            raise ValueError("multiplicative step must be > 1.0")
        if mode == "add" and step <= 0.0:
            raise ValueError("additive step must be > 0.0")
        if float(lo) > float(hi):
            raise ValueError(f"knob {name!r}: lo > hi")
        self.name = name
        self._get = get
        self._set = set
        self.lo = float(lo)
        self.hi = float(hi)
        self.step = float(step)
        self.mode = mode
        self.integer = bool(integer)
        self.direction = 1 if int(direction) >= 0 else -1
        self.tier = tier

    def get(self) -> float:
        return float(self._get())

    def apply(self, value: float) -> None:
        self._set(int(value) if self.integer else float(value))

    def propose(self) -> Tuple[Optional[float], float, float]:
        """(new, raw, cur): the next step in the current direction.
        `raw` is the unclamped candidate, `new` is raw clamped to the
        guardrails and rounded for integer knobs — None when the clamp
        lands back on the current value (pinned at a rail: a refusal,
        never a silent out-of-range move)."""
        cur = self.get()
        if self.mode == "mul":
            raw = cur * self.step if self.direction > 0 else cur / self.step
        else:
            raw = cur + self.step * self.direction
        new = min(self.hi, max(self.lo, raw))
        if self.integer:
            new = float(int(round(new)))
        if abs(new - cur) < 1e-12:
            return None, raw, cur
        return new, raw, cur


def default_knobs(pool) -> List[Knob]:
    """The standing knob table: per-entry collector linger + WFQ weight + circuit
    breaker threshold/cooldown, scheduler quantum + shed depth — each
    actuated through the same reconfigure seam POST /config drives,
    inside hard guardrails. The breaker rails are deliberately tight:
    a threshold below 2 turns any single transient blip into an
    outage, above 32 the breaker stops protecting anything; a cooldown
    under 1 s thrashes probes, over 120 s parks a recovered model in
    fast-fail. Fused-group members are skipped (reconfigure refuses
    them); weight/scheduler knobs exist only when the pool runs a
    DeviceScheduler; breaker knobs only for entries that carry one."""
    knobs: List[Knob] = []
    sch = pool.scheduler
    for e in pool.entries():
        if e.group is not None:
            continue
        nm = e.name
        knobs.append(Knob(
            f"linger_ms:{nm}",
            get=lambda _e=e: _e.engine.batch_timeout_ms,
            set=lambda v, _p=pool, _n=nm: _p.reconfigure(
                _n, batch_timeout_ms=v),
            lo=0.0, hi=20.0, step=2.0, mode="add", direction=-1,
            tier=e.tier))
        if getattr(e, "breaker", None) is not None:
            knobs.append(Knob(
                f"breaker_threshold:{nm}",
                get=lambda _e=e: _e.breaker.failure_threshold,
                set=lambda v, _p=pool, _n=nm: _p.reconfigure(
                    _n, breaker_threshold=v),
                lo=2, hi=32, step=2.0, mode="mul", integer=True,
                direction=1, tier=e.tier))
            knobs.append(Knob(
                f"breaker_reset_s:{nm}",
                get=lambda _e=e: _e.breaker.reset_timeout_s,
                set=lambda v, _p=pool, _n=nm: _p.reconfigure(
                    _n, breaker_reset_s=v),
                lo=1.0, hi=120.0, step=2.0, mode="mul",
                direction=-1, tier=e.tier))
        if sch is not None:
            knobs.append(Knob(
                f"weight:{nm}",
                get=lambda _e=e: _e.weight,
                set=lambda v, _p=pool, _n=nm: _p.reconfigure(_n, weight=v),
                lo=0.25, hi=16.0, step=2.0, mode="mul", direction=1,
                tier=e.tier))
    if sch is not None:
        knobs.append(Knob(
            "quantum",
            get=lambda _s=sch: _s.quantum,
            set=lambda v, _p=pool: _p.reconfigure_scheduler(quantum=v),
            lo=0.25, hi=8.0, step=1.5, mode="mul", direction=-1))
        knobs.append(Knob(
            "shed_depth",
            get=lambda _s=sch: _s.shed_depth,
            set=lambda v, _p=pool: _p.reconfigure_scheduler(shed_depth=v),
            lo=2, hi=64, step=2.0, mode="mul", integer=True, direction=-1))
    return knobs


# ---------------------------------------------------------------------------
# Tuner
# ---------------------------------------------------------------------------
WATCHING, SETTLING, FROZEN = "watching", "settling", "frozen"
_STATE_VALUES = {WATCHING: 0, SETTLING: 1, FROZEN: 2}


def register_metrics() -> None:
    """Pre-register the tuner families at 0 so a snapshot distinguishes
    'tuner never moved' from 'tuner never ran'."""
    reg = registry()
    reg.counter("serving_tuner_moves_total",
                "AutoTuner knob decisions by outcome "
                "(applied/kept/reverted/neutral/refused)")
    reg.counter("serving_tuner_reverts_total",
                "Moves reverted after the settle window regressed the "
                "windowed score")
    reg.counter("serving_tuner_freezes_total",
                "Tuner freezes by typed trigger (breaker_open/"
                "canary_rejected/slo_breach/manual)")
    reg.counter("serving_tuner_errors_total",
                "Control-loop ticks that raised (swallowed: the tuner "
                "must never take down serving)")
    g = reg.gauge("serving_tuner_frozen",
                  "1 while the AutoTuner is frozen at the last "
                  "known-good config")
    if not g._touched():
        g.set(0.0)
    sg = reg.gauge("serving_tuner_state",
                   "AutoTuner state (0=watching, 1=settling, 2=frozen)")
    if not sg._touched():
        sg.set(0.0)
    reg.gauge("serving_slo_verdict",
              "Windowed per-tier SLO verdict (1 = p99 over budget)")


class AutoTuner:
    """Hill-climbs one serving knob at a time against the monitor's
    windowed score, with every decision ledgered and revertible.

    State machine per tick():

    * any state → **frozen** on a typed trigger (breaker open, canary
      rejection since last tick, hard SLO breach): every knob reverts
      to the last known-good snapshot, the freeze is ledgered and
      counted. Frozen thaws only after ``freeze_cooldown_s`` of
      continuously healthy ticks.
    * **settling** (a move in flight): after ``settle_ticks`` ticks the
      move's outcome is judged against the score it was applied at —
      improved ≥ ``tolerance`` → *kept* (snapshot becomes known-good);
      regressed ≥ ``tolerance`` → *reverted* (the EXACT old value is
      restored — bitwise — and the knob's climb direction flips);
      else *neutral*.
    * **watching** + unhealthy verdicts → apply ONE move: the knob is
      picked by the worst tier's dominant phase (queue_wait → its
      linger, sched_wait → quantum/its weight), else round-robin; a
      step that would leave the guardrails is ledgered as a *refusal*
      (and the direction flips), never applied.

    The clock is injectable; tick() can be driven manually (fake-clock
    tests) or by start()'s daemon thread every ``interval_s``."""

    def __init__(self, pool, monitor: Optional[SLOMonitor] = None, *,
                 knobs: Optional[List[Knob]] = None,
                 ledger_path: Optional[str] = None,
                 interval_s: float = 5.0, settle_ticks: int = 2,
                 tolerance: float = 0.05,
                 breach_freeze_factor: float = 3.0,
                 freeze_cooldown_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.pool = pool
        self._clock = clock
        self.monitor = monitor if monitor is not None \
            else SLOMonitor(pool, clock=clock)
        self.knobs = list(knobs) if knobs is not None \
            else default_knobs(pool)
        if not self.knobs:
            raise ValueError("AutoTuner needs at least one knob")
        self.ledger_path = ledger_path or default_ledger_path()
        self.interval_s = float(interval_s)
        self.settle_ticks = int(settle_ticks)
        self.tolerance = float(tolerance)
        self.breach_freeze_factor = float(breach_freeze_factor)
        self.freeze_cooldown_s = float(freeze_cooldown_s)
        self._lock = threading.RLock()
        self._state = WATCHING
        self._frozen_reason: Optional[str] = None
        self._healthy_since: Optional[float] = None
        self._seq = 0
        self._pending: Optional[Dict[str, Any]] = None
        self._known_good = self._snapshot()
        self._trail: "collections.deque" = collections.deque(maxlen=256)
        self._rotation = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        register_metrics()
        reg = registry()
        self._moves_c = reg.counter("serving_tuner_moves_total")
        self._reverts_c = reg.counter("serving_tuner_reverts_total")
        self._freezes_c = reg.counter("serving_tuner_freezes_total")
        self._errors_c = reg.counter("serving_tuner_errors_total")
        self._frozen_g = reg.gauge("serving_tuner_frozen")
        self._state_g = reg.gauge("serving_tuner_state")
        self._frozen_g.set(0.0)
        self._state_g.set(0.0)

    # ----------------------------------------------------------- internals
    def _snapshot(self) -> Dict[str, float]:
        return {k.name: k.get() for k in self.knobs}

    def _emit(self, kind: str, **fields) -> Dict[str, Any]:
        """Build, trail, and append one ledger row. ValueError (a
        schema bug) propagates loudly; OSError (unwritable ledger) must
        never take down the control loop — the in-memory trail still
        records the decision."""
        with self._lock:
            self._seq += 1
            entry: Dict[str, Any] = {
                "schema": LEDGER_SCHEMA_VERSION,
                "ts": round(float(self._clock()), 3),
                "seq": self._seq, "kind": kind}
            entry.update(fields)
            self._trail.append(entry)
        try:
            append_entry(entry, self.ledger_path)
        except OSError:
            pass
        return entry

    def _set_state(self, state: str) -> None:
        self._state = state
        self._state_g.set(float(_STATE_VALUES[state]))
        self._frozen_g.set(1.0 if state == FROZEN else 0.0)

    # ---------------------------------------------------------------- tick
    def tick(self) -> MonitorReport:
        """One control-loop step: scrape → verdicts → (freeze |
        settle-evaluate | move). Safe to call manually alongside a
        running thread (the state machine is lock-guarded)."""
        report = self.monitor.tick()
        with self._lock:
            self._tick_locked(report)
        return report

    def _tick_locked(self, report: MonitorReport) -> None:
        reason = self._freeze_reason(report)
        if self._state == FROZEN:
            if reason is not None:
                self._healthy_since = None
                return
            if self._healthy_since is None:
                self._healthy_since = report.ts
            elif report.ts - self._healthy_since >= self.freeze_cooldown_s:
                self._unfreeze_locked(report.ts - self._healthy_since)
            return
        if reason is not None:
            self._freeze_locked(reason, report)
            return
        if self._pending is not None:
            self._pending["ticks_left"] -= 1
            if self._pending["ticks_left"] > 0:
                return
            self._resolve_pending_locked(report)
            return
        if report.healthy:
            # A healthy steady state IS the known-good config.
            self._known_good = self._snapshot()
            return
        self._try_move_locked(report)

    def _freeze_reason(self, report: MonitorReport) -> Optional[str]:
        if report.breakers_open:
            return "breaker_open"
        if report.canary_rejections > 0:
            return "canary_rejected"
        for v in report.sampled():
            # A mild breach is the tuning signal; a HARD breach
            # (factor× over budget) is an incident — stop tuning.
            if v.slo_ms > 0 and \
                    v.p99_ms >= self.breach_freeze_factor * v.slo_ms:
                return "slo_breach"
        return None

    def _freeze_locked(self, reason: str, report: MonitorReport) -> None:
        restored: Dict[str, float] = {}
        for k in self.knobs:
            good = self._known_good.get(k.name)
            if good is None:
                continue
            try:
                if k.get() != good:
                    k.apply(good)
                    restored[k.name] = good
            except Exception:
                self._errors_c.inc()  # actuator down mid-incident
        self._pending = None
        self._frozen_reason = reason
        self._healthy_since = None
        self._set_state(FROZEN)
        self._freezes_c.labels(reason=reason).inc()
        self._emit("freeze", reason=reason, evidence=report.evidence(),
                   restored=restored)

    def _unfreeze_locked(self, healthy_s: float) -> None:
        self._frozen_reason = None
        self._healthy_since = None
        self._set_state(WATCHING)
        self._emit("unfreeze", healthy_s=round(float(healthy_s), 3))

    def unfreeze(self) -> None:
        """Operator override: thaw now instead of waiting out the
        cooldown (the freeze itself stays ledgered)."""
        with self._lock:
            if self._state == FROZEN:
                self._unfreeze_locked(0.0)

    def _resolve_pending_locked(self, report: MonitorReport) -> None:
        p = self._pending
        self._pending = None
        knob: Knob = p["knob"]
        before, after = p["before_score"], report.score
        reverted = False
        if after <= before * (1.0 - self.tolerance):
            outcome = "kept"
            self._known_good = self._snapshot()
        elif after >= before * (1.0 + self.tolerance):
            outcome = "reverted"
            reverted = True
            try:
                knob.apply(p["old"])  # exact prior value — bitwise
            except Exception:
                self._errors_c.inc()
            knob.direction = -knob.direction
            self._reverts_c.inc()
        else:
            outcome = "neutral"
        self._set_state(WATCHING)
        self._moves_c.labels(knob=knob.name, outcome=outcome).inc()
        self._emit("outcome", ref=p["seq"], knob=knob.name,
                   outcome=outcome, old=p["old"], new=p["new"],
                   before_score=round(before, 4),
                   after_score=round(after, 4), reverted=reverted,
                   evidence=report.evidence())

    def _pick_knob_locked(self, report: MonitorReport) -> Optional[Knob]:
        # _locked suffix: only ever called from _try_move_locked, with
        # the tuner lock held — _rotation is guarded by the caller.
        worst = report.worst
        if worst is not None and worst.top_phase:
            prefs: List[Knob] = []
            if worst.top_phase == "queue_wait":
                prefs = [k for k in self.knobs
                         if k.name.startswith("linger_ms:")]
            elif worst.top_phase == "sched_wait":
                prefs = [k for k in self.knobs if k.name == "quantum"
                         or k.name.startswith("weight:")]
            prefs = [k for k in prefs if k.tier in (None, worst.tier)]
            if prefs:
                k = prefs[self._rotation % len(prefs)]
                self._rotation += 1
                return k
        if not self.knobs:
            return None
        k = self.knobs[self._rotation % len(self.knobs)]
        self._rotation += 1
        return k

    def _try_move_locked(self, report: MonitorReport) -> None:
        knob = self._pick_knob_locked(report)
        if knob is None:
            return
        new, raw, cur = knob.propose()
        if new is None:
            self._moves_c.labels(knob=knob.name, outcome="refused").inc()
            self._emit("refusal", knob=knob.name, candidate=float(raw),
                       lo=knob.lo, hi=knob.hi, reason="guardrail")
            knob.direction = -knob.direction
            return
        try:
            knob.apply(new)
        except Exception as e:
            self._moves_c.labels(knob=knob.name, outcome="refused").inc()
            self._emit("refusal", knob=knob.name, candidate=float(new),
                       lo=knob.lo, hi=knob.hi,
                       reason=f"actuator rejected: {e}")
            return
        self._moves_c.labels(knob=knob.name, outcome="applied").inc()
        entry = self._emit("move", knob=knob.name, old=cur,
                           new=float(new), direction=knob.direction,
                           evidence=report.evidence())
        self._pending = {"seq": entry["seq"], "knob": knob, "old": cur,
                         "new": float(new),
                         "before_score": report.score,
                         "ticks_left": self.settle_ticks}
        self._set_state(SETTLING)

    # ----------------------------------------------------------- lifecycle
    def start(self, interval_s: Optional[float] = None) -> "AutoTuner":
        """Run tick() every interval_s on a daemon thread (set the
        interval BEFORE start — it is read by the running loop)."""
        if interval_s is not None:
            self.interval_s = float(interval_s)
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="serving-autotuner", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # The control loop must never take down serving.
                self._errors_c.inc()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    # ----------------------------------------------------------- introspect
    def trail(self, n: int = 50) -> List[Dict[str, Any]]:
        """The last n decision rows (in-memory mirror of the ledger)."""
        with self._lock:
            return [dict(e) for e in list(self._trail)[-int(n):]]

    def describe(self) -> Dict[str, Any]:
        """GET /debug/tuner body: state, knob table with guardrails,
        known-good snapshot, pending move, recent decision trail."""
        with self._lock:
            pending = None
            if self._pending is not None:
                pending = {"knob": self._pending["knob"].name,
                           "old": self._pending["old"],
                           "new": self._pending["new"],
                           "ticks_left": self._pending["ticks_left"]}
            return {
                "state": self._state,
                "frozen_reason": self._frozen_reason,
                "interval_s": self.interval_s,
                "settle_ticks": self.settle_ticks,
                "tolerance": self.tolerance,
                "breach_freeze_factor": self.breach_freeze_factor,
                "freeze_cooldown_s": self.freeze_cooldown_s,
                "window_s": getattr(self.monitor, "window_s", None),
                "ledger_path": self.ledger_path,
                "knobs": [{"name": k.name, "value": k.get(),
                           "lo": k.lo, "hi": k.hi, "step": k.step,
                           "mode": k.mode, "direction": k.direction,
                           "tier": k.tier} for k in self.knobs],
                "known_good": dict(self._known_good),
                "pending": pending,
                "trail": [dict(e) for e in list(self._trail)[-50:]],
            }
