"""Priority-tier weighted fair queuing across served models sharing one
device.

Port of `deeplearning4j_tpu/serving/scheduler.py`: the same arbitration
rule, accounting and metric families, so a scripted sequence of slot
requests gets the same grants in both packages.

The gateway's engines each own a collector thread, and every coalesced
forward previously raced for the device unarbitrated: one chatty batch
model could head-of-line-block a latency-critical one. The
:class:`DeviceScheduler` is the arbiter those collectors now pass
through: before a forward dispatches it must hold THE dispatch slot
(one per scheduler — the shared device budget), and when several
collectors are waiting the slot goes to

1. the highest **priority tier** present (``critical`` > ``standard`` >
   ``batch``), then
2. within a tier, the largest **deficit** (weighted deficit round-robin:
   every time an entry is passed over while waiting, its deficit grows
   by ``weight x quantum``; a dispatch pays ``cost x quantum / weight``
   back — service is charged inversely to weight, so two contending
   entries split the device exactly ``weight_a : weight_b``), then
3. FIFO arrival order.

So under saturation high tiers keep bounded latency, equal-tier entries
share the device in proportion to their WFQ weights, and low tiers
degrade gracefully — they are *passed over*, never starved silently:
an entry passed over more than ``starvation_budget`` consecutive times
while it had queued work increments
``serving_starvation_total{model}`` (the pager signal). Entries that
are not waiting accrue nothing — the counter can never grow without
queued work.

Admission-side degradation: :meth:`should_shed` tells the gateway to
shed a LOW-tier request with a typed 503 (``tier_shed``) when some
strictly-higher tier already has ``shed_depth`` requests queued — the
low-tier client gets an immediate typed answer instead of a queue slot
behind traffic that will always outrank it.

Chaos seam: every slot acquisition fires the ``serve.schedule`` fault
point (utils/faults.py), so an armed plan fails scheduling decisions
deterministically — the forward that owned the slot surfaces a typed
``BatchExecutionError`` to its callers, never a hang.

Metrics: ``serving_starvation_total{model}``,
``serving_sched_dispatch_total{model,tier}``,
``serving_tier_slo_ms{tier}`` (the configured per-tier latency SLOs the
gateway's ``serving_tier_p99_ms{tier}`` gauges are judged against).

A pool without tiers never constructs a scheduler: ``ModelPool.add``
defaults leave ``engine.scheduler`` unset and every dispatch runs
exactly the pre-scheduler path.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional

from ..optimize.metrics import registry
from ..utils import faults

__all__ = ["DeviceScheduler", "TierShedError", "TIERS", "TIER_VALUES",
           "DEFAULT_TIER_SLO_MS", "register_metrics"]

# Priority tiers, highest first. TIER_VALUES orders them (lower = more
# important) and doubles as the stable metric encoding.
TIERS = ("critical", "standard", "batch")
TIER_VALUES = {"critical": 0, "standard": 1, "batch": 2}

# Default per-tier p99 SLOs in ms — exported as
# serving_tier_slo_ms{tier} so dashboards compare the observed
# serving_tier_p99_ms{tier} against the budget without config access.
DEFAULT_TIER_SLO_MS = {"critical": 50.0, "standard": 250.0,
                       "batch": 2000.0}

# Deficits are bounded so an entry idle-waiting behind a pathological
# storm cannot bank unbounded credit and then monopolize the device.
_DEFICIT_CAP = 1e6


class TierShedError(RuntimeError):
    """Typed tier shed: a lower-tier request was rejected at admission
    because a higher tier's backlog already saturates the shared device
    budget. Maps to HTTP 503 ``tier_shed`` — the graceful-degradation
    contract (shed fast, never head-of-line-block)."""


def register_metrics() -> None:
    """Pre-register the scheduler families and the per-tier SLO gauges
    at their defaults."""
    reg = registry()
    reg.counter("serving_starvation_total",
                "Times an entry with queued work was passed over beyond "
                "its starvation budget")
    reg.counter("serving_sched_dispatch_total",
                "Forwards dispatched through the device scheduler")
    g = reg.gauge("serving_tier_slo_ms",
                  "Configured p99 latency SLO per priority tier")
    for tier, slo in DEFAULT_TIER_SLO_MS.items():
        g.labels(tier=tier).set(slo)


class _SchedEntry:
    __slots__ = ("name", "tier", "tier_value", "weight", "deficit",
                 "passed_over", "depth_fn", "dispatches", "starvations",
                 "last_passovers")

    def __init__(self, name: str, tier: str, weight: float,
                 depth_fn: Optional[Callable[[], int]]):
        self.name = name
        self.tier = tier
        self.tier_value = TIER_VALUES[tier]
        self.weight = float(weight)
        self.deficit = 0.0
        self.passed_over = 0     # consecutive pass-overs while waiting
        self.depth_fn = depth_fn  # queued-request gauge for should_shed
        self.dispatches = 0
        self.starvations = 0
        # pass-over run length of the most recent GRANT (snapshotted
        # before the grant resets passed_over): the flight recorder's
        # "how many times was this batch's slot passed over" context
        self.last_passovers = 0


class _Waiter:
    __slots__ = ("name", "seq", "granted")

    def __init__(self, name: str, seq: int):
        self.name = name
        self.seq = seq
        self.granted = False


class DeviceScheduler:
    """Weighted deficit-round-robin arbiter for one shared device.

    ``quantum`` is the deficit an entry of weight 1.0 accrues per
    pass-over; a dispatch is charged ``cost x quantum / weight``, so
    two entries contending within a tier split dispatches in exactly
    their weight ratio.
    ``starvation_budget`` is how many consecutive pass-overs a waiting
    entry absorbs before ``serving_starvation_total{model}`` fires.
    ``shed_depth`` is the higher-tier queue depth past which lower-tier
    admissions shed (:meth:`should_shed`). ``tier_slo_ms`` overrides
    the exported per-tier SLO gauges."""

    def __init__(self, *, quantum: float = 1.0, starvation_budget: int = 3,
                 shed_depth: int = 8,
                 tier_slo_ms: Optional[Dict[str, float]] = None):
        self.quantum = float(quantum)
        self.starvation_budget = int(starvation_budget)
        self.shed_depth = int(shed_depth)
        self.tier_slo_ms = dict(DEFAULT_TIER_SLO_MS)
        if tier_slo_ms:
            self.tier_slo_ms.update(
                {t: float(v) for t, v in tier_slo_ms.items()})
        self._cv = threading.Condition()
        self._entries: Dict[str, _SchedEntry] = {}
        self._waiters: List[_Waiter] = []
        self._busy = False
        self._seq = 0
        reg = registry()
        self._starv_c = reg.counter(
            "serving_starvation_total",
            "Times an entry with queued work was passed over beyond "
            "its starvation budget")
        self._disp_c = reg.counter(
            "serving_sched_dispatch_total",
            "Forwards dispatched through the device scheduler")
        slo_g = reg.gauge("serving_tier_slo_ms",
                          "Configured p99 latency SLO per priority tier")
        for tier, slo in self.tier_slo_ms.items():
            slo_g.labels(tier=tier).set(slo)

    # ---------------------------------------------------------- registry
    def register(self, name: str, *, tier: str = "standard",
                 weight: float = 1.0,
                 depth_fn: Optional[Callable[[], int]] = None) -> None:
        """Register (or re-register: the reconfigure path) one served
        entry. ``depth_fn`` samples that entry's queued-request count
        for the tier-shed rule — never called on the dispatch path."""
        if tier not in TIER_VALUES:
            raise ValueError(f"unknown tier {tier!r}; one of {TIERS}")
        if weight <= 0:
            raise ValueError("weight must be > 0")
        with self._cv:
            old = self._entries.get(name)
            e = _SchedEntry(name, tier, weight, depth_fn)
            if old is not None:  # keep accounting across reconfigure
                e.deficit = old.deficit
                e.dispatches = old.dispatches
                e.starvations = old.starvations
            self._entries[name] = e

    def unregister(self, name: str) -> None:
        with self._cv:
            self._entries.pop(name, None)

    # ------------------------------------------------------- reconfigure
    def reconfigure(self, *, quantum: Optional[float] = None,
                    shed_depth: Optional[int] = None,
                    starvation_budget: Optional[int] = None,
                    tier_slo_ms: Optional[Dict[str, float]] = None
                    ) -> Dict[str, object]:
        """Live scheduler-level reconfiguration (the gateway's
        POST /config scheduler knobs and the AutoTuner's actuator).
        Validates BEFORE mutating — an invalid call changes nothing —
        and re-exports the serving_tier_slo_ms gauges on SLO changes.
        Raises ValueError on invalid values (unknown tier, non-positive
        quantum/budget/depth)."""
        if quantum is not None and float(quantum) <= 0:
            raise ValueError("quantum must be > 0")
        if shed_depth is not None and int(shed_depth) < 1:
            raise ValueError("shed_depth must be >= 1")
        if starvation_budget is not None and int(starvation_budget) < 1:
            raise ValueError("starvation_budget must be >= 1")
        slo_update: Dict[str, float] = {}
        if tier_slo_ms:
            for t, v in dict(tier_slo_ms).items():
                if t not in TIER_VALUES:
                    raise ValueError(
                        f"unknown tier {t!r} in tier_slo_ms; one of {TIERS}")
                if float(v) <= 0:
                    raise ValueError(f"tier_slo_ms[{t!r}] must be > 0")
                slo_update[t] = float(v)
        with self._cv:
            if quantum is not None:
                self.quantum = float(quantum)
            if shed_depth is not None:
                self.shed_depth = int(shed_depth)
            if starvation_budget is not None:
                self.starvation_budget = int(starvation_budget)
            if slo_update:
                self.tier_slo_ms.update(slo_update)
        if slo_update:
            slo_g = registry().gauge(
                "serving_tier_slo_ms",
                "Configured p99 latency SLO per priority tier")
            for t, v in slo_update.items():
                slo_g.labels(tier=t).set(v)
        return self.config()

    def config(self) -> Dict[str, object]:
        """The scheduler-level knob values (the reconfigure surface's
        current state; per-entry state lives in describe())."""
        with self._cv:
            return {"quantum": self.quantum,
                    "shed_depth": self.shed_depth,
                    "starvation_budget": self.starvation_budget,
                    "tier_slo_ms": dict(self.tier_slo_ms)}

    def names(self) -> List[str]:
        with self._cv:
            return list(self._entries)

    # ---------------------------------------------------------- dispatch
    @contextlib.contextmanager
    def slot(self, name: str, cost: float = 1.0):
        """Hold the device dispatch slot for one coalesced forward.
        Blocks until this entry wins arbitration; releasing re-arbitrates
        among the remaining waiters. Unregistered names are admitted
        FIFO at standard tier (they still serialize on the device)."""
        faults.fire("serve.schedule")
        with self._cv:
            self._seq += 1
            w = _Waiter(name, self._seq)
            self._waiters.append(w)
            self._maybe_grant_locked()
            while not w.granted:
                self._cv.wait(timeout=0.1)
        try:
            yield self
        finally:
            with self._cv:
                self._busy = False
                e = self._entries.get(name)
                if e is not None:
                    e.deficit = max(
                        -_DEFICIT_CAP,
                        e.deficit - float(cost) * self.quantum / e.weight)
                self._maybe_grant_locked()
                self._cv.notify_all()

    def _maybe_grant_locked(self) -> None:
        """Grant the slot to the best waiter (callers hold self._cv)."""
        if self._busy or not self._waiters:
            return
        best = min(self._waiters, key=self._waiter_key)
        self._waiters.remove(best)
        self._account_pick_locked(best.name)
        best.granted = True
        self._busy = True
        self._cv.notify_all()

    def _waiter_key(self, w: _Waiter):
        e = self._entries.get(w.name)
        if e is None:  # unregistered: standard tier, zero deficit
            return (TIER_VALUES["standard"], 0.0, w.seq)
        return (e.tier_value, -e.deficit, w.seq)

    def _account_pick_locked(self, picked: str) -> None:
        """DRR bookkeeping for one grant: the pick resets its pass-over
        run; every OTHER still-waiting entry earns weight x quantum of
        deficit and one pass-over (starvation fires past the budget)."""
        e = self._entries.get(picked)
        if e is not None:
            e.last_passovers = e.passed_over
            e.passed_over = 0
            e.dispatches += 1
            self._disp_c.labels(model=picked, tier=e.tier).inc()
        else:
            self._disp_c.labels(model=picked, tier="standard").inc()
        seen = set()
        for w in self._waiters:
            if w.name in seen:
                continue
            seen.add(w.name)
            o = self._entries.get(w.name)
            if o is None:
                continue
            o.deficit = min(_DEFICIT_CAP,
                            o.deficit + o.weight * self.quantum)
            o.passed_over += 1
            if o.passed_over > self.starvation_budget:
                o.passed_over = 0
                o.starvations += 1
                self._starv_c.labels(model=o.name).inc()

    def _select(self, waiting: List[str]) -> str:
        """Deterministic one-shot arbitration over `waiting` entry names
        (unit-test surface for the pick rule — same tier/deficit/
        starvation accounting as the live slot path, no threads)."""
        with self._cv:
            ws = []
            for n in waiting:
                self._seq += 1
                ws.append(_Waiter(n, self._seq))
            best = min(ws, key=self._waiter_key)
            self._waiters = [w for w in ws if w is not best]
            self._account_pick_locked(best.name)
            e = self._entries.get(best.name)
            if e is not None:
                e.deficit = max(-_DEFICIT_CAP,
                                e.deficit - self.quantum / e.weight)
            self._waiters = []
            return best.name

    def last_passovers(self, name: Optional[str]) -> int:
        """Pass-over run length of `name`'s most recent slot grant (0
        for unknown/unregistered names) — read by the engine right after
        it wins the slot, as exemplar context."""
        with self._cv:
            e = self._entries.get(name)
            return e.last_passovers if e is not None else 0

    # --------------------------------------------------------- admission
    def should_shed(self, name: str) -> Optional[str]:
        """Admission check for one request routed at `name`: returns
        a shed reason (``"tier_shed"``) when a strictly-higher tier
        already has >= ``shed_depth`` requests queued, else None.
        Sampling queue depths happens here (admission), never on the
        dispatch path."""
        with self._cv:
            e = self._entries.get(name)
            if e is None:
                return None
            others = [o for o in self._entries.values()
                      if o.tier_value < e.tier_value
                      and o.depth_fn is not None]
        for o in others:
            try:
                # deliberate unlocked read of a config int: depth
                # sampling happens outside _cv by design (see above)
                if int(o.depth_fn()) >= self.shed_depth:  # jaxlint: atomic
                    return "tier_shed"
            except Exception:
                continue  # a broken gauge must never shed traffic
        return None

    # ------------------------------------------------------------- intro
    def describe(self) -> Dict[str, dict]:
        with self._cv:
            return {e.name: {"tier": e.tier, "weight": e.weight,
                             "deficit": round(e.deficit, 3),
                             "dispatches": e.dispatches,
                             "starvations": e.starvations}
                    for e in self._entries.values()}
