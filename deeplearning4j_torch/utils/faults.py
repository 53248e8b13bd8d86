"""Deterministic fault-injection registry.

The torch package's copy of `deeplearning4j_tpu/utils/faults.py`, cut to the
seams the port calls. Production code calls :func:`fire` (or, at a
flag-style point, :func:`check`) at named injection points; when nothing is
armed both are near-free no-ops. Tests arm a point with a plan string:

    ``"fail:2"``      raise :class:`FaultInjected` on the 2nd call
    ``"fail:1,3"``    ... on the 1st and 3rd calls
    ``"delay:2@50"``  sleep 50 ms on the 2nd call, then continue

Call numbers are 1-based and counted per point. Points used here:

    serve.forward      each coalesced forward in ParallelInference (and
                       each SEQUENTIAL-mode forward)
    serve.pack         the assembly and the unpack of each packed row
                       (ParallelInference with packed_admission)
    serve.decode_step  each decode step attempt of DecodeEngine, solo
                       retries included (serving/decode.py)
    checkpoint.write   mid-write of a checkpoint archive, after the
                       parameters (utils/model_serializer.py)
    etl.next           each base-iterator poll in the async producer
                       (data/iterators.py)
    step.nonfinite     per-step divergence flag (checked, never raised;
                       optimize/resilience.py)

Stdlib-only on purpose: everything in the package may import this.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, FrozenSet, Optional


class FaultInjected(RuntimeError):
    """Raised at an armed injection point (``transient``: retry helpers
    treat it like a flaky-transport error)."""

    transient = True


class _Plan:
    __slots__ = ("action", "calls", "delay_ms", "count", "fired")

    def __init__(self, action: str, calls: FrozenSet[int], delay_ms: float):
        self.action = action      # "fail" | "delay"
        self.calls = calls        # 1-based call numbers covered
        self.delay_ms = delay_ms
        self.count = 0            # calls seen at this point
        self.fired = 0            # calls the plan covered


def _parse(spec: str) -> _Plan:
    action, _, arg = spec.strip().partition(":")
    if action not in ("fail", "delay"):
        raise ValueError(f"unknown fault action {action!r} in spec {spec!r} "
                         "(expected 'fail:...' or 'delay:...')")
    delay_ms = 0.0
    if action == "delay":
        arg, at, ms = arg.partition("@")
        try:
            delay_ms = float(ms)
        except ValueError:
            at = ""
        if not at or delay_ms < 0:
            raise ValueError(
                f"delay spec {spec!r} needs 'delay:CALLS@MS' with a "
                "non-negative millisecond count")
    try:
        calls = frozenset(int(part) for part in arg.split(","))
    except ValueError:
        calls = frozenset()
    if not calls or min(calls) < 1:
        raise ValueError(f"fault spec {spec!r} must list 1-based call numbers")
    return _Plan(action, calls, delay_ms)


_lock = threading.Lock()
_plans: Dict[str, _Plan] = {}


def inject(point: str, spec: str) -> None:
    """Arm `point` with a plan (replacing any existing plan and counters)."""
    plan = _parse(spec)
    with _lock:
        _plans[point] = plan


def clear(point: Optional[str] = None) -> None:
    """Disarm one point (or all)."""
    with _lock:
        if point is None:
            _plans.clear()
        else:
            _plans.pop(point, None)


def _advance(point: str):
    """Count one call at `point`; (plan, call number) when an armed plan
    covers it, else None."""
    with _lock:
        plan = _plans.get(point)
        if plan is None:
            return None
        plan.count += 1
        if plan.count not in plan.calls:
            return None
        plan.fired += 1
        return plan, plan.count


def fire(point: str) -> None:
    """Injection hook: no-op unless an armed plan covers this call; then
    raises :class:`FaultInjected` (``fail``) or sleeps and returns
    (``delay``)."""
    hit = _advance(point)
    if hit is None:
        return
    plan, n = hit
    if plan.action == "delay":
        time.sleep(plan.delay_ms / 1000.0)
        return
    raise FaultInjected(f"injected fault at {point!r} (call #{n})")


def check(point: str) -> bool:
    """Non-raising variant for flag-style points (``step.nonfinite``):
    True when the plan covers this call. A ``delay`` plan sleeps but
    returns False: it slows the caller without flipping the flag."""
    hit = _advance(point)
    if hit is None:
        return False
    plan, _ = hit
    if plan.action == "delay":
        time.sleep(plan.delay_ms / 1000.0)
        return False
    return True


def call_count(point: str) -> int:
    with _lock:
        plan = _plans.get(point)
        return plan.count if plan else 0


def fired_count(point: str) -> int:
    """Calls at `point` that the armed plan covered."""
    with _lock:
        plan = _plans.get(point)
        return plan.fired if plan else 0


@contextmanager
def injected(point: str, spec: str):
    """Scoped arming for tests: arms on entry, disarms on exit."""
    inject(point, spec)
    try:
        yield
    finally:
        clear(point)
