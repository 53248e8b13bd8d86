"""Deterministic fault-injection registry.

The torch package's copy of `deeplearning4j_tpu/utils/faults.py`, cut to the
seams the port calls. Production code calls :func:`fire` at named
injection points; when nothing is armed it is a near-free no-op. Tests arm a
point with a plan string:

    ``"fail:2"``      raise :class:`FaultInjected` on the 2nd call
    ``"fail:1,3"``    ... on the 1st and 3rd calls
    ``"delay:2@50"``  sleep 50 ms on the 2nd call, then continue

Call numbers are 1-based and counted per point. Points used here:

    serve.forward      each coalesced forward in ParallelInference (and
                       each SEQUENTIAL-mode forward)
    checkpoint.write   mid-write of a checkpoint archive, after the
                       parameters (utils/model_serializer.py)

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
    __slots__ = ("action", "calls", "delay_ms", "count")

    def __init__(self, action: str, calls: FrozenSet[int], delay_ms: float):
        self.action = action      # "fail" | "delay"
        self.calls = calls        # 1-based call numbers covered
        self.delay_ms = delay_ms
        self.count = 0            # calls seen at this point


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


def fire(point: str) -> None:
    """Injection hook: no-op unless an armed plan covers this call; then
    raises :class:`FaultInjected` (``fail``) or sleeps and returns
    (``delay``)."""
    with _lock:
        plan = _plans.get(point)
        if plan is None:
            return
        plan.count += 1
        n = plan.count
        if n not in plan.calls:
            return
    if plan.action == "delay":
        time.sleep(plan.delay_ms / 1000.0)
        return
    raise FaultInjected(f"injected fault at {point!r} (call #{n})")


def call_count(point: str) -> int:
    with _lock:
        plan = _plans.get(point)
        return plan.count if plan else 0


@contextmanager
def injected(point: str, spec: str):
    """Scoped arming for tests: arms on entry, disarms on exit."""
    inject(point, spec)
    try:
        yield
    finally:
        clear(point)
