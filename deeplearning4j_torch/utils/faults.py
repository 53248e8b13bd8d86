"""Deterministic fault-injection registry.

The torch package's copy of `deeplearning4j_tpu/utils/faults.py`, with the
same grammar. Production code calls :func:`fire` (or, at a flag-style point,
:func:`check`) at named injection points; when nothing is armed both are
near-free no-ops. Tests (or an operator, through environment variables) arm
a point with a plan string:

    ``"fail:2"``      raise :class:`FaultInjected` on the 2nd call
    ``"fail:1,3"``    ... on the 1st and 3rd calls
    ``"fail:2-4"``    ... on calls 2 through 4
    ``"fail:2/5"``    ... on calls 2, 7, 12, ... (every 5th from the 2nd)
    ``"fail:*"``      ... on every call
    ``"kill:3"``      SIGKILL this process on the 3rd call (crash tests)
    ``"delay:2@50"``  sleep 50 ms on the 2nd call, then continue (the same
                      call selectors as fail:/kill:, e.g. ``"delay:*@10"``)

Call numbers are 1-based and counted per point, so a plan is deterministic:
the same program order always hits the same faults.

Environment arming: ``DL4JTPU_FAULT_<POINT>``, dots and dashes mapped to
underscores (``DL4JTPU_FAULT_CHECKPOINT_WRITE="kill:3"``), read at a point's
first call. The variable keeps the JAX package's name, so one setting arms
both packages. An explicit :func:`inject` or :func:`clear` wins over it;
:func:`reset` forgets both, so the variable is read again.

Points used here:

    serve.forward      each coalesced forward in ParallelInference (and
                       each SEQUENTIAL-mode forward)
    serve.pack         the assembly and the unpack of each packed row
                       (ParallelInference with packed_admission)
    serve.decode_step  each decode step attempt of DecodeEngine, solo
                       retries included (serving/decode.py)
    serve.schedule     each DeviceScheduler slot acquisition
                       (serving/scheduler.py)
    serve.decode       a hot swap's checkpoint decode, before anything is
                       changed (serving/model_pool.py)
    swap.warm          each warm forward inside a hot swap's pause
                       (serving/model_pool.py)
    checkpoint.write   mid-write of a checkpoint archive, after the
                       parameters (utils/model_serializer.py)
    etl.next           each base-iterator poll in the async producer
                       (data/iterators.py)
    step.nonfinite     per-step divergence flag (checked, never raised;
                       optimize/resilience.py)
    ps.pull / ps.push  each parameter-server transport attempt, retries
                       included (parallel/param_server.py)

Points of the cluster health plane (parallel/cluster_health.py):

    heartbeat.send     each watchdog beat publish: ``fail:`` suppresses
                       the beat (the peer goes quiet), ``delay:SEL@MS``
                       slows the side channel
    step.stall         checked in ClusterHealthMonitor.notify_step: when
                       armed the step report is swallowed, so the process
                       keeps beating but looks frozen (the stand-in for a
                       wedged main thread)

Points of the replica federation (serving/federation.py):

    route.dispatch     each front-end dispatch leg (the first attempt and
                       the failover retry count one call each): ``fail:``
                       drops the leg before the HTTP post, exercising the
                       failover path without killing a replica
    replica.beat       each replica-side beat publish: ``fail:``
                       suppresses the beat, so the replica goes dark and
                       is evicted past timeout_s while its gateway keeps
                       serving; armable in a replica process through
                       DL4JTPU_FAULT_REPLICA_BEAT

Stdlib-only on purpose: everything in the package may import this.
"""
from __future__ import annotations

import os
import signal
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Set, Tuple


class FaultInjected(RuntimeError):
    """Raised at an armed injection point (``transient``: retry helpers
    treat it like a flaky-transport error)."""

    transient = True


class _Plan:
    __slots__ = ("action", "calls", "periodic", "always", "delay_ms",
                 "count", "fired")

    def __init__(self, action: str, calls: Set[int],
                 periodic: List[Tuple[int, int]], always: bool,
                 delay_ms: float = 0.0):
        self.action = action      # "fail" | "kill" | "delay"
        self.calls = calls        # 1-based call numbers covered
        self.periodic = periodic  # (start, every): start, start + every, ...
        self.always = always
        self.delay_ms = delay_ms
        self.count = 0            # calls seen at this point
        self.fired = 0            # calls the plan covered

    def covers(self, n: int) -> bool:
        return (self.always or n in self.calls or
                any(n >= s and (n - s) % p == 0 for s, p in self.periodic))


def _parse(spec: str) -> _Plan:
    action, _, arg = spec.strip().partition(":")
    if action not in ("fail", "kill", "delay"):
        raise ValueError(f"unknown fault action {action!r} in spec {spec!r} "
                         "(expected 'fail:...', 'kill:...' or 'delay:...')")
    arg = arg.strip()
    delay_ms = 0.0
    if action == "delay":
        arg, at, ms = arg.partition("@")
        arg = arg.strip()
        try:
            delay_ms = float(ms)
        except ValueError:
            at = ""
        if not at or delay_ms < 0:
            raise ValueError(
                f"delay spec {spec!r} needs 'delay:SELECTOR@MS' with a "
                "non-negative millisecond count")
    if arg in ("", "*"):
        return _Plan(action, set(), [], always=True, delay_ms=delay_ms)
    calls: Set[int] = set()
    periodic: List[Tuple[int, int]] = []
    for part in arg.split(","):
        part = part.strip()
        lo, slash, every = part.partition("/")
        try:
            if slash:
                start, period = int(lo), int(every)
                if start < 1 or period < 1:
                    raise ValueError
                periodic.append((start, period))
                continue
            lo, dash, hi = part.partition("-")
            if dash:
                calls.update(range(int(lo), int(hi) + 1))
            else:
                calls.add(int(lo))
        except ValueError:
            raise ValueError(f"bad call selector {part!r} in fault spec {spec!r}")
    if not (calls or periodic) or (calls and min(calls) < 1):
        raise ValueError(f"fault spec {spec!r} must select 1-based call numbers")
    return _Plan(action, calls, periodic, always=False, delay_ms=delay_ms)


_lock = threading.Lock()
_plans: Dict[str, _Plan] = {}
_env_checked: Set[str] = set()   # points whose environment variable was read


def _env_var(point: str) -> str:
    """The environment variable that arms `point`."""
    return "DL4JTPU_FAULT_" + point.upper().replace(".", "_").replace("-", "_")


def inject(point: str, spec: str) -> None:
    """Arm `point` with a plan (replacing any existing plan and counters)."""
    plan = _parse(spec)
    with _lock:
        _plans[point] = plan
        _env_checked.add(point)   # an explicit plan wins over the environment


def clear(point: Optional[str] = None) -> None:
    """Disarm one point (or all); a cleared point does not re-arm from the
    environment."""
    with _lock:
        if point is None:
            _env_checked.update(_plans)
            _plans.clear()
        else:
            _plans.pop(point, None)
            _env_checked.add(point)


def reset() -> None:
    """Forget every plan and every environment read (test fixtures)."""
    with _lock:
        _plans.clear()
        _env_checked.clear()


def _advance(point: str) -> Optional[Tuple[str, float, int]]:
    """Count one call at `point`; (action, delay ms, call number) when an
    armed plan covers it, else None."""
    with _lock:
        plan = _plans.get(point)
        if plan is None:
            if point in _env_checked:
                return None
            _env_checked.add(point)
            spec = os.environ.get(_env_var(point))
            if not spec:
                return None
            plan = _plans[point] = _parse(spec)
        plan.count += 1
        if not plan.covers(plan.count):
            return None
        plan.fired += 1
        return plan.action, plan.delay_ms, plan.count


def fire(point: str) -> None:
    """Injection hook: no-op unless an armed plan covers this call; then
    raises :class:`FaultInjected` (``fail``), SIGKILLs the process
    (``kill``: unmaskable, for torn-write crash tests), or sleeps and
    returns (``delay``)."""
    hit = _advance(point)
    if hit is None:
        return
    action, delay_ms, n = hit
    if action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    if action == "delay":
        time.sleep(delay_ms / 1000.0)
        return
    raise FaultInjected(f"injected fault at {point!r} (call #{n})")


def check(point: str) -> bool:
    """Non-raising variant for flag-style points (``step.nonfinite``):
    True when the plan covers this call. A ``delay`` plan sleeps but
    returns False: it slows the caller without flipping the flag."""
    hit = _advance(point)
    if hit is None:
        return False
    action, delay_ms, _ = hit
    if action == "delay":
        time.sleep(delay_ms / 1000.0)
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
