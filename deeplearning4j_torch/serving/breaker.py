"""Per-model circuit breaker for the serving path.

Port of `deeplearning4j_tpu/serving/breaker.py`, state for state.

State machine (the classic Nygard breaker, shaped for coalesced-forward
serving):

    CLOSED ──(N consecutive batch failures, or ONE non-finite-output
              trip)──► OPEN ──(reset_timeout_s elapsed)──► HALF_OPEN
    HALF_OPEN ──(probe forward succeeds)──► CLOSED
    HALF_OPEN ──(probe forward fails)────► OPEN (cooldown restarts)

While OPEN the gateway fast-fails ``/predict`` with a distinct 503
``breaker_open`` status instead of queuing requests against a model
that cannot answer them — the queue slots and forward capacity go to
healthy models, and ``/health`` reports the deployment degraded.
HALF_OPEN admits ONE probe request at a time (a probe that dies before
reaching a forward — shed, queue-full — releases its slot after
``probe_timeout_s`` so the breaker can never wedge half-open).

Outcomes are recorded from the engine's batch hooks (ModelPool wires
``on_batch``/``on_batch_error``), so a breaker sees exactly what the
coalesced forwards did — including the instant trip when a forward
returns NaN/Inf rows under ``check_finite``.

Metrics: ``serving_breaker_state{model}`` gauge (0=closed, 1=open,
2=half_open), ``serving_breaker_transitions_total{model,to}`` counter,
and ``serving_batch_failures_total{model}`` (bumped by the pool's
failure hook, pre-registered here so every scrape carries the family).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..optimize.metrics import registry

__all__ = ["BreakerOpenError", "CircuitBreaker", "CLOSED", "OPEN",
           "HALF_OPEN", "STATE_VALUES", "register_metrics"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# Gauge encoding for serving_breaker_state (alert on value == 1).
STATE_VALUES = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class BreakerOpenError(RuntimeError):
    """Fast-fail: the model's circuit breaker is open (or half-open with
    a probe already in flight) — the request was rejected without
    taking a queue slot. Maps to HTTP 503 ``breaker_open``."""


def register_metrics() -> None:
    """Pre-register the breaker/chaos metric families so a snapshot
    records serving resilience activity — including its absence — before
    any breaker exists."""
    reg = registry()
    reg.gauge("serving_breaker_state",
              "Circuit breaker state per model (0=closed, 1=open, "
              "2=half_open)")
    reg.counter("serving_breaker_transitions_total",
                "Breaker state transitions by target state")
    reg.counter("serving_batch_failures_total",
                "Coalesced forwards that raised or returned non-finite "
                "outputs")


class CircuitBreaker:
    """Thread-safe three-state breaker guarding one served model.

    `failure_threshold` consecutive batch failures open it; a
    NonFiniteOutputError (``record_failure(trip=True)``) opens it
    immediately. After `reset_timeout_s` the next `allow()` admits one
    half-open probe; its outcome recloses or reopens the breaker.
    `clock` is injectable for deterministic tests."""

    def __init__(self, model: str = "", *, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0,
                 probe_timeout_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.model = model
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        # A half-open probe that never produces an outcome (it was shed
        # before reaching a forward) frees its slot after this long.
        self.probe_timeout_s = float(
            reset_timeout_s if probe_timeout_s is None else probe_timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_started: Optional[float] = None
        reg = registry()
        self._state_g = reg.gauge(
            "serving_breaker_state",
            "Circuit breaker state per model (0=closed, 1=open, "
            "2=half_open)").labels(model=model)
        self._trans_c = reg.counter(
            "serving_breaker_transitions_total",
            "Breaker state transitions by target state")
        self._state_g.set(STATE_VALUES[CLOSED])

    # ------------------------------------------------------------- state
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._consecutive

    def _transition(self, to: str) -> None:
        # callers hold self._lock
        self._state = to
        self._state_g.set(STATE_VALUES[to])
        self._trans_c.labels(model=self.model, to=to).inc()

    # ---------------------------------------------------------- decisions
    def allow(self) -> bool:
        """Admission decision for one request. CLOSED always admits;
        OPEN fast-fails until the cooldown elapses, then flips to
        HALF_OPEN and admits one probe; HALF_OPEN admits a new probe
        only when none is in flight (or the last one timed out)."""
        with self._lock:
            if self._state == CLOSED:
                return True
            now = self._clock()
            if self._state == OPEN:
                if now - self._opened_at < self.reset_timeout_s:
                    return False
                self._transition(HALF_OPEN)
                self._probe_started = now
                return True
            # HALF_OPEN
            if (self._probe_started is not None and
                    now - self._probe_started < self.probe_timeout_s):
                return False
            self._probe_started = now
            return True

    def record_success(self) -> None:
        """A forward served rows: reset the failure run; a half-open
        probe success recloses the breaker."""
        with self._lock:
            self._consecutive = 0
            self._probe_started = None
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self, *, trip: bool = False) -> None:
        """A forward failed. `trip=True` (non-finite outputs) opens the
        breaker immediately; otherwise `failure_threshold` consecutive
        failures open it. A half-open probe failure reopens it."""
        with self._lock:
            self._consecutive += 1
            if self._state == HALF_OPEN:
                self._probe_started = None
                self._opened_at = self._clock()
                self._transition(OPEN)
            elif self._state == CLOSED and (
                    trip or self._consecutive >= self.failure_threshold):
                self._opened_at = self._clock()
                self._transition(OPEN)
            # already OPEN: a straggler failure from a forward that was
            # in flight when the breaker opened changes nothing.

    def reconfigure(self, *, failure_threshold: Optional[int] = None,
                    reset_timeout_s: Optional[float] = None) -> dict:
        """Live knob set — the ``POST /config`` / ``pool.reconfigure`` /
        AutoTuner actuator seam. Validates BOTH values
        before mutating either, so an invalid request changes nothing.
        Takes effect on the next decision: a raised threshold does not
        retroactively reclose an open breaker, a shortened cooldown is
        honored by the next ``allow()``."""
        ft = rt = None
        if failure_threshold is not None:
            ft = int(failure_threshold)
            if ft < 1:
                raise ValueError("failure_threshold must be >= 1")
        if reset_timeout_s is not None:
            rt = float(reset_timeout_s)
            if rt <= 0:
                raise ValueError("reset_timeout_s must be > 0")
        with self._lock:
            if ft is not None:
                self.failure_threshold = ft
            if rt is not None:
                self.reset_timeout_s = rt
        return self.describe()

    def describe(self) -> dict:
        with self._lock:
            return {"state": self._state,
                    "consecutive_failures": self._consecutive,
                    "failure_threshold": self.failure_threshold,
                    "reset_timeout_s": self.reset_timeout_s}
