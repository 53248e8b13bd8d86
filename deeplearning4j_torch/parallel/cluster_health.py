"""Cluster health plane for multi-process training.

Port of `deeplearning4j_tpu/parallel/cluster_health.py`, with the same
names, metric families, environment variables and exit code; it imports
neither JAX nor anything of the JAX package.

`MultiHostRunner` guards lockstep counts up front, but once the loop runs,
a peer that dies, stalls or is preempted turns every surviving process
into a silent hang at the next collective. This module turns those hangs
into prompt typed failures and preemption into a clean checkpoint, with
four pieces:

* **Heartbeat watchdog**, :class:`ClusterHealthMonitor`: a background
  thread per process exchanging ``(process_id, step, ts)`` beats over a
  side channel (a chief-hosted ``JsonHttpServer``; an in-process
  transport for tests). A peer whose beats go stale past ``timeout_s``
  raises :class:`PeerLostError`; a peer that keeps beating but stops
  advancing its step while others advance raises
  :class:`ClusterDesyncError`. Both carry the offending peer ids, and the
  default failure action hard-exits the process with
  :data:`ClusterHealthMonitor.EXIT_CODE`, so a restarter can act instead
  of a process sitting in a wedged collective.
* **Timed collectives**, :func:`timed_collective`: a blocking collective
  (barrier, lockstep allgather) under a deadline, raising
  :class:`BarrierTimeoutError` instead of hanging.
* **Preemption grace**: a SIGTERM flag (``request_grace``) rides the
  beats; `MultiHostRunner.fit` agrees on a stop step through a small
  allgather, writes one coordinated checkpoint and exits 0
  (:class:`GraceCheckpointed` is the control-flow signal).
* **Straggler telemetry**: the ``cluster_peer_beat_age_seconds`` and
  ``cluster_peer_step_lag`` gauges per peer, and the
  ``cluster_desync_total{kind}`` and ``cluster_grace_checkpoints_total``
  counters, driven in tests through the ``heartbeat.send`` and
  ``step.stall`` fault points.

Every age is measured on the chief's monotonic clock (the chief stamps
each beat on receipt and returns its own ``now`` with the table), so clock
skew between hosts never enters the staleness rule. Clocks, transports and
the failure action are injectable for fake-clock tests. The side channel
is independent of torch.distributed's store and process group: when the
group wedges inside a collective, the channel keeps working.

Environment (the JAX package's ``DL4JTPU_HEARTBEAT_*`` names, kept so one
setting arms both packages):

    DL4JTPU_HEARTBEAT=1                enable the plane in MultiHostRunner
    DL4JTPU_HEARTBEAT_INTERVAL_S       beat cadence           (default 1)
    DL4JTPU_HEARTBEAT_TIMEOUT_S        beat-staleness deadline (default 30)
    DL4JTPU_HEARTBEAT_STALL_S          step-stall deadline     (default 60)
    DL4JTPU_HEARTBEAT_BARRIER_TIMEOUT_S  collective deadline   (default 300)
    DL4JTPU_HEARTBEAT_PORT             chief beat port (default: the
                                       store's port + 1)
    DL4JTPU_HEARTBEAT_GRACE_EVERY      grace-poll cadence in steps (default 1)
"""
from __future__ import annotations

import logging
import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..optimize import metrics as metrics_mod
from ..utils import faults
from ..utils.http_server import JsonHttpServer, json_request

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Typed failures
# ---------------------------------------------------------------------------

class ClusterHealthError(RuntimeError):
    """Base of every typed cluster-health failure. Carries the offending
    peer ids so the restarter/operator knows WHICH process to look at."""

    def __init__(self, message: str, peers: Optional[List[int]] = None):
        super().__init__(message)
        self.peers = list(peers or [])


class PeerLostError(ClusterHealthError):
    """A peer's heartbeats went stale past the timeout (killed,
    preempted without grace, or network-partitioned)."""


class ClusterDesyncError(ClusterHealthError):
    """A peer is alive (fresh beats) but stopped advancing its step
    while others advance — a wedged main thread or a stalled host."""


class BarrierTimeoutError(ClusterHealthError):
    """A known blocking point (barrier / lockstep allgather / grace
    checkpoint) did not complete within its deadline."""


class GraceCheckpointed(Exception):
    """Control-flow signal: the cluster agreed to stop, the grace
    checkpoint was written, and the process should exit 0."""

    def __init__(self, step: int):
        super().__init__(f"grace checkpoint written at step {step}")
        self.step = int(step)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


@dataclass
class HealthConfig:
    """Tuning knobs for the health plane (see module docstring for the
    matching ``DL4JTPU_HEARTBEAT_*`` env family)."""

    interval_s: float = 1.0          # beat cadence
    timeout_s: float = 30.0          # beat staleness => PeerLostError
    stall_timeout_s: float = 60.0    # step stagnation => ClusterDesyncError
    barrier_timeout_s: float = 300.0  # blocking collective deadline
    grace_every: int = 1             # grace-flag allgather cadence (steps)
    port: Optional[int] = None       # chief beat port (None: coord port + 1)

    @classmethod
    def from_env(cls) -> "HealthConfig":
        port = os.environ.get("DL4JTPU_HEARTBEAT_PORT")
        return cls(
            interval_s=_env_float("DL4JTPU_HEARTBEAT_INTERVAL_S", 1.0),
            timeout_s=_env_float("DL4JTPU_HEARTBEAT_TIMEOUT_S", 30.0),
            stall_timeout_s=_env_float("DL4JTPU_HEARTBEAT_STALL_S", 60.0),
            barrier_timeout_s=_env_float(
                "DL4JTPU_HEARTBEAT_BARRIER_TIMEOUT_S", 300.0),
            grace_every=max(1, int(_env_float(
                "DL4JTPU_HEARTBEAT_GRACE_EVERY", 1))),
            port=int(port) if port else None,
        )


def health_enabled_from_env() -> bool:
    """True when ``DL4JTPU_HEARTBEAT`` opts the process into the plane."""
    return os.environ.get("DL4JTPU_HEARTBEAT", "").strip() not in (
        "", "0", "false", "no")


# Beat kinds: the same beat table (and the same staleness rule) now
# carries two populations — training peers watched by
# ClusterHealthMonitor, and serving replicas watched by the federation
# front-end (serving/federation.py). The ``kind`` field keeps them
# distinguishable when both ride one table.
KIND_TRAINER = "trainer"
KIND_REPLICA = "replica"


def beat_ages(table: dict) -> Dict[str, float]:
    """Age of every beat in a chief-stamped table, in seconds on the
    CHIEF's monotonic clock (``recv_ts`` stamped at receipt vs the
    table's ``now``) — the one staleness rule shared by the training
    watchdog (:meth:`ClusterHealthMonitor._evaluate`) and the serving
    federation's eviction sweep, so "dark past timeout_s" means the
    same thing on both planes. Beats missing ``recv_ts`` read as age
    0 (just arrived)."""
    beats = table.get("beats", {})
    chief_now = float(table.get("now", 0.0))
    return {str(k): max(0.0, chief_now - float(b.get("recv_ts", chief_now)))
            for k, b in beats.items()}


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

_HELP = {
    "cluster_peer_beat_age_seconds":
        "Age of each peer's newest heartbeat on the chief clock",
    "cluster_peer_step_lag":
        "Optimizer steps each peer trails the local process by",
    "cluster_heartbeats_sent_total": "Heartbeats published by this process",
    "cluster_heartbeat_failures_total":
        "Heartbeat sends/fetches that failed (transport or injected)",
    "cluster_desync_total":
        "Typed cluster-health failures raised, by kind "
        "(peer_lost | desync | barrier_timeout)",
    "cluster_grace_checkpoints_total":
        "Coordinated preemption-grace checkpoints written",
}


def register_metrics(reg=None):
    """Pre-register every cluster-health family so a snapshot carries
    them before the first beat."""
    reg = reg or metrics_mod.registry()
    for name, help_ in _HELP.items():
        if name.endswith("_total"):
            reg.counter(name, help_)
        else:
            reg.gauge(name, help_)
    return reg


def _counter(name: str):
    return metrics_mod.registry().counter(name, _HELP[name])


def _gauge(name: str):
    return metrics_mod.registry().gauge(name, _HELP[name])


# ---------------------------------------------------------------------------
# Beat transports
# ---------------------------------------------------------------------------

class InProcessBeatTransport:
    """Shared in-memory beat table — the sockets-free transport unit
    tests share between several monitors. Also the chief's local store
    inside :class:`HttpBeatTransport` (the chief never loops through
    its own HTTP socket)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._beats: Dict[int, dict] = {}

    def publish(self, beat: dict) -> None:
        rec = dict(beat)
        rec["recv_ts"] = self._clock()
        with self._lock:
            self._beats[int(beat["process_id"])] = rec

    def table(self) -> dict:
        with self._lock:
            beats = {str(k): dict(v) for k, v in self._beats.items()}
        return {"now": self._clock(), "beats": beats}

    def close(self) -> None:
        pass


class HttpBeatTransport:
    """Chief-hosted HTTP side channel over :class:`JsonHttpServer`.

    Process 0 serves ``POST /beat`` + ``GET /beats``; every process
    (chief included, via the local store) publishes its beat and fetches
    the chief-stamped table. Deliberately independent of the process
    group's store: when the cluster wedges inside a collective, this
    channel keeps working.
    """

    def __init__(self, process_id: int, host: str, port: int, *,
                 chief: bool = False, clock: Callable[[], float] =
                 time.monotonic, request_timeout_s: float = 2.0):
        self.process_id = int(process_id)
        self.chief = bool(chief)
        self._url = f"http://{host}:{int(port)}"
        self._timeout = float(request_timeout_s)
        self._store: Optional[InProcessBeatTransport] = None
        self._server: Optional[JsonHttpServer] = None
        if self.chief:
            store = InProcessBeatTransport(clock)
            self._store = store

            def _post_beat(payload):
                store.publish(payload)
                return 200, {"ok": True}

            self._server = JsonHttpServer(
                get_routes={"/beats": lambda _p: (200, store.table())},
                post_routes={"/beat": _post_beat},
                port=int(port), host=host, pool_size=4).start()

    @property
    def url(self) -> str:
        return self._url

    def publish(self, beat: dict) -> None:
        if self._store is not None:
            self._store.publish(beat)
            return
        json_request(self._url + "/beat", beat, timeout=self._timeout)

    def table(self) -> dict:
        if self._store is not None:
            return self._store.table()
        return json_request(self._url + "/beats", timeout=self._timeout)

    def close(self) -> None:
        if self._server is not None:
            self._server.stop()
            self._server = None


# ---------------------------------------------------------------------------
# The watchdog
# ---------------------------------------------------------------------------

def _default_on_failure(err: ClusterHealthError) -> None:
    """Tear the process down so the restarter can act. The main thread
    is (by hypothesis) wedged inside a collective, so a raised exception
    could never reach it — a hard exit is the only honest action.
    os._exit skips atexit/flush, so write the diagnosis directly."""
    sys.stderr.write(
        f"ClusterHealthMonitor: {type(err).__name__}: {err} "
        f"(peers={err.peers}) — hard-exiting with code "
        f"{ClusterHealthMonitor.EXIT_CODE} for the restarter\n")
    sys.stderr.flush()
    log.critical("cluster health failure: %s: %s", type(err).__name__, err)
    os._exit(ClusterHealthMonitor.EXIT_CODE)


class ClusterHealthMonitor:
    """Per-process heartbeat watchdog (see module docstring).

    State transitions, evaluated once per poll against the chief-stamped
    beat table::

        HEALTHY ──beat age > timeout_s──────────────▶ PEER_LOST
        HEALTHY ──peer step frozen > stall_timeout_s
                  while the local step advances─────▶ DESYNC
        (either) ──record failure, bump cluster_desync_total,
                   call on_failure (default: hard exit 17)

    ``notify_step`` feeds the step-progress side (wired as a
    ParallelWrapper step hook); ``request_grace`` flips the preemption
    bit that rides the beats. ``check()`` re-raises a recorded failure
    in the *caller's* thread — the fit loop calls it at step boundaries
    so the typed error surfaces in the main thread too whenever the
    main thread is still alive to see it.
    """

    EXIT_CODE = 17  # distinct from SIGKILL'd (-9) and clean (0) exits

    def __init__(self, process_id: int, num_processes: int, transport, *,
                 config: Optional[HealthConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_failure: Optional[Callable[[ClusterHealthError],
                                               None]] = None):
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)
        self.transport = transport
        self.config = config or HealthConfig.from_env()
        self._clock = clock
        self._on_failure = on_failure or _default_on_failure
        self._lock = threading.RLock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # ---- shared state: every access under self._lock ----
        self._step = 0
        self._step_changed_at = clock()
        self._grace = False
        self._peer_grace = False
        self._failure: Optional[ClusterHealthError] = None
        self._started_at: Optional[float] = None
        # peer id -> (last seen step, local ts when that step first seen)
        self._peer_steps: Dict[int, Tuple[int, float]] = {}
        self._transport_fail_since: Optional[float] = None
        register_metrics()

    # --------------------------------------------------------------- control
    def start(self) -> "ClusterHealthMonitor":
        with self._lock:
            if self._thread is not None:
                return self
            self._started_at = self._clock()
        self._stop_evt.clear()
        t = threading.Thread(target=self._loop, daemon=True,
                             name=f"cluster-health-{self.process_id}")
        with self._lock:
            self._thread = t
        t.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            t.join(timeout=5)
        self.transport.close()

    # ------------------------------------------------------------ main-thread
    def notify_step(self, step: int) -> None:
        """Report optimizer progress (wired as a wrapper step hook).
        The ``step.stall`` fault point swallows the report — the peer
        keeps beating but looks frozen, the deterministic stand-in for a
        wedged main thread."""
        if faults.check("step.stall"):
            return
        with self._lock:
            if int(step) > self._step:
                self._step = int(step)
                self._step_changed_at = self._clock()

    def request_grace(self) -> None:
        """Flag preemption (SIGTERM handler); the bit rides the beats."""
        with self._lock:
            self._grace = True

    def grace_requested(self) -> bool:
        """True once this process — or any peer, via the beat table —
        asked for a grace checkpoint."""
        with self._lock:
            return self._grace or self._peer_grace

    def failure(self) -> Optional[ClusterHealthError]:
        with self._lock:
            return self._failure

    def check(self) -> None:
        """Raise the recorded typed failure in the caller's thread."""
        with self._lock:
            failure = self._failure
        if failure is not None:
            raise failure

    # ------------------------------------------------------------------ poll
    def poll_once(self) -> Optional[ClusterHealthError]:
        """One beat + fetch + evaluate cycle (the loop body; callable
        directly with a fake clock in tests). Records and reports the
        first failure, then becomes a no-op."""
        with self._lock:
            if self._failure is not None:
                return self._failure
            beat = {"process_id": self.process_id, "step": self._step,
                    "grace": bool(self._grace), "kind": KIND_TRAINER,
                    "send_ts": self._clock()}
        ok = True
        try:
            # the fault point covers both grammars: fail: suppresses the
            # send, delay:SEL@MS injects channel latency then sends
            faults.fire("heartbeat.send")
            self.transport.publish(beat)
            _counter("cluster_heartbeats_sent_total").inc()
        except Exception as e:  # incl. FaultInjected: transport must never kill the watchdog
            ok = False
            _counter("cluster_heartbeat_failures_total").inc()
            log.debug("heartbeat publish failed: %s", e)
        table = None
        try:
            table = self.transport.table()
        except Exception as e:
            ok = False
            _counter("cluster_heartbeat_failures_total").inc()
            log.debug("heartbeat fetch failed: %s", e)
        now_local = self._clock()
        hosts_channel = bool(getattr(self.transport, "chief", True))
        err: Optional[ClusterHealthError] = None
        with self._lock:
            if ok and table is not None:
                self._transport_fail_since = None
            elif self._transport_fail_since is None:
                self._transport_fail_since = now_local
            if table is not None:
                err = self._evaluate(table, now_local)
            elif not hosts_channel and \
                    self._transport_fail_since is not None and \
                    now_local - self._transport_fail_since > \
                    self.config.timeout_s:
                # non-chief with an unreachable side channel: the chief
                # process (which hosts it) is gone
                err = PeerLostError(
                    f"process {self.process_id}: beat channel (chief) "
                    f"unreachable for over {self.config.timeout_s:.1f}s — "
                    "treating the chief as lost", peers=[0])
            if err is not None:
                self._failure = err
        if err is not None:
            kind = "peer_lost" if isinstance(err, PeerLostError) else "desync"
            _counter("cluster_desync_total").labels(kind=kind).inc()
            self._on_failure(err)
        return err

    # ------------------------------------------------------------- internals
    def _evaluate(self, table: dict,
                  now_local: float) -> Optional[ClusterHealthError]:
        """Watchdog state machine over one chief-stamped table. Caller
        holds self._lock."""
        cfg = self.config
        beats = table.get("beats", {})
        ages = beat_ages(table)
        self._peer_grace = any(
            b.get("grace") for k, b in beats.items()
            if int(k) != self.process_id)
        my_fresh = now_local - self._step_changed_at <= cfg.stall_timeout_s
        started_at = self._started_at      # one snapshot per evaluation
        lost: List[int] = []
        lost_ages: List[float] = []
        stalled: List[int] = []
        for pid in range(self.num_processes):
            if pid == self.process_id:
                continue
            b = beats.get(str(pid))
            if b is None:
                # startup grace: a peer that has never beaten is only
                # lost once the cluster has had timeout_s to assemble
                if started_at is not None and \
                        now_local - started_at > cfg.timeout_s:
                    lost.append(pid)
                    lost_ages.append(float("inf"))
                continue
            age = ages.get(str(pid), 0.0)
            _gauge("cluster_peer_beat_age_seconds").labels(
                peer=str(pid)).set(age)
            pstep = int(b.get("step", 0))
            seen = self._peer_steps.get(pid)
            if seen is None or pstep > seen[0]:
                self._peer_steps[pid] = (pstep, now_local)
                seen = self._peer_steps[pid]
            lag = max(0, self._step - pstep)
            _gauge("cluster_peer_step_lag").labels(peer=str(pid)).set(lag)
            if age > cfg.timeout_s:
                lost.append(pid)
                lost_ages.append(age)
                continue
            if lag > 0 and my_fresh and \
                    now_local - seen[1] > cfg.stall_timeout_s:
                stalled.append(pid)
        if lost:
            ages = ", ".join("never" if a == float("inf") else f"{a:.1f}s"
                             for a in lost_ages)
            return PeerLostError(
                f"peer(s) {lost} missed heartbeats past "
                f"{cfg.timeout_s:.1f}s (beat ages: {ages}) while process "
                f"{self.process_id} is at step {self._step}", peers=lost)
        if stalled:
            return ClusterDesyncError(
                f"peer(s) {stalled} kept beating but made no step "
                f"progress for over {cfg.stall_timeout_s:.1f}s while "
                f"process {self.process_id} advanced to step "
                f"{self._step}", peers=stalled)
        return None

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                if self.poll_once() is not None:
                    return
            except Exception:
                log.exception("cluster health loop error (continuing)")
            self._stop_evt.wait(self.config.interval_s)


# ---------------------------------------------------------------------------
# Timed collectives
# ---------------------------------------------------------------------------

def timed_collective(fn: Callable[[], object], *, name: str,
                     timeout_s: Optional[float],
                     monitor: Optional[ClusterHealthMonitor] = None):
    """Run a blocking collective under a watchdog deadline.

    The collective runs on a daemon worker thread while the caller
    waits with a timeout; on expiry the caller gets a typed
    :class:`BarrierTimeoutError` (or the monitor's richer
    PeerLost/Desync diagnosis, when one is recorded) instead of hanging
    forever. The abandoned worker thread stays blocked — acceptable,
    because every caller of this path is about to tear the process
    down.
    """
    if not timeout_s or timeout_s <= 0:
        return fn()
    out: dict = {}
    done = threading.Event()

    def _run():
        try:
            out["value"] = fn()
        except BaseException as e:  # propagate into the waiting thread
            out["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=_run, daemon=True,
                         name=f"collective-{name}")
    t.start()
    if not done.wait(timeout_s):
        _counter("cluster_desync_total").labels(kind="barrier_timeout").inc()
        if monitor is not None:
            monitor.check()  # prefer the watchdog's peer-level diagnosis
        raise BarrierTimeoutError(
            f"collective {name!r} did not complete within "
            f"{float(timeout_s):.1f}s — a peer is gone or wedged")
    if "error" in out:
        raise out["error"]
    return out.get("value")
