"""Replica federation: several serving replicas behind one routing front
end.

Port of `deeplearning4j_tpu/serving/federation.py`, with the same routes,
statuses, bodies, metric names and fault points; it imports neither JAX
nor anything of the JAX package, and a spawned replica runs this module's
`main`.

N replica processes, each running the whole gateway stack (ServingGateway
over a ModelPool) on its own port, sit behind a
:class:`FederationFrontEnd` that owns routing, membership, failover and
rolling deploys. A replica never knows it is federated.

Membership rides the heartbeat plane (parallel/cluster_health.py): every
replica publishes ``kind="replica"`` beats carrying its URL and its
gateway's admission load (``queue_depth`` and the EWMA ``est_wait_s`` of
ServingGateway.load()) into the front end's chief-stamped beat table (the
same InProcessBeatTransport and beat_ages staleness rule the training
watchdog evaluates). Per-replica state machine::

    (first beat) ──────────────────────────▶ JOINING   (not routable)
    JOINING ──beat with warmed=True────────▶ HEALTHY   (routable)
    HEALTHY ──POST /swap steering──────────▶ DRAINING  (not routable,
                                                        beats fresh)
    DRAINING ──swap leg done───────────────▶ HEALTHY
    any ──beats dark past timeout_s,
          or a connection-dead dispatch────▶ DEAD      (evicted)
    DEAD ──fresh beat (recovered or
           replacement replica)────────────▶ JOINING   (takes traffic
                                                        again only once
                                                        its beats say
                                                        warmed)

Dispatch is weighted least-loaded: each replica's score is
``(1 + frontend_inflight + queue_depth) * (1 + est_wait_s) / weight``,
lowest wins, ties to the lowest id.

Failover is typed and exactly-once. A request on a replica that dies
mid-flight fails with :class:`ReplicaLostError`, a subclass of the serving
chain's ServerClosedError, and a **predict** request is retried on a
sibling at most once. Every failure path (the dispatch thread's connection
error, the eviction sweep) goes through the same claim-or-wait gate, so
two concurrent failover signals never dispatch the retry twice. A
**generate** request is never retried mid-decode (a sibling has no KV
state for it): it fails typed with ``tokens_so_far`` attached. A falsely
evicted replica may still complete the original forward after the sibling
retry; that is pure inference, and the client sees exactly one response.

Rolling deploys: ``POST /swap`` on the front end runs the pool's
checkpoint-gated canary swap on one replica first, after steering traffic
away (DRAINING) and waiting for its in-flight count to reach zero, then
promotes the rest one at a time the same way. A canary rejection aborts
the roll with the canary's parameters already rolled back by the
replica's own swap protocol, and every other replica untouched.

Fault points (utils/faults.py): ``route.dispatch`` before every dispatch
leg, ``replica.beat`` before every replica beat publish, both armable in
subprocesses (DL4JTPU_FAULT_ROUTE_DISPATCH, DL4JTPU_FAULT_REPLICA_BEAT).

Metrics: ``serving_replicas{state}``,
``serving_replica_evictions_total{reason}``,
``serving_failover_retries_total{outcome}`` (ok / failed / no_sibling /
decode_suppressed) and ``serving_replica_dispatch_total{replica}``.

Run a replica from the command line (what spawn_replica() runs)::

    python -c "import sys; from deeplearning4j_torch.serving.federation \
        import main; sys.exit(main(sys.argv[1:]))" \
        --replica-id 0 --frontend http://127.0.0.1:8000 \
        [--port 0] [--builder pkg.mod:fn] [--interval-s 0.5]
"""
from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import urllib.error
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..optimize.metrics import registry
from ..parallel.cluster_health import (KIND_REPLICA, HealthConfig,
                                       InProcessBeatTransport, beat_ages)
from ..parallel.inference import ServerClosedError
from ..utils import faults
from ..utils.http_server import JsonHttpServer, json_request

log = logging.getLogger(__name__)

__all__ = ["ReplicaLostError", "FederationFrontEnd", "ReplicaServer",
           "serve_replica", "spawn_replica", "default_builder",
           "register_metrics", "JOINING", "HEALTHY", "DRAINING", "DEAD"]

# Replica membership states.
JOINING = "joining"
HEALTHY = "healthy"
DRAINING = "draining"
DEAD = "dead"
STATES = (JOINING, HEALTHY, DRAINING, DEAD)


class ReplicaLostError(ServerClosedError):
    """The replica holding this request died (beats dark past
    timeout_s, or its socket went away mid-request) — a member of the
    serving typed-error chain via ServerClosedError, so it maps to the
    same 503 family every client already handles. ``replica`` names
    the lost member; ``tokens_so_far`` carries a decode request's
    partial progress (always present, possibly empty — decode is never
    retried mid-stream, the client decides whether to resume)."""

    transient = True  # retryable, like faults.FaultInjected

    def __init__(self, message: str, *, replica: Optional[int] = None,
                 tokens_so_far: Optional[List[Any]] = None):
        super().__init__(message)
        self.replica = replica
        self.tokens_so_far = list(tokens_so_far or [])


_HELP = {
    "serving_replicas":
        "Federation replica population by membership state",
    "serving_replica_evictions_total":
        "Replicas evicted from the federation, by reason "
        "(beat_timeout | dispatch)",
    "serving_failover_retries_total":
        "Failover outcomes for requests whose replica died mid-flight "
        "(ok | failed | no_sibling | decode_suppressed)",
    "serving_replica_dispatch_total":
        "Requests dispatched to each replica (retry legs included)",
}


def register_metrics() -> None:
    """Pre-register the federation families at 0, so a scrape tells 'no
    federation activity' from 'no federation'. The population gauge is
    touched at every state so a snapshot always carries the state axis."""
    reg = registry()
    g = reg.gauge("serving_replicas", _HELP["serving_replicas"])
    for state in STATES:
        g.touch(state=state)
    for name in ("serving_replica_evictions_total",
                 "serving_failover_retries_total",
                 "serving_replica_dispatch_total"):
        reg.counter(name, _HELP[name])


def _http_transport(url: str, payload: Optional[dict],
                    timeout: float) -> Tuple[int, dict]:
    """Default dispatch transport: one JSON POST (GET when payload is
    None). A non-2xx reply from a LIVE replica is not a transport
    failure — its typed body passes through verbatim so the client
    sees exactly the status the replica chose. Connection-level
    errors (refused/reset/timeout) propagate for the caller to
    convert into ReplicaLostError."""
    try:
        return 200, json_request(url, payload, timeout=timeout)
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read().decode())
        except Exception:
            body = {"status": "error", "error": f"HTTP {e.code}"}
        return e.code, body


class _Replica:
    """One membership record; every field mutates under the
    front-end's lock."""

    __slots__ = ("id", "url", "state", "weight", "warmed", "queue_depth",
                 "est_wait_s", "inflight", "dispatched", "evictions")

    def __init__(self, rid: int, url: str, weight: float = 1.0):
        self.id = int(rid)
        self.url = str(url)
        self.state = JOINING
        self.weight = float(weight)
        self.warmed = False
        self.queue_depth = 0
        self.est_wait_s = 0.0
        self.inflight: Set["_Request"] = set()
        self.dispatched = 0
        self.evictions = 0

    def describe(self, age: Optional[float] = None) -> Dict[str, Any]:
        d = {"id": self.id, "url": self.url, "state": self.state,
             "weight": self.weight, "warmed": self.warmed,
             "queue_depth": self.queue_depth,
             "est_wait_s": self.est_wait_s,
             "inflight": len(self.inflight),
             "dispatched": self.dispatched}
        if age is not None:
            d["beat_age_s"] = round(age, 3)
        return d


class _Request:
    """One in-flight request record — the exactly-once unit.

    ``retried`` is the failover claim bit: every failure path calls
    :meth:`FederationFrontEnd._fail_over`, which atomically
    claims-or-waits on it, so at most ONE retry leg is ever
    dispatched for this request id. ``settled`` is the client-outcome
    bit: the first writer wins, every later writer discards its
    result, so the client sees exactly one response even when the
    original forward and the retry race to completion."""

    __slots__ = ("rid", "kind", "payload", "tried", "retried",
                 "settled", "status", "body", "error", "done")

    def __init__(self, rid: str, kind: str, payload: dict):
        self.rid = rid
        self.kind = kind
        self.payload = payload
        self.tried: Set[int] = set()
        self.retried = False
        self.settled = False
        self.status = 0
        self.body: dict = {}
        self.error: Optional[Exception] = None
        self.done = threading.Event()


class FederationFrontEnd(JsonHttpServer):
    """The routing front-end: membership, weighted least-loaded
    dispatch, typed exactly-once failover, rolling swap, config
    fan-out (see module docstring).

    ``health`` reuses the heartbeat plane's HealthConfig — only
    ``interval_s`` (eviction-sweep cadence) and ``timeout_s``
    (beats-dark eviction threshold) apply here. ``transport`` and
    ``clock`` are injectable for deterministic tests: transport is
    ``fn(url, payload_or_None, timeout_s) -> (status, body)`` raising
    OSError/URLError on a dead peer."""

    def __init__(self, *, port: int = 0, pool_size: int = 8,
                 health: Optional[HealthConfig] = None,
                 request_timeout_s: float = 30.0,
                 swap_timeout_s: float = 120.0,
                 drain_timeout_s: float = 10.0,
                 transport: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        super().__init__(
            get_routes={"/health": self._health_route,
                        "/replicas": self._replicas_route,
                        "/stats": self._stats_route},
            post_routes={"/predict": self._predict_route,
                         "/generate": self._generate_route,
                         "/swap": self._swap_route,
                         "/config": self._config_route,
                         "/beat": self._beat_route},
            port=port, pool_size=pool_size, expose_metrics=True)
        self.health = health or HealthConfig(interval_s=0.5,
                                             timeout_s=10.0)
        self.request_timeout_s = float(request_timeout_s)
        self.swap_timeout_s = float(swap_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self._transport = transport or _http_transport
        self._clock = clock
        self._lock = threading.RLock()
        self._replicas: Dict[int, _Replica] = {}
        # The heartbeat plane's beat table: replicas POST /beat into it,
        # the sweep evaluates it with the same beat_ages rule the
        # training watchdog uses.
        self._beats = InProcessBeatTransport(clock)
        self._rid_counter = 0
        self._requests = {"predict": 0, "generate": 0}
        self._swap_lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._sweeper: Optional[threading.Thread] = None
        register_metrics()
        reg = registry()
        self._pop_g = reg.gauge("serving_replicas",
                                _HELP["serving_replicas"])
        self._evict_c = reg.counter("serving_replica_evictions_total",
                                    _HELP["serving_replica_evictions_total"])
        self._retry_c = reg.counter("serving_failover_retries_total",
                                    _HELP["serving_failover_retries_total"])
        self._dispatch_c = reg.counter(
            "serving_replica_dispatch_total",
            _HELP["serving_replica_dispatch_total"])

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "FederationFrontEnd":
        super().start()
        self._stop_evt.clear()
        self._sweeper = threading.Thread(target=self._sweep_loop,
                                         daemon=True,
                                         name="federation-sweep")
        self._sweeper.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._sweeper
        self._sweeper = None
        if t is not None:
            t.join(timeout=5)
        super().stop()

    def _sweep_loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self.poll_once()
            except Exception:
                log.exception("federation sweep error (continuing)")
            self._stop_evt.wait(self.health.interval_s)

    # ----------------------------------------------------------- membership
    def _beat_route(self, payload: dict):
        """POST /beat — replica membership heartbeat. First beat from
        an unknown id registers it JOINING; a beat from a DEAD member
        is the rejoin path (recovered or replacement process — back to
        JOINING, routable again only once warmed). Load gauges ride
        every beat."""
        try:
            rid = int(payload["process_id"])
            url = str(payload["url"])
        except (KeyError, TypeError, ValueError):
            return 400, {"status": "error",
                         "error": "beat needs process_id and url"}
        self._beats.publish(payload)
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None:
                rep = self._replicas[rid] = _Replica(
                    rid, url, weight=float(payload.get("weight", 1.0)))
            rep.url = url
            if "weight" in payload:
                rep.weight = float(payload["weight"])
            rep.queue_depth = int(payload.get("queue_depth", 0))
            rep.est_wait_s = float(payload.get("est_wait_s", 0.0))
            rep.warmed = bool(payload.get("warmed", False))
            if rep.state == DEAD:
                rep.state = JOINING
            if rep.state == JOINING and rep.warmed:
                rep.state = HEALTHY
            self._refresh_population()
        return 200, {"ok": True, "state": rep.state,
                     "now": self._clock()}

    def poll_once(self) -> List[int]:
        """One eviction sweep over the beat table (the loop body;
        callable directly with a fake clock in tests). Returns the ids
        evicted this pass."""
        ages = beat_ages(self._beats.table())
        stale: List[_Replica] = []
        with self._lock:
            for rep in self._replicas.values():
                if rep.state == DEAD:
                    continue
                age = ages.get(str(rep.id))
                if age is not None and age > self.health.timeout_s:
                    stale.append(rep)
        for rep in stale:
            self._evict(rep, reason="beat_timeout")
        return [r.id for r in stale]

    def _evict(self, rep: _Replica, *, reason: str) -> None:
        """Remove a replica from the routable set and fail its
        in-flight requests typed — each through the same exactly-once
        failover gate the dispatch threads use, so a request whose
        connection error races this sweep still produces ONE retry and
        ONE client response."""
        with self._lock:
            if rep.state == DEAD:
                return
            rep.state = DEAD
            rep.warmed = False
            rep.evictions += 1
            inflight = list(rep.inflight)
            rep.inflight.clear()
            self._refresh_population()
        self._evict_c.labels(reason=reason).inc()
        log.warning("federation: evicted replica %d (%s), "
                    "%d in-flight to fail over", rep.id, reason,
                    len(inflight))
        for req in inflight:
            threading.Thread(
                target=self._fail_over, args=(req, rep),
                kwargs={"cause": ReplicaLostError(
                    f"replica {rep.id} evicted ({reason})",
                    replica=rep.id)},
                daemon=True, name=f"federation-failover-{req.rid}",
            ).start()

    def _refresh_population(self) -> None:
        # caller holds self._lock
        counts = {s: 0 for s in STATES}
        for rep in self._replicas.values():
            counts[rep.state] += 1
        for state, n in counts.items():
            self._pop_g.labels(state=state).set(float(n))

    def wait_for_replicas(self, n: int, timeout: float = 60.0) -> bool:
        """Block until `n` replicas are HEALTHY. Wall-clock bound, not
        fake-clock driven."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                healthy = sum(1 for r in self._replicas.values()
                              if r.state == HEALTHY)
            if healthy >= n:
                return True
            time.sleep(0.05)
        return False

    # ------------------------------------------------------------- dispatch
    def _pick(self, exclude: Set[int] = frozenset()) -> _Replica:
        """Weighted least-loaded choice among HEALTHY members:
        score = (1 + inflight + queue_depth) * (1 + est_wait_s) / weight,
        lowest wins (ties: lowest id, deterministic). Raises
        ReplicaLostError when no routable replica exists."""
        with self._lock:
            best: Optional[_Replica] = None
            best_score = float("inf")
            for rep in sorted(self._replicas.values(),
                              key=lambda r: r.id):
                if rep.state != HEALTHY or rep.id in exclude:
                    continue
                score = ((1.0 + len(rep.inflight) + rep.queue_depth)
                         * (1.0 + rep.est_wait_s) / rep.weight)
                if score < best_score:
                    best, best_score = rep, score
            if best is None:
                raise ReplicaLostError(
                    "no healthy replica available"
                    + (f" (excluding {sorted(exclude)})" if exclude
                       else ""))
            return best

    def _next_rid(self) -> str:
        with self._lock:
            self._rid_counter += 1
            return f"fe-{os.getpid()}-{self._rid_counter}"

    def _post_once(self, rep: _Replica, req: _Request) -> Tuple[int, dict]:
        """One dispatch leg: the route.dispatch chaos point, the
        per-replica counter, then the transport call. Raises
        FaultInjected (dropped leg) or OSError/URLError (dead
        replica)."""
        faults.fire("route.dispatch")
        self._dispatch_c.labels(replica=str(rep.id)).inc()
        with self._lock:
            rep.dispatched += 1
        return self._transport(rep.url + "/" + req.kind, req.payload,
                               self.request_timeout_s)

    def _settle(self, req: _Request, status: int, body: dict,
                error: Optional[Exception] = None) -> bool:
        """First writer wins; the client sees exactly one outcome."""
        with self._lock:
            if req.settled:
                return False
            req.settled = True
            req.status, req.body, req.error = status, body, error
        req.done.set()
        return True

    def _track(self, rep: _Replica, req: _Request) -> None:
        with self._lock:
            req.tried.add(rep.id)
            if rep.state != DEAD:
                rep.inflight.add(req)

    def _untrack(self, rep: _Replica, req: _Request) -> None:
        with self._lock:
            rep.inflight.discard(req)

    def _lost_body(self, err: ReplicaLostError, req: _Request) -> dict:
        body = {"status": "unavailable", "reason": "replica_lost",
                "error": str(err), "request_id": req.rid}
        if req.kind == "generate":
            body["tokens_so_far"] = err.tokens_so_far
        return body

    def dispatch(self, kind: str, payload: dict) -> Tuple[int, dict]:
        """Route one request (in-process entry point; the HTTP routes
        are thin wrappers). Returns (status, body) — replica-typed
        statuses pass through verbatim; a lost replica yields a typed
        503 ``replica_lost`` after the exactly-once failover gate."""
        payload = dict(payload)
        rid = str(payload.get("request_id") or self._next_rid())
        payload["request_id"] = rid
        req = _Request(rid, kind, payload)
        with self._lock:
            self._requests[kind] = self._requests.get(kind, 0) + 1
        rep = self._pick()  # ReplicaLostError propagates to the route
        self._track(rep, req)
        try:
            status, body = self._post_once(rep, req)
        except faults.FaultInjected as e:
            # A dropped ROUTE leg, not a dead replica: failover without
            # evicting the member.
            self._untrack(rep, req)
            return self._fail_over(req, rep, cause=e)
        except (OSError, urllib.error.URLError) as e:
            self._untrack(rep, req)
            self._evict(rep, reason="dispatch")
            return self._fail_over(req, rep, cause=e)
        self._untrack(rep, req)
        if self._settle(req, status, body):
            return status, body
        # The eviction sweep failed this request over while the
        # original forward was still completing; the settled outcome
        # is the client's answer (exactly one response).
        req.done.wait(timeout=self.request_timeout_s + 5.0)
        return req.status, req.body

    def _fail_over(self, req: _Request, from_rep: _Replica, *,
                   cause: Exception) -> Tuple[int, dict]:
        """The exactly-once failover gate. Atomically claims the
        request's single retry; a caller that loses the claim waits
        for the winner's outcome instead of dispatching again. predict
        retries on the least-loaded sibling; generate fails typed with
        tokens_so_far (never retried mid-stream)."""
        with self._lock:
            claimed = not req.retried
            req.retried = True
        if not claimed:
            req.done.wait(timeout=self.request_timeout_s + 5.0)
            if not req.done.is_set():
                err = ReplicaLostError(
                    f"request {req.rid}: failover outcome never "
                    f"arrived after replica {from_rep.id} was lost",
                    replica=from_rep.id)
                self._settle(req, 503, self._lost_body(err, req), err)
            return req.status, req.body
        if req.kind != "predict":
            self._retry_c.labels(outcome="decode_suppressed").inc()
            err = ReplicaLostError(
                f"replica {from_rep.id} lost mid-decode ({cause}); "
                "decode requests are never retried on a sibling — "
                "resume from tokens_so_far", replica=from_rep.id,
                tokens_so_far=[])
            self._settle(req, 503, self._lost_body(err, req), err)
            return req.status, req.body
        try:
            sib = self._pick(exclude=set(req.tried))
        except ReplicaLostError as e:
            self._retry_c.labels(outcome="no_sibling").inc()
            err = ReplicaLostError(
                f"replica {from_rep.id} lost ({cause}) and {e}",
                replica=from_rep.id)
            self._settle(req, 503, self._lost_body(err, req), err)
            return req.status, req.body
        self._track(sib, req)
        try:
            status, body = self._post_once(sib, req)
        except (faults.FaultInjected, OSError,
                urllib.error.URLError) as e:
            self._untrack(sib, req)
            if not isinstance(e, faults.FaultInjected):
                self._evict(sib, reason="dispatch")
            self._retry_c.labels(outcome="failed").inc()
            err = ReplicaLostError(
                f"replica {from_rep.id} lost ({cause}); retry on "
                f"sibling {sib.id} also failed ({e})", replica=sib.id)
            self._settle(req, 503, self._lost_body(err, req), err)
        else:
            self._untrack(sib, req)
            self._retry_c.labels(outcome="ok").inc()
            self._settle(req, status, body)
        return req.status, req.body

    # ---------------------------------------------------------- HTTP routes
    def _predict_route(self, req: dict):
        try:
            return self.dispatch("predict", req)
        except ReplicaLostError as e:
            return 503, {"status": "unavailable", "reason": "replica_lost",
                         "error": str(e)}

    def _generate_route(self, req: dict):
        try:
            return self.dispatch("generate", req)
        except ReplicaLostError as e:
            return 503, {"status": "unavailable", "reason": "replica_lost",
                         "error": str(e), "tokens_so_far": e.tokens_so_far}

    def _health_route(self, _):
        with self._lock:
            counts = {s: 0 for s in STATES}
            for rep in self._replicas.values():
                counts[rep.state] += 1
        healthy = counts[HEALTHY]
        status = ("ok" if healthy and healthy == sum(counts.values())
                  else "degraded" if healthy else "down")
        return 200, {"status": status, "replicas": counts}

    def _replicas_route(self, _):
        ages = beat_ages(self._beats.table())
        with self._lock:
            reps = [r.describe(ages.get(str(r.id)))
                    for r in sorted(self._replicas.values(),
                                    key=lambda r: r.id)]
        return 200, {"replicas": reps, "now": self._clock()}

    def _stats_route(self, _):
        ages = beat_ages(self._beats.table())
        with self._lock:
            reps = [r.describe(ages.get(str(r.id)))
                    for r in sorted(self._replicas.values(),
                                    key=lambda r: r.id)]
            requests = dict(self._requests)
        return 200, {
            "replicas": reps, "requests": requests,
            "evictions": int(self._evict_c.total()),
            "failover_retries": int(self._retry_c.total()),
            "timeout_s": self.health.timeout_s,
            "interval_s": self.health.interval_s}

    # ---------------------------------------------------------- rolling swap
    def _swap_route(self, req: dict):
        """POST /swap — rolling checkpoint deploy across the fleet.
        Canary on ONE replica (traffic steered away first, its own
        golden-batch gate decides), then promote the rest one at a
        time the same way. Any rejection aborts the roll: the failing
        replica's params are already rolled back bitwise by its own
        swap protocol, later replicas are untouched, earlier ones keep
        the new checkpoint (reported, so the operator can re-roll or
        roll back)."""
        if not self._swap_lock.acquire(blocking=False):
            return 409, {"status": "swap_failed",
                         "error": "another rolling swap is in progress"}
        try:
            with self._lock:
                targets = sorted(
                    (r for r in self._replicas.values()
                     if r.state == HEALTHY), key=lambda r: r.id)
            if not targets:
                return 503, {"status": "unavailable",
                             "reason": "replica_lost",
                             "error": "no healthy replica to swap"}
            swapped: List[int] = []
            results: Dict[str, Any] = {}
            for i, rep in enumerate(targets):
                stage = "canary" if i == 0 else "promote"
                out = self._swap_one(rep, req, stage)
                if out is not None:  # typed abort
                    out["swapped"] = swapped
                    return 409, out
                swapped.append(rep.id)
                results[str(rep.id)] = {"stage": stage, "ok": True}
            return 200, {"status": "ok", "canary": targets[0].id,
                         "swapped": swapped, "replicas": results}
        finally:
            self._swap_lock.release()

    def _swap_one(self, rep: _Replica, req: dict,
                  stage: str) -> Optional[dict]:
        """One zero-traffic swap leg: steer away, drain, swap,
        restore. Returns None on success, a typed abort body on
        failure (with the replica back HEALTHY when it is alive and
        bitwise-rolled-back, DEAD when it died mid-swap)."""
        with self._lock:
            if rep.state != HEALTHY:
                return {"status": "swap_failed", "stage": stage,
                        "replica": rep.id,
                        "error": f"replica {rep.id} left the healthy "
                                 f"set mid-roll ({rep.state})"}
            rep.state = DRAINING
            self._refresh_population()
        try:
            if not self._wait_drained(rep):
                return {"status": "swap_failed", "stage": stage,
                        "replica": rep.id,
                        "error": f"replica {rep.id} still had in-flight "
                                 f"requests after {self.drain_timeout_s}s "
                                 "drain window"}
            try:
                status, body = self._transport(
                    rep.url + "/swap", req, self.swap_timeout_s)
            except (OSError, urllib.error.URLError) as e:
                self._evict(rep, reason="dispatch")
                return {"status": "swap_failed", "stage": stage,
                        "replica": rep.id,
                        "error": f"replica {rep.id} died mid-swap: {e}"}
            if status != 200:
                return {"status": "swap_failed", "stage": stage,
                        "replica": rep.id, "detail": body,
                        "error": body.get("error",
                                          f"replica swap HTTP {status}")}
            return None
        finally:
            with self._lock:
                if rep.state == DRAINING:
                    rep.state = HEALTHY
                self._refresh_population()

    def _wait_drained(self, rep: _Replica) -> bool:
        deadline = time.monotonic() + self.drain_timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if not rep.inflight:
                    return True
            time.sleep(0.01)
        with self._lock:
            return not rep.inflight

    # --------------------------------------------------------------- config
    def _config_route(self, req: dict):
        """POST /config — fan the reconfiguration out to every live
        replica (the fleet must stay homogeneous, or least-loaded
        routing would chase config skew). ``replica`` (an id) targets
        one member instead. Response carries each replica's verdict;
        the worst status wins."""
        req = dict(req)
        target = req.pop("replica", None)
        with self._lock:
            reps = sorted((r for r in self._replicas.values()
                           if r.state in (HEALTHY, DRAINING, JOINING)),
                          key=lambda r: r.id)
            if target is not None:
                reps = [r for r in reps if r.id == int(target)]
        if not reps:
            return 503, {"status": "unavailable", "reason": "replica_lost",
                         "error": "no live replica to configure"
                         if target is None else
                         f"no live replica with id {target}"}
        worst = 200
        per: Dict[str, Any] = {}
        for rep in reps:
            try:
                status, body = self._transport(
                    rep.url + "/config", req, self.request_timeout_s)
            except (OSError, urllib.error.URLError) as e:
                status, body = 503, {"status": "error", "error": str(e)}
            per[str(rep.id)] = {"code": status, **body}
            if status != 200 and worst == 200:
                worst = status
        return worst, {"status": "ok" if worst == 200 else "error",
                       "replicas": per}


# ---------------------------------------------------------------------------
# Replica side
# ---------------------------------------------------------------------------

class ReplicaServer:
    """The replica-side beat publisher: a daemon thread that samples
    the local gateway's admission load (ServingGateway.load()) and
    POSTs a ``kind="replica"`` beat to the front-end every
    ``interval_s``. The gateway itself is untouched — a replica is a
    plain single-process gateway plus this thread. ``mark_warmed()``
    flips the beat's ``warmed`` bit, which is what admits the replica
    to the routable set (call it after warmup so a joining replica
    never takes traffic it would have to compile for)."""

    def __init__(self, gateway, *, replica_id: int, frontend_url: str,
                 interval_s: float = 0.5, weight: float = 1.0,
                 beat_timeout_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic,
                 transport: Optional[Callable] = None):
        self.gateway = gateway
        self.replica_id = int(replica_id)
        self.frontend_url = frontend_url.rstrip("/")
        self.interval_s = float(interval_s)
        self.weight = float(weight)
        self.beat_timeout_s = float(beat_timeout_s)
        self._clock = clock
        self._transport = transport
        self._warmed = False
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.beat_failures = 0

    def mark_warmed(self) -> None:
        self._warmed = True

    def beat_once(self) -> None:
        """One beat publish. The ``replica.beat`` chaos point fires
        first: ``fail:`` suppresses the beat (the replica goes dark —
        the eviction drill), ``delay:`` slows the channel."""
        faults.fire("replica.beat")
        beat = {"process_id": self.replica_id, "kind": KIND_REPLICA,
                "url": self.gateway.url, "warmed": self._warmed,
                "weight": self.weight, "send_ts": self._clock()}
        beat.update(self.gateway.load())
        if self._transport is not None:
            self._transport(self.frontend_url + "/beat", beat,
                            self.beat_timeout_s)
        else:
            json_request(self.frontend_url + "/beat", beat,
                         timeout=self.beat_timeout_s)

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self.beat_once()
            except Exception as e:  # never kill the publisher
                # single writer: only this beat thread ever bumps it
                self.beat_failures += 1  # jaxlint: atomic
                log.debug("replica %d beat failed: %s",
                          self.replica_id, e)
            self._stop_evt.wait(self.interval_s)

    def start(self) -> "ReplicaServer":
        if self._thread is None:
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"replica-beat-{self.replica_id}")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=5)


def default_builder(gateway) -> None:
    """The stock replica model: a tiny MLP from a fixed seed, so every
    replica of a fleet built this way serves the same parameters. Geometry,
    device and engine knobs come from the environment, so a parent process
    shapes the fleet without a builder of its own:

        DL4JTPU_REPLICA_N_IN / _HIDDEN / _N_OUT   model geometry
        DL4JTPU_REPLICA_DEVICE                    device (default: CUDA)
        DL4JTPU_REPLICA_BATCH_LIMIT               rows per forward
        DL4JTPU_REPLICA_BATCH_TIMEOUT_MS          collector linger
        DL4JTPU_REPLICA_QUEUE_LIMIT               admission queue bound
        DL4JTPU_REPLICA_CKPT_DIR                  checkpoint dir (arms
                                                  hot swap)
        DL4JTPU_REPLICA_CANARY_DRIFT              canary max drift
    """
    from .. import (Adam, DenseLayer, InputType, MultiLayerNetwork,
                    NeuralNetConfiguration, OutputLayer, WeightInit)
    env = os.environ.get
    n_in = int(env("DL4JTPU_REPLICA_N_IN", "16"))
    hidden = int(env("DL4JTPU_REPLICA_HIDDEN", "32"))
    n_out = int(env("DL4JTPU_REPLICA_N_OUT", "4"))
    conf = (NeuralNetConfiguration.builder().seed(42)
            .updater(Adam(1e-3)).weight_init(WeightInit.XAVIER).list()
            .layer(DenseLayer(n_out=hidden, activation="relu"))
            .layer(OutputLayer(n_out=n_out, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(n_in))
            .build())
    net = MultiLayerNetwork(conf).init(device=env("DL4JTPU_REPLICA_DEVICE"))
    kw: Dict[str, Any] = dict(
        batch_limit=int(env("DL4JTPU_REPLICA_BATCH_LIMIT", "4")),
        batch_timeout_ms=float(
            env("DL4JTPU_REPLICA_BATCH_TIMEOUT_MS", "10.0")),
        queue_limit=int(env("DL4JTPU_REPLICA_QUEUE_LIMIT", "256")))
    ckpt_dir = env("DL4JTPU_REPLICA_CKPT_DIR")
    if ckpt_dir:
        kw["checkpoints"] = ckpt_dir
    drift = env("DL4JTPU_REPLICA_CANARY_DRIFT")
    if drift:
        kw["canary_max_drift"] = float(drift)
    gateway.add_model("default", net, **kw)


def serve_replica(build: Callable, *, replica_id: int,
                  frontend_url: str, port: int = 0,
                  interval_s: float = 0.5, weight: float = 1.0,
                  warmup: bool = True, gateway_kw: Optional[dict] = None):
    """Stand up one replica: a full ServingGateway on its own port
    (``build(gateway)`` registers the models), warmed BEFORE the beat
    says so — a joining replica becomes routable only once its
    compiles are behind it. Returns (gateway, replica_server), both
    started."""
    from .gateway import ServingGateway
    gw = ServingGateway(port=port, **(gateway_kw or {}))
    build(gw)
    gw.start()
    rs = ReplicaServer(gw, replica_id=replica_id,
                       frontend_url=frontend_url,
                       interval_s=interval_s, weight=weight)
    rs.start()  # beat unwarmed immediately: membership sees JOINING
    if warmup:
        gw.warmup()
    rs.mark_warmed()
    return gw, rs


def spawn_replica(replica_id: int, frontend_url: str, *,
                  builder: Optional[str] = None, port: int = 0,
                  interval_s: float = 0.5, env: Optional[dict] = None):
    """Spawn a replica subprocess running this module's main (callers
    SIGKILL the handle for chaos drills). `builder` is a ``pkg.mod:fn``
    import path (default: the stock builder); `env` overlays the child's
    environment (DL4JTPU_REPLICA_* geometry and device, DL4JTPU_FAULT_*
    arming). Readiness is observed through the front end's beat table
    (wait_for_replicas), not stdout."""
    import subprocess
    # -c instead of -m: the parent has usually already imported
    # serving.federation, and runpy warns when re-executing a module
    # that is live in sys.modules.
    cmd = [sys.executable, "-c",
           "import sys; from deeplearning4j_torch.serving.federation "
           "import main; sys.exit(main(sys.argv[1:]))",
           "--replica-id", str(int(replica_id)),
           "--frontend", frontend_url,
           "--port", str(int(port)),
           "--interval-s", str(float(interval_s))]
    if builder:
        cmd += ["--builder", builder]
    child_env = dict(os.environ)
    child_env.update(env or {})
    return subprocess.Popen(cmd, env=child_env)


def _resolve_builder(spec: str) -> Callable:
    import importlib
    mod_name, _, fn_name = spec.partition(":")
    if not fn_name:
        raise SystemExit(f"--builder {spec!r} must be 'pkg.mod:fn'")
    return getattr(importlib.import_module(mod_name), fn_name)


def main(argv: Optional[List[str]] = None) -> int:
    """Replica process entry point (see module docstring)."""
    import argparse
    import signal as _signal
    p = argparse.ArgumentParser(
        description="deeplearning4j_torch federation replica")
    p.add_argument("--replica-id", type=int, required=True)
    p.add_argument("--frontend", required=True,
                   help="front-end base URL (http://host:port)")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--builder",
                   default="deeplearning4j_torch.serving.federation"
                           ":default_builder")
    p.add_argument("--interval-s", type=float, default=0.5)
    args = p.parse_args(argv)
    build = _resolve_builder(args.builder)
    gw, rs = serve_replica(build, replica_id=args.replica_id,
                           frontend_url=args.frontend, port=args.port,
                           interval_s=args.interval_s)
    print(f"REPLICA_READY {args.replica_id} {gw.port}", flush=True)
    stop = threading.Event()
    for sig in (_signal.SIGTERM, _signal.SIGINT):
        _signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    rs.stop()
    gw.pool.shutdown()
    gw.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
