"""The port's replica federation against the JAX package's.

The in-process cases of tests/test_federation.py: each scenario runs
through both packages' FederationFrontEnd, each wired to a fake fleet
(a recording transport with scripted replica behaviour and a hand-cranked
clock), and the status codes, bodies, legs, membership states and
/replicas must come out the same. Then the replica-side beat publisher
and the port's ServingGateway.load() on their own."""
import json
import threading
import time
import urllib.error

import numpy as np
import pytest

from deeplearning4j_tpu.optimize.metrics import registry as jax_registry
from deeplearning4j_tpu.parallel import cluster_health as jch
from deeplearning4j_tpu.serving import federation as jfed
from deeplearning4j_tpu.utils import faults as jfaults
from deeplearning4j_torch.optimize.metrics import registry as torch_registry
from deeplearning4j_torch.parallel import cluster_health as tch
from deeplearning4j_torch.parallel.inference import ServerClosedError
from deeplearning4j_torch.serving import federation as tfed
from deeplearning4j_torch.utils import faults as tfaults

PACKAGES = {"jax": (jfed, jch, jfaults, jax_registry),
            "torch": (tfed, tch, tfaults, torch_registry)}


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


class FakeFleet:
    """A front end wired to an in-memory fleet: the transport records every
    leg, replica behaviour is scripted, the clock is a float."""

    def __init__(self, fed, ch, *, timeout_s=5.0, **fe_kw):
        self.fed = fed
        self.now = [0.0]
        self.calls = []
        self.dead = set()
        self.responses = {}
        self.blocks = {}
        self.lock = threading.Lock()
        self.fe = fed.FederationFrontEnd(
            health=ch.HealthConfig(interval_s=0.5, timeout_s=timeout_s),
            transport=self._transport, clock=lambda: self.now[0], **fe_kw)

    def _transport(self, url, payload, timeout):
        rid = int(url.split("//r")[1].split("/")[0])
        route = url.rsplit("/", 1)[1]
        with self.lock:
            self.calls.append((rid, route, payload))
        gate = self.blocks.get((rid, route))
        if gate is not None:
            assert gate.wait(timeout=10), "blocked transport never freed"
        if rid in self.dead:
            raise urllib.error.URLError("connection refused")
        scripted = self.responses.get((rid, route))
        if scripted is not None:
            return scripted
        return 200, {"status": "ok", "replica": rid,
                     "request_id": (payload or {}).get("request_id")}

    def beat(self, rid, *, warmed=True, queue_depth=0, est_wait_s=0.0,
             weight=1.0):
        return self.fe._beat_route({
            "process_id": rid, "kind": "replica", "url": f"http://r{rid}",
            "warmed": warmed, "queue_depth": queue_depth,
            "est_wait_s": est_wait_s, "weight": weight,
            "send_ts": self.now[0]})

    def join(self, *rids, **kw):
        for rid in rids:
            code, body = self.beat(rid, **kw)
            assert code == 200 and body["state"] == self.fed.HEALTHY, body

    def state(self, rid):
        with self.fe._lock:
            return self.fe._replicas[rid].state

    def states(self):
        with self.fe._lock:
            return {r: rep.state for r, rep in sorted(self.fe._replicas.items())}

    def legs(self, route=None):
        with self.lock:
            return [(c[0], c[1]) for c in self.calls
                    if route is None or c[1] == route]

    def replicas(self):
        code, body = self.fe._replicas_route(None)
        return code, body["replicas"]


def both(scenario):
    """The scenario's transcript through each package; they must agree."""
    out = {}
    for name, (fed, ch, faults, reg) in PACKAGES.items():
        out[name] = json.loads(json.dumps(scenario(fed, ch, faults, reg),
                                          default=str))
    assert out["jax"] == out["torch"], out
    return out["torch"]


def retries(reg, outcome):
    return reg().counter("serving_failover_retries_total", "").total(
        outcome=outcome)


# ---------------------------------------------------------------------------
# The typed chain and the names
# ---------------------------------------------------------------------------

def test_replica_lost_is_server_closed():
    e = tfed.ReplicaLostError("gone", replica=3, tokens_so_far=[1, 2])
    assert isinstance(e, ServerClosedError) and e.transient
    assert e.replica == 3 and e.tokens_so_far == [1, 2]
    assert tfed.ReplicaLostError("x").tokens_so_far == []
    assert (tfed.JOINING, tfed.HEALTHY, tfed.DRAINING, tfed.DEAD) == \
        (jfed.JOINING, jfed.HEALTHY, jfed.DRAINING, jfed.DEAD)
    assert tfed.__all__ == jfed.__all__


# ---------------------------------------------------------------------------
# Membership
# ---------------------------------------------------------------------------

def test_joining_until_warmed_then_routable():
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch)
        a = fl.beat(0, warmed=False)
        b = fl.fe._predict_route({"inputs": [1]})
        c = fl.beat(0, warmed=True)
        d = fl.fe._predict_route({"inputs": [1]})
        for r in (a, c):
            r[1].pop("now")
        return a, b, c, d, fl.replicas()
    a, b, c, d, reps = both(scenario)
    assert a[1]["state"] == "joining" and b[0] == 503
    assert c[1]["state"] == "healthy" and d[0] == 200 and d[1]["replica"] == 0


def test_beat_requires_identity():
    assert both(lambda fed, ch, f, r: FakeFleet(fed, ch).fe._beat_route(
        {"url": "http://r0"}))[0] == 400


def test_fake_clock_eviction_and_rejoin():
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch, timeout_s=5.0)
        fl.join(0, 1)
        fl.now[0] = 3.0
        fl.beat(1)
        fl.now[0] = 6.0
        log = [fl.fe.poll_once(), fl.states(), fl.fe.poll_once(),
               fl.replicas()]
        log.append(fl.beat(0, warmed=False)[1]["state"])
        log.append(fl.beat(0, warmed=True)[1]["state"])
        return log
    log = both(scenario)
    assert log[0] == [0] and log[1] == {"0": "dead", "1": "healthy"}
    assert log[2] == [] and log[4:] == ["joining", "healthy"]


def test_beats_refresh_load_and_population_gauge():
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch)
        fl.join(0)
        fl.beat(0, queue_depth=7, est_wait_s=0.25)
        g = reg().gauge("serving_replicas", "")
        return fl.replicas(), g.value(state="healthy") >= 1.0
    (_, reps), gauge = both(scenario)
    assert reps[0]["queue_depth"] == 7 and reps[0]["est_wait_s"] == 0.25
    assert gauge


def test_health_route_tracks_population():
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch)
        log = [fl.fe._health_route(None)]
        fl.join(0, 1)
        log.append(fl.fe._health_route(None))
        fl.dead.add(1)
        fl.beat(0, queue_depth=10)
        fl.fe.dispatch("predict", {"inputs": [1]})
        log.append(fl.fe._health_route(None))
        return log
    log = both(scenario)
    assert [b["status"] for _, b in log] == ["down", "ok", "degraded"]
    assert log[2][1]["replicas"]["dead"] == 1


# ---------------------------------------------------------------------------
# Least-loaded dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beats,expect", [
    ([(0, dict(queue_depth=10))], 1),
    ([(0, dict(est_wait_s=2.0))], 1),
    ([(0, dict(queue_depth=2, weight=1.0)), (1, dict(queue_depth=2,
                                                     weight=4.0))], 1),
    ([(1, dict(queue_depth=3)), (0, dict(queue_depth=1, est_wait_s=0.5))], 0),
    ([], 0),
], ids=["depth", "wait_breaks_ties", "weight", "score", "lowest_id"])
def test_least_loaded_routing(beats, expect):
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch)
        fl.join(0, 1)
        for rid, kw in beats:
            fl.beat(rid, **kw)
        return fl.fe.dispatch("predict", {"inputs": [1]})
    assert both(scenario)[1]["replica"] == expect


def test_typed_replica_status_passes_through():
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch)
        fl.join(0)
        fl.responses[(0, "predict")] = (429, {"status": "shed",
                                              "reason": "queue_full"})
        return fl.fe.dispatch("predict", {"inputs": [1]}), fl.state(0), \
            fl.legs("predict")
    (code, body), state, legs = both(scenario)
    assert (code, body["reason"]) == (429, "queue_full")
    assert state == "healthy" and len(legs) == 1


def test_request_id_assigned_and_forwarded():
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch)
        fl.join(0)
        _, a = fl.fe.dispatch("predict", {"inputs": [1]})
        sent = fl.calls[0][2]["request_id"]
        _, b = fl.fe.dispatch("predict", {"request_id": "mine"})
        return a["request_id"] == sent, a["request_id"].split("-")[0], \
            b["request_id"]
    assert both(scenario) == [True, "fe", "mine"]


# ---------------------------------------------------------------------------
# Exactly-once failover
# ---------------------------------------------------------------------------

def test_dead_replica_evicted_and_retried_once_on_sibling():
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch)
        fl.join(0, 1)
        fl.dead.add(0)
        fl.beat(1, queue_depth=10)
        before = retries(reg, "ok")
        out = fl.fe.dispatch("predict", {"inputs": [1]})
        return out[0], out[1]["replica"], fl.states(), fl.legs("predict"), \
            retries(reg, "ok") - before
    code, rep, states, legs, n = both(scenario)
    assert code == 200 and rep == 1 and states["0"] == "dead"
    assert [l[0] for l in legs] == [0, 1] and n == 1


def test_failed_retry_is_typed_and_final():
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch)
        fl.join(0, 1)
        fl.dead.update({0, 1})
        code, body = fl.fe.dispatch("predict", {"inputs": [1]})
        return code, body, fl.legs("predict"), fl.states()
    code, body, legs, states = both(scenario)
    assert code == 503 and body["reason"] == "replica_lost"
    assert "request_id" in body and len(legs) == 2
    assert states == {"0": "dead", "1": "dead"}


def test_no_sibling_is_typed():
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch)
        fl.join(0)
        fl.dead.add(0)
        before = retries(reg, "no_sibling")
        out = fl.fe.dispatch("predict", {"inputs": [1]})
        return out, retries(reg, "no_sibling") - before
    (code, body), n = both(scenario)
    assert code == 503 and body["reason"] == "replica_lost" and n == 1


def test_generate_never_retried_mid_stream():
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch)
        fl.join(0, 1)
        fl.dead.add(0)
        fl.beat(1, queue_depth=10)
        before = retries(reg, "decode_suppressed")
        out = fl.fe.dispatch("generate", {"prompt": [1, 2]})
        return out, fl.legs("generate"), \
            retries(reg, "decode_suppressed") - before
    (code, body), legs, n = both(scenario)
    assert code == 503 and body["reason"] == "replica_lost"
    assert body["tokens_so_far"] == [] and [l[0] for l in legs] == [0]
    assert n == 1


def test_generate_route_with_no_replica_is_typed():
    def scenario(fed, ch, faults, reg):
        return FakeFleet(fed, ch).fe._generate_route({"prompt": [1]})
    code, body = both(scenario)
    assert code == 503 and body["tokens_so_far"] == []


def test_eviction_sweep_fails_over_inflight_request():
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch)
        fl.join(0, 1)
        fl.beat(1, queue_depth=10)
        gate = threading.Event()
        fl.blocks[(0, "predict")] = gate
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "r", fl.fe.dispatch("predict", {"inputs": [1]})))
        t.start()
        deadline = time.monotonic() + 5
        while not fl.legs("predict") and time.monotonic() < deadline:
            time.sleep(0.005)
        with fl.fe._lock:
            rep0 = fl.fe._replicas[0]
        fl.fe._evict(rep0, reason="beat_timeout")
        deadline = time.monotonic() + 5
        while len(fl.legs("predict")) < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        gate.set()
        t.join(timeout=10)
        return out["r"][0], out["r"][1]["replica"], fl.legs("predict")
    assert both(scenario) == [200, 1, [[0, "predict"], [1, "predict"]]]


def test_concurrent_failover_signals_retry_exactly_once():
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch)
        fl.join(0, 1)
        slow = threading.Event()
        fl.blocks[(1, "predict")] = slow
        r = fed._Request("rid-1", "predict", {"request_id": "rid-1"})
        r.tried.add(0)
        with fl.fe._lock:
            rep0 = fl.fe._replicas[0]
        results = []
        cause = fed.ReplicaLostError("boom", replica=0)
        ts = [threading.Thread(target=lambda: results.append(
            fl.fe._fail_over(r, rep0, cause=cause))) for _ in range(4)]
        for t in ts:
            t.start()
        time.sleep(0.1)
        slow.set()
        for t in ts:
            t.join(timeout=10)
        return len(fl.legs("predict")), len({json.dumps(x, sort_keys=True)
                                             for x in results})
    assert both(scenario) == [1, 1]


def test_route_dispatch_fault_fails_over_without_evicting():
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch)
        fl.join(0, 1)
        fl.beat(1, queue_depth=10)
        with faults.injected("route.dispatch", "fail:1"):
            code, body = fl.fe.dispatch("predict", {"inputs": [1]})
            fired = faults.fired_count("route.dispatch")
        return code, body["replica"], fired, fl.states()
    assert both(scenario) == [200, 1, 1, {"0": "healthy", "1": "healthy"}]


# ---------------------------------------------------------------------------
# Rolling swap
# ---------------------------------------------------------------------------

def test_canary_then_promote_with_traffic_steered_away():
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch)
        fl.join(0, 1, 2)
        at_swap = {}

        def scripted(url, payload, timeout):
            rid = int(url.split("//r")[1].split("/")[0])
            route = url.rsplit("/", 1)[1]
            fl.calls.append((rid, route, payload))
            if route == "swap":
                at_swap[rid] = fl.state(rid)
                return 200, {"status": "ok", "version": 2}
            return 200, {"status": "ok", "replica": rid}
        fl.fe._transport = scripted
        out = fl.fe._swap_route({"model": "default", "checkpoint": "ckpt-2"})
        sent = [c[2]["checkpoint"] for c in fl.calls if c[1] == "swap"]
        return out, at_swap, fl.states(), sent
    (code, body), at_swap, states, sent = both(scenario)
    assert code == 200 and body["canary"] == 0 and body["swapped"] == [0, 1, 2]
    assert set(at_swap.values()) == {"draining"}
    assert set(states.values()) == {"healthy"} and sent == ["ckpt-2"] * 3


@pytest.mark.parametrize("failing,stage,swapped", [
    (0, "canary", []), (1, "promote", [0])])
def test_rejected_leg_aborts_the_roll(failing, stage, swapped):
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch)
        fl.join(0, 1, 2)
        fl.responses[(failing, "swap")] = (
            409, {"status": "swap_failed", "error": "canary drift 0.9"})
        return fl.fe._swap_route({"checkpoint": "bad"}), fl.legs("swap"), \
            fl.states()
    (code, body), legs, states = both(scenario)
    assert code == 409 and body["stage"] == stage
    assert body["replica"] == failing and body["swapped"] == swapped
    assert [l[0] for l in legs] == list(range(failing + 1))
    assert set(states.values()) == {"healthy"}


def test_drain_timeout_aborts_typed():
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch)
        fl.fe.drain_timeout_s = 0.05
        fl.join(0)
        with fl.fe._lock:
            fl.fe._replicas[0].inflight.add(fed._Request("stuck", "predict",
                                                         {}))
        return fl.fe._swap_route({"checkpoint": "c"}), fl.legs("swap"), \
            fl.state(0)
    (code, body), legs, state = both(scenario)
    assert code == 409 and body["stage"] == "canary" and "drain" in body["error"]
    assert legs == [] and state == "healthy"


def test_replica_death_mid_swap_evicts_and_aborts():
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch)
        fl.join(0, 1)
        real = fl._transport

        def dying(url, payload, timeout):
            if url.endswith("/swap"):
                raise urllib.error.URLError("reset by peer")
            return real(url, payload, timeout)
        fl.fe._transport = dying
        return fl.fe._swap_route({"checkpoint": "c"}), fl.states()
    (code, body), states = both(scenario)
    assert code == 409 and "died mid-swap" in body["error"]
    assert states == {"0": "dead", "1": "healthy"}


def test_concurrent_roll_rejected_and_empty_fleet_typed():
    def scenario(fed, ch, faults, reg):
        empty = FakeFleet(fed, ch).fe._swap_route({"checkpoint": "c"})
        fl = FakeFleet(fed, ch)
        fl.join(0)
        fl.fe._swap_lock.acquire()
        try:
            busy = fl.fe._swap_route({"checkpoint": "c"})
        finally:
            fl.fe._swap_lock.release()
        return empty, busy
    (c1, b1), (c2, b2) = both(scenario)
    assert c1 == 503 and b1["reason"] == "replica_lost"
    assert c2 == 409 and "in progress" in b2["error"]


# ---------------------------------------------------------------------------
# /config fan-out
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("script,request_", [
    ({}, {"model": "default", "breaker_threshold": 8}),
    ({1: (400, {"status": "error", "error": "unknown_knob"})},
     {"model": "m", "weight": 2.0}),
    ({}, {"model": "m", "weight": 2.0, "replica": 1}),
    ({}, {"model": "m", "replica": 7}),
], ids=["all", "worst_status", "one_replica", "unknown_replica"])
def test_config_fan_out(script, request_):
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch)
        fl.join(0, 1)
        for rid, resp in script.items():
            fl.responses[(rid, "config")] = resp
        out = fl.fe._config_route(dict(request_))
        sent = [c[2] for c in fl.calls if c[1] == "config"]
        return out, sent
    (code, body), sent = both(scenario)
    if "replica" in request_:
        assert all("replica" not in s for s in sent)
    if request_.get("replica") == 7:
        assert code == 503
    elif script:
        assert code == 400 and body["replicas"]["0"]["code"] == 200
    else:
        assert code == 200


def test_stats_route_matches():
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch)
        fl.join(0, 1)
        fl.fe.dispatch("predict", {"inputs": [1]})
        fl.fe.dispatch("generate", {"prompt": [1]})
        code, body = fl.fe._stats_route(None)
        body.pop("evictions"), body.pop("failover_retries")
        return code, body
    code, body = both(scenario)
    assert body["requests"] == {"predict": 1, "generate": 1}


# ---------------------------------------------------------------------------
# The replica side
# ---------------------------------------------------------------------------

class _StubGateway:
    url = "http://replica:1"

    def load(self):
        return {"queue_depth": 3, "est_wait_s": 0.125}


def test_beat_payload_carries_kind_load_and_warmth():
    def scenario(fed, ch, faults, reg):
        sent = []
        rs = fed.ReplicaServer(_StubGateway(), replica_id=4,
                               frontend_url="http://fe",
                               transport=lambda u, p, t: sent.append((u, p)))
        rs.beat_once()
        rs.mark_warmed()
        rs.beat_once()
        for _, p in sent:
            p.pop("send_ts")
        return sent
    sent = both(scenario)
    url, beat = sent[0]
    assert url == "http://fe/beat" and beat["kind"] == "replica"
    assert beat["process_id"] == 4 and beat["queue_depth"] == 3
    assert beat["warmed"] is False and sent[1][1]["warmed"] is True


def test_replica_beat_fault_suppresses_then_evicts():
    def scenario(fed, ch, faults, reg):
        fl = FakeFleet(fed, ch, timeout_s=5.0)
        rs = fed.ReplicaServer(_StubGateway(), replica_id=0,
                               frontend_url="http://fe",
                               transport=lambda u, p, t: fl.fe._beat_route(p))
        rs.mark_warmed()
        rs.beat_once()
        first = fl.state(0)
        with faults.injected("replica.beat", "fail:*"):
            for _ in range(3):
                with pytest.raises(faults.FaultInjected):
                    rs.beat_once()
        fl.now[0] = 6.0
        return first, fl.fe.poll_once(), fl.state(0)
    assert both(scenario) == ["healthy", [0], "dead"]


def test_beat_loop_survives_transport_failures():
    def broken(u, p, t):
        raise ConnectionError("fe down")
    rs = tfed.ReplicaServer(_StubGateway(), replica_id=0,
                            frontend_url="http://fe", interval_s=0.01,
                            transport=broken)
    rs.start()
    deadline = time.monotonic() + 5
    while rs.beat_failures < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    rs.stop()
    assert rs.beat_failures >= 3


def test_gateway_load_aggregates_entry_queues():
    """The port's ServingGateway.load(): the summed queue depth and the
    worst wait estimate, what a replica rides on its beats."""
    from deeplearning4j_torch.serving import ServingGateway
    from test_torch_model_pool import port_twin
    from test_serving_gateway import make_net

    gate = threading.Event()
    net = port_twin(make_net())
    inner = net.output

    def slow(x, *a, **k):
        gate.wait(10)
        return inner(x, *a, **k)
    net.output = slow
    gw = ServingGateway()
    gw.add_model("m", net, batch_limit=1, queue_limit=64)
    try:
        assert gw.load() == {"queue_depth": 0, "est_wait_s": 0.0}
        x = np.zeros((1, 4), np.float32)
        ts = [threading.Thread(target=lambda: gw.predict("m", x))
              for _ in range(4)]
        for t in ts:
            t.start()
        deadline = time.monotonic() + 5
        while gw.load()["queue_depth"] < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert gw.load()["queue_depth"] >= 1
        gate.set()
        for t in ts:
            t.join(timeout=10)
    finally:
        gate.set()
        gw.pool.shutdown()


def test_frontend_and_replica_over_http():
    """One real front end and one in-process replica over HTTP: the replica
    joins, warms, takes /predict, and the front end's /replicas lists it."""
    from deeplearning4j_torch.serving import ServingGateway
    from deeplearning4j_torch.utils.http_server import json_request
    from test_torch_model_pool import port_twin
    from test_serving_gateway import make_net

    fe = tfed.FederationFrontEnd(
        health=tch.HealthConfig(interval_s=0.05, timeout_s=5.0)).start()
    gw = rs = None
    try:
        gw, rs = tfed.serve_replica(
            lambda g: g.add_model("default", port_twin(make_net())),
            replica_id=0, frontend_url=fe.url, interval_s=0.05)
        assert fe.wait_for_replicas(1, timeout=10)
        x = np.random.default_rng(0).standard_normal((2, 4)).astype(np.float32)
        out = json_request(fe.url + "/predict", {"model": "default",
                                                 "features": x.tolist()})
        direct = json_request(gw.url + "/predict", {"model": "default",
                                                    "features": x.tolist()})
        assert out["predictions"] == direct["predictions"]
        reps = json_request(fe.url + "/replicas")["replicas"]
        assert reps[0]["state"] == "healthy" and reps[0]["dispatched"] >= 1
    finally:
        if rs is not None:
            rs.stop()
        if gw is not None:
            gw.stop()
        fe.stop()
