"""The torch port's serving gateway (serving/gateway.py) against the JAX
package's, with the 4-16-3 MLP of the JAX package's gateway tests carried
across:

- /predict answers agree with the JAX gateway's for the same inputs (rtol
  1e-5, atol 1e-7), over HTTP and in process.
- Every typed error gets the same HTTP status, status word and reason in
  both packages: unknown model 404; breaker_open, tier_shed, deadline (at
  admission and late) and a closed server 503; queue_full 429; nonfinite and
  batch_failed 500; the /swap, /config and /generate refusals.
- /health, /models and /stats carry the JAX package's keys; the debug
  routes answer 404 with the same body until armed.
- The port refuses a non-finite answer with 500 nonfinite before it is
  serialized, also without check_finite (json.dumps would write NaN).
- POST /generate answers naive_generate's tokens; KV exhaustion is 429.
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_torch.parallel import inference as port_inf
from deeplearning4j_torch.serving import ModelPool as PortPool
from deeplearning4j_torch.serving import ServingGateway as PortGateway
from deeplearning4j_torch.serving import decode as port_decode
from deeplearning4j_tpu.parallel import inference as ref_inf
from deeplearning4j_tpu.serving import ModelPool as RefPool
from deeplearning4j_tpu.serving import ServingGateway as RefGateway
from test_serving_gateway import make_net, rand_x
from test_torch_model_pool import port_twin

RTOL, ATOL = 1e-5, 1e-7


def post(url, payload):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def ref_net():
    return make_net()


@pytest.fixture(scope="module")
def nets(ref_net):
    """The MLP in both packages, shared by every gateway of this file (a
    served net keeps its compiled forwards; a test that replaces `output`
    does it through monkeypatch)."""
    return ref_net, port_twin(ref_net)


@pytest.fixture
def gateways(nets):
    """(JAX gateway, port gateway), each serving the MLP as "m" (batch limit
    2) and as "lo" at the batch tier, which makes both pools tiered."""
    made = []
    for pool_cls, gw_cls, net in zip((RefPool, PortPool), (RefGateway, PortGateway),
                                     nets):
        gw = gw_cls(pool_cls())
        gw.add_model("m", net, batch_limit=2)
        gw.add_model("lo", net, batch_limit=2, tier="batch")
        made.append(gw)
    yield made
    for gw in made:
        gw.stop()


def test_answers_match_reference_over_http_and_in_process(gateways):
    for gw in gateways:
        gw.warmup().start()
    xs = [rand_x(n, seed=40 + n) for n in (1, 2, 3)]
    for x in xs:
        (rc, rb), (pc, pb) = (post(gw.url + "/predict",
                                   {"model": "m", "features": x.tolist()})
                              for gw in gateways)
        assert rc == pc == 200 and rb["version"] == pb["version"] == "initial"
        np.testing.assert_allclose(pb["predictions"], rb["predictions"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gateways[1].predict("m", x),
                                   np.asarray(gateways[0].predict("m", x)),
                                   rtol=RTOL, atol=ATOL)


def _arrange(case, gw, inf, monkeypatch):
    """Set up `case` on one gateway; returns the request to route."""
    entry = gw.pool.get("m")
    x = rand_x(1, seed=3).tolist()
    req = {"model": "m", "features": x}

    def raising(err):
        def output(*a, **kw):
            raise err("scripted")
        return output

    if case == "unknown_model":
        req["model"] = "nope"
    elif case == "breaker_open":
        entry.breaker.record_failure(trip=True)
    elif case == "tier_shed":
        gw.pool.scheduler.register("hot", tier="critical", depth_fn=lambda: 99)
        req["model"] = "lo"
    elif case == "deadline_admission":
        entry.engine._ewma_batch_s = 10.0
        req["deadline_ms"] = 1.0
    elif case == "deadline_late":
        entry.engine.output = raising(inf.DeadlineExceededError)
    elif case == "queue_full":
        entry.engine.output = raising(inf.QueueFullError)
    elif case == "kv_exhausted":
        entry.engine.output = raising(inf.KVCacheExhaustedError)
    elif case == "nonfinite":
        monkeypatch.setattr(entry.model, "output",
                            lambda *a, **kw: np.full((1, 3), np.nan, np.float32))
    elif case == "batch_failed":
        monkeypatch.setattr(entry.model, "output", raising(RuntimeError))
    elif case == "closed":
        gw.pool.shutdown()
    return req


CASES = ["unknown_model", "breaker_open", "tier_shed", "deadline_admission",
         "deadline_late", "queue_full", "kv_exhausted", "nonfinite",
         "batch_failed", "closed"]


@pytest.mark.parametrize("case", CASES)
def test_typed_errors_match_reference(gateways, case, monkeypatch):
    got = []
    for gw, inf in zip(gateways, (ref_inf, port_inf)):
        code, body = gw._predict_route(_arrange(case, gw, inf, monkeypatch))
        got.append((code, body.get("status"), body.get("reason")))
    assert got[0] == got[1]
    assert got[0][0] != 200


@pytest.mark.parametrize("route,req", [
    ("/swap", {"model": "nope"}), ("/swap", {"model": "m"}),
    ("/config", {"model": "m", "colour": 1}),
    ("/config", {"model": "m", "weight": "heavy"}),
    ("/config", {"model": "nope", "weight": 2.0}),
    ("/config", {"model": "m", "tier": "gold"}),
    ("/config", {"tier_slo_ms": 5}), ("/config", {}),
    ("/config", {"model": "m", "batch_timeout_ms": 3.0}),
    ("/config", {"quantum": 2.0, "tier_slo_ms": {"batch": 900.0}}),
    ("/generate", {"model": "m"}), ("/generate", {"model": "nope", "prompt": [1]})])
def test_control_routes_match_reference(gateways, route, req):
    got = []
    for gw in gateways:
        handler = {"/swap": gw._swap_route, "/config": gw._config_route,
                   "/generate": gw._generate_route}[route]
        code, body = handler(dict(req))
        got.append((code, body.get("status"), body.get("reason"),
                    sorted(body.get("reconfigured", []))))
    assert got[0] == got[1]


def test_read_routes_match_reference(gateways):
    for gw in gateways:
        gw.predict("m", rand_x(2))
    shapes = []
    for gw in gateways:
        health = gw._health_route(None)
        models = gw._models_route(None)
        stats = gw._stats_route(None)
        debug = gw._debug_requests_route(None)
        tuner = gw._debug_tuner_route(None)
        trace = gw._trace_route()
        shapes.append((health, sorted(models[1]["models"][0]),
                       sorted(stats[1]), sorted(stats[1]["latency"]["m"]),
                       debug, tuner, trace[0], json.loads(trace[2])["status"]))
    assert shapes[0] == shapes[1]
    assert shapes[0][0][1]["status"] == "ok"


def test_nonfinite_is_refused_before_serialization(nets, monkeypatch):
    gw = PortGateway(PortPool())
    entry = gw.add_model("m", nets[1], check_finite=False)
    monkeypatch.setattr(entry.model, "output",
                        lambda *a, **kw: np.full((1, 3), np.inf, np.float32))
    try:
        gw.start()
        code, body = post(gw.url + "/predict", {"model": "m",
                                                "features": rand_x(1).tolist()})
    finally:
        gw.stop()
    assert (code, body["reason"]) == (500, "nonfinite")


def test_generate_over_http_and_kv_backpressure():
    model = port_decode.TransformerDecoder(vocab=32, layers=2, heads=2, head_dim=8,
                                           ff=16, max_context=32, seed=4, device="cpu")
    gw = PortGateway(PortPool())
    gw.add_decode_model("dec", model, max_decode_batch=2, pack_bucket=16,
                        kv_block_tokens=4, kv_max_blocks=2)
    try:
        gw.warmup("dec").start()
        code, body = post(gw.url + "/generate", {"model": "dec", "prompt": [3, 1, 4],
                                                 "max_new_tokens": 4})
        assert code == 200
        assert body["tokens"] == port_decode.naive_generate(model, [3, 1, 4], 4, pad_to=16)
        code, body = post(gw.url + "/generate", {"model": "dec", "prompt": list(range(10)),
                                                 "max_new_tokens": 8})
        assert (code, body["reason"]) == (429, "queue_full")
        code, body = post(gw.url + "/generate", {"model": "dec", "prompt": [99]})
        assert (code, body["reason"]) == (400, "bad_prompt")
    finally:
        gw.stop()
