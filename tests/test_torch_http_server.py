"""The torch port's JSON HTTP server (utils/http_server.py) against the JAX
package's: the same route tables answer every request with the same status
and the same JSON body (query strings, unknown paths, raising handlers, bad
JSON, raw routes), `/metrics` serves the port's own registry, `json_request`
round-trips, and `stop()` finishes an in-flight handler before returning.
Tolerance: none (equality)."""
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from deeplearning4j_torch.optimize.metrics import registry as port_registry
from deeplearning4j_torch.utils import http_server as port_http
from deeplearning4j_tpu.utils import http_server as ref_http


def _routes():
    def echo(req):
        return 200, {"got": req}

    def boom(_):
        raise ValueError("handler raised")

    def typed(req):
        return int(req.get("code", 200)), {"status": "typed"}

    return ({"/echo": echo, "/boom": boom},
            {"/echo": echo, "/boom": boom, "/typed": typed},
            {"/raw": lambda: (200, "text/plain", b"raw body")})


def _call(url, method, body=None):
    data = None if body is None else body
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


CASES = [("GET", "/echo", None), ("GET", "/echo?model=a&tier=batch", None),
         ("GET", "/nope", None), ("GET", "/boom", None), ("GET", "/raw", None),
         ("POST", "/echo", b'{"x": [1, 2.5, null]}'), ("POST", "/echo", b"{bad"),
         ("POST", "/boom", b"{}"), ("POST", "/typed", b'{"code": 503}'),
         ("POST", "/nope", b"{}")]


@pytest.fixture(scope="module")
def servers():
    got = []
    for mod in (port_http, ref_http):
        get, post, raw = _routes()
        got.append(mod.JsonHttpServer(get, post, raw_get_routes=raw).start())
    yield got
    for s in got:
        s.stop()


@pytest.mark.parametrize("method,path,body", CASES,
                         ids=[f"{m} {p} {b!r}" for m, p, b in CASES])
def test_same_status_and_body_as_reference(servers, method, path, body):
    port, ref = (_call(s.url + path, method, body) for s in servers)
    assert port[:2] == ref[:2]
    if port[1] == "application/json":
        p, r = json.loads(port[2]), json.loads(ref[2])
        if path == "/echo" and body == b"{bad":
            # the JSON decoder's message is the same text in both
            assert p["error"].startswith("bad JSON") and r["error"].startswith("bad JSON")
        assert p == r
    else:
        assert port[2] == ref[2]


def test_metrics_route_serves_the_ports_registry():
    port_registry().counter("http_server_test_total", "test family").inc()
    srv = port_http.JsonHttpServer({}, {}, expose_metrics=True).start()
    try:
        code, ctype, body = _call(srv.url + "/metrics", "GET")
    finally:
        srv.stop()
    assert code == 200 and ctype.startswith("text/plain")
    assert b"http_server_test_total" in body


def test_json_request_round_trips():
    srv = port_http.JsonHttpServer({"/ping": lambda q: (200, {"q": q})},
                                   {"/echo": lambda r: (200, r)}).start()
    try:
        assert port_http.json_request(srv.url + "/echo", {"a": [1, 2]}) == {"a": [1, 2]}
        assert port_http.json_request(srv.url + "/ping") == {"q": None}
        with pytest.raises(urllib.error.HTTPError):
            port_http.json_request(srv.url + "/missing")
    finally:
        srv.stop()


def test_stop_finishes_the_inflight_handler():
    entered, finished = threading.Event(), []

    def slow(_):
        entered.set()
        time.sleep(0.05)
        finished.append(True)
        return 200, {"ok": True}

    srv = port_http.JsonHttpServer({}, {"/slow": slow}, pool_size=2).start()
    url = srv.url
    reply = []
    t = threading.Thread(target=lambda: reply.append(_call(url + "/slow", "POST", b"{}")))
    t.start()
    assert entered.wait(timeout=10)
    srv.stop()
    assert finished == [True]
    t.join(timeout=10)
    assert not t.is_alive() and reply[0][0] == 200
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url + "/slow", data=b"{}", timeout=2)
