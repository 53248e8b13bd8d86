"""The port's streaming/ against the JAX package's.

- The wire format: `_encode`/`_decode` give equal JSON from both packages.
- A JAX `HttpBrokerClient` publishes and consumes through the port's
  `NDArrayStreamServer`, and a port client through the JAX server; a port
  ServeRoute consumes from a JAX server over HTTP.
- The registration consume's payload is delivered (the counterpart of
  tests/test_streaming_utils.py::test_registration_consume_payload_not_dropped).
- A ServeRoute over a small net carried from the JAX package answers within
  rtol 1e-5 of the JAX route's answers; a malformed message counts in
  `errors` and the route goes on serving.
"""
import json

import jax
import numpy as np
import pytest

import deeplearning4j_torch as port
import deeplearning4j_tpu as ref
from deeplearning4j_torch import streaming as pst
from deeplearning4j_torch.streaming import ndarray_stream as pns
from deeplearning4j_torch.utils import params as port_params
from deeplearning4j_tpu import streaming as rst
from deeplearning4j_tpu.streaming import ndarray_stream as rns

from test_torch_word2vec import one_torch_thread  # noqa: F401

WAIT_S = 20


def _conf(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(1).updater(pkg.Adam(0.01))
            .list()
            .layer(pkg.DenseLayer(n_out=8, activation="relu"))
            .layer(pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(4)).build())


def carried():
    r = ref.MultiLayerNetwork(_conf(ref)).init()
    p = port.MultiLayerNetwork(_conf(port)).init(device="cpu")
    p.params_tree = port_params.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, r.params_tree), "cpu")
    return r, p


def test_wire_format_equal():
    a = np.random.default_rng(0).standard_normal((2, 3, 4))
    assert json.dumps(pns._encode(a)) == json.dumps(rns._encode(a))
    enc = rns._encode(a)
    assert np.array_equal(pns._decode(enc), rns._decode(enc))
    assert pns._decode(enc).dtype == np.float32


@pytest.mark.parametrize("server_pkg,client_pkg", [(pst, rst), (rst, pst)])
def test_http_broker_across_packages(server_pkg, client_pkg):
    broker = server_pkg.InProcessBroker()
    local = server_pkg.NDArrayConsumer("x", broker=broker)
    with server_pkg.NDArrayStreamServer(broker=broker) as srv:
        remote = client_pkg.HttpBrokerClient(srv.url, poll_timeout=0.5)
        c = client_pkg.NDArrayConsumer("x", broker=remote)
        arrays = [np.full((2, 3), i, np.float32) for i in range(3)]
        for a in arrays:
            client_pkg.NDArrayPublisher("x", broker=remote).publish(a)
        for a in arrays:
            np.testing.assert_array_equal(c.get(timeout=WAIT_S), a)
            np.testing.assert_array_equal(local.get(timeout=WAIT_S), a)
        remote.topic("x").unsubscribe(c._queue)


def test_registration_consume_payload_not_dropped():
    """The synchronous registration /consume can itself return a message;
    it must land on the local queue."""
    topic = pns._HttpTopic("http://unused", "t", "cid", poll_timeout=0.05)
    payload = pns._encode(np.arange(3, dtype=np.float32))
    consumes = [0]

    def fake_post(route, body):
        if route == "/consume":
            consumes[0] += 1
            if consumes[0] == 1:   # the registration call
                return {"empty": False, **payload}
        return {"empty": True}

    topic._post = fake_post
    q = topic.subscribe()
    try:
        np.testing.assert_allclose(q.get(timeout=5), np.arange(3, dtype=np.float32))
    finally:
        topic.unsubscribe(q)


def _serve(pkg, net, inputs, extra=None):
    broker = pkg.InProcessBroker()
    pub = pkg.NDArrayPublisher("in", broker=broker)
    out = pkg.NDArrayConsumer("out", broker=broker)
    route = pkg.ServeRoute(net, "in", "out", broker=broker)
    with route:
        if extra is not None:
            pub.publish(extra)
        answers = []
        for x in inputs:
            pub.publish(x)
            answers.append(out.get(timeout=WAIT_S))
    return answers, route


def test_serve_route_matches_reference():
    r, p = carried()
    rng = np.random.default_rng(3)
    inputs = [rng.standard_normal((n, 4)).astype(np.float32) for n in (1, 5, 2)]
    got, route = _serve(pst, p, inputs)
    want, _ = _serve(rst, r, inputs)
    for g, w, x in zip(got, want, inputs):
        np.testing.assert_allclose(g, w, rtol=1e-5)
        np.testing.assert_allclose(g, p.output(x), rtol=1e-5)
    assert (route.served, route.errors) == (3, 0)


def test_serve_route_counts_a_malformed_message_and_goes_on():
    _, p = carried()
    x = np.ones((2, 4), np.float32)
    got, route = _serve(pst, p, [x, x], extra=np.ones((2, 7), np.float32))
    assert route.errors == 1 and route.served == 2
    np.testing.assert_allclose(got[1], p.output(x), rtol=1e-5)


def test_port_route_consumes_from_a_reference_server():
    r, p = carried()
    broker = rst.InProcessBroker()
    with rst.NDArrayStreamServer(broker=broker) as srv:
        remote = pst.HttpBrokerClient(srv.url, poll_timeout=0.5)
        out = rst.NDArrayConsumer("preds", broker=broker)
        x = np.random.default_rng(5).standard_normal((3, 4)).astype(np.float32)
        route = pst.ServeRoute(p, "imgs", "preds", broker=remote)
        try:
            with route:
                rst.NDArrayPublisher("imgs", broker=broker).publish(x)
                np.testing.assert_allclose(out.get(timeout=WAIT_S), r.output(x),
                                           rtol=1e-5)
        finally:
            remote.topic("imgs").unsubscribe(route._consumer._queue)
