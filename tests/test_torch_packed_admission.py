"""Packed admission in the torch port's ParallelInference against the JAX
package's.

The served model is the char model at width 16 (two causal
`SelfAttentionLayer(16, 4 heads, relu, packed_segments=True)` and an
`RnnOutputLayer(11, softmax)`, as tests/test_torch_char_model.py builds
it); the JAX network holds the port network's parameters. Requests are
single sequences [1, t, 11] from a numpy seed.

- Packed answers against each request served alone by `net.output` (rtol
  1e-6, atol 1e-7: ROADMAP's "Batch sum order" hold on the CPU, since a
  packed row's products run at another size) and against the JAX package's
  packed answers (rtol 1e-5, atol 1e-6).
- A request that is not one sequence takes the row path and is counted.
- A `serve.pack` fault fails only the request whose own attempt fails; the
  collector survives.
- Shutdown serves the requests still queued, packed.
- The configuration errors and the builder's option.

Every client thread is joined with a timeout that fails the test.
"""
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import deeplearning4j_torch as port
import deeplearning4j_tpu as ref
from deeplearning4j_torch.parallel.inference import (BatchExecutionError,
                                                     InferenceMode,
                                                     ParallelInference)
from deeplearning4j_torch.utils import faults
from deeplearning4j_torch.utils import params as port_params
from deeplearning4j_tpu.nn.conf.builders import \
    MultiLayerConfiguration as RefConfiguration
from deeplearning4j_tpu.parallel.inference import \
    ParallelInference as RefParallelInference

WIDTH, HEADS, VOCAB, BUCKET = 16, 4, 11, 32
SOLO = dict(rtol=1e-6, atol=1e-7)
VS_JAX = dict(rtol=1e-5, atol=1e-6)
JOIN_S = 60.0


def _conf(pkg):
    attn = lambda: pkg.SelfAttentionLayer(n_out=WIDTH, n_heads=HEADS, causal=True,
                                          activation="relu", packed_segments=True)
    return (pkg.NeuralNetConfiguration.builder().seed(0).updater(pkg.Sgd(0.1))
            .list().layer(attn()).layer(attn())
            .layer(pkg.RnnOutputLayer(n_out=VOCAB, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(pkg.InputType.recurrent(VOCAB)).build())


@pytest.fixture(scope="module")
def nets():
    net = port.MultiLayerNetwork(_conf(port)).init(device="cpu")
    jnet = ref.MultiLayerNetwork(
        RefConfiguration.from_json(_conf(port).to_json())).init()
    jnet.params_tree = jax.tree_util.tree_map(
        jax.numpy.asarray, port_params.params_to_numpy(net.params_tree))
    return net, jnet


def _requests(seed, lengths):
    rng = np.random.default_rng(seed)
    eye = np.eye(VOCAB, dtype=np.float32)
    return [eye[rng.integers(0, VOCAB, (1, t))] for t in lengths]


def _clients(pi, reqs):
    out = [None] * len(reqs)

    def run(i):
        try:
            out[i] = np.asarray(pi.output(reqs[i]))
        except BaseException as e:  # noqa: BLE001 (handed to the test)
            out[i] = e

    ts = [threading.Thread(target=run, args=(i,), daemon=True)
          for i in range(len(reqs))]
    for t in ts:
        t.start()
    return out, ts


def _join(ts):
    for t in ts:
        t.join(JOIN_S)
        assert not t.is_alive(), "a client thread hung"


def _serve(net, reqs, cls=ParallelInference, **kw):
    kw.setdefault("batch_timeout_ms", 200.0)
    pi = cls(net, packed_admission=True, pack_bucket=BUCKET, batch_limit=8, **kw)
    try:
        pi.warmup(max_bucket=1, time_steps=BUCKET)
        out, ts = _clients(pi, reqs)
        _join(ts)
    finally:
        pi.shutdown()
    return out, pi


def test_packed_answers_match_solo_and_jax(nets):
    net, jnet = nets
    reqs = _requests(0, (5, 7, 3, 6, 4, 2))
    got, pi = _serve(net, reqs)
    want_jax, _ = _serve(jnet, reqs, cls=RefParallelInference)
    for i, x in enumerate(reqs):
        assert not isinstance(got[i], BaseException), got[i]
        assert got[i].shape == (1, x.shape[1], VOCAB)
        np.testing.assert_allclose(got[i], net.output(x), **SOLO)
        np.testing.assert_allclose(got[i], want_jax[i], **VS_JAX)
    assert pi.total_packed_requests == len(reqs)
    assert pi.total_forwards < len(reqs), "nothing was packed together"
    assert pi.total_pack_fallbacks == 0


def test_packed_row_carries_segment_ids(nets, monkeypatch):
    """The forward sees one [1, BUCKET] row whose features mask numbers the
    requests 1..k in arrival order, 0 past them."""
    net, _ = nets
    seen = []
    real = net.output

    def spy(x, features_mask=None):
        seen.append((tuple(x.shape), None if features_mask is None
                     else torch.as_tensor(features_mask).numpy().copy()))
        return real(x, features_mask=features_mask)

    monkeypatch.setattr(net, "output", spy)
    reqs = _requests(1, (4, 3))
    got, pi = _serve(net, reqs)
    packed = [m for shape, m in seen if m is not None and shape[1] == BUCKET
              and m.any()]
    assert pi.total_forwards == 1 and len(packed) == 1
    assert packed[0].tolist() == [[1] * 4 + [2] * 3 + [0] * (BUCKET - 7)]


def test_ineligible_request_takes_the_row_path(nets):
    net, _ = nets
    x2 = _requests(2, (6, 6))
    x2 = np.concatenate(x2, axis=0)   # two rows: not one sequence
    got, pi = _serve(net, [x2])
    np.testing.assert_allclose(got[0], net.output(x2), **SOLO)
    assert pi.total_pack_fallbacks == 1 and pi.total_packed_requests == 0


def test_serve_pack_fault_fails_only_its_batch(nets):
    net, _ = nets
    reqs = _requests(3, (5,))
    pi = ParallelInference(net, packed_admission=True, pack_bucket=BUCKET,
                           batch_timeout_ms=1.0)
    try:
        with faults.injected("serve.pack", "fail:1"):
            with pytest.raises(BatchExecutionError):
                pi.output(reqs[0])
        # the collector survived: traffic resumes
        np.testing.assert_allclose(pi.output(reqs[0]), net.output(reqs[0]), **SOLO)
        assert pi.total_batch_failures == 1
    finally:
        pi.shutdown()
    # three requests packed together: the row's assembly (call 1) and the
    # first solo retry's (call 2) fail, so exactly one request fails
    reqs = _requests(4, (5, 6, 4))
    with faults.injected("serve.pack", "fail:1,2"):
        got, pi = _serve(net, reqs)
    failed = [o for o in got if isinstance(o, BatchExecutionError)]
    assert len(failed) == 1
    for o, x in zip(got, reqs):
        if not isinstance(o, BaseException):
            np.testing.assert_allclose(o, net.output(x), **SOLO)


def test_shutdown_drains_queued_packed_requests(nets):
    net, _ = nets
    reqs = _requests(5, (4, 4, 4, 4))
    pi = ParallelInference(net, packed_admission=True, pack_bucket=BUCKET,
                           batch_timeout_ms=300.0)
    out, ts = _clients(pi, reqs)
    pi.shutdown()
    _join(ts)
    for o, x in zip(out, reqs):
        assert not isinstance(o, BaseException), o
        np.testing.assert_allclose(o, net.output(x), **SOLO)


class _Stub:
    _initialized = True

    class conf:   # a MultiLayerNetwork configuration has no network_inputs
        pass


def test_configuration_errors_and_builder():
    with pytest.raises(ValueError, match="BATCHED"):
        ParallelInference(_Stub(), inference_mode=InferenceMode.SEQUENTIAL,
                          packed_admission=True, pack_bucket=8)
    with pytest.raises(ValueError, match="pack_bucket"):
        ParallelInference(_Stub(), packed_admission=True, pack_bucket=0)


def test_builder_and_eligibility(nets):
    net, _ = nets
    pi = ParallelInference.builder(net).packed_admission(8).build()
    try:
        assert pi.packed_admission and pi.pack_bucket == 8
        assert pi._pack_eligible(np.zeros((1, 5, 3), np.float32))
        for bad in (np.zeros((2, 5, 3)), np.zeros((1, 9, 3)), np.zeros((1, 0, 3)),
                    np.zeros((1, 5))):
            assert not pi._pack_eligible(bad)
    finally:
        pi.shutdown()
