"""The torch port's flight recorder (serving/flight_recorder.py) against the
JAX package's:

- A scripted RequestTrace (the same origin and cut points) gives the same
  segments, per-phase ms and summary; `complete` returns the same summary
  and captures the same exemplars (errored, shed, over-SLO; not a fast ok
  request) in both packages.
- The port's ParallelInference marks the same phases in the same order as
  the JAX package's engine, BATCHED and SEQUENTIAL, a failed attempt and its
  solo retry included, and the phases sum to the traced wall time.
- Through the gateway the port's timeline is the JAX package's followed by
  `respond`, and it ends at the gateway's wall clock: the phases sum to
  `wall_ms` (the JAX package's stop short of it by the caller's wake-up).
- The recorder arms from DL4JTPU_FLIGHT_RECORDER and restores the tracing
  state it found when disarmed.

Tolerance: none for the scripted traces (the same floats in both); phase
sums within 1e-9 ms of the wall time they partition; a gateway summary's
phases, each rounded to 1e-4 ms, within 1e-3 ms of its `wall_ms`.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_torch.optimize import tracing as port_tracing
from deeplearning4j_torch.parallel import inference as port_inf
from deeplearning4j_torch.serving import ModelPool as PortPool
from deeplearning4j_torch.serving import ServingGateway as PortGateway
from deeplearning4j_torch.serving import flight_recorder as port_fr
from deeplearning4j_torch.utils import faults as port_faults
from deeplearning4j_tpu.optimize import tracing as ref_tracing
from deeplearning4j_tpu.parallel import inference as ref_inf
from deeplearning4j_tpu.serving import ModelPool as RefPool
from deeplearning4j_tpu.serving import ServingGateway as RefGateway
from deeplearning4j_tpu.serving import flight_recorder as ref_fr
from deeplearning4j_tpu.utils import faults as ref_faults


class _Stub:
    """Forward-only model for both engines: x * 2 on the host (the port's
    engine stages the batch on `device` first)."""

    _initialized = True
    conf = None
    device = torch.device("cpu")

    def output(self, x, **kw):
        return np.asarray(x.numpy() if hasattr(x, "numpy") else x) * 2.0

    def warmup(self, b, time_steps=None):
        pass


@pytest.fixture
def recorders():
    for fr in (port_fr, ref_fr):
        fr.enable(exemplar_ring=8)
        fr.clear()
    yield
    for fr in (port_fr, ref_fr):
        fr.disable()
        fr.clear()
    port_faults.reset()
    ref_faults.reset()


MARKS = [("admission", 0.25e-3), ("queue_wait", 2.5e-3), ("pack", 2.75e-3),
         ("sched_wait", 3.0e-3), ("dispatch", 3.125e-3), ("device", 9.5e-3),
         ("device", 12.0e-3), ("unpack", 12.5e-3)]


def _scripted(fr, rid=7):
    tr = fr.RequestTrace(rid, "fr_model", "standard")
    tr.t0 = 100.0
    for phase, dt in MARKS:
        tr.mark(phase, 100.0 + dt)
    tr.ctx.update(batch_rows=3, bucket=4)
    return tr


def test_scripted_trace_matches_reference():
    port, ref = _scripted(port_fr), _scripted(ref_fr)
    assert port.segments() == ref.segments()
    assert port.phase_ms() == ref.phase_ms()
    assert port.summary() == ref.summary()
    # the port closes a gateway timeline with `respond` (its one extra phase)
    assert port_fr.PHASES == ref_fr.PHASES + ("respond",)
    assert port_fr.ONESHOT_PHASES == ref_fr.ONESHOT_PHASES


@pytest.mark.parametrize("status,wall_ms,slo_ms,captured", [
    ("ok", 12.5, 50.0, False), ("ok", 12.5, 10.0, True),
    ("error", 12.5, 50.0, True), ("shed", 1.0, None, True),
    ("breaker_open", 0.5, 250.0, True)])
def test_complete_and_exemplars_match_reference(recorders, status, wall_ms,
                                                 slo_ms, captured):
    got = []
    for fr in (port_fr, ref_fr):
        summary = fr.complete(_scripted(fr), status, wall_ms, slo_ms)
        got.append((summary, fr.exemplars(model="fr_model"),
                    fr.exemplars(tier="batch")))
    assert got[0] == got[1]
    assert bool(got[0][1]) == captured


def test_want_summary_without_capture(recorders):
    for fr in (port_fr, ref_fr):
        s = fr.complete(_scripted(fr), "ok", 12.5, 50.0, want_summary=True)
        assert s["status"] == "ok" and fr.exemplars() == []
    assert port_fr.new_trace("m") is not None
    port_fr.disable()
    assert port_fr.new_trace("m") is None


def _engine_phases(inf, mode, fail_first=False):
    eng = inf.ParallelInference(_Stub(), inference_mode=mode, batch_limit=4)
    fr = port_fr if inf is port_inf else ref_fr
    faults = port_faults if inf is port_inf else ref_faults
    try:
        tr = fr.new_trace("fr_engine", "standard")
        tr.mark("admission")
        if fail_first:
            faults.inject("serve.forward", "fail:1")
        try:
            out = eng.output(np.ones((2, 3), np.float32), trace=tr)
        except inf.BatchExecutionError:
            out = None
        return [p for p, _ in tr.marks], out, tr
    finally:
        faults.clear("serve.forward")
        eng.shutdown()


@pytest.mark.parametrize("mode", ["BATCHED", "SEQUENTIAL"])
@pytest.mark.parametrize("fail_first", [False, True], ids=["ok", "failed"])
def test_engine_marks_the_reference_phases(recorders, mode, fail_first):
    port = _engine_phases(port_inf, port_inf.InferenceMode[mode], fail_first)
    ref = _engine_phases(ref_inf, ref_inf.InferenceMode[mode], fail_first)
    assert port[0] == ref[0]
    if not fail_first:
        assert port[0] == list(port_fr.ONESHOT_PHASES) or mode == "SEQUENTIAL"
        np.testing.assert_array_equal(port[1], ref[1])
    tr = port[2]
    total = sum(d for _, _, d in tr.segments())
    assert abs(total - (tr.marks[-1][1] - tr.t0)) < 1e-12


@pytest.mark.parametrize("features", [[[1.0, 2.0, 3.0]], "junk"],
                         ids=["ok", "refused"])
def test_gateway_timeline_ends_at_its_wall_clock(recorders, features):
    summaries = []
    for pool_cls, gw_cls in ((RefPool, RefGateway), (PortPool, PortGateway)):
        pool = pool_cls()
        pool.add("m", _Stub())
        gw = gw_cls(pool)
        try:
            sink = []
            try:
                gw.predict("m", np.asarray(features, np.float32)
                           if features != "junk" else np.ones(3, np.float32),
                           _trace_sink=sink)
            except Exception:
                pass
            summaries.append(sink[0])
        finally:
            pool.shutdown()
    ref, port = summaries
    assert [p["phase"] for p in port["phases"]] == \
        [p["phase"] for p in ref["phases"]] + ["respond"]
    assert port["status"] == ref["status"]
    assert abs(sum(p["ms"] for p in port["phases"]) - port["wall_ms"]) < 1e-3
    assert sum(p["ms"] for p in ref["phases"]) <= ref["wall_ms"] + 1e-6


def test_env_arming_and_tracing_state(monkeypatch):
    was = port_tracing.is_enabled()
    monkeypatch.setenv(port_fr.ENV_FLAG, "5")
    try:
        assert port_fr.maybe_enable_from_env() is True
        assert port_tracing.is_enabled()
        assert port_fr._exemplars.maxlen == 5
    finally:
        port_fr.disable()
    assert port_tracing.is_enabled() == was
    monkeypatch.setenv(port_fr.ENV_FLAG, "0")
    assert port_fr.maybe_enable_from_env() is False
    assert port_fr.ENV_FLAG == ref_fr.ENV_FLAG


def test_spans_reach_the_trace_export(recorders):
    port_tracing.clear()
    port_fr.complete(_scripted(port_fr), "error", 12.5, 50.0)
    events = [e for e in port_tracing.export_trace_events()["traceEvents"]
              if e.get("cat") == "serve"]
    assert [e["name"] for e in events] == ["serve/" + p for p, _ in MARKS]
    assert all(e["args"] == {"model": "fr_model", "rid": 7} for e in events)
    ref_tracing.clear()
