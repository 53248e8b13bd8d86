"""The port's cluster health plane against the JAX package's.

Each scenario of tests/test_cluster_health.py runs the same scripted beat
table (a hand-cranked clock, the sockets-free InProcessBeatTransport)
through both packages' monitors; the typed errors, their peer ids and
messages, the grace bits and the gauges must come out the same."""
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu.optimize import metrics as jax_metrics
from deeplearning4j_tpu.parallel import cluster_health as jch
from deeplearning4j_tpu.utils import faults as jfaults
from deeplearning4j_torch.optimize import metrics as torch_metrics
from deeplearning4j_torch.parallel import cluster_health as tch
from deeplearning4j_torch.utils import faults as tfaults

PACKAGES = {"jax": (jch, jfaults, jax_metrics),
            "torch": (tch, tfaults, torch_metrics)}

CFG = dict(interval_s=1.0, timeout_s=5.0, stall_timeout_s=10.0,
           barrier_timeout_s=30.0)


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def make_pair(ch, clock, **overrides):
    cfg = ch.HealthConfig(**{**CFG, **overrides})
    transport = ch.InProcessBeatTransport(clock)
    fails = []
    mons = [ch.ClusterHealthMonitor(p, 2, transport, config=cfg,
                                    clock=clock, on_failure=fails.append)
            for p in range(2)]
    for m in mons:
        m._started_at = clock()
    return mons, fails


def describe(err):
    if err is None:
        return None
    return (type(err).__name__, list(err.peers), str(err))


def both(scenario):
    """The scenario's transcript from each package; they must be equal."""
    out = {name: scenario(*mods) for name, mods in PACKAGES.items()}
    assert out["jax"] == out["torch"], out
    return out["torch"]


# ---------------------------------------------------------------------------
# The watchdog state machine
# ---------------------------------------------------------------------------

def test_healthy_cluster_stays_healthy():
    def scenario(ch, faults, metrics):
        clock = FakeClock()
        (m0, m1), fails = make_pair(ch, clock)
        log = []
        for _ in range(20):
            clock.advance(1.0)
            log.append((describe(m0.poll_once()), describe(m1.poll_once())))
        return log, len(fails)
    log, nfails = both(scenario)
    assert nfails == 0 and all(e == (None, None) for e in log)


def test_dead_peer_raises_peer_lost_with_id():
    def scenario(ch, faults, metrics):
        clock = FakeClock()
        (m0, m1), fails = make_pair(ch, clock)
        m0.poll_once(), m1.poll_once()
        clock.advance(5.5)
        err = m0.poll_once()
        with pytest.raises(ch.PeerLostError):
            m0.check()
        age = metrics.registry().gauge(
            "cluster_peer_beat_age_seconds").value(peer="1")
        return describe(err), fails == [err], m0.poll_once() is err, age
    (kind, peers, msg), latched, same, age = both(scenario)
    assert kind == "PeerLostError" and peers == [1] and latched and same
    assert age == 5.5


def test_startup_grace_for_never_beaten_peer():
    def scenario(ch, faults, metrics):
        clock = FakeClock()
        (m0, _), _ = make_pair(ch, clock)
        clock.advance(4.0)
        first = describe(m0.poll_once())
        clock.advance(2.0)
        return first, describe(m0.poll_once())
    first, (kind, peers, msg) = both(scenario)
    assert first is None and kind == "PeerLostError" and peers == [1]
    assert "never" in msg


def test_beating_but_frozen_peer_raises_desync():
    def scenario(ch, faults, metrics):
        clock = FakeClock()
        (m0, m1), fails = make_pair(ch, clock)
        step, log = 0, []
        for _ in range(3):
            clock.advance(1.0)
            step += 1
            m0.notify_step(step)
            m1.notify_step(step)
            log.append((describe(m0.poll_once()), describe(m1.poll_once())))
        for _ in range(12):
            clock.advance(1.0)
            step += 1
            m0.notify_step(step)
            err0 = m0.poll_once()
            log.append((describe(err0), describe(m1.poll_once())))
            if err0 is not None:
                break
        lag = metrics.registry().gauge("cluster_peer_step_lag").value(peer="1")
        return log, describe(err0), fails == [err0], lag
    log, (kind, peers, _), latched, lag = both(scenario)
    assert kind == "ClusterDesyncError" and peers == [1] and latched
    assert all(e[1] is None for e in log)  # the frozen peer blames nobody
    assert lag > 0


def test_frozen_everywhere_is_not_a_desync():
    def scenario(ch, faults, metrics):
        clock = FakeClock()
        (m0, m1), fails = make_pair(ch, clock)
        for _ in range(30):
            clock.advance(1.0)
            m0.poll_once(), m1.poll_once()
        return len(fails)
    assert both(scenario) == 0


def test_chief_channel_unreachable_marks_chief_lost():
    def scenario(ch, faults, metrics):
        clock = FakeClock()

        class DeadChannel:
            chief = False

            def publish(self, beat):
                raise OSError("connection refused")

            def table(self):
                raise OSError("connection refused")

            def close(self):
                pass

        fails = []
        m = ch.ClusterHealthMonitor(1, 2, DeadChannel(),
                                    config=ch.HealthConfig(**CFG),
                                    clock=clock, on_failure=fails.append)
        m._started_at = clock()
        first = describe(m.poll_once())
        clock.advance(5.5)
        return first, describe(m.poll_once())
    first, (kind, peers, _) = both(scenario)
    assert first is None and kind == "PeerLostError" and peers == [0]


# ---------------------------------------------------------------------------
# Grace, steps and the fault points
# ---------------------------------------------------------------------------

def test_grace_flag_rides_the_beats():
    def scenario(ch, faults, metrics):
        clock = FakeClock()
        (m0, m1), _ = make_pair(ch, clock)
        m1.request_grace()
        before = (m1.grace_requested(), m0.grace_requested())
        m1.poll_once()
        m0.poll_once()
        return before, m0.grace_requested()
    assert both(scenario) == ((True, False), True)


def test_notify_step_is_monotonic():
    def scenario(ch, faults, metrics):
        (m0, _), _ = make_pair(ch, FakeClock())
        m0.notify_step(5)
        m0.notify_step(3)
        with m0._lock:
            return m0._step
    assert both(scenario) == 5


def test_step_stall_fault_point_freezes_reports():
    def scenario(ch, faults, metrics):
        (m0, _), _ = make_pair(ch, FakeClock())
        m0.notify_step(1)
        with faults.injected("step.stall", "fail:*"):
            m0.notify_step(2)
        with m0._lock:
            return m0._step
    assert both(scenario) == 1


def test_heartbeat_send_fault_point_suppresses_beats():
    def scenario(ch, faults, metrics):
        clock = FakeClock()
        (m0, m1), _ = make_pair(ch, clock)
        m0.poll_once(), m1.poll_once()
        with faults.injected("heartbeat.send", "fail:*"):
            for _ in range(6):
                clock.advance(1.0)
                m1.poll_once()
            err = m0.poll_once()
            fired = faults.fired_count("heartbeat.send")
        return describe(err), fired
    (kind, peers, _), fired = both(scenario)
    assert kind == "PeerLostError" and peers == [1] and fired >= 6


def test_delay_fault_on_heartbeat_send_keeps_the_beat():
    def scenario(ch, faults, metrics):
        clock = FakeClock()
        (m0, m1), _ = make_pair(ch, clock)
        with faults.injected("heartbeat.send", "delay:*@1"):
            for _ in range(6):
                clock.advance(1.0)
                m1.poll_once()
                m0.poll_once()
            fired = faults.fired_count("heartbeat.send")
        return describe(m0.failure()), fired
    assert both(scenario) == (None, 12)


# ---------------------------------------------------------------------------
# Configuration and metrics
# ---------------------------------------------------------------------------

def test_from_env_reads_the_heartbeat_family(monkeypatch):
    monkeypatch.setenv("DL4JTPU_HEARTBEAT_INTERVAL_S", "0.25")
    monkeypatch.setenv("DL4JTPU_HEARTBEAT_TIMEOUT_S", "3")
    monkeypatch.setenv("DL4JTPU_HEARTBEAT_STALL_S", "7")
    monkeypatch.setenv("DL4JTPU_HEARTBEAT_BARRIER_TIMEOUT_S", "11")
    monkeypatch.setenv("DL4JTPU_HEARTBEAT_GRACE_EVERY", "2")
    monkeypatch.setenv("DL4JTPU_HEARTBEAT_PORT", "12345")

    def scenario(ch, faults, metrics):
        c = ch.HealthConfig.from_env()
        return (c.interval_s, c.timeout_s, c.stall_timeout_s,
                c.barrier_timeout_s, c.grace_every, c.port)
    assert both(scenario) == (0.25, 3.0, 7.0, 11.0, 2, 12345)


@pytest.mark.parametrize("value,enabled", [(None, False), ("0", False),
                                           ("no", False), ("1", True)])
def test_health_enabled_from_env(monkeypatch, value, enabled):
    if value is None:
        monkeypatch.delenv("DL4JTPU_HEARTBEAT", raising=False)
    else:
        monkeypatch.setenv("DL4JTPU_HEARTBEAT", value)
    assert both(lambda ch, f, m: ch.health_enabled_from_env()) == enabled


def test_register_metrics_registers_every_family():
    def scenario(ch, faults, metrics):
        text = ch.register_metrics().prometheus_text()
        return sorted(n for n in ch._HELP if n in text)
    assert both(scenario) == sorted(tch._HELP)


def test_beat_ages_and_exit_code():
    table = {"now": 10.0, "beats": {"0": {"recv_ts": 9.0},
                                    "1": {"recv_ts": 12.0}, "2": {}}}
    assert tch.beat_ages(table) == jch.beat_ages(table) == \
        {"0": 1.0, "1": 0.0, "2": 0.0}
    assert tch.ClusterHealthMonitor.EXIT_CODE == \
        jch.ClusterHealthMonitor.EXIT_CODE == 17
    assert (tch.KIND_TRAINER, tch.KIND_REPLICA) == \
        (jch.KIND_TRAINER, jch.KIND_REPLICA)


def test_monitor_thread_start_stop():
    transport = tch.InProcessBeatTransport()
    fails = []
    m = tch.ClusterHealthMonitor(
        0, 1, transport, config=tch.HealthConfig(interval_s=0.01, timeout_s=5,
                                                 stall_timeout_s=5),
        on_failure=fails.append).start()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not transport.table()["beats"]:
        time.sleep(0.01)
    m.stop()
    assert "0" in transport.table()["beats"] and not fails


def test_http_beat_transport_round_trip():
    chief = tch.HttpBeatTransport(0, "127.0.0.1", 0, chief=True)
    try:
        port = chief._server.port
        peer = tch.HttpBeatTransport(1, "127.0.0.1", port)
        peer.publish({"process_id": 1, "step": 3})
        chief.publish({"process_id": 0, "step": 4})
        table = peer.table()
        assert {k: b["step"] for k, b in table["beats"].items()} == \
            {"0": 4, "1": 3}
        assert set(tch.beat_ages(table)) == {"0", "1"}
    finally:
        chief.close()


# ---------------------------------------------------------------------------
# Timed collectives
# ---------------------------------------------------------------------------

def test_fast_collective_passes_value_through():
    assert both(lambda ch, f, m: (
        ch.timed_collective(lambda: 42, name="x", timeout_s=5),
        ch.timed_collective(lambda: 7, name="x", timeout_s=None))) == (42, 7)


def test_worker_exception_propagates():
    def boom():
        raise ValueError("inner")
    with pytest.raises(ValueError, match="inner"):
        tch.timed_collective(boom, name="x", timeout_s=5)


def test_hanging_collective_raises_typed_timeout():
    def scenario(ch, faults, metrics):
        release = threading.Event()
        try:
            with pytest.raises(ch.BarrierTimeoutError) as e:
                ch.timed_collective(release.wait, name="wedge-me",
                                    timeout_s=0.05)
        finally:
            release.set()
        return str(e.value)
    assert "wedge-me" in both(scenario)


def test_monitor_diagnosis_preferred_over_generic_timeout():
    def scenario(ch, faults, metrics):
        clock = FakeClock()
        (m0, _), _ = make_pair(ch, clock)
        m0.poll_once()
        clock.advance(6.0)
        m0.poll_once()
        release = threading.Event()
        try:
            with pytest.raises(ch.PeerLostError) as e:
                ch.timed_collective(release.wait, name="b", timeout_s=0.05,
                                    monitor=m0)
        finally:
            release.set()
        return describe(e.value)
    assert both(scenario)[1] == [1]


# ---------------------------------------------------------------------------
# The step checkpoint manager
# ---------------------------------------------------------------------------

def test_deprecated_alias_identity():
    from deeplearning4j_torch.parallel import multihost
    import deeplearning4j_torch.parallel as P
    assert multihost.CheckpointManager is multihost.StepCheckpointManager
    assert P.CheckpointManager is P.StepCheckpointManager


def test_latest_valid_skips_torn_newest(tmp_path):
    from deeplearning4j_torch import (DenseLayer, InputType,
                                      MultiLayerNetwork,
                                      NeuralNetConfiguration, OutputLayer,
                                      Sgd)
    from deeplearning4j_torch.parallel.multihost import StepCheckpointManager
    conf = (NeuralNetConfiguration.builder().seed(1).updater(Sgd(0.1)).list()
            .layer(DenseLayer(n_out=4, activation="tanh"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(3)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    mgr = StepCheckpointManager(str(tmp_path))
    mgr.save(net, 2)
    good = net.params().copy()
    net.set_params(good + 1.0)
    mgr.save(net, 4)
    (tmp_path / "checkpoint_step4.zip").write_bytes(b"torn checkpoint")
    assert mgr.latest()[0] == 4
    assert mgr.latest_valid()[0] == 2
    assert mgr.restore_into(net) == 2
    np.testing.assert_array_equal(net.params(), good)
    assert "checkpoint_corrupt_total" in \
        torch_metrics.registry().prometheus_text()


def test_latest_valid_none_when_all_corrupt(tmp_path):
    from deeplearning4j_torch.parallel.multihost import StepCheckpointManager
    mgr = StepCheckpointManager(str(tmp_path))
    (tmp_path / "checkpoint_step1.zip").write_bytes(b"garbage")
    assert mgr.latest_valid() is None
    assert mgr.restore_into(object()) is None
