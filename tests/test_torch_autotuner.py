"""The torch port's serving control loop (serving/autotuner.py) against the
JAX package's:

- `validate_entry` accepts and refuses the same ledger rows with the same
  problems.
- SLOMonitor turns the same windowed observations (explicit ``t=`` stamps
  on a scripted clock) into the same per-tier verdicts, shed rates,
  dominant phases and open breakers.
- AutoTuner, driven by the same scripted monitor, makes the same moves:
  the same ledger rows, knob values and states through a convergence, a
  guardrail refusal, a revert and a freeze/thaw.
- The default ledger is never the repository's autotune_ledger.jsonl: it
  is $DL4JTORCH_AUTOTUNE_LEDGER or ~/.deeplearning4j_torch/.
- A port gateway's /debug/tuner reports an attached tuner.

Tolerance: none (equality).
"""
import pathlib

import numpy as np
import pytest

from deeplearning4j_torch.optimize.metrics import registry as port_registry
from deeplearning4j_torch.serving import ModelPool as PortPool
from deeplearning4j_torch.serving import ServingGateway as PortGateway
from deeplearning4j_torch.serving import autotuner as port_at
from deeplearning4j_tpu.optimize.metrics import registry as ref_registry
from deeplearning4j_tpu.serving import autotuner as ref_at
from test_serving_gateway import make_net, rand_x
from test_torch_model_pool import port_twin

ROOT = pathlib.Path(__file__).resolve().parents[1]

_EPOCH = [20_000_000.0]


def fresh_t0():
    _EPOCH[0] += 100_000.0
    return _EPOCH[0]


def _row(kind, **kw):
    base = {"schema": 1, "ts": 1.5, "seq": 3, "kind": kind}
    fields = {
        "move": dict(knob="k", old=1.0, new=2, direction=-1, evidence={}),
        "outcome": dict(ref=2, knob="k", outcome="kept", old=1.0, new=2.0,
                        before_score=1.0, after_score=0.5, reverted=False,
                        evidence={}),
        "refusal": dict(knob="k", candidate=-1.0, lo=0.0, hi=4.0, reason="guardrail"),
        "freeze": dict(reason="breaker_open", evidence={}, restored={}),
        "unfreeze": dict(healthy_s=60.0),
    }.get(kind, {})
    base.update(fields)
    base.update(kw)
    return base


ROWS = {
    "move": _row("move"), "outcome": _row("outcome"), "refusal": _row("refusal"),
    "freeze": _row("freeze"), "unfreeze": _row("unfreeze"),
    "unknown_kind": _row("wander"), "unknown_field": _row("move", extra=1),
    "missing_field": {k: v for k, v in _row("move").items() if k != "knob"},
    "wrong_type": _row("move", direction=1.0),
    "bad_outcome": _row("outcome", outcome="great"),
    "bad_reason": _row("freeze", reason="boredom"),
    "schema": _row("unfreeze", schema=2), "not_a_dict": [1, 2],
}


@pytest.mark.parametrize("name", sorted(ROWS))
def test_validate_entry_matches_reference(name):
    assert port_at.validate_entry(ROWS[name]) == ref_at.validate_entry(ROWS[name])
    assert port_at.LEDGER_SCHEMA_VERSION == ref_at.LEDGER_SCHEMA_VERSION
    assert port_at.MOVE_OUTCOMES == ref_at.MOVE_OUTCOMES
    assert port_at.FREEZE_REASONS == ref_at.FREEZE_REASONS


def test_ledger_default_is_never_the_repository_file(tmp_path, monkeypatch):
    repo_ledger = ROOT / "autotune_ledger.jsonl"
    before = repo_ledger.read_bytes() if repo_ledger.exists() else None
    monkeypatch.delenv(port_at.LEDGER_ENV, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    path = port_at.default_ledger_path()
    assert path == str(tmp_path / ".deeplearning4j_torch" / "autotune_ledger.jsonl")
    port_at.append_entry(_row("unfreeze"))
    with open(path, "a") as f:
        f.write('{"torn": ')
    assert port_at.read_ledger() == [_row("unfreeze")]
    monkeypatch.setenv(port_at.LEDGER_ENV, str(tmp_path / "env.jsonl"))
    assert port_at.default_ledger_path() == str(tmp_path / "env.jsonl")
    assert port_at.LEDGER_ENV != ref_at.LEDGER_ENV
    with pytest.raises(ValueError):
        port_at.append_entry(ROWS["unknown_kind"])
    after = repo_ledger.read_bytes() if repo_ledger.exists() else None
    assert after == before


# ------------------------------------------------------------ the monitor

class _Breaker:
    def __init__(self, state="closed"):
        self.state = state


class _Entry:
    def __init__(self, name, tier, breaker=None):
        self.name, self.tier, self.breaker, self.group = name, tier, breaker, None
        self.weight = 1.0


class _Sched:
    def __init__(self, slos):
        self.tier_slo_ms = dict(slos)


class _Pool:
    def __init__(self, entries=(), scheduler=None):
        self._entries, self.scheduler = list(entries), scheduler

    def entries(self):
        return list(self._entries)


def _observe(registry, t0):
    """The same windowed traffic, stamped on the scripted clock: gold's p99
    over its SLO with queue_wait dominant, silver healthy, a shed share."""
    reg = registry()
    lat = reg.histogram("serving_latency_ms")
    for i, ms in enumerate((2.0, 3.0, 4.0, 30.0, 35.0)):
        lat.labels(model="atm_gold").observe(ms, t=t0 + 1.0 + 0.1 * i)
        lat.labels(tier="gold").observe(ms, t=t0 + 1.0 + 0.1 * i)
    for ms in (1.0, 1.5):
        lat.labels(model="atm_silver").observe(ms, t=t0 + 1.5)
        lat.labels(tier="silver").observe(ms, t=t0 + 1.5)
    ph = reg.histogram("serving_phase_ms")
    ph.labels(model="atm_gold", tier="gold", phase="queue_wait").observe(20.0, t=t0 + 1.2)
    ph.labels(model="atm_gold", tier="gold", phase="device").observe(5.0, t=t0 + 1.2)
    reg.counter("serving_requests_total").labels(model="atm_gold", status="ok").inc(8)
    reg.counter("serving_shed_total").labels(model="atm_gold", reason="queue_full").inc(2)


def _monitor_run(mod, registry, t0):
    now = [t0]
    pool = _Pool([_Entry("atm_gold", "gold"),
                  _Entry("atm_silver", "silver", breaker=_Breaker("open"))],
                 _Sched({"gold": 10.0, "silver": 5.0}))
    mon = mod.SLOMonitor(pool, window_s=30.0, min_samples=2, clock=lambda: now[0])
    first = mon.tick()
    _observe(registry, t0)
    now[0] = t0 + 2.0
    second = mon.tick()
    return [(r.evidence(), r.score, r.healthy, r.worst.tier if r.worst else None)
            for r in (first, second)]


def _same_tier_children():
    """Give both registries the same tier-labelled latency children: a
    monitor reports every tier it finds there, and other test files of the
    same process may have served tiers through one package only."""
    hists = [reg().histogram("serving_latency_ms") for reg in (port_registry, ref_registry)]
    tiers = {labels["tier"] for h in hists for labels, _ in h.items() if "tier" in labels}
    for h in hists:
        for tier in tiers:
            h.labels(tier=tier)


def test_monitor_verdicts_match_reference():
    t0 = fresh_t0()
    _same_tier_children()
    got = _monitor_run(port_at, port_registry, t0)
    assert got == _monitor_run(ref_at, ref_registry, t0)
    assert got[1][3] == "gold" and got[1][0]["tiers"]["gold"]["top_phase"] == "queue_wait"


# ------------------------------------------------------------ the tuner

class _ScriptedMonitor:
    """p99 = latency_fn() against a fixed SLO; ts advances 1 s a tick."""

    def __init__(self, mod, latency_fn, slo):
        self.mod, self.latency_fn, self.slo = mod, latency_fn, float(slo)
        self.breakers, self.t = [], 0.0

    def tick(self):
        self.t += 1.0
        v = self.mod.TierVerdict("gold", float(self.latency_fn()), self.slo,
                                 requests=100)
        return self.mod.MonitorReport(self.t, {"gold": v},
                                      breakers_open=list(self.breakers), min_samples=1)


SCENARIOS = {
    # (start, p99 as a function of the knob, SLO, ticks, breaker open on ticks)
    "converge": (10.0, lambda v: 2.0 + v, 5.0, 12, ()),
    "guardrail": (0.0, lambda v: 8.0, 5.0, 3, ()),
    "revert": (10.0, lambda v: 25.0 - v, 8.0, 4, ()),
    "freeze_thaw": (10.0, lambda v: 2.0 + v, 5.0, 8, (2, 3)),
}


def _tune(mod, tmp_path, name):
    start, model, slo, ticks, open_on = SCENARIOS[name]
    store = {"v": start}
    knob = mod.Knob(f"at_{name}", get=lambda: store["v"],
                    set=lambda x: store.__setitem__("v", x),
                    lo=0.0, hi=16.0, step=2.0, mode="add", direction=-1)
    mon = _ScriptedMonitor(mod, lambda: model(store["v"]), slo)
    clock = [0.0]
    ledger = str(tmp_path / f"{mod.__name__.split('.')[0]}_{name}.jsonl")
    tuner = mod.AutoTuner(_Pool(), monitor=mon, knobs=[knob], ledger_path=ledger,
                          settle_ticks=1, freeze_cooldown_s=2.0,
                          clock=lambda: clock[0])
    trail = []
    for i in range(ticks):
        clock[0] = float(i)
        mon.breakers = ["m"] if i in open_on else []
        tuner.tick()
        trail.append((store["v"], tuner.describe()["state"], knob.direction))
    d = tuner.describe()
    return trail, mod.read_ledger(ledger), d["known_good"], sorted(d)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_hill_climb_matches_reference(tmp_path, name):
    got, want = _tune(port_at, tmp_path, name), _tune(ref_at, tmp_path, name)
    assert got == want
    assert got[1] and all(port_at.validate_entry(r) == [] for r in got[1])


def test_knob_rejects_what_the_reference_rejects():
    for kw in (dict(mode="pow"), dict(mode="mul", step=1.0),
               dict(mode="add", step=0.0), dict(lo=2.0, hi=1.0)):
        args = dict(lo=0.0, hi=1.0, step=2.0, mode="mul")
        args.update(kw)
        for mod in (port_at, ref_at):
            with pytest.raises(ValueError):
                mod.Knob("k", get=lambda: 0.0, set=lambda v: None, **args)


def test_gateway_reports_an_attached_tuner(tmp_path):
    gw = PortGateway(PortPool())
    gw.add_model("m", port_twin(make_net()), batch_limit=2, tier="critical")
    try:
        assert gw._debug_tuner_route(None)[0] == 404
        ledger = str(tmp_path / "ledger.jsonl")
        tuner = gw.attach_tuner(ledger_path=ledger, start=False)
        gw.predict("m", rand_x(2))
        tuner.tick()
        code, body = gw._debug_tuner_route(None)
        assert code == 200 and body["enabled"] and body["ledger_path"] == ledger
        names = {k["name"] for k in body["knobs"]}
        assert {"linger_ms:m", "breaker_threshold:m", "breaker_reset_s:m",
                "weight:m", "quantum", "shed_depth"} == names
        assert np.isfinite(tuner.monitor.tick().score)
    finally:
        gw.stop()
