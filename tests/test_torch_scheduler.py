"""The torch port's device scheduler (serving/scheduler.py) against the JAX
package's: the same registrations and the same scripted arbitration rounds
give the same grant sequence, deficits, dispatch and starvation counts, and
shed decisions, exactly. A live-slot check (threads) holds the port's grant
order by tier. Tolerance: none (equality)."""
import threading

import pytest

from deeplearning4j_torch.serving import scheduler as port_sched
from deeplearning4j_tpu.serving import scheduler as ref_sched

ENTRIES = [("crit", "critical", 1.0), ("std_a", "standard", 1.0),
           ("std_b", "standard", 3.0), ("bat", "batch", 1.0)]

ROUNDS = {
    "all_waiting": [["crit", "std_a", "std_b", "bat"]] * 3,
    "weighted_pair": [["std_a", "std_b"]] * 12,
    "starving_batch": [["std_a", "bat"]] * 6 + [["bat"]],
    "unregistered_fifo": [["ghost", "std_a"], ["ghost", "bat"], ["bat", "ghost"]],
    "mixed": [["bat", "std_b"], ["crit", "bat"], ["std_a", "std_b", "bat"],
              ["bat"], ["std_b", "std_a"]],
}


def _play(mod, rounds, **kw):
    sch = mod.DeviceScheduler(starvation_budget=2, **kw)
    for name, tier, weight in ENTRIES:
        sch.register(name, tier=tier, weight=weight)
    picks = [sch._select(list(r)) for r in rounds]
    return picks, sch.describe(), sch.config()


@pytest.mark.parametrize("name", sorted(ROUNDS))
def test_arbitration_matches_reference(name):
    assert _play(port_sched, ROUNDS[name]) == _play(ref_sched, ROUNDS[name])


@pytest.mark.parametrize("quantum", [0.5, 2.0])
def test_quantum_scales_deficits_as_reference(quantum):
    rounds = ROUNDS["weighted_pair"]
    assert _play(port_sched, rounds, quantum=quantum) == \
        _play(ref_sched, rounds, quantum=quantum)


@pytest.mark.parametrize("depths", [(0, 0), (8, 0), (0, 8), (3, 20), (7, 7)])
def test_should_shed_matches_reference(depths):
    got = []
    for mod in (port_sched, ref_sched):
        sch = mod.DeviceScheduler(shed_depth=8)
        sch.register("crit", tier="critical", depth_fn=lambda: depths[0])
        sch.register("std", tier="standard", depth_fn=lambda: depths[1])
        sch.register("bat", tier="batch", depth_fn=lambda: 0)
        got.append([sch.should_shed(n) for n in ("crit", "std", "bat", "nope")])
    assert got[0] == got[1]


@pytest.mark.parametrize("kw", [dict(quantum=0), dict(shed_depth=0),
                                dict(starvation_budget=0),
                                dict(tier_slo_ms={"gold": 1.0}),
                                dict(tier_slo_ms={"batch": -1.0}),
                                dict(quantum=2.0, shed_depth=4,
                                     tier_slo_ms={"critical": 20.0})],
                         ids=["quantum0", "depth0", "budget0", "unknown_tier",
                              "negative_slo", "valid"])
def test_reconfigure_matches_reference(kw):
    got = []
    for mod in (port_sched, ref_sched):
        sch = mod.DeviceScheduler()
        try:
            got.append(("ok", sch.reconfigure(**kw)))
        except ValueError as e:
            got.append(("error", str(e), sch.config()))
    assert got[0] == got[1]


def test_register_rejects_what_the_reference_rejects():
    for mod in (port_sched, ref_sched):
        sch = mod.DeviceScheduler()
        with pytest.raises(ValueError):
            sch.register("x", tier="gold")
        with pytest.raises(ValueError):
            sch.register("x", weight=0)
    assert port_sched.TIERS == ref_sched.TIERS
    assert port_sched.DEFAULT_TIER_SLO_MS == ref_sched.DEFAULT_TIER_SLO_MS


def test_live_slot_grants_by_tier_when_it_frees():
    """One holder keeps the slot while a batch-tier and a critical-tier
    waiter queue (batch first); on release the critical one goes first."""
    sch = port_sched.DeviceScheduler()
    sch.register("crit", tier="critical")
    sch.register("bat", tier="batch")
    order, queued = [], threading.Semaphore(0)
    release = threading.Event()

    def holder():
        with sch.slot("bat"):
            release.wait(timeout=10)

    def waiter(name):
        queued.release()
        with sch.slot(name):
            order.append(name)

    h = threading.Thread(target=holder)
    h.start()
    while not sch._busy:
        threading.Event().wait(0.001)
    threads = []
    for name in ("bat", "crit"):
        t = threading.Thread(target=waiter, args=(name,))
        t.start()
        queued.acquire()
        while len(sch._waiters) < len(threads) + 1:
            threading.Event().wait(0.001)
        threads.append(t)
    release.set()
    for t in [h] + threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert order == ["crit", "bat"]
