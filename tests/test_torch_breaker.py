"""The torch port's circuit breaker (serving/breaker.py) against the JAX
package's, on a scripted clock: the same sequence of admissions, outcomes,
clock steps and reconfigurations gives the same decisions and the same
states, exactly, in both packages. Tolerance: none (every value is compared
for equality)."""
import pytest

from deeplearning4j_torch.optimize.metrics import registry as port_registry
from deeplearning4j_torch.serving import breaker as port_breaker
from deeplearning4j_tpu.serving import breaker as ref_breaker

# (op, argument): "allow" -> decision, "ok" / "fail" / "trip" -> outcome,
# "t" -> advance the scripted clock by the argument in seconds
SCRIPTS = {
    "threshold_then_cooldown": [
        ("allow", None), ("fail", None), ("allow", None), ("fail", None),
        ("allow", None), ("fail", None), ("allow", None), ("t", 5.0),
        ("allow", None), ("t", 5.1), ("allow", None), ("allow", None),
        ("ok", None), ("allow", None)],
    "instant_trip_on_nonfinite": [
        ("allow", None), ("trip", None), ("allow", None), ("t", 10.0),
        ("allow", None), ("trip", None), ("allow", None), ("t", 10.0),
        ("allow", None), ("ok", None), ("allow", None)],
    "half_open_probe_times_out": [
        ("trip", None), ("t", 10.0), ("allow", None), ("allow", None),
        ("t", 2.0), ("allow", None), ("t", 1.5), ("allow", None),
        ("fail", None), ("allow", None), ("t", 10.0), ("allow", None)],
    "success_resets_the_run": [
        ("fail", None), ("fail", None), ("ok", None), ("fail", None),
        ("fail", None), ("allow", None), ("fail", None), ("allow", None)],
    "straggler_failure_while_open": [
        ("trip", None), ("fail", None), ("fail", None), ("t", 9.9),
        ("allow", None), ("t", 0.2), ("allow", None), ("ok", None)],
}


def _run(mod, script, **kw):
    now = [1000.0]
    br = mod.CircuitBreaker("brk_parity", failure_threshold=3,
                            reset_timeout_s=10.0, probe_timeout_s=3.0,
                            clock=lambda: now[0], **kw)
    trail = []
    for op, arg in script:
        if op == "allow":
            trail.append(("allow", br.allow()))
        elif op == "ok":
            br.record_success()
        elif op == "fail":
            br.record_failure()
        elif op == "trip":
            br.record_failure(trip=True)
        else:
            now[0] += arg
        trail.append((br.state, br.consecutive_failures))
    return trail, br.describe()


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scripted_sequence_matches_reference(name):
    assert _run(port_breaker, SCRIPTS[name]) == _run(ref_breaker, SCRIPTS[name])


@pytest.mark.parametrize("kw", [dict(failure_threshold=0),
                                dict(reset_timeout_s=0.0),
                                dict(failure_threshold=4, reset_timeout_s=-1.0),
                                dict(failure_threshold=7, reset_timeout_s=2.5)],
                         ids=["threshold0", "reset0", "one_bad", "valid"])
def test_reconfigure_validates_both_before_mutating(kw):
    results = []
    for mod in (port_breaker, ref_breaker):
        br = mod.CircuitBreaker("brk_cfg", failure_threshold=5, reset_timeout_s=30.0)
        try:
            results.append(("ok", br.reconfigure(**kw)))
        except ValueError as e:
            results.append(("error", str(e), br.describe()))
    assert results[0] == results[1]


def test_metrics_match_reference_names_and_values():
    trail, _ = _run(port_breaker, SCRIPTS["threshold_then_cooldown"])
    reg = port_registry()
    assert reg.gauge("serving_breaker_state").value(model="brk_parity") == \
        port_breaker.STATE_VALUES["closed"]
    assert reg.counter("serving_breaker_transitions_total").value(
        model="brk_parity", to="open") >= 1
    assert port_breaker.STATE_VALUES == ref_breaker.STATE_VALUES
    with pytest.raises(ValueError):
        port_breaker.CircuitBreaker("x", failure_threshold=0)
    assert issubclass(port_breaker.BreakerOpenError, RuntimeError)
