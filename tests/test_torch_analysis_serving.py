"""The port's serving rules JL501-JL503 against the JAX analyzer's, and the
fault points they found untested.

- Every JL501/JL502 snippet of tests/test_analysis.py (the route and
  metrics classes and the JL5xx suppression cases) gives the same findings
  (rule, line, column, message) from both analyzers, with and without the
  suppression comments.
- JL502's pre-registration check on a temporary package tree (a serving
  module using a registered and an unregistered family) and JL503 on a
  temporary checkout: the same findings on the same layout, where the
  port's corpora are its own tests (tests/test_torch_*.py; a test of the
  JAX package covers no port point) and the table of points in its
  utils/faults.py docstring.
- On the JAX package's tree with its `# jaxlint:` comments taken out, the
  port's JL501-502 find exactly what the JAX analyzer restricted to them
  finds, fingerprints included.
- The port's tree is clean against its committed baseline for JL501-503,
  and every baselined JL5xx finding is justified.
- The three points JL503 found untested in the port, armed in both
  packages with the same plans and answered alike: `serve.schedule` (a
  typed batch failure, then service), `swap.warm` (a failed swap that
  changes nothing, then a swap), and `ps.push` (transient push faults
  absorbed by the HTTP client's retries; a failed push in the trainer's
  worker respawns it).
"""
import ast
import os
import textwrap

import jax
import numpy as np
import pytest

import deeplearning4j_torch as port
from deeplearning4j_torch.analysis import engine as pengine
from deeplearning4j_torch.analysis import rules as prules
from deeplearning4j_torch.analysis.baseline import Baseline, default_baseline_path
from deeplearning4j_torch.analysis.cli import main as pmain
from deeplearning4j_torch.optimize.metrics import registry as port_registry
from deeplearning4j_torch.optimize.resilience import RetryPolicy as PortRetry
from deeplearning4j_torch.parallel import param_server as port_ps
from deeplearning4j_torch.parallel.inference import BatchExecutionError as PortBatchError
from deeplearning4j_torch.serving import ModelPool as PortPool
from deeplearning4j_torch.serving import ServingGateway as PortGateway
from deeplearning4j_torch.serving import SwapError as PortSwapError
from deeplearning4j_torch.utils import faults as port_faults
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.analysis import engine as rengine
from deeplearning4j_tpu.analysis import rules as rrules
from deeplearning4j_tpu.optimize.metrics import registry as ref_registry
from deeplearning4j_tpu.optimize.resilience import CheckpointManager as RefManager
from deeplearning4j_tpu.optimize.resilience import RetryPolicy as RefRetry
from deeplearning4j_tpu.parallel import param_server as ref_ps
from deeplearning4j_tpu.parallel.inference import BatchExecutionError as RefBatchError
from deeplearning4j_tpu.serving import ModelPool as RefPool
from deeplearning4j_tpu.serving import ServingGateway as RefGateway
from deeplearning4j_tpu.serving import SwapError as RefSwapError
from deeplearning4j_tpu.utils import faults as ref_faults

from test_serving_gateway import make_net, rand_x
from test_torch_model_pool import port_twin
from test_torch_word2vec import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PORT_PKG = os.path.join(ROOT, "deeplearning4j_torch")
REF_PKG = os.path.join(ROOT, "deeplearning4j_tpu")
SERVING_RULES = ("JL501", "JL502")
PORT_RULES = [prules.RULES_BY_ID[r] for r in SERVING_RULES]
REF_RULES = [rrules.RULES_BY_ID[r] for r in SERVING_RULES]
SNIPPET_CLASSES = ("TestRouteTypedErrorRule", "TestMetricsDisciplineRule")


def _reference_snippets():
    """{id: source} of the JL501/JL502 snippets of tests/test_analysis.py."""
    tree = ast.parse(open(os.path.join(HERE, "test_analysis.py"), encoding="utf-8").read())
    out = {}
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        for fn in node.body:
            if not isinstance(fn, ast.FunctionDef) or not fn.name.startswith("test_"):
                continue
            if node.name in SNIPPET_CLASSES:
                srcs = [c.value for c in ast.walk(fn) if isinstance(c, ast.Constant)
                        and isinstance(c.value, str) and "\n" in c.value
                        and "def " in c.value]
            elif (node.name, fn.name) == ("TestSuppression", "test_disable_each_new_rule"):
                cases = next(n for n in ast.walk(fn) if isinstance(n, ast.Dict))
                srcs = [v.value for k, v in zip(cases.keys, cases.values)
                        if k.value in SERVING_RULES]
            else:
                continue
            for k, src in enumerate(srcs):
                out[f"{node.name}.{fn.name}[{k}]"] = src
    return out


SNIPPETS = _reference_snippets()


def _key(f):
    return (f.rule, f.line, f.col, f.message, f.symbol)


def test_snippets_cover_both_rules():
    assert len(SNIPPETS) == 11
    fired = {f.rule for src in SNIPPETS.values()
             for f in pengine.analyze_source(textwrap.dedent(src), "fixture.py",
                                             rules=PORT_RULES)}
    assert fired == set(SERVING_RULES)


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_snippet_findings_equal_reference(name):
    src = textwrap.dedent(SNIPPETS[name])
    for text in (src, src.replace("# jaxlint:", "# lint:")):
        got = pengine.analyze_source(text, "fixture.py", rules=PORT_RULES)
        want = rengine.analyze_source(text, "fixture.py", rules=REF_RULES)
        assert [_key(f) for f in got] == [_key(f) for f in want]


# ---------------------------------------------------------------------------
# temporary trees
# ---------------------------------------------------------------------------

def _serving_tree(root, pkg, family):
    """tests/test_analysis.py's miniature: <pkg>/serving/mod.py using
    `family`, with only 'registered_total' pre-registered."""
    serving = root / pkg / "serving"
    serving.mkdir(parents=True)
    (root / pkg / "metrics.py").write_text(textwrap.dedent("""
        def register_serving_metrics(reg):
            reg.counter("registered_total", "help")
    """))
    mod = serving / "mod.py"
    mod.write_text(textwrap.dedent(f"""
        def handle(self, reg):
            reg.counter("{family}", "help").inc()
            reg.counter("registered_total", "help").inc()
    """))
    return str(mod)


@pytest.mark.parametrize("family", ["unregistered_total", "registered_total"])
def test_preregistration_on_a_package_tree(tmp_path, family):
    want = [f for f in rengine.analyze_paths(
        [_serving_tree(tmp_path / "ref", "deeplearning4j_tpu", family)])
        if f.rule == "JL502"]
    got = [f for f in pengine.analyze_paths(
        [_serving_tree(tmp_path / "port", "deeplearning4j_torch", family)])
        if f.rule == "JL502"]
    assert [_key(f) for f in got] == [_key(f) for f in want]
    assert len(got) == (family == "unregistered_total")


FAULT_MOD = """
    from .utils import faults
    def run():
        faults.fire("serve.forward")
        faults.check("step.nonfinite")
"""


def _fault_trees(root, *, tested, documented, jax_test=False):
    """The same module in a JAX package checkout (tests/test_mod.py,
    docs/faults.md) and in the port's (tests/test_torch_mod.py and the
    utils/faults.py docstring)."""
    mods = {}
    for side, pkg in (("ref", "deeplearning4j_tpu"), ("port", "deeplearning4j_torch")):
        base = root / side
        (base / pkg / "utils").mkdir(parents=True)
        (base / "tests").mkdir()
        (base / "docs").mkdir()
        points = "'serve.forward', 'DL4JTPU_FAULT_STEP_NONFINITE'" if tested else "'other'"
        test_name = "test_mod.py" if side == "ref" or jax_test else "test_torch_mod.py"
        (base / "tests" / test_name).write_text(f"POINTS = [{points}]\n")
        if side == "port" and jax_test:
            (base / "tests" / "test_torch_mod.py").write_text("POINTS = ['other']\n")
        table = "serve.forward   drops a forward\nstep.nonfinite  a flag\n" \
            if documented else "nothing\n"
        (base / "docs" / "faults.md").write_text(
            "\n".join(f"| {line} |" for line in table.splitlines()) + "\n")
        (base / pkg / "utils" / "faults.py").write_text(f'"""Points:\n\n{table}"""\n')
        mod = base / pkg / "mod.py"
        mod.write_text(textwrap.dedent(FAULT_MOD))
        mods[side] = str(mod)
    return mods


def _kinds(findings):
    return [(f.line, f.col, "test" if "test" in f.message else "table") for f in findings
            if f.rule == "JL503"]


@pytest.mark.parametrize("tested", [True, False], ids=["tested", "untested"])
@pytest.mark.parametrize("documented", [True, False], ids=["documented", "undocumented"])
def test_fault_coverage_on_a_checkout(tmp_path, tested, documented):
    mods = _fault_trees(tmp_path, tested=tested, documented=documented)
    want = _kinds(rengine.analyze_paths([mods["ref"]]))
    got = _kinds(pengine.analyze_paths([mods["port"]]))
    assert got == want
    assert len(got) == 2 * (not tested) + 2 * (not documented)


def test_a_test_of_the_jax_package_covers_no_port_point(tmp_path):
    mods = _fault_trees(tmp_path, tested=True, documented=True, jax_test=True)
    assert _kinds(rengine.analyze_paths([mods["ref"]])) == []
    got = [f for f in pengine.analyze_paths([mods["port"]]) if f.rule == "JL503"]
    assert [f.line for f in got] == [4, 5]
    assert all("tests/test_torch_*.py" in f.message for f in got)


def test_reference_tree_findings_equal():
    """The JAX package's tree with its `# jaxlint:` comments taken out."""
    got, want = [], []
    for fname in pengine.iter_python_files([REF_PKG]):
        with open(fname, encoding="utf-8") as fh:
            naked = fh.read().replace("# jaxlint:", "# lint:")
        got += pengine.analyze_source(naked, fname, rules=PORT_RULES)
        want += rengine.analyze_source(naked, fname, rules=REF_RULES)
    fp = lambda fs: [(f.path, *_key(f), f.fingerprint) for f in fs]
    assert fp(got) == fp(want)
    assert len([f for f in got if f.rule == "JL502"]) >= 15


def test_port_tree_clean_for_the_serving_rules(capsys):
    import json
    assert pmain([PORT_PKG, "--rules", "JL501,JL502,JL503", "--format", "json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["summary"]["new"] == 0
    entries = [e for e in Baseline.load(default_baseline_path()).entries
               if e.rule.startswith("JL5")]
    assert len(entries) == report["summary"]["baselined"] > 0
    assert all(e.justification.strip() for e in entries)
    assert not [e for e in entries if e.rule in ("JL501", "JL503")]


# ---------------------------------------------------------------------------
# the fault points JL503 found untested, armed in both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nets():
    r = make_net()
    return r, port_twin(r)


def _gateways(nets, **kw):
    out = []
    for pool_cls, gw_cls, net in zip((RefPool, PortPool), (RefGateway, PortGateway), nets):
        gw = gw_cls(pool_cls())
        gw.add_model("m", net, **kw)
        out.append(gw)
    return out


def test_serve_schedule_fault_is_typed_and_the_server_survives(nets):
    x = rand_x(1)
    outcomes = []
    for gw, faults, err in zip(_gateways(nets, tier="critical", check_finite=False),
                               (ref_faults, port_faults), (RefBatchError, PortBatchError)):
        try:
            with faults.injected("serve.schedule", "fail:1"):
                with pytest.raises(err):
                    gw.predict("m", x)
                assert faults.fired_count("serve.schedule") == 1
            outcomes.append(np.asarray(gw.predict("m", x)))
            assert gw.pool.get("m").engine.total_batch_failures >= 1
        finally:
            gw.pool.shutdown()
    np.testing.assert_allclose(outcomes[1], outcomes[0], rtol=1e-5, atol=1e-7)


def _failed_swaps(registry):
    return registry().counter("serving_swaps_total", "").value(
        model="m", outcome="failed", precision="fp32")


def test_swap_warm_fault_rolls_back_as_failed(tmp_path):
    d = str(tmp_path / "ckpt")
    RefManager(d).save(make_net(seed=42, train_seed=7))
    r = make_net(seed=42)
    for gw_net, pool_cls, gw_cls, faults, err, reg in (
            (r, RefPool, RefGateway, ref_faults, RefSwapError, ref_registry),
            (port_twin(r), PortPool, PortGateway, port_faults, PortSwapError,
             port_registry)):
        from deeplearning4j_torch.optimize.resilience import CheckpointManager as PM
        mgr = RefManager(d) if gw_cls is RefGateway else PM(d)
        gw = gw_cls(pool_cls())
        gw.add_model("m", gw_net, checkpoints=mgr, batch_limit=4)
        before = [np.array(a) for a in jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, gw_net.params_tree))]
        failed0 = _failed_swaps(reg)
        try:
            with faults.injected("swap.warm", "fail:1"):
                with pytest.raises(err, match="warm forward failed"):
                    gw.swap("m")
            assert _failed_swaps(reg) == failed0 + 1
            after = [np.array(a) for a in jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(np.asarray, gw_net.params_tree))]
            assert all(np.array_equal(a, b) for a, b in zip(before, after))
            assert gw.swap("m")["swapped"] is True   # the plan is spent
        finally:
            gw.pool.shutdown()


def test_swap_warm_fault_in_a_fused_group_member(tmp_path):
    """The fused group's member swap takes the same point: the failed swap
    leaves the member's answers as they were."""
    from test_torch_fused_serving import member_conf
    from test_torch_model_pool import _graph_members, _x8
    from deeplearning4j_torch.optimize.resilience import CheckpointManager as PM
    members = _graph_members()
    d = str(tmp_path / "a")
    PM(d).save(port.ComputationGraph(member_conf(port, 1, 3)).init(device="cpu", seed=99))
    pool = PortPool()
    pool.add_fused_group("g", members, checkpoints={"a": d}, batch_limit=2)
    try:
        ea, x = pool.get("a"), _x8(2)
        before = ea.engine.output(x, transform=ea.transform, tag="a")
        with port_faults.injected("swap.warm", "fail:1"):
            with pytest.raises(PortSwapError, match="warm forward failed"):
                pool.swap("a")
            assert port_faults.fired_count("swap.warm") == 1
        np.testing.assert_array_equal(ea.engine.output(x, transform=ea.transform, tag="a"),
                                      before)
        assert pool.swap("a")["swapped"]
    finally:
        pool.shutdown()


FAST = dict(max_retries=4, base_delay=0.001, multiplier=2.0, max_delay=0.005,
            jitter=0.0, deadline=10.0)


def _ps_data(n=64, seed=42):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=n)]


def test_push_faults_absorbed_by_the_http_client(nets):
    """tests/test_resilience.py's remote worker under ps.pull fail:1,3 and
    ps.push fail:2, in both packages: every batch trains."""
    x, y = _ps_data()
    applied = []
    for pkg, ps, faults, retry, net in (
            (ref, ref_ps, ref_faults, RefRetry, make_net()),
            (port, port_ps, port_faults, PortRetry, port_twin(make_net()))):
        node = ps.ParameterServerHttpNode(ps.ParameterServer(net), port=0).start()
        try:
            with faults.injected("ps.pull", "fail:1,3"), \
                    faults.injected("ps.push", "fail:2"):
                applied.append(ps.remote_worker_fit(net, node.url, pkg.DataSet(x, y),
                                                    epochs=1, batch_size=16,
                                                    retry=retry(**FAST)))
                assert faults.fired_count("ps.push") == 1
        finally:
            node.stop()
    assert applied == [4, 4]


def test_push_fault_respawns_the_trainers_worker(nets):
    x, y = _ps_data()
    net = port_twin(make_net())
    respawns = port_registry().counter("worker_respawns_total")
    before = respawns.value()
    tr = port_ps.ParameterServerTrainer(net, workers=2, max_worker_restarts=2)
    with port_faults.injected("ps.push", "fail:1"):
        tr.fit(port.DataSet(x, y), epochs=1, batch_size=16)
        assert port_faults.fired_count("ps.push") >= 1
    assert tr.server.version > 0
    assert respawns.value() == before + 1
