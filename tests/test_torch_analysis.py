"""The port's lock rules (JL401-JL404), baseline, CLI and lock recorder
against the JAX package's (the host-sync and serving rules are held in
tests/test_torch_analysis_host_sync.py and test_torch_analysis_serving.py).

- Every JL401-404 snippet of tests/test_analysis.py (the lock-rule classes
  and the JL4xx suppression cases) gives the same findings (rule, line,
  column, message) from both analyzers.
- On the JAX package's tree, with its suppression comments taken out so
  that every lock finding shows, the port's analyzer finds exactly what the
  JAX analyzer restricted to JL401-404 finds (fingerprints included).
- `lock_edges_from_source` is equal on every file of the port that
  constructs a lock.
- JL403 also counts the torch fences (`torch.cuda.synchronize()`, a
  stream's or an event's `.synchronize()`).
- The `lockcheck` cases of tests/test_analysis.py::TestLockcheck, against
  the port's ParallelInference on the CPU.
- The port's tree is clean against its committed baseline through
  `cli.main`, and every baseline entry carries a justification.
"""
import ast
import inspect
import json
import os
import textwrap
import threading

import numpy as np
import pytest

import deeplearning4j_torch as port
from deeplearning4j_torch.analysis import engine as pengine
from deeplearning4j_torch.analysis import lockcheck as plc
from deeplearning4j_torch.analysis import rules as prules
from deeplearning4j_torch.analysis.baseline import Baseline, default_baseline_path
from deeplearning4j_torch.analysis.cli import main as pmain
from deeplearning4j_torch.parallel import inference as pinf
from deeplearning4j_tpu.analysis import engine as rengine
from deeplearning4j_tpu.analysis import rules as rrules

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PORT_PKG = os.path.join(ROOT, "deeplearning4j_torch")
REF_PKG = os.path.join(ROOT, "deeplearning4j_tpu")
LOCK_RULES = ("JL401", "JL402", "JL403", "JL404")
REF_LOCK_RULES = [rrules.RULES_BY_ID[r] for r in LOCK_RULES]
PORT_LOCK_RULES = [prules.RULES_BY_ID[r] for r in LOCK_RULES]
SNIPPET_CLASSES = {"TestLockRule", "TestLockOrderRule", "TestBlockingUnderLockRule",
                   "TestFieldAtomicityRule", "TestSuppression"}


def _reference_snippets():
    """{id: source} of every lock snippet of tests/test_analysis.py."""
    path = os.path.join(HERE, "test_analysis.py")
    tree = ast.parse(open(path, encoding="utf-8").read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant) and \
                node.targets[0].id in ("LOCK_CYCLE_SRC", "DROPPED_RACE_SRC"):
            out[node.targets[0].id] = node.value.value
        if isinstance(node, ast.ClassDef) and node.name in SNIPPET_CLASSES:
            for fn in node.body:
                if not isinstance(fn, ast.FunctionDef):
                    continue
                consts = [c.value for c in ast.walk(fn) if isinstance(c, ast.Constant)
                          and isinstance(c.value, str) and "\n" in c.value
                          and "threading" in c.value]
                for k, src in enumerate(consts):
                    out[f"{node.name}.{fn.name}[{k}]"] = src
    return out


SNIPPETS = _reference_snippets()


def _key(f):
    return (f.rule, f.line, f.col, f.message, f.symbol)


def test_snippets_cover_every_lock_rule():
    assert len(SNIPPETS) == 19
    fired = {f.rule for src in SNIPPETS.values()
             for f in pengine.analyze_source(textwrap.dedent(src), "fixture.py",
                                             rules=PORT_LOCK_RULES)}
    assert fired == set(LOCK_RULES)


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_snippet_findings_equal_reference(name):
    src = textwrap.dedent(SNIPPETS[name])
    got = pengine.analyze_source(src, "fixture.py", rules=PORT_LOCK_RULES)
    want = rengine.analyze_source(src, "fixture.py", rules=REF_LOCK_RULES)
    assert [_key(f) for f in got] == [_key(f) for f in want]
    # and with the suppressions taken out
    naked = src.replace("# jaxlint:", "# lint:")
    got = pengine.analyze_source(naked, "fixture.py", rules=PORT_LOCK_RULES)
    want = rengine.analyze_source(naked, "fixture.py", rules=REF_LOCK_RULES)
    assert [_key(f) for f in got] == [_key(f) for f in want]


def _tree_sources(root):
    for fname in pengine.iter_python_files([root]):
        with open(fname, encoding="utf-8") as fh:
            yield fname, fh.read()


def test_reference_tree_findings_equal():
    """The JAX package's tree with its `# jaxlint:` comments taken out: the
    lock findings its own comments hide show, and both analyzers find the
    same ones."""
    got, want = [], []
    for fname, src in _tree_sources(REF_PKG):
        naked = src.replace("# jaxlint:", "# lint:")
        got += pengine.analyze_source(naked, fname, rules=PORT_LOCK_RULES)
        want += rengine.analyze_source(naked, fname, rules=REF_LOCK_RULES)
    fp = lambda fs: [(f.path, *_key(f), f.fingerprint) for f in fs]
    assert fp(got) == fp(want)
    assert len(got) >= 15 and {f.rule for f in got} >= {"JL403", "JL404"}


def _lock_files():
    out = []
    for fname, src in _tree_sources(PORT_PKG):
        if any(c in src for c in ("Lock(", "RLock(", "Condition(", "Semaphore(")):
            out.append(os.path.relpath(fname, ROOT))
    return out


@pytest.mark.parametrize("relpath", _lock_files())
def test_lock_edges_equal_reference(relpath):
    src = open(os.path.join(ROOT, relpath), encoding="utf-8").read()
    got = prules.lock_edges_from_source(src, relpath)
    want = rrules.lock_edges_from_source(src, relpath)
    assert {e: n.lineno for e, n in got.items()} == {e: n.lineno for e, n in want.items()}


@pytest.mark.parametrize("fence", ["torch.cuda.synchronize()", "self._stream.synchronize()",
                                   "done.synchronize()", "x.block_until_ready()"])
def test_jl403_counts_the_torch_fences(fence):
    src = textwrap.dedent(f"""
        import threading
        import torch
        class Srv:
            def __init__(self):
                self._lock = threading.Lock()
            def step(self, x, done):
                with self._lock:
                    {fence}
                {fence}
    """)
    found = [f for f in pengine.analyze_source(src, "fixture.py") if f.rule == "JL403"]
    assert [f.line for f in found] == [9]
    assert "host fence" in found[0].message and "Srv._lock" in found[0].message


# ---------------------------------------------------------------------------
# lockcheck (tests/test_analysis.py::TestLockcheck against the port)
# ---------------------------------------------------------------------------

def _pair_cls():
    class Pair:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def ab(self):
            with self._a:
                with self._b:
                    pass

        def ba(self):
            with self._b:
                with self._a:
                    pass
    return Pair


def test_recording_observes_nesting():
    with plc.recording():
        p = _pair_cls()()
        names = plc.adopt(p, "Pair")
        p.ab()
    assert names == ["Pair._a", "Pair._b"]
    assert plc.observed_edges() == {("Pair._a", "Pair._b"): 1}


def test_recording_restores_factories_even_when_the_body_raises():
    real, real_r = threading.Lock, threading.RLock
    with pytest.raises(KeyError):
        with plc.recording():
            assert threading.Lock is not real
            raise KeyError("body failed")
    assert threading.Lock is real and threading.RLock is real_r
    assert not isinstance(threading.Lock(), plc.LockProxy)


def test_rlock_reentry_is_not_an_edge():
    with plc.recording():
        r = threading.RLock()
        r.lockcheck_name = "R"
        with r:
            with r:
                pass
    assert plc.observed_edges() == {}


def test_cross_check_confirms_static_graph():
    with plc.recording():
        Pair = _pair_cls()
        p = Pair()
        plc.adopt(p, "Pair")
        p.ab()
        p.ba()
    static = prules.lock_edges_from_source(textwrap.dedent(inspect.getsource(Pair)))
    report = plc.cross_check(plc.observed_edges(), static)
    assert report.confirmed == {("Pair._a", "Pair._b"), ("Pair._b", "Pair._a")}
    assert not report.unexplained and not report.unexercised
    assert report.cycles == [["Pair._a", "Pair._b"]]
    assert not report.ok()


def test_cross_check_flags_unexplained_and_ignores_noise():
    report = plc.cross_check({("C.x", "C.y"): 3}, {("C.y", "C.x"): None})
    assert report.unexplained == {("C.x", "C.y")}
    assert report.unexercised == {("C.y", "C.x")}
    assert report.cycles
    quiet = plc.cross_check({("lock-9", "lock-10"): 1}, {("C.x", "C.y"): None})
    assert not quiet.unexplained and quiet.ok()


def test_instrument_wraps_only_bare_locks():
    class Mixed:
        def __init__(self):
            self._lock = threading.Lock()
            self._r = threading.RLock()
            self._cv = threading.Condition()
            self.count = 0

    m = Mixed()
    assert plc.instrument(m, "Mixed") == ["Mixed._lock", "Mixed._r"]
    assert isinstance(m._lock, plc.LockProxy) and not isinstance(m._cv, plc.LockProxy)
    plc.reset()
    with m._lock:
        with m._r:
            pass
    assert plc.observed_edges() == {("Mixed._lock", "Mixed._r"): 1}


def _served_net():
    conf = (port.NeuralNetConfiguration.builder().seed(1).list()
            .layer(port.DenseLayer(n_out=4, activation="relu"))
            .layer(port.OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(port.InputType.feed_forward(3)).build())
    return port.MultiLayerNetwork(conf).init(device="cpu")


def _static_inference_edges():
    with open(inspect.getsourcefile(pinf), encoding="utf-8") as fh:
        return prules.lock_edges_from_source(fh.read())


@pytest.mark.parametrize("mode", ["SEQUENTIAL", "BATCHED"])
def test_parallel_inference_runtime_vs_static(mode):
    """A live serve and shutdown of the port's ParallelInference, its locks
    recorded, cross-checked against its static graph: no cycle."""
    net = _served_net()
    x = np.ones((1, 3), np.float32)
    with plc.recording():
        srv = pinf.ParallelInference(net, inference_mode=getattr(pinf.InferenceMode, mode))
        names = plc.adopt(srv)
        try:
            threads = [threading.Thread(target=lambda: [srv.output(x) for _ in range(3)])
                       for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
        finally:
            srv.shutdown()
    assert "ParallelInference._lock" in names
    report = plc.cross_check(plc.observed_edges(), _static_inference_edges())
    assert report.ok(), f"live deadlock ordering: {report.cycles}"
    assert not report.unexplained


def test_instrumented_parallel_inference_vs_static():
    srv = pinf.ParallelInference(_served_net(), inference_mode=pinf.InferenceMode.SEQUENTIAL)
    names = plc.instrument(srv)
    assert any(n.startswith("ParallelInference.") for n in names)
    plc.reset()
    srv.output(np.ones((1, 3), np.float32))
    srv.shutdown()
    assert plc.cross_check(plc.observed_edges(), _static_inference_edges()).ok()


# ---------------------------------------------------------------------------
# the gate on the port's own tree
# ---------------------------------------------------------------------------

def test_port_tree_clean_against_committed_baseline(capsys):
    assert pmain([PORT_PKG, "--format", "json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["summary"]["new"] == 0 and report["summary"]["expired"] == 0
    entries = Baseline.load(default_baseline_path()).entries
    assert len(entries) == report["summary"]["baselined"]
    assert all(e.justification.strip() for e in entries)


def test_cli_gates_a_new_finding(tmp_path, capsys):
    f = tmp_path / "mod.py"
    f.write_text(textwrap.dedent(SNIPPETS["DROPPED_RACE_SRC"]))
    bl = str(tmp_path / "baseline.json")
    assert pmain([str(f), "--baseline", bl]) == 1
    assert pmain([str(f), "--baseline", bl, "--write-baseline"]) == 2
    assert "justif" in capsys.readouterr().err
    assert pmain([str(f), "--baseline", bl, "--write-baseline", "--justify", "known"]) == 0
    assert pmain([str(f), "--baseline", bl]) == 0
    assert pmain([str(f), "--rules", "JL999"]) == 2
    capsys.readouterr()
    assert pmain(["--rules"]) == 0
    assert [line.split()[0] for line in capsys.readouterr().out.splitlines()] == \
        ["JL101", "JL102", "JL103", *LOCK_RULES, "JL501", "JL502", "JL503"]
