"""The port's host-sync rules JL101-JL103 and its tracecheck shim against the
JAX package's.

- Every JL1xx snippet of tests/test_analysis.py (TestSyncRules, and the
  JL101 cases of TestSuppression) gives the same findings (rule, line,
  column, message) from both analyzers, with and without the suppression
  comments.
- On the JAX package's tree with its `# jaxlint:` comments taken out, the
  port's JL101-103 find exactly what the JAX analyzer restricted to them
  finds, fingerprints included. A finding from one of torch's spellings is
  the only one that may differ; `TORCH_SPELLING_EXTRAS` lists each by
  fingerprint, and it is empty.
- Torch's spellings on snippets: `.cpu()` and `.numpy()` in a hot site are
  JL102, `.to("cpu")` (by position, keyword or `torch.device`) is JL103; a
  move to the card, a dtype cast and a cold function are not.
- tracecheck: one sequence of operations through the JAX shim on jax arrays
  and through the port's on torch tensors gives the same counts, site by
  site, in the local tally and in `host_syncs_total{site}`; torch's own
  copies to the host count too; handing a spy back into torch (a network's
  `output`, a torch function) and `fenced_read` are uncounted.
- `sync_debug` restores the mode it set, tallies the sync warnings by call
  site, re-issues other warnings, and raises without a CUDA device.
"""
import ast
import os
import textwrap
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.analysis import engine as pengine
from deeplearning4j_torch.analysis import rules as prules
from deeplearning4j_torch.analysis import tracecheck as ptc
from deeplearning4j_torch.optimize.metrics import registry as port_registry
from deeplearning4j_tpu.analysis import engine as rengine
from deeplearning4j_tpu.analysis import rules as rrules
from deeplearning4j_tpu.analysis import tracecheck as rtc
from deeplearning4j_tpu.optimize.metrics import registry as ref_registry

from test_torch_word2vec import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
REF_PKG = os.path.join(os.path.dirname(HERE), "deeplearning4j_tpu")
SYNC_RULES = ("JL101", "JL102", "JL103")
PORT_RULES = [prules.RULES_BY_ID[r] for r in SYNC_RULES]
REF_RULES = [rrules.RULES_BY_ID[r] for r in SYNC_RULES]
#: fingerprints of findings only torch's spellings give on the JAX tree
TORCH_SPELLING_EXTRAS = set()
JL101_SUPPRESSION = {"test_disable_single_rule", "test_disable_all",
                     "test_disable_other_rule_does_not_mask"}


def _reference_snippets():
    """{id: source} of the JL1xx snippets of tests/test_analysis.py."""
    tree = ast.parse(open(os.path.join(HERE, "test_analysis.py"), encoding="utf-8").read())
    out = {}
    for node in tree.body:
        if not (isinstance(node, ast.ClassDef)
                and node.name in ("TestSyncRules", "TestSuppression")):
            continue
        for fn in node.body:
            if not isinstance(fn, ast.FunctionDef) or (
                    node.name == "TestSuppression" and fn.name not in JL101_SUPPRESSION):
                continue
            srcs = [c.value for c in ast.walk(fn) if isinstance(c, ast.Constant)
                    and isinstance(c.value, str) and "\n" in c.value
                    and "def " in c.value]
            for k, src in enumerate(srcs):
                out[f"{node.name}.{fn.name}[{k}]"] = src
    return out


SNIPPETS = _reference_snippets()


def _key(f):
    return (f.rule, f.line, f.col, f.message, f.symbol)


def test_snippets_cover_every_sync_rule():
    assert len(SNIPPETS) == 10
    fired = {f.rule for src in SNIPPETS.values()
             for f in pengine.analyze_source(textwrap.dedent(src), "fixture.py",
                                             rules=PORT_RULES)}
    assert fired == set(SYNC_RULES)


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_snippet_findings_equal_reference(name):
    src = textwrap.dedent(SNIPPETS[name])
    for text in (src, src.replace("# jaxlint:", "# lint:")):
        got = pengine.analyze_source(text, "fixture.py", rules=PORT_RULES)
        want = rengine.analyze_source(text, "fixture.py", rules=REF_RULES)
        assert [_key(f) for f in got] == [_key(f) for f in want]


def test_reference_tree_findings_equal():
    got, want = [], []
    for fname in pengine.iter_python_files([REF_PKG]):
        with open(fname, encoding="utf-8") as fh:
            naked = fh.read().replace("# jaxlint:", "# lint:")
        got += pengine.analyze_source(naked, fname, rules=PORT_RULES)
        want += rengine.analyze_source(naked, fname, rules=REF_RULES)
    extra = [f for f in got if f.fingerprint in TORCH_SPELLING_EXTRAS]
    fp = lambda fs: [(f.path, *_key(f), f.fingerprint) for f in fs]
    assert fp([f for f in got if f not in extra]) == fp(want)
    assert {f.fingerprint for f in extra} == TORCH_SPELLING_EXTRAS
    assert {f.rule for f in got} == set(SYNC_RULES) - {"JL102"} and len(got) >= 30


# ---------------------------------------------------------------------------
# torch's spellings
# ---------------------------------------------------------------------------

def _hot(expr):
    return textwrap.dedent(f"""
        import torch
        def fit(model, data):
            for batch in data:
                out = {expr}
            return out
    """)


@pytest.mark.parametrize("expr,rule", [
    ("batch.loss.cpu()", "JL102"), ("batch.loss.numpy()", "JL102"),
    ("batch.loss.detach().cpu().numpy()", "JL102"),
    ('batch.loss.to("cpu")', "JL103"), ('batch.loss.to(device="cpu")', "JL103"),
    ('batch.loss.to(torch.device("cpu"))', "JL103"),
    ('batch.loss.to("cpu", torch.float64)', "JL103"),
    ('batch.loss.to("cuda")', None), ("batch.loss.to(torch.float16)", None),
    ("batch.loss.cpu(0)", None),
])
def test_torch_spellings_in_a_hot_loop(expr, rule):
    found = [f for f in pengine.analyze_source(_hot(expr), "fixture.py", rules=PORT_RULES)]
    assert {f.rule for f in found} == ({rule} if rule else set())
    assert all(f.line == 5 and f.symbol == "fit" for f in found)
    # the JAX analyzer knows none of them
    assert not rengine.analyze_source(_hot(expr), "fixture.py", rules=REF_RULES)


def test_torch_spellings_on_a_cold_path_and_suppressed():
    cold = textwrap.dedent("""
        def summarize(t):
            return t.cpu().numpy(), t.to("cpu")
    """)
    assert not pengine.analyze_source(cold, "fixture.py", rules=PORT_RULES)
    quiet = _hot('batch.loss.to("cpu")  # jaxlint: disable=JL103')
    assert not pengine.analyze_source(quiet, "fixture.py", rules=PORT_RULES)


# ---------------------------------------------------------------------------
# tracecheck against the JAX shim
# ---------------------------------------------------------------------------

def _sequence(tc, asarray, where):
    """One sequence of host reads, arithmetic and re-entry through shim
    `tc`, on arrays made by `asarray`; `where(x)` hands a value back into
    the array library."""
    tc.reset_counts()
    tree = tc.watch({"loss": asarray(1.5), "w": [asarray([1.0, 2.0, 3.0])], "n": 3},
                    site="seq.out")
    loss, w = tree["loss"], tree["w"][0]
    assert isinstance(loss, tc.SyncSpy) and tree["n"] == 3
    float(loss), int(loss), bool(loss), loss.item()
    [0, 1, 2][tc.watch(asarray(1), site="seq.index")]
    np.asarray(w), w.tolist(), list(range(3))[tc.watch(asarray(2), site="seq.index")]
    (w + 1, w * 2, -w, w[0], w.shape, len(w))          # uncounted
    where(w)                                            # re-entry: uncounted
    host = tc.fenced_read(w)                            # deliberate: uncounted
    np.testing.assert_array_equal(np.asarray(host), [1.0, 2.0, 3.0])
    step = tc.wrap(lambda x: x * 3, site="seq.wrap")
    assert int(step(asarray(2.0))) == 6
    return {s: tc.sync_count(s) for s in ("seq.out", "seq.index", "seq.wrap")}


def test_counts_equal_the_jax_shim_site_by_site():
    fam_ref = ref_registry().counter(rtc.METRIC_NAME, "")
    fam_port = port_registry().counter(ptc.METRIC_NAME, "")
    before = [fam.value(site="seq.out") for fam in (fam_ref, fam_port)]
    want = _sequence(rtc, jnp.asarray, jnp.asarray)
    got = _sequence(ptc, torch.tensor, torch.sum)
    assert got == want == {"seq.out": 6, "seq.index": 2, "seq.wrap": 1}
    assert fam_ref.value(site="seq.out") - before[0] == \
        fam_port.value(site="seq.out") - before[1] == 6


def test_torch_copies_to_the_host_count():
    ptc.reset_counts()
    x = ptc.watch(torch.arange(6.0).reshape(2, 3), site="copies")
    x.cpu(), x.numpy(), x.to("cpu"), x.to(device="cpu"), x.to(torch.device("cpu"))
    x.to("cpu", torch.float64), x.to(torch.zeros(1))
    assert ptc.sync_count("copies") == 7
    x.to(torch.float64), x.double(), x.float()
    assert ptc.sync_count("copies") == 7


def test_a_network_output_of_a_spy_is_uncounted():
    """`net.output(watch(x))`: the spy goes back into torch through
    `torch.as_tensor` and the layers, uncounted; the answer is a numpy
    array equal to the unwatched one."""
    conf = (port.NeuralNetConfiguration.builder().seed(3).list()
            .layer(port.DenseLayer(n_out=5, activation="relu"))
            .layer(port.OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(port.InputType.feed_forward(4)).build())
    net = port.MultiLayerNetwork(conf).init(device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 4)).astype(np.float32))
    ptc.reset_counts()
    got = net.output(ptc.watch(x, site="net.in"))
    assert ptc.sync_count("net.in") == 0
    np.testing.assert_array_equal(got, net.output(x))
    out = ptc.watch(torch.from_numpy(got), site="net.out")
    assert type(torch.softmax(out, -1)) is torch.Tensor and ptc.sync_count() == 0
    assert out.argmax(-1).tolist() == got.argmax(-1).tolist()
    assert ptc.sync_count("net.out") == 0   # the argmax is a plain tensor
    out.tolist()
    assert ptc.sync_count("net.out") == 1


def test_fenced_read_of_bfloat16_is_exact_float32():
    t = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    ptc.reset_counts()
    got = ptc.fenced_read(ptc.watch(t, site="bf16"))
    assert got.dtype == np.float32 and got.tolist() == [1.5, -2.25, 3.0]
    assert ptc.sync_count() == 0


# ---------------------------------------------------------------------------
# sync_debug
# ---------------------------------------------------------------------------

def test_sync_debug_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with ptc.sync_debug("warn"):
            pass


def test_sync_debug_tallies_by_call_site(monkeypatch):
    """The card's sync warnings, stood in for by the warning torch raises
    (`ptc.SYNC_WARNING`), counted by call site; the mode is set for the
    block and restored after; any other warning passes through."""
    modes = [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)

    def sync():
        warnings.warn(ptc.SYNC_WARNING, UserWarning)   # the one call site

    with warnings.catch_warnings(record=True) as outer:
        warnings.simplefilter("always")
        with ptc.sync_debug("warn") as seen:
            assert modes[-1] == "warn"
            for _ in range(3):
                sync()
            warnings.warn("something else", RuntimeWarning)
    assert modes[-1] == 0
    assert seen.total() == 3 and len(seen) == 1
    (site,) = seen
    assert site.startswith(__file__) and site.endswith(":" + str(
        sync.__code__.co_firstlineno + 1))
    assert [str(w.message) for w in outer] == ["something else"]
