"""The port's ui/ against the JAX package's, on the same inputs.

- StatsListener: the records of a 3-step `fit` on a small dense net and a
  small CNN, both packages starting from the JAX package's initial
  parameters (carried) on the same batches. Scores and mean magnitudes
  within rtol 1e-5, update magnitudes within rtol 1e-4; the histograms of
  the record taken before the first step (iteration 0, equal parameters)
  count for count, and after training at most one count per leaf moved to
  a neighbouring bin, with equal totals.
- The device histograms against `np.histogram` on the same arrays, exactly:
  values on the edges, the max, negative zero, constant leaves, float64.
- `export_json`, `render_html` and the UIServer's pages over HTTP give
  equal bodies from both packages on one storage; `component_to_json` both
  ways; a FileStatsStorage file written by either package reads in the
  other; the remote router of either package posts into the other's
  receiver; `png_gray` and `activation_grid` give equal bytes.
"""
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
import deeplearning4j_tpu as ref
from deeplearning4j_torch import ui as pui
from deeplearning4j_torch.ui import convolutional as pconv
from deeplearning4j_torch.ui import stats as pstats
from deeplearning4j_torch.utils import params as port_params
from deeplearning4j_tpu import ui as rui
from deeplearning4j_tpu.ui import convolutional as rconv

from test_torch_word2vec import one_torch_thread  # noqa: F401

STEPS = 3
BATCH = 8
CONFIG = dict(collect_histograms=True, collect_updates=True)


def _mlp(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(3).updater(pkg.Sgd(0.1))
            .list()
            .layer(pkg.DenseLayer(n_out=8, activation="tanh"))
            .layer(pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(5)).build())


def _cnn(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(5).updater(pkg.Sgd(0.1))
            .list()
            .layer(pkg.ConvolutionLayer(kernel_size=(3, 3), stride=(1, 1),
                                        padding=(1, 1), n_out=6, activation="relu"))
            .layer(pkg.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.convolutional(8, 8, 1)).build())


SHAPES = {"mlp": (_mlp, (5,)), "cnn": (_cnn, (8, 8, 1))}


def carried(make_conf):
    """(JAX network, port network) holding the JAX network's initial
    parameters and updater state."""
    r = ref.MultiLayerNetwork(make_conf(ref)).init()
    p = port.MultiLayerNetwork(make_conf(port)).init(device="cpu")
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    p.params_tree = port_params.params_from_numpy(to_np(r.params_tree), "cpu")
    p.opt_state = port_params.opt_state_from_numpy(to_np(r.opt_state), "cpu")
    return r, p


def batches(kind, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((STEPS * BATCH,) + SHAPES[kind][1]).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, STEPS * BATCH)]
    return x, y


def run_both(kind):
    """The records of both packages' listeners: one at iteration 0, then
    one per step of a 3-step fit."""
    r, p = carried(SHAPES[kind][0])
    rs, ps = rui.InMemoryStatsStorage(), pui.InMemoryStatsStorage()
    rl = rui.StatsListener(rs, session_id="s", config=rui.StatsUpdateConfiguration(**CONFIG))
    pl = pui.StatsListener(ps, session_id="s", config=pui.StatsUpdateConfiguration(**CONFIG))
    rl.iteration_done(r, 0)
    pl.iteration_done(p, 0)
    r.listeners.append(rl)
    p.listeners.append(pl)
    x, y = batches(kind)
    r.fit(x, y, epochs=1, batch_size=BATCH, use_async=False)
    p.fit(x, y, epochs=1, batch_size=BATCH)
    return rs.get_updates("s"), ps.get_updates("s"), pl


def at_most_one_moved(got, want):
    """True when `got` is `want` or `want` with one count moved to a
    neighbouring bin."""
    d = np.asarray(got) - np.asarray(want)
    nz = np.flatnonzero(d)
    return d.sum() == 0 and (nz.size == 0 or (
        nz.size == 2 and nz[1] == nz[0] + 1 and abs(d[nz[0]]) == 1))


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_listener_records_match_reference(kind):
    want, got, listener = run_both(kind)
    assert [{k: v for k, v in u.items() if k != "timestamp"} for u in got[-1:]] == \
        [{k: v for k, v in u.items() if k != "timestamp"} for u in want[-1:]] == \
        [{"epoch_end": 1, "iteration": STEPS}]
    got, want = got[:-1], want[:-1]
    assert [u["iteration"] for u in got] == [u["iteration"] for u in want] \
        == list(range(STEPS + 1))
    assert list(got[1]) == list(want[1])   # the same keys, in the same order
    for g, w in zip(got, want):
        if w["score"] is None:
            assert g["score"] is None
        else:
            np.testing.assert_allclose(g["score"], w["score"], rtol=1e-5)
        assert sorted(g["param_mean_magnitudes"]) == sorted(w["param_mean_magnitudes"])
        for name, v in w["param_mean_magnitudes"].items():
            np.testing.assert_allclose(g["param_mean_magnitudes"][name], v, rtol=1e-5)
        assert sorted(g.get("update_mean_magnitudes", {})) == \
            sorted(w.get("update_mean_magnitudes", {}))
        for name, v in w.get("update_mean_magnitudes", {}).items():
            np.testing.assert_allclose(g["update_mean_magnitudes"][name], v, rtol=1e-4)
        for name, h in w["param_histograms"].items():
            gh = g["param_histograms"][name]
            if g["iteration"] == 0:
                assert gh == h, name
            else:
                assert sum(gh["counts"]) == sum(h["counts"])
                assert at_most_one_moved(gh["counts"], h["counts"]), (name, gh, h)
                np.testing.assert_allclose([gh["min"], gh["max"]], [h["min"], h["max"]],
                                           rtol=1e-5, atol=1e-7)
    # one transfer for the ranges, one for every other number of the record
    assert listener.last_transfers == 2


def test_update_magnitudes_need_no_host_copy():
    """The previous parameters stay tensors on the leaves' device."""
    _, p = carried(_mlp)
    listener = pui.StatsListener(pui.InMemoryStatsStorage(), config=pui.StatsUpdateConfiguration(
        collect_updates=True, collect_histograms=False))
    listener.iteration_done(p, 1)
    assert listener.last_transfers == 1
    assert all(isinstance(t, torch.Tensor) and t.device == p.device
               for t in listener._prev_params.values())


class _Leaves:
    """A model whose parameter tree is the given arrays."""

    def __init__(self, arrays):
        self.params_tree = ({f"p{i}": torch.from_numpy(a) for i, a in enumerate(arrays)},)
        self.score_value = None


def _edge_cases():
    rng = np.random.default_rng(7)
    normal = rng.standard_normal(997).astype(np.float32)
    on_edges = normal.copy()
    on_edges[:21] = np.histogram_bin_edges(normal, 20)   # every edge, the max among them
    zeros = np.zeros(64, np.float32)
    zeros[::3] = -0.0
    zeros[1::5] = np.float32(1e-30)
    tiny_span = (1 + (np.arange(300) % 4) * np.float32(1.2e-7)).astype(np.float32)
    return {"normal": normal, "on_edges": on_edges, "signed_zeros": zeros,
            "constant_zero": np.zeros(33, np.float32),
            "constant": np.full(10, -2.5, np.float32), "tiny_span": tiny_span,
            "float64": rng.standard_normal(500),
            "one_value": np.array([3.0], np.float32)}


@pytest.mark.parametrize("case", sorted(_edge_cases()))
def test_histogram_counts_exactly_as_numpy(case):
    a = _edge_cases()[case]
    storage = pui.InMemoryStatsStorage()
    pui.StatsListener(storage, session_id="s", config=pui.StatsUpdateConfiguration(
        collect_histograms=True)).iteration_done(_Leaves([a]), 0)
    h = storage.get_updates("s")[0]["param_histograms"]["layer0/p0"]
    counts, edges = np.histogram(a, bins=20)
    assert h["counts"] == counts.tolist()
    assert (h["min"], h["max"]) == (float(edges[0]), float(edges[-1]))


def test_histc_edges_are_not_numpys():
    """Why the edges are numpy's own: `torch.histc` bins by its own
    arithmetic and puts values lying on numpy's edges in other bins."""
    a = _edge_cases()["on_edges"]
    histc = torch.histc(torch.from_numpy(a), bins=20, min=float(a.min()), max=float(a.max()))
    exact = pstats.histogram_counts(torch.from_numpy(a),
                                    torch.from_numpy(np.histogram_bin_edges(a, 20)))
    assert exact.tolist() == np.histogram(a, 20)[0].tolist()
    assert histc.to(torch.int64).tolist() != exact.tolist()


def _filled_storage():
    want, _, _ = run_both("mlp")
    storage = rui.InMemoryStatsStorage()
    for u in want:
        storage.put_update("s", u)
    storage.put_update("s", {"epoch_end": 0, "iteration": STEPS, "timestamp": 1.0})
    return storage


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def test_reports_and_pages_equal_reference(tmp_path):
    storage = _filled_storage()
    assert pui.export_json(storage) == rui.export_json(storage)
    assert pui.render_html(storage) == rui.render_html(storage)
    assert pui.render_html(storage, refresh_seconds=2.0) == \
        rui.render_html(storage, refresh_seconds=2.0)
    a, b = tmp_path / "port.html", tmp_path / "ref.html"
    pui.render_html_report(storage, str(a))
    rui.render_html_report(storage, str(b))
    assert a.read_bytes() == b.read_bytes()
    r, p = carried(_cnn)
    grids = [("layer0", rconv.png_gray(np.arange(64, dtype=np.uint8).reshape(8, 8)))]
    points = np.random.default_rng(1).standard_normal((20, 2))
    servers = []
    try:
        for pkg, net in ((pui, p), (rui, r)):
            srv = pkg.UIServer(port=0).start()
            servers.append(srv)
            srv.attach(storage).attach_model(net)
            srv.attach_activations(grids, 4).attach_embedding(points, list("ab" * 10))
        for route in ("/", "/train/sessions", "/train/data", "/model", "/activations",
                      "/tsne"):
            got, want = (_get(s.url + route) for s in servers)
            assert got == want, route
            assert got[0] == 200
        assert _get(servers[0].url + "/metrics")[0] == 200
        assert _get(servers[0].url + "/trace")[0] == 200
    finally:
        for s in servers:
            s.stop()


def test_graph_model_page_equal_reference():
    def conf(pkg):
        return (pkg.NeuralNetConfiguration.builder().seed(1).graph_builder()
                .add_inputs("in")
                .add_layer("d1", pkg.DenseLayer(n_out=4, activation="relu"), "in")
                .add_layer("d2", pkg.DenseLayer(n_out=4, activation="relu"), "in")
                .add_vertex("m", pkg.MergeVertex(), "d1", "d2")
                .add_layer("out", pkg.OutputLayer(n_out=2, activation="softmax",
                                                  loss="mcxent"), "m")
                .set_outputs("out").set_input_types(pkg.InputType.feed_forward(3))
                .build())
    pages = []
    for pkg, dev in ((pui, {"device": "cpu"}), (rui, {})):
        top = port if pkg is pui else ref
        srv = pkg.UIServer(port=0)
        srv.attach_model(top.ComputationGraph(conf(top)).init(**dev))
        pages.append(srv._model_page())
    assert pages[0] == pages[1]


def test_components_json_both_ways():
    tree = rui.ComponentDiv(components=[
        rui.ComponentText(text="hi <b>", font_size=14),
        rui.ComponentTable(header=["a", "b"], content=[["1", "2"]]),
        rui.ChartLine(title="l", series_names=["s"], x=[[0.0, 1.0]], y=[[2.0, 3.0]]),
        rui.ChartScatter(title="s", x=[[0.0, 1.0]], y=[[1.0, 0.5]]),
        rui.ChartHistogram.from_values(np.arange(50.0), bins=5, title="h"),
        rui.ChartHorizontalBar(labels=["x"], values=[2.0])], style="margin:1px")
    js = rui.component_to_json(tree)
    got = pui.component_from_json(js)
    assert type(got) is pui.ComponentDiv
    assert pui.component_to_json(got) == js
    assert pui.render_component(got) == rui.render_component(tree)
    back = rui.component_from_json(pui.component_to_json(got))
    assert rui.component_to_json(back) == js
    assert pui.ChartHistogram.from_values(np.arange(50.0), bins=5).y == \
        rui.ChartHistogram.from_values(np.arange(50.0), bins=5).y


def test_file_storage_reads_across_packages(tmp_path):
    want, got, _ = run_both("mlp")
    pf, rf = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    port_store, ref_store = pui.FileStatsStorage(str(pf)), rui.FileStatsStorage(str(rf))
    for u in got:
        port_store.put_update("p", u)
    for u in want:
        ref_store.put_update("r", u)
    assert rui.FileStatsStorage(str(pf)).get_updates("p") == got
    assert pui.FileStatsStorage(str(rf)).get_updates("r") == want
    assert pui.FileStatsStorage(str(pf)).list_session_ids() == ["p"]


@pytest.mark.parametrize("sender,receiver", [(pui, rui), (rui, pui)])
def test_remote_router_posts_across_packages(sender, receiver):
    storage = receiver.InMemoryStatsStorage()
    srv = receiver.StatsReceiverServer(storage).start()
    router = sender.RemoteStatsStorageRouter(srv.url)
    try:
        for i in range(3):
            router.put_update("w0", {"iteration": i, "score": 1.0 / (i + 1)})
        router.flush()
        assert [u["iteration"] for u in storage.get_updates("w0")] == [0, 1, 2]
        assert json.loads(_get(srv.url + "/sessions")[1]) == {"sessions": ["w0"]}
    finally:
        router.shutdown()
        srv.stop()


def test_png_and_grid_bytes_equal_reference():
    rng = np.random.default_rng(4)
    act = rng.standard_normal((6, 7, 5)).astype(np.float32)
    act[:, :, 2] = 1.5   # a flat channel
    assert np.array_equal(pconv.activation_grid(act), rconv.activation_grid(act))
    assert np.array_equal(pconv.activation_grid(act, max_channels=3),
                          rconv.activation_grid(act, max_channels=3))
    img = rconv.activation_grid(act)
    assert pconv.png_gray(img) == rconv.png_gray(img)
    with pytest.raises(ValueError):
        pconv.activation_grid(act[0])


def test_convolutional_listener_grids_match_reference():
    r, p = carried(_cnn)
    probe = np.random.default_rng(2).standard_normal((8, 8, 1)).astype(np.float32)
    got = pui.ConvolutionalIterationListener(probe, frequency=1)._grids(p)
    want = rui.ConvolutionalIterationListener(probe, frequency=1)._grids(r)
    assert [n for n, _ in got] == [n for n, _ in want] == \
        ["layer0 (ConvolutionLayer)", "layer1 (SubsamplingLayer)"]
    # the activations round alike but for the last bit: each grid pixel
    # within one grey level
    acts_p, acts_r = p.feed_forward(probe[None]), r.feed_forward(probe[None])
    for a, b in zip(acts_p[1:3], acts_r[1:3]):
        ga = pconv.activation_grid(a[0]).astype(int)
        gb = rconv.activation_grid(np.asarray(b)[0]).astype(int)
        assert np.abs(ga - gb).max() <= 1


def test_ui_server_singleton_and_listener_publish():
    _, p = carried(_cnn)
    srv = pui.UIServer.get_instance()
    try:
        assert pui.UIServer.get_instance() is srv
        listener = pui.ConvolutionalIterationListener(
            np.zeros((1, 8, 8, 1), np.float32), frequency=2)
        listener.iteration_done(p, 2)
        status, body = _get(srv.url + "/activations")
        assert status == 200 and b"layer0 (ConvolutionLayer)" in body
        assert b"iteration 2" in body
    finally:
        srv.stop()
    assert pui.UIServer._instance is None
