"""chip_smoke.py's clustering, k-NN and Keras import phases (`phase_knn`,
`phase_kmeans`, `phase_tsne`, `phase_keras_import`) on the CPU at small
sizes. The card-against-CPU holds compare the CPU with itself here; what
these tests can see fail are the holds against references of their own:

- the k-NN tie check fails when ties are ordered highest index first;
- the Keras hold fails on cnn_cf when the flatten permutation is dropped;
- the k-means step hold fails when a centroid update leaves out a point.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_torch.clustering import kmeans as port_kmeans
from deeplearning4j_torch.clustering import vptree as port_vptree
from deeplearning4j_torch.keras_import import model_import as port_import

from test_torch_word2vec import one_torch_thread  # noqa: F401

KNN_SMALL = dict(n=3000, d=16, queries=64, batch=16, k=5, http_requests=8, http_rows=3,
                 http_clients=2, tie_rows=300, tie_queries=32)
KMEANS_SMALL = dict(n=4000, d=8, k=8, subset=2000)
TSNE_SMALL = dict(n=200, d=10, n_iter=100, kl_n=120)
KERAS_SMALL = dict(fit_images=64, batch=32, serve_batch=16)


def test_knn_phase_passes():
    r = chip_smoke.phase_knn(torch, "cpu", device="cpu", size=KNN_SMALL)
    for metric in ("euclidean", "cosine"):
        assert r[metric]["near_tie_swaps"] == 0 and r[metric]["max_rel_err"] == 0.0
        assert len(r[metric]["ms_per_batch"]) == 4
        assert r["ties"][metric]["ties_across_kth"] > 0
    assert r["http"]["requests"] == 8


def test_knn_tie_check_fails_with_ties_unordered(monkeypatch):
    plain = port_vptree.smallest_k

    def highest_index_first(d, k):
        cols, vals = plain(d.flip(1), k)
        return d.shape[1] - 1 - cols, vals

    monkeypatch.setattr(port_vptree, "smallest_k", highest_index_first)
    with pytest.raises(RuntimeError, match="tie order"):
        chip_smoke.phase_knn(torch, "cpu", device="cpu", size=KNN_SMALL)


def test_knn_hold_sees_a_wrong_neighbour():
    """Off by a whole place with no near-tie there, or a different set
    beyond the k-th distance's gap: both fail."""
    want_i = np.array([[0, 1, 2, 3]])
    want_d = np.array([[1.0, 2.0, 3.0, 4.0]], np.float32)
    assert chip_smoke.knn_hold("t", want_i[:, :3], want_d[:, :3], want_i, want_d, 3) == (0, 0.0)
    with pytest.raises(RuntimeError, match="no near-tie"):
        chip_smoke.knn_hold("t", np.array([[0, 2, 1]]), want_d[:, :3], want_i, want_d, 3)
    near = np.array([[1.0, 2.0, 2.0, 4.0]], np.float32)
    assert chip_smoke.knn_hold("t", np.array([[0, 2, 1]]), near[:, :3], want_i, near, 3)[0] == 2
    with pytest.raises(RuntimeError, match="distances off"):
        chip_smoke.knn_hold("t", want_i[:, :3], want_d[:, :3] * 1.001, want_i, want_d, 3)


def test_kmeans_phase_passes():
    r = chip_smoke.phase_kmeans(torch, "cpu", device="cpu", size=KMEANS_SMALL)
    assert r["iterations"] >= 1 and r["subset"]["inertia_rel_gap"] == 0.0
    assert r["step_hold"]["card"]["centroid_rel_err"] <= chip_smoke.KMEANS_REL
    assert r["step_hold"]["card_vs_cpu"]["clusters_compared"] == 8


def test_kmeans_hold_fails_when_the_update_drops_a_point(monkeypatch):
    step = port_kmeans.KMeansClustering._step

    def dropping(points, centroids):
        return step(points[1:], centroids)[0], step(points, centroids)[1], \
            step(points, centroids)[2]

    monkeypatch.setattr(port_kmeans.KMeansClustering, "_step", staticmethod(dropping))
    with pytest.raises(RuntimeError, match="k-means step"):
        chip_smoke.phase_kmeans(torch, "cpu", device="cpu", size=KMEANS_SMALL)


def test_tsne_phase_passes():
    r = chip_smoke.phase_tsne(torch, "cpu", device="cpu", size=TSNE_SMALL)
    assert r["n_iter"] == 100 and np.isfinite(r["kl"])
    assert max(r["step_hold"].values()) == 0.0 and r["whole_run"]["rel_gap"] == 0.0


def test_keras_phase_passes():
    r = chip_smoke.phase_keras_import(torch, "cpu", device="cpu", size=KERAS_SMALL)
    assert len(r["fixtures"]) == 8 and all(f["trees_bitwise"] for f in r["fixtures"].values())
    m = r["mnist_cnn"]
    assert m["parameters"] == 1_199_882 and m["fit"]["iterations"] == 2
    assert np.isfinite(m["fit"]["score"])


def test_keras_hold_fails_without_the_flatten_permutation(monkeypatch):
    monkeypatch.setattr(port_import, "_permute_flatten_dense", lambda fn, h, w, c: fn)
    with pytest.raises(RuntimeError, match="Keras import cnn_cf"):
        chip_smoke.phase_keras_import(torch, "cpu", device="cpu", size=KERAS_SMALL)
