"""The port's clustering (`deeplearning4j_torch/clustering`) against the JAX
package's on the CPU: the host structures (VPTree, KDTree, t-SNE's
affinities) exactly equal; the device functions (`knn_brute_force`,
k-means' `_step` and `fit`, `_tsne_step`, `Tsne.fit_transform`) within the
stated tolerances, the k-NN tie order exactly `jax.lax.top_k`'s; the
refusals alike."""
import numpy as np
import pytest
import torch

from deeplearning4j_torch import clustering as port
from deeplearning4j_torch.clustering import kmeans as port_kmeans
from deeplearning4j_torch.clustering import tsne as port_tsne
from deeplearning4j_torch.clustering import vptree as port_vptree
from deeplearning4j_tpu import clustering as ref
from deeplearning4j_tpu.clustering import kmeans as ref_kmeans
from deeplearning4j_tpu.clustering import tsne as ref_tsne

from test_torch_word2vec import one_torch_thread  # noqa: F401

METRICS = ["euclidean", "cosine"]


def points(n, d, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def tied_corpus(seed=1, rows=120, dim=6):
    """Integer rows, each two or three times: every dot product is exact,
    so equal distances are equal bits in any summation order."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-1, 2, (rows, dim)).astype(np.float32)
    corpus = np.concatenate([base, base[rng.permutation(rows)], base[:rows // 2]])
    return corpus, rng.integers(-1, 2, (40, dim)).astype(np.float32)


def tree_nodes(node):
    """(index, threshold) of every node, depth first."""
    if node is None:
        return []
    return ([(node.index, getattr(node, "threshold", getattr(node, "axis", None)))]
            + tree_nodes(getattr(node, "inside", getattr(node, "left", None)))
            + tree_nodes(getattr(node, "outside", getattr(node, "right", None))))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("seed", [0, 3])
def test_vptree_equals_the_jax_package(metric, seed):
    x = points(300, 8, seed)
    mine = port.VPTree(x, metric=metric, seed=seed)
    theirs = ref.VPTree(x, metric=metric, seed=seed)
    assert tree_nodes(mine.root) == tree_nodes(theirs.root)
    for q in np.concatenate([x[:5] + 0.05, points(5, 8, seed + 9)]):
        for k in (1, 7, 400):
            got, want = mine.search(q, k), theirs.search(q, k)
            assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_kdtree_equals_the_jax_package():
    x = points(250, 5, 4)
    mine, theirs = port.KDTree(x), ref.KDTree(x)
    assert tree_nodes(mine.root) == tree_nodes(theirs.root)
    for q in points(8, 5, 5):
        assert mine.nn(q) == theirs.nn(q)
        for k in (1, 6, 300):
            got, want = mine.knn(q, k), theirs.knn(q, k)
            assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="k must be"):
        mine.knn(x[0], 0)
    with pytest.raises(ValueError, match="needs"):
        port.KDTree(np.zeros(3))


@pytest.mark.parametrize("metric", METRICS)
def test_knn_brute_force_against_the_jax_package(metric):
    corpus, queries = points(500, 16, 6), points(30, 16, 7)
    got_i, got_d = port.knn_brute_force(corpus, queries, 8, metric, device="cpu")
    want_i, want_d = ref.knn_brute_force(corpus, queries, 8, metric)
    assert got_i.dtype == want_i.dtype == np.int32 and got_d.dtype == np.float32
    assert np.array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5)
    # one query as a vector; k past the corpus clamps to it
    i1, d1 = port.knn_brute_force(corpus[:20], queries[0], 50, metric, device="cpu")
    i2, d2 = ref.knn_brute_force(corpus[:20], queries[0], 50, metric)
    assert i1.shape == i2.shape == (1, 20) and np.array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [1, 7, 13])
def test_knn_tie_order_is_jax_top_k_order(metric, k):
    """Duplicate rows tie exactly: the lower index first, at the k-th place
    too (which rows get in)."""
    corpus, queries = tied_corpus()
    got_i, got_d = port.knn_brute_force(corpus, queries, k, metric, device="cpu")
    want_i, want_d = ref.knn_brute_force(corpus, queries, k, metric)
    assert np.array_equal(got_i, want_i) and np.array_equal(got_d, want_d)
    d = port_vptree.knn_distances(torch.as_tensor(corpus), torch.as_tensor(queries),
                                  metric).numpy()
    s = np.sort(d, axis=1)
    assert (s[:, k - 1] == s[:, k]).any()   # ties across the k-th place occur


def test_smallest_k_is_a_stable_selection():
    d = torch.tensor([[3.0, 1.0, 1.0, 2.0, 1.0, 0.5],
                      [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]])
    cols, vals = port_vptree.smallest_k(d, 3)
    assert cols.tolist() == [[5, 1, 2], [0, 1, 2]]
    assert vals.tolist() == [[0.5, 1.0, 1.0], [2.0, 2.0, 2.0]]
    cols, vals = port_vptree.smallest_k(d, 0)
    assert cols.shape == vals.shape == (2, 0)


def test_knn_device_none_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.knn_brute_force(points(10, 2), points(2, 2), 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.KMeansClustering(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.Tsne()
    with pytest.raises(ValueError, match="Unknown metric"):
        port.knn_brute_force(points(10, 2), points(2, 2), 3, "manhattan", device="cpu")


def blobs(n, d, k, seed):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 3, (k, d))
    return (centres[rng.integers(0, k, n)] + rng.standard_normal((n, d))).astype(np.float32)


def test_kmeans_step_against_the_jax_package():
    x = blobs(400, 6, 5, 8)
    c = x[[3, 50, 77, 120, 333]]
    # a centroid no point is nearest keeps its place
    c = np.concatenate([c, np.full((1, 6), 1e3, np.float32)])
    got = port_kmeans.KMeansClustering._step(torch.as_tensor(x), torch.as_tensor(c))
    want = ref_kmeans.KMeansClustering._step(x, c)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5)
    assert np.array_equal(got[0][-1].numpy(), c[-1])
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)


def test_kmeans_fit_against_the_jax_package():
    x = blobs(600, 4, 6, 9)
    mine = port.KMeansClustering(6, seed=2, device="cpu").fit(x)
    theirs = ref.KMeansClustering(6, seed=2).fit(x)
    assert mine.iterations_run == theirs.iterations_run
    np.testing.assert_allclose(mine.centroids, theirs.centroids, rtol=1e-5)
    p, q = mine.predict(x), theirs.predict(x)
    assert p.dtype == q.dtype and np.array_equal(p, q)
    np.testing.assert_allclose(mine.inertia(x), theirs.inertia(x), rtol=1e-5)


def test_kmeans_refusals():
    with pytest.raises(ValueError, match="points < k"):
        port.KMeansClustering(5, device="cpu").fit(points(3, 2))
    with pytest.raises(ValueError, match="points < k"):
        ref.KMeansClustering(5).fit(points(3, 2))
    with pytest.raises(RuntimeError, match="fit"):
        port.KMeansClustering(2, device="cpu").predict(points(3, 2))
    with pytest.raises(ValueError, match="euclidean"):
        port.KMeansClustering(2, metric="cosine", device="cpu")


def test_tsne_affinities_equal_the_jax_package():
    x = np.random.default_rng(10).standard_normal((70, 5))
    d2 = port_tsne._pairwise_sq_dists(x)
    assert np.array_equal(d2, ref_tsne._pairwise_sq_dists(x))
    for perplexity in (5.0, 20.0):
        assert np.array_equal(port_tsne._calibrate_p(d2, perplexity),
                              ref_tsne._calibrate_p(d2, perplexity))


def tsne_affinities(n, seed):
    x = np.random.default_rng(seed).standard_normal((n, 5))
    P = ref_tsne._calibrate_p(ref_tsne._pairwise_sq_dists(x), 10.0)
    P = (P + P.T) / np.maximum((P + P.T).sum(), 1e-12)
    return x, np.maximum(P, 1e-12)


@pytest.mark.parametrize("momentum, exaggeration", [(0.5, 12.0), (0.8, 1.0)])
def test_tsne_step_against_the_jax_package(momentum, exaggeration):
    import jax.numpy as jnp
    _, P = tsne_affinities(60, 11)
    rng = np.random.default_rng(12)
    y = rng.normal(0, 1e-2, (60, 2)).astype(np.float32)
    v = rng.normal(0, 1e-3, (60, 2)).astype(np.float32)
    Pe = (P * exaggeration).astype(np.float32)
    got = port_tsne._tsne_step(torch.as_tensor(y), torch.as_tensor(v), torch.as_tensor(Pe),
                               momentum, 200.0)
    want = ref_tsne._tsne_step(jnp.asarray(y), jnp.asarray(v), jnp.asarray(Pe),
                               jnp.asarray(momentum, jnp.float32),
                               jnp.asarray(200.0, jnp.float32))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def test_tsne_fit_transform_against_the_jax_package():
    """50 iterations at n 60, through both schedules (exaggeration, then
    none; the initial momentum, then the final). At the defaults (learning
    rate 200, 100 exaggerated steps) the descent is chaotic at this size:
    one step agrees to 3e-7, then rounding grows about tenfold a step until
    the two runs differ by the whole embedding. Exaggeration amplifies it
    most, so the comparison runs at learning rate 10 with 5 exaggerated
    steps and the momentum switch at 25, where over ten inputs the two
    packages stay within 3.7e-5 of max|y| while the embedding grows from
    1e-4 to about 5."""
    x, _ = tsne_affinities(60, 13)
    kw = dict(perplexity=10.0, n_iter=50, learning_rate=10.0, exaggeration_iters=5,
              momentum_switch=25, seed=2)
    mine, theirs = port.Tsne(device="cpu", **kw), ref.Tsne(**kw)
    got, want = mine.fit_transform(x), theirs.fit_transform(x)
    assert got.shape == want.shape == (60, 2)
    assert np.abs(want).max() > 1.0   # moved well away from its start
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(mine.kl_divergence, theirs.kl_divergence, rtol=1e-4)


def test_tsne_refuses_too_few_points():
    x = np.zeros((20, 3))
    with pytest.raises(ValueError, match="perplexity"):
        port.Tsne(perplexity=10.0, device="cpu").fit_transform(x)
    with pytest.raises(ValueError, match="perplexity"):
        ref.Tsne(perplexity=10.0).fit_transform(x)
