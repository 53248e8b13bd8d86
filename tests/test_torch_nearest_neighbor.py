"""The port's nearest-neighbour server (`serving/nearest_neighbor.py`)
against the JAX package's on the CPU: the same requests give equal JSON
from both, with the device top-k (`use_device=True`) and with the host
VPTree (`use_device=False`). On integer-valued points every distance is
exact in float32 whatever the summation order, so the device answers are
equal to the bit; on random points the indices are equal and the
distances within 1e-5."""
import urllib.error

import numpy as np
import pytest
import torch

from deeplearning4j_torch.serving import NearestNeighbor, NearestNeighborsServer
from deeplearning4j_torch.utils.http_server import json_request
from deeplearning4j_tpu.serving import NearestNeighborsServer as RefServer

from test_torch_word2vec import one_torch_thread  # noqa: F401


def integer_points(seed=3, n=200, d=6):
    rng = np.random.default_rng(seed)
    base = rng.integers(-2, 3, (n // 2, d)).astype(np.float32)
    return np.concatenate([base, base[::-1]]), rng.integers(-2, 3, (12, d)).astype(np.float32)


def requests(queries):
    """Single points and batches, default and explicit k."""
    return ([{"point": queries[0].tolist()},
             {"point": queries[1].tolist(), "k": 3},
             {"point": queries[:5].tolist(), "k": 7},
             {"point": queries[5:].tolist(), "k": 1},
             {"point": queries[2].tolist(), "k": 500}])


def both(points, metric, use_device):
    return (NearestNeighborsServer(points, metric=metric, use_device=use_device,
                                   device="cpu"),
            RefServer(points, metric=metric, use_device=use_device))


@pytest.mark.parametrize("use_device", [True, False])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_equal_json_on_exact_points(metric, use_device):
    points, queries = integer_points()
    mine, theirs = both(points, metric, use_device)
    with mine, theirs:
        assert json_request(mine.url + "/health") == json_request(theirs.url + "/health") \
            == {"status": "ok", "corpus": len(points), "dim": points.shape[1]}
        for body in requests(queries):
            assert json_request(mine.url + "/knn", body, timeout=60) == \
                json_request(theirs.url + "/knn", body, timeout=60)
        for s in (mine, theirs):   # a request without a point is a client error
            with pytest.raises(urllib.error.HTTPError) as e:
                json_request(s.url + "/knn", {"k": 3})
            assert e.value.code == 400


@pytest.mark.parametrize("use_device", [True, False])
def test_random_points_within_tolerance(use_device):
    rng = np.random.default_rng(4)
    points = rng.standard_normal((300, 10)).astype(np.float32)
    queries = rng.standard_normal((12, 10)).astype(np.float32)
    mine, theirs = both(points, "euclidean", use_device)
    with mine, theirs:
        for body in requests(queries):
            got = json_request(mine.url + "/knn", body, timeout=60)["results"]
            want = json_request(theirs.url + "/knn", body, timeout=60)["results"]
            if isinstance(want[0], dict):
                got, want = [got], [want]
            for g, w in zip(got, want):
                assert [r["index"] for r in g] == [r["index"] for r in w]
                np.testing.assert_allclose([r["distance"] for r in g],
                                           [r["distance"] for r in w], rtol=1e-5)


def test_facade_keeps_the_corpus_on_its_device(monkeypatch):
    points, queries = integer_points()
    nn = NearestNeighbor(points, device="cpu")
    assert nn._corpus.device.type == "cpu" and nn._tree is None
    idx, dist = nn.search(queries[0], 4)
    assert idx.shape == dist.shape == (4,)
    host = NearestNeighbor(points, use_device=False)
    assert host._corpus is None and host._tree is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NearestNeighbor(points)
    NearestNeighbor(points, use_device=False)   # the host path needs no device
