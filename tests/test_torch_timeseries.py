"""The port's time-series utilities against the JAX package's.

The numpy helpers (3-D <-> 2-D reshapes, the masked time reversal, the
moving average, the moving window matrix) give bitwise the JAX package's
arrays; Viterbi gives the same path and a log probability within 1e-5 on
random HMMs, the JAX package's scan running in float32 as the port does.
"""
import jax  # noqa: F401  (the JAX package's Viterbi runs on the CPU)
import numpy as np
import pytest

from deeplearning4j_torch.utils import timeseries as port_ts
from deeplearning4j_tpu.utils import timeseries as ref_ts


def _arr(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_reshapes_and_reversal_match():
    a = _arr(0, (3, 5, 4))
    flat = port_ts.reshape_3d_to_2d(a)
    np.testing.assert_array_equal(flat, ref_ts.reshape_3d_to_2d(a))
    np.testing.assert_array_equal(port_ts.reshape_2d_to_3d(flat, 3),
                                  ref_ts.reshape_2d_to_3d(flat, 3))
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]], np.float32)
    for m in (None, mask):
        np.testing.assert_array_equal(port_ts.reverse_time_series(a, m),
                                      ref_ts.reverse_time_series(a, m))
    with pytest.raises(ValueError):
        port_ts.reshape_3d_to_2d(flat)
    with pytest.raises(ValueError):
        port_ts.reshape_2d_to_3d(flat, 4)


@pytest.mark.parametrize("window", [1, 3, 7])
def test_moving_average_and_windows_match(window):
    a = _arr(1, (2, 7))
    np.testing.assert_array_equal(port_ts.moving_average(a, window),
                                  ref_ts.moving_average(a, window))
    m = _arr(2, (9, 3))
    for rot in (False, True):
        np.testing.assert_array_equal(port_ts.moving_window_matrix(m, window, rot),
                                      ref_ts.moving_window_matrix(m, window, rot))
    with pytest.raises(ValueError):
        port_ts.moving_average(a, 8)


def _hmm(seed, s, o):
    rng = np.random.default_rng(seed)
    norm = lambda a: a / a.sum(-1, keepdims=True)
    return norm(rng.random(s)), norm(rng.random((s, s))), norm(rng.random((s, o)))


@pytest.mark.parametrize("seed,s,o,t", [(0, 2, 2, 12), (1, 4, 6, 40), (2, 7, 3, 1)])
def test_viterbi_matches(seed, s, o, t):
    hmm = _hmm(seed, s, o)
    obs = np.random.default_rng(seed + 10).integers(0, o, t)
    path, logp = port_ts.Viterbi(*hmm).decode(obs)
    want_path, want_logp = ref_ts.Viterbi(*hmm).decode(obs)
    np.testing.assert_array_equal(path, want_path)
    assert abs(logp - want_logp) <= 1e-5 * max(1.0, abs(want_logp))


def test_viterbi_edges():
    v = port_ts.Viterbi(*_hmm(3, 3, 4))
    path, logp = v.decode([])
    assert path.shape == (0,) and logp == 0.0
    with pytest.raises(ValueError, match="out of range"):
        v.decode([0, 4])
    # a deterministic chain: state i emits symbol i, stays with 0.9
    trans = np.full((3, 3), 0.05) + np.eye(3) * 0.85
    emit = np.eye(3) * 0.98 + 0.01
    path, _ = port_ts.Viterbi(np.ones(3) / 3, trans, emit).decode([2, 2, 0, 0, 1])
    np.testing.assert_array_equal(path, [2, 2, 0, 0, 1])
