"""Time-series and sequence utilities.

Port of `deeplearning4j_tpu/utils/timeseries.py` (reference
util/TimeSeriesUtils.java: 3-D <-> 2-D reshapes, time reversal with its
masked form, the moving average; util/MovingWindowMatrix.java: sliding
sub-matrices; util/Viterbi.java: the most likely hidden state sequence).
The array helpers are numpy, as in the JAX package. Viterbi's max-product
forward pass runs in torch, in float32 like the JAX package's scan, on the
device of its tables (the CPU unless `device` says otherwise); the
backtrace runs on the host.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .device import DeviceLike


# --------------------------------------------------------- TimeSeriesUtils
def reshape_3d_to_2d(arr) -> np.ndarray:
    """[batch, time, features] -> [batch * time, features] (reference
    TimeSeriesUtils.reshape3dTo2d)."""
    arr = np.asarray(arr)
    if arr.ndim != 3:
        raise ValueError(f"need rank 3, got {arr.shape}")
    return arr.reshape(-1, arr.shape[-1])


def reshape_2d_to_3d(arr, batch: int) -> np.ndarray:
    """Inverse of reshape_3d_to_2d (reference reshape2dTo3d)."""
    arr = np.asarray(arr)
    if arr.shape[0] % batch:
        raise ValueError(f"{arr.shape[0]} rows not divisible by batch {batch}")
    return arr.reshape(batch, arr.shape[0] // batch, arr.shape[-1])


def reverse_time_series(arr, mask=None) -> np.ndarray:
    """Reverse along time; with a [batch, time] mask, only each row's valid
    prefix reverses and the padding stays in place (reference
    reverseTimeSeries(INDArray, mask))."""
    arr = np.asarray(arr)
    if mask is None:
        return arr[:, ::-1].copy()
    mask = np.asarray(mask)
    out = arr.copy()
    for b in range(arr.shape[0]):
        n = int(mask[b].sum())
        out[b, :n] = arr[b, :n][::-1]
    return out


def moving_average(arr, window: int) -> np.ndarray:
    """Trailing moving average over the last axis (reference
    TimeSeriesUtils.movingAverage): output length T - window + 1."""
    arr = np.asarray(arr, np.float64)
    if window < 1 or window > arr.shape[-1]:
        raise ValueError(f"window {window} out of range for {arr.shape}")
    c = np.cumsum(np.concatenate(
        [np.zeros(arr.shape[:-1] + (1,)), arr], axis=-1), axis=-1)
    return (c[..., window:] - c[..., :-window]) / window


def moving_window_matrix(matrix, window_rows: int,
                         add_rotate: bool = False) -> np.ndarray:
    """Every vertical sliding window of a 2-D matrix -> [n_windows,
    window_rows, cols] (reference MovingWindowMatrix.windows(); `add_rotate`
    appends the row-rotated windows, like addRotate)."""
    m = np.asarray(matrix)
    if m.ndim != 2:
        raise ValueError("need a 2-D matrix")
    n = m.shape[0] - window_rows + 1
    if n <= 0:
        raise ValueError(f"window_rows {window_rows} > rows {m.shape[0]}")
    wins = np.stack([m[i:i + window_rows] for i in range(n)])
    if add_rotate:
        wins = np.concatenate([wins, np.stack(
            [np.roll(w, -1, axis=0) for w in wins])])
    return wins


# ------------------------------------------------------------------ Viterbi
class Viterbi:
    """The most likely hidden state sequence of an HMM (reference
    util/Viterbi.java, generalized from its two-state decoder): `decode`
    over (initial, transition, emission) log probabilities."""

    def __init__(self, initial, transition, emission, device: DeviceLike = "cpu"):
        """initial [S], transition [S, S] (row from -> to), emission [S, O]:
        probabilities, normalized per row; stored as float32 logs."""
        eps = 1e-30
        log = lambda a: torch.log(torch.as_tensor(np.asarray(a, np.float32),
                                                  device=device) + eps)
        self.log_init = log(initial)
        self.log_trans = log(transition)
        self.log_emit = log(emission)

    def decode(self, observations) -> Tuple[np.ndarray, float]:
        """(state sequence [T], log probability of the best path)."""
        obs = np.asarray(observations, np.int64)
        if obs.size == 0:
            return np.empty(0, np.int64), 0.0
        n_obs = self.log_emit.shape[1]
        if obs.min() < 0 or obs.max() >= n_obs:
            raise ValueError(f"observation out of range [0, {n_obs})")
        emit = self.log_emit.T[torch.as_tensor(obs, device=self.log_emit.device)]
        with torch.no_grad():
            scores = [self.log_init + emit[0]]
            back = []
            for t in range(1, obs.shape[0]):
                cand = scores[-1][:, None] + self.log_trans   # [S, S] from -> to
                best, arg = torch.max(cand, dim=0)
                scores.append(best + emit[t])
                back.append(arg)
        last = scores[-1].cpu().numpy()
        back = torch.stack(back).cpu().numpy() if back else np.empty((0, 0), np.int64)
        T = obs.shape[0]
        path = np.empty(T, np.int64)
        path[-1] = int(np.argmax(last))
        for t in range(T - 2, -1, -1):
            path[t] = back[t, path[t + 1]]
        return path, float(last.max())
