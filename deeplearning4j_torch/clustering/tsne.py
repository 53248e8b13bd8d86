"""t-SNE embedding.

Reference parity: plot/BarnesHutTsne.java (858 LoC) + plot/Tsne.java —
perplexity-calibrated conditional probabilities, early exaggeration,
momentum gradient descent.

Port of `deeplearning4j_tpu/clustering/tsne.py`, which replaces
Barnes-Hut's quad/sp-trees by the EXACT O(n²) gradient as dense products
(at the corpus sizes the reference visualizes, thousands of rows): exact
t-SNE with the same hyperparameter surface (perplexity, early exaggeration,
momentum schedule). The affinities (`_pairwise_sq_dists`, `_calibrate_p`)
are host numpy, copied; each update step (`_tsne_step`) is a few torch
operations on the device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import Tensor

from ..utils.device import DeviceLike, resolve_device


def _pairwise_sq_dists(x: np.ndarray) -> np.ndarray:
    s = (x * x).sum(-1)
    return np.maximum(s[:, None] - 2.0 * x @ x.T + s[None, :], 0.0)


def _calibrate_p(d2: np.ndarray, perplexity: float, tol: float = 1e-5,
                 max_tries: int = 50) -> np.ndarray:
    """Per-row binary search for beta (=1/2σ²) hitting the target
    perplexity (reference Tsne.hBeta / x2p)."""
    n = d2.shape[0]
    target = np.log(perplexity)
    P = np.zeros((n, n))
    for i in range(n):
        beta, beta_min, beta_max = 1.0, -np.inf, np.inf
        di = np.delete(d2[i], i)
        for _ in range(max_tries):
            e = np.exp(-di * beta)
            s = e.sum()
            if s <= 0:
                h = 0.0
                p = np.zeros_like(e)
            else:
                p = e / s
                h = -(p * np.log(np.clip(p, 1e-12, None))).sum()
            if abs(h - target) < tol:
                break
            if h > target:  # entropy too high → sharpen
                beta_min = beta
                beta = beta * 2 if beta_max == np.inf \
                    else (beta + beta_max) / 2
            else:
                beta_max = beta
                beta = beta / 2 if beta_min == -np.inf \
                    else (beta + beta_min) / 2
        row = np.insert(p, i, 0.0)
        P[i] = row
    return P


def _tsne_step(y: Tensor, velocity: Tensor, P: Tensor, momentum: float,
               lr: float):
    """One exact-gradient update (KL(P||Q), student-t kernel): (y,
    velocity, KL as a 0-d tensor)."""
    n = y.shape[0]
    s = (y * y).sum(-1)
    d2 = s[:, None] - 2.0 * (y @ y.T) + s[None, :]
    num = 1.0 / (1.0 + d2)
    num = num * (1.0 - torch.eye(n, dtype=y.dtype, device=y.device))
    Q = num / torch.clamp(num.sum(), min=1e-12)
    PQ = (P - torch.clamp(Q, min=1e-12)) * num  # [n, n]
    grad = 4.0 * ((torch.diag(PQ.sum(1)) - PQ) @ y)
    velocity = momentum * velocity - lr * grad
    y = y + velocity
    y = y - y.mean(0)  # recentre, like the reference
    kl = (P * torch.log(torch.clamp(P, min=1e-12)
                        / torch.clamp(Q, min=1e-12))).sum()
    return y, velocity, kl


class Tsne:
    """Builder-style exact t-SNE (reference Tsne.Builder surface)."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 200.0, n_iter: int = 500,
                 early_exaggeration: float = 12.0,
                 exaggeration_iters: int = 100,
                 initial_momentum: float = 0.5, final_momentum: float = 0.8,
                 momentum_switch: int = 250, seed: int = 0,
                 device: DeviceLike = None):
        self.n_components = int(n_components)
        self.perplexity = float(perplexity)
        self.learning_rate = float(learning_rate)
        self.n_iter = int(n_iter)
        self.early_exaggeration = float(early_exaggeration)
        self.exaggeration_iters = int(exaggeration_iters)
        self.initial_momentum = float(initial_momentum)
        self.final_momentum = float(final_momentum)
        self.momentum_switch = int(momentum_switch)
        self.seed = int(seed)
        #: where the steps run (default: CUDA, raising when there is none)
        self.device = resolve_device(device)
        self.kl_divergence: Optional[float] = None

    def fit_transform(self, x) -> np.ndarray:
        return self._descend(self._affinities(x))

    def _affinities(self, x) -> np.ndarray:
        """The symmetrized joint probabilities P of `x`, on the host."""
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        if self.perplexity * 3 > n:
            raise ValueError(f"perplexity {self.perplexity} too large for "
                             f"{n} points (need n > 3*perplexity)")
        d2 = _pairwise_sq_dists(x)
        P = _calibrate_p(d2, self.perplexity)
        P = (P + P.T) / np.maximum((P + P.T).sum(), 1e-12)  # symmetrize
        return np.maximum(P, 1e-12)

    def _descend(self, P: np.ndarray) -> np.ndarray:
        """The n_iter device steps from the seeded start on P."""
        n = P.shape[0]
        rng = np.random.default_rng(self.seed)
        y = torch.as_tensor(rng.normal(0, 1e-4, (n, self.n_components)),
                            dtype=torch.float32, device=self.device)
        vel = torch.zeros_like(y)
        P_dev = torch.as_tensor(P, dtype=torch.float32, device=self.device)
        P_exag = P_dev * self.early_exaggeration
        kl = None
        for it in range(self.n_iter):
            exag = self.early_exaggeration \
                if it < self.exaggeration_iters else 1.0
            mom = self.initial_momentum if it < self.momentum_switch \
                else self.final_momentum
            y, vel, kl = _tsne_step(y, vel, P_exag if exag != 1.0 else P_dev,
                                    mom, self.learning_rate)
        self.kl_divergence = float(kl)
        return y.cpu().numpy()
