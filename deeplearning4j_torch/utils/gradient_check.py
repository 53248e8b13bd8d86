"""Gradient checks: central finite differences against autograd.

Port of `deeplearning4j_tpu/utils/gradient_check.py` (reference
gradientcheck/GradientCheckUtil.java): per parameter, the central difference
(L(p + eps) - L(p - eps)) / 2 eps against the backward's gradient, passing
where the relative error is at most `max_rel_error` or the absolute error at
most `min_abs_error`. The parameters are walked as the flat vector of
`params()` (leaves in checkpoint order, each in the JAX package's layout), so
`max_params` samples the same entries as the JAX package does for the same
seed. Run it on a float64 network on the CPU, as the reference runs in
double precision: in float32 the differences' noise passes the tolerance.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from . import params as param_utils

Tensor = torch.Tensor


def _flat(tree) -> Tensor:
    """The differentiable flat vector: 4-D kernels as HWIO, row-major."""
    leaves = [(t.permute(2, 3, 1, 0) if t.ndim == 4 else t).reshape(-1)
              for t in param_utils.tree_leaves(tree)]
    return torch.cat(leaves)


def _unflat(template, flat: Tensor):
    """Inverse of `_flat` on `template`'s structure, differentiable."""
    out, offset = [], 0
    for t in param_utils.tree_leaves(template):
        n = t.numel()
        piece = flat[offset:offset + n]
        if t.ndim == 4:
            o, i, h, w = t.shape
            leaf = piece.reshape(h, w, i, o).permute(3, 2, 0, 1)
        else:
            leaf = piece.reshape(t.shape)
        out.append(leaf)
        offset += n
    return param_utils.tree_unflatten(template, out)


def _check(loss_from_flat: Callable[[Tensor], Tensor], flat0: Tensor,
           epsilon: float, max_rel_error: float, min_abs_error: float,
           max_params: Optional[int], seed: int, print_results: bool,
           stop_at_first: bool) -> int:
    """The number of parameters whose gradient fails."""
    x = flat0.detach().clone().requires_grad_()
    with torch.enable_grad():
        analytic = torch.autograd.grad(loss_from_flat(x), x)[0].detach().cpu().numpy()
    flat_np = flat0.detach().cpu().numpy()
    n = flat_np.shape[0]
    if max_params is not None and max_params < n:
        idx = np.sort(np.random.default_rng(seed).choice(n, size=max_params,
                                                         replace=False))
    else:
        idx = np.arange(n)

    def value(v):
        with torch.no_grad():
            return float(loss_from_flat(torch.as_tensor(v, device=flat0.device)))

    n_fail = 0
    for i in idx:
        plus = flat_np.copy()
        plus[i] += epsilon
        minus = flat_np.copy()
        minus[i] -= epsilon
        num = (value(plus) - value(minus)) / (2 * epsilon)
        ana = float(analytic[i])
        denom = max(abs(num), abs(ana))
        rel = 0.0 if denom == 0 else abs(num - ana) / denom
        ok = rel <= max_rel_error or abs(num - ana) <= min_abs_error
        if print_results:
            print(f"param {i}: numeric={num:.8g} analytic={ana:.8g} rel={rel:.3g} "
                  f"{'ok' if ok else 'FAIL'}")
        if not ok:
            n_fail += 1
            if stop_at_first:
                return n_fail
    return n_fail


def gradient_check_mln(net, x, y, features_mask=None, labels_mask=None,
                       epsilon: float = 1e-6, max_rel_error: float = 1e-3,
                       min_abs_error: float = 1e-8, print_results: bool = False,
                       max_params: Optional[int] = None, seed: int = 0) -> bool:
    """Central differences against autograd for every parameter of a
    MultiLayerNetwork (a sample of `max_params` of them when given), on the
    score with train=False and the running layer state. True when all
    checked parameters pass (reference GradientCheckUtil.checkGradients)."""
    net._check_init()
    xa, ya = net._as_input(x), net._as_labels(y)
    fm, lm = net._as_mask(features_mask), net._as_mask(labels_mask)

    def loss_from_flat(flat):
        params = _unflat(net.params_tree, flat)
        return net._loss(params, net.state_tree, xa, ya, fm, lm, False, None)[0]

    n_fail = _check(loss_from_flat, _flat(net.params_tree), epsilon,
                    max_rel_error, min_abs_error, max_params, seed,
                    print_results, stop_at_first=False)
    if n_fail and not print_results:
        n = len(net.params())
        print(f"gradient check: {n_fail}/{min(n, max_params or n)} parameters failed")
    return n_fail == 0


def gradient_check_fn(fn: Callable, params, epsilon: float = 1e-6,
                      max_rel_error: float = 1e-3, min_abs_error: float = 1e-8,
                      max_params: Optional[int] = None, seed: int = 0) -> bool:
    """The same check for any scalar function of a tree of tensors (a layer's
    objective, a ComputationGraph's score, a loss); stops at the first
    failure."""
    return _check(lambda flat: fn(_unflat(params, flat)), _flat(params),
                  epsilon, max_rel_error, min_abs_error, max_params, seed,
                  print_results=False, stop_at_first=True) == 0
