"""Second-order / line-search solvers: LineGradientDescent,
ConjugateGradient, LBFGS.

Port of `deeplearning4j_tpu/optimize/solvers.py`. Reference parity:
optimize/Solver.java dispatches on OptimizationAlgorithm to solvers over
BaseOptimizer (optimize/solvers/{LineGradientDescent,ConjugateGradient,
LBFGS}.java + BackTrackLineSearch.java). SGD remains the production path
inside `fit`; these batch solvers optimize the FULL-BATCH loss like the
reference's (which the reference itself notes are for small/full-batch
problems).

The loss is a scalar function of the FLAT parameter vector: the leaves in
`utils/params.tree_leaves` order (the checkpoint's, dict keys sorted), each
in the JAX package's layout (HWIO convolution kernels), so the vector is
element for element the JAX package's. One autograd backward per
value+gradient evaluation, value-only trials for the line search;
direction updates (Polak-Ribiere beta, the L-BFGS two-loop recursion) are
float32 vector ops on the network's device with the scalars read back in
the JAX package's order. Backtracking line search (Armijo) mirrors
BackTrackLineSearch.java's contract.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..utils import params as param_utils


def _ref_view(t: torch.Tensor) -> torch.Tensor:
    """A port leaf in the JAX package's layout (OIHW -> HWIO)."""
    return t.permute(2, 3, 1, 0) if t.ndim == 4 else t


class _FlatProblem:
    """Scalar loss over the flat parameter vector of a network."""

    def __init__(self, net, x, y, fmask=None, lmask=None):
        self.net = net
        self._template = net.params_tree
        self._leaves = param_utils.tree_leaves(net.params_tree)
        self._args = (net._as_input(x), net._as_labels(y), net._as_mask(fmask),
                      net._as_mask(lmask))
        self.flat0 = torch.cat([_ref_view(t).reshape(-1) for t in self._leaves])

    def _unflatten(self, flat: torch.Tensor):
        out, ofs = [], 0
        for t in self._leaves:
            n = t.numel()
            shape = tuple(_ref_view(t).shape)
            leaf = flat[ofs:ofs + n].reshape(shape).to(t.dtype)
            if leaf.ndim == 4:  # HWIO -> OIHW, channels-last as stored
                leaf = leaf.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
            out.append(leaf)
            ofs += n
        return param_utils.tree_unflatten(self._template, out)

    def _loss(self, flat):
        return self.net._loss(self._unflatten(flat), self.net.state_tree,
                              *self._args, False, None)[0]

    def value(self, flat) -> torch.Tensor:
        with torch.no_grad():
            return self._loss(flat)

    def value_and_grad(self, flat):
        flat = flat.detach().requires_grad_()
        with torch.enable_grad():
            loss = self._loss(flat)
        (g,) = torch.autograd.grad(loss, flat)
        return loss.detach(), g

    def commit(self, flat):
        self.net.params_tree = self._unflatten(flat.detach())


def backtrack_line_search(value_fn, w, direction, f0, g0, *,
                          step0: float = 1.0, c1: float = 1e-4,
                          shrink: float = 0.5,
                          max_steps: int = 20) -> Tuple[torch.Tensor, float]:
    """Armijo backtracking (reference BackTrackLineSearch.java): shrink the
    step until f(w + a·d) <= f0 + c1·a·gᵀd. `value_fn` is VALUE-ONLY (no
    backward pass per trial). Returns (new_w, new_f); falls back to the
    unmoved point when no step satisfies the condition."""
    slope = float(torch.dot(g0, direction))
    if slope >= 0:  # not a descent direction: flip (reference resets)
        direction = -direction
        slope = -slope
    a = step0
    for _ in range(max_steps):
        w_new = w + a * direction
        f_new = float(value_fn(w_new))
        if f_new <= f0 + c1 * a * slope:
            return w_new, f_new
        a *= shrink
    return w, f0


class BaseSolver:
    def __init__(self, max_iterations: int = 100, tolerance: float = 1e-6):
        self.max_iterations = int(max_iterations)
        self.tolerance = float(tolerance)
        self.scores: List[float] = []

    def optimize(self, net, x, y, fmask=None, lmask=None) -> float:
        """Minimize the full-batch score; commits params to the net and
        returns the final score (reference Solver.optimize())."""
        net._check_init()
        prob = _FlatProblem(net, x, y, fmask, lmask)
        w = prob.flat0
        f, g = prob.value_and_grad(w)
        f = float(f)
        self.scores = [f]
        state = self._init_state(w, g)
        for it in range(self.max_iterations):
            direction, state = self._direction(g, state)
            w_new, f_new = backtrack_line_search(
                prob.value, w, direction, f, g)
            if f - f_new < self.tolerance:
                w = w_new
                self.scores.append(f_new)
                break
            g_new = prob.value_and_grad(w_new)[1]
            state = self._post_step(state, w, w_new, g, g_new)
            w, f, g = w_new, f_new, g_new
            self.scores.append(f)
        prob.commit(w)
        net.score_value = self.scores[-1]
        return self.scores[-1]

    # hooks ---------------------------------------------------------------
    def _init_state(self, w, g):
        return None

    def _direction(self, g, state):
        raise NotImplementedError

    def _post_step(self, state, w, w_new, g, g_new):
        return state


class LineGradientDescent(BaseSolver):
    """Steepest descent + line search (reference
    solvers/LineGradientDescent.java)."""

    def _direction(self, g, state):
        return -g, state


class ConjugateGradient(BaseSolver):
    """Nonlinear CG, Polak-Ribière with restart (reference
    solvers/ConjugateGradient.java)."""

    def _init_state(self, w, g):
        return {"prev_g": g, "prev_d": -g, "first": True}

    def _direction(self, g, state):
        if state["first"]:
            d = -g
        else:
            pg = state["prev_g"]
            beta = float(torch.dot(g, g - pg) /
                         torch.clamp(torch.dot(pg, pg), min=1e-30))
            beta = max(0.0, beta)  # PR+ restart
            d = -g + beta * state["prev_d"]
        state = {**state, "prev_d": d, "first": False}
        return d, state

    def _post_step(self, state, w, w_new, g, g_new):
        return {**state, "prev_g": g}


class LBFGS(BaseSolver):
    """Limited-memory BFGS, two-loop recursion (reference
    solvers/LBFGS.java; memory m=10 like the reference default)."""

    def __init__(self, max_iterations: int = 100, tolerance: float = 1e-6,
                 memory: int = 10):
        super().__init__(max_iterations, tolerance)
        self.memory = int(memory)

    def _init_state(self, w, g):
        return {"s": [], "y": []}

    def _direction(self, g, state):
        s_list, y_list = state["s"], state["y"]
        q = g
        alphas = []
        for s, y in zip(reversed(s_list), reversed(y_list)):
            rho = 1.0 / float(torch.clamp(torch.dot(y, s), min=1e-30))
            a = rho * float(torch.dot(s, q))
            alphas.append((a, rho))
            q = q - a * y
        if y_list:
            y_last, s_last = y_list[-1], s_list[-1]
            gamma = float(torch.dot(s_last, y_last) /
                          torch.clamp(torch.dot(y_last, y_last), min=1e-30))
            q = q * gamma
        for (a, rho), s, y in zip(reversed(alphas), s_list, y_list):
            b = rho * float(torch.dot(y, q))
            q = q + (a - b) * s
        return -q, state

    def _post_step(self, state, w, w_new, g, g_new):
        s = w_new - w
        y = g_new - g
        if float(torch.dot(s, y)) > 1e-10:  # curvature condition
            state["s"].append(s)
            state["y"].append(y)
            if len(state["s"]) > self.memory:
                state["s"].pop(0)
                state["y"].pop(0)
        return state


def solver_for(algorithm, **kw) -> BaseSolver:
    """Reference Solver.Builder dispatch (optimize/Solver.java:43-60)."""
    from ..nn.conf.builders import OptimizationAlgorithm as OA
    table = {
        OA.LINE_GRADIENT_DESCENT: LineGradientDescent,
        OA.CONJUGATE_GRADIENT: ConjugateGradient,
        OA.LBFGS: LBFGS,
    }
    if algorithm not in table:
        raise ValueError(
            f"{algorithm} has no batch solver (SGD runs in the train step "
            "via fit())")
    return table[algorithm](**kw)
