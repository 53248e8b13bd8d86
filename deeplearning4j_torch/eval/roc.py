"""ROC family: ROC, ROCBinary, ROCMultiClass.

The torch package's own copy of `deeplearning4j_tpu/eval/roc.py`. Reference
parity: eval/ROC.java (351 LoC — exact mode stores all
(probability, label) pairs when thresholdSteps == 0, thresholded mode
buckets counts at thresholdSteps evenly spaced thresholds; calculateAUC
via trapezoidal integration, calculateAUCPR), eval/ROCBinary.java
(per-output-column binary ROC), eval/ROCMultiClass.java (one-vs-all ROC
per class). All three support accumulator merge() for distributed
evaluation like the reference's IEvaluation contract.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .evaluation import _host


def _binary_curve(scores: np.ndarray, labels: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact ROC points: (thresholds desc, fpr, tpr), tie-grouped."""
    order = np.argsort(-scores, kind="stable")
    s = scores[order]
    y = labels[order].astype(np.float64)
    # group ties: only take curve points where the score changes
    distinct = np.where(np.diff(s))[0]
    idx = np.r_[distinct, y.size - 1]
    tps = np.cumsum(y)[idx]
    fps = (idx + 1) - tps
    P = y.sum()
    N = y.size - P
    tpr = tps / P if P > 0 else np.zeros_like(tps)
    fpr = fps / N if N > 0 else np.zeros_like(fps)
    return s[idx], np.r_[0.0, fpr], np.r_[0.0, tpr]


_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy 1.x compat


def _auc_trapezoid(x: np.ndarray, y: np.ndarray) -> float:
    return float(_trapezoid(y, x))


def _auprc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Area under precision-recall (reference calculateAUCPR), by
    right-continuous step interpolation over exact points."""
    P = labels.sum()
    if P == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    y = labels[order].astype(np.float64)
    tps = np.cumsum(y)
    fps = np.cumsum(1.0 - y)
    precision = tps / (tps + fps)
    recall = tps / P
    # step integral: sum precision * d(recall)
    drecall = np.diff(np.r_[0.0, recall])
    return float(np.sum(precision * drecall))


class ROC:
    """Binary ROC (reference eval/ROC.java). `threshold_steps == 0` is
    EXACT mode (all scores kept); > 0 buckets scores into that many
    threshold bins — O(steps) memory for streaming evaluation."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = int(threshold_steps)
        self._scores: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []
        if self.threshold_steps > 0:
            # histogram counts of positives/negatives per score bin
            self._pos_hist = np.zeros(self.threshold_steps, np.int64)
            self._neg_hist = np.zeros(self.threshold_steps, np.int64)
        self._count = 0

    @staticmethod
    def _coerce(labels, predictions) -> Tuple[np.ndarray, np.ndarray]:
        """Normalize every calling convention to flat (scores, 0/1 labels):
        labels may be rank-1 class indices OR [N,1] OR one-hot [N,2];
        predictions rank-1 P(positive) OR [N,1] OR softmax [N,2] — the
        shapes are coerced INDEPENDENTLY (a rank-1 label vector with [N,2]
        softmax probs is the most common pairing)."""
        y = _host(labels)
        p = _host(predictions)
        if p.ndim == 2:
            if p.shape[1] == 2:
                p = p[:, 1]     # P(class 1)
            elif p.shape[1] == 1:
                p = p[:, 0]
            else:
                raise ValueError(
                    f"ROC is binary; got {p.shape[1]}-column predictions "
                    "(use ROCMultiClass)")
        if y.ndim == 2:
            if y.shape[1] == 2:
                y = y[:, 1]     # one-hot: col 1 = positive
            elif y.shape[1] == 1:
                y = y[:, 0]
            else:
                raise ValueError(
                    f"ROC is binary; got {y.shape[1]}-column labels")
        p = p.astype(np.float64).reshape(-1)
        y = (y > 0.5).astype(np.int64).reshape(-1)
        if p.shape != y.shape:
            raise ValueError(f"labels ({y.shape}) and predictions "
                             f"({p.shape}) disagree after coercion")
        return p, y

    def eval(self, labels, predictions, mask=None) -> None:
        p, y = self._coerce(labels, predictions)
        if mask is not None:
            keep = _host(mask).reshape(-1) > 0
            p, y = p[keep], y[keep]
        self._count += y.size
        if self.threshold_steps > 0:
            bins = np.clip((p * self.threshold_steps).astype(np.int64), 0,
                           self.threshold_steps - 1)
            np.add.at(self._pos_hist, bins[y == 1], 1)
            np.add.at(self._neg_hist, bins[y == 0], 1)
        else:
            self._scores.append(p)
            self._labels.append(y)

    # ------------------------------------------------------------- results
    def _exact_arrays(self):
        if not self._scores:
            return np.empty(0), np.empty(0, np.int64)
        return np.concatenate(self._scores), np.concatenate(self._labels)

    def get_roc_curve(self) -> Tuple[np.ndarray, np.ndarray]:
        """(fpr, tpr) points, threshold-descending."""
        if self.threshold_steps > 0:
            # cumulative counts from the top bin downward == score >= t
            pos = np.cumsum(self._pos_hist[::-1]).astype(np.float64)
            neg = np.cumsum(self._neg_hist[::-1]).astype(np.float64)
            P, N = max(pos[-1], 1.0), max(neg[-1], 1.0)
            return np.r_[0.0, neg / N], np.r_[0.0, pos / P]
        s, y = self._exact_arrays()
        if s.size == 0:
            return np.zeros(1), np.zeros(1)
        _, fpr, tpr = _binary_curve(s, y)
        return fpr, tpr

    def calculate_auc(self) -> float:
        fpr, tpr = self.get_roc_curve()
        # ensure the curve reaches (1,1)
        if fpr.size == 0 or fpr[-1] < 1.0:
            fpr, tpr = np.r_[fpr, 1.0], np.r_[tpr, 1.0]
        return _auc_trapezoid(fpr, tpr)

    def calculate_auprc(self) -> float:
        if self.threshold_steps > 0:
            # O(steps) directly from cumulative bin counts (top bin first
            # == descending score threshold) — never materializes
            # per-example arrays, preserving the streaming-memory contract.
            tps = np.cumsum(self._pos_hist[::-1]).astype(np.float64)
            fps = np.cumsum(self._neg_hist[::-1]).astype(np.float64)
            P = tps[-1]
            if P == 0:
                return 0.0
            nz = tps + fps > 0
            precision = np.where(nz, tps / np.maximum(tps + fps, 1), 0.0)
            recall = tps / P
            drecall = np.diff(np.r_[0.0, recall])
            return float(np.sum(precision * drecall))
        s, y = self._exact_arrays()
        return _auprc(s, y) if s.size else 0.0

    def merge(self, other: "ROC") -> "ROC":
        if other.threshold_steps != self.threshold_steps:
            raise ValueError("Cannot merge ROCs with different "
                             "threshold_steps")
        if self.threshold_steps > 0:
            self._pos_hist += other._pos_hist
            self._neg_hist += other._neg_hist
        else:
            self._scores.extend(other._scores)
            self._labels.extend(other._labels)
        self._count += other._count
        return self

    def stats(self) -> str:
        return (f"ROC (exact={self.threshold_steps == 0}, "
                f"n={self._count}): AUC={self.calculate_auc():.4f}, "
                f"AUPRC={self.calculate_auprc():.4f}")


class _PerColumnROC:
    """Shared machinery: one binary ROC per output column."""

    _KIND = "column"

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = int(threshold_steps)
        self._rocs: Optional[List[ROC]] = None

    def _ensure(self, n: int):
        if self._rocs is None:
            self._rocs = [ROC(self.threshold_steps) for _ in range(n)]
        elif len(self._rocs) != n:
            raise ValueError(f"{type(self).__name__} saw {len(self._rocs)} "
                             f"{self._KIND}s before, now {n}")

    def eval(self, labels, predictions, mask=None) -> None:
        y = _host(labels)
        p = _host(predictions)
        if y.ndim == 3:  # time series: flatten time, apply [b, t] mask
            y = y.reshape(-1, y.shape[-1])
            p = p.reshape(-1, p.shape[-1])
            if mask is not None:
                keep = _host(mask).reshape(-1) > 0
                y, p = y[keep], p[keep]
                mask = None
        self._ensure(y.shape[1])
        m = None if mask is None else _host(mask)
        for c in range(y.shape[1]):
            col_mask = m[:, c] if (m is not None and m.ndim == 2) else m
            self._rocs[c].eval(y[:, c:c + 1], p[:, c:c + 1], col_mask)

    def calculate_auc(self, col: int) -> float:
        return self._rocs[col].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs]))

    def merge(self, other):
        if other._rocs is None:
            return self
        self._ensure(len(other._rocs))
        for mine, theirs in zip(self._rocs, other._rocs):
            mine.merge(theirs)
        return self

    def stats(self) -> str:
        aucs = ", ".join(f"{i}:{r.calculate_auc():.4f}"
                         for i, r in enumerate(self._rocs or []))
        return f"{type(self).__name__} per-{self._KIND} AUC: {aucs}"


class ROCBinary(_PerColumnROC):
    """Per-output-column binary ROC for multi-label sigmoid outputs
    (reference eval/ROCBinary.java)."""

    _KIND = "label"

    def num_labels(self) -> int:
        return 0 if self._rocs is None else len(self._rocs)


class ROCMultiClass(_PerColumnROC):
    """One-vs-all ROC per class for softmax outputs (reference
    eval/ROCMultiClass.java)."""

    _KIND = "class"

    def num_classes(self) -> int:
        return 0 if self._rocs is None else len(self._rocs)
