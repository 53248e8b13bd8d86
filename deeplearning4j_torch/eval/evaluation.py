"""Evaluation metrics.

The torch package's own copy of `deeplearning4j_tpu/eval/evaluation.py`
(reference deeplearning4j-nn eval/: Evaluation.java, accuracy / precision /
recall / F1, confusion matrix, top-N; RegressionEvaluation, MSE / MAE /
RMSE / R2 per column; EvaluationBinary; the IEvaluation SPI of mergeable
accumulators, so a data-parallel evaluator can merge shards).

Host-side numpy accumulation: metrics are O(batch) bookkeeping, not work
for the card; the forward passes run on the network's device and arrive
here as numpy. A tensor argument is copied to the host first.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def _host(a):
    """numpy view of `a`: tensors (any device, bfloat16 as float32) are
    copied to the host; anything else goes through np.asarray."""
    if hasattr(a, "detach"):
        a = a.detach().cpu()
        return (a.float() if str(a.dtype) == "torch.bfloat16" else a).numpy()
    return np.asarray(a)


def _to_class_indices(arr: np.ndarray, mask: Optional[np.ndarray] = None):
    """[batch, classes] probs/one-hot (or [batch, time, classes]) → flat
    class indices + keep-mask."""
    arr = _host(arr)
    if arr.ndim == 3:
        classes = arr.shape[-1]
        flat = arr.reshape(-1, classes)
        keep = None
        if mask is not None:
            keep = _host(mask).reshape(-1) > 0
        return np.argmax(flat, axis=-1), keep
    if arr.ndim == 2:
        keep = None
        if mask is not None:
            m = _host(mask).reshape(-1)
            keep = m > 0
        return np.argmax(arr, axis=-1), keep
    # rank-1 class indices: the mask still applies
    keep = None if mask is None else _host(mask).reshape(-1) > 0
    return arr.astype(np.int64), keep


class Evaluation:
    """Classification metrics accumulator (reference eval/Evaluation.java)."""

    def __init__(self, n_classes: Optional[int] = None,
                 label_names: Optional[List[str]] = None, top_n: int = 1):
        self.n_classes = n_classes
        self.label_names = label_names
        self.top_n = int(top_n)
        self.top_n_correct = 0
        self.top_n_total = 0
        self.confusion: Optional[np.ndarray] = None
        if n_classes:
            self.confusion = np.zeros((n_classes, n_classes), np.int64)

    def _ensure(self, n: int):
        if self.confusion is None:
            self.n_classes = n
            self.confusion = np.zeros((n, n), np.int64)
        elif n > self.confusion.shape[0]:
            grown = np.zeros((n, n), np.int64)
            grown[:self.confusion.shape[0], :self.confusion.shape[1]] = self.confusion
            self.confusion = grown
            self.n_classes = n

    def eval(self, labels, predictions, mask=None):
        labels, predictions = _host(labels), _host(predictions)
        n = int(predictions.shape[-1]) if predictions.ndim > 1 \
            else int(max(np.max(labels), np.max(predictions)) + 1)
        self._ensure(n)
        t, keep = _to_class_indices(labels, mask)
        p, _ = _to_class_indices(predictions, mask)
        if keep is not None:
            t, p = t[keep], p[keep]
        np.add.at(self.confusion, (t, p), 1)
        # Top-N accuracy (reference Evaluation topN): needs probability
        # rows; rank-1 integer predictions can only support top-1.
        preds = predictions
        if self.top_n > 1 and preds.ndim >= 2:
            flat = preds.reshape(-1, preds.shape[-1])
            if keep is not None:
                flat = flat[keep]
            k = min(self.top_n, flat.shape[-1])
            topk = np.argpartition(-flat, k - 1, axis=-1)[:, :k]
            self.top_n_correct += int((topk == t[:, None]).any(-1).sum())
            self.top_n_total += t.size

    # ----------------------------------------------------------- metrics
    def num_examples(self) -> int:
        return int(self.confusion.sum()) if self.confusion is not None else 0

    def accuracy(self) -> float:
        if self.num_examples() == 0:
            return 0.0
        return float(np.trace(self.confusion) / self.confusion.sum())

    def true_positives(self, cls: int) -> int:
        return int(self.confusion[cls, cls])

    def false_positives(self, cls: int) -> int:
        return int(self.confusion[:, cls].sum() - self.confusion[cls, cls])

    def false_negatives(self, cls: int) -> int:
        return int(self.confusion[cls, :].sum() - self.confusion[cls, cls])

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self.true_positives(cls) + self.false_positives(cls)
            return self.true_positives(cls) / denom if denom else 0.0
        vals = [self.precision(c) for c in range(self.n_classes)
                if self.confusion[c, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self.true_positives(cls) + self.false_negatives(cls)
            return self.true_positives(cls) / denom if denom else 0.0
        vals = [self.recall(c) for c in range((self.n_classes or 0))
                if self.confusion[c, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def top_n_accuracy(self) -> float:
        """Reference Evaluation.topNAccuracy(): fraction of examples whose
        true class was among the top_n highest-probability predictions."""
        if self.top_n <= 1:
            return self.accuracy()
        return self.top_n_correct / self.top_n_total \
            if self.top_n_total else 0.0

    def label_name(self, cls: int) -> str:
        if self.label_names is not None and cls < len(self.label_names):
            return self.label_names[cls]
        return str(cls)

    def merge(self, other: "Evaluation") -> "Evaluation":
        """Accumulator merge (reference IEvaluation.merge; used by the
        data-parallel evaluator)."""
        if other.confusion is None:
            return self
        self._ensure(other.confusion.shape[0])
        self.confusion[:other.confusion.shape[0], :other.confusion.shape[1]] += \
            other.confusion
        self.top_n_correct += other.top_n_correct
        self.top_n_total += other.top_n_total
        if self.label_names is None:
            self.label_names = other.label_names
        return self

    def stats(self) -> str:
        """Reference Evaluation.stats(): overall metrics + per-class
        label-named precision/recall/f1 rows + confusion matrix."""
        lines = [
            f"# examples: {self.num_examples()}",
            f"Accuracy:  {self.accuracy():.4f}",
            f"Precision: {self.precision():.4f}",
            f"Recall:    {self.recall():.4f}",
            f"F1 Score:  {self.f1():.4f}",
        ]
        if self.top_n > 1:
            lines.append(f"Top-{self.top_n} Accuracy: "
                         f"{self.top_n_accuracy():.4f}")
        if self.n_classes:
            lines.append("Per-class (label: precision, recall, f1, count):")
            for c in range(self.n_classes):
                cnt = int(self.confusion[c, :].sum())
                lines.append(
                    f"  {self.label_name(c)}: {self.precision(c):.4f}, "
                    f"{self.recall(c):.4f}, {self.f1(c):.4f}, {cnt}")
        lines += ["Confusion matrix (rows=actual, cols=predicted):",
                  str(self.confusion)]
        return "\n".join(lines)


class RegressionEvaluation:
    """Per-column regression metrics (reference eval/RegressionEvaluation.java:
    MSE, MAE, RMSE, RSE, R^2, correlation)."""

    def __init__(self, n_columns: Optional[int] = None):
        self.n = 0
        self.sum_sq_err = None
        self.sum_abs_err = None
        self.sum_label = None
        self.sum_label_sq = None
        self.sum_pred = None
        self.sum_pred_sq = None
        self.sum_label_pred = None
        self.n_columns = n_columns

    def eval(self, labels, predictions, mask=None):
        labels = _host(labels).astype(np.float64)
        predictions = _host(predictions).astype(np.float64)
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
            if mask is not None:
                keep = _host(mask).reshape(-1) > 0
                labels, predictions = labels[keep], predictions[keep]
        cols = labels.shape[-1]
        if self.sum_sq_err is None:
            self.n_columns = cols
            z = np.zeros(cols, np.float64)
            (self.sum_sq_err, self.sum_abs_err, self.sum_label, self.sum_label_sq,
             self.sum_pred, self.sum_pred_sq, self.sum_label_pred) = \
                (z.copy() for _ in range(7))
        err = predictions - labels
        self.n += labels.shape[0]
        self.sum_sq_err += (err ** 2).sum(0)
        self.sum_abs_err += np.abs(err).sum(0)
        self.sum_label += labels.sum(0)
        self.sum_label_sq += (labels ** 2).sum(0)
        self.sum_pred += predictions.sum(0)
        self.sum_pred_sq += (predictions ** 2).sum(0)
        self.sum_label_pred += (labels * predictions).sum(0)

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self.sum_sq_err[col] / self.n)

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self.sum_abs_err[col] / self.n)

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col: int = 0) -> float:
        ss_tot = self.sum_label_sq[col] - self.sum_label[col] ** 2 / self.n
        ss_res = self.sum_sq_err[col]
        return float(1.0 - ss_res / ss_tot) if ss_tot else 0.0

    def correlation(self, col: int = 0) -> float:
        n = self.n
        cov = self.sum_label_pred[col] - self.sum_label[col] * self.sum_pred[col] / n
        vl = self.sum_label_sq[col] - self.sum_label[col] ** 2 / n
        vp = self.sum_pred_sq[col] - self.sum_pred[col] ** 2 / n
        denom = np.sqrt(vl * vp)
        return float(cov / denom) if denom else 0.0

    def stats(self) -> str:
        cols = range(self.n_columns or 0)
        return "\n".join(
            f"col {c}: MSE={self.mean_squared_error(c):.6f} "
            f"MAE={self.mean_absolute_error(c):.6f} "
            f"RMSE={self.root_mean_squared_error(c):.6f} "
            f"R2={self.r_squared(c):.4f}" for c in cols)


class EvaluationBinary:
    """Per-output binary metrics with 0.5 threshold (reference
    eval/EvaluationBinary.java)."""

    def __init__(self):
        self.tp = self.fp = self.tn = self.fn = None

    def eval(self, labels, predictions, mask=None):
        labels = _host(labels) > 0.5
        preds = _host(predictions) > 0.5
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            preds = preds.reshape(-1, preds.shape[-1])
            if mask is not None:
                keep = _host(mask).reshape(-1) > 0
                labels, preds = labels[keep], preds[keep]
        if self.tp is None:
            z = np.zeros(labels.shape[-1], np.int64)
            self.tp, self.fp, self.tn, self.fn = z.copy(), z.copy(), z.copy(), z.copy()
        self.tp += (labels & preds).sum(0)
        self.fp += (~labels & preds).sum(0)
        self.tn += (~labels & ~preds).sum(0)
        self.fn += (labels & ~preds).sum(0)

    def accuracy(self, col: int = 0) -> float:
        total = self.tp[col] + self.fp[col] + self.tn[col] + self.fn[col]
        return float((self.tp[col] + self.tn[col]) / total) if total else 0.0

    def precision(self, col: int = 0) -> float:
        d = self.tp[col] + self.fp[col]
        return float(self.tp[col] / d) if d else 0.0

    def recall(self, col: int = 0) -> float:
        d = self.tp[col] + self.fn[col]
        return float(self.tp[col] / d) if d else 0.0

    def f1(self, col: int = 0) -> float:
        p, r = self.precision(col), self.recall(col)
        return 2 * p * r / (p + r) if (p + r) else 0.0
