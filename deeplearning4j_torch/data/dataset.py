"""DataSet and MultiDataSet containers.

Port of `deeplearning4j_tpu/data/dataset.py` (reference nd4j-api `DataSet`:
features, labels, featuresMask, labelsMask; `MultiDataSet`: lists of each),
consumed by the fit loops of MultiLayerNetwork and ComputationGraph. Data
stays numpy on the host (cheap slicing and shuffling); the network copies a
batch to its device at the start of each step.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class DataSet:
    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def split_test_and_train(self, n_train: int):
        return (DataSet(self.features[:n_train], self.labels[:n_train],
                        _sl(self.features_mask, 0, n_train),
                        _sl(self.labels_mask, 0, n_train)),
                DataSet(self.features[n_train:], self.labels[n_train:],
                        _sl(self.features_mask, n_train, None),
                        _sl(self.labels_mask, n_train, None)))

    def shuffle(self, seed: Optional[int] = None) -> "DataSet":
        idx = np.random.default_rng(seed).permutation(self.num_examples())
        return DataSet(self.features[idx], self.labels[idx],
                       None if self.features_mask is None else self.features_mask[idx],
                       None if self.labels_mask is None else self.labels_mask[idx])

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        return [DataSet(self.features[i:i + batch_size],
                        self.labels[i:i + batch_size],
                        _sl(self.features_mask, i, i + batch_size),
                        _sl(self.labels_mask, i, i + batch_size))
                for i in range(0, self.num_examples(), batch_size)]

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        return DataSet(
            np.concatenate([d.features for d in datasets]),
            np.concatenate([d.labels for d in datasets]),
            _cat([d.features_mask for d in datasets]),
            _cat([d.labels_mask for d in datasets]))


def _sl(arr, a, b):
    return None if arr is None else arr[a:b]


def _cat(arrs):
    if any(a is None for a in arrs):
        return None
    return np.concatenate(arrs)


@dataclass
class MultiDataSet:
    """Multi-input/multi-output container (reference nd4j MultiDataSet),
    consumed by ComputationGraph.fit: one array per network input and
    output, in the configuration's order."""

    features: List[np.ndarray] = field(default_factory=list)
    labels: List[np.ndarray] = field(default_factory=list)
    features_masks: Optional[List[Optional[np.ndarray]]] = None
    labels_masks: Optional[List[Optional[np.ndarray]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])

    def slice(self, a: int, b: int) -> "MultiDataSet":
        """Rows [a, b) of every array and mask."""
        return MultiDataSet(
            [f[a:b] for f in self.features], [y[a:b] for y in self.labels],
            None if self.features_masks is None else
            [_sl(m, a, b) for m in self.features_masks],
            None if self.labels_masks is None else
            [_sl(m, a, b) for m in self.labels_masks])

    @staticmethod
    def from_dataset(ds: DataSet) -> "MultiDataSet":
        return MultiDataSet(
            [ds.features], [ds.labels],
            None if ds.features_mask is None else [ds.features_mask],
            None if ds.labels_mask is None else [ds.labels_mask])


class SlicingMultiIterator:
    """Re-iterable minibatch views of one MultiDataSet, `batch_size` rows
    each, the last one ragged (the JAX package's `_SlicingMultiIterator`,
    nn/graph/graph.py:50)."""

    def __init__(self, mds: MultiDataSet, batch_size: int):
        self._mds = mds
        self._batch = int(batch_size)

    def __iter__(self):
        n = self._mds.num_examples()
        for start in range(0, n, self._batch):
            yield self._mds.slice(start, min(start + self._batch, n))
