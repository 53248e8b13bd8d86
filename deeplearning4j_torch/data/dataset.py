"""DataSet container.

Port of `deeplearning4j_tpu/data/dataset.py` (reference nd4j-api `DataSet`:
features, labels, featuresMask, labelsMask), consumed by the fit loop. Data
stays numpy on the host (cheap slicing and shuffling); the network copies a
batch to its device at the start of each step. MultiDataSet comes with the
ComputationGraph slice.
"""
from __future__ import annotations

from dataclasses import dataclass
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
