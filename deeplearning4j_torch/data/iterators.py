"""DataSet iterators.

Port of the synchronous part of `deeplearning4j_tpu/data/iterators.py`
(reference nd4j `DataSetIterator` SPI, `ListDataSetIterator`,
`ExistingDataSetIterator`) and `as_iterator`, which `fit` uses to take a
DataSetIterator, a DataSet, or (features, labels) arrays. The async,
device-prefetch, pad-to-bucket and pack iterators come with a later slice.
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional

import numpy as np

from .dataset import DataSet


class DataSetIterator:
    """Iterator SPI (reference nd4j DataSetIterator). Subclasses implement
    `reset` and `__next__`; `__iter__` restarts by default."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def batch_size(self) -> int:
        raise NotImplementedError

    def total_examples(self) -> Optional[int]:
        return None

    # Normalizer hook (reference DataSetIterator.setPreProcessor)
    pre_processor: Optional[Callable[[DataSet], DataSet]] = None

    def _maybe_preprocess(self, ds: DataSet) -> DataSet:
        if self.pre_processor is not None:
            out = self.pre_processor(ds)
            return ds if out is None else out
        return ds


class ListDataSetIterator(DataSetIterator):
    """Iterate a DataSet in minibatches (reference ListDataSetIterator); the
    last batch is ragged unless `drop_last`."""

    def __init__(self, data: DataSet, batch_size: int = 32, shuffle: bool = False,
                 seed: Optional[int] = None, drop_last: bool = False):
        self._data = data
        self._batch = int(batch_size)
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._drop_last = drop_last
        self._cursor = 0
        self._view = data

    def reset(self):
        self._cursor = 0
        if self._shuffle:
            self._view = self._data.shuffle(
                None if self._seed is None else self._seed + self._epoch)
            self._epoch += 1

    def __next__(self) -> DataSet:
        n = self._view.num_examples()
        if self._cursor >= n:
            raise StopIteration
        end = min(self._cursor + self._batch, n)
        if self._drop_last and end - self._cursor < self._batch:
            raise StopIteration
        v, a = self._view, self._cursor
        ds = DataSet(v.features[a:end], v.labels[a:end],
                     None if v.features_mask is None else v.features_mask[a:end],
                     None if v.labels_mask is None else v.labels_mask[a:end])
        self._cursor = end
        return self._maybe_preprocess(ds)

    def batch_size(self):
        return self._batch

    def total_examples(self):
        return self._data.num_examples()


class ExistingDataSetIterator(DataSetIterator):
    """Wrap an existing iterable of DataSets (reference
    ExistingDataSetIterator)."""

    def __init__(self, datasets: Iterable[DataSet]):
        self._datasets = list(datasets)
        self._i = 0

    def reset(self):
        self._i = 0

    def __next__(self):
        if self._i >= len(self._datasets):
            raise StopIteration
        ds = self._datasets[self._i]
        self._i += 1
        return self._maybe_preprocess(ds)

    def batch_size(self):
        return self._datasets[0].num_examples() if self._datasets else 0


def as_iterator(data, labels=None, batch_size: int = 32) -> DataSetIterator:
    """Coerce (features, labels) / DataSet / iterator to a DataSetIterator."""
    if isinstance(data, DataSetIterator):
        return data
    if isinstance(data, DataSet):
        return ListDataSetIterator(data, batch_size or data.num_examples())
    if labels is None:
        raise ValueError("labels required when passing a raw feature array")
    ds = DataSet(np.asarray(data), np.asarray(labels))
    return ListDataSetIterator(ds, batch_size or ds.num_examples())
