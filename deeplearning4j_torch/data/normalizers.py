"""Data normalizers, the checkpoint's `normalizer.json` entry.

Port of `deeplearning4j_tpu/data/normalizers.py` (reference nd4j's
NormalizerStandardize, NormalizerMinMaxScaler and ImagePreProcessingScaler,
persisted by ModelSerializer.writeModel's normalizer entry): the same
fields, registered under the same names, so a normalizer that either
package stores in a checkpoint restores in the other. Statistics are plain
lists of floats. Data stays numpy on the host: `transform` is the numpy
formula of the JAX package's fallback arm (its `native_etl` host kernels
wait for the data-pipeline slice).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..utils import serde
from .dataset import DataSet


class DataNormalization:
    """SPI (nd4j DataNormalization): fit(iterator | DataSet), and
    transform(DataSet) (also by calling it) in place of the reference's
    preProcess."""

    def fit(self, data) -> "DataNormalization":
        raise NotImplementedError

    def transform(self, ds: DataSet) -> DataSet:
        raise NotImplementedError

    def revert(self, ds: DataSet) -> DataSet:
        raise NotImplementedError

    def __call__(self, ds: DataSet) -> DataSet:
        return self.transform(ds)

    @staticmethod
    def _features_of(data):
        if isinstance(data, DataSet):
            yield np.asarray(data.features)
        else:  # an iterator of DataSets
            for ds in data:
                yield np.asarray(ds.features)


@serde.register
@dataclass
class NormalizerStandardize(DataNormalization):
    """Zero mean, unit variance per feature column: statistics over every
    axis but the last, in float64."""

    mean: Optional[List[float]] = None
    std: Optional[List[float]] = None

    def fit(self, data):
        count, s, ss = 0, None, None
        for x in self._features_of(data):
            flat = x.reshape(-1, x.shape[-1]).astype(np.float64)
            if s is None:
                s, ss = flat.sum(0), (flat ** 2).sum(0)
            else:
                s += flat.sum(0)
                ss += (flat ** 2).sum(0)
            count += flat.shape[0]
        if count == 0:
            raise ValueError("fit() saw no data")
        mean = s / count
        var = np.maximum(ss / count - mean ** 2, 1e-12)
        self.mean = mean.tolist()
        self.std = np.sqrt(var).tolist()
        return self

    def _stats(self):
        if self.mean is None:
            raise RuntimeError("Call fit() before transform()")
        return (np.asarray(self.mean, np.float32),
                np.asarray(self.std, np.float32))

    def transform(self, ds: DataSet) -> DataSet:
        m, s = self._stats()
        return DataSet((np.asarray(ds.features) - m) / s, ds.labels,
                       ds.features_mask, ds.labels_mask)

    def revert(self, ds: DataSet) -> DataSet:
        m, s = self._stats()
        return DataSet(np.asarray(ds.features) * s + m, ds.labels,
                       ds.features_mask, ds.labels_mask)


@serde.register
@dataclass
class NormalizerMinMaxScaler(DataNormalization):
    """Scale each feature column into [min_range, max_range]."""

    min_range: float = 0.0
    max_range: float = 1.0
    data_min: Optional[List[float]] = None
    data_max: Optional[List[float]] = None

    def fit(self, data):
        lo = hi = None
        for x in self._features_of(data):
            flat = x.reshape(-1, x.shape[-1])
            fl, fh = flat.min(0), flat.max(0)
            lo = fl if lo is None else np.minimum(lo, fl)
            hi = fh if hi is None else np.maximum(hi, fh)
        if lo is None:
            raise ValueError("fit() saw no data")
        self.data_min = np.asarray(lo, np.float64).tolist()
        self.data_max = np.asarray(hi, np.float64).tolist()
        return self

    def _stats(self):
        if self.data_min is None:
            raise RuntimeError("Call fit() before transform()")
        lo = np.asarray(self.data_min, np.float32)
        hi = np.asarray(self.data_max, np.float32)
        return lo, np.maximum(hi - lo, 1e-12)

    def transform(self, ds: DataSet) -> DataSet:
        lo, span = self._stats()
        scaled = (np.asarray(ds.features) - lo) / span
        out = scaled * (self.max_range - self.min_range) + self.min_range
        return DataSet(out.astype(np.float32), ds.labels,
                       ds.features_mask, ds.labels_mask)

    def revert(self, ds: DataSet) -> DataSet:
        lo, span = self._stats()
        unit = (np.asarray(ds.features) - self.min_range) \
            / (self.max_range - self.min_range)
        return DataSet((unit * span + lo).astype(np.float32), ds.labels,
                       ds.features_mask, ds.labels_mask)


@serde.register
@dataclass
class ImagePreProcessingScaler(DataNormalization):
    """Pixel values in [0, max_pixel] to [min_range, max_range], with no
    fitting (reference ImagePreProcessingScaler, maxPixelVal 255)."""

    min_range: float = 0.0
    max_range: float = 1.0
    max_pixel: float = 255.0

    def fit(self, data):
        return self  # stateless, like the reference

    def transform(self, ds: DataSet) -> DataSet:
        x = np.asarray(ds.features, np.float32) / self.max_pixel
        x = x * (self.max_range - self.min_range) + self.min_range
        return DataSet(x, ds.labels, ds.features_mask, ds.labels_mask)

    def revert(self, ds: DataSet) -> DataSet:
        x = (np.asarray(ds.features) - self.min_range) \
            / (self.max_range - self.min_range) * self.max_pixel
        return DataSet(x.astype(np.float32), ds.labels,
                       ds.features_mask, ds.labels_mask)
