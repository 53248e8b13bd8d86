"""Record readers and the record-reader dataset iterators (the DataVec glue).

Port of `deeplearning4j_tpu/data/records.py` (reference DataVec's
RecordReader SPI consumed through deeplearning4j-core's
datasets/datavec/RecordReaderDataSetIterator.java: label-column extraction,
one-hot for classification, regression pass-through; and
SequenceRecordReaderDataSetIterator.java: paired feature/label sequence
readers, shorter sequences left-aligned and mask-padded). CSV parsing is
DataVec's CSVRecordReader / CSVSequenceRecordReader, through the csv module.

Readers yield plain Python rows on the host; batches are numpy arrays, which
the fit loop (or a DevicePrefetchIterator) copies to the device. Both
packages produce the same DataSets from the same records.
"""
from __future__ import annotations

import csv
import io
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

from .dataset import DataSet
from .iterators import DataSetIterator


class RecordReader:
    """SPI (DataVec RecordReader): iterate records = lists of values."""

    def __iter__(self) -> Iterator[List[str]]:
        self.reset()
        return self

    def __next__(self) -> List[str]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class ListStringRecordReader(RecordReader):
    """Records from an in-memory list of rows (DataVec
    ListStringRecordReader)."""

    def __init__(self, rows: Sequence[Sequence[str]]):
        self._rows = [list(r) for r in rows]
        self._i = 0

    def reset(self):
        self._i = 0

    def __next__(self):
        if self._i >= len(self._rows):
            raise StopIteration
        row = self._rows[self._i]
        self._i += 1
        return row


class CSVRecordReader(RecordReader):
    """CSV file -> records (DataVec CSVRecordReader: skipNumLines,
    delimiter, quote handling via the csv module)."""

    def __init__(self, path: str, skip_lines: int = 0, delimiter: str = ","):
        self.path = path
        self.skip_lines = int(skip_lines)
        self.delimiter = delimiter
        self._rows: Optional[List[List[str]]] = None
        self._i = 0

    def _load(self):
        if self._rows is None:
            with open(self.path, newline="") as f:
                rows = list(csv.reader(f, delimiter=self.delimiter))
            self._rows = [r for r in rows[self.skip_lines:] if r]

    def reset(self):
        self._load()
        self._i = 0

    def __next__(self):
        self._load()
        if self._i >= len(self._rows):
            raise StopIteration
        row = self._rows[self._i]
        self._i += 1
        return row


class CSVSequenceRecordReader:
    """One CSV file per sequence (DataVec CSVSequenceRecordReader):
    iterating yields [timesteps][columns] token matrices."""

    def __init__(self, paths: Sequence[str], skip_lines: int = 0,
                 delimiter: str = ","):
        self.paths = list(paths)
        self.skip_lines = int(skip_lines)
        self.delimiter = delimiter
        self._i = 0

    def __iter__(self):
        self.reset()
        return self

    def reset(self):
        self._i = 0

    def __next__(self) -> List[List[str]]:
        if self._i >= len(self.paths):
            raise StopIteration
        with open(self.paths[self._i], newline="") as f:
            rows = [r for r in csv.reader(f, delimiter=self.delimiter) if r]
        self._i += 1
        return rows[self.skip_lines:]


class RecordReaderDataSetIterator(DataSetIterator):
    """Records -> DataSets (reference RecordReaderDataSetIterator).

    Classification: `label_index` column becomes a one-hot of
    `num_classes`. Regression: `label_index` (or the span
    label_index..label_index_to) passes through as float labels.
    """

    def __init__(self, reader: RecordReader, batch_size: int = 32,
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 regression: bool = False,
                 label_index_to: Optional[int] = None):
        self.reader = reader
        self._batch = int(batch_size)
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self.label_index_to = label_index_to
        if not regression and label_index is not None and not num_classes:
            raise ValueError("classification needs num_classes")
        self._it: Optional[Iterator] = None

    def reset(self):
        self.reader.reset()
        self._it = iter(self.reader)

    def batch_size(self):
        return self._batch

    def _split(self, row: List[str]):
        vals = np.array([float(v) for v in row], np.float32)
        li = self.label_index
        if li is None:
            return vals, None
        if self.regression:
            hi = (self.label_index_to if self.label_index_to is not None
                  else li) + 1
            y = vals[li:hi]
            x = np.concatenate([vals[:li], vals[hi:]])
            return x, y
        y = np.zeros(self.num_classes, np.float32)
        y[int(vals[li])] = 1.0
        x = np.concatenate([vals[:li], vals[li + 1:]])
        return x, y

    def __next__(self) -> DataSet:
        if self._it is None:
            self.reset()
        xs, ys = [], []
        for _ in range(self._batch):
            try:
                row = next(self._it)
            except StopIteration:
                break
            x, y = self._split(row)
            xs.append(x)
            ys.append(y)
        if not xs:
            raise StopIteration
        feats = np.stack(xs)
        labels = feats if ys[0] is None else np.stack(ys)
        return self._maybe_preprocess(DataSet(feats, labels))


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Paired feature/label sequence readers -> padded+masked rank-3
    DataSets (reference SequenceRecordReaderDataSetIterator,
    ALIGN_END-style padding: shorter sequences are left-aligned and
    mask-padded)."""

    def __init__(self, features_reader, labels_reader=None,
                 batch_size: int = 32, num_classes: Optional[int] = None,
                 regression: bool = False, label_index: int = -1):
        self.features_reader = features_reader
        self.labels_reader = labels_reader
        self._batch = int(batch_size)
        self.num_classes = num_classes
        self.regression = regression
        self.label_index = label_index
        self._fit = None
        self._lit = None

    def reset(self):
        self._fit = iter(self.features_reader)
        self._lit = iter(self.labels_reader) \
            if self.labels_reader is not None else None

    def batch_size(self):
        return self._batch

    def _one(self):
        seq = next(self._fit)
        f = np.array([[float(v) for v in row] for row in seq], np.float32)
        if self._lit is not None:
            lab_rows = next(self._lit)
            if self.regression:
                y = np.array([[float(v) for v in row] for row in lab_rows],
                             np.float32)
            else:
                idx = [int(float(row[0])) for row in lab_rows]
                y = np.eye(self.num_classes, dtype=np.float32)[idx]
        else:
            li = self.label_index
            if self.regression:
                y = f[:, li:li + 1] if li >= 0 else f[:, -1:]
                f = np.delete(f, li if li >= 0 else -1, axis=1)
            else:
                col = f[:, li].astype(int)
                y = np.eye(self.num_classes, dtype=np.float32)[col]
                f = np.delete(f, li, axis=1)
        return f, y

    def __next__(self) -> DataSet:
        if self._fit is None:
            self.reset()
        fs, ys = [], []
        for _ in range(self._batch):
            try:
                fs_y = self._one()
            except StopIteration:
                break
            fs.append(fs_y[0])
            ys.append(fs_y[1])
        if not fs:
            raise StopIteration
        T = max(f.shape[0] for f in fs)
        B = len(fs)
        feats = np.zeros((B, T, fs[0].shape[1]), np.float32)
        labels = np.zeros((B, T, ys[0].shape[1]), np.float32)
        fmask = np.zeros((B, T), np.float32)
        lmask = np.zeros((B, T), np.float32)
        for i, (f, y) in enumerate(zip(fs, ys)):
            feats[i, :f.shape[0]] = f
            labels[i, :y.shape[0]] = y
            fmask[i, :f.shape[0]] = 1.0
            lmask[i, :y.shape[0]] = 1.0
        return self._maybe_preprocess(
            DataSet(feats, labels, fmask, lmask))
