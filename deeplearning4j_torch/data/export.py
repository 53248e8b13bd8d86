"""Export-based training: pre-batched DataSets saved to disk, streamed back.

Port of `deeplearning4j_tpu/data/export.py` (reference dl4j-spark's
BatchAndExportDataSetsFunction and ExportSupport): `export_datasets` re-batches
any DataSetIterator to exactly `batch_size` examples a file, across the
boundaries of the incoming DataSets, the last partial batch kept, and writes
``dataset_<idx>.npz``; `ExportedDataSetIterator` streams the files back in
order, one batch resident at a time. The format is numpy's .npz with the keys
features and labels (features_mask and labels_mask are read when present), so
either package reads the other's files.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np

from .dataset import DataSet
from .iterators import DataSetIterator

_FILE_RE = re.compile(r"^dataset_(\d+)\.npz$")


def export_datasets(iterator, directory: str, batch_size: int,
                    max_batches: Optional[int] = None) -> List[str]:
    """Re-batch `iterator` to exactly `batch_size` examples per file and
    export (reference BatchAndExportDataSetsFunction semantics: batches
    are rebuilt across incoming DataSet boundaries; the final partial
    batch is kept, like ExportSupport). Returns the written paths."""
    os.makedirs(directory, exist_ok=True)
    paths: List[str] = []
    buf_f: List[np.ndarray] = []
    buf_l: List[np.ndarray] = []
    count = 0

    def flush(n):
        nonlocal count
        if not buf_f:
            return
        cat_f = np.concatenate(buf_f)
        cat_l = np.concatenate(buf_l)
        f, rest_f = cat_f[:n], cat_f[n:]
        l, rest_l = cat_l[:n], cat_l[n:]
        buf_f.clear()
        buf_l.clear()
        if rest_f.shape[0]:
            buf_f.append(rest_f)
            buf_l.append(rest_l)
        path = os.path.join(directory, f"dataset_{count}.npz")
        np.savez(path, features=f, labels=l)
        paths.append(path)
        count += 1

    for ds in iterator:
        if ds.features_mask is not None or ds.labels_mask is not None:
            raise NotImplementedError(
                "export_datasets does not re-batch masked (variable "
                "length) DataSets")
        buf_f.append(np.asarray(ds.features))
        buf_l.append(np.asarray(ds.labels))
        while sum(a.shape[0] for a in buf_f) >= batch_size:
            flush(batch_size)
            if max_batches is not None and count >= max_batches:
                return paths
    if buf_f:
        flush(sum(a.shape[0] for a in buf_f))
    return paths


class ExportedDataSetIterator(DataSetIterator):
    """Stream exported batch files back as DataSets (the training side
    of export-based training). Files are memory-light: one batch is
    resident at a time, which is exactly what AsyncDataSetIterator's
    prefetch queue wants."""

    def __init__(self, directory: str):
        self.directory = directory
        names = sorted(
            (int(m.group(1)), n) for n in os.listdir(directory)
            if (m := _FILE_RE.match(n)))
        self._files = [os.path.join(directory, n) for _, n in names]
        if not self._files:
            raise FileNotFoundError(
                f"no dataset_<N>.npz files in {directory!r}")
        self._i = 0
        with np.load(self._files[0]) as z:
            self._batch = int(z["features"].shape[0])

    def reset(self):
        self._i = 0

    def batch_size(self):
        """NOMINAL batch size (first file's row count). The exporter
        keeps a smaller final partial batch, so the LAST file may hold
        fewer rows — don't size fixed buffers off this value."""
        return self._batch

    def __next__(self) -> DataSet:
        if self._i >= len(self._files):
            raise StopIteration
        with np.load(self._files[self._i]) as z:
            ds = DataSet(z["features"], z["labels"],
                         z["features_mask"] if "features_mask" in z else None,
                         z["labels_mask"] if "labels_mask" in z else None)
        self._i += 1
        return self._maybe_preprocess(ds)
