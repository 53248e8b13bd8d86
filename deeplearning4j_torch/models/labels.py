"""ImageNet label decoding.

Port of `deeplearning4j_tpu/models/labels.py` (reference
zoo/util/imagenet/ImageNetLabels.java). The reference fetches
imagenet_class_index.json from a URL at run time; here, as in the JAX
package, the same standard file loads from a local path, and nothing is
downloaded. `decode_predictions` takes numpy arrays or CPU tensors.
"""
from __future__ import annotations

import json
from typing import List, Sequence, Tuple

import numpy as np


class ImageNetLabels:
    """Index -> human label over the standard imagenet_class_index.json
    format: {"0": ["n01440764", "tench"], "1": [...], ...}."""

    def __init__(self, path: str):
        with open(path) as f:
            raw = json.load(f)
        self._labels: List[str] = [""] * len(raw)
        self._wnids: List[str] = [""] * len(raw)
        for k, (wnid, label) in raw.items():
            i = int(k)
            if not 0 <= i < len(raw):
                raise ValueError(f"class index {k} out of range")
            self._wnids[i] = wnid
            self._labels[i] = label

    def __len__(self) -> int:
        return len(self._labels)

    def get_label(self, idx: int) -> str:
        """Reference ImageNetLabels.getLabel(int)."""
        return self._labels[idx]

    def wnid(self, idx: int) -> str:
        return self._wnids[idx]

    def decode_predictions(self, predictions, top: int = 5
                           ) -> List[List[Tuple[str, str, float]]]:
        """[batch, classes] probabilities -> per-row top-k
        (wnid, label, probability) — reference
        ImageNetLabels.decodePredictions."""
        p = np.asarray(predictions)
        if p.ndim == 1:
            p = p[None]
        if p.shape[1] != len(self._labels):
            raise ValueError(
                f"predictions have {p.shape[1]} classes, labels have "
                f"{len(self._labels)}")
        out = []
        for row in p:
            order = np.argsort(row)[::-1][:top]
            out.append([(self._wnids[i], self._labels[i], float(row[i]))
                        for i in order])
        return out
