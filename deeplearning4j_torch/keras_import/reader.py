"""HDF5 archive reader for Keras model files.

Port of `deeplearning4j_tpu/keras_import/reader.py` (reference
modelimport/keras/Hdf5Archive.java:25-61): the `model_config` /
`training_config` JSON attributes and each layer's weight datasets of a
Keras-saved .h5 file. The JAX package reads the file through h5py; the port
reads it with its own loader (`hdf5.py`), which needs nothing but numpy and
refuses, by name, any HDF5 feature outside the corner Keras files use.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np


class InvalidKerasConfigurationException(ValueError):
    """Reference exceptions/InvalidKerasConfigurationException."""


class UnsupportedKerasConfigurationException(ValueError):
    """Reference exceptions/UnsupportedKerasConfigurationException."""


class Hdf5Archive:
    def __init__(self, path: str):
        from . import hdf5
        self._f = hdf5.File(path)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- metadata
    def _json_attr(self, name: str) -> Optional[dict]:
        if name not in self._f.attrs:
            return None
        raw = self._f.attrs[name]
        if isinstance(raw, bytes):
            raw = raw.decode("utf-8")
        return json.loads(raw)

    def model_config(self) -> dict:
        cfg = self._json_attr("model_config")
        if cfg is None:
            raise InvalidKerasConfigurationException(
                "File has no 'model_config' attribute — not a Keras model "
                "file saved with model.save(...h5)")
        return cfg

    def training_config(self) -> Optional[dict]:
        return self._json_attr("training_config")

    def keras_version(self) -> str:
        v = self._f.attrs.get("keras_version", b"unknown")
        return v.decode() if isinstance(v, bytes) else str(v)

    # -------------------------------------------------------------- weights
    def _weights_root(self):
        # model.save(...) layout nests under model_weights/; bare
        # save_weights(...) puts layer groups at the root.
        return self._f["model_weights"] if "model_weights" in self._f \
            else self._f

    def layer_names(self) -> List[str]:
        root = self._weights_root()
        if "layer_names" in root.attrs:
            return [n.decode() if isinstance(n, bytes) else str(n)
                    for n in root.attrs["layer_names"]]
        return [k for k in root.keys() if k != "top_level_model_weights"]

    def layer_weights(self, layer_name: str) -> Dict[str, np.ndarray]:
        """All weight arrays for one layer, keyed by short name (`kernel`,
        `bias`, `gamma`, ...). Resolution goes through the `weight_names`
        attribute so any nesting (sequential/<name>/...) is handled."""
        root = self._weights_root()
        if layer_name not in root:
            return {}
        grp = root[layer_name]
        out: Dict[str, np.ndarray] = {}
        names = grp.attrs.get("weight_names")
        if names is not None:
            for wn in names:
                wn = wn.decode() if isinstance(wn, bytes) else str(wn)
                short = wn.split("/")[-1].split(":")[0]
                out[short] = np.asarray(grp[wn] if wn in grp
                                        else self._find(grp, wn))
            return out

        def walk(g, prefix=""):
            for k in g:
                item = g[k]
                if hasattr(item, "keys"):
                    walk(item, prefix + k + "/")
                else:
                    out[k.split(":")[0]] = np.asarray(item)
        walk(grp)
        return out

    @staticmethod
    def _find(grp, path: str):
        node = grp
        for part in path.split("/"):
            if part in node:
                node = node[part]
            else:
                raise KeyError(f"weight {path!r} not found under "
                               f"{grp.name!r}")
        return node
