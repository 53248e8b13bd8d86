"""Best-model savers (reference earlystopping/saver/*.java); port of
`deeplearning4j_tpu/earlystopping/savers.py`."""
from __future__ import annotations

import os


class EarlyStoppingModelSaver:
    def save_best_model(self, model, score: float) -> None:
        raise NotImplementedError

    def save_latest_model(self, model, score: float) -> None:
        pass

    def get_best_model(self):
        raise NotImplementedError


class InMemoryModelSaver(EarlyStoppingModelSaver):
    """Keep the best model's arrays in memory (reference
    InMemoryModelSaver)."""

    def __init__(self):
        self._best = None

    def save_best_model(self, model, score):
        from ..utils.params import tree_copy as copy
        # copies, not aliases: training goes on from the live trees
        self._best = (model, copy(model.params_tree), copy(model.state_tree),
                      copy(model.opt_state), model.iteration, model.epoch)

    def get_best_model(self):
        """Returns a NEW network with the best-epoch arrays; the live
        training model is left untouched (reference InMemoryModelSaver
        stores a clone)."""
        if self._best is None:
            return None
        model, params, state, opt, iteration, epoch = self._best
        best = type(model)(model.conf.clone())._adopt(
            params, model._dtype, model.device, opt_state=opt, state_tree=state)
        best.iteration = iteration
        best.epoch = epoch
        return best


class LocalFileModelSaver(EarlyStoppingModelSaver):
    """Checkpoint best/latest to disk (reference LocalFile{Model,Graph}Saver
    — one saver handles both model classes here). Both writes are atomic
    (save_model's tmp+fsync+rename path), so a crash mid-save never tears
    an existing bestModel.zip/latestModel.zip."""

    def __init__(self, directory: str, device=None):
        self.dir = directory
        #: where get_best_model restores: `device`, else the device of the
        #: last model saved, else CUDA (the entry points' default)
        self.device = device
        os.makedirs(directory, exist_ok=True)
        self.best_path = os.path.join(directory, "bestModel.zip")
        self.latest_path = os.path.join(directory, "latestModel.zip")

    def save_best_model(self, model, score):
        from ..utils.model_serializer import save_model
        save_model(model, self.best_path)
        self._saved_on = model.device

    def save_latest_model(self, model, score):
        from ..utils.model_serializer import save_model
        save_model(model, self.latest_path)
        self._saved_on = model.device

    _saved_on = None

    def get_best_model(self):
        """Restore bestModel.zip; if it is corrupt (e.g. pre-atomic-write
        torn file, disk damage), fall back to latestModel.zip with a
        warning rather than raising — a slightly-worse model beats losing
        the early-stopping run."""
        import logging
        from ..utils.model_serializer import (CheckpointCorruptError,
                                              restore_model)
        if not os.path.exists(self.best_path):
            return None
        device = self.device if self.device is not None else self._saved_on
        try:
            return restore_model(self.best_path, device=device)
        except CheckpointCorruptError as e:
            log = logging.getLogger(__name__)
            if not os.path.exists(self.latest_path):
                raise
            log.warning("bestModel.zip is corrupt (%s); falling back to "
                        "latestModel.zip", e)
            return restore_model(self.latest_path, device=device)
