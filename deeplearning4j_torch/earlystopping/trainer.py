"""EarlyStoppingTrainer (reference earlystopping/trainer/
BaseEarlyStoppingTrainer.java — the fit loop with per-iteration and
per-epoch termination checks; works for MultiLayerNetwork and
ComputationGraph alike, replacing the reference's separate
EarlyStoppingTrainer/EarlyStoppingGraphTrainer pair); port of
`deeplearning4j_tpu/earlystopping/trainer.py`."""
from __future__ import annotations

import logging
import math
from typing import Optional

from .config import (EarlyStoppingConfiguration, EarlyStoppingResult,
                     TerminationReason)
from ..optimize import metrics as metrics_mod
from ..optimize import tracing

log = logging.getLogger("deeplearning4j_torch.earlystopping")


class EarlyStoppingTrainer:
    def __init__(self, config: EarlyStoppingConfiguration, model,
                 train_data, train_labels=None, batch_size: int = 32):
        self.config = config
        self.model = model
        self.train_data = train_data
        self.train_labels = train_labels
        self.batch_size = batch_size

    def _fit_epoch(self):
        """One training epoch; EarlyStoppingParallelTrainer overrides to
        route through a ParallelWrapper."""
        self.model.fit(self.train_data, self.train_labels, epochs=1,
                       batch_size=self.batch_size)

    def fit(self, max_epochs: int = 10_000) -> EarlyStoppingResult:
        conf = self.config
        model = self.model
        for c in conf.epoch_termination_conditions:
            c.initialize()
        for c in conf.iteration_termination_conditions:
            c.initialize()

        score_vs_epoch = {}
        best_score = math.inf
        best_epoch = -1
        reason: Optional[TerminationReason] = None
        details = ""
        epoch = 0

        # Per-iteration termination rides the listener hook.
        stop_flag = {"stop": False, "why": ""}
        outer = self

        class _IterCheck:
            def iteration_done(self, m, iteration):
                score = float(m.score_value)
                for c in conf.iteration_termination_conditions:
                    if c.terminate(score):
                        stop_flag["stop"] = True
                        stop_flag["why"] = str(c)
                        raise _StopIteration()

            def on_epoch_end(self, m, e):
                pass

        class _StopIteration(Exception):
            pass

        # Only install the per-step check (and its device-fencing score
        # fetch) when iteration conditions actually exist.
        if conf.iteration_termination_conditions:
            model.listeners.append(_IterCheck())
        reg = metrics_mod.registry()
        try:
            while epoch < max_epochs:
                try:
                    with tracing.span("earlystopping/epoch", epoch=epoch):
                        self._fit_epoch()
                except _StopIteration:
                    reason = TerminationReason.ITERATION_TERMINATION
                    details = stop_flag["why"]
                    break
                epoch += 1
                reg.counter("early_stopping_epochs_total",
                            "Epochs completed under early stopping").inc()

                # Best-model tracking and score-based termination only run
                # on epochs where the score calculator actually ran
                # (reference BaseEarlyStoppingTrainer); without a
                # calculator, last train-batch loss is the documented
                # fallback and every epoch is an eval epoch.
                has_calc = conf.score_calculator is not None
                eval_epoch = (not has_calc) or \
                    (epoch % conf.evaluate_every_n_epochs == 0)
                if eval_epoch:
                    score = float(conf.score_calculator(model)) if has_calc \
                        else float(model.score_value)
                    score_vs_epoch[epoch] = score
                    if score < best_score:
                        best_score = score
                        best_epoch = epoch
                        conf.saver.save_best_model(model, score)
                        reg.gauge("early_stopping_best_score",
                                  "Best evaluation score so far"
                                  ).set(best_score)
                if conf.save_last_model:
                    conf.saver.save_latest_model(model, float(
                        model.score_value))
                if eval_epoch:
                    stop = None
                    for c in conf.epoch_termination_conditions:
                        if c.terminate(epoch, score):
                            stop = c
                            break
                    if stop is not None:
                        reason = TerminationReason.EPOCH_TERMINATION
                        details = str(stop)
                        break
        finally:
            model.listeners = [l for l in model.listeners
                               if not isinstance(l, _IterCheck)]

        if reason is None:
            reason = TerminationReason.EPOCH_TERMINATION
            details = f"max_epochs({max_epochs})"
        best = conf.saver.get_best_model()
        return EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            score_vs_epoch=score_vs_epoch,
            best_model_epoch=best_epoch,
            best_model_score=best_score,
            total_epochs=epoch,
            best_model=best if best is not None else model,
        )


class EarlyStoppingGraphTrainer(EarlyStoppingTrainer):
    """Name parity (reference EarlyStoppingGraphTrainer); the base already
    handles ComputationGraph."""


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    """Early stopping over data-parallel training (reference
    parallelism/EarlyStoppingParallelTrainer.java): each epoch trains
    through the ParallelWrapper's sharded or local-SGD step; termination,
    scoring and best-model saving read the wrapped network as usual."""

    def __init__(self, config: EarlyStoppingConfiguration, wrapper,
                 train_data, train_labels=None, batch_size: int = 32):
        super().__init__(config, wrapper.model, train_data, train_labels,
                         batch_size)
        self.wrapper = wrapper

    def _fit_epoch(self):
        try:
            self.wrapper.fit(self.train_data, self.train_labels, epochs=1,
                             batch_size=self.batch_size)
        finally:
            # an iteration termination aborts by exception before fit's own
            # finalize; a pending local-SGD window must still average so
            # the saved best model is the wrapper's averaged one
            self.wrapper.finalize()
