"""EarlyStoppingConfiguration + result (reference
earlystopping/EarlyStoppingConfiguration.java, EarlyStoppingResult.java); port
of `deeplearning4j_tpu/earlystopping/config.py`."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from .savers import EarlyStoppingModelSaver, InMemoryModelSaver
from .termination import (EpochTerminationCondition,
                          IterationTerminationCondition)


class TerminationReason(enum.Enum):
    ERROR = "error"
    ITERATION_TERMINATION = "iteration_termination"
    EPOCH_TERMINATION = "epoch_termination"


@dataclass
class EarlyStoppingConfiguration:
    """Builder-style config (reference EarlyStoppingConfiguration.Builder).

    `score_calculator(model) -> float` runs at the end of each epoch
    (reference ScoreCalculator SPI, e.g. DataSetLossCalculator); lower is
    better, matching the reference's convention."""

    saver: EarlyStoppingModelSaver = field(default_factory=InMemoryModelSaver)
    epoch_termination_conditions: List[EpochTerminationCondition] = \
        field(default_factory=list)
    iteration_termination_conditions: List[IterationTerminationCondition] = \
        field(default_factory=list)
    score_calculator: Optional[Callable] = None
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False

    @staticmethod
    def builder() -> "EarlyStoppingConfigurationBuilder":
        return EarlyStoppingConfigurationBuilder()


class EarlyStoppingConfigurationBuilder:
    def __init__(self):
        self._conf = EarlyStoppingConfiguration()

    def model_saver(self, saver):
        self._conf.saver = saver
        return self

    def epoch_termination_conditions(self, *conds):
        self._conf.epoch_termination_conditions = list(conds)
        return self

    def iteration_termination_conditions(self, *conds):
        self._conf.iteration_termination_conditions = list(conds)
        return self

    def score_calculator(self, fn):
        self._conf.score_calculator = fn
        return self

    def evaluate_every_n_epochs(self, n: int):
        self._conf.evaluate_every_n_epochs = int(n)
        return self

    def save_last_model(self, b: bool = True):
        self._conf.save_last_model = bool(b)
        return self

    def build(self) -> EarlyStoppingConfiguration:
        import dataclasses
        # Snapshot: further builder mutation must not affect built configs.
        return dataclasses.replace(
            self._conf,
            epoch_termination_conditions=list(
                self._conf.epoch_termination_conditions),
            iteration_termination_conditions=list(
                self._conf.iteration_termination_conditions))


@dataclass
class EarlyStoppingResult:
    """Reference EarlyStoppingResult: why training stopped + best model."""

    termination_reason: TerminationReason
    termination_details: str
    score_vs_epoch: dict
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: object
