"""Termination conditions (reference earlystopping/termination/*.java); the
torch package's own copy of `deeplearning4j_tpu/earlystopping/termination.py`."""
from __future__ import annotations

import math
import time


class EpochTerminationCondition:
    """Checked at the end of every epoch."""

    def initialize(self):
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    """Checked after every minibatch."""

    def initialize(self):
        pass

    def terminate(self, score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = int(max_epochs)

    def terminate(self, epoch, score):
        return epoch >= self.max_epochs

    def __str__(self):
        return f"MaxEpochs({self.max_epochs})"


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop when no score improvement for N epochs (reference
    ScoreImprovementEpochTerminationCondition, with minImprovement)."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = int(max_epochs_without_improvement)
        self.min_improvement = float(min_improvement)
        self.best = None
        self.since_best = 0

    def initialize(self):
        self.best = None
        self.since_best = 0

    def terminate(self, epoch, score):
        if self.best is None or self.best - score > self.min_improvement:
            self.best = score
            self.since_best = 0
            return False
        self.since_best += 1
        # Exactly N epochs without improvement terminates (reference
        # ScoreImprovementEpochTerminationCondition.java semantics).
        return self.since_best >= self.patience

    def __str__(self):
        return f"ScoreImprovement(patience={self.patience})"


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score is at least as good as a target (reference
    BestScoreEpochTerminationCondition)."""

    def __init__(self, best_expected_score: float):
        self.target = float(best_expected_score)

    def terminate(self, epoch, score):
        return score <= self.target

    def __str__(self):
        return f"BestScore({self.target})"


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = float(max_seconds)
        self._start = None

    def initialize(self):
        self._start = time.monotonic()

    def terminate(self, score):
        return (time.monotonic() - self._start) > self.max_seconds

    def __str__(self):
        return f"MaxTime({self.max_seconds}s)"


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Terminate if the score exceeds a cap (diverging run)."""

    def __init__(self, max_score: float):
        self.max_score = float(max_score)

    def terminate(self, score):
        return score > self.max_score

    def __str__(self):
        return f"MaxScore({self.max_score})"


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    def terminate(self, score):
        return math.isnan(score) or math.isinf(score)

    def __str__(self):
        return "InvalidScore()"
