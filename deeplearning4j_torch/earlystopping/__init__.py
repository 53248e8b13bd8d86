"""Early stopping (reference deeplearning4j-nn earlystopping/ package); the
torch package's port of `deeplearning4j_tpu/earlystopping/`.

Components mirrored: EarlyStoppingConfiguration (builder),
termination conditions (earlystopping/termination/: MaxEpochs, MaxTime,
MaxScore, ScoreImprovementEpochs, BestScore, InvalidScore), model savers
(earlystopping/saver/: InMemory, LocalFile), trainer over
BaseEarlyStoppingTrainer with per-epoch evaluation of a score calculator,
and EarlyStoppingResult with termination reason/details.
"""
from .config import (EarlyStoppingConfiguration, EarlyStoppingResult,
                     TerminationReason)
from .savers import InMemoryModelSaver, LocalFileModelSaver
from .termination import (BestScoreEpochTerminationCondition,
                          InvalidScoreIterationTerminationCondition,
                          MaxEpochsTerminationCondition,
                          MaxScoreIterationTerminationCondition,
                          MaxTimeIterationTerminationCondition,
                          ScoreImprovementEpochTerminationCondition)
from .trainer import (EarlyStoppingGraphTrainer, EarlyStoppingParallelTrainer,
                      EarlyStoppingTrainer)
