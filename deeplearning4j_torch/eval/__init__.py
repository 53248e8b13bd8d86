"""Evaluation (reference org.deeplearning4j.eval, SURVEY.md §2.1)."""
from .evaluation import Evaluation, EvaluationBinary, RegressionEvaluation
from .roc import ROC, ROCBinary, ROCMultiClass
