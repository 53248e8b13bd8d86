"""Batched inference (the serving slice of the JAX package's parallel/)."""
from .inference import (BatchExecutionError, DeadlineExceededError,
                        InferenceMode, NonFiniteOutputError,
                        ParallelInference, QueueFullError, ServerClosedError)
