"""Batched inference (the serving slice of the JAX package's parallel/)."""
from .inference import (BatchExecutionError, DeadlineExceededError,
                        DecodeStepError, InferenceMode, KVCacheExhaustedError,
                        NonFiniteOutputError, ParallelInference, QueueFullError,
                        ServerClosedError)
