"""Parallelism: device meshes, data-parallel training (sync and local SGD),
the asynchronous parameter server, the multi-process runner with its
cluster health plane, and batched inference.

Ports the JAX package's parallel/ but its pipeline, tensor and sequence
wrappers (PipelineParallelWrapper, TensorParallelWrapper,
SequenceParallelWrapper and their meshes), which are still to come."""
from .cluster_health import (BarrierTimeoutError, ClusterDesyncError,
                             ClusterHealthError, ClusterHealthMonitor,
                             GraceCheckpointed, HealthConfig, PeerLostError,
                             timed_collective)
from .inference import (BatchExecutionError, DeadlineExceededError,
                        DecodeStepError, InferenceMode, KVCacheExhaustedError,
                        NonFiniteOutputError, ParallelInference, QueueFullError,
                        ServerClosedError)
from .mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, batch_sharded,
                   create_mesh, data_parallel_mesh, replicate, replicated,
                   shard_batch)
from .multihost import (CheckpointManager, MultiHostRunner,
                        StepCheckpointManager)
from .param_server import (HttpParameterServerClient, ParameterServer,
                           ParameterServerHttpNode, ParameterServerTrainer,
                           remote_worker_fit)
from .wrapper import ParallelWrapper
