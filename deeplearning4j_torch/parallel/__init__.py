"""Parallelism: device meshes, data-parallel training (sync and local SGD),
tensor, sequence (ring attention) and pipeline parallelism, the
asynchronous parameter server, the multi-process runner with its cluster
health plane, and batched inference. Ports the JAX package's parallel/."""
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
from .pipeline import PipelineParallelWrapper, pipeline_mesh
from .sequence import SequenceParallelWrapper, seq_parallel_mesh
from .tensor import TensorParallelWrapper, tensor_parallel_mesh
from .wrapper import ParallelWrapper
