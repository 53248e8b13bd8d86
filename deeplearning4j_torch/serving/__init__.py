"""Serving: the single-replica serving plane of the JAX package's serving/,
ported. The gateway control plane (continuous batching, SLO shedding,
per-model circuit breakers, checkpoint-gated hot swap with a canary gate,
priority-tier WFQ scheduling across co-resident models and fused
cross-model batching) on the stdlib HTTP core of utils/http_server.py; the
replica federation (`federation`: several gateway processes behind one
routing front end, with membership on the heartbeat plane, least-loaded
dispatch, exactly-once failover and rolling swaps); the
per-request flight recorder (`flight_recorder`: phase-attributed tail
latency, slow-request exemplars, GET /debug/requests and /trace); the
serving control loop (`autotuner`: windowed SLO verdicts and the auditable
hill-climbing AutoTuner behind GET /debug/tuner); and the autoregressive
decode plane (`decode`: token-granularity continuous batching over a paged
KV cache, POST /generate); and the k-NN and Keras-backend REST facades
(`nearest_neighbor`: brute-force top-k on the device or a VPTree on the
host, POST /knn; `keras_server`: import a Keras .h5, train it on the
device, predict through its handle)."""
from . import autotuner, decode, federation, flight_recorder
from .autotuner import AutoTuner, Knob, SLOMonitor
from .breaker import BreakerOpenError, CircuitBreaker
from .decode import (DecodeEngine, PagedKVCache, RecurrentAdapter,
                     TransformerAdapter, TransformerDecoder, naive_generate,
                     register_metrics)
from .federation import (FederationFrontEnd, ReplicaLostError, ReplicaServer,
                         serve_replica, spawn_replica)
from .flight_recorder import RequestTrace
from .gateway import ServingGateway
from .keras_server import KerasBackendServer
from .model_pool import FusedModelGroup, ModelEntry, ModelPool, SwapError
from .nearest_neighbor import NearestNeighbor, NearestNeighborsServer
from .scheduler import DeviceScheduler, TierShedError
