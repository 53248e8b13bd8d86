"""Serving: the decode plane of the JAX package's serving/ (serving/decode.py:
token-granularity continuous batching over a paged KV cache, with a
transformer and a recurrent adapter). The gateway, model pool, scheduler,
breaker and flight recorder are not ported yet."""
from . import decode
from .decode import (DecodeEngine, PagedKVCache, RecurrentAdapter,
                     TransformerAdapter, TransformerDecoder, naive_generate,
                     register_metrics)
