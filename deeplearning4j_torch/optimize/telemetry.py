"""The shape-churn guard.

Port of the recompile-churn guard of `deeplearning4j_tpu/optimize/
telemetry.py`. A fit loop that keeps feeding a step new shapes pays for
each one: on the card every new input shape makes cuDNN choose its
convolution algorithms again (and, once steps are captured as CUDA graphs,
costs a capture each). The canonical cause is a data pipeline emitting
ragged batches (every epoch tail a new shape) or unbucketed variable-length
sequences. The guard records the distinct shape signatures each logical
step has seen and goes loud, with one warning and a labelled counter, when
a step crosses the threshold.

The networks note their steps under the JAX package's labels
(`mln_train_step#<tag>`, `mln_output#<tag>`, `graph_train_step#<tag>`,
`graph_output#<tag>`, the tag being ``id(net) & 0xffff`` as four hex
digits), and the counter keeps the JAX package's name,
``recompile_churn_total{fn=<label>}``, so dashboards read both packages
alike. The threshold comes from ``DL4JTORCH_RECOMPILE_CHURN_THRESHOLD``.

The XLA compile counter and `jit_cache_size` of the JAX module have no
meaning in eager torch and are not ported.
"""
from __future__ import annotations

import logging
import os
import threading

log = logging.getLogger(__name__)

ENV_CHURN_THRESHOLD = "DL4JTORCH_RECOMPILE_CHURN_THRESHOLD"
DEFAULT_CHURN_THRESHOLD = 5

_churn_lock = threading.Lock()
_step_signatures: dict = {}   # label -> set of signatures
_churn_warned: set = set()    # labels already warned (one-shot)


def churn_threshold() -> int:
    try:
        return int(os.environ.get(ENV_CHURN_THRESHOLD,
                                  DEFAULT_CHURN_THRESHOLD))
    except ValueError:
        return DEFAULT_CHURN_THRESHOLD


def probe_tag(net) -> str:
    """The label suffix of one network: ``id(net) & 0xffff`` as four hex
    digits, as the JAX package tags its steps."""
    return f"{id(net) & 0xffff:04x}"


def _dtype_name(dtype) -> str:
    # torch spells float32 "torch.float32", numpy and jax "float32": one
    # spelling, so equal arrays give equal signatures in both packages
    return str(dtype).replace("torch.", "", 1)


def shape_signature(*args) -> tuple:
    """Cheap hashable signature of a call's data arguments: per-arg
    (shape, dtype) with None passing through. Metadata only: it never reads
    a tensor's data, so it never waits for the device."""
    sig = []
    for a in args:
        if a is None:
            sig.append(None)
        else:
            sig.append((tuple(getattr(a, "shape", ())),
                        _dtype_name(getattr(a, "dtype", ""))))
    return tuple(sig)


def note_step_signature(label: str, sig: tuple) -> int:
    """Record one call signature for a logical step; returns the number of
    distinct signatures seen. Crossing the threshold fires ONE loud warning
    per label and bumps `recompile_churn_total{fn=label}` for every new
    signature past it."""
    with _churn_lock:
        seen = _step_signatures.setdefault(label, set())
        if sig in seen:
            return len(seen)
        seen.add(sig)
        n = len(seen)
        over = n > churn_threshold()
        warn = over and label not in _churn_warned
        if warn:
            _churn_warned.add(label)
    if over:
        from .metrics import registry
        registry().counter(
            "recompile_churn_total",
            "Distinct call signatures past the churn threshold; on the "
            "card each one made cuDNN choose its algorithms again"
            ).labels(fn=label).inc()
    if warn:
        log.warning(
            "SHAPE CHURN: %s has now been called with %d distinct shape "
            "signatures (threshold %d); on the GPU every new shape costs a "
            "cuDNN algorithm choice (and a CUDA graph capture where steps "
            "are captured). Bucket or pad your batches (pad_to_bucket=True)",
            label, n, churn_threshold())
    return n


def churn_offenders(top: int = 5):
    """Worst logical steps by distinct-signature count:
    [(label, n_signatures), ...] sorted descending."""
    with _churn_lock:
        items = [(lbl, len(sigs)) for lbl, sigs in _step_signatures.items()]
    items.sort(key=lambda kv: (-kv[1], kv[0]))
    return items[:max(0, int(top))]


def reset_churn() -> None:
    """Forget recorded signatures and re-arm the one-shot warnings (test
    isolation)."""
    with _churn_lock:
        _step_signatures.clear()
        _churn_warned.clear()
