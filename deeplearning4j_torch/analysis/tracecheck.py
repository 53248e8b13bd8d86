"""Runtime host-sync checker: count implicit device->host syncs.

Port of `deeplearning4j_tpu/analysis/tracecheck.py`. Static analysis
(JL1xx) can only *suspect* a hidden sync; this shim confirms it live.
:func:`watch` wraps a value (typically a network's output) in a
:class:`SyncSpy` that behaves like the underlying tensor but increments
``host_syncs_total{site}`` in the port's MetricsRegistry every time host
Python implicitly forces a transfer: ``float()``, ``int()``, ``bool()``,
``__index__``, ``np.asarray()`` (via ``__array__``), ``.item()``,
``.tolist()``, as the JAX shim counts them, and torch's own copies to the
host, ``.cpu()``, ``.numpy()`` and ``.to()`` onto the CPU. Each counts
whatever device the tensor is on, as the JAX shim counts on any backend.

Handing the spy back INTO torch is free, as ``__jax_array__`` makes it in
the JAX package: a :class:`SyncSpy` is a ``torch.Tensor`` subclass whose
``__torch_function__`` unwraps every spy and runs the function on the
plain tensors, so ``net.output(watch(x))`` does not count itself, and what
it returns is a plain tensor (wrap it again with :func:`watch` to keep
tracking).

Deliberate reads go through :func:`fenced_read`, which synchronizes the
tensor's stream once and copies without counting: the "I meant to pay this
cost, once, here" spelling the JL101 fix hint points at.

A spy sees only the values it wraps. On the card, :func:`sync_debug` is the
device's own count: it sets ``torch.cuda.set_sync_debug_mode`` for the
enclosed code and tallies the warnings torch raises at each synchronizing
CUDA operation, by call site, whatever value caused it.

Typical use in a step loop under test::

    out = watch(net.output(x), site="serve.out")
    ...
    assert sync_count("serve.out") == 0      # nothing implicitly synced
    y = fenced_read(out)                      # explicit, uncounted
    with sync_debug("warn") as seen:
        net.fit(ds)
    seen                                      # Counter({"file.py:123": n, ...})
"""
from __future__ import annotations

import warnings
from collections import Counter
from contextlib import contextmanager
from typing import Any, Callable, Optional

import numpy as np
import torch

METRIC_NAME = "host_syncs_total"

#: the text of the warning torch raises at a synchronizing CUDA operation
#: under ``torch.cuda.set_sync_debug_mode("warn")``
SYNC_WARNING = "called a synchronizing CUDA operation"

try:
    from ..optimize.metrics import registry as _registry
except Exception:  # pragma: no cover - analysis must import standalone
    _registry = None

# Fallback tally used when the metrics registry is unavailable; also
# mirrored unconditionally so tests can reset it cheaply.
_local_counts: dict = {}


def _count(site: str) -> None:
    _local_counts[site] = _local_counts.get(site, 0) + 1
    if _registry is not None:
        try:
            _registry().counter(
                METRIC_NAME,
                "implicit device->host syncs observed by tracecheck",
            ).labels(site=site).inc()
        except Exception:  # registry misconfiguration must not break math
            pass


def sync_count(site: Optional[str] = None) -> int:
    """Observed implicit syncs (one site, or all sites when None)."""
    if site is not None:
        return _local_counts.get(site, 0)
    return sum(_local_counts.values())


def reset_counts() -> None:
    _local_counts.clear()


_T = torch.Tensor
#: the Tensor methods that read the value to the host, whatever the device
_COUNTED = {_T.__float__, _T.__int__, _T.__bool__, _T.__index__,
            _T.__array__, _T.item, _T.tolist, _T.cpu, _T.numpy}


def _is_cpu(target) -> bool:
    if isinstance(target, (str, torch.device)):
        return torch.device(target).type == "cpu"
    if isinstance(target, torch.Tensor):
        return target.device.type == "cpu"
    return False


def _to_host(args, kwargs) -> bool:
    """Whether a ``Tensor.to(...)`` call moves its tensor onto the CPU."""
    return _is_cpu(kwargs.get("device")) or any(_is_cpu(a) for a in args[1:])


def _unwrap(value):
    if isinstance(value, SyncSpy):
        return value._value
    if isinstance(value, (list, tuple)):
        return type(value)(_unwrap(v) for v in value)
    if isinstance(value, dict):
        return {k: _unwrap(v) for k, v in value.items()}
    return value


class SyncSpy(torch.Tensor):
    """Tensor proxy that counts implicit host syncs.

    Arithmetic, attributes (``shape``, ``dtype``...), indexing and torch
    re-entry all pass through uncounted and return plain tensors; only the
    operations that force a device->host transfer count.
    """

    @staticmethod
    def __new__(cls, value: torch.Tensor, site: str = "default"):
        spy = torch.Tensor._make_subclass(cls, value.detach(), False)
        spy._value = value
        spy._site = site
        return spy

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if args and isinstance(args[0], SyncSpy) and (
                func in _COUNTED or (func is _T.to and _to_host(args, kwargs))):
            _count(args[0]._site)
        return func(*_unwrap(args), **_unwrap(kwargs))

    def __repr__(self):
        return f"SyncSpy({self._value!r}, site={self._site!r})"

    def unwrap(self) -> torch.Tensor:
        return self._value


def watch(value: Any, site: str = "default") -> Any:
    """Wrap every tensor leaf of ``value`` in a :class:`SyncSpy`.

    Scalars/strings/None pass through untouched; dicts, lists and tuples
    are walked leaf-wise, so a whole output tree can be watched in one
    call.
    """
    if isinstance(value, SyncSpy):
        return SyncSpy(value._value, site)
    if isinstance(value, torch.Tensor):
        return SyncSpy(value, site)
    if isinstance(value, dict):
        return {k: watch(v, site) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        out = [watch(v, site) for v in value]
        return type(value)(*out) if hasattr(value, "_fields") else \
            type(value)(out)
    return value


def wrap(fn: Callable, site: Optional[str] = None) -> Callable:
    """Decorator: watch the outputs of ``fn`` under ``site`` (defaults
    to the function's qualified name)."""
    label = site or getattr(fn, "__qualname__", getattr(
        fn, "__name__", "wrapped"))

    def inner(*args, **kwargs):
        return watch(fn(*args, **kwargs), site=label)

    inner.__name__ = getattr(fn, "__name__", "wrapped")
    inner.__qualname__ = f"tracecheck[{label}]"
    inner.__wrapped__ = fn
    return inner


@contextmanager
def _sync_debug_off(device: torch.device):
    """No sync-debug warning for the enclosed copy (a deliberate read)."""
    if device.type != "cuda":
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def fenced_read(value: Any):
    """Deliberate, uncounted device->host read: fence then copy.

    Accepts a raw tensor or a :class:`SyncSpy`; synchronizes the tensor's
    stream once and returns a numpy array (0-d for a scalar; bfloat16 and
    float16 come back as float32, which numpy holds exactly)."""
    if isinstance(value, SyncSpy):
        value = value.unwrap()
    if not isinstance(value, torch.Tensor):
        return np.asarray(value)
    t = value.detach()
    with _sync_debug_off(t.device):
        if t.device.type == "cuda":
            torch.cuda.current_stream(t.device).synchronize()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.cpu().numpy()


@contextmanager
def sync_debug(mode="warn"):
    """Run the enclosed code under ``torch.cuda.set_sync_debug_mode(mode)``
    ("warn", "error", or 0-2) and restore the mode after. Yields a
    ``Counter`` of call site (``file:line``) -> the "called a synchronizing
    CUDA operation" warnings raised there in the block (other warnings are
    re-issued; a read forced through a spy is tallied at the spy's
    ``__torch_function__`` here, its caller in the spy's own count). Raises
    without a CUDA device: the counts are the card's own."""
    if not torch.cuda.is_available():
        raise RuntimeError("sync_debug counts the CUDA device's synchronizing "
                           "operations; no CUDA device is available")
    seen: Counter = Counter()
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(mode)
        try:
            yield seen
        finally:
            torch.cuda.set_sync_debug_mode(before)
            for w in caught:
                if SYNC_WARNING in str(w.message):
                    seen[f"{w.filename}:{w.lineno}"] += 1
    for w in caught:
        if SYNC_WARNING not in str(w.message):
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
