"""Runtime lock-order recorder: confirm (or refute) the static graph.

Port of `deeplearning4j_tpu/analysis/lockcheck.py`, whole.

Static analysis (JL402) can only see the acquisition orders spelled in
the source; this shim observes the orders that actually happen under
test. :func:`recording` patches ``threading.Lock``/``RLock`` factories
so every lock constructed inside the block is a :class:`LockProxy` that
records, per acquisition, which other proxied locks the acquiring
thread already holds — building the *observed* acquisition-order graph
as ``(held, acquired)`` edges.

Identities default to ``lock-<n>`` in construction order; call
:func:`adopt` on an object after construction to rename its lock
attributes to ``"ClassName.attr"`` — the same identity scheme JL402's
static graph uses, which is what makes :func:`cross_check` a direct
set comparison:

* a *static* edge never observed at runtime is merely untested;
* an *observed* edge absent from the static graph means the analyzer's
  one-level callee expansion missed an acquisition path — worth a look;
* a cycle in the observed graph is a real deadlock ordering that
  actually executed, not a may-alias guess.

Typical use in a test::

    with lockcheck.recording():
        srv = ParallelInference(model)          # locks become proxies
        lockcheck.adopt(srv)                    # name them Cls.attr
        srv.output(x); srv.shutdown()
    edges = lockcheck.observed_edges()
    static = rules.lock_edges_from_source(open(srv_file).read())
    report = lockcheck.cross_check(edges, static)
    assert not report.cycles

Everything here is plain threading bookkeeping, no device work.
:func:`recording` restores the real factories in a ``finally``: test
workers share one interpreter between files.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Set, Tuple

from .rules import find_cycles

#: observed edges: (held_identity, acquired_identity) -> times seen
_edges: Dict[Tuple[str, str], int] = {}
_edges_lock = threading.Lock()

#: per-thread stack of currently-held proxy identities
_held = threading.local()

_counter = 0
_counter_lock = threading.Lock()


def _next_name(kind: str) -> str:
    global _counter
    with _counter_lock:
        _counter += 1
        return f"{kind}-{_counter}"


def _held_stack() -> List[str]:
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = _held.stack = []
    return stack


def reset() -> None:
    """Clear the observed graph (not the identity counter — proxy names
    stay unique across resets within one process)."""
    with _edges_lock:
        _edges.clear()


def observed_edges() -> Dict[Tuple[str, str], int]:
    """Snapshot of the observed acquisition-order graph."""
    with _edges_lock:
        return dict(_edges)


class LockProxy:
    """Order-recording wrapper around a real ``threading`` lock.

    Behaves like the lock it wraps (``acquire``/``release``/context
    manager/``locked``); on every successful acquire it records an edge
    from each lock the thread already holds to this one.
    """

    def __init__(self, inner, name: str):
        self._inner = inner
        self.lockcheck_name = name

    def _record_acquire(self) -> None:
        stack = _held_stack()
        me = self.lockcheck_name
        with _edges_lock:
            for held in stack:
                if held != me:  # RLock re-entry is not an ordering edge
                    key = (held, me)
                    _edges[key] = _edges.get(key, 0) + 1
        stack.append(me)

    def _record_release(self) -> None:
        stack = _held_stack()
        # release order need not be LIFO; drop the most recent entry
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == self.lockcheck_name:
                del stack[i]
                break

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._record_acquire()
        return got

    def release(self):
        self._inner.release()
        self._record_release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __repr__(self):
        return f"LockProxy({self.lockcheck_name!r})"

    def __getattr__(self, name):
        return getattr(self._inner, name)


@contextmanager
def recording():
    """Patch ``threading.Lock``/``RLock`` so locks constructed inside
    the block are :class:`LockProxy` instances, and clear the observed
    graph. Locks constructed before/after the block are untouched (and
    invisible to the recorder)."""
    real_lock, real_rlock = threading.Lock, threading.RLock

    def make_lock():
        return LockProxy(real_lock(), _next_name("lock"))

    def make_rlock():
        return LockProxy(real_rlock(), _next_name("rlock"))

    reset()
    threading.Lock = make_lock  # type: ignore[assignment]
    threading.RLock = make_rlock  # type: ignore[assignment]
    try:
        yield
    finally:
        threading.Lock, threading.RLock = real_lock, real_rlock


def instrument(obj, cls_name: str = "") -> List[str]:
    """Wrap an EXISTING object's plain ``threading.Lock``/``RLock``
    attributes in :class:`LockProxy`, named ``"ClassName.attr"``.

    The post-construction alternative to :func:`recording` for objects
    whose module was imported long before the test ran — no import
    machinery involved. Only bare lock types are wrapped (Condition /
    Semaphore / Event have their own wait protocols and are left
    alone). Returns the instrumented identities. Call before the
    object's threads start, for the same reason as :func:`adopt`.
    """
    lock_type = type(threading.Lock())
    rlock_type = type(threading.RLock())
    cls_name = cls_name or type(obj).__name__
    adopted: List[str] = []
    for attr, value in sorted(vars(obj).items()):
        if isinstance(value, (lock_type, rlock_type)):
            proxy = LockProxy(value, f"{cls_name}.{attr}")
            setattr(obj, attr, proxy)
            adopted.append(proxy.lockcheck_name)
    return adopted


def adopt(obj, cls_name: str = "") -> List[str]:
    """Rename ``obj``'s :class:`LockProxy` attributes to the static
    identity scheme ``"ClassName.attr"`` (JL402 uses the *defining*
    class's name for ``self.x`` locks). Returns the adopted identities.

    Call right after construction, before the object's threads run —
    edges recorded under the old ``lock-<n>`` names are not rewritten.
    """
    cls_name = cls_name or type(obj).__name__
    adopted: List[str] = []
    for attr, value in sorted(vars(obj).items()):
        if isinstance(value, LockProxy):
            value.lockcheck_name = f"{cls_name}.{attr}"
            adopted.append(value.lockcheck_name)
    return adopted


@dataclass
class CrossCheck:
    """Observed-vs-static comparison (:func:`cross_check`)."""
    #: runtime edges the static graph also derived — confirmed orderings
    confirmed: Set[Tuple[str, str]] = field(default_factory=set)
    #: runtime edges the static walker never derived — analysis gaps
    unexplained: Set[Tuple[str, str]] = field(default_factory=set)
    #: static edges never exercised at runtime — untested orderings
    unexercised: Set[Tuple[str, str]] = field(default_factory=set)
    #: cycles in the union graph (observed ∪ static): an ordering that
    #: can deadlock, proven at least partly by execution
    cycles: List[List[str]] = field(default_factory=list)

    def ok(self) -> bool:
        return not self.cycles


def cross_check(observed: Dict[Tuple[str, str], int],
                static_edges: Iterable[Tuple[str, str]]) -> CrossCheck:
    """Compare an observed graph against JL402's static edges.

    ``static_edges`` accepts the ``lock_edges_from_source`` dict (keys
    are the edges) or any iterable of ``(held, acquired)`` pairs. Only
    identities present in BOTH graphs participate in the unexplained /
    unexercised sets — a runtime edge between locks the static pass
    never named (e.g. un-adopted ``lock-<n>`` proxies) is noise, not an
    analysis gap.
    """
    obs = set(observed)
    stat = set(static_edges)
    stat_names = {n for e in stat for n in e}
    obs_names = {n for e in obs for n in e}
    both = stat_names & obs_names
    result = CrossCheck()
    result.confirmed = obs & stat
    result.unexplained = {e for e in obs - stat
                          if e[0] in both and e[1] in both}
    result.unexercised = {e for e in stat - obs
                          if e[0] in both and e[1] in both}
    result.cycles = [c for c in find_cycles(obs | stat) if len(c) >= 2]
    return result
