"""The rules of the port's analyzer.

Port of the JL1xx, JL4xx and JL5xx families of
`deeplearning4j_tpu/analysis/rules.py`, held to it finding for finding on
the JAX package's tree. Each rule is a :class:`Rule` with a stable id, a
severity, a one-line fix hint, and a ``check(ctx)`` generator yielding
``(node, message)`` pairs. The engine turns those into findings, applies
``# jaxlint: disable=RULE`` suppressions (the JAX analyzer's syntax, so one
comment silences both), and matches them against the baseline.

Rule families
-------------
* JL1xx  hidden host syncs: implicit device->host transfers inside hot
  paths (``fit`` / step loops / listener callbacks) that stall the host's
  run-ahead of the device. JL101 ``float()``/``int()``/``bool()`` of a
  value, JL102 ``.item()``/``.tolist()`` and torch's ``.cpu()``/``.numpy()``,
  JL103 ``np.asarray``/``np.array``/``jax.device_get`` and torch's
  ``.to("cpu")``. Only the torch spellings can find more than the JAX
  analyzer does on the same tree.
* JL4xx  lock discipline in threaded subsystems (RacerD-style
  consistent-guard checking): JL401 consistent guards over thread entry
  points, JL402 lock-acquisition-order cycles (potential deadlocks), JL403
  blocking calls under a held lock, JL404 field-level atomicity (shared
  attributes written under a lock but read or read-modify-written outside
  it). JL403 counts a host fence as blocking: the JAX package's
  ``.block_until_ready()``, and the port's ``torch.cuda.synchronize()`` and
  ``.synchronize()`` on a stream or an event, each of which waits for the
  device.
* JL5xx  serving discipline: JL501 typed-error taxonomy at HTTP route
  handlers, JL502 metrics-family discipline (hot-path construction,
  unbounded label cardinality, serving families that no
  ``register*metrics`` function pre-registers), JL503 fault-point coverage
  (every ``faults.fire`` literal must be armed by a port test,
  ``tests/test_torch_*.py``, and listed in the table of points of the
  package's own ``utils/faults.py`` docstring).

Hotness is lexical: a function is *hot* if its name looks like a
training/step/iterator path (or a listener callback), or if it is nested
inside one.

The trace-purity, recompile and donation rules (JL0xx, JL2xx, JL301) and
the JAX package's jit-boundary inference (``boundaries.py``) check jit
tracing, and have no meaning in eager torch, which traces nothing and
donates nothing.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Set, Tuple

# --------------------------------------------------------------------------
# shared vocabularies
# --------------------------------------------------------------------------

#: function names considered hot paths for the host-sync rules
HOT_NAME_RE = re.compile(
    r"(^|_)(fit|train|step|batch|epoch|iterate|forward|backward|update|"
    r"pump|producer|consumer|worker|prefetch)($|_)|"
    r"^(__next__|__iter__)$")

#: listener / callback entry points whose whole body is per-step hot
CALLBACK_NAMES = {
    "iteration_done", "on_epoch_start", "on_epoch_end",
    "on_forward_pass", "on_backward_pass", "on_gradient_calculation",
    "epoch_done",
}

#: loop-index-ish receivers that float()/int() legitimately touches
_INDEXY = {
    "iteration", "epoch", "i", "j", "k", "idx", "n", "step", "step_num",
    "num_examples", "count", "batch_size", "num_batches", "total",
    "iteration_count", "epoch_count", "seed", "size", "length",
}

_LOCKISH = re.compile(r"lock|mutex|cond|(^|_)cv($|_)|sem", re.IGNORECASE)

_SYNC_PRIMITIVE_CTORS = {"Lock", "RLock", "Condition", "Event", "Semaphore",
                         "BoundedSemaphore", "Barrier", "Queue", "LifoQueue",
                         "PriorityQueue", "SimpleQueue", "deque"}


@dataclass(frozen=True)
class Rule:
    id: str
    severity: str          # error | warning | info
    title: str
    hint: str
    check: Callable[["object"], Iterator[Tuple[ast.AST, str]]]

    def describe(self) -> dict:
        return {"id": self.id, "severity": self.severity,
                "title": self.title, "hint": self.hint}


def _name_of(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


def _is_self_attr(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self")


def _walk_no_nested(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body without descending into nested defs/classes
    (their hotness / reachability is judged separately)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))



# --------------------------------------------------------------------------
# JL1xx — hidden host syncs (hot paths)
# --------------------------------------------------------------------------

def _indexy(node: ast.AST) -> bool:
    name = _name_of(node)
    return name in _INDEXY or name.endswith(("_count", "_idx", "_index"))


def _in_loop(ctx, node: ast.AST, fn: ast.AST) -> bool:
    cur = ctx.parent(node)
    while cur is not None and cur is not fn:
        if isinstance(cur, (ast.For, ast.While, ast.AsyncFor, ast.ListComp,
                            ast.SetComp, ast.DictComp, ast.GeneratorExp)):
            return True
        cur = ctx.parent(cur)
    return False


def _hot_sites(ctx, fn) -> Iterator[ast.AST]:
    """Per-step-hot nodes in a hot function: the whole body of a listener
    callback / ``__next__`` (called once per iteration from outside), or
    nodes under a loop for ordinary fit/step/train functions."""
    whole_body = getattr(fn, "name", "") in CALLBACK_NAMES or \
        getattr(fn, "name", "") in ("__next__",)
    for node in _walk_no_nested(fn):
        if whole_body or _in_loop(ctx, node, fn):
            yield node


#: value-producing calls that read host state, not device buffers
_HOST_VALUE_METHODS = {"get", "pop", "integers", "randint", "choice",
                       "random", "uniform", "normal"}
_HOST_VALUE_FUNCS = {"len", "round", "min", "max", "sum", "abs", "ord",
                     "time", "perf_counter", "monotonic", "getattr"}


def _shape_read(arg: ast.AST) -> bool:
    for sub in ast.walk(arg):
        if isinstance(sub, ast.Attribute) and sub.attr in ("shape", "ndim"):
            return True
        if isinstance(sub, ast.Name) and sub.id == "shape":
            return True
    return False


def _check_host_scalar_sync(ctx):
    for fn in ctx.hot_functions():
        params = {a.arg for a in fn.args.args} if \
            isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) else set()
        for node in _hot_sites(ctx, fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in ("float", "int", "bool")
                    and len(node.args) == 1 and not node.keywords):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) or _indexy(arg):
                continue
            if isinstance(arg, ast.Name) and arg.id in params:
                continue  # coercing a host-side argument, not a device read
            if isinstance(arg, ast.Call) and (
                    _name_of(arg.func) in _HOST_VALUE_FUNCS or
                    (isinstance(arg.func, ast.Attribute)
                     and arg.func.attr in _HOST_VALUE_METHODS)):
                continue
            if isinstance(arg, (ast.BinOp, ast.BoolOp)):
                continue  # arithmetic on host scalars, not a device read
            if _shape_read(arg):
                continue  # shapes are host metadata
            desc = ast.unparse(arg) if hasattr(ast, "unparse") else "value"
            yield node, (f"'{node.func.id}({desc})' in hot path may block "
                         f"on device->host transfer every step")


#: zero-argument methods that read a device value back to the host: the
#: JAX package's two, and torch's copies to the host
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")


def _check_item_sync(ctx):
    for fn in ctx.hot_functions():
        for node in _hot_sites(ctx, fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SYNC_METHODS
                    and not node.args and not node.keywords):
                yield node, (f"'.{node.func.attr}()' in hot path forces a "
                             f"device->host sync every step")


_ASARRAY_CALLS = {"numpy.asarray", "numpy.array", "jax.device_get"}


def _cpu_target(node: ast.AST) -> bool:
    """``"cpu"``, or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call) and _name_of(node.func) == "device"
            and bool(node.args) and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "cpu")


def _to_cpu_call(node: ast.AST) -> bool:
    """``t.to("cpu", ...)``, ``t.to(device="cpu")``,
    ``t.to(torch.device("cpu"))``: torch's copy to the host."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "to"):
        return False
    return (bool(node.args) and _cpu_target(node.args[0])) or any(
        kw.arg == "device" and _cpu_target(kw.value) for kw in node.keywords)


def _check_asarray_sync(ctx):
    for fn in ctx.hot_functions():
        for node in _hot_sites(ctx, fn):
            if isinstance(node, ast.Call):
                d = ctx.dotted(node.func)
                if d in _ASARRAY_CALLS:
                    yield node, (f"'{d}()' in hot path copies device memory "
                                 f"to host; batch or fence it once per step")
                elif _to_cpu_call(node):
                    yield node, ("'.to(\"cpu\")' in hot path copies device "
                                 "memory to host; batch or fence it once per "
                                 "step")


# --------------------------------------------------------------------------
# JL4xx — lock discipline
# --------------------------------------------------------------------------

def _thread_entry_points(cls: ast.ClassDef,
                         methods: Dict[str, ast.FunctionDef]) -> Set[str]:
    entries: Set[str] = set()
    for base in cls.bases:
        if _name_of(base) == "Thread" and "run" in methods:
            entries.add("run")
    for m in methods.values():
        for node in ast.walk(m):
            if not isinstance(node, ast.Call):
                continue
            fname = _name_of(node.func)
            if fname == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target" and _is_self_attr(kw.value) and \
                            kw.value.attr in methods:
                        entries.add(kw.value.attr)
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "submit":
                if node.args and _is_self_attr(node.args[0]) and \
                        node.args[0].attr in methods:
                    entries.add(node.args[0].attr)
    return entries


def _guard_of(ctx, node) -> Optional[str]:
    """Name of the self.<lock-ish> attribute whose ``with`` block encloses
    this node, or None."""
    cur = ctx.parent(node)
    while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        if isinstance(cur, ast.With):
            for item in cur.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call):
                    expr = expr.func
                if _is_self_attr(expr) and _LOCKISH.search(expr.attr):
                    return expr.attr
        cur = ctx.parent(cur)
    return None


def _sync_primitive_attrs(init: Optional[ast.FunctionDef], ctx) -> Set[str]:
    out: Set[str] = set()
    if init is None:
        return out
    for node in ast.walk(init):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            d = (ctx.dotted(node.value.func) or "").split(".")[-1]
            if d in _SYNC_PRIMITIVE_CTORS:
                for tgt in node.targets:
                    if _is_self_attr(tgt):
                        out.add(tgt.attr)
    return out


def _check_lock_discipline(ctx):
    for cls in ctx.classes():
        methods = {n.name: n for n in cls.body
                   if isinstance(n, ast.FunctionDef)}
        entries = _thread_entry_points(cls, methods)
        if not entries:
            continue
        # thread side = entry points + one level of same-class callees
        thread_side: Set[str] = set(entries)
        for name in list(entries):
            fn = methods.get(name)
            if fn is None:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and \
                        _is_self_attr(node.func) and \
                        node.func.attr in methods:
                    thread_side.add(node.func.attr)
        main_side = set(methods) - thread_side - {"__init__"}
        exempt = _sync_primitive_attrs(methods.get("__init__"), ctx)

        def attr_events(names: Set[str], want_store: bool):
            for mname in names:
                fn = methods.get(mname)
                if fn is None:
                    continue
                for node in ast.walk(fn):
                    tgts = []
                    if isinstance(node, ast.Assign):
                        tgts = node.targets
                    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                        tgts = [node.target]
                    if want_store:
                        for t in tgts:
                            sub = [t]
                            if isinstance(t, (ast.Tuple, ast.List)):
                                sub = list(t.elts)
                            for s in sub:
                                if _is_self_attr(s):
                                    yield mname, s.attr, s
                    elif isinstance(node, ast.Attribute) and \
                            _is_self_attr(node) and \
                            isinstance(node.ctx, ast.Load):
                        yield mname, node.attr, node

        thread_writes: Dict[str, List[Tuple[str, ast.AST]]] = {}
        for mname, attr, node in attr_events(thread_side, True):
            thread_writes.setdefault(attr, []).append((mname, node))
        main_touch: Set[str] = set()
        for _, attr, _n in attr_events(main_side, True):
            main_touch.add(attr)
        for _, attr, _n in attr_events(main_side, False):
            main_touch.add(attr)

        for attr, writes in sorted(thread_writes.items()):
            if attr in exempt or attr.startswith("__"):
                continue
            writer_methods = {m for m, _ in writes}
            shared = attr in main_touch or len(writer_methods) > 1
            if not shared:
                continue
            guards = {_guard_of(ctx, node) for _, node in writes}
            # main-side write sites must use the same guard too
            main_writes = [(m, n) for m, a, n in attr_events(main_side, True)
                           if a == attr]
            guards |= {_guard_of(ctx, node) for _, node in main_writes}
            if guards == {None}:
                for mname, node in writes:
                    yield node, (
                        f"'{cls.name}.{attr}' is written from thread entry "
                        f"'{mname}' and shared with other methods, with no "
                        f"lock held at any write site")
            elif None in guards or len(guards - {None}) > 1:
                named = sorted(g for g in guards if g)
                for mname, node in writes + main_writes:
                    if _guard_of(ctx, node) is None or len(named) > 1:
                        yield node, (
                            f"'{cls.name}.{attr}' write in '{mname}' is not "
                            f"consistently guarded (locks seen: "
                            f"{', '.join(named) or 'none'})")


# --------------------------------------------------------------------------
# JL402/JL403 — lock-acquisition graphs and blocking-under-lock
# --------------------------------------------------------------------------

#: primitives that are *acquired* (``with``/``.acquire()``), as opposed to
#: queues/events which only block
_ACQUIRABLE_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
                     "BoundedSemaphore"}


def _module_lock_names(ctx) -> Set[str]:
    out: Set[str] = set()
    for stmt in getattr(ctx.tree, "body", []):
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            d = (ctx.dotted(stmt.value.func) or "").split(".")[-1]
            if d in _ACQUIRABLE_CTORS:
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        out.add(tgt.id)
    return out


def _class_lock_attrs(ctx, methods: Dict[str, ast.FunctionDef]) -> Set[str]:
    """``self.<attr>`` names that hold sync primitives: assigned one in
    ``__init__``, or lock-ish by name anywhere in the class."""
    out = _sync_primitive_attrs(methods.get("__init__"), ctx)
    for fn in methods.values():
        for node in ast.walk(fn):
            if _is_self_attr(node) and _LOCKISH.search(node.attr):
                out.add(node.attr)
    return out


def _lock_identity(ctx, expr, cls_name: str, lock_attrs: Set[str],
                   module_locks: Set[str]) -> Optional[str]:
    """Stable name for a lock object resolved by attribute path:
    ``Cls.attr`` for ``self.<lock>``, a dotted path for other attribute
    chains whose last segment is lock-ish, the bare name for
    module-level locks."""
    if isinstance(expr, ast.Call):
        expr = expr.func
    if _is_self_attr(expr) and (expr.attr in lock_attrs
                                or _LOCKISH.search(expr.attr)):
        return f"{cls_name}.{expr.attr}" if cls_name else f"self.{expr.attr}"
    if isinstance(expr, ast.Name) and (expr.id in module_locks
                                       or _LOCKISH.search(expr.id)):
        return expr.id
    if isinstance(expr, ast.Attribute) and _LOCKISH.search(expr.attr):
        d = ctx.dotted(expr)
        if d:
            return d
    return None


#: functions whose call under a held lock blocks on device/model work
_FORWARDISH = {"output", "predict", "generate", "forward", "_forward"}
#: queue-shaped receiver names for .get()/.put() blocking checks
_QUEUEISH = re.compile(r"queue|(^|_)q($|_)", re.IGNORECASE)
_SOCKETISH_METHODS = {"urlopen", "recv", "recv_into", "sendall",
                      "getresponse", "accept", "makefile"}


class _LockGraph:
    """Held-lock statement walker over one class (or the module's
    top-level functions).

    Records (a) lock-order edges ``A -> B`` (B acquired while A held,
    including one transitive level of same-scope callees) and (b)
    blocking calls made while at least one lock is held."""

    def __init__(self, ctx, cls_name: str,
                 methods: Dict[str, ast.FunctionDef],
                 lock_attrs: Set[str], module_locks: Set[str]):
        self.ctx = ctx
        self.cls_name = cls_name
        self.methods = methods
        self.lock_attrs = lock_attrs
        self.module_locks = module_locks
        self.edges: Dict[Tuple[str, str], ast.AST] = {}
        self.blocking: List[Tuple[ast.AST, str, Tuple[str, ...]]] = []
        self._summaries: Dict[str, Set[str]] = {}

    def lock_of(self, expr) -> Optional[str]:
        return _lock_identity(self.ctx, expr, self.cls_name,
                              self.lock_attrs, self.module_locks)

    def walk(self) -> "_LockGraph":
        for _name, fn in sorted(self.methods.items()):
            self._stmts(fn.body, [])
        return self

    # -- one-level callee summaries ---------------------------------------
    def summary(self, name: str) -> Set[str]:
        """Locks a callee acquires anywhere in its own body (memoised;
        the one transitive level of the inter-procedural graph)."""
        if name in self._summaries:
            return self._summaries[name]
        self._summaries[name] = set()          # recursion guard
        acquired: Set[str] = set()
        fn = self.methods.get(name)
        if fn is not None:
            for node in _walk_no_nested(fn):
                if isinstance(node, ast.With):
                    for item in node.items:
                        lk = self.lock_of(item.context_expr)
                        if lk:
                            acquired.add(lk)
                elif isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "acquire":
                    lk = self.lock_of(node.func.value)
                    if lk:
                        acquired.add(lk)
        self._summaries[name] = acquired
        return acquired

    # -- walking ----------------------------------------------------------
    def _record(self, held: List[str], lock: str, node: ast.AST) -> None:
        for h in held:
            if h != lock:
                self.edges.setdefault((h, lock), node)

    def _stmts(self, body: List[ast.stmt], held: List[str]) -> None:
        for stmt in body:
            self._scan_exprs(stmt, held)
            if isinstance(stmt, ast.With):
                acquired: List[str] = []
                for item in stmt.items:
                    lk = self.lock_of(item.context_expr)
                    if lk:
                        self._record(held, lk, item.context_expr)
                        acquired.append(lk)
                self._stmts(stmt.body, held + acquired)
            elif isinstance(stmt, ast.If):
                self._stmts(stmt.body, list(held))
                self._stmts(stmt.orelse, list(held))
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                self._stmts(stmt.body, list(held))
                self._stmts(stmt.orelse, list(held))
            elif isinstance(stmt, ast.Try):
                self._stmts(stmt.body, list(held))
                for handler in stmt.handlers:
                    self._stmts(handler.body, list(held))
                self._stmts(stmt.orelse, list(held))
                self._stmts(stmt.finalbody, list(held))
            elif isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                           ast.Call):
                # sequential .acquire()/.release() at this nesting level
                call = stmt.value
                if isinstance(call.func, ast.Attribute):
                    lk = self.lock_of(call.func.value)
                    if lk and call.func.attr == "acquire":
                        self._record(held, lk, call)
                        held.append(lk)
                    elif lk and call.func.attr == "release" and lk in held:
                        held.remove(lk)

    def _scan_exprs(self, stmt: ast.stmt, held: List[str]) -> None:
        """Calls in this statement's own expressions (tests, values,
        arguments) — child statements are handled by :meth:`_stmts`."""
        stack = [c for c in ast.iter_child_nodes(stmt)
                 if not isinstance(c, ast.stmt)]
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef, ast.stmt)):
                continue
            if isinstance(node, ast.Call):
                self._call(node, held)
            stack.extend(ast.iter_child_nodes(node))

    def _call(self, call: ast.Call, held: List[str]) -> None:
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr == "acquire":
            lk = self.lock_of(func.value)
            if lk:
                self._record(held, lk, call)
            return
        # one transitive callee level: locks the callee itself acquires
        callee = None
        if _is_self_attr(func) and func.attr in self.methods:
            callee = func.attr
        elif isinstance(func, ast.Name) and func.id in self.methods:
            callee = func.id
        if callee is not None and held:
            for lk in sorted(self.summary(callee)):
                self._record(held, lk, call)
        if held:
            reason = self._blocking_reason(call, held)
            if reason:
                self.blocking.append((call, reason, tuple(held)))

    def _blocking_reason(self, call: ast.Call,
                         held: List[str]) -> Optional[str]:
        func = call.func
        attr = func.attr if isinstance(func, ast.Attribute) else ""
        d = self.ctx.dotted(func) or ""
        kwnames = {kw.arg for kw in call.keywords}
        if d == "time.sleep":
            return "'time.sleep' call"
        if attr == "block_until_ready":
            return "host fence '.block_until_ready()'"
        if d == "torch.cuda.synchronize":
            return "host fence 'torch.cuda.synchronize()'"
        if attr == "synchronize":
            return "host fence '.synchronize()'"
        if d.split(".")[0] == "subprocess":
            return f"subprocess call '{d}'"
        if d.startswith(("urllib.", "requests.", "socket.")) or \
                attr in _SOCKETISH_METHODS:
            return "socket/HTTP I/O"
        recv = func.value if isinstance(func, ast.Attribute) else None
        rname = _name_of(recv) if recv is not None else ""
        if _QUEUEISH.search(rname or ""):
            if attr == "get" and not call.args and "timeout" not in kwnames:
                return f"blocking '{rname}.get()' without timeout"
            if attr == "put" and "timeout" not in kwnames and \
                    "block" not in kwnames:
                return f"blocking '{rname}.put()' without timeout"
        if attr == "wait" and not call.args and "timeout" not in kwnames:
            rid = self.lock_of(recv) if recv is not None else None
            if [h for h in held if h != rid]:
                return "'.wait()' without timeout"
        if attr in _FORWARDISH:
            return f"model forward '.{attr}()'"
        return None


def _lock_graphs(ctx) -> List[_LockGraph]:
    module_locks = _module_lock_names(ctx)
    mod_fns = {n.name: n for n in getattr(ctx.tree, "body", [])
               if isinstance(n, ast.FunctionDef)}
    graphs = [_LockGraph(ctx, "", mod_fns, set(), module_locks)]
    for cls in ctx.classes():
        methods = {n.name: n for n in cls.body
                   if isinstance(n, ast.FunctionDef)}
        graphs.append(_LockGraph(ctx, cls.name, methods,
                                 _class_lock_attrs(ctx, methods),
                                 module_locks))
    return [g.walk() for g in graphs]


def find_cycles(edges) -> List[List[str]]:
    """Simple cycles in a lock-order graph, each reported once, rooted
    at its lexicographically smallest lock. ``edges`` is any iterable of
    ``(from, to)`` pairs (a dict of edge->site works directly)."""
    adj: Dict[str, Set[str]] = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
    out: List[List[str]] = []
    seen: Set[Tuple[str, ...]] = set()

    def dfs(start: str, node: str, path: List[str],
            onpath: Set[str]) -> None:
        for nxt in sorted(adj.get(node, ())):
            if nxt == start:
                canon = tuple(path)
                if canon not in seen:
                    seen.add(canon)
                    out.append(list(path))
            elif nxt not in onpath and nxt > start:
                path.append(nxt)
                onpath.add(nxt)
                dfs(start, nxt, path, onpath)
                path.pop()
                onpath.discard(nxt)

    for start in sorted(adj):
        dfs(start, start, [start], {start})
    return out


def lock_edges_from_source(source: str,
                           path: str = "<string>") -> Dict[Tuple[str, str],
                                                           ast.AST]:
    """The static lock-acquisition-order graph of one source file, as an
    edge ``(held, acquired) -> acquisition site`` map — the static half
    of the :mod:`.lockcheck` runtime cross-check."""
    from .engine import FileContext
    tree = ast.parse(source)
    ctx = FileContext(path, source, tree)
    edges: Dict[Tuple[str, str], ast.AST] = {}
    for g in _lock_graphs(ctx):
        edges.update(g.edges)
    return edges


def _check_lock_order(ctx):
    for g in _lock_graphs(ctx):
        for cycle in find_cycles(g.edges):
            if len(cycle) < 2:
                continue
            node = g.edges.get((cycle[0], cycle[1]))
            if node is None:
                continue
            ring = " -> ".join(cycle + [cycle[0]])
            yield node, (f"cyclic lock acquisition order {ring}: two "
                         f"threads taking these locks in opposite order "
                         f"can deadlock")


def _check_blocking_under_lock(ctx):
    for g in _lock_graphs(ctx):
        for node, reason, held in g.blocking:
            locks = ", ".join(sorted(set(held)))
            yield node, (f"{reason} while holding {locks} — blocking "
                         f"inside a critical section wedges every waiter")


# --------------------------------------------------------------------------
# JL404 — field-level atomicity
# --------------------------------------------------------------------------

def _check_field_atomicity(ctx):
    for cls in ctx.classes():
        methods = {n.name: n for n in cls.body
                   if isinstance(n, ast.FunctionDef)}
        if not methods:
            continue
        sync_attrs = _class_lock_attrs(ctx, methods)
        owns_locks = any(_LOCKISH.search(a) for a in sync_attrs) or \
            bool(_sync_primitive_attrs(methods.get("__init__"), ctx))

        # (attr, node, kind, method, guard)
        events: List[Tuple[str, ast.AST, str, str, Optional[str]]] = []
        for mname, fn in methods.items():
            if mname.endswith("_locked"):
                continue      # caller-holds-lock convention
            for node in _walk_no_nested(fn):
                if isinstance(node, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign)):
                    tgts = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                    for tgt in tgts:
                        subs = list(tgt.elts) if isinstance(
                            tgt, (ast.Tuple, ast.List)) else [tgt]
                        for s in subs:
                            if _is_self_attr(s) and \
                                    not s.attr.startswith("__"):
                                kind = "rmw" if isinstance(
                                    node, ast.AugAssign) else "write"
                                events.append((s.attr, s, kind, mname,
                                               _guard_of(ctx, s)))
                elif isinstance(node, (ast.If, ast.While)):
                    for sub in ast.walk(node.test):
                        if _is_self_attr(sub) and \
                                isinstance(sub.ctx, ast.Load) and \
                                not sub.attr.startswith("__"):
                            events.append((sub.attr, sub, "test-read",
                                           mname, _guard_of(ctx, sub)))

        by_attr: Dict[str, List] = {}
        for attr, node, kind, mname, guard in events:
            by_attr.setdefault(attr, []).append((node, kind, mname, guard))

        for attr, evs in sorted(by_attr.items()):
            if attr in sync_attrs:
                continue
            guarded = sorted({g for n, k, m, g in evs
                              if g and m != "__init__"
                              and k in ("write", "rmw")})
            for node, kind, mname, guard in evs:
                if mname == "__init__" or guard is not None:
                    continue
                if kind == "rmw" and (owns_locks or guarded):
                    yield node, (
                        f"unguarded read-modify-write of 'self.{attr}' in "
                        f"'{mname}' of lock-owning class '{cls.name}' — "
                        f"lost-update race (the 'dropped += 1' shape)")
                elif kind == "write" and guarded:
                    yield node, (
                        f"'self.{attr}' is written under "
                        f"{'/'.join(guarded)} elsewhere in '{cls.name}' "
                        f"but written without it in '{mname}'")
                elif kind == "test-read" and guarded:
                    yield node, (
                        f"check-then-act read of 'self.{attr}' in "
                        f"'{mname}' without {'/'.join(guarded)} (it is "
                        f"written under that lock) — the value can change "
                        f"between the test and the action")


# --------------------------------------------------------------------------
# JL5xx — serving discipline
# --------------------------------------------------------------------------

#: the typed serving-error taxonomy allowed to escape an HTTP handler (each
#: name has a class in the port: parallel/inference.py,
#: serving/{breaker,scheduler,model_pool,federation}.py, utils/faults.py)
ERROR_TAXONOMY = {
    "ServerClosedError", "BatchExecutionError", "NonFiniteOutputError",
    "QueueFullError", "DeadlineExceededError", "DecodeStepError",
    "KVCacheExhaustedError", "BreakerOpenError", "TierShedError",
    "SwapError", "ReplicaLostError", "FaultInjected",
}

#: self.* calls that raise typed serving errors (must sit inside a try)
_ROUTE_RAISING_CALLS = {"predict", "generate", "swap", "dispatch", "get",
                        "reconfigure", "reconfigure_scheduler",
                        "eject_member", "remove", "admit"}


def _try_protected(ctx, node, fn) -> bool:
    """Is this node inside the *body* of a try that has handlers (not in
    a handler/else/finally, which run unprotected)?"""
    child, cur = node, ctx.parent(node)
    while cur is not None:
        if isinstance(cur, ast.Try) and cur.handlers and child in cur.body:
            return True
        if cur is fn:
            return False
        child, cur = cur, ctx.parent(cur)
    return False


def _check_route_typed_errors(ctx):
    for fn in ctx.functions():
        name = getattr(fn, "name", "")
        if not name.endswith("_route"):
            continue
        for node in _walk_no_nested(fn):
            if isinstance(node, ast.Raise) and node.exc is not None:
                exc = node.exc
                if isinstance(exc, ast.Call):
                    exc = exc.func
                ename = _name_of(exc)
                if ename and ename not in ERROR_TAXONOMY and \
                        not _try_protected(ctx, node, fn):
                    yield node, (
                        f"raise of non-taxonomy '{ename}' escapes HTTP "
                        f"handler '{name}' untyped — clients see a bare "
                        f"500 instead of a typed serving error")
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                if attr not in _ROUTE_RAISING_CALLS:
                    continue
                d = ctx.dotted(node.func) or ""
                if not d.startswith("self."):
                    continue
                if attr == "get" and d != "self.pool.get":
                    continue
                if not _try_protected(ctx, node, fn):
                    yield node, (
                        f"call to '{d}' outside any try in HTTP handler "
                        f"'{name}' — a typed serving error raised here "
                        f"escapes as an untyped 500")


# --- JL502: metrics discipline --------------------------------------------

_METRIC_FACTORIES = {"counter", "gauge", "histogram"}
_UNBOUNDED_LABELS = {"request_id", "rid", "uuid", "guid", "trace_id",
                     "span_id", "correlation_id", "port", "pid", "tid"}
_UNBOUNDED_VALUE_CALLS = {"uuid4", "uuid1", "getpid", "get_ident"}
_REGISTER_FN_RE = re.compile(r"register.*metrics")

#: the package directories a file may sit in, and the bench entry point
#: beside each whose ``register*metrics`` functions pre-register families
#: too (the port's own bench entry point joins here once it exists)
_PACKAGE_DIRS = ("deeplearning4j_torch", "deeplearning4j_tpu")
_BENCH_ENTRIES = {"deeplearning4j_tpu": "bench.py"}


def _metric_family_call(ctx, node) -> Optional[str]:
    """Family name if this call constructs a metric family on a
    registry-ish receiver, else None."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _METRIC_FACTORIES
            and node.args and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)):
        return None
    recv = node.func.value
    if isinstance(recv, ast.Call):
        recv = recv.func
    if re.search(r"reg", _name_of(recv) or "", re.IGNORECASE):
        return node.args[0].value
    return None


def _package_root(path: str) -> Optional[str]:
    """Ascend from a file path to its package directory (None when
    analyzing sources outside a checkout)."""
    cur = os.path.abspath(path)
    while True:
        if os.path.basename(cur) in _PACKAGE_DIRS and os.path.isdir(cur):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return None
        cur = parent


def _tree_files(root: str) -> List[str]:
    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        out.extend(os.path.join(dirpath, f) for f in sorted(filenames))
    return out


_PREREG_CACHE: Dict[str, frozenset] = {}


def _preregistered_families(pkg_root: str) -> frozenset:
    """Every string constant inside a ``register*metrics`` function in
    the package (and its bench entry point, where it has one): the
    families a scrape sees before any traffic."""
    cached = _PREREG_CACHE.get(pkg_root)
    if cached is not None:
        return cached
    names: Set[str] = set()
    files = [f for f in _tree_files(pkg_root) if f.endswith(".py")]
    entry = _BENCH_ENTRIES.get(os.path.basename(pkg_root))
    if entry is not None:
        bench = os.path.join(os.path.dirname(pkg_root), entry)
        if os.path.isfile(bench):
            files.append(bench)
    for fname in files:
        try:
            with open(fname, "r", encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
        except (OSError, SyntaxError, UnicodeDecodeError):
            continue
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and _REGISTER_FN_RE.search(node.name):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Constant) and \
                            isinstance(sub.value, str):
                        names.add(sub.value)
    out = frozenset(names)
    _PREREG_CACHE[pkg_root] = out
    return out


def _check_metrics_discipline(ctx):
    # (a) family construction reachable from a hot path
    for fn in ctx.hot_functions():
        fname = getattr(fn, "name", "<lambda>")
        if _REGISTER_FN_RE.search(fname):
            continue
        for node in _walk_no_nested(fn):
            fam = _metric_family_call(ctx, node)
            if fam:
                yield node, (
                    f"metric family '{fam}' constructed in hot function "
                    f"'{fname}' — construct once in register_metrics() "
                    f"and only .labels().inc() on the hot path")
    # (b) unbounded-cardinality label sets
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "labels"):
            continue
        for kw in node.keywords:
            if kw.arg and kw.arg.lower() in _UNBOUNDED_LABELS:
                yield kw.value, (
                    f"metric label '{kw.arg}' is unbounded-cardinality "
                    f"(per-request identity) — every value mints a new "
                    f"series and the scrape grows without bound")
            elif isinstance(kw.value, ast.Call) and \
                    _name_of(kw.value.func) in _UNBOUNDED_VALUE_CALLS:
                yield kw.value, (
                    f"metric label '{kw.arg}' is fed from "
                    f"'{_name_of(kw.value.func)}()' — unbounded "
                    f"cardinality mints a new series per value")
    # (c) serving families absent from every pre-registration
    if "serving" not in os.path.normpath(ctx.path).split(os.sep):
        return
    pkg = _package_root(ctx.path)
    if pkg is None:
        return
    prereg = _preregistered_families(pkg)
    if not prereg:
        return
    for node in ast.walk(ctx.tree):
        fam = _metric_family_call(ctx, node)
        if fam is None or fam in prereg:
            continue
        encl = ctx.enclosing_function(node)
        if encl is not None and \
                _REGISTER_FN_RE.search(getattr(encl, "name", "")):
            continue
        yield node, (
            f"metric family '{fam}' used in serving/ but absent from "
            f"every register_metrics() pre-registration — a bench "
            f"--once scrape misses it until first use")


# --- JL503: fault-point coverage ------------------------------------------

_CORPUS_CACHE: Dict[Tuple[str, str], str] = {}


def _test_corpus(repo_root: str) -> str:
    """The port's tests, ``tests/test_torch_*.py``, as one string: a test
    of the JAX package cannot cover a point of the port."""
    key = (repo_root, "tests")
    cached = _CORPUS_CACHE.get(key)
    if cached is not None:
        return cached
    chunks: List[str] = []
    root = os.path.join(repo_root, "tests")
    if os.path.isdir(root):
        for fname in _tree_files(root):
            base = os.path.basename(fname)
            if base.startswith("test_torch_") and base.endswith(".py"):
                try:
                    with open(fname, "r", encoding="utf-8") as fh:
                        chunks.append(fh.read())
                except (OSError, UnicodeDecodeError):
                    continue
    out = "\n".join(chunks)
    _CORPUS_CACHE[key] = out
    return out


def _docs_corpus(pkg_root: str) -> str:
    """The table of points: the docstring of the package's own
    ``utils/faults.py``."""
    key = (pkg_root, "docs")
    cached = _CORPUS_CACHE.get(key)
    if cached is not None:
        return cached
    out = ""
    try:
        with open(os.path.join(pkg_root, "utils", "faults.py"), "r",
                  encoding="utf-8") as fh:
            out = ast.get_docstring(ast.parse(fh.read())) or ""
    except (OSError, SyntaxError, UnicodeDecodeError):
        pass
    _CORPUS_CACHE[key] = out
    return out


def _fault_env_var(point: str) -> str:
    return "DL4JTPU_FAULT_" + point.upper().replace(".", "_").replace(
        "-", "_")


def _check_fault_coverage(ctx):
    pkg = _package_root(ctx.path)
    if pkg is None:
        return
    tests = _test_corpus(os.path.dirname(pkg))
    docs = _docs_corpus(pkg)
    if not tests or not docs:
        return
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("fire", "check")
                and node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            continue
        point = node.args[0].value
        if "." not in point:
            continue
        if node.func.attr == "check" and not re.search(
                r"fault", _name_of(node.func.value) or "", re.IGNORECASE):
            continue          # '.check' is a common name; require faults.*
        if point not in tests and _fault_env_var(point) not in tests:
            yield node, (
                f"fault point '{point}' is not exercised by any test "
                f"under tests/test_torch_*.py — the chaos hook can "
                f"silently rot")
        if point not in docs:
            yield node, (
                f"fault point '{point}' is missing from the table of "
                f"points in utils/faults.py")


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

RULES: Tuple[Rule, ...] = (
    Rule("JL101", "warning", "host-scalar-sync",
         "Fence once per step (tracecheck.fenced_read / "
         "block_until_ready) or read asynchronously off the hot path.",
         _check_host_scalar_sync),
    Rule("JL102", "warning", "item-sync",
         "Batch .item()/.tolist() reads behind an explicit per-step fence.",
         _check_item_sync),
    Rule("JL103", "info", "host-copy",
         "np.asarray/device_get copies device memory; hoist out of the "
         "per-step loop or fence deliberately.",
         _check_asarray_sync),
    Rule("JL401", "warning", "lock-discipline",
         "Guard every write with the same self.<lock>, or annotate a "
         "documented atomic with '# jaxlint: atomic'.",
         _check_lock_discipline),
    Rule("JL402", "error", "lock-order-cycle",
         "Acquire locks in one global order everywhere; break the cycle, "
         "or baseline it with a justification if it cannot manifest.",
         _check_lock_order),
    Rule("JL403", "warning", "blocking-under-lock",
         "Move the blocking call outside the critical section, or give it "
         "a timeout so waiters cannot wedge behind it.",
         _check_blocking_under_lock),
    Rule("JL404", "warning", "field-atomicity",
         "Take the guarding lock for every read-modify-write and "
         "check-then-act on shared fields, or annotate a documented "
         "atomic with '# jaxlint: atomic'.",
         _check_field_atomicity),
    Rule("JL501", "error", "untyped-route-error",
         "Wrap handler work in try/except and map failures to the typed "
         "serving taxonomy (QueueFullError, ServerClosedError, ...).",
         _check_route_typed_errors),
    Rule("JL502", "warning", "metrics-discipline",
         "Construct metric families once in register_metrics(), keep "
         "label sets bounded, and pre-register serving families so "
         "bench --once scrapes see them.",
         _check_metrics_discipline),
    Rule("JL503", "error", "fault-coverage",
         "Add a test that arms the point (faults.inject/injected) and a "
         "row to the docs fault table.",
         _check_fault_coverage),
)

RULES_BY_ID: Dict[str, Rule] = {r.id: r for r in RULES}


def rule_catalog() -> List[dict]:
    """Stable, docs-friendly listing of every rule."""
    return [r.describe() for r in RULES]
