"""The lock rules of the port's analyzer.

Port of the JL4xx family of `deeplearning4j_tpu/analysis/rules.py`, held to
it finding for finding on the JAX package's tree. Each rule is a
:class:`Rule` with a stable id, a severity, a one-line fix hint, and a
``check(ctx)`` generator yielding ``(node, message)`` pairs. The engine
turns those into findings, applies ``# jaxlint: disable=RULE``
suppressions (the JAX analyzer's syntax, so one comment silences both), and
matches them against the baseline.

JL4xx  lock discipline in threaded subsystems (RacerD-style
consistent-guard checking): JL401 consistent guards over thread entry
points, JL402 lock-acquisition-order cycles (potential deadlocks), JL403
blocking calls under a held lock, JL404 field-level atomicity (shared
attributes written under a lock but read or read-modify-written outside
it).

JL403 counts a host fence as blocking: the JAX package's
``.block_until_ready()``, and the port's ``torch.cuda.synchronize()`` and
``.synchronize()`` on a stream or an event, each of which waits for the
device.

The trace-purity, recompile and donation rules (JL0xx, JL2xx, JL301) check
jit tracing and have no meaning in eager torch.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Set, Tuple

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


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

RULES: Tuple[Rule, ...] = (
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
)

RULES_BY_ID: Dict[str, Rule] = {r.id: r for r in RULES}


def rule_catalog() -> List[dict]:
    """Stable, docs-friendly listing of every rule."""
    return [r.describe() for r in RULES]
