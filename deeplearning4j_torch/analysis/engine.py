"""Per-file analysis orchestration.

Port of `deeplearning4j_tpu/analysis/engine.py`, without the jit-boundary
inference that only the JAX package's tracing rules read. Parses each file
once, builds a :class:`FileContext` (parent links, import aliases,
hot-function classification, suppression comments), runs every rule from
:mod:`.rules`, and emits :class:`~.findings.Finding` records sorted by
location. Hotness is lexical, as in the JAX package: a function is hot if
its name looks like a training/step/iterator path or a listener callback
(`rules.HOT_NAME_RE`, `rules.CALLBACK_NAMES`), or if it is nested inside
one.

Suppression syntax (same line as the finding), the JAX analyzer's own, so
one comment silences both::

    self._stopped = True  # jaxlint: disable=JL401
    self.dropped += 1     # jaxlint: disable=JL401,JL101
    self._flag = True     # jaxlint: atomic   (alias for disable=JL401,JL404)
    x = float(y)          # jaxlint: disable=all
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Set

from .findings import Finding, normalize_path
from .rules import CALLBACK_NAMES, HOT_NAME_RE, RULES

_SUPPRESS_RE = re.compile(
    r"#\s*jaxlint:\s*(?:disable=(?P<ids>[A-Za-z0-9_,\s*]+)|(?P<atomic>atomic))")

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _parse_suppressions(lines: List[str]) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for lineno, line in enumerate(lines, start=1):
        if "jaxlint" not in line:
            continue
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        if m.group("atomic"):
            out.setdefault(lineno, set()).update({"JL401", "JL404"})
            continue
        ids = {tok.strip().upper() for tok in m.group("ids").split(",")
               if tok.strip()}
        if "ALL" in ids or "*" in ids:
            ids = {"*"}
        out.setdefault(lineno, set()).update(ids)
    return out


def build_alias_map(tree: ast.AST) -> Dict[str, str]:
    """Import-alias resolution (``import numpy as np`` -> np: numpy;
    ``from threading import Lock`` -> Lock: threading.Lock), collected from
    every import statement in the file, function-local ones included."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def dotted_name(node: ast.AST,
                aliases: Optional[Dict[str, str]] = None) -> Optional[str]:
    """``torch.cuda.synchronize`` for an Attribute/Name chain (None when
    the chain contains calls/subscripts), with the first segment
    canonicalized through the import-alias map."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    else:
        return None
    parts.reverse()
    if aliases and parts[0] in aliases:
        parts[0:1] = aliases[parts[0]].split(".")
    return ".".join(parts)


class FileContext:
    """Everything the rules need about one parsed file."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.rel = normalize_path(path)
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.aliases = build_alias_map(tree)
        self.suppressions = _parse_suppressions(self.lines)
        self._parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self._parents[child] = node
        self._functions = [n for n in ast.walk(tree)
                           if isinstance(n, _FUNC_NODES)]
        self._hot: Set[ast.AST] = set()
        for fn in self._functions:
            name = getattr(fn, "name", "<lambda>")
            if name in CALLBACK_NAMES or HOT_NAME_RE.search(name):
                self._hot.add(fn)
        # lexical hotness inheritance: a def nested inside a hot def is hot
        for fn in self._functions:
            cur = self._parents.get(fn)
            while cur is not None:
                if cur in self._hot:
                    self._hot.add(fn)
                    break
                cur = self._parents.get(cur)

    # -- navigation -------------------------------------------------------
    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, _FUNC_NODES):
                return cur
            cur = self._parents.get(cur)
        return None

    def qualname(self, node: ast.AST) -> str:
        """Class.method path for a node (its enclosing def chain)."""
        parts: List[str] = []
        cur: Optional[ast.AST] = node
        if not isinstance(cur, (*_FUNC_NODES, ast.ClassDef)):
            cur = self.enclosing_function(node) or self._enclosing_class(node)
        while cur is not None:
            if isinstance(cur, (*_FUNC_NODES, ast.ClassDef)):
                parts.append(getattr(cur, "name", "<lambda>"))
            cur = self._parents.get(cur)
        return ".".join(reversed(parts))

    def _enclosing_class(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur
            cur = self._parents.get(cur)
        return None

    # -- classification ---------------------------------------------------
    def dotted(self, node: ast.AST) -> Optional[str]:
        return dotted_name(node, self.aliases)

    def functions(self) -> List[ast.AST]:
        return list(self._functions)

    def classes(self) -> List[ast.ClassDef]:
        return [n for n in ast.walk(self.tree)
                if isinstance(n, ast.ClassDef)]

    def is_hot(self, fn: ast.AST) -> bool:
        return fn in self._hot

    def hot_functions(self) -> List[ast.AST]:
        return [fn for fn in self._functions if fn in self._hot]

    # -- suppression ------------------------------------------------------
    def suppressed(self, lineno: int, rule_id: str) -> bool:
        ids = self.suppressions.get(lineno)
        if not ids:
            return False
        return "*" in ids or rule_id in ids


def analyze_source(source: str, path: str = "<string>",
                   rules: Optional[Iterable] = None) -> List[Finding]:
    """Analyze one source string; returns findings sorted by location."""
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        return [Finding(
            rule="JL000", severity="error", path=normalize_path(path),
            line=exc.lineno or 1, col=exc.offset or 0,
            message=f"syntax error: {exc.msg}", symbol="",
            line_text="")]
    ctx = FileContext(path, source, tree)
    findings: List[Finding] = []
    seen: Set = set()
    for rule in (rules if rules is not None else RULES):
        for node, message in rule.check(ctx):
            lineno = getattr(node, "lineno", 1)
            col = getattr(node, "col_offset", 0)
            if ctx.suppressed(lineno, rule.id):
                continue
            key = (rule.id, lineno, col, message)
            if key in seen:
                continue
            seen.add(key)
            line_text = ctx.lines[lineno - 1] if \
                0 < lineno <= len(ctx.lines) else ""
            findings.append(Finding(
                rule=rule.id, severity=rule.severity, path=ctx.rel,
                line=lineno, col=col + 1, message=message,
                symbol=ctx.qualname(node), hint=rule.hint,
                line_text=line_text))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def iter_python_files(paths: Iterable[str]) -> Iterator[str]:
    skip_dirs = {"__pycache__", ".git", ".pytest_cache", "build", "dist"}
    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py"):
                yield path
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in skip_dirs)
            for name in sorted(files):
                if name.endswith(".py"):
                    yield os.path.join(root, name)


def analyze_paths(paths: Iterable[str],
                  rules: Optional[Iterable] = None) -> List[Finding]:
    """Analyze files and/or directory trees; returns sorted findings."""
    findings: List[Finding] = []
    for fname in iter_python_files(paths):
        try:
            with open(fname, "r", encoding="utf-8") as fh:
                source = fh.read()
        except (OSError, UnicodeDecodeError) as exc:
            findings.append(Finding(
                rule="JL000", severity="error", path=normalize_path(fname),
                line=1, col=0, message=f"unreadable file: {exc}"))
            continue
        findings.extend(analyze_source(source, fname, rules=rules))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
