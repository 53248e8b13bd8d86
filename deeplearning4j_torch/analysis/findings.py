"""The Finding record and its baseline fingerprint.

Port of `deeplearning4j_tpu/analysis/findings.py`. Fingerprints
deliberately exclude the line NUMBER: a baseline must survive unrelated
edits above a grandfathered finding. They hash the rule id, the normalized
file path, the enclosing symbol, and the stripped source line text: stable
under drift, invalidated the moment the offending line itself changes
(which is exactly when a human should re-triage it).

Paths anchor at either package directory, so the port's analyzer and the
JAX package's fingerprint a file of either tree alike.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field

PACKAGE_DIRS = ("deeplearning4j_torch", "deeplearning4j_tpu")

SEVERITIES = ("error", "warning", "info")


def normalize_path(path: str) -> str:
    """Stable repo-relative posix path: anchor at a package directory when
    present (absolute vs relative invocations must fingerprint
    identically), else fall back to a cwd-relative path."""
    parts = os.path.abspath(path).replace(os.sep, "/").split("/")
    for pkg in PACKAGE_DIRS:
        if pkg in parts:
            return "/".join(parts[parts.index(pkg):])
    rel = os.path.relpath(path)
    if not rel.startswith(".."):
        return rel.replace(os.sep, "/")
    return path.replace(os.sep, "/")


@dataclass
class Finding:
    rule: str                 # "JL401"
    severity: str             # error | warning | info
    path: str                 # normalized (see normalize_path)
    line: int
    col: int
    message: str
    symbol: str = ""          # enclosing Class.method / function
    hint: str = ""            # rule fix-hint
    justification: str = ""   # filled from a matching baseline entry
    line_text: str = ""
    fingerprint: str = field(default="")

    def __post_init__(self):
        if not self.fingerprint:
            key = "|".join((self.rule, self.path, self.symbol,
                            self.line_text.strip()))
            self.fingerprint = hashlib.sha1(
                key.encode("utf-8", "replace")).hexdigest()[:16]

    def text(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col}"
        sym = f" [{self.symbol}]" if self.symbol else ""
        hint = f"\n      hint: {self.hint}" if self.hint else ""
        return (f"{loc}: {self.rule} {self.severity}: "
                f"{self.message}{sym}{hint}")

    def as_dict(self) -> dict:
        return {
            "rule": self.rule, "severity": self.severity, "path": self.path,
            "line": self.line, "col": self.col, "message": self.message,
            "symbol": self.symbol, "hint": self.hint,
            "fingerprint": self.fingerprint,
        }
