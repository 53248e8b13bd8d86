"""Grandfathered-finding store.

Port of `deeplearning4j_tpu/analysis/baseline.py`, the same file format.
``analysis/baseline.json`` records known findings so the CI gate fails
only on NEW ones. Each entry carries the finding's fingerprint (rule |
path | symbol | stripped line text — see :mod:`.findings`), a human
locator, and a one-line justification for why it is tolerated.

Matching is a multiset: two identical fingerprints in the tree need two
baseline entries. Entries whose fingerprint no longer matches anything
are reported as *expired* so the file can be pruned (or pruned
automatically by ``--write-baseline``).
"""
from __future__ import annotations

import json
import os
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .findings import Finding

FORMAT_VERSION = 1

DEFAULT_BASENAME = "baseline.json"


def default_baseline_path() -> str:
    """The baseline shipped inside the analysis package."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        DEFAULT_BASENAME)


@dataclass
class BaselineEntry:
    fingerprint: str
    rule: str = ""
    location: str = ""       # "path:line [symbol]" at record time (advisory)
    justification: str = ""

    def as_dict(self) -> dict:
        return {"fingerprint": self.fingerprint, "rule": self.rule,
                "location": self.location,
                "justification": self.justification}


@dataclass
class MatchResult:
    new: List[Finding] = field(default_factory=list)
    known: List[Finding] = field(default_factory=list)
    expired: List[BaselineEntry] = field(default_factory=list)


class Baseline:
    def __init__(self, entries: Optional[List[BaselineEntry]] = None,
                 path: Optional[str] = None):
        self.entries: List[BaselineEntry] = list(entries or [])
        self.path = path

    # -- persistence ------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls(path=path)
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
        version = data.get("version", FORMAT_VERSION)
        if version > FORMAT_VERSION:
            raise ValueError(
                f"baseline {path} has version {version}; this analyzer "
                f"understands <= {FORMAT_VERSION}")
        entries = [BaselineEntry(
            fingerprint=e["fingerprint"], rule=e.get("rule", ""),
            location=e.get("location", ""),
            justification=e.get("justification", ""))
            for e in data.get("entries", [])]
        return cls(entries, path=path)

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if path is None:
            raise ValueError("no baseline path to save to")
        payload = {
            "version": FORMAT_VERSION,
            "entries": [e.as_dict() for e in sorted(
                self.entries, key=lambda e: (e.location, e.fingerprint))],
        }
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, path)
        self.path = path

    # -- matching ---------------------------------------------------------
    def match(self, findings: List[Finding]) -> MatchResult:
        budget = Counter(e.fingerprint for e in self.entries)
        by_fp: Dict[str, BaselineEntry] = {}
        for e in self.entries:
            by_fp.setdefault(e.fingerprint, e)
        result = MatchResult()
        used: Counter = Counter()
        for f in findings:
            if budget[f.fingerprint] > 0:
                budget[f.fingerprint] -= 1
                used[f.fingerprint] += 1
                f.justification = by_fp[f.fingerprint].justification
                result.known.append(f)
            else:
                result.new.append(f)
        for e in self.entries:
            if used[e.fingerprint] > 0:
                used[e.fingerprint] -= 1
            else:
                result.expired.append(e)
        return result

    # -- (re)recording ----------------------------------------------------
    def record(self, findings: List[Finding],
               default_justification: str = "") -> None:
        """Replace entries with the given findings, preserving existing
        justifications for fingerprints that survive.

        Every NEW entry must carry a justification — pass one via
        ``default_justification`` (CLI: ``--justify``); recording an
        entry with an empty justification raises ValueError instead of
        silently grandfathering it."""
        old: Dict[str, List[BaselineEntry]] = {}
        for e in self.entries:
            old.setdefault(e.fingerprint, []).append(e)
        new_entries: List[BaselineEntry] = []
        unjustified: List[str] = []
        for f in findings:
            kept = old.get(f.fingerprint)
            justification = default_justification
            if kept:
                justification = kept.pop(0).justification or justification
            if not justification.strip():
                unjustified.append(f"{f.path}:{f.line} {f.rule}")
            new_entries.append(BaselineEntry(
                fingerprint=f.fingerprint, rule=f.rule,
                location=f"{f.path}:{f.line} [{f.symbol}]",
                justification=justification))
        if unjustified:
            shown = "; ".join(unjustified[:5])
            more = f" (+{len(unjustified) - 5} more)" \
                if len(unjustified) > 5 else ""
            raise ValueError(
                f"refusing to baseline {len(unjustified)} finding(s) "
                f"without a justification — pass one with --justify: "
                f"{shown}{more}")
        self.entries = new_entries
