"""The port analyzer's command line (port of
`deeplearning4j_tpu/analysis/cli.py`).

::

    python -m deeplearning4j_torch.analysis [paths...] \
        [--format text|json] [--baseline FILE] [--write-baseline] \
        [--justify TEXT] [--no-baseline] [--rules [JL101,JL401]] \
        [--list-rules]

A bare ``--rules`` (no value) prints the rule catalog — id, severity,
title, fix hint — and exits; with a comma-separated value it restricts
the run to those rules.

Exit codes: 0 = clean vs baseline, 1 = new findings, 2 = usage/config
error. The default path is the port's package and the default baseline
its ``analysis/baseline.json`` (``[tool.jaxlint]`` in pyproject.toml
configures the JAX package's analyzer, not this one).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .baseline import Baseline, default_baseline_path
from .engine import analyze_paths
from .rules import RULES_BY_ID, rule_catalog

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m deeplearning4j_torch.analysis",
        description="host-sync, lock-discipline and serving-discipline "
                    "static analysis of the port")
    p.add_argument("paths", nargs="*",
                   help="files or directories (default: the "
                        "deeplearning4j_torch package)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--baseline", default=None,
                   help="baseline JSON (default: the packaged "
                        "analysis/baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, ignore any baseline")
    p.add_argument("--write-baseline", action="store_true",
                   help="record the current findings as the new baseline "
                        "(preserves justifications for surviving entries; "
                        "new entries require --justify)")
    p.add_argument("--justify", default="",
                   help="justification recorded on NEW baseline entries "
                        "written by --write-baseline")
    p.add_argument("--rules", nargs="?", const="", default=None,
                   help="comma-separated rule ids to run (default: all); "
                        "bare --rules prints the rule catalog with "
                        "severity and fix hints, then exits")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def _select_rules(spec: Optional[str]):
    if not spec:
        return None
    wanted = [tok.strip().upper() for tok in spec.split(",") if tok.strip()]
    unknown = [w for w in wanted if w not in RULES_BY_ID]
    if unknown:
        print(f"jaxlint: unknown rule id(s): {', '.join(unknown)}",
              file=sys.stderr)
        raise SystemExit(2)
    return [RULES_BY_ID[w] for w in wanted]


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules or args.rules == "":
        for r in rule_catalog():
            print(f"{r['id']}  {r['severity']:<7}  {r['title']:<18} "
                  f"{r['hint']}")
        return 0

    paths = args.paths
    if not paths:
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        paths = [pkg_root]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"jaxlint: no such path: {', '.join(missing)}",
              file=sys.stderr)
        return 2

    try:
        rules = _select_rules(args.rules)
    except SystemExit:
        return 2

    findings = analyze_paths(paths, rules=rules)

    baseline_path = args.baseline or default_baseline_path()
    if args.no_baseline:
        baseline = Baseline()
    else:
        try:
            baseline = Baseline.load(baseline_path)
        except (ValueError, json.JSONDecodeError, OSError) as exc:
            print(f"jaxlint: cannot load baseline {baseline_path}: {exc}",
                  file=sys.stderr)
            return 2

    if args.write_baseline:
        try:
            baseline.record(findings,
                            default_justification=args.justify)
        except ValueError as exc:
            print(f"jaxlint: {exc}", file=sys.stderr)
            return 2
        baseline.save(baseline_path)
        print(f"jaxlint: wrote {len(baseline.entries)} baseline entries "
              f"to {baseline_path}")
        return 0

    result = baseline.match(findings)

    if args.format == "json":
        print(json.dumps({
            "new": [f.as_dict() for f in result.new],
            "baselined": [f.as_dict() for f in result.known],
            "expired": [e.as_dict() for e in result.expired],
            "summary": {"new": len(result.new),
                        "baselined": len(result.known),
                        "expired": len(result.expired),
                        "files_scanned": len({f.path for f in findings})
                        if findings else 0},
        }, indent=2))
    else:
        for f in result.new:
            print(f.text())
        if result.expired:
            print(f"jaxlint: note: {len(result.expired)} baseline "
                  f"entr{'y is' if len(result.expired) == 1 else 'ies are'} "
                  f"stale (fixed or moved); prune with --write-baseline")
        status = "clean" if not result.new else "FAILED"
        print(f"jaxlint: {status}: {len(result.new)} new finding(s), "
              f"{len(result.known)} baselined, "
              f"{len(result.expired)} expired baseline entr"
              f"{'y' if len(result.expired) == 1 else 'ies'}")
    return 1 if result.new else 0
