"""Repo-native static analysis of the port's lock discipline, and a runtime
lock-order recorder.

Port of the lock half of `deeplearning4j_tpu/analysis/` (jaxlint): the
threaded subsystems (prefetch, ParallelInference, the wrappers, the
parameter server, the serving plane, MetricsRegistry) enforce their lock
discipline only by convention, and this package turns those conventions
into a gate.

* :mod:`.rules` — JL401-JL404 (consistent guards, lock-order cycles,
  blocking under a held lock, field atomicity) and the lock-graph helpers.
* :mod:`.engine` — per-file AST orchestration producing findings, with the
  JAX analyzer's ``# jaxlint: disable=RULE`` / ``# jaxlint: atomic``
  suppressions.
* :mod:`.baseline` — grandfathered-finding store, so the gate fails only
  on NEW findings (``analysis/baseline.json``, each entry justified).
* :mod:`.lockcheck` — runtime recorder of the lock-acquisition order, held
  against the static graph.

CLI::

    python -m deeplearning4j_torch.analysis [paths...] \
        [--format text|json] [--baseline FILE] [--write-baseline]

Exit code 0 means no findings beyond the baseline.
"""
from .engine import Finding, analyze_paths, analyze_source  # noqa: F401
from .rules import RULES, rule_catalog  # noqa: F401
from .baseline import Baseline  # noqa: F401

__all__ = ["Finding", "analyze_paths", "analyze_source", "RULES",
           "rule_catalog", "Baseline"]
