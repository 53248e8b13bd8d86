"""Repo-native static analysis of the port's host syncs, lock discipline
and serving discipline, and two runtime recorders.

Port of `deeplearning4j_tpu/analysis/` (jaxlint), for the rule families
that mean something in eager torch: hidden host syncs in hot paths (a
`.item()`, `float()`, `.tolist()` or `.cpu()` of a CUDA tensor waits for
the device), the lock discipline of the threaded subsystems (prefetch,
ParallelInference, the wrappers, the parameter server, the serving plane,
MetricsRegistry), and the serving plane's typed errors, metric families and
fault points. This package turns those conventions into a gate:

* :mod:`.rules` — JL101-JL103 (host syncs, with torch's ``.cpu()``,
  ``.numpy()`` and ``.to("cpu")`` spellings), JL401-JL404 (consistent
  guards, lock-order cycles, blocking under a held lock, field atomicity)
  with the lock-graph helpers, and JL501-JL503 (typed route errors, metrics
  discipline, fault-point coverage).
* :mod:`.engine` — per-file AST orchestration producing findings, with
  lexical hot-function classification and the JAX analyzer's
  ``# jaxlint: disable=RULE`` / ``# jaxlint: atomic`` suppressions.
* :mod:`.baseline` — grandfathered-finding store, so the gate fails only
  on NEW findings (``analysis/baseline.json``, each entry justified).
* :mod:`.tracecheck` — runtime shim that counts implicit device->host
  syncs into the metrics registry (``host_syncs_total{site}``), and the
  card's own count under ``torch.cuda.set_sync_debug_mode`` (``sync_debug``).
* :mod:`.lockcheck` — runtime recorder of the lock-acquisition order, held
  against the static graph.

The JAX analyzer's other rules stay out, because they check jit tracing
and eager torch traces nothing and donates nothing: JL001-JL005 (trace
purity), JL201-JL203 (jit cache keys: unhashable statics, closed-over
arrays, shape f-strings), JL301 (buffer donation) and ``boundaries.py``
(jit-boundary inference).

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
