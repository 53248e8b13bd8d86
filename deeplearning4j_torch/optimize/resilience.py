"""Fault-tolerant training control plane.

Port of `deeplearning4j_tpu/optimize/resilience.py`: four pillars on top of
the serializer/metrics/tracing stack:

* **Crash-safe checkpointing** — :class:`CheckpointManager`: atomic
  checkpoint files (utils/model_serializer.save_model writes tmp + fsync
  + rename), an atomically-replaced ``manifest.json`` recording
  step/epoch/mid-epoch position plus a sha256 content checksum per
  checkpoint, and `keep_last` / `keep_every_n_epochs` retention.
* **Auto-resume** — ``fit(..., checkpoint=mgr, resume=True)`` restores
  the newest *valid* checkpoint (torn/corrupt files are skipped with a
  warning) and fast-forwards epoch/iteration/batch counters. The port
  neither writes nor reads the JAX package's ``rngState.npz`` (its dropout
  key stream), so a resumed run is bitwise an uninterrupted one for a model
  without dropout (deterministic, unshuffled pipelines). The directory
  layout, manifest and checkpoint files are the JAX package's: a directory
  written by either package resumes in the other.
* **Divergence sentinels** — :class:`DivergenceSentinel`: one all-finite
  reduction over loss+params per checked step (one host read), with
  policy ``warn | skip_step | rollback`` (rollback = restore the last
  checkpoint + LR backoff through the updaters).
* **Retry/backoff** — :class:`RetryPolicy` + :func:`retry_call`:
  exponential backoff with jitter and a wall-clock deadline, for calls
  over flaky transport or storage; every retry increments
  ``retries_total{edge}`` and emits a span.

All recovery actions are observable: counters in the metrics registry and
spans in the trace ring.
"""
from __future__ import annotations

import itertools
import json
import hashlib
import logging
import os
import random as _random
import time
from dataclasses import dataclass
from http.client import HTTPException
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..utils import faults
from ..utils import params as param_utils
from ..utils.faults import FaultInjected
from ..utils.model_serializer import (CheckpointCorruptError,
                                      load_checkpoint_state, restore_model,
                                      save_model, validate_checkpoint)
from . import metrics as metrics_mod
from . import tracing

log = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.json"

# one help string per family so every call site registers identically
_HELP = {
    "checkpoint_saves_total": "Checkpoints written by CheckpointManager",
    "restores_total": "Checkpoint restores (auto-resume + rollback)",
    "checkpoint_corrupt_total":
        "Checkpoints skipped as torn/corrupt during restore scans",
    "nonfinite_steps_total":
        "Training steps where the divergence sentinel saw a non-finite "
        "loss or parameter, by policy",
    "rollbacks_total":
        "Divergence rollbacks (checkpoint restored + LR backoff applied)",
    "retries_total": "Transient-failure retries per distributed edge",
}


def _counter(name: str):
    return metrics_mod.registry().counter(name, _HELP[name])


# ---------------------------------------------------------------------------
# Retry/backoff
# ---------------------------------------------------------------------------

#: exception types retried by default: flaky transport (URLError/HTTPError/
#: timeouts are OSError subclasses; HTTPException covers half-closed
#: keep-alives) plus injected transient faults.
TRANSIENT_ERRORS: Tuple[type, ...] = (OSError, HTTPException, FaultInjected)

_jitter_rand = _random.Random()


@dataclass
class RetryPolicy:
    """Exponential backoff with full-range jitter and a deadline.

    Delay before retry *k* (0-based) is
    ``min(base_delay * multiplier**k, max_delay) * (1 ± jitter)``.
    ``deadline`` bounds total elapsed time across attempts; a retry that
    would sleep past it re-raises instead. ``max_retries=0`` disables
    retrying entirely.
    """

    max_retries: int = 5
    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 2.0
    jitter: float = 0.25
    deadline: Optional[float] = 30.0

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        """Build from the JAX package's ``DL4JTPU_RETRY_*`` env knobs:
        MAX, BASE_MS, MULT, MAX_MS, JITTER, DEADLINE_S."""
        e = os.environ.get
        return cls(
            max_retries=int(e("DL4JTPU_RETRY_MAX", 5)),
            base_delay=float(e("DL4JTPU_RETRY_BASE_MS", 50)) / 1000.0,
            multiplier=float(e("DL4JTPU_RETRY_MULT", 2.0)),
            max_delay=float(e("DL4JTPU_RETRY_MAX_MS", 2000)) / 1000.0,
            jitter=float(e("DL4JTPU_RETRY_JITTER", 0.25)),
            deadline=float(e("DL4JTPU_RETRY_DEADLINE_S", 30)) or None,
        )

    def delay(self, attempt: int, rand=None) -> float:
        d = min(self.base_delay * (self.multiplier ** attempt),
                self.max_delay)
        if self.jitter:
            r = (rand or _jitter_rand).random()      # U[0,1)
            d *= 1.0 + self.jitter * (2.0 * r - 1.0)
        return max(0.0, d)


def retry_call(fn: Callable[[], Any], *, edge: str,
               policy: Optional[RetryPolicy] = None,
               retryable: Tuple[type, ...] = TRANSIENT_ERRORS,
               clock: Callable[[], float] = time.monotonic,
               sleep: Callable[[float], None] = time.sleep,
               rand=None) -> Any:
    """Call `fn` with the policy's backoff schedule on transient errors.

    Non-retryable exceptions propagate immediately; retryable ones
    propagate once the attempt budget or deadline is exhausted. Each
    retry increments ``retries_total{edge}`` and emits a span.
    `clock`/`sleep`/`rand` are injectable for fake-clock tests.
    """
    policy = policy or RetryPolicy.from_env()
    start = clock()
    for attempt in itertools.count():
        try:
            return fn()
        except retryable as e:
            if attempt >= policy.max_retries:
                raise
            delay = policy.delay(attempt, rand)
            if policy.deadline is not None and \
                    (clock() - start) + delay > policy.deadline:
                log.warning("%s: retry deadline (%.1fs) exhausted after "
                            "%d attempt(s); giving up on %s",
                            edge, policy.deadline, attempt + 1, e)
                raise
            _counter("retries_total").labels(edge=edge).inc()
            log.warning("%s: transient failure (attempt %d/%d): %s; "
                        "retrying in %.0f ms", edge, attempt + 1,
                        policy.max_retries, e, delay * 1000.0)
            with tracing.span("retry", edge=edge, attempt=attempt):
                sleep(delay)


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointManager:
    """Crash-safe checkpoint directory with manifest, retention, resume.

    Layout: ``<dir>/checkpoint-<iteration>.zip`` files (atomic writes via
    save_model) plus an atomically-replaced ``manifest.json``::

        {"format_version": 1, "checkpoints": [
            {"file": ..., "iteration": N, "epoch": E,
             "batches_into_epoch": B, "sha256": ..., "size": ...}, ...]}

    ``epoch`` counts *completed* epochs at save time and
    ``batches_into_epoch`` the batches already consumed in the epoch in
    flight — exactly what fit needs to fast-forward on resume. A save
    interrupted by SIGKILL (see the ``checkpoint.write`` fault point)
    leaves the manifest pointing at the previous complete checkpoint.

    Cadence (used by the fit-loop hooks and the listener adapter):
    `save_every_n_iterations` saves mid-epoch on iteration multiples;
    `save_every_n_epochs` saves at epoch boundaries (default every
    epoch). Retention: `keep_last` newest are kept, plus epoch-boundary
    checkpoints of every `keep_every_n_epochs`-th epoch are pinned.
    """

    def __init__(self, directory: str, *, keep_last: int = 3,
                 keep_every_n_epochs: Optional[int] = None,
                 save_every_n_iterations: Optional[int] = None,
                 save_every_n_epochs: Optional[int] = 1,
                 save_updater: bool = True):
        self.directory = os.path.abspath(os.fspath(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.keep_last = int(keep_last)
        self.keep_every_n_epochs = keep_every_n_epochs
        self.save_every_n_iterations = save_every_n_iterations
        self.save_every_n_epochs = save_every_n_epochs
        self.save_updater = bool(save_updater)

    # ------------------------------------------------------------- manifest
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME)

    def checkpoints(self) -> List[Dict[str, Any]]:
        """Manifest records, oldest → newest. Falls back to a directory
        scan (no checksums) when the manifest is missing/unreadable, so a
        directory of bare checkpoint files is still resumable."""
        try:
            with open(self.manifest_path, "r", encoding="utf-8") as f:
                recs = json.load(f).get("checkpoints", [])
            if isinstance(recs, list):
                return recs
        except (OSError, ValueError):
            pass
        recs = []
        try:
            names = sorted(n for n in os.listdir(self.directory)
                           if n.startswith("checkpoint-")
                           and n.endswith(".zip"))
        except OSError:
            names = []
        for n in names:
            recs.append({"file": n})
        return recs

    def _write_manifest(self, records: List[Dict[str, Any]]) -> None:
        payload = json.dumps({"format_version": 1, "checkpoints": records},
                             indent=1)
        tmp = f"{self.manifest_path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.manifest_path)

    def _path(self, rec: Dict[str, Any]) -> str:
        return os.path.join(self.directory, rec["file"])

    # ----------------------------------------------------------------- save
    def save(self, model, *, batches_into_epoch: int = 0,
             normalizer=None) -> Dict[str, Any]:
        """Atomically write a checkpoint + updated manifest; prune."""
        fname = f"checkpoint-{int(model.iteration):08d}.zip"
        path = os.path.join(self.directory, fname)
        with tracing.span("checkpoint/save", iteration=int(model.iteration)):
            save_model(model, path, save_updater=self.save_updater,
                       normalizer=normalizer)
            rec = {
                "file": fname,
                "iteration": int(model.iteration),
                "epoch": int(model.epoch),
                "batches_into_epoch": int(batches_into_epoch),
                "sha256": _sha256(path),
                "size": os.path.getsize(path),
            }
            records = [r for r in self.checkpoints()
                       if r.get("file") != fname]
            records.append(rec)
            records.sort(key=lambda r: (r.get("iteration", -1),
                                        r.get("file", "")))
            records = self._prune(records)
            self._write_manifest(records)
        _counter("checkpoint_saves_total").inc()
        return rec

    def _prune(self, records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        if self.keep_last <= 0 or len(records) <= self.keep_last:
            return records
        keep_ids = {id(r) for r in records[-self.keep_last:]}
        kept = []
        for r in records:
            n = self.keep_every_n_epochs
            pinned = (n and r.get("batches_into_epoch", 0) == 0
                      and r.get("epoch", 0) > 0
                      and r.get("epoch", 0) % n == 0)
            if id(r) in keep_ids or pinned:
                kept.append(r)
            else:
                try:
                    os.unlink(self._path(r))
                except OSError:
                    pass
        return kept

    # -------------------------------------------------------------- restore
    def _valid(self, rec: Dict[str, Any]) -> bool:
        path = self._path(rec)
        if not os.path.exists(path):
            return False
        want = rec.get("sha256")
        if want and _sha256(path) != want:
            return False
        try:
            validate_checkpoint(path, deep=not want)
        except CheckpointCorruptError:
            return False
        return True

    def latest_valid(self) -> Optional[Dict[str, Any]]:
        """Newest checkpoint that passes checksum + structural validation;
        torn/corrupt ones are skipped with a warning."""
        for rec in reversed(self.checkpoints()):
            if self._valid(rec):
                return rec
            _counter("checkpoint_corrupt_total").inc()
            log.warning("skipping torn/corrupt checkpoint %s in %s",
                        rec.get("file"), self.directory)
        return None

    def restore_into(self, model) -> Optional[Dict[str, Any]]:
        """Load the newest valid checkpoint's training state into an
        existing model; returns its manifest record (None if no valid
        checkpoint exists)."""
        rec = self.latest_valid()
        if rec is None:
            return None
        path = self._path(rec)
        with tracing.span("checkpoint/restore", file=rec.get("file")):
            meta = load_checkpoint_state(model, path,
                                         load_updater=self.save_updater)
        _counter("restores_total").inc()
        out = dict(rec)
        out.setdefault("iteration", meta.get("iteration", 0))
        out.setdefault("epoch", meta.get("epoch", 0))
        out.setdefault("batches_into_epoch", 0)
        return out

    def restore_latest(self, load_updater: bool = True, device=None):
        """Rebuild a fresh model from the newest valid checkpoint, on
        `device` (CUDA unless the caller asks for the CPU). Returns
        ``(model, record)`` or ``(None, None)``."""
        rec = self.latest_valid()
        if rec is None:
            return None, None
        with tracing.span("checkpoint/restore", file=rec.get("file")):
            model = restore_model(self._path(rec), load_updater=load_updater,
                                  device=device)
        _counter("restores_total").inc()
        return model, rec

    # ------------------------------------------------- fit-loop cadence hooks
    def on_batch(self, model, batches_into_epoch: int) -> None:
        n = self.save_every_n_iterations
        if n and int(model.iteration) % n == 0:
            self.save(model, batches_into_epoch=batches_into_epoch)

    def on_epoch(self, model) -> None:
        n = self.save_every_n_epochs
        if n and int(model.epoch) % n == 0:
            self.save(model, batches_into_epoch=0)

    def listener(self):
        """An IterationListener adapter driving this manager from
        `model.add_listener(...)` (for loops that don't take
        ``checkpoint=``, e.g. custom training drivers)."""
        from .listeners import CheckpointListener
        return CheckpointListener(manager=self)


# ---------------------------------------------------------------------------
# Divergence sentinel
# ---------------------------------------------------------------------------

class DivergenceError(RuntimeError):
    """Training diverged and the sentinel could not (or may no longer)
    recover: no valid checkpoint, or the rollback budget is exhausted."""


class DivergenceSentinel:
    """Per-step non-finite watchdog for the fit loops.

    After each (checked) step, one reduction computes a single all-finite
    flag over the step loss and every floating-point parameter leaf: one
    scalar device read, amortizable via `check_every`. On a non-finite
    flag:

    * ``warn`` — log + count, keep training;
    * ``skip_step`` — restore the pre-step params/updater/layer-state
      snapshot and the dropout generator's state (device-side copies taken
      before each step) and continue: the poisoned batch's update is
      dropped;
    * ``rollback`` — restore the newest valid checkpoint from the
      attached :class:`CheckpointManager` and multiply every updater's
      learning rate by `lr_backoff` (read by the next eager step; there
      is no trace to invalidate). At most `max_rollbacks` before
      :class:`DivergenceError`.

    The ``step.nonfinite`` fault point forces the flag for chaos tests.
    """

    POLICIES = ("warn", "skip_step", "rollback")

    def __init__(self, policy: str = "warn", *,
                 checkpoint: Optional[CheckpointManager] = None,
                 lr_backoff: float = 0.5, check_every: int = 1,
                 max_rollbacks: int = 3):
        if policy not in self.POLICIES:
            raise ValueError(f"policy must be one of {self.POLICIES}, "
                             f"got {policy!r}")
        if policy == "rollback" and checkpoint is None:
            raise ValueError("policy='rollback' requires a checkpoint= "
                             "CheckpointManager to roll back to")
        if policy == "skip_step" and int(check_every) != 1:
            # a step-k NaN detected at step k+j would restore an
            # already-poisoned snapshot
            raise ValueError("policy='skip_step' requires check_every=1")
        self.policy = policy
        self.checkpoint = checkpoint
        self.lr_backoff = float(lr_backoff)
        self.check_every = max(1, int(check_every))
        self.max_rollbacks = int(max_rollbacks)
        self.rollbacks = 0
        self.nonfinite_steps = 0
        self._snapshot = None

    # ------------------------------------------------------------- fit hooks
    def before_step(self, model) -> None:
        if self.policy != "skip_step":
            return
        # fresh copies every step, never aliases of the live trees
        copy = lambda tree: param_utils.tree_map(torch.clone, tree)
        gen = model._dropout_gen
        self._snapshot = (
            copy(model.params_tree),
            copy(model.opt_state),
            copy(model.state_tree),
            None if gen is None else gen.get_state(),
            int(model.iteration),
        )

    def after_step(self, model) -> bool:
        """Returns True when a non-finite step was detected (and the
        policy's recovery action was applied)."""
        if self.check_every > 1 and \
                int(model.iteration) % self.check_every != 0:
            return False
        if not self._nonfinite(model):
            self._snapshot = None
            return False
        self.nonfinite_steps += 1
        _counter("nonfinite_steps_total").labels(policy=self.policy).inc()
        with tracing.span("sentinel/" + self.policy,
                          iteration=int(model.iteration)):
            if self.policy == "warn":
                log.warning("non-finite loss/params at iteration %d "
                            "(policy=warn: continuing)", model.iteration)
            elif self.policy == "skip_step":
                self._skip_step(model)
            else:
                self._rollback(model)
        return True

    # -------------------------------------------------------------- internals
    def _nonfinite(self, model) -> bool:
        if faults.check("step.nonfinite"):
            return True
        flags = [torch.isfinite(t).all()
                 for t in param_utils.tree_leaves(model.params_tree)
                 if t.is_floating_point()]
        if model.score_value is not None:
            flags.append(torch.isfinite(torch.as_tensor(model.score_value)).all())
        return bool(flags) and not bool(torch.stack(
            [f.to(flags[0].device) for f in flags]).all())

    def _skip_step(self, model) -> None:
        if self._snapshot is None:
            log.warning("non-finite step but no pre-step snapshot; "
                        "falling back to warn")
            return
        params, opt, state, gen_state, iteration = self._snapshot
        self._snapshot = None
        model.params_tree = params
        model.opt_state = opt
        model.state_tree = state
        if gen_state is not None:
            model._dropout_gen.set_state(gen_state)
        model.iteration = iteration
        model.score_value = None
        log.warning("non-finite step at iteration %d: update dropped, "
                    "pre-step state restored (policy=skip_step)", iteration)

    def _rollback(self, model) -> None:
        if self.rollbacks >= self.max_rollbacks:
            raise DivergenceError(
                f"training diverged {self.rollbacks + 1} times; rollback "
                f"budget ({self.max_rollbacks}) exhausted")
        rec = self.checkpoint.restore_into(model)
        if rec is None:
            raise DivergenceError(
                "non-finite step with policy='rollback' but no valid "
                f"checkpoint in {self.checkpoint.directory}")
        self.rollbacks += 1
        for layer in _iter_layers(model):
            upd = getattr(layer, "updater", None)
            if upd is not None and getattr(upd, "learning_rate", None):
                upd.learning_rate = float(upd.learning_rate) * self.lr_backoff
        model.score_value = None
        _counter("rollbacks_total").inc()
        log.warning("non-finite step: rolled back to %s (iteration %s), "
                    "learning rates scaled by %g (%d/%d rollbacks used)",
                    rec.get("file"), rec.get("iteration"), self.lr_backoff,
                    self.rollbacks, self.max_rollbacks)


def _iter_layers(model):
    layers = getattr(model, "layers", None)
    if layers is not None:
        return list(layers)
    return [model.conf.nodes[n].layer for n in model._layer_nodes]
