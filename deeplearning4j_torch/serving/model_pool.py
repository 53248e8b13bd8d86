"""Named model pool with checkpoint-gated zero-downtime hot-swap.

Port of `deeplearning4j_tpu/serving/model_pool.py`. Each entry pairs a
live network with its continuous-batching execution engine
(parallel/inference.ParallelInference, or serving/decode.DecodeEngine for a
generative entry) and, optionally, the CheckpointManager a training run
publishes to. The pool is the gateway's routing table and the owner of the
swap protocol:

1. **Gate** — `CheckpointManager.latest_valid()` picks the newest
   checkpoint whose sha256 manifest entry verifies; torn/corrupt
   publishes are skipped, an empty manifest refuses the swap.
2. **Decode off the hot path** — params/state npz trees are read and
   staged on the model's device against the LIVE model's trees as
   templates (same structure, same shapes — an architecture mismatch
   fails here, before traffic is touched), quantized when the swap asks
   for it, and the device is synchronized, so the copies are complete
   before any forward can read them — all while the engine keeps serving.
3. **Pause–assign–warm** — the engine's execution lock is held just
   long enough to assign the new trees and push one zero batch per
   warmed bucket (shapes are unchanged, so this re-verifies the fast path
   with the new params). In-flight requests finish first; queued requests
   WAIT — none are dropped or failed.
4. **Rollback on failure** — if the warm forward raises, the old trees
   (the very tensors that were serving) are restored before the lock is
   released and the swap reports failed; traffic never sees half-swapped
   params.

4½. **Canary gate** — after pause-assign-warm, a
   retained golden batch runs through the NEW params; non-finite
   outputs (or drift past the optional `canary_max_drift` knob vs the
   OLD params' outputs on the same batch) auto-roll back to the old
   tree and raise `SwapError`, counted as
   `serving_swaps_total{outcome="canary_rejected"}` — a checkpoint
   that passes its sha256 gate but computes garbage never reaches
   traffic.

Swap outcomes land in `serving_swaps_total{model,outcome}`; per-model
queue depth is sampled into `serving_queue_depth{model}` and breaker
state into `serving_breaker_state{model}` at scrape time.
"""
from __future__ import annotations

import os
import threading
import weakref
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.padding import next_pow2_bucket, repeat_tail_rows
from ..optimize import tracing
from ..optimize.metrics import registry
from ..parallel.inference import (InferenceMode, NonFiniteOutputError,
                                  ParallelInference)
from ..quantize import quantize as quantize_mod
from ..utils import faults
from ..utils.model_serializer import (PARAMS_ENTRY, STATE_ENTRY,
                                      CheckpointCorruptError,
                                      _npz_bytes_to_tree, _read_entry,
                                      validate_checkpoint)
from .breaker import STATE_VALUES, CircuitBreaker
from .scheduler import DeviceScheduler, TIER_VALUES

__all__ = ["FusedModelGroup", "ModelEntry", "ModelPool", "SwapError"]


class SwapError(RuntimeError):
    """Hot-swap refused: no CheckpointManager attached, no valid
    checkpoint published, architecture mismatch, the warm forward
    failed, or the canary gate rejected the new params (in the latter
    two cases the old params were rolled back and are still serving)."""


class _CanaryRejected(RuntimeError):
    """Internal: the post-warm golden-batch check failed — distinguishes
    the canary_rejected swap outcome from a plain warm failure."""


#: serving precisions the quantized swap plane can promote
PRECISIONS = ("fp32", "bf16", "int8")


def _swap_counter(name: str, outcome: str, precision: str = "fp32"):
    registry().counter(
        "serving_swaps_total",
        "Checkpoint hot-swap attempts by outcome "
        "(ok/noop/failed/canary_rejected) and target precision"
        ).labels(model=name, outcome=outcome, precision=precision).inc()


def _set_precision_gauge(name: str, precision: str):
    """One-hot `serving_precision{model,precision}` gauge: the scrape
    surface's answer to 'what precision is this model serving at right
    now' without diffing swap counters."""
    g = registry().gauge(
        "serving_precision",
        "Active serving precision per model (1 = the labeled "
        "precision is live)")
    for p in PRECISIONS:
        g.labels(model=name, precision=p).set(
            1.0 if p == precision else 0.0)


def _fused_fallback_counter(reason: str, n: int = 1):
    registry().counter(
        "serving_fused_fallback_total",
        "Members served per-model instead of fused, by reason "
        "(ineligible/ejected/dissolved)"
        ).labels(reason=reason).inc(n)


def register_metrics() -> None:
    """Pre-register every pool-owned family: a scrape
    taken before the first request must already show them at zero."""
    reg = registry()
    fam = reg.counter(
        "serving_fused_fallback_total",
        "Members served per-model instead of fused, by reason "
        "(ineligible/ejected/dissolved)")
    for reason in ("ineligible", "ejected", "dissolved"):
        fam.labels(reason=reason)
    reg.counter("serving_shed_total",
                "Requests shed before a forward served them, by reason")
    reg.counter("serving_forwards_total",
                "Coalesced forward passes executed")
    reg.counter("serving_rows_total",
                "Real (un-padded) request rows served")
    reg.histogram("serving_batch_rows",
                  "Real rows per coalesced forward (bucket fill)")
    reg.counter("serving_swaps_total",
                "Checkpoint hot-swap attempts by outcome "
                "(ok/noop/failed/canary_rejected) and target precision")
    reg.gauge("serving_precision",
              "Active serving precision per model (1 = the labeled "
              "precision is live)")
    reg.gauge("serving_queue_depth", "Requests queued per served model")


def _golden_forward(model, golden: np.ndarray) -> np.ndarray:
    """Run the golden batch through the model padded to its pow2 bucket
    (the rule the engine coalesces to: the old and the new parameters'
    outputs come from the same bucket, so batch order alone cannot move
    the drift) and slice the real rows back."""
    n = golden.shape[0]
    xs = repeat_tail_rows(golden, next_pow2_bucket(n) - n)
    return np.asarray(model.output(xs))[:n]


def _sync(device) -> None:
    """Wait for every copy and kernel queued on `device`: a swap's staged
    trees are complete before the pause assigns them, whatever stream
    queued them."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class ModelEntry:
    """One named served model: the live network, its batching engine,
    and the checkpoint source it hot-swaps from."""

    def __init__(self, name: str, model, engine: ParallelInference,
                 checkpoints=None, breaker: Optional[CircuitBreaker] = None,
                 golden_batch: Optional[np.ndarray] = None,
                 canary_max_drift: Optional[float] = None,
                 tier: str = "standard", weight: float = 1.0):
        self.name = name
        self.model = model
        self.engine = engine
        self.checkpoints = checkpoints
        self.breaker = breaker
        # Priority tier + WFQ weight (serving/scheduler.py). Defaults
        # never construct a scheduler — single-model pools keep the
        # exact pre-scheduler dispatch path.
        self.tier = tier
        self.weight = float(weight)
        # Fused-group plumbing: members of a FusedModelGroup share one
        # engine; `transform` slices this member's output columns out of
        # the fused forward, `group` owns the per-member swap protocol.
        self.transform = None
        self.group: Optional["FusedModelGroup"] = None
        # Canary substrate: a small retained input batch (provided, or
        # captured from the first served request) replayed through new
        # params before a swap promotes them; `canary_max_drift` bounds
        # max|new - old| output drift on it (None = finiteness only).
        self.golden_batch = None if golden_batch is None else \
            np.asarray(golden_batch)
        self.canary_max_drift = canary_max_drift
        # Active serving precision ("fp32" until a quantized swap
        # promotes an int8/bf16 tree) — stamped on metrics, traces,
        # and describe() so the A/B is attributable everywhere.
        self.precision = "fp32"
        # Manifest record of the checkpoint currently serving; empty
        # until the first swap (initial params came from the caller,
        # not a published checkpoint).
        self.version: Dict[str, Any] = {}
        self.swaps = 0

    def describe(self) -> Dict[str, Any]:
        out = {
            "model": self.name,
            "version": self.version.get("file", "initial"),
            "iteration": int(getattr(self.model, "iteration", 0)),
            "swaps": self.swaps,
            "queue_depth": self.engine.queue_depth(),
            "warmed_buckets": list(self.engine.warmed_buckets),
            "total_forwards": self.engine.total_forwards,
            "total_shed": self.engine.total_shed,
            "total_batch_failures": self.engine.total_batch_failures,
            "tier": self.tier,
            "weight": self.weight,
            "batch_timeout_ms": float(self.engine.batch_timeout_ms),
            "precision": self.precision,
        }
        if self.group is not None:
            out["fused_group"] = self.group.name
        if self.breaker is not None:
            out["breaker"] = self.breaker.describe()
        return out


class ModelPool:
    """Thread-safe name → ModelEntry routing table + swap protocol."""

    def __init__(self, scheduler: Optional[DeviceScheduler] = None):
        self._lock = threading.Lock()
        self._entries: Dict[str, ModelEntry] = {}
        # Cross-entry device arbitration (serving/scheduler.py). None
        # until a caller passes one or an add() names a non-default
        # tier/weight — a pool that never does keeps the exact
        # pre-scheduler behavior.
        self.scheduler = scheduler
        # Weakly-referenced scrape collector: queue depth is sampled at
        # scrape time only (never in the request path), and a dead pool
        # silently drops out of the scrape.
        wr = weakref.ref(self)

        def _collect(reg, _wr=wr):
            pool = _wr()
            if pool is None:
                return
            g = reg.gauge("serving_queue_depth",
                          "Requests queued per served model")
            bg = reg.gauge("serving_breaker_state",
                           "Circuit breaker state per model (0=closed, "
                           "1=open, 2=half_open)")
            for e in pool.entries():
                g.labels(model=e.name).set(e.engine.queue_depth())
                if e.breaker is not None:
                    bg.labels(model=e.name).set(
                        STATE_VALUES[e.breaker.state])

        registry().register_collector(_collect)

    # ----------------------------------------------------------- scheduling
    def _ensure_scheduler(self) -> DeviceScheduler:
        """Create the shared DeviceScheduler on first demand and
        retro-register every existing entry at its recorded tier/weight
        (entries added before any priority was expressed default to
        standard/1.0 — the same arbitration-neutral values)."""
        if self.scheduler is None:
            self.scheduler = DeviceScheduler()
            for e in self.entries():
                self._sched_register(e)
        return self.scheduler

    def _sched_register(self, entry: ModelEntry) -> None:
        """Register one entry (or its fused group) with the scheduler
        and point its engine at the shared dispatch slot. A fused
        group's members schedule as ONE unit under the group name."""
        sch = self.scheduler
        if sch is None:
            return
        sched_name = entry.group.name if entry.group is not None \
            else entry.name
        sch.register(sched_name, tier=entry.tier, weight=entry.weight,
                     depth_fn=entry.engine.queue_depth)
        entry.engine.scheduler = sch
        entry.engine.sched_name = sched_name

    # ------------------------------------------------------------- routing
    def _serving_families(self):
        """The per-engine telemetry families (registry dedups by name)."""
        reg = registry()
        return (
            reg.counter(
                "serving_shed_total",
                "Requests shed before a forward served them, by reason"),
            reg.counter("serving_forwards_total",
                        "Coalesced forward passes executed"),
            reg.counter("serving_rows_total",
                        "Real (un-padded) request rows served"),
            reg.histogram(
                "serving_batch_rows",
                "Real rows per coalesced forward (bucket fill)"),
            reg.counter(
                "serving_batch_failures_total",
                "Coalesced forwards that raised or returned non-finite "
                "outputs"),
        )

    def _wire_hooks(self, entry: ModelEntry) -> None:
        """Engine-level telemetry hooks for a single-model entry: late
        (in-queue) deadline sheds, per-forward batch stats, and batch
        failures, labeled by model; breaker success/failure per
        forward."""
        shed_c, fwd_c, rows_c, fill_h, fail_c = self._serving_families()
        name, breaker = entry.name, entry.breaker

        def _on_shed(req, reason, _name=name):
            shed_c.labels(model=_name, reason=reason).inc()

        def _on_batch(reqs, rows, bucket, dur_s, _name=name,
                      _entry=entry, _breaker=breaker):
            fwd_c.labels(model=_name).inc()
            rows_c.labels(model=_name).inc(rows)
            fill_h.labels(model=_name).observe(rows)
            _breaker.record_success()
            if (_entry.golden_batch is None and reqs
                    and getattr(reqs[0], "x", None) is not None):
                # Retain a slice of real traffic as the swap canary
                # input (first served request, at most 4 rows). Decode
                # requests carry prompts, not feature rows — no capture.
                _entry.golden_batch = np.asarray(reqs[0].x[:4]).copy()

        def _on_batch_error(exc, n_requests, _name=name, _breaker=breaker):
            fail_c.labels(model=_name).inc()
            _breaker.record_failure(
                trip=isinstance(exc, NonFiniteOutputError))

        entry.engine.on_shed = _on_shed
        entry.engine.on_batch = _on_batch
        entry.engine.on_batch_error = _on_batch_error

    def add(self, name: str, model, *, checkpoints=None,
            batch_limit: int = 32, queue_limit: int = 256,
            batch_timeout_ms: float = 2.0,
            inference_mode: InferenceMode = InferenceMode.BATCHED,
            check_finite: bool = True,
            breaker: Optional[CircuitBreaker] = None,
            breaker_threshold: int = 5,
            breaker_reset_s: float = 30.0,
            golden_batch=None,
            canary_max_drift: Optional[float] = None,
            packed_admission: bool = False,
            pack_bucket: int = 0,
            tier: str = "standard",
            weight: float = 1.0) -> ModelEntry:
        """Register an init()ed model under `name` behind a fresh
        continuous-batching engine. `checkpoints` (a CheckpointManager
        or a directory path) enables hot-swap for this entry.

        Resilience knobs: `check_finite` fails a
        forward whose outputs carry NaN/Inf (on by default for served
        entries — the breaker's instant trip); `breaker` (or
        `breaker_threshold`/`breaker_reset_s` for the default one)
        guards this entry's /predict path; `golden_batch` seeds the
        swap canary input (otherwise the first served request's rows
        are retained); `canary_max_drift` bounds output drift a swap
        may introduce on the golden batch (None = finiteness only);
        `packed_admission`/`pack_bucket` coalesce short sequence
        requests into one segment-masked [1, pack_bucket] row (the
        model's attention layers must run packed_segments=True).

        Priority knobs: `tier`
        (critical/standard/batch) and `weight` (WFQ share within the
        tier) rank this entry against its pool-mates under saturation.
        Naming a non-default tier or weight creates the pool's shared
        DeviceScheduler on the spot (and retro-registers every existing
        entry); all-default pools never construct one and keep the
        exact single-model dispatch path."""
        if tier not in TIER_VALUES:
            raise ValueError(f"unknown tier {tier!r}; one of "
                             f"{tuple(TIER_VALUES)}")
        if isinstance(checkpoints, (str, os.PathLike)):
            from ..optimize.resilience import CheckpointManager
            checkpoints = CheckpointManager(checkpoints)
        engine = ParallelInference(
            model, inference_mode=inference_mode, batch_limit=batch_limit,
            queue_limit=queue_limit, batch_timeout_ms=batch_timeout_ms,
            check_finite=check_finite, packed_admission=packed_admission,
            pack_bucket=pack_bucket)
        if breaker is None:
            breaker = CircuitBreaker(name,
                                     failure_threshold=breaker_threshold,
                                     reset_timeout_s=breaker_reset_s)
        entry = ModelEntry(name, model, engine, checkpoints,
                           breaker=breaker, golden_batch=golden_batch,
                           canary_max_drift=canary_max_drift,
                           tier=tier, weight=weight)
        self._wire_hooks(entry)
        with self._lock:
            if name in self._entries:
                raise ValueError(f"model {name!r} already registered")
            self._entries[name] = entry
        _set_precision_gauge(name, entry.precision)
        if (self.scheduler is not None or tier != "standard"
                or weight != 1.0):
            self._ensure_scheduler()
            self._sched_register(entry)
        return entry

    def add_decode(self, name: str, model, *, checkpoints=None,
                   max_decode_batch: int = 8, queue_limit: int = 64,
                   max_context: Optional[int] = None,
                   pack_bucket: int = 64,
                   kv_block_tokens: int = 16,
                   kv_max_blocks: int = 256,
                   feature_dim: Optional[int] = None,
                   check_finite: bool = True,
                   breaker: Optional[CircuitBreaker] = None,
                   breaker_threshold: int = 5,
                   breaker_reset_s: float = 30.0,
                   tier: str = "standard",
                   weight: float = 1.0) -> ModelEntry:
        """Register a GENERATIVE entry under `name` behind a
        DecodeEngine (serving/decode.py): token-granularity continuous
        batching over a paged KV cache, served through POST /generate.

        The model family picks the adapter: a
        :class:`~.decode.TransformerDecoder` decodes through the
        packed-prefill + paged-KV token arm (`pack_bucket`,
        `kv_block_tokens`, `kv_max_blocks` size that plane); a streaming
        network exposing ``rnn_time_step`` decodes through the
        recurrent arm (`feature_dim` is its per-step input width —
        required, and the net's ``n_out`` must equal it, since the
        output feeds back as the next step's input).

        Breaker / tier / weight / checkpoint knobs mean exactly what
        they mean on :meth:`add` — the entry rides the same routing
        table, swap protocol (the engine's ``swap_warm`` re-warms the
        decode signature grid inside the pause window), and describe()
        surface."""
        from .decode import (DecodeEngine, PagedKVCache, RecurrentAdapter,
                             TransformerAdapter, TransformerDecoder)
        if tier not in TIER_VALUES:
            raise ValueError(f"unknown tier {tier!r}; one of "
                             f"{tuple(TIER_VALUES)}")
        if isinstance(checkpoints, (str, os.PathLike)):
            from ..optimize.resilience import CheckpointManager
            checkpoints = CheckpointManager(checkpoints)
        if isinstance(model, TransformerDecoder):
            cache = PagedKVCache(
                layers=model.n_layers, heads=model.heads,
                head_dim=model.head_dim,
                block_tokens=kv_block_tokens, max_blocks=kv_max_blocks,
                device=model.device)
            adapter = TransformerAdapter(model, cache,
                                         pack_bucket=pack_bucket,
                                         check_finite=check_finite)
        elif hasattr(model, "rnn_time_step"):
            if feature_dim is None:
                raise ValueError(
                    "recurrent decode entries need feature_dim= (the "
                    "net's per-step input width)")
            adapter = RecurrentAdapter(model, feature_dim=feature_dim,
                                       check_finite=check_finite)
        else:
            raise ValueError(
                f"model {type(model).__name__} fits neither decode arm: "
                "need a TransformerDecoder or a streaming net with "
                "rnn_time_step")
        engine = DecodeEngine(adapter, name=name,
                              max_decode_batch=max_decode_batch,
                              queue_limit=queue_limit,
                              max_context=max_context,
                              device=adapter.device)
        if breaker is None:
            breaker = CircuitBreaker(name,
                                     failure_threshold=breaker_threshold,
                                     reset_timeout_s=breaker_reset_s)
        entry = ModelEntry(name, model, engine, checkpoints,
                           breaker=breaker, tier=tier, weight=weight)
        self._wire_hooks(entry)
        with self._lock:
            if name in self._entries:
                engine.shutdown()
                raise ValueError(f"model {name!r} already registered")
            self._entries[name] = entry
        _set_precision_gauge(name, entry.precision)
        if (self.scheduler is not None or tier != "standard"
                or weight != 1.0):
            self._ensure_scheduler()
            self._sched_register(entry)
        return entry

    def add_fused_group(self, group_name: str, members, *,
                        checkpoints: Optional[Dict[str, Any]] = None,
                        batch_limit: int = 32, queue_limit: int = 256,
                        batch_timeout_ms: float = 2.0,
                        breaker_threshold: int = 5,
                        breaker_reset_s: float = 30.0,
                        canary_max_drift: Optional[float] = None,
                        tier: str = "standard", weight: float = 1.0):
        """Register N same-input-geometry models as ONE fused pool
        entry group: their graphs merge
        into a single channel-concatenated forward
        (nn/graph/fusion.build_fused_serving_net) behind ONE shared
        continuous-batching engine, each member's traffic rides the
        shared batch, and each member's output columns are sliced back
        under its own name — hot-swap, canary, checkpoints, and circuit
        breakers stay PER MEMBER.

        `members` is an ordered name → model mapping (or a list of
        (name, model) pairs); `checkpoints` maps member names to their
        CheckpointManagers / directories. The group schedules as one
        WFQ unit under `group_name` at `tier`/`weight`.

        Fallback rule: when the member set cannot merge (not graphs,
        differing input geometry, uninitialized members), every member
        is registered as an ordinary independent entry instead —
        counted in `serving_fused_fallback_total{reason="ineligible"}`
        — and the list of independent entries is returned. On success
        the :class:`FusedModelGroup` is returned."""
        from ..nn.graph.fusion import FusionIneligibleError
        named = list(members.items()) if isinstance(members, dict) \
            else list(members)
        ckpts = checkpoints or {}
        with self._lock:
            for nm, _ in named:
                if nm in self._entries:
                    raise ValueError(f"model {nm!r} already registered")
        try:
            group = FusedModelGroup(
                self, group_name, named, checkpoints=ckpts,
                batch_limit=batch_limit, queue_limit=queue_limit,
                batch_timeout_ms=batch_timeout_ms,
                breaker_threshold=breaker_threshold,
                breaker_reset_s=breaker_reset_s,
                canary_max_drift=canary_max_drift,
                tier=tier, weight=weight)
        except FusionIneligibleError as e:
            _fused_fallback_counter("ineligible", len(named))
            entries = [self.add(nm, m, checkpoints=ckpts.get(nm),
                                batch_limit=batch_limit,
                                queue_limit=queue_limit,
                                batch_timeout_ms=batch_timeout_ms,
                                breaker_threshold=breaker_threshold,
                                breaker_reset_s=breaker_reset_s,
                                canary_max_drift=canary_max_drift,
                                tier=tier, weight=weight)
                       for nm, m in named]
            for entry in entries:
                entry.fused_fallback = str(e)
            return entries
        with self._lock:
            for nm, _ in named:
                if nm in self._entries:  # raced a concurrent add
                    group.engine.shutdown()
                    raise ValueError(f"model {nm!r} already registered")
            for entry in group.member_entries():
                self._entries[entry.name] = entry
        if (self.scheduler is not None or tier != "standard"
                or weight != 1.0):
            self._ensure_scheduler()
            self._sched_register(group.member_entries()[0])
        return group

    def eject_member(self, name: str) -> ModelEntry:
        """Fall one member back to per-model dispatch (swap-state or
        behavior divergence): the member leaves its fused group and gets
        its own independent engine; the group rebuilds around the
        remaining members, or dissolves entirely when fewer than two
        remain. Counted in `serving_fused_fallback_total`."""
        entry = self.get(name)
        if entry.group is None:
            raise ValueError(f"model {name!r} is not in a fused group")
        return entry.group.eject(name)

    def reconfigure(self, name: str, *,
                    packed_admission: Optional[bool] = None,
                    pack_bucket: Optional[int] = None,
                    tier: Optional[str] = None,
                    weight: Optional[float] = None,
                    batch_timeout_ms: Optional[float] = None,
                    breaker_threshold: Optional[int] = None,
                    breaker_reset_s: Optional[float] = None
                    ) -> Dict[str, Any]:
        """Live per-entry reconfiguration (the gateway's POST /config
        surface and the AutoTuner's per-entry actuator). Tier/weight
        changes re-rank the entry in the shared scheduler (creating it
        on first use); `batch_timeout_ms` (the collector linger) is a
        plain live set — the collector thread reads it every iteration,
        so the next coalescing window already honors it, no engine
        rebuild; `breaker_threshold`/`breaker_reset_s`
        retune the entry's circuit breaker in place
        (CircuitBreaker.reconfigure — validated, effective on the next
        admission decision); packed-admission changes rebuild the
        entry's engine with the new admission mode — the old engine
        drains its queue, the new one is warmed to the old bucket set
        first, and no queued request is dropped. Fused-group members
        cannot be reconfigured in place (eject_member first)."""
        entry = self.get(name)
        if entry.group is not None:
            raise ValueError(
                f"model {name!r} is a member of fused group "
                f"{entry.group.name!r}; eject_member() it before "
                "reconfiguring")
        changed: List[str] = []
        if breaker_threshold is not None or breaker_reset_s is not None:
            if entry.breaker is None:
                raise ValueError(
                    f"model {name!r} has no circuit breaker to "
                    "reconfigure")
            entry.breaker.reconfigure(failure_threshold=breaker_threshold,
                                      reset_timeout_s=breaker_reset_s)
            if breaker_threshold is not None:
                changed.append("breaker_threshold")
            if breaker_reset_s is not None:
                changed.append("breaker_reset_s")
        if batch_timeout_ms is not None:
            bt = float(batch_timeout_ms)
            if bt < 0:
                raise ValueError("batch_timeout_ms must be >= 0")
            entry.engine.batch_timeout_ms = bt
            changed.append("batch_timeout_ms")
        if tier is not None or weight is not None:
            if tier is not None:
                if tier not in TIER_VALUES:
                    raise ValueError(f"unknown tier {tier!r}; one of "
                                     f"{tuple(TIER_VALUES)}")
                entry.tier = tier
                changed.append("tier")
            if weight is not None:
                if float(weight) <= 0:
                    raise ValueError("weight must be > 0")
                entry.weight = float(weight)
                changed.append("weight")
            self._ensure_scheduler()
            self._sched_register(entry)
        if packed_admission is not None or pack_bucket is not None:
            old = entry.engine
            packed = old.packed_admission if packed_admission is None \
                else bool(packed_admission)
            bucket = old.pack_bucket if pack_bucket is None \
                else int(pack_bucket)
            engine = ParallelInference(
                entry.model, inference_mode=old.inference_mode,
                batch_limit=old.batch_limit,
                batch_timeout_ms=old.batch_timeout_ms,
                queue_limit=old._queue.maxsize,
                check_finite=old.check_finite,
                packed_admission=packed, pack_bucket=bucket)
            if old.warmed_buckets:
                # Warm the replacement BEFORE it takes traffic (only a
                # new packed signature meets new kernels, once, here).
                engine.warmup(max_bucket=max(old.warmed_buckets))
            entry.engine = engine
            self._wire_hooks(entry)
            self._sched_register(entry)
            old.shutdown()
            changed.append("packed_admission")
        out = entry.describe()
        out["reconfigured"] = changed
        return out

    def reconfigure_scheduler(self, **knobs) -> Dict[str, Any]:
        """Scheduler-level live reconfiguration (quantum / shed_depth /
        starvation_budget / tier_slo_ms — DeviceScheduler.reconfigure),
        creating the shared scheduler on first use so an operator can
        set SLOs before any tiered entry exists. Raises ValueError on
        invalid values, mutating nothing."""
        return self._ensure_scheduler().reconfigure(**knobs)

    def get(self, name: str) -> ModelEntry:
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise KeyError(f"no model named {name!r} in the pool "
                           f"(have: {sorted(self.names())})")
        return entry

    def remove(self, name: str) -> None:
        with self._lock:
            entry = self._entries.get(name)
            if entry is not None and entry.group is not None:
                raise ValueError(
                    f"model {name!r} is a member of fused group "
                    f"{entry.group.name!r}; eject_member() it first")
            self._entries.pop(name, None)
        if entry is not None:
            entry.engine.shutdown()

    def names(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def entries(self) -> List[ModelEntry]:
        with self._lock:
            return list(self._entries.values())

    def describe(self) -> List[Dict[str, Any]]:
        return [e.describe() for e in self.entries()]

    # -------------------------------------------------------------- warmup
    def warmup(self, name: Optional[str] = None, *,
               max_bucket: Optional[int] = None,
               time_steps: Optional[int] = None) -> "ModelPool":
        """Run every pow2 bucket once for one model (or all): after this
        the first request at any bucket finds its kernels built and
        cuDNN's choices made."""
        targets = [self.get(name)] if name else self.entries()
        for e in targets:
            e.engine.warmup(max_bucket=max_bucket, time_steps=time_steps)
        return self

    # ---------------------------------------------------------------- swap
    def swap(self, name: str, *, manager=None,
             time_steps: Optional[int] = None,
             quantize: Optional[str] = None) -> Dict[str, Any]:
        """Checkpoint-gated zero-downtime hot-swap (module docstring
        protocol). Returns {"swapped": bool, "model", "file",
        "iteration", "precision"}; raises :class:`SwapError` when the
        gate or the warm fails (old params keep serving either way).

        `quantize` ("int8" | "bf16" | "fp32"/None) makes quantization a
        DEPLOYMENT decision: the decoded fp32 checkpoint is quantized
        via quantize.quantize_tree before promotion, and the golden-
        batch canary compares the quantized outputs against the
        currently-serving ones under `canary_max_drift` — a quantized
        tree that drifts past the accuracy budget is rolled back with
        the `canary_rejected` outcome exactly like a bad checkpoint."""
        target = quantize or "fp32"
        if target not in PRECISIONS:
            _swap_counter(name, "failed", target)
            raise SwapError(f"unknown quantize mode {quantize!r}; one of "
                            f"{PRECISIONS}")
        entry = self.get(name)
        if entry.group is not None:
            # Fused-group member: the group owns the swap protocol (the
            # fused trees must be rebuilt under the SHARED engine's
            # pause). /swap stays per-member for callers either way.
            return entry.group.swap_member(name, manager=manager,
                                           time_steps=time_steps,
                                           quantize=quantize)
        mgr = manager or entry.checkpoints
        if mgr is None:
            _swap_counter(name, "failed", target)
            raise SwapError(f"model {name!r} has no CheckpointManager "
                            "attached — nothing to swap from")
        rec = mgr.latest_valid()
        if rec is None:
            _swap_counter(name, "failed", target)
            raise SwapError(
                f"no valid checkpoint in {mgr.directory!r} — manifest "
                "empty or every entry torn/corrupt")
        if (rec.get("file") and rec.get("file") == entry.version.get("file")
                and target == entry.precision):
            # Same file AND same precision: re-quantizing the serving
            # checkpoint to a different precision is a real swap.
            _swap_counter(name, "noop", target)
            return {"swapped": False, "model": name, "file": rec["file"],
                    "iteration": rec.get("iteration", 0),
                    "precision": entry.precision,
                    "reason": "already serving this checkpoint"}
        path = os.path.join(mgr.directory, rec["file"])
        model = entry.model
        with tracing.span("serve/swap", cat="serve", model=name,
                          file=rec.get("file")):
            # Decode + device-stage OUTSIDE the execution lock: traffic
            # keeps flowing while the npz trees are read. The live trees
            # are the templates, so a config/architecture drift fails
            # here — before anything was mutated. (Chaos seam:
            # "serve.decode" exercises exactly this pre-mutation path.)
            try:
                faults.fire("serve.decode")
                meta = validate_checkpoint(path)
                # Checkpoints are always fp32: when the LIVE tree is
                # quantized, the decode template is its dequantized
                # shape (same structure as the published file).
                params_template = model.params_tree
                if entry.precision != "fp32":
                    params_template = quantize_mod.dequantize_tree(
                        params_template)
                with zipfile.ZipFile(path, "r") as zf:
                    new_params = _npz_bytes_to_tree(
                        _read_entry(zf, path, PARAMS_ENTRY),
                        params_template, model.device)
                    new_state = _npz_bytes_to_tree(
                        _read_entry(zf, path, STATE_ENTRY),
                        model.state_tree, model.device)
                if target != "fp32":
                    # Quantize OFF the hot path, before the pause: the
                    # engine keeps serving old params while per-channel
                    # scales are computed.
                    new_params = quantize_mod.quantize_tree(
                        new_params, target)
                # the staged copies (and the quantization) are complete
                # before the pause can hand them to a forward
                _sync(model.device)
            except (CheckpointCorruptError, ValueError,
                    quantize_mod.AlreadyQuantizedError,
                    faults.FaultInjected) as e:
                _swap_counter(name, "failed", target)
                raise SwapError(
                    f"checkpoint {rec.get('file')!r} cannot serve model "
                    f"{name!r}: {e}") from e
            old = (model.params_tree, model.state_tree,
                   int(model.iteration), int(model.epoch))
            buckets = list(entry.engine.warmed_buckets) or [1]
            golden = entry.golden_batch
            # The pause window is the stall every queued request feels
            # (their sched_wait phase) — record it as its own span so a
            # serving-trace tail reads "swap in progress", not mystery.
            with tracing.span("serve/swap_pause", cat="serve",
                              model=name), entry.engine.paused():
                old_out = None
                if golden is not None:
                    # The canary reference: OLD params' outputs on the
                    # retained golden batch, computed inside the pause
                    # window so no concurrent forward interleaves.
                    try:
                        old_out = _golden_forward(model, golden)
                    except Exception:
                        old_out = None  # old model already broken:
                        # canary degrades to the finiteness check
                model.params_tree = new_params
                model.state_tree = new_state
                model.iteration = int(meta.get("iteration", old[2]))
                model.epoch = int(meta.get("epoch", old[3]))
                if hasattr(model, "_rnn_carry"):
                    model._rnn_carry = None
                try:
                    # Warm the new params at every warmed bucket (the
                    # shapes are unchanged: the kernels are built).
                    # Decode engines warm their own (row × KV view) grid.
                    swap_warm = getattr(entry.engine, "swap_warm", None)
                    for b in buckets:
                        faults.fire("swap.warm")
                        if swap_warm is not None:
                            swap_warm(b)
                        else:
                            model.warmup(b, time_steps=time_steps)
                    # Canary gate: the new params must produce all-finite
                    # outputs on the golden batch (and, with
                    # canary_max_drift set, stay within the drift budget
                    # of the old outputs) BEFORE traffic resumes.
                    if golden is not None:
                        new_out = _golden_forward(model, golden)
                        if not np.isfinite(new_out).all():
                            raise _CanaryRejected(
                                "non-finite outputs on the golden batch")
                        drift_cap = entry.canary_max_drift
                        if (drift_cap is not None and old_out is not None
                                and np.isfinite(old_out).all()):
                            drift = float(np.max(np.abs(
                                new_out - old_out))) if new_out.size else 0.0
                            if drift > drift_cap:
                                raise _CanaryRejected(
                                    f"golden-batch output drift {drift:.6g} "
                                    f"exceeds canary_max_drift {drift_cap}")
                except Exception as e:
                    # Auto-rollback: restore the OLD trees (the tensors
                    # that were serving, bitwise) before the pause lock
                    # releases — traffic never sees the rejected
                    # checkpoint.
                    (model.params_tree, model.state_tree,
                     model.iteration, model.epoch) = old
                    if hasattr(model, "_rnn_carry"):
                        model._rnn_carry = None
                    canary = isinstance(e, _CanaryRejected)
                    _swap_counter(
                        name, "canary_rejected" if canary else "failed",
                        target)
                    what = ("canary gate rejected"
                            if canary else "warm forward failed on")
                    raise SwapError(
                        f"{what} {rec.get('file')!r} (precision "
                        f"{target}); rolled back to previous params: "
                        f"{e}") from e
        with self._lock:
            entry.version = dict(rec)
            entry.swaps += 1
            entry.precision = target
        _set_precision_gauge(name, target)
        _swap_counter(name, "ok", target)
        return {"swapped": True, "model": name, "file": rec.get("file"),
                "iteration": rec.get("iteration", 0),
                "precision": target}

    # ------------------------------------------------------------ lifecycle
    def shutdown(self) -> None:
        for e in self.entries():
            e.engine.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


class FusedModelGroup:
    """N co-resident same-input-geometry models behind ONE forward.

    The members' graphs are merged (nn/graph/fusion.merge_serving_conf)
    and sibling-fused into a single channel-concatenated network: one
    shared continuous-batching engine coalesces EVERY member's traffic
    into the same batch, runs one dispatch, and each request's transform
    slices its member's columns back out. One dispatch + one coalescing
    window serving N models is the multi-model throughput win.

    Per-member semantics are preserved:

    - **Breakers** — each member keeps its own CircuitBreaker. Success
      is recorded by the member's column transform on its normal path;
      failures are attributed through ``err.request_tags`` (only the
      members whose requests rode the failed forward are charged), and
      a member whose columns turn non-finite trips ONLY its own breaker
      (the fused engine runs check_finite=False; finiteness is judged
      per member column slice).
    - **Hot-swap / canary / checkpoints** — :meth:`swap_member` runs the
      full pool swap protocol for one member: decode against the SOLO
      member trees (the source of truth), rebuild the fused trees under
      the shared engine's pause, warm at the warmed buckets (the shapes
      are unchanged), and gate on a member-column golden
      canary with rollback of both solo and fused trees.
    - **Fallback** — an ineligible member set never reaches this class
      (ModelPool.add_fused_group registers independents instead), and
      :meth:`eject` returns one divergent member to per-model dispatch
      at runtime, rebuilding or dissolving the group.
    """

    def __init__(self, pool: ModelPool, name: str, named_members,
                 *, checkpoints: Dict[str, Any], batch_limit: int,
                 queue_limit: int, batch_timeout_ms: float,
                 breaker_threshold: int, breaker_reset_s: float,
                 canary_max_drift: Optional[float],
                 tier: str, weight: float):
        from ..nn.graph import fusion
        if tier not in TIER_VALUES:
            raise ValueError(f"unknown tier {tier!r}; one of "
                             f"{tuple(TIER_VALUES)}")
        self.pool = pool
        self.name = name
        self.tier = tier
        self.weight = float(weight)
        self._engine_kw = dict(batch_limit=batch_limit,
                               queue_limit=queue_limit,
                               batch_timeout_ms=batch_timeout_ms)
        self._breaker_kw = dict(failure_threshold=breaker_threshold,
                                reset_timeout_s=breaker_reset_s)
        self.members = [nm for nm, _ in named_members]
        self._models = {nm: m for nm, m in named_members}
        # Raises FusionIneligibleError on divergent members — the
        # caller's fallback-to-independent seam.
        self.fused_net, self.fusion_groups, self.col_slices = \
            fusion.build_fused_serving_net(named_members)
        # One engine for the whole group. check_finite stays OFF at the
        # engine level: a NaN in one member's columns must trip that
        # member's breaker only, so finiteness is judged per slice in
        # the member transforms below.
        self.engine = ParallelInference(self.fused_net,
                                        check_finite=False,
                                        **self._engine_kw)
        self._entries: Dict[str, ModelEntry] = {}
        for nm, model in named_members:
            ck = checkpoints.get(nm)
            if isinstance(ck, (str, os.PathLike)):
                from ..optimize.resilience import CheckpointManager
                ck = CheckpointManager(ck)
            entry = ModelEntry(
                nm, model, self.engine, ck,
                breaker=CircuitBreaker(nm, **self._breaker_kw),
                canary_max_drift=canary_max_drift,
                tier=tier, weight=weight)
            entry.group = self
            entry.transform = self._member_transform(nm, entry.breaker)
            self._entries[nm] = entry
        self._wire_group_hooks()

    # ------------------------------------------------------------ plumbing
    def member_entries(self) -> List[ModelEntry]:
        return [self._entries[nm] for nm in self.members]

    def named_members(self):
        return [(nm, self._models[nm]) for nm in self.members]

    def _member_transform(self, name: str, breaker: CircuitBreaker):
        """Column view for one member: slice its columns out of the
        fused output, fail THIS request (and trip THIS breaker, via the
        tagged error path) when they are non-finite, record breaker
        success otherwise."""
        def _t(rows, _name=name, _breaker=breaker):
            off, width = self.col_slices[_name]
            cols = np.asarray(rows)[..., off:off + width]
            if not np.isfinite(cols).all():
                raise NonFiniteOutputError(
                    f"fused member {_name!r} produced non-finite output "
                    "columns")
            _breaker.record_success()
            return cols
        return _t

    def _wire_group_hooks(self) -> None:
        """Shared-engine telemetry: batch stats label the GROUP (one
        forward serves many members); sheds label the member that owned
        the request; failures are attributed to member breakers through
        the error's request_tags."""
        shed_c, fwd_c, rows_c, fill_h, fail_c = \
            self.pool._serving_families()

        def _on_shed(req, reason, _g=self.name):
            shed_c.labels(model=req.tag or _g, reason=reason).inc()

        def _on_batch(reqs, rows, bucket, dur_s, _g=self.name):
            fwd_c.labels(model=_g).inc()
            rows_c.labels(model=_g).inc(rows)
            fill_h.labels(model=_g).observe(rows)
            for r in reqs:
                e = self._entries.get(r.tag)
                if e is not None and e.golden_batch is None:
                    # Retain per-member canary input from real traffic.
                    e.golden_batch = np.asarray(r.x[:4]).copy()

        def _on_batch_error(exc, n_requests, _g=self.name):
            fail_c.labels(model=_g).inc()
            trip = isinstance(exc, NonFiniteOutputError)
            tags = getattr(exc, "request_tags", None) or []
            charged = set()
            for tag in tags:
                e = self._entries.get(tag)
                if e is not None and tag not in charged:
                    charged.add(tag)
                    e.breaker.record_failure(trip=trip)

        self.engine.on_shed = _on_shed
        self.engine.on_batch = _on_batch
        self.engine.on_batch_error = _on_batch_error

    # ---------------------------------------------------------------- swap
    def swap_member(self, name: str, *, manager=None,
                    time_steps: Optional[int] = None,
                    quantize: Optional[str] = None) -> Dict[str, Any]:
        """Per-member checkpoint hot-swap inside the fused group: the
        ModelPool.swap protocol with the fused forward as the execution
        substrate. The member's SOLO model stays the decode template and
        source of truth; under the shared engine's pause the solo trees
        mutate, the fused trees rebuild from ALL members' current trees
        (a concatenation), the warmed buckets re-run through the fused
        net, and a member-column canary gates
        promotion. Rollback restores both solo and fused trees, so
        neither this member nor its groupmates ever see half-swapped
        params."""
        entry = self._entries.get(name)
        if entry is None:
            raise KeyError(f"no member {name!r} in fused group "
                           f"{self.name!r}")
        if quantize and quantize != "fp32":
            # The fused forward runs ONE channel-concatenated weight
            # per layer; a single member at a different precision would
            # force per-member splits back into the fused matmul.
            # Quantize the whole group or serve the member solo.
            _swap_counter(name, "failed", quantize)
            raise SwapError(
                f"quantized swap is per-model; member {name!r} of fused "
                f"group {self.name!r} cannot change precision alone "
                "(eject it or serve it unfused)")
        mgr = manager or entry.checkpoints
        if mgr is None:
            _swap_counter(name, "failed")
            raise SwapError(f"model {name!r} has no CheckpointManager "
                            "attached — nothing to swap from")
        rec = mgr.latest_valid()
        if rec is None:
            _swap_counter(name, "failed")
            raise SwapError(
                f"no valid checkpoint in {mgr.directory!r} — manifest "
                "empty or every entry torn/corrupt")
        if rec.get("file") and rec.get("file") == entry.version.get("file"):
            _swap_counter(name, "noop")
            return {"swapped": False, "model": name, "file": rec["file"],
                    "iteration": rec.get("iteration", 0),
                    "reason": "already serving this checkpoint"}
        from ..nn.graph.fusion import fused_trees_from_members
        path = os.path.join(mgr.directory, rec["file"])
        model = entry.model  # the member's SOLO network
        fused = self.fused_net
        with tracing.span("serve/swap", cat="serve", model=name,
                          group=self.name, file=rec.get("file")):
            try:
                faults.fire("serve.decode")
                meta = validate_checkpoint(path)
                with zipfile.ZipFile(path, "r") as zf:
                    new_params = _npz_bytes_to_tree(
                        _read_entry(zf, path, PARAMS_ENTRY),
                        model.params_tree, model.device)
                    new_state = _npz_bytes_to_tree(
                        _read_entry(zf, path, STATE_ENTRY),
                        model.state_tree, model.device)
                _sync(model.device)
            except (CheckpointCorruptError, ValueError,
                    faults.FaultInjected) as e:
                _swap_counter(name, "failed")
                raise SwapError(
                    f"checkpoint {rec.get('file')!r} cannot serve model "
                    f"{name!r}: {e}") from e
            old_solo = (model.params_tree, model.state_tree,
                        int(model.iteration), int(model.epoch))
            old_fused = (fused.params_tree, fused.state_tree)
            buckets = list(self.engine.warmed_buckets) or [1]
            golden = entry.golden_batch
            off, width = self.col_slices[name]
            with tracing.span("serve/swap_pause", cat="serve",
                              model=name), self.engine.paused():
                old_cols = None
                if golden is not None:
                    try:
                        old_cols = _golden_forward(
                            fused, golden)[..., off:off + width]
                    except Exception:
                        old_cols = None  # degrade to finiteness check
                model.params_tree = new_params
                model.state_tree = new_state
                model.iteration = int(meta.get("iteration", old_solo[2]))
                model.epoch = int(meta.get("epoch", old_solo[3]))
                try:
                    # Rebuild the fused trees from every member's
                    # CURRENT solo trees — pure concat, the fused
                    # net keeps its shapes.
                    fused.params_tree, fused.state_tree = \
                        fused_trees_from_members(self.fusion_groups,
                                                 self.named_members(),
                                                 order=fused._layer_nodes)
                    for b in buckets:
                        faults.fire("swap.warm")
                        fused.warmup(b, time_steps=time_steps)
                    if golden is not None:
                        new_cols = _golden_forward(
                            fused, golden)[..., off:off + width]
                        if not np.isfinite(new_cols).all():
                            raise _CanaryRejected(
                                "non-finite member columns on the "
                                "golden batch")
                        drift_cap = entry.canary_max_drift
                        if (drift_cap is not None and old_cols is not None
                                and np.isfinite(old_cols).all()):
                            drift = float(np.max(np.abs(
                                new_cols - old_cols))) \
                                if new_cols.size else 0.0
                            if drift > drift_cap:
                                raise _CanaryRejected(
                                    f"member-column drift {drift:.6g} "
                                    "exceeds canary_max_drift "
                                    f"{drift_cap}")
                except Exception as e:
                    (model.params_tree, model.state_tree,
                     model.iteration, model.epoch) = old_solo
                    fused.params_tree, fused.state_tree = old_fused
                    canary = isinstance(e, _CanaryRejected)
                    _swap_counter(
                        name, "canary_rejected" if canary else "failed")
                    what = ("canary gate rejected"
                            if canary else "warm forward failed on")
                    raise SwapError(
                        f"{what} {rec.get('file')!r}; rolled back to "
                        f"previous params: {e}") from e
        entry.version = dict(rec)
        entry.swaps += 1
        _swap_counter(name, "ok")
        return {"swapped": True, "model": name, "file": rec.get("file"),
                "iteration": rec.get("iteration", 0)}

    # --------------------------------------------------------------- eject
    def eject(self, name: str) -> ModelEntry:
        """Return one member to independent per-model dispatch and
        rebuild the group around the remaining members (dissolving it
        entirely below two). The ejected member keeps its breaker,
        checkpoints, canary state, and pool name; it gets a fresh
        engine warmed to the group's bucket set. Queued requests on the
        old shared engine are served by its shutdown drain."""
        if name not in self._entries:
            raise KeyError(f"no member {name!r} in fused group "
                           f"{self.name!r}")
        pool = self.pool
        old_engine = self.engine
        warm_top = max(old_engine.warmed_buckets) \
            if old_engine.warmed_buckets else None

        def _independent(entry: ModelEntry) -> None:
            entry.group = None
            entry.transform = None
            entry.engine = ParallelInference(
                entry.model, check_finite=True, **self._engine_kw)
            if warm_top:
                entry.engine.warmup(max_bucket=warm_top)
            pool._wire_hooks(entry)
            pool._sched_register(entry)

        ejected = self._entries.pop(name)
        self.members.remove(name)
        self._models.pop(name)
        _independent(ejected)
        _fused_fallback_counter("ejected")
        if len(self.members) >= 2:
            # Rebuild the fused substrate around the survivors: new
            # merged net, new engine (the old executables baked the
            # departed member's columns in).
            from ..nn.graph import fusion
            self.fused_net, self.fusion_groups, self.col_slices = \
                fusion.build_fused_serving_net(self.named_members())
            self.engine = ParallelInference(self.fused_net,
                                            check_finite=False,
                                            **self._engine_kw)
            if warm_top:
                self.engine.warmup(max_bucket=warm_top)
            for nm in self.members:
                e = self._entries[nm]
                e.engine = self.engine
                e.transform = self._member_transform(nm, e.breaker)
                pool._sched_register(e)
            self._wire_group_hooks()
        else:
            # One member left: a fused group of one is just overhead.
            for nm in list(self.members):
                e = self._entries.pop(nm)
                self.members.remove(nm)
                self._models.pop(nm)
                _independent(e)
                _fused_fallback_counter("dissolved")
            if pool.scheduler is not None:
                pool.scheduler.unregister(self.name)
        old_engine.shutdown()
        return ejected

    def describe(self) -> Dict[str, Any]:
        return {
            "group": self.name,
            "members": list(self.members),
            "col_slices": {nm: list(self.col_slices[nm])
                           for nm in self.members},
            "tier": self.tier,
            "weight": self.weight,
            "total_forwards": self.engine.total_forwards,
            "queue_depth": self.engine.queue_depth(),
            "fused_nodes": [g.fused_name for g in self.fusion_groups],
        }
