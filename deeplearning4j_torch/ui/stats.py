"""Training observability: StatsListener -> StatsStorage pipeline.

Port of `deeplearning4j_tpu/ui/stats.py` (reference deeplearning4j-ui-model's
BaseStatsListener: per-iteration score, timings, memory, parameter
histograms, mean magnitudes and update magnitudes, routed through the
StatsStorage contract into InMemoryStatsStorage / FileStatsStorage).
Records are plain JSON; `FileStatsStorage` writes the JAX package's
JSON-lines format, so either package reads the other's file.

The statistics are computed where the parameters live. The JAX listener
copies every leaf to the host on every reported iteration (and keeps a host
copy of each for the update magnitudes); on full-width AlexNet that is about
250 MB out of the card each step. This listener keeps the previous
parameters on the device, computes the mean magnitudes, the update
magnitudes and the histograms there, and brings the small results to the
host in one transfer per record: a vector of the score, the magnitudes and
the histogram counts. With histograms on, one transfer of every leaf's min
and max comes first, since the bin edges are made on the host.

Histograms count exactly as ``np.histogram(leaf, bins)`` does: the edges are
numpy's own (``np.histogram_bin_edges`` of the leaf's min and max, in the
leaf's type, so a constant leaf gets (min - 0.5, max + 0.5)), and the device
runs numpy's bucketing: the scaled estimate, then its one-bin corrections
against those exact edges, the last bin closed. bfloat16 and float16 leaves
are counted in float32.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..optimize import metrics as metrics_mod
from ..optimize.listeners import IterationListener


# ---------------------------------------------------------------------------
# Storage (reference api/storage/StatsStorage.java)
# ---------------------------------------------------------------------------
class StatsStorage:
    """SPI: session-keyed append-only update records."""

    def put_update(self, session_id: str, record: Dict[str, Any]) -> None:
        raise NotImplementedError

    def list_session_ids(self) -> List[str]:
        raise NotImplementedError

    def get_updates(self, session_id: str) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def get_latest_update(self, session_id: str) -> Optional[Dict[str, Any]]:
        ups = self.get_updates(session_id)
        return ups[-1] if ups else None


class InMemoryStatsStorage(StatsStorage):
    """Reference ui/storage/InMemoryStatsStorage.java."""

    def __init__(self):
        self._updates: Dict[str, List[Dict[str, Any]]] = {}

    def put_update(self, session_id, record):
        self._updates.setdefault(session_id, []).append(record)

    def list_session_ids(self):
        return list(self._updates)

    def get_updates(self, session_id):
        return list(self._updates.get(session_id, []))


class FileStatsStorage(StatsStorage):
    """JSON-lines file persistence (reference ui/storage/FileStatsStorage):
    one ``{"session": id, **record}`` object a line."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def put_update(self, session_id, record):
        with open(self.path, "a") as f:
            f.write(json.dumps({"session": session_id, **record}) + "\n")

    def _read(self) -> List[Dict[str, Any]]:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]

    def list_session_ids(self):
        seen = []
        for rec in self._read():
            if rec["session"] not in seen:
                seen.append(rec["session"])
        return seen

    def get_updates(self, session_id):
        return [{k: v for k, v in rec.items() if k != "session"}
                for rec in self._read() if rec["session"] == session_id]


# ---------------------------------------------------------------------------
# Listener (reference ui/stats/BaseStatsListener.java)
# ---------------------------------------------------------------------------
class StatsUpdateConfiguration:
    """What to collect per update (reference
    DefaultStatsUpdateConfiguration builder)."""

    def __init__(self, *, collect_score: bool = True,
                 collect_timings: bool = True,
                 collect_memory: bool = True,
                 collect_histograms: bool = False,
                 histogram_bins: int = 20,
                 collect_mean_magnitudes: bool = True,
                 collect_updates: bool = False):
        self.collect_score = collect_score
        self.collect_timings = collect_timings
        self.collect_memory = collect_memory
        self.collect_histograms = collect_histograms
        self.histogram_bins = int(histogram_bins)
        self.collect_mean_magnitudes = collect_mean_magnitudes
        self.collect_updates = collect_updates


def _named_params(model):
    """(name, tensor) over the model's parameter tree, named as the JAX
    package names them: ``node/param`` for a graph, ``layer<i>/param`` for
    a MultiLayerNetwork."""
    tree = model.params_tree
    items = tree.items() if isinstance(tree, dict) else \
        ((f"layer{i}", p) for i, p in enumerate(tree))
    for node, params in items:
        for pname, arr in params.items():
            if not isinstance(arr, torch.Tensor):
                raise TypeError(f"StatsListener needs tensor leaves; "
                                f"{node}/{pname} is {type(arr).__name__}")
            yield f"{node}/{pname}", arr.detach()


def _counted(t: torch.Tensor) -> torch.Tensor:
    """The leaf as the statistics see it: half types upcast to float32."""
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


def histogram_edges(mn, mx, dtype, bins: int) -> np.ndarray:
    """``np.histogram``'s edges for a leaf of numpy type `dtype` whose min
    and max are `mn` and `mx`: numpy's own computation on a two-element
    array that has the leaf's min, max and type. Raises numpy's ValueError
    for a non-finite range."""
    return np.histogram_bin_edges(np.array([mn, mx], dtype), bins=bins)


#: Counters each bin is spread over while counting: the elements of a leaf
#: add into lanes * bins slots (element i into lane i % lanes), so atomic
#: adds from neighbouring threads do not queue on one address. With one
#: slot a bin, the atomics took 7.6 of a record's 11.0 device ms on
#: full-width AlexNet (NVIDIA H100 80GB HBM3, 700 W).
HISTOGRAM_LANES = 1024


def histogram_counts(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """int64 counts of `x` over `edges` (on `x`'s device, in the edges'
    type), bucketed as numpy's uniform-bin ``np.histogram`` buckets: the
    estimate ``(v - first) / (last - first) * bins`` truncated, the last
    edge folded into the last bin, then one step down where the value lies
    below its bin's lower edge and one step up where it reaches the next
    edge (except in the last bin, which is closed). No host sync."""
    bins = edges.numel() - 1
    v = x.reshape(-1).to(edges.dtype)
    first, last = edges[0], edges[-1]
    # v <= last, so the estimate is at most bins, which folds into bins - 1
    idx = ((v - first) / (last - first) * bins).to(torch.int64).clamp_(max=bins - 1)
    idx -= (v < edges[idx]).to(torch.int64)
    idx += ((v >= edges[idx + 1]) & (idx != bins - 1)).to(torch.int64)
    lane = torch.arange(idx.numel(), device=x.device) % HISTOGRAM_LANES
    slots = torch.zeros(HISTOGRAM_LANES * bins, dtype=torch.int64, device=x.device)
    slots.scatter_add_(0, idx.add_(lane.mul_(bins)), torch.ones_like(idx))
    return slots.view(HISTOGRAM_LANES, bins).sum(0)


class StatsListener(IterationListener):
    """Collects per-iteration training statistics into a StatsStorage
    (reference StatsListener/BaseStatsListener). Attach with
    net.add_listener(StatsListener(storage)).

    `last_host_bytes` and `last_transfers` say what the last record brought
    to the host (bytes, device-to-host copies)."""

    def __init__(self, storage: StatsStorage, frequency: int = 1,
                 session_id: Optional[str] = None,
                 config: Optional[StatsUpdateConfiguration] = None):
        self.storage = storage
        self.frequency = max(1, int(frequency))
        self.session_id = session_id or f"session-{int(time.time() * 1000)}"
        self.config = config or StatsUpdateConfiguration()
        self._last_time: Optional[float] = None
        #: name -> the leaf at the last record, on its device
        self._prev_params: Optional[Dict[str, torch.Tensor]] = None
        self.last_host_bytes = 0
        self.last_transfers = 0

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        out = t.cpu().numpy()
        self.last_host_bytes += out.nbytes
        self.last_transfers += 1
        return out

    def _leaf_stats(self, model, leaves):
        """(mean magnitudes, histograms, update magnitudes, score) of one
        record: every number computed on the leaves' device and brought to
        the host together with the score."""
        cfg = self.config
        names = [n for n, _ in leaves]
        xs = [_counted(t) for _, t in leaves]
        parts: List[torch.Tensor] = []
        score = model.score_value if cfg.collect_score else None
        score_on_device = isinstance(score, torch.Tensor)
        if score_on_device:
            parts.append(score.detach().reshape(1).to(torch.float64))
        if cfg.collect_mean_magnitudes:
            parts.extend(torch.mean(x.abs(), dtype=torch.float64).reshape(1)
                         for x in xs)
        upd_names = []
        if cfg.collect_updates and self._prev_params is not None:
            upd_names = [n for n in names if n in self._prev_params]
            parts.extend(torch.mean((x - self._prev_params[n]).abs(),
                                    dtype=torch.float64).reshape(1)
                         for n, x in zip(names, xs) if n in self._prev_params)
        edges = []
        if cfg.collect_histograms and xs:
            ranges = self._to_host(torch.stack(
                [m.to(torch.float64) for x in xs for m in torch.aminmax(x)]))
            edges = [histogram_edges(ranges[2 * i], ranges[2 * i + 1],
                                     _numpy_dtype(x.dtype),
                                     cfg.histogram_bins)
                     for i, x in enumerate(xs)]
            parts.extend(histogram_counts(x, e).to(torch.float64)
                         for x, e in zip(xs, _edges_on(edges, xs[0].device)))
        flat = self._to_host(torch.cat(parts)) if parts else np.zeros(0)
        pos = 0
        if score_on_device:
            score, pos = float(flat[0]), 1
        mm: Dict[str, float] = {}
        if cfg.collect_mean_magnitudes:
            mm = dict(zip(names, flat[pos:pos + len(names)].tolist()))
            pos += len(names)
        upd = dict(zip(upd_names, flat[pos:pos + len(upd_names)].tolist()))
        pos += len(upd_names)
        hists: Dict[str, Any] = {}
        for name, e in zip(names, edges):
            counts = flat[pos:pos + cfg.histogram_bins].astype(np.int64)
            pos += cfg.histogram_bins
            hists[name] = {"counts": counts.tolist(),
                           "min": float(e[0]), "max": float(e[-1])}
        if cfg.collect_updates:
            self._prev_params = {n: x.clone() for n, x in zip(names, xs)}
        return mm, hists, upd, score

    def iteration_done(self, model, iteration: int) -> None:
        now = time.time()
        duration_ms = None if self._last_time is None \
            else (now - self._last_time) * 1000.0
        self._last_time = now
        if iteration % self.frequency != 0:
            return
        cfg = self.config
        self.last_host_bytes = self.last_transfers = 0
        leaves = []
        if cfg.collect_mean_magnitudes or cfg.collect_histograms or \
                cfg.collect_updates:
            leaves = list(_named_params(model))
        mm, hists, upd, score = self._leaf_stats(model, leaves)
        rec: Dict[str, Any] = {"iteration": int(iteration),
                               "timestamp": now}
        if cfg.collect_score:
            rec["score"] = float(score) if score is not None else None
        if cfg.collect_timings and duration_ms is not None:
            rec["iteration_ms"] = duration_ms
        if cfg.collect_memory:
            # host-side RSS, the JVM-heap analog
            rec["host_max_rss_mb"] = \
                metrics_mod.host_rss_bytes() / (1024.0 * 1024.0)
            devs = metrics_mod.device_memory_stats()
            if devs and devs[0]["bytes_in_use"]:
                rec["device_bytes_in_use"] = devs[0]["bytes_in_use"]
        if cfg.collect_mean_magnitudes:
            rec["param_mean_magnitudes"] = mm
        if cfg.collect_histograms:
            rec["param_histograms"] = hists
        if cfg.collect_updates and upd:
            rec["update_mean_magnitudes"] = upd
        self.storage.put_update(self.session_id, rec)

    def on_epoch_end(self, model, epoch: int) -> None:
        self.storage.put_update(self.session_id,
                                {"epoch_end": int(epoch),
                                 "iteration": int(model.iteration),
                                 "timestamp": time.time()})


def _numpy_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def _edges_on(edges: List[np.ndarray], device) -> List[torch.Tensor]:
    """Every leaf's edges on `device`, one copy for each edge type."""
    out: List[Optional[torch.Tensor]] = [None] * len(edges)
    for dt in {e.dtype for e in edges}:
        ids = [i for i, e in enumerate(edges) if e.dtype == dt]
        block = torch.as_tensor(np.stack([edges[i] for i in ids]),
                                device=device)
        for j, i in enumerate(ids):
            out[i] = block[j]
    return out
