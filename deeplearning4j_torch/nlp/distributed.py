"""Sharded Word2Vec with device-side pair generation: the device-corpus engine.

Port of `deeplearning4j_tpu/nlp/distributed.py` (reference
AggregateSkipGram, SkipGram.java:176-283, and dl4j-spark-nlp's Word2Vec).
The indexed corpus is uploaded to the device once, as int32, and every step
makes its pairs there: dynamic windows, sentence-boundary masking,
frequent-word subsampling and negative sampling, then the skip-gram
negative-sampling update on the rows the chunk touches. One call runs
`steps_per_call` chunks in a Python loop (the JAX package's `lax.scan`),
with the learning rates computed on the host as there.

Each chunk draws, from a `torch.Generator` on the device seeded `seed + 1`,
in this order: the window `b` in 1..window for every position, the keep
uniforms `u` [chunk, 2W+1] (column 0 the center's, the rest its contexts'),
and the negatives' positions in the unigram table [chunk, negative]. These
are not `jax.random`'s draws, so the chunk itself is a pure function of
them (`one_chunk`), which the tests feed the JAX package's own draws.

The JAX package's documented divergences from the host-pair engine hold
here too: subsampling drops a token as center and context without closing
the window over it; negatives are drawn per center and shared across its
contexts, the negative term weighted by the center's valid-context count
m; one chunk is one averaged step for every row it touches.

A mesh (`parallel/mesh.py:Mesh`) splits each chunk's positions over its
shards, as the JAX package shards the position axis: the chunk's random
numbers are drawn once, for the whole chunk, and sliced per shard; the
touch counts are summed over every shard before any division (the shards
meet there); and every replica of the tables applies the same summed
update, every shard's rows. The contributions to a row are summed before
they reach the table (`embeddings.segment_sum`), so a frequent word's row
takes one rounding a chunk, not one for each of its thousands of slots. A device may stand in the mesh more than once
(several shards on one device share its replica).

A mesh may span the processes of a `torch.distributed` group (gloo, or
NCCL where each rank has its own GPU), as the JAX package's mesh spans
hosts. Every process holds a replica of the tables on each of its devices,
draws the whole chunk's numbers from the same seeded generator, and runs
its own shards. The touch counts are all-reduced over the group (they are
sums of whole numbers, so the sum is exact in any order), and each shard's
(rows, contributions) are all-gathered before the segment sum, in mesh
order, so every process applies to every replica the update the
one-process mesh would: bitwise where the devices sum in a fixed order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..nn import shards as shards_lib
from ..parallel.mesh import Mesh, is_multiprocess, process_index
from ..utils.device import DeviceLike, canonical, resolve_device
from . import embeddings
from .vocab import VocabCache, unigram_table


@dataclass
class Replica:
    """What one device holds: the tables and the corpus with its lookups."""

    tables: Dict[str, torch.Tensor]
    corpus: torch.Tensor        # [n] int32 token ids
    sent: torch.Tensor          # [n] int32 sentence ids
    keep: torch.Tensor          # [V] float32 keep probability
    unigram: torch.Tensor       # [table] int32 negative-sampling table


def chunk_pairs(rep: Replica, idx: torch.Tensor, b, u, window: int):
    """The pairs of positions `idx` [c]: (centers [c], contexts [c, 2W],
    valid [c, 2W]). A pair is valid inside the center's drawn window b,
    inside the corpus and its sentence, and where both tokens survive
    subsampling (u [c, 2W+1] against their keep probabilities)."""
    corpus, sent = rep.corpus, rep.sent
    n = corpus.shape[0]
    offs = torch.cat([torch.arange(-window, 0),      # [2W], the center excluded
                      torch.arange(1, window + 1)]).to(idx.device)
    idx_c = idx.clamp_max(n - 1)
    centers = corpus[idx_c].long()                        # [c]
    P = idx[:, None] + offs[None, :]                      # [c, 2W]
    Pc = P.clamp(0, n - 1)
    contexts = corpus[Pc].long()                          # [c, 2W]
    same_sent = sent[Pc] == sent[idx_c][:, None]
    valid = ((offs.abs()[None, :] <= b[:, None]) & (P >= 0) & (P < n)
             & same_sent & (idx < n)[:, None])
    keep_ctr = u[:, 0] < rep.keep[centers]
    keep_ctx = u[:, 1:] < rep.keep[contexts]
    return centers, contexts, valid & keep_ctr[:, None] & keep_ctx


def shard_grads(rep: Replica, idx: torch.Tensor, b, u, neg_pos, window: int):
    """One shard's part of a chunk, on its replica's device, from the
    tables as they were before the chunk: its positions `idx` [c] and their
    draws (b [c], u [c, 2W+1], neg_pos [c, K]). Returns the undivided
    gradient contributions with the slots they go to, the shard's own touch
    counts, and its loss sum and valid-pair count."""
    syn0, syn1neg = rep.tables["syn0"], rep.tables["syn1neg"]
    centers, contexts, valid = chunk_pairs(rep, idx, b, u, window)
    negs = rep.unigram[neg_pos.long()].long()             # [c, K]
    m = valid.float().sum(1)                              # [c]
    h = syn0[centers]                                     # [c, D]
    pos = syn1neg[contexts]                               # [c, 2W, D]
    neg = syn1neg[negs]                                   # [c, K, D]
    vm = valid.to(h.dtype)
    pos_score = torch.einsum("cd,cwd->cw", h, pos)
    neg_score = torch.einsum("cd,ckd->ck", h, neg)
    mk = m.to(h.dtype)[:, None]
    loss = -((F.logsigmoid(pos_score) * vm).sum()
             + (F.logsigmoid(-neg_score) * mk).sum())
    d_pos = -torch.sigmoid(-pos_score) * vm               # [c, 2W]
    d_neg = torch.sigmoid(neg_score) * mk                 # [c, K]
    gh = torch.einsum("cw,cwd->cd", d_pos, pos) + torch.einsum("ck,ckd->cd", d_neg, neg)
    D = h.shape[-1]
    g1 = torch.cat([(d_pos[..., None] * h[:, None, :]).reshape(-1, D),
                    (d_neg[..., None] * h[:, None, :]).reshape(-1, D)])
    syn1_idx = torch.cat([contexts.reshape(-1), negs.reshape(-1)])
    syn1_w = torch.cat([valid.float().reshape(-1),
                        m.repeat_interleave(negs.shape[1])])
    V = syn0.shape[0]
    return {"centers": centers, "gh": gh, "syn1_idx": syn1_idx, "g1": g1,
            "syn0_counts": torch.zeros(V, dtype=torch.float32,
                                       device=idx.device).index_add_(0, centers, m),
            "syn1_counts": torch.zeros(V, dtype=torch.float32,
                                       device=idx.device).index_add_(0, syn1_idx, syn1_w),
            "loss": loss.float(), "pairs": valid.float().sum()}


def meet_counts(parts: List[dict], group=None) -> List[dict]:
    """Each shard's view of the chunk's touch counts: the sum over every
    shard (the update averages a row over all the chunk's slots that touch
    it, wherever they were computed), of every process of `group` too."""
    out = []
    for p in parts:
        dev = p["syn0_counts"].device
        out.append({k: sum((q[k].to(dev) for q in parts[1:]), parts[0][k].to(dev))
                    for k in ("syn0_counts", "syn1_counts")})
    if group is not None:
        host = shards_lib._host_staged(group)
        both = torch.cat([out[0]["syn0_counts"], out[0]["syn1_counts"]])
        wire = shards_lib._wire(both, host)
        group.allreduce([wire]).wait()
        V = out[0]["syn0_counts"].shape[0]
        for c in out:
            whole = wire.to(c["syn0_counts"].device)
            c["syn0_counts"], c["syn1_counts"] = whole[:V], whole[V:]
    return out


def one_chunk(replicas: Dict[torch.device, Replica], shard_devices: Sequence,
              start: int, lr, b, u, neg_pos, window: int, *,
              positions: Optional[Sequence[int]] = None,
              owners: Optional[Sequence[int]] = None,
              group=None) -> torch.Tensor:
    """One chunk of `b.shape[0]` positions from `start`, split evenly over
    the mesh's shards, applied in place to every replica's tables; returns
    loss / valid pairs.

    `shard_devices` are this process's shards (one entry a shard, keys of
    `replicas`), at mesh `positions` (default 0, 1, ...). Across processes
    `owners` names the process of every mesh position and `group` is the
    process group: the counts meet and the updates are gathered over it.

    Pure in the draws: b [chunk] (windows in 1..W), u [chunk, 2W+1] (keep
    uniforms), neg_pos [chunk, K] (unigram table positions), sliced per
    shard."""
    chunk = b.shape[0]
    positions = list(range(len(shard_devices))) if positions is None \
        else list(positions)
    total = len(positions) if owners is None else len(owners)
    per = chunk // total
    parts = []
    for s, dev in zip(positions, shard_devices):
        sl = slice(s * per, (s + 1) * per)
        idx = start + torch.arange(s * per, (s + 1) * per, device=dev)
        parts.append(shard_grads(replicas[dev], idx, b[sl].to(dev), u[sl].to(dev),
                                 neg_pos[sl].to(dev), window))
    counts = meet_counts(parts, group)
    updates = {"syn0": [], "syn1neg": []}
    for p, c in zip(parts, counts):
        gh = p["gh"].float() / c["syn0_counts"][p["centers"]].clamp_min(1.0)[:, None]
        g1 = p["g1"].float() / c["syn1_counts"][p["syn1_idx"]].clamp_min(1.0)[:, None]
        updates["syn0"].append((p["centers"], -lr * gh))
        updates["syn1neg"].append((p["syn1_idx"], -lr * g1))
    first = shard_devices[0]
    losses, pairs = [p["loss"] for p in parts], [p["pairs"] for p in parts]
    if group is not None:   # every shard's part, in mesh order
        gather = lambda ts: shards_lib.gather_positions(ts, group, owners, first,
                                                        kind="word2vec")
        for name, ups in updates.items():
            updates[name] = list(zip(gather([i for i, _ in ups]),
                                     gather([d for _, d in ups])))
        losses, pairs = gather(losses), gather(pairs)
    for dev, rep in replicas.items():
        for name, ups in updates.items():
            table = rep.tables[name]
            rows, sums = embeddings.segment_sum(
                torch.cat([i.to(dev) for i, _ in ups]),
                torch.cat([d.to(dev) for _, d in ups]), table.shape[0])
            table.index_add_(0, rows, sums.to(table.dtype))
    loss = sum(t.to(first) for t in losses)
    pairs = sum(t.to(first) for t in pairs)
    return loss / pairs.clamp_min(1.0)


class ShardedWord2Vec:
    """Device-corpus skip-gram/NS trainer, optionally sharded over a mesh
    (see the module docstring). `device` None means CUDA; with a mesh the
    mesh's devices are used, this process's own. A mesh that spans
    processes meets over `process_group` (default: the whole
    `torch.distributed` group)."""

    def __init__(self, cache: VocabCache, layer_size: int = 100,
                 window: int = 5, negative: int = 5,
                 learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4, chunk: int = 2048,
                 steps_per_call: int = 8, sampling: float = 0.0,
                 seed: int = 42, mesh: Optional[Mesh] = None,
                 dtype=torch.float32, device: DeviceLike = None,
                 process_group=None):
        if negative <= 0:
            raise NotImplementedError(
                "ShardedWord2Vec trains negative sampling; use "
                "BatchedEmbeddingTrainer for hierarchical softmax")
        self.cache = cache
        self.layer_size = int(layer_size)
        self.window = int(window)
        self.negative = int(negative)
        self.lr = float(learning_rate)
        self.min_lr = float(min_learning_rate)
        self.chunk = int(chunk)
        self.steps_per_call = int(steps_per_call)
        self.sampling = float(sampling)
        self.seed = int(seed)
        self.mesh = mesh
        self._group, self._positions, self._owners = None, None, None
        if mesh is not None:
            self._group = process_group if process_group is not None else (
                torch.distributed.group.WORLD if is_multiprocess(mesh) else None)
            rank = self._group.rank() if self._group is not None \
                else process_index()
            self._positions = [i for i, p in enumerate(mesh.processes)
                               if p == rank]
            if self._group is None and len(self._positions) != mesh.size:
                raise ValueError(
                    "the mesh's devices span processes: initialize "
                    "torch.distributed or pass process_group")
            if self._group is not None:
                self._owners = list(mesh.processes)
                per_rank = {self._owners.count(r) for r in range(self._group.size())}
                if len(per_rank) != 1:
                    raise ValueError(
                        "every process must hold the same number of mesh "
                        f"positions; the mesh's owners are {self._owners}")
            self._shard_devices = [canonical(mesh.devices[i])
                                   for i in self._positions]
        else:
            self._shard_devices = [canonical(resolve_device(device))]
        self.device = self._shard_devices[0]
        V, D = len(cache), self.layer_size
        self._dtype = dtype
        syn0 = embeddings.init_syn0(seed, V, D, dtype, self.device)
        self._unigram = unigram_table(cache)
        # keep-probability per word (word2vec subsampling formula);
        # sampling=0 keeps everything
        if self.sampling > 0:
            total = max(1, cache.total_word_count)
            freqs = np.array(
                [cache.words[w].count / total for w in cache.index2word],
                np.float32)
            keep = np.minimum(1.0, np.sqrt(self.sampling / freqs)
                              + self.sampling / freqs)
        else:
            keep = np.ones(V, np.float32)
        self._keep = np.asarray(keep, np.float32)
        if mesh is not None and self.chunk % mesh.size:
            raise ValueError(f"chunk={self.chunk} must divide evenly over "
                             f"the {mesh.size}-device mesh")
        self._replicas: Dict[torch.device, Replica] = {}
        for dev in dict.fromkeys(self._shard_devices):
            self._replicas[dev] = Replica(
                {"syn0": syn0.to(dev, copy=dev != self.device),
                 "syn1neg": torch.zeros((V, D), dtype=dtype, device=dev)},
                None, None, torch.as_tensor(self._keep, device=dev),
                torch.as_tensor(self._unigram.astype(np.int32), device=dev))
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        self._corpus_host = None
        self.last_losses = None

    @property
    def tables(self) -> Dict[str, torch.Tensor]:
        """The first shard's replica of {"syn0", "syn1neg"}."""
        return self._replicas[self.device].tables

    @tables.setter
    def tables(self, tables: Dict[str, torch.Tensor]) -> None:
        """Every replica takes a copy of `tables`, in the trainer's dtype."""
        for dev, rep in self._replicas.items():
            rep.tables = {k: v.to(dev, self._dtype, copy=True).contiguous()
                          for k, v in tables.items()}

    def _draw(self):
        """The chunk's random numbers, in order: windows, keep uniforms,
        negatives' table positions."""
        dev, gen, C, W = self.device, self._gen, self.chunk, self.window
        b = torch.randint(1, W + 1, (C,), generator=gen, device=dev)
        u = torch.rand((C, 2 * W + 1), generator=gen, device=dev)
        neg_pos = torch.randint(0, len(self._unigram), (C, self.negative),
                                generator=gen, device=dev)
        return b, u, neg_pos

    def _device_corpus(self, token_ids, sent_ids):
        token_ids = np.ascontiguousarray(token_ids, np.int32)
        sent_ids = np.ascontiguousarray(sent_ids, np.int32)
        if token_ids.shape != sent_ids.shape or token_ids.ndim != 1:
            raise ValueError("token_ids/sent_ids must be equal 1-D arrays")
        # device-resident: uploaded once and kept while its CONTENT is the
        # same (a pointer-based key would falsely hit when numpy reuses a
        # freed buffer's address for a fresh corpus)
        cached = self._corpus_host
        if cached is None or not (
                np.array_equal(cached[0], token_ids)
                and np.array_equal(cached[1], sent_ids)):
            for dev, rep in self._replicas.items():
                rep.corpus = torch.as_tensor(token_ids, device=dev)
                rep.sent = torch.as_tensor(sent_ids, device=dev)
            self._corpus_host = (token_ids.copy(), sent_ids.copy())
        rep = self._replicas[self.device]
        return rep.corpus, rep.sent

    def _call(self, starts: Sequence[int], lrs: np.ndarray) -> torch.Tensor:
        """One call: a chunk from each start at its learning rate; returns
        the per-chunk losses [steps] on the first shard's device."""
        losses = []
        for start, lr in zip(starts, lrs):
            b, u, neg_pos = self._draw()
            losses.append(one_chunk(self._replicas, self._shard_devices, int(start),
                                    float(lr), b, u, neg_pos, self.window,
                                    positions=self._positions, owners=self._owners,
                                    group=self._group))
        return torch.stack(losses)

    def fit_corpus(self, token_ids: np.ndarray, sent_ids: np.ndarray,
                   epochs: int = 1) -> "ShardedWord2Vec":
        """Train over a flat indexed corpus. `sent_ids[i]` tags the
        sentence of token i (windows never cross a boundary)."""
        corpus, _ = self._device_corpus(token_ids, sent_ids)
        n = int(corpus.shape[0])
        spc = self.chunk * self.steps_per_call
        calls = max(1, -(-n // spc))
        total_steps = max(1, epochs * calls * self.steps_per_call)
        step = 0
        for _ in range(epochs):
            for c in range(calls):
                starts = np.arange(self.steps_per_call,
                                   dtype=np.int32) * self.chunk + c * spc
                lrs = np.maximum(
                    self.min_lr,
                    self.lr * (1.0 - (step + np.arange(
                        self.steps_per_call)) / total_steps)
                ).astype(np.float32)
                self.last_losses = self._call(starts, lrs)
                step += self.steps_per_call
        return self

    def vectors(self) -> np.ndarray:
        return self.tables["syn0"].detach().float().cpu().numpy()


def corpus_arrays(indexed_sentences):
    """[sentence arrays] -> (flat token ids, sentence ids) for
    fit_corpus."""
    if not indexed_sentences:
        return (np.empty(0, np.int32), np.empty(0, np.int32))
    toks = np.concatenate([np.asarray(s, np.int32)
                           for s in indexed_sentences])
    sids = np.concatenate([np.full(len(s), i, np.int32)
                           for i, s in enumerate(indexed_sentences)])
    return toks, sids
