"""Batched embedding training engine: the host-pair engine.

Port of `deeplearning4j_tpu/nlp/embeddings.py` (reference
models/sequencevectors/SequenceVectors.java:187-310, SkipGram.java:176-283,
CBOW.java, InMemoryLookupTable). Training pairs are generated on the host by
numpy, exactly as in the JAX package (same generator calls, same order), and
each batch runs as one device step: gather the rows the batch touches, take
the closed-form gradient of the negative-sampling or hierarchical-softmax
objective, and scatter-add the update into the tables (`index_add_`).

Update rule (the JAX package's, kept): the loss is SUMMED over pairs and
each table row's gradient is divided by the number of index slots touching
that row in the batch, so a row touched k times takes the average of its k
per-pair steps. The JAX package takes `jax.grad` with respect to the whole
tables and divides each row by its count (`_row_scale`), a dense V x D pass;
here the contributions are summed per touched row (`segment_sum`), divided
by the row's count and added: the same arithmetic on the touched rows only.
Counts follow `_row_scale`: padded slots (-1) count for nothing,
CBOW's syn0 counts run over its unmasked context slots, the NS output
counts over [target, negatives] and the HS output counts over the valid
points. Hierarchical softmax keeps word2vec.c's MAX_EXP skip: a code bit
whose |score| >= 6 contributes neither loss nor gradient.

The steps compute in the tables' dtype (float32, or bfloat16) and keep the
tables in it: each update is cast to the table's dtype before it is added.
(The JAX package's bfloat16 tables come out of their first step as float32,
promoted by the float32 learning rate.)
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import DeviceLike, resolve_device
from .vocab import VocabCache, unigram_table

MAX_EXP = 6.0


# ---------------------------------------------------------------------------
# Device steps
# ---------------------------------------------------------------------------


def row_counts(n_rows: int, indices: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[n_rows] float32 count of the index slots naming each row, each slot
    weighted by `weights` (a 0/1 mask of valid slots; -1 slots name row 0
    with weight 0), as the JAX package's `_row_scale` counts."""
    idx = indices.reshape(-1).clamp_min(0).long()
    w = torch.ones(idx.shape, dtype=torch.float32, device=idx.device) \
        if weights is None else weights.reshape(-1).float()
    return torch.zeros(n_rows, dtype=torch.float32, device=idx.device) \
        .index_add_(0, idx, w)


def segment_sum(indices: torch.Tensor, values: torch.Tensor, n_rows: int):
    """(rows [N], sums [N, D]) for N index slots naming rows of a table of
    `n_rows`: the distinct rows in ascending order, each with the float32
    sum of its slots' values, then filler entries whose sum is 0 (each
    naming some row, spread over the table). Adding `sums` at `rows` adds
    every value at its row, but each row takes one rounding instead of one
    per slot (a frequent word's row is touched thousands of times a
    chunk), with no host sync: the count of distinct rows stays on the
    device."""
    idx = indices.reshape(-1).long()
    n = idx.shape[0]
    vals = values.reshape(n, -1).float()
    ordered, perm = torch.sort(idx)
    first = torch.ones_like(ordered, dtype=torch.bool)
    first[1:] = ordered[1:] != ordered[:-1]
    seg = torch.cumsum(first, 0) - 1
    sums = torch.zeros_like(vals).index_add_(0, seg, vals[perm])
    rows = torch.arange(n, device=idx.device) % n_rows
    return rows.scatter_(0, seg, ordered), sums


def scatter_update(table: torch.Tensor, indices: torch.Tensor,
                   grads: torch.Tensor, counts: torch.Tensor, lr) -> None:
    """table[i] -= lr * (sum of the slots' g at i) / max(count[i], 1), in
    place: the JAX package's dense row-scaled step (`_row_scale`) on the
    rows the slots touch (padded -1 slots carry g = 0 into row 0)."""
    rows, gsum = segment_sum(indices.clamp_min(0), grads, table.shape[0])
    g = gsum / counts[rows].clamp_min(1.0)[:, None]
    table.index_add_(0, rows, (-lr * g).to(table.dtype))


def _predictor(syn0, centers, contexts, cbow: bool):
    """h [B, D] and, for CBOW, the context mask [B, W] and its row sums."""
    if not cbow:
        return syn0[centers.long()], None, None
    mask = (contexts >= 0).to(syn0.dtype)
    ctx = syn0[contexts.clamp_min(0).long()]
    denom = mask.sum(-1, keepdim=True).clamp_min(1.0)
    return (ctx * mask[..., None]).sum(1) / denom, mask, denom


def _predictor_update(syn0, centers, contexts, gh, lr, cbow, mask, denom):
    """Scatter the predictor's gradient gh [B, D] into syn0: onto the center
    rows (skip-gram), or over the context rows each weighted 1/denom
    (CBOW), counted as `_row_scale` counts them."""
    V = syn0.shape[0]
    if not cbow:
        scatter_update(syn0, centers, gh, row_counts(V, centers), lr)
        return
    g_ctx = (gh / denom)[:, None, :] * mask[..., None]
    scatter_update(syn0, contexts, g_ctx, row_counts(V, contexts, contexts >= 0),
                   lr)


def ns_grads(h, pos, neg):
    """Closed-form gradients of -(sum log s(h.pos) + sum log s(-h.neg)):
    (loss, d/dh [B, D], d/dpos [B, D], d/dneg [B, K, D]); the derivatives of
    log-sigmoid taken as the JAX package's autodiff takes them (s(-x))."""
    pos_score = (h * pos).sum(-1)
    neg_score = torch.einsum("bd,bkd->bk", h, neg)
    loss = -(F.logsigmoid(pos_score).sum() + F.logsigmoid(-neg_score).sum())
    d_pos = -torch.sigmoid(-pos_score)               # [B]
    d_neg = torch.sigmoid(neg_score)                 # [B, K]
    gh = d_pos[:, None] * pos + torch.einsum("bk,bkd->bd", d_neg, neg)
    return loss, gh, d_pos[:, None] * h, d_neg[..., None] * h[:, None, :]


def hs_grads(h, pts, codes, skip: bool = True):
    """Closed-form gradients of -sum log s((1 - 2 code) h.point) over the
    valid code bits (codes >= 0): (loss, d/dh [B, D], d/dpts [B, L, D]).
    With `skip`, a bit whose |score| >= MAX_EXP contributes nothing
    (word2vec.c's skip window)."""
    dtype = h.dtype
    cmask = (codes >= 0).to(dtype)
    score = torch.einsum("bd,bld->bl", h, pts)
    if skip:
        cmask = cmask * (score.abs() < MAX_EXP).to(dtype)
    sign = 1.0 - 2.0 * codes.clamp_min(0).to(dtype)
    loss = -(F.logsigmoid(sign * score) * cmask).sum()
    d_score = -sign * torch.sigmoid(-sign * score) * cmask   # [B, L]
    gh = torch.einsum("bl,bld->bd", d_score, pts)
    return loss, gh, d_score[..., None] * h[:, None, :]


def _ns_step(tables, centers, contexts, negatives, lr, cbow: bool = False):
    """One negative-sampling SGD step, in place on `tables` ({"syn0",
    "syn1neg"}); returns (tables, loss / batch).

    centers [B]; contexts [B] (skip-gram) or [B, W] with -1 padding (CBOW);
    negatives [B, K]."""
    syn0, syn1neg = tables["syn0"], tables["syn1neg"]
    h, mask, denom = _predictor(syn0, centers, contexts, cbow)
    tgt = centers if cbow else contexts
    pos = syn1neg[tgt.long()]
    neg = syn1neg[negatives.long()]
    loss, gh, g_pos, g_neg = ns_grads(h, pos, neg)
    syn1_idx = torch.cat([tgt.reshape(-1, 1).long(), negatives.long()], dim=1)
    g1 = torch.cat([g_pos[:, None, :], g_neg], dim=1)
    _predictor_update(syn0, centers, contexts, gh, lr, cbow, mask, denom)
    scatter_update(syn1neg, syn1_idx, g1, row_counts(syn1neg.shape[0], syn1_idx),
                   lr)
    return tables, loss / centers.shape[0]


def _hs_step(tables, centers, contexts, codes, points, lr, cbow: bool = False):
    """One hierarchical-softmax SGD step, in place on `tables` ({"syn0",
    "syn1"}); codes/points [B, L] with -1 padding; returns (tables,
    loss / batch)."""
    syn0, syn1 = tables["syn0"], tables["syn1"]
    h, mask, denom = _predictor(syn0, centers, contexts, cbow)
    pts = syn1[points.clamp_min(0).long()]
    loss, gh, g_pts = hs_grads(h, pts, codes)
    _predictor_update(syn0, centers, contexts, gh, lr, cbow, mask, denom)
    scatter_update(syn1, points, g_pts, row_counts(syn1.shape[0], points, codes >= 0),
                   lr)
    return tables, loss / centers.shape[0]


# ---------------------------------------------------------------------------
# Host-side pair generation (the JAX package's, unchanged)
# ---------------------------------------------------------------------------


def sentences_to_indices(sentences, cache: VocabCache):
    out = []
    for tokens in sentences:
        ids = [cache.index_of(t) for t in tokens]
        ids = [i for i in ids if i >= 0]
        if len(ids) > 1:
            out.append(np.array(ids, dtype=np.int32))
    return out


def subsample(ids: np.ndarray, cache: VocabCache, threshold: float,
              rng: np.random.Generator) -> np.ndarray:
    """Frequent-word subsampling (reference sampling, word2vec formula)."""
    if threshold <= 0:
        return ids
    total = max(1, cache.total_word_count)
    freqs = np.array([cache.words[cache.word_for_index(i)].count / total
                      for i in ids])
    keep_prob = np.minimum(1.0, np.sqrt(threshold / freqs)
                           + threshold / freqs)
    return ids[rng.random(len(ids)) < keep_prob]


def generate_pairs(indexed_sentences, window: int,
                   rng: np.random.Generator,
                   cache: Optional[VocabCache] = None,
                   sampling: float = 0.0):
    """(center, context) pairs with word2vec's random dynamic window,
    vectorized per sentence (row-major pos x offset order)."""
    centers, contexts = [], []
    offs = np.arange(-window, window + 1)
    for ids in indexed_sentences:
        if sampling > 0 and cache is not None:
            ids = subsample(ids, cache, sampling, rng)
        n = len(ids)
        if n < 2:
            continue
        b = rng.integers(1, window + 1, size=n)
        P = np.arange(n)[:, None] + offs[None, :]          # [n, 2w+1]
        valid = (np.abs(offs)[None, :] <= b[:, None]) & \
            (offs != 0)[None, :] & (P >= 0) & (P < n)
        centers.append(np.repeat(ids, valid.sum(1)))
        contexts.append(ids[P[valid]])
    if not centers:
        return (np.empty(0, np.int32), np.empty(0, np.int32))
    return (np.concatenate(centers).astype(np.int32),
            np.concatenate(contexts).astype(np.int32))


def generate_cbow(indexed_sentences, window: int, rng: np.random.Generator,
                  cache=None, sampling: float = 0.0):
    """(context-window [N, 2*window], center) with -1 padding at the
    invalid offset positions."""
    W = 2 * window
    offs = np.concatenate([np.arange(-window, 0), np.arange(1, window + 1)])
    ctxs, centers = [], []
    for ids in indexed_sentences:
        if sampling > 0 and cache is not None:
            ids = subsample(ids, cache, sampling, rng)
        n = len(ids)
        if n < 2:
            continue
        b = rng.integers(1, window + 1, size=n)
        P = np.arange(n)[:, None] + offs[None, :]          # [n, 2w]
        valid = (np.abs(offs)[None, :] <= b[:, None]) & (P >= 0) & (P < n)
        rows = np.where(valid, ids[np.clip(P, 0, n - 1)], -1).astype(np.int32)
        keep = valid.any(1)
        ctxs.append(rows[keep])
        centers.append(ids[keep])
    if not ctxs:
        return (np.empty((0, W), np.int32), np.empty(0, np.int32))
    return (np.concatenate(ctxs).astype(np.int32),
            np.concatenate(centers).astype(np.int32))


def codes_points_arrays(cache: VocabCache) -> Tuple[np.ndarray, np.ndarray]:
    """Pad huffman codes/points to [V, L] with -1 (for HS batch lookup)."""
    V = len(cache)
    L = max((len(cache.words[w].code) for w in cache.index2word), default=1)
    codes = np.full((V, L), -1, dtype=np.int32)
    points = np.full((V, L), -1, dtype=np.int32)
    for i, w in enumerate(cache.index2word):
        vw = cache.words[w]
        codes[i, :len(vw.code)] = vw.code
        points[i, :len(vw.points)] = vw.points
    return codes, points


def init_syn0(seed: int, V: int, D: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """syn0's init, U(-0.5/D, 0.5/D) (reference resetWeights), drawn on
    `device` from a generator seeded `seed`. The JAX package draws it with
    `jax.random.uniform(PRNGKey(seed), ...)`; tests replace this function by
    that draw, carried, to hold whole fits to it."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand((V, D), generator=gen, device=device, dtype=torch.float32)
    return (u * (1.0 / D) - 0.5 / D).to(dtype)


class BatchedEmbeddingTrainer:
    """Run epochs of batched NS/HS updates over host-generated pairs, on
    `device` (None: CUDA; raises without a GPU unless the CPU is named)."""

    def __init__(self, cache: VocabCache, layer_size: int = 100,
                 window: int = 5, negative: int = 5,
                 use_hierarchic_softmax: bool = False, cbow: bool = False,
                 learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4,
                 batch_size: int = 1024, sampling: float = 0.0,
                 seed: int = 42, dtype=torch.float32,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cache = cache
        self.layer_size = int(layer_size)
        self.window = int(window)
        self.negative = int(negative)
        self.use_hs = bool(use_hierarchic_softmax) or self.negative <= 0
        self.cbow = bool(cbow)
        self.lr = float(learning_rate)
        self.min_lr = float(min_learning_rate)
        self.batch_size = int(batch_size)
        self.sampling = float(sampling)
        self.seed = int(seed)
        V, D = len(cache), self.layer_size
        self.tables = {"syn0": init_syn0(seed, V, D, dtype, self.device)}
        if self.use_hs:
            self.tables["syn1"] = torch.zeros((max(V - 1, 1), D), dtype=dtype,
                                              device=self.device)
            self._codes, self._points = codes_points_arrays(cache)
            self._codes_dev = torch.as_tensor(self._codes, device=self.device)
            self._points_dev = torch.as_tensor(self._points, device=self.device)
        if self.negative > 0:
            self.tables["syn1neg"] = torch.zeros((V, D), dtype=dtype,
                                                 device=self.device)
            self._unigram = unigram_table(cache)
        self.last_loss = None

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def fit_sentences(self, indexed_sentences, epochs: int = 1):
        rng = np.random.default_rng(self.seed)
        total_steps = None
        step = 0
        for _ in range(epochs):
            if self.cbow:
                ctxs, centers = generate_cbow(
                    indexed_sentences, self.window, rng, self.cache,
                    self.sampling)
                order = rng.permutation(len(centers))
                ctx_all, centers = ctxs[order], centers[order]
                tgt = centers
            else:
                centers, contexts = generate_pairs(
                    indexed_sentences, self.window, rng, self.cache,
                    self.sampling)
                order = rng.permutation(len(centers))
                centers, ctx_all = centers[order], contexts[order]
                tgt = ctx_all
            n = len(centers)
            if n == 0:
                continue
            if total_steps is None:
                total_steps = max(1, epochs * (n // self.batch_size + 1))
            # the epoch's pairs cross to the device once; batches are views
            centers_d = self._to_device(centers)
            ctx_d = self._to_device(ctx_all)
            tgt_d = centers_d if self.cbow else ctx_d
            for start in range(0, n, self.batch_size):
                end = min(start + self.batch_size, n)
                lr = max(self.min_lr,
                         self.lr * (1.0 - step / max(1, total_steps)))
                lr = float(np.float32(lr))
                c, ctx = centers_d[start:end], ctx_d[start:end]
                # both objectives train in the same pass when HS and NS are
                # both on (reference SkipGram.java:176-283), HS first;
                # `loss` sums whichever ran
                loss = 0.0
                if self.use_hs:
                    t = tgt_d[start:end].long()
                    self.tables, hs_loss = _hs_step(
                        self.tables, c, ctx, self._codes_dev[t],
                        self._points_dev[t], lr, cbow=self.cbow)
                    loss = loss + hs_loss
                if self.negative > 0:
                    negs = rng.choice(self._unigram,
                                      size=(end - start, self.negative))
                    self.tables, ns_loss = _ns_step(
                        self.tables, c, ctx, self._to_device(negs), lr,
                        cbow=self.cbow)
                    loss = loss + ns_loss
                step += 1
            self.last_loss = float(loss)
        return self

    def vectors(self) -> np.ndarray:
        return self.tables["syn0"].detach().float().cpu().numpy()
