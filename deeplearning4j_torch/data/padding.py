"""Batch padding with bit-honest loss normalization, and sequence packing.

Port of `deeplearning4j_tpu/data/padding.py`. The zero-weight pad contract
is used wherever a batch grows to a canonical shape (pad-to-bucket in the
fit pipeline, the serving engine's buckets): appended rows repeat the tail
example so the forward stays numerically tame, and a labels mask (created
when absent) zero-weights them so the LOSS, numerator and normalization,
exactly matches training on the original batch. In the port a bucket is no
longer a compile boundary (torch runs eagerly), but it is still the set of
batch sizes the server warms (cuDNN picks its algorithms per shape), the
unit of its launch accounting, and what makes a padded fit follow the JAX
package step for step.

Caveat, inherited by every caller: pad rows still traverse the forward
pass, so batch-statistics state (BatchNormalization train-mode mean/var)
and shape-dependent dropout draws include them, as in the JAX package.
Loss and gradients match exactly.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from .dataset import DataSet, MultiDataSet


def next_pow2_bucket(n: int) -> int:
    """Smallest power of two >= n: the canonical batch bucket."""
    if n < 1:
        raise ValueError(f"bucket size needs n >= 1, got {n}")
    return 1 << (int(n) - 1).bit_length()


def repeat_tail_rows(a, pad: int):
    """Append `pad` copies of the last row (None-safe). Tensors pad with
    torch ops on their own device; host arrays stay numpy."""
    if a is None or pad == 0:
        return a
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))], 0)
    a = np.asarray(a)
    return np.concatenate(
        [a, np.broadcast_to(a[-1:], (pad,) + a.shape[1:])], 0)


def pad_lmask_zero_weight(lmask, n: int, pad: int):
    """A labels mask covering `pad` appended rows, constructed so the
    LOSS (numerator and normalization) exactly matches training on the
    original `n`-row batch:
      * no user mask  -> ones (n,1) + zero pad rows; the rank-2 mask
        path divides by sum(mask) = n, preserving the unmasked
        time-sum/batch-mean semantics (an (n,T) ones mask would NOT —
        it flips the denominator to n*T).
      * rank-1 user mask (per-example weights) -> zero-padded and
        scaled by padded_n/n; the rank-1 mean path then yields
        sum(sa*m)/n, the unpadded value (exact by linearity).
      * rank>=2 user mask -> zero pad rows; sum(mask) is unchanged."""
    if lmask is None:
        m = np.ones((n, 1), np.float32)
    else:
        m = np.asarray(lmask, np.float32)
    zeros = np.zeros((pad,) + m.shape[1:], m.dtype)
    out = np.concatenate([m, zeros], axis=0)
    if out.ndim == 1:
        # Rank-1 masks take the mean-over-batch loss path; rescale so
        # mean over padded_n equals the unpadded mean over n.
        out = out * (out.shape[0] / float(n))
    return out


def pad_dataset_rows(ds: DataSet, target: int) -> DataSet:
    """Pad a DataSet's batch dimension up to `target` rows under the
    zero-weight contract. A no-op when already at (or beyond) target."""
    n = ds.num_examples()
    pad = target - n
    if pad <= 0:
        return ds
    return DataSet(repeat_tail_rows(ds.features, pad),
                   repeat_tail_rows(ds.labels, pad),
                   repeat_tail_rows(ds.features_mask, pad),
                   pad_lmask_zero_weight(ds.labels_mask, n, pad))


# ---------------------------------------------------------------------------
# Sequence packing (the varlen/segment-mask counterpart of pad-to-bucket):
# several short sequences share one [bucket_len] row, separated by per-token
# SEGMENT IDS (0 = padding, 1..k = the k sequences of the row). Attention
# layers consume the ids through the ordinary features-mask plumbing
# (SelfAttentionLayer packed_segments); the loss stays exact through the
# same rank-2 zero-weight labels-mask contract the pad path uses — the
# denominator is sum(mask) = total REAL tokens, identical packed or not.
# ---------------------------------------------------------------------------

def first_fit_pack(lengths: Sequence[int], bucket_len: int) -> List[List[int]]:
    """Greedy first-fit bin packing of `lengths` into bins of capacity
    `bucket_len`: each sequence goes into the FIRST bin with room, in
    arrival order (deterministic; the classic online packing rule the
    T5/GPT example-packing pipelines use). Returns bins as lists of
    sequence indices, in first-opened order."""
    if bucket_len < 1:
        raise ValueError(f"bucket_len must be >= 1, got {bucket_len}")
    bins: List[List[int]] = []
    space: List[int] = []
    for i, raw in enumerate(lengths):
        n = int(raw)
        if n < 1:
            raise ValueError(f"sequence {i} has non-positive length {n}")
        if n > bucket_len:
            raise ValueError(
                f"sequence {i} (length {n}) exceeds bucket_len={bucket_len}")
        for j in range(len(bins)):
            if space[j] >= n:
                bins[j].append(i)
                space[j] -= n
                break
        else:
            bins.append([i])
            space.append(bucket_len - n)
    return bins


def pack_sequences(features, labels, lengths, bucket_len: int, *,
                   bins: Optional[List[List[int]]] = None,
                   rows: Optional[int] = None, labels_mask=None):
    """Pack ragged [n, t, ...] sequences into canonical
    ``(rows, bucket_len)`` arrays. Returns
    ``(features, labels, segment_mask, labels_mask, positions)``:

      * features/labels — zeros outside real tokens
      * segment_mask [rows, bucket_len] f32 — 0 = pad, 1..k = segment id
        (the packed feature mask; ``mask > 0`` is the ordinary key mask)
      * labels_mask [rows, bucket_len] f32 — the zero-weight loss mask
        (the caller's per-token `labels_mask` spliced in when given, so
        user weighting survives packing; ones otherwise)
      * positions [rows, bucket_len] int32 — 0-based, RESET per segment
        (attention itself needs only the ids — global order is causal-
        exact within a segment — but position-consuming features do not)

    `bins` defaults to first_fit_pack(lengths, bucket_len); `rows` pads
    with empty all-zero bins up to a fixed row count (one batch shape
    per epoch). Rows beyond the packed bins are fully masked: segment 0
    everywhere, zero loss weight."""
    features = np.asarray(features)
    labels = np.asarray(labels)
    if bins is None:
        bins = first_fit_pack(lengths, bucket_len)
    if rows is None:
        rows = len(bins)
    if len(bins) > rows:
        raise ValueError(f"{len(bins)} bins exceed rows={rows}")
    f = np.zeros((rows, bucket_len) + features.shape[2:], features.dtype)
    l = np.zeros((rows, bucket_len) + labels.shape[2:], labels.dtype)
    seg = np.zeros((rows, bucket_len), np.float32)
    lm = np.zeros((rows, bucket_len), np.float32)
    pos = np.zeros((rows, bucket_len), np.int32)
    for r, members in enumerate(bins):
        ofs = 0
        for s, i in enumerate(members, start=1):
            n = int(lengths[i])
            f[r, ofs:ofs + n] = features[i, :n]
            l[r, ofs:ofs + n] = labels[i, :n]
            seg[r, ofs:ofs + n] = s
            lm[r, ofs:ofs + n] = 1.0 if labels_mask is None \
                else np.asarray(labels_mask, np.float32)[i, :n]
            pos[r, ofs:ofs + n] = np.arange(n, dtype=np.int32)
            ofs += n
    return f, l, seg, lm, pos


# Packing observability: counters for packed items and fallbacks, plus a
# cumulative real/padded-token efficiency gauge; `source` distinguishes the
# training iterator ("fit") from serving admission ("serve").

_PACK_HELP = "Sequences admitted through a packed row"
_FALLBACK_HELP = "Items that fell back to the unpacked path"
_EFF_HELP = "Cumulative real/padded token ratio of packed rows"

_pack_lock = threading.Lock()
_pack_totals = {}  # source -> [real_tokens, padded_tokens]


def record_packing(source: str, *, items: int = 0, real_tokens: int = 0,
                   padded_tokens: int = 0, fallbacks: int = 0) -> None:
    """Fold one packing event into the metric families. `items` counts
    sequences that landed in a packed row; `real_tokens`/`padded_tokens`
    update the cumulative efficiency gauge; `fallbacks` counts items
    that bypassed packing (ineligible shape, overflow, ...)."""
    from ..optimize.metrics import registry
    reg = registry()
    if items:
        reg.counter("packed_requests_total", _PACK_HELP).labels(
            source=source).inc(items)
    if fallbacks:
        reg.counter("packing_fallback_total", _FALLBACK_HELP).labels(
            source=source).inc(fallbacks)
    if padded_tokens:
        with _pack_lock:
            tot = _pack_totals.setdefault(source, [0, 0])
            tot[0] += int(real_tokens)
            tot[1] += int(padded_tokens)
            eff = tot[0] / float(tot[1])
        reg.gauge("packing_efficiency", _EFF_HELP).labels(
            source=source).set(eff)


def pad_multidataset_rows(mds: MultiDataSet, target: int) -> MultiDataSet:
    """pad_dataset_rows for MultiDataSet: every output head gets a
    zero-weight mask over the pad rows (masks list created when
    absent)."""
    n = mds.num_examples()
    pad = target - n
    if pad <= 0:
        return mds
    lmasks = mds.labels_masks if mds.labels_masks is not None \
        else [None] * len(mds.labels)
    return MultiDataSet(
        [repeat_tail_rows(f, pad) for f in mds.features],
        [repeat_tail_rows(l, pad) for l in mds.labels],
        None if mds.features_masks is None
        else [repeat_tail_rows(m, pad) for m in mds.features_masks],
        [pad_lmask_zero_weight(m, n, pad) for m in lmasks])
