"""Autoregressive decode serving: iteration-level continuous batching over a
paged KV cache.

Port of `deeplearning4j_tpu/serving/decode.py`. A generative request is a
loop: its prompt is prefilled once, then the model produces one token per
step until done. Two techniques keep batching that loop cheap:

* **Iteration-level scheduling** (Orca, OSDI '22): the decode batch is
  re-formed between steps. A finished request leaves at once; a queued
  prompt joins at the next step boundary after its prefill. The
  :class:`DecodeEngine` loop owns this.
* **Block-paged KV cache** (PagedAttention, SOSP '23): per-request K/V
  lives in fixed-size token blocks of one preallocated arena
  (:class:`PagedKVCache`), so memory scales with tokens in flight. The
  block size goes through ``next_pow2_bucket``, the rule that also buckets
  the step's row count and KV view length.

Two model families decode through the one engine:

* :class:`TransformerAdapter` wraps :class:`TransformerDecoder`, a small
  causal LM: prompts are admitted packed (ragged prompts spliced into one
  segment-masked ``[1, pack_bucket]`` prefill row) and each step runs
  single-query attention against the paged cache through
  ``ops.flash_attention.decode_attention``, which on the GPU is K7
  (``ops/csrc/decode_attention.cu``).
* :class:`RecurrentAdapter` wraps a streaming ``MultiLayerNetwork``
  (``rnn_time_step``): per-request carry rows are gathered into a
  pow2-bucketed batch each step.

In the port the KV arena, the step's view and the carries live on the
engine's device (CUDA unless the caller asks for the CPU): a step's view
is gathered there by one indexed read, and the new token's K/V goes back
by one indexed write, never through host memory.

Chaos seam: each step attempt fires the ``serve.decode_step`` fault point
(utils/faults.py) before dispatch. A failing batch step is isolated by solo
retries: only a request whose solo step also fails gets a typed
:class:`~..parallel.inference.DecodeStepError`, its KV blocks freed, and
batchmates keep generating. The serving plane drives the engine through
the attributes ParallelInference has too: ``scheduler`` (a
serving/scheduler.DeviceScheduler slot held by every step), the ``on_*``
hooks (the model pool's breaker and metrics) and each request's
flight-recorder ``trace``; each defaults to None.
"""
from __future__ import annotations

import collections
import contextlib
import math
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..data.padding import next_pow2_bucket
from ..ops.attention import dense_attention
from ..ops.flash_attention import decode_attention
from ..optimize.metrics import registry
from ..parallel.inference import (DeadlineExceededError, DecodeStepError,
                                  KVCacheExhaustedError, NonFiniteOutputError,
                                  QueueFullError, ServerClosedError)
from ..utils import faults
from ..utils.device import DeviceLike, resolve_device

__all__ = ["PagedKVCache", "TransformerDecoder", "TransformerAdapter",
           "RecurrentAdapter", "DecodeEngine", "naive_generate",
           "register_metrics"]

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------
# Inter-token gaps sit between sub-ms (hot step) and the step-queue tail.
INTER_TOKEN_BUCKETS_MS = (0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                          100.0, 250.0, 500.0, 1000.0)

_TOKENS_HELP = "Tokens generated by the decode loop"
_STEPS_HELP = "Iteration-level decode steps executed (all riders advance)"
_PREFILL_HELP = "Packed prefill forwards executed"
_ITL_HELP = ("Wall time between a request's consecutive tokens "
             "(step + between-step scheduling)")
_KV_BLOCKS_HELP = "KV cache blocks currently allocated"
_KV_UTIL_HELP = ("Fraction of allocated KV block capacity holding real "
                 "tokens (1.0 = no block-tail waste)")


def register_metrics() -> None:
    """Pre-register the decode and KV-cache families at 0, so a scrape can
    tell 'no decode traffic yet' from 'families absent'."""
    reg = registry()
    reg.counter("serving_decode_tokens_total", _TOKENS_HELP)
    reg.counter("serving_decode_steps_total", _STEPS_HELP)
    reg.counter("serving_decode_prefills_total", _PREFILL_HELP)
    reg.histogram("serving_inter_token_ms", _ITL_HELP,
                  buckets=INTER_TOKEN_BUCKETS_MS)
    reg.gauge("serving_kv_blocks_in_use", _KV_BLOCKS_HELP)
    reg.gauge("serving_kv_utilization", _KV_UTIL_HELP)


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------
class PagedKVCache:
    """Bucket-allocated KV arena: fixed-size token blocks, per-request block
    tables, all-or-nothing grabs.

    One preallocated pair of arenas ``[max_blocks, block_tokens, layers,
    heads, head_dim]`` on `device` holds K and V for every in-flight
    request; a request owns ``ceil(len / block_tokens)`` blocks.
    ``block_tokens`` goes through ``next_pow2_bucket``, the rule that buckets
    the step's KV view length. Each arena has one more block that is never
    handed out and stays zero: a view's rows past a request's length are
    gathered from it.

    Exhaustion is typed: an allocation that cannot be satisfied raises
    :class:`KVCacheExhaustedError` without taking any block. Thread-safe;
    every method takes the one lock.
    """

    def __init__(self, *, layers: int, heads: int, head_dim: int,
                 block_tokens: int = 16, max_blocks: int = 256,
                 dtype: torch.dtype = torch.float32, device: DeviceLike = None):
        self.block_tokens = next_pow2_bucket(block_tokens)
        self.max_blocks = int(max_blocks)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.row_shape = (int(layers), int(heads), int(head_dim))
        rows = (self.max_blocks + 1) * self.block_tokens   # + the zero block
        # flat [block * block_tokens + offset, layers, heads, head_dim]
        self._k = torch.zeros((rows,) + self.row_shape, dtype=dtype,
                              device=self.device)
        self._v = torch.zeros_like(self._k)
        self._zero_row = self.max_blocks * self.block_tokens
        self._free: List[int] = list(range(self.max_blocks - 1, -1, -1))
        self._tables: Dict[int, List[int]] = {}
        self._lens: Dict[int, int] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ bookkeeping
    def blocks_needed(self, n_tokens: int) -> int:
        return max(1, -(-int(n_tokens) // self.block_tokens))

    def blocks_of(self, rid: int) -> int:
        with self._lock:
            return len(self._tables.get(rid, ()))

    def length(self, rid: int) -> int:
        with self._lock:
            return self._lens.get(rid, 0)

    def blocks_in_use(self) -> int:
        with self._lock:
            return self.max_blocks - len(self._free)

    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def utilization(self) -> float:
        """Stored tokens / allocated block capacity (block-tail waste)."""
        with self._lock:
            used = self.max_blocks - len(self._free)
            if used == 0:
                return 0.0
            tokens = sum(self._lens.values())
            return tokens / float(used * self.block_tokens)

    def _grab_locked(self, n_blocks: int) -> List[int]:
        if n_blocks > len(self._free):
            raise KVCacheExhaustedError(
                f"KV cache needs {n_blocks} block(s), "
                f"{len(self._free)} free of {self.max_blocks} "
                f"(block_tokens={self.block_tokens})")
        return [self._free.pop() for _ in range(n_blocks)]

    def _rows(self, table: List[int], n: int) -> List[int]:
        """Arena rows of a request's first `n` tokens."""
        bt = self.block_tokens
        return [table[j // bt] * bt + j % bt for j in range(n)]

    def _as_rows(self, a) -> Tensor:
        return torch.as_tensor(a, device=self.device).to(self.dtype)

    # ------------------------------------------------------------------ writes
    def write_prompt(self, rid: int, k, v) -> None:
        """Allocate and fill `rid`'s table with a prefilled prompt (`k`/`v`:
        [tokens, layers, heads, head_dim], tensors or arrays).
        All-or-nothing: a raise leaves no blocks taken and no table entry."""
        k, v = self._as_rows(k), self._as_rows(v)
        t = k.shape[0]
        with self._lock:
            if rid in self._tables:
                raise ValueError(f"rid {rid} already cached")
            blocks = self._grab_locked(self.blocks_needed(t))
            self._tables[rid] = blocks
            self._lens[rid] = t
            rows = torch.tensor(self._rows(blocks, t), dtype=torch.int64,
                                device=self.device)
            self._k[rows] = k
            self._v[rows] = v

    def _slot_locked(self, rid: int) -> int:
        """The arena row of `rid`'s next token, growing its table by a block
        when the tail block is full; a failed grow raises typed and leaves
        the table as it was. The caller counts the token once written."""
        table = self._tables[rid]
        n = self._lens[rid]
        bt = self.block_tokens
        if n >= len(table) * bt:
            table.extend(self._grab_locked(1))
        return table[n // bt] * bt + n % bt

    def append(self, rid: int, k_tok, v_tok) -> None:
        """Append ONE token's K/V (`[layers, heads, head_dim]`)."""
        with self._lock:
            row = self._slot_locked(rid)
            self._k[row] = self._as_rows(k_tok)
            self._v[row] = self._as_rows(v_tok)
            self._lens[rid] += 1

    def append_batch(self, rids: Sequence[int], k: Tensor, v: Tensor
                     ) -> Dict[int, BaseException]:
        """Append one token to each of `rids` (`k`/`v`: [len(rids), layers,
        heads, head_dim]) in one indexed write. A request whose table cannot
        grow gets its KVCacheExhaustedError in the returned dict and keeps
        its table; the others are appended, in `rids` order."""
        fails: Dict[int, BaseException] = {}
        rows, src = [], []
        with self._lock:
            for i, rid in enumerate(rids):
                try:
                    rows.append(self._slot_locked(rid))
                except KVCacheExhaustedError as e:
                    fails[rid] = e
                    continue
                src.append(i)
            if rows:
                at = torch.tensor(rows, dtype=torch.int64, device=self.device)
                pick = torch.tensor(src, dtype=torch.int64, device=self.device)
                self._k[at] = self._as_rows(k)[pick]
                self._v[at] = self._as_rows(v)[pick]
                for i in src:
                    self._lens[rids[i]] += 1
        return fails

    def free(self, rid: int) -> None:
        """Return `rid`'s blocks to the free list (idempotent)."""
        with self._lock:
            blocks = self._tables.pop(rid, None)
            self._lens.pop(rid, None)
            if blocks:
                self._free.extend(blocks)

    # ------------------------------------------------------------------- reads
    def batch_view(self, rids: Sequence[int], bucket_t: int
                   ) -> Tuple[Tensor, Tensor, Tensor]:
        """Gather a padded dense view for one decode step: K and V as
        ``[len(rids), bucket_t, layers, heads, head_dim]`` (zeros past each
        row's length) plus the valid lengths ``[len(rids)]`` int32, all on
        the cache's device. ``bucket_t`` must be a block multiple >= every
        row's length + 1 (room for the token the step is about to scatter
        in)."""
        with self._lock:
            bt = self.block_tokens
            if bucket_t % bt:
                raise ValueError(
                    f"view bucket {bucket_t} not a multiple of "
                    f"block_tokens {bt}")
            n = len(rids)
            index = np.full((n, bucket_t), self._zero_row, np.int64)
            lens = [self._lens[rid] for rid in rids]
            for i, rid in enumerate(rids):
                index[i, :lens[i]] = self._rows(self._tables[rid], lens[i])
            at = torch.from_numpy(index.reshape(-1)).to(self.device)
            shape = (n, bucket_t) + self.row_shape
            return (self._k[at].view(shape), self._v[at].view(shape),
                    torch.tensor(lens, dtype=torch.int32, device=self.device))


# ---------------------------------------------------------------------------
# Transformer arm: a self-contained causal LM
# ---------------------------------------------------------------------------
def _layer_norm(x: Tensor, scale: Tensor, bias: Tensor, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _sinusoid(pos: Tensor, d_model: int) -> Tensor:
    """Sinusoidal position encoding from int positions [..., t] ->
    [..., t, d_model] (d_model even)."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=pos.device)
                      / half)
    ang = pos[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


_TOP_KEYS = ("emb", "lnf_s", "lnf_b")
_LAYER_KEYS = ("ln1_s", "ln1_b", "wq", "wk", "wv", "wo", "ln2_s", "ln2_b",
               "w1", "b1", "w2", "b2")


class TransformerDecoder(nn.Module):
    """Minimal pre-LN causal transformer LM sized for serving tests and the
    decode bench: tied embedding/unembedding, sinusoidal positions computed
    from explicit position operands (so a packed prefill row and a
    mid-generation step agree on every token's encoding).

    Two functions are the whole inference surface:

    * ``prefill(tokens[1,T], seg[1,T], pos[1,T])``: one segment-masked packed
      row through ``dense_attention(causal=True, segment_ids=...)``, returning
      per-position logits and the per-layer K/V that seed the paged cache.
      Padding is segment 0; packed prompts are 1..k.
    * ``step(tok[b], pos[b], k_view, v_view, lens[b])``: one token a row
      against a bucketed KV view: the new token's K/V is written into the
      view at ``lens`` (in place: the view is the step's own gather, so the
      JAX function's copy of it per layer is saved), attention runs through
      ``decode_attention`` over ``lens + 1`` positions, and the new K/V rows
      are also returned for the cache's append.

    Weights are drawn from ``np.random.RandomState(seed)`` in the JAX
    package's order, so the same seed gives the same weights; they live on
    `device` (CUDA unless the caller asks for the CPU) as parameters without
    gradients. ``params_tree`` reads and assigns them in the JAX package's
    tree (a hot swap is an assignment).
    """

    def __init__(self, *, vocab: int = 128, layers: int = 2, heads: int = 2,
                 head_dim: int = 8, ff: int = 64, max_context: int = 128,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__()
        if head_dim * heads % 2:
            raise ValueError("d_model (heads*head_dim) must be even for "
                             "the sinusoidal position encoding")
        self.vocab, self.n_layers = int(vocab), int(layers)
        self.heads, self.head_dim = int(heads), int(head_dim)
        self.d_model = self.heads * self.head_dim
        self.ff = int(ff)
        self.max_context = int(max_context)
        self.device = resolve_device(device)
        # Pool duck-compat: swap/describe read these on every entry.
        self.iteration = 0
        self.epoch = 0
        self.state_tree: Dict[str, Any] = {}
        rng = np.random.RandomState(seed)

        def w(*shape):
            return rng.randn(*shape).astype(np.float32) * 0.08

        d, f = self.d_model, self.ff
        ones = lambda n: np.ones((n,), np.float32)
        zeros = lambda n: np.zeros((n,), np.float32)
        tree = {
            "emb": w(self.vocab, d), "lnf_s": ones(d), "lnf_b": zeros(d),
            "layers": [{
                "ln1_s": ones(d), "ln1_b": zeros(d),
                "wq": w(d, d), "wk": w(d, d), "wv": w(d, d), "wo": w(d, d),
                "ln2_s": ones(d), "ln2_b": zeros(d),
                "w1": w(d, f), "b1": zeros(f), "w2": w(f, d), "b2": zeros(d),
            } for _ in range(self.n_layers)],
        }
        as_param = lambda a: nn.Parameter(
            torch.as_tensor(a, dtype=torch.float32, device=self.device).clone(),
            requires_grad=False)
        self.top = nn.ParameterDict({k: as_param(tree[k]) for k in _TOP_KEYS})
        self.blocks = nn.ModuleList(
            nn.ParameterDict({k: as_param(lp[k]) for k in _LAYER_KEYS})
            for lp in tree["layers"])

    @property
    def params_tree(self) -> Dict[str, Any]:
        """The weights as the JAX package's tree: {"emb", "lnf_s", "lnf_b",
        "layers": [per-layer dicts]} of tensors."""
        return {**{k: self.top[k] for k in _TOP_KEYS},
                "layers": [{k: lp[k] for k in _LAYER_KEYS} for lp in self.blocks]}

    @params_tree.setter
    def params_tree(self, tree: Dict[str, Any]) -> None:
        if len(tree["layers"]) != self.n_layers:
            raise ValueError(f"tree has {len(tree['layers'])} layers, the "
                             f"decoder {self.n_layers}")
        pairs = [(self.top[k], tree[k]) for k in _TOP_KEYS] + [
            (lp[k], new[k]) for lp, new in zip(self.blocks, tree["layers"])
            for k in _LAYER_KEYS]
        with torch.no_grad():
            for p, a in pairs:
                if isinstance(a, np.ndarray):
                    a = torch.from_numpy(np.array(a, np.float32))
                a = torch.as_tensor(a, device=self.device)
                if a.shape != p.shape:
                    raise ValueError(f"leaf {tuple(a.shape)} where the decoder "
                                     f"holds {tuple(p.shape)}")
                p.copy_(a)

    # ----------------------------------------------------------- pure forward
    def _ints(self, a) -> Tensor:
        return torch.as_tensor(a, device=self.device).to(torch.int64)

    def _embed(self, tok: Tensor, pos: Tensor) -> Tensor:
        return self.top["emb"][tok] + _sinusoid(pos, self.d_model)

    @staticmethod
    def _mlp(h: Tensor, lp) -> Tensor:
        return torch.relu(h @ lp["w1"] + lp["b1"]) @ lp["w2"] + lp["b2"]

    def _heads(self, a: Tensor) -> Tensor:   # [..., t, d_model] -> [..., t, H, Dh]
        return a.reshape(a.shape[:-1] + (self.heads, self.head_dim))

    def _logits(self, x: Tensor) -> Tensor:
        x = _layer_norm(x, self.top["lnf_s"], self.top["lnf_b"])
        return x @ self.top["emb"].T

    @torch.no_grad()
    def prefill(self, tokens, seg, pos) -> Tuple[Tensor, Tensor, Tensor]:
        """tokens/seg/pos [1, T] -> (logits [1, T, vocab], k_all/v_all [1, T,
        layers, heads, head_dim]), on the decoder's device."""
        tok, seg, pos = self._ints(tokens), self._ints(seg), self._ints(pos)
        x = self._embed(tok, pos)
        ks, vs = [], []
        for lp in self.blocks:
            h = _layer_norm(x, lp["ln1_s"], lp["ln1_b"])
            q = self._heads(h @ lp["wq"])
            k = self._heads(h @ lp["wk"])
            v = self._heads(h @ lp["wv"])
            # Causal within the packed row is exact under global arange
            # positions + segment equality; pads are segment 0, never read.
            a = dense_attention(q, k, v, causal=True, segment_ids=seg)
            x = x + a.reshape(a.shape[:2] + (self.d_model,)) @ lp["wo"]
            x = x + self._mlp(_layer_norm(x, lp["ln2_s"], lp["ln2_b"]), lp)
            ks.append(k)
            vs.append(v)
        return self._logits(x), torch.stack(ks, dim=2), torch.stack(vs, dim=2)

    @torch.no_grad()
    def step(self, tok, pos, k_view, v_view, lens
             ) -> Tuple[Tensor, Tensor, Tensor]:
        """One decode step. tok/pos/lens [b]; k_view/v_view [b, bucket_t,
        layers, heads, head_dim] on the decoder's device, written at `lens`
        in place (every lens < bucket_t) -> (logits [b, vocab], k_new/v_new
        [b, layers, heads, head_dim])."""
        tok, pos, lens = self._ints(tok), self._ints(pos), self._ints(lens)
        k_view = torch.as_tensor(k_view, device=self.device)
        v_view = torch.as_tensor(v_view, device=self.device)
        b = tok.shape[0]
        rows = torch.arange(b, device=self.device)
        seen = (lens + 1).to(torch.int32)   # K7's cache_len, the same for every layer
        x = self._embed(tok, pos)[:, None, :]   # [b, 1, d]
        k_toks, v_toks = [], []
        for li, lp in enumerate(self.blocks):
            h = _layer_norm(x, lp["ln1_s"], lp["ln1_b"])
            q = self._heads(h @ lp["wq"])                 # [b, 1, H, Dh]
            k_new = self._heads((h @ lp["wk"])[:, 0])     # [b, H, Dh]
            v_new = self._heads((h @ lp["wv"])[:, 0])
            k_view[rows, lens, li] = k_new.to(k_view.dtype)
            v_view[rows, lens, li] = v_new.to(v_view.dtype)
            a = decode_attention(q, k_view[:, :, li], v_view[:, :, li], seen)
            x = x + a.reshape(b, 1, self.d_model) @ lp["wo"]
            x = x + self._mlp(_layer_norm(x, lp["ln2_s"], lp["ln2_b"]), lp)
            k_toks.append(k_new)
            v_toks.append(v_new)
        return (self._logits(x)[:, 0], torch.stack(k_toks, dim=1),
                torch.stack(v_toks, dim=1))

    def warmup(self, batch_size: int, *, time_steps=None) -> "TransformerDecoder":
        """Engine-warmup compatibility: one step at this row bucket and a
        minimal KV view."""
        b = next_pow2_bucket(batch_size)
        view = lambda: torch.zeros((b, 2, self.n_layers, self.heads, self.head_dim),
                                   device=self.device)
        zeros = torch.zeros(b, dtype=torch.int64, device=self.device)
        self.step(zeros, zeros, view(), view(), zeros)
        return self


def naive_generate(model: TransformerDecoder, prompt: Sequence[int],
                   n_tokens: int, *, pad_to: int) -> List[int]:
    """Full-recompute greedy decode, the baseline the KV-cached loop is
    benched against: every token re-runs the whole sequence through the
    prefill (padded to `pad_to`)."""
    toks = [int(t) for t in prompt]
    out: List[int] = []
    for _ in range(n_tokens):
        t = len(toks)
        if t > pad_to:
            raise ValueError(f"sequence {t} exceeds pad_to {pad_to}")
        row = np.zeros((1, pad_to), np.int32)
        seg = np.zeros((1, pad_to), np.int32)
        pos = np.zeros((1, pad_to), np.int32)
        row[0, :t] = toks
        seg[0, :t] = 1
        pos[0, :t] = np.arange(t)
        logits, _, _ = model.prefill(row, seg, pos)
        nxt = int(logits[0, t - 1].argmax())
        toks.append(nxt)
        out.append(nxt)
    return out


def _pow2_rows(max_rows: int) -> List[int]:
    rows, b = [], 1
    top = next_pow2_bucket(max_rows)
    while b <= top:
        rows.append(b)
        b <<= 1
    return rows


class TransformerAdapter:
    """Token-family adapter: packed prefill + paged-KV decode steps.

    ``prefill_group``/``step`` report per-request outcomes as ``(results,
    failures)`` dicts instead of raising for partial trouble: the engine
    applies survivors and fails victims typed, so a KV-grow failure or a
    poisoned row never costs its batchmates a token.
    """

    kind = "token"

    def __init__(self, model: TransformerDecoder, cache: PagedKVCache,
                 *, pack_bucket: int = 64, check_finite: bool = True):
        if cache.device != model.device:
            raise ValueError(f"the cache lies on {cache.device}, the model on "
                             f"{model.device}")
        self.model = model
        self.cache = cache
        self.device = model.device
        self.pack_bucket = next_pow2_bucket(pack_bucket)
        if self.pack_bucket > model.max_context:
            raise ValueError("pack_bucket exceeds model max_context")
        self.check_finite = bool(check_finite)

    # ------------------------------------------------------------- validation
    def validate_prompt(self, prompt) -> np.ndarray:
        p = np.asarray(prompt)
        if p.ndim != 1 or p.size < 1:
            raise ValueError("prompt must be a non-empty 1-D token list")
        p = p.astype(np.int64)
        if p.min() < 0 or p.max() >= self.model.vocab:
            raise ValueError(
                f"prompt tokens outside [0, {self.model.vocab})")
        if p.size > self.pack_bucket:
            raise ValueError(
                f"prompt length {p.size} exceeds pack_bucket "
                f"{self.pack_bucket}")
        return p.astype(np.int32)

    def max_total_len(self, prompt_len: int, max_new: int) -> int:
        return prompt_len + max_new

    # ---------------------------------------------------------------- prefill
    def pack_groups(self, items: List[Tuple[int, np.ndarray]]
                    ) -> List[List[Tuple[int, np.ndarray]]]:
        """Greedy first-fit: split (rid, prompt) pairs into groups whose total
        token count rides one [1, pack_bucket] row."""
        groups: List[List[Tuple[int, np.ndarray]]] = []
        fill: List[int] = []
        for rid, p in items:
            for gi, g in enumerate(groups):
                if fill[gi] + p.size <= self.pack_bucket:
                    g.append((rid, p))
                    fill[gi] += p.size
                    break
            else:
                groups.append([(rid, p)])
                fill.append(p.size)
        return groups

    def prefill_group(self, group: List[Tuple[int, np.ndarray]]
                      ) -> Tuple[Dict[int, int], Dict[int, BaseException]]:
        """Prefill ONE packed group: splice prompts into a segment-masked
        row, run the packed forward, seed each rid's KV blocks. Returns
        ``({rid: first token}, {rid: error})``: a rid whose blocks cannot be
        granted lands in the failure dict (typed KVCacheExhaustedError)
        without costing groupmates theirs."""
        pb = self.pack_bucket
        row = np.zeros((1, pb), np.int32)
        seg = np.zeros((1, pb), np.int32)
        pos = np.zeros((1, pb), np.int32)
        spans: List[Tuple[int, int, int]] = []  # (rid, lo, hi)
        cur = 0
        for si, (rid, p) in enumerate(group, start=1):
            lo, hi = cur, cur + p.size
            if hi > pb:
                raise ValueError("pack group overflows pack_bucket")
            row[0, lo:hi] = p
            seg[0, lo:hi] = si
            pos[0, lo:hi] = np.arange(p.size)
            spans.append((rid, lo, hi))
            cur = hi
        logits, k_all, v_all = self.model.prefill(row, seg, pos)
        ends = torch.tensor([hi - 1 for _, _, hi in spans], device=self.device)
        first = logits[0, ends].argmax(-1).tolist()
        if self.check_finite:
            finite = torch.isfinite(logits[0]).all(-1).tolist()
        out: Dict[int, int] = {}
        fails: Dict[int, BaseException] = {}
        for (rid, lo, hi), tok in zip(spans, first):
            if self.check_finite and not all(finite[lo:hi]):
                fails[rid] = NonFiniteOutputError(
                    "prefill produced non-finite logits")
                continue
            try:
                self.cache.write_prompt(rid, k_all[0, lo:hi], v_all[0, lo:hi])
            except KVCacheExhaustedError as e:
                fails[rid] = e
                continue
            out[rid] = tok
        return out, fails

    # ------------------------------------------------------------------- step
    def kv_bucket(self, rids: Sequence[int]) -> int:
        """View length for this step: room for every row's cache + the token
        being scattered, snapped to the pow2 rule and never below one block."""
        need = max(self.cache.length(r) for r in rids) + 1
        return max(self.cache.block_tokens, next_pow2_bucket(need))

    def step(self, rids: Sequence[int], last_items: Sequence[Any]
             ) -> Tuple[Dict[int, int], Dict[int, BaseException]]:
        """One iteration-level step for `rids`: rows are padded to the pow2
        row bucket by repeating row 0 (only real rows append, so a pad row's
        K/V never enters the cache). Returns ``({rid: next token}, {rid:
        error})``."""
        n = len(rids)
        bucket = next_pow2_bucket(n)
        kvb = self.kv_bucket(rids)
        pad_rids = list(rids) + [rids[0]] * (bucket - n)
        k_view, v_view, lens = self.cache.batch_view(pad_rids, kvb)
        toks = torch.tensor([int(t) for t in last_items]
                            + [int(last_items[0])] * (bucket - n),
                            dtype=torch.int64, device=self.device)
        logits, k_t, v_t = self.model.step(toks, lens, k_view, v_view, lens)
        nxt = logits[:n].argmax(-1).tolist()
        if self.check_finite:
            finite = torch.isfinite(logits[:n]).all(-1).tolist()
        out: Dict[int, int] = {}
        fails: Dict[int, BaseException] = {}
        keep = []
        for i, rid in enumerate(rids):
            if self.check_finite and not finite[i]:
                fails[rid] = NonFiniteOutputError(
                    "decode step produced non-finite logits")
                continue
            keep.append(i)
        kept = [rids[i] for i in keep]
        at = torch.tensor(keep, dtype=torch.int64, device=self.device)
        fails.update(self.cache.append_batch(kept, k_t[at], v_t[at]))
        for i, rid in zip(keep, kept):
            if rid not in fails:
                out[rid] = nxt[i]
        return out, fails

    # ------------------------------------------------------------------ admin
    def free(self, rid: int) -> None:
        self.cache.free(rid)

    def kv_blocks(self, rid: int) -> int:
        return self.cache.blocks_of(rid)

    def result_of(self, generated: List[int]) -> List[int]:
        return list(generated)

    def warm_signatures(self, max_rows: int, max_context: int
                        ) -> Tuple[List[int], List[int]]:
        """The step shapes the engine can reach: pow2 row buckets x pow2 KV
        view buckets (block-floored; one bucket past max_context so a row
        at max_context can still scatter its final token)."""
        kvs, kv = [], self.cache.block_tokens
        top_kv = next_pow2_bucket(max_context + 1)
        while kv <= top_kv:
            kvs.append(kv)
            kv <<= 1
        return _pow2_rows(max_rows), kvs

    def warm_step(self, b: int, kv: int) -> None:
        """One step on zeros at `b` rows and a KV view of `kv` tokens."""
        L, H, D = self.model.n_layers, self.model.heads, self.model.head_dim
        view = lambda: torch.zeros((b, kv, L, H, D), dtype=self.cache.dtype,
                                   device=self.device)
        zeros = torch.zeros(b, dtype=torch.int64, device=self.device)
        self.model.step(zeros, zeros, view(), view(), zeros)

    def warmup(self, max_rows: int, max_context: int) -> List[int]:
        """Run the packed prefill and every step shape in the grid once, so
        the first request finds cuBLAS's choices made and the kernels
        built. Returns the row buckets warmed."""
        zeros = np.zeros((1, self.pack_bucket), np.int32)
        self.model.prefill(zeros, zeros, zeros)
        rows, kvs = self.warm_signatures(max_rows, max_context)
        for b in rows:
            for kv in kvs:
                self.warm_step(b, kv)
        return rows


# ---------------------------------------------------------------------------
# Recurrent arm: streaming LSTM through rnn_time_step
# ---------------------------------------------------------------------------
class RecurrentAdapter:
    """Stream-family adapter: a MultiLayerNetwork generates through the same
    iteration-level loop via ``rnn_time_step``.

    There is no KV cache: the recurrent state is the cache. Per-request
    carry rows (each layer's h/c at batch 1) live in this adapter on the
    network's device; every step gathers the active rows into one
    pow2-bucketed batch (pad rows repeat the last real row), sets it as the
    net's carry, runs ONE ``rnn_time_step``, and keeps the advanced rows.
    The model's own output feeds back as the next step's input, so the net
    must be built with ``n_out == n_in``.
    """

    kind = "stream"

    def __init__(self, net, *, feature_dim: int, check_finite: bool = True):
        for layer in net.layers:
            if not layer.supports_streaming():
                raise ValueError(
                    f"{type(layer).__name__} cannot stream: the decode "
                    "loop needs rnn_time_step support")
        self.net = net
        self.device = net.device
        self.feature_dim = int(feature_dim)
        self.check_finite = bool(check_finite)
        self._carries: Dict[int, tuple] = {}
        self.pack_bucket = 0  # no packed path on the stream arm

    # ------------------------------------------------------------- validation
    def validate_prompt(self, prompt) -> np.ndarray:
        p = np.asarray(prompt, np.float32)
        if p.ndim != 2 or p.shape[0] < 1 or p.shape[1] != self.feature_dim:
            raise ValueError(
                f"stream prompt must be [time, {self.feature_dim}], got "
                f"{p.shape}")
        return p

    def max_total_len(self, prompt_len: int, max_new: int) -> int:
        return prompt_len + max_new

    # ---------------------------------------------------------------- prefill
    def pack_groups(self, items):
        # Stream prefill is sequential per request: every prompt is its own
        # group (still admitted between steps).
        return [[it] for it in items]

    @staticmethod
    def _carry_rows(carry, i: int) -> tuple:
        """Row `i` of every layer's carry, copied."""
        return tuple({k: v[i:i + 1].clone() for k, v in layer.items()}
                     for layer in carry)

    def prefill_group(self, group
                      ) -> Tuple[Dict[int, np.ndarray], Dict[int, BaseException]]:
        (rid, prompt), = group
        net = self.net
        net.rnn_clear_previous_state()
        out = None
        try:
            # One token at a time at [1, features], so no pad step ever
            # touches the carry.
            for t in range(prompt.shape[0]):
                out = net.rnn_time_step(prompt[t:t + 1])
            self._carries[rid] = self._carry_rows(net._rnn_carry, 0)
        finally:
            net.rnn_clear_previous_state()
        out = np.asarray(out)[0]
        if self.check_finite and not np.isfinite(out).all():
            self._carries.pop(rid, None)
            return {}, {rid: NonFiniteOutputError(
                "stream prefill produced non-finite outputs")}
        return {rid: out}, {}

    # ------------------------------------------------------------------- step
    def step(self, rids: Sequence[int], last_items: Sequence[np.ndarray]
             ) -> Tuple[Dict[int, np.ndarray], Dict[int, BaseException]]:
        n = len(rids)
        bucket = next_pow2_bucket(n)
        pad_i = [min(i, n - 1) for i in range(bucket)]
        net = self.net
        first = self._carries[rids[0]]
        net._rnn_carry = tuple(
            {k: torch.cat([self._carries[rids[pad_i[j]]][li][k]
                           for j in range(bucket)], dim=0)
             for k in first[li]}
            for li in range(len(first)))
        x = np.stack([np.asarray(last_items[pad_i[j]], np.float32)
                      for j in range(bucket)], axis=0)
        try:
            out = net.rnn_time_step(x)
            new_carry = net._rnn_carry
        finally:
            net.rnn_clear_previous_state()
        out = np.asarray(out)
        results: Dict[int, np.ndarray] = {}
        fails: Dict[int, BaseException] = {}
        for i, rid in enumerate(rids):
            if self.check_finite and not np.isfinite(out[i]).all():
                fails[rid] = NonFiniteOutputError(
                    "decode step produced non-finite outputs")
                continue
            self._carries[rid] = self._carry_rows(new_carry, i)
            results[rid] = out[i]
        return results, fails

    # ------------------------------------------------------------------ admin
    def free(self, rid: int) -> None:
        self._carries.pop(rid, None)

    def kv_blocks(self, rid: int) -> int:
        return 0

    def result_of(self, generated: List[np.ndarray]) -> np.ndarray:
        return np.stack([np.asarray(g) for g in generated], axis=0)

    def warm_signatures(self, max_rows: int, max_context: int):
        return _pow2_rows(max_rows), []

    def warm_step(self, b: int) -> None:
        net = self.net
        net.rnn_clear_previous_state()
        net.rnn_time_step(np.zeros((b, self.feature_dim), np.float32))
        net.rnn_clear_previous_state()

    def warmup(self, max_rows: int, max_context: int) -> List[int]:
        """One step at each pow2 row bucket (the prefill's [1, features] is
        the first)."""
        rows, _ = self.warm_signatures(max_rows, max_context)
        for b in rows:
            self.warm_step(b)
        return rows


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
class _DecodeRequest:
    __slots__ = ("rid", "prompt", "max_new_tokens", "event", "result",
                 "error", "deadline", "trace", "generated", "last_item",
                 "t_last")

    def __init__(self, rid: int, prompt, max_new_tokens: int,
                 deadline: Optional[float], trace):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.deadline = deadline
        self.trace = trace
        self.generated: List[Any] = []
        self.last_item = None     # feeds the next step's input
        self.t_last = 0.0         # last token emission (inter-token gap)

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and \
            (now if now is not None else time.monotonic()) > self.deadline


class _StepPause:
    """Context manager holding the engine's step lock: the in-flight step
    completes, then the loop stalls between steps; active generations wait,
    they are not dropped (the hot-swap window)."""

    def __init__(self, lock):
        self._lock = lock

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


class DecodeEngine:
    """Iteration-level continuous-batching decode loop.

    Duck-types the :class:`~..parallel.inference.ParallelInference` surface
    a model pool consumes (queue_depth / estimate_wait_s / warmup / paused /
    shutdown / scheduler hooks / counters). The entry point is
    :meth:`generate`, not ``output``. The engine runs on `device` (CUDA
    unless the caller asks for the CPU), where its adapter's model and
    cache must lie.

    The loop, each iteration:

    1. **Admit** queued prompts up to ``max_decode_batch`` active requests:
       packed prefill groups for the token arm, one prompt a group for the
       stream arm. A prompt whose KV blocks cannot be granted requeues at
       the front while others are still generating (their completions free
       blocks), or fails typed when nothing is generating.
    2. **Step** every active request ONE token under the step lock (the
       ``paused()`` swap gate). Each attempt fires ``serve.decode_step``; a
       failed batch step is re-run solo per rider, and only a request whose
       solo step also fails gets :class:`DecodeStepError`, its KV freed.
    3. **Retire** finished requests at once (event set between steps).
    """

    def __init__(self, adapter, *, name: str = "decode",
                 max_decode_batch: int = 8, queue_limit: int = 64,
                 max_context: Optional[int] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if adapter.device.type != self.device.type:
            raise ValueError(f"the adapter runs on {adapter.device}, the engine "
                             f"on {self.device}")
        self.adapter = adapter
        self.name = name
        self.max_decode_batch = int(max_decode_batch)
        self.queue_limit = int(queue_limit)
        if max_context is None:
            max_context = (adapter.model.max_context
                           if adapter.kind == "token" else 64)
        self.max_context = int(max_context)
        self.check_finite = bool(getattr(adapter, "check_finite", True))

        # ParallelInference duck-type surface.
        self.warmed_buckets: List[int] = []
        self.total_forwards = 0
        self.total_shed = 0
        self.total_batch_failures = 0
        self.batch_timeout_ms = 0.0
        self.on_shed: Optional[Callable] = None
        self.on_batch: Optional[Callable] = None
        self.on_batch_error: Optional[Callable] = None
        self.scheduler = None
        self.sched_name: Optional[str] = None

        self._rid = 0
        self._queue: collections.deque = collections.deque()
        self._active: List[_DecodeRequest] = []
        self._cv = threading.Condition()
        self._lock = threading.RLock()   # step/execution lock (paused())
        self._shutdown = False
        self._ewma_step_s = 0.0

        reg = registry()
        self._tokens_c = reg.counter("serving_decode_tokens_total",
                                     _TOKENS_HELP).labels(model=name)
        self._steps_c = reg.counter("serving_decode_steps_total",
                                    _STEPS_HELP).labels(model=name)
        self._prefills_c = reg.counter("serving_decode_prefills_total",
                                       _PREFILL_HELP).labels(model=name)
        self._itl_h = reg.histogram(
            "serving_inter_token_ms", _ITL_HELP,
            buckets=INTER_TOKEN_BUCKETS_MS).labels(model=name)
        cache = getattr(adapter, "cache", None)
        if cache is not None:
            wr = weakref.ref(cache)

            def _collect(reg, _wr=wr, _name=name):
                c = _wr()
                if c is None:
                    return
                reg.gauge("serving_kv_blocks_in_use",
                          _KV_BLOCKS_HELP).labels(model=_name).set(
                              c.blocks_in_use())
                reg.gauge("serving_kv_utilization",
                          _KV_UTIL_HELP).labels(model=_name).set(
                              round(c.utilization(), 6))

            reg.register_collector(_collect)

        self._worker = threading.Thread(
            target=self._loop, name=f"DecodeEngine-{name}", daemon=True)
        self._worker.start()

    # ------------------------------------------------------ duck-type surface
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def active_count(self) -> int:
        with self._cv:
            return len(self._active)

    def estimate_wait_s(self) -> float:
        """Admission estimate: queued prompts ahead at the EWMA step time,
        batched at max_decode_batch; 0.0 while cold."""
        svc = self._ewma_step_s
        if svc <= 0.0:
            return 0.0
        ahead = self.queue_depth() // max(1, self.max_decode_batch)
        return (ahead + 1) * svc

    def paused(self) -> _StepPause:
        return _StepPause(self._lock)

    def warmup(self, max_bucket: Optional[int] = None, **_kw) -> "DecodeEngine":
        """Run the packed prefill and every (row bucket x KV view bucket)
        step once."""
        rows = self.adapter.warmup(max_bucket or self.max_decode_batch,
                                   self.max_context)
        for b in rows:
            if b not in self.warmed_buckets:
                self.warmed_buckets.append(b)
        return self

    def swap_warm(self, bucket: int) -> None:
        """The per-bucket warm hook of a swap: new params, same shapes; re-run
        the row bucket across the KV grid."""
        ad = self.adapter
        b = next_pow2_bucket(bucket)
        if ad.kind == "token":
            for kv in ad.warm_signatures(bucket, self.max_context)[1]:
                ad.warm_step(b, kv)
        else:
            ad.warm_step(b)

    def output(self, x, **_kw):
        raise NotImplementedError(
            f"{self.name!r} is a decode entry: use generate() (one-shot "
            "output does not apply)")

    # --------------------------------------------------------------- generate
    def generate(self, prompt, *, max_new_tokens: int = 16,
                 deadline: Optional[float] = None, trace=None):
        """Blocking decode of one prompt: admitted between steps, rides the
        continuous batch, returns the adapter's result (a token-id list for
        the transformer arm, a [steps, features] array for the stream arm).
        Raises the typed errors of ParallelInference.output plus
        DecodeStepError / KVCacheExhaustedError."""
        p = self.adapter.validate_prompt(prompt)
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        plen = p.shape[0]
        total = self.adapter.max_total_len(plen, int(max_new_tokens))
        if total > self.max_context:
            raise ValueError(
                f"prompt {plen} + max_new_tokens {max_new_tokens} "
                f"exceeds max_context {self.max_context}")
        with self._cv:
            if self._shutdown:
                raise ServerClosedError(
                    "DecodeEngine was shut down before this request ran")
            if len(self._queue) >= self.queue_limit:
                raise QueueFullError(
                    f"decode admission queue at capacity "
                    f"({self.queue_limit})")
            self._rid += 1
            req = _DecodeRequest(self._rid, p, int(max_new_tokens),
                                 deadline, trace)
            self._queue.append(req)
            self._cv.notify_all()
        while not req.event.wait(timeout=0.5):
            with self._cv:
                if self._shutdown and not req.event.is_set():
                    req.error = ServerClosedError(
                        "DecodeEngine shut down mid-request")
                    req.event.set()
        if req.error is not None:
            raise req.error
        return req.result

    # ------------------------------------------------------------------- loop
    def _loop(self):
        while True:
            with self._cv:
                while (not self._queue and not self._active
                       and not self._shutdown):
                    self._cv.wait(timeout=0.2)
                if self._shutdown and not self._active and not self._queue:
                    return
                admits = self._take_admits_locked()
            try:
                if admits:
                    self._admit(admits)
                if self._active:
                    self._step_once()
            except Exception as e:  # noqa: BLE001 (the loop must survive)
                # A fault past the per-step isolation would otherwise hang
                # every caller: fail the in-flight set typed and keep the
                # loop alive for the next admission.
                for req in admits + list(self._active):
                    if not req.event.is_set():
                        self._fail_step(req, e)
                # the loop thread is the only writer of _active; readers
                # snapshot the rebound list
                self._active = [r for r in self._active  # jaxlint: atomic
                                if not r.event.is_set()]

    def _take_admits_locked(self) -> List[_DecodeRequest]:
        room = self.max_decode_batch - len(self._active)
        admits: List[_DecodeRequest] = []
        while room > 0 and self._queue:
            admits.append(self._queue.popleft())
            room -= 1
        return admits

    def _fail(self, req: _DecodeRequest, err: BaseException) -> None:
        self._finalize_trace(req)
        self.adapter.free(req.rid)
        req.error = err
        req.event.set()

    def _finish(self, req: _DecodeRequest) -> None:
        req.result = self.adapter.result_of(req.generated)
        self._finalize_trace(req)
        self.adapter.free(req.rid)
        req.event.set()

    def _finalize_trace(self, req: _DecodeRequest) -> None:
        tr = req.trace
        if tr is None:
            return
        tr.ctx["tokens_generated"] = len(req.generated)
        tr.ctx["kv_blocks"] = self.adapter.kv_blocks(req.rid)
        tr.mark("unpack")

    # -------------------------------------------------------------- admission
    def _admit(self, admits: List[_DecodeRequest]) -> None:
        now = time.monotonic()
        live: List[_DecodeRequest] = []
        for req in admits:
            if req.expired(now):
                self.total_shed += 1  # jaxlint: atomic (loop-thread stat)
                if self.on_shed is not None:
                    self.on_shed(req, "expired")
                self._fail(req, DeadlineExceededError(
                    "deadline passed while queued for decode admission"))
                continue
            live.append(req)
        if not live:
            return
        by_rid = {r.rid: r for r in live}
        for group in self.adapter.pack_groups(
                [(r.rid, r.prompt) for r in live]):
            reqs = [by_rid[rid] for rid, _ in group]
            for r in reqs:
                if r.trace is not None:
                    r.trace.mark("queue_wait")
            try:
                with self._lock, self._sched_slot(cost=float(len(group))):
                    t0 = time.perf_counter()
                    first, fails = self.adapter.prefill_group(group)
                    dur = time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001 (typed wrapper below)
                self.total_batch_failures += 1  # jaxlint: atomic
                if self.on_batch_error is not None:
                    self.on_batch_error(e, len(reqs))
                for r in reqs:
                    err = DecodeStepError(
                        f"packed prefill failed for request {r.rid}: "
                        f"{e!r}")
                    err.__cause__ = e
                    self._fail(r, err)
                continue
            self.total_forwards += 1  # jaxlint: atomic (loop-thread stat)
            self._prefills_c.inc()
            ok_reqs = [r for r in reqs if r.rid in first]
            if self.on_batch is not None and ok_reqs:
                self.on_batch(ok_reqs, len(ok_reqs),
                              getattr(self.adapter, "pack_bucket", 0), dur)
            now2 = time.perf_counter()
            for r in ok_reqs:
                item = first[r.rid]
                r.generated.append(item)
                r.last_item = item
                r.t_last = now2
                self._tokens_c.inc()
                if r.trace is not None:
                    r.trace.mark("prefill")
                self._active.append(r)
            kv_starved = [r for r in reqs if isinstance(
                fails.get(r.rid), KVCacheExhaustedError)]
            if kv_starved:
                self._requeue_or_fail(kv_starved, fails)
            for r in reqs:
                err = fails.get(r.rid)
                if err is not None and r not in kv_starved:
                    self.total_batch_failures += 1  # jaxlint: atomic
                    if self.on_batch_error is not None:
                        self.on_batch_error(err, 1)
                    self._fail(r, err)
        self._retire_done()

    def _requeue_or_fail(self, reqs: List[_DecodeRequest],
                         fails: Dict[int, BaseException]) -> None:
        """KV admission backpressure: while anything is generating, its
        completion will free blocks, so the starved prompts wait at the
        front of the queue. With nothing active the cache cannot free up on
        its own: fail typed now."""
        if self._active:
            with self._cv:
                for r in reversed(reqs):
                    self._queue.appendleft(r)
        else:
            self.total_shed += len(reqs)  # jaxlint: atomic (loop-thread stat)
            for r in reqs:
                if self.on_shed is not None:
                    self.on_shed(r, "kv_exhausted")
                self._fail(r, fails[r.rid])

    # ------------------------------------------------------------------- step
    def _sched_slot(self, cost: float = 1.0):
        if self.scheduler is None:
            return contextlib.nullcontext()
        return self.scheduler.slot(self.sched_name or self.name, cost=cost)

    def _step_attempt(self, reqs: List[_DecodeRequest]
                      ) -> Tuple[Dict[int, Any], Dict[int, BaseException]]:
        faults.fire("serve.decode_step")
        return self.adapter.step([r.rid for r in reqs],
                                 [r.last_item for r in reqs])

    def _step_once(self) -> None:
        now = time.monotonic()
        for req in list(self._active):
            if req.expired(now):
                self._active.remove(req)
                self.total_shed += 1  # jaxlint: atomic (loop-thread stat)
                if self.on_shed is not None:
                    self.on_shed(req, "expired")
                self._fail(req, DeadlineExceededError(
                    f"deadline passed after {len(req.generated)} "
                    "token(s)"))
        if not self._active:
            return
        reqs = list(self._active)
        t0 = time.perf_counter()
        with self._lock, self._sched_slot(cost=float(len(reqs))):
            try:
                out, fails = self._step_attempt(reqs)
            except Exception as e:  # noqa: BLE001 (isolated below)
                self.total_batch_failures += 1
                if self.on_batch_error is not None:
                    self.on_batch_error(e, len(reqs))
                out, fails = self._isolate(reqs, e)
        dur = time.perf_counter() - t0
        # the loop thread is the only writer; estimate_wait_s reads a float
        self._ewma_step_s = (dur if self._ewma_step_s == 0.0  # jaxlint: atomic
                             else 0.8 * self._ewma_step_s + 0.2 * dur)
        for rid, err in fails.items():
            req = next((r for r in self._active if r.rid == rid), None)
            if req is None:
                continue
            self.total_batch_failures += 1  # jaxlint: atomic
            if self.on_batch_error is not None:
                self.on_batch_error(err, 1)
            self._fail_step(req, err)
        if out:
            self.total_forwards += 1  # jaxlint: atomic (loop-thread stat)
            self._steps_c.inc()
            if self.on_batch is not None:
                survivors = [r for r in reqs if r.rid in out]
                self.on_batch(survivors, len(survivors),
                              next_pow2_bucket(len(reqs)), dur)
            self._apply(out)
        self._retire_done()

    def _isolate(self, reqs: List[_DecodeRequest], batch_err: BaseException
                 ) -> Tuple[Dict[int, Any], Dict[int, BaseException]]:
        """Solo-retry isolation after a failed batch step: each rider steps
        alone (its own fault fire); a request whose solo step also fails is
        failed typed with its KV freed, survivors' results merge."""
        if len(reqs) == 1:
            return {}, {reqs[0].rid: batch_err}
        merged: Dict[int, Any] = {}
        fails: Dict[int, BaseException] = {}
        for r in reqs:
            if r not in self._active:
                continue
            try:
                out_r, fails_r = self._step_attempt([r])
            except Exception as e:  # noqa: BLE001
                fails[r.rid] = e
                continue
            merged.update(out_r)
            fails.update(fails_r)
        return merged, fails

    def _fail_step(self, req: _DecodeRequest, cause: BaseException) -> None:
        if req in self._active:
            self._active.remove(req)
        if isinstance(cause, (KVCacheExhaustedError, NonFiniteOutputError)):
            err: BaseException = cause
        else:
            err = DecodeStepError(
                f"decode step failed after {len(req.generated)} "
                f"token(s): {cause!r}")
            err.__cause__ = cause
        self._fail(req, err)

    def _apply(self, out: Dict[int, Any]) -> None:
        now = time.perf_counter()
        for req in list(self._active):
            if req.rid not in out:
                continue
            item = out[req.rid]
            req.generated.append(item)
            req.last_item = item
            self._tokens_c.inc()
            if req.t_last:
                self._itl_h.observe((now - req.t_last) * 1000.0)
            req.t_last = now
            if req.trace is not None:
                req.trace.mark("decode_step")

    def _retire_done(self) -> None:
        for req in list(self._active):
            if len(req.generated) >= req.max_new_tokens:
                self._active.remove(req)
                self._finish(req)

    # --------------------------------------------------------------- shutdown
    def shutdown(self, join_timeout: float = 5.0) -> None:
        """Close the engine: the loop drains in-flight generations to
        completion; anything still unserved after the join window fails with
        ServerClosedError instead of hanging its caller."""
        with self._cv:
            already = self._shutdown
            self._shutdown = True
            self._cv.notify_all()
        if not already:
            self._worker.join(timeout=join_timeout)
        err = ServerClosedError(
            "DecodeEngine was shut down before this request completed")
        with self._cv:
            stranded = list(self._queue) + list(self._active)
            self._queue.clear()
            self._active.clear()
        for req in stranded:
            if not req.event.is_set():
                self.adapter.free(req.rid)
                req.error = err
                req.event.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
