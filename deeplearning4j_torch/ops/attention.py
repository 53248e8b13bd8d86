"""Attention: dense, blockwise and the flash route on one device, with the
dispatch rule that picks one, and ring attention for sequence parallelism.

Port of `deeplearning4j_tpu/ops/attention.py`. Dense and blockwise are
plain torch, as they are plain XLA there; "pallas" names the flash route
(`ops/flash_attention.py`: the CUDA kernels K3-K5 on a GPU, their plain
versions on the CPU). The rule is the JAX package's as it runs on a TPU whose
kernel probe passes: the flash route is ready wherever
`flash_attention_supported` holds, so the card and the CPU choose alike.

Ring attention (Liu et al. 2023): time is cut over a mesh's seq axis, each
shard keeps its queries and the key/value blocks travel around the ring,
one hop a step, folded into the shard's running softmax, so no shard holds
the [T, T] scores. The flash body (`_ring_body_flash`) runs
`flash_attention` once a hop (K3 forward; K4 and K5 backward on a GPU)
with the queries' and the visiting block's global positions and the lse,
and merges the hops' normalized (o, lse) pairs in float32; the plain body
(`_ring_body`, blockwise inside each hop when `block_size` asks) runs where
the flash geometry is not supported. Inside a sequence-parallel step
(`parallel/sequence.py`) each shard runs its own ring
(`ring_attention_shard`, its place and its hop given by the caller);
`ring_self_attention` on whole tensors runs
every shard of the ring in turn, a hop moving the block to the receiving
shard's device (the JAX package's `shard_map` over the mesh).

`attention_kernel_selected_total` counts every call's choice per impl (the
JAX package counts per trace, which under jit is once per compiled shape);
a ring counts once a call, its route as "pallas", "blockwise" or "dense".
"""
from __future__ import annotations

import contextlib
import logging
import threading
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import flash_attention as fa

Tensor = torch.Tensor

NEG = -1e30  # finite -inf stand-in: keeps exp() NaN-free in masked rows

ATTENTION_IMPLS = ("pallas", "blockwise", "dense")

#: Choices made by `select_attention_impl` in this process, per impl.
attention_kernel_selected_total = {impl: 0 for impl in ATTENTION_IMPLS}
_count_lock = threading.Lock()
_warned_pallas = False

# ---------------------------------------------------------------------------
# Sequence-parallel context: while active, SelfAttentionLayer routes its
# attention through the ring over the given mesh axis.
# ---------------------------------------------------------------------------

_SEQ_PARALLEL: list = []


@contextlib.contextmanager
def sequence_parallel(mesh, axis: str = "seq",
                      batch_axis: Optional[str] = None,
                      head_axis: Optional[str] = None):
    """Route attention layers through the ring while active. `batch_axis`
    optionally names the mesh axis the batch is cut over (the data half of
    a data x seq mesh); `head_axis` one the heads are cut over (tensor
    parallelism; heads are independent, so they compose with the ring)."""
    _SEQ_PARALLEL.append((mesh, axis, batch_axis, head_axis))
    try:
        yield
    finally:
        _SEQ_PARALLEL.pop()


def active_sequence_parallel():
    """(mesh, seq_axis, batch_axis, head_axis) of the innermost active
    sequence_parallel context, or None."""
    return _SEQ_PARALLEL[-1] if _SEQ_PARALLEL else None


def _count_attention_impl(impl: str) -> None:
    with _count_lock:
        attention_kernel_selected_total[impl] += 1


def pick_block_size(t: int, block_size: int = 0) -> int:
    """Block size for single-device blockwise attention; 0 = dense.
    block_size: 0 = auto (blockwise once t >= 2048; probe order 512, 1024,
    256, 128), -1 = always dense, >0 = that block size whenever it divides
    t (including t == block, a single-block run)."""
    if block_size == -1:
        return 0
    if block_size > 0:
        return block_size if t % block_size == 0 else 0
    if t < 2048:
        return 0
    for blk in (512, 1024, 256, 128):
        if t % blk == 0:
            return blk
    return 0


def _warn_pallas_unavailable_once(t: int, head_dim: int) -> None:
    global _warned_pallas
    if _warned_pallas:
        return
    logging.getLogger(__name__).warning(
        "attention impl 'pallas' requested but the flash geometry gate refuses "
        "t=%d head_dim=%d; falling back per the dispatch rule", t, head_dim)
    _warned_pallas = True


def select_attention_impl(t_q: int, head_dim: int, *,
                          requested: Optional[str] = None,
                          block_size: int = 0,
                          t_k: Optional[int] = None) -> str:
    """Pick 'pallas' | 'blockwise' | 'dense' for a single-device attention
    call, count it in `attention_kernel_selected_total`, and return it.

    Rule (the JAX package's): below t=2048 dense; from 2048 up, with
    t_q == t_k and block_size == 0, the flash route wherever its geometry is
    supported, else blockwise, else dense. An explicit block_size (> 0)
    keeps blockwise; -1 forces dense. `requested` overrides ('auto'/None =
    the rule); a requested 'pallas' whose geometry the gate refuses warns
    once and falls through the rule, the JAX package's own fallback.

    The gate is the JAX package's (`flash_attention_supported`), and the
    port's kernels take every geometry it passes, so the choice is the JAX
    package's (with `interpret=True`) at every head_dim. Where the gate
    refuses, both packages take the blockwise or dense route, their
    plain-tensor path, not a fallback from a kernel."""
    t_k = t_q if t_k is None else t_k
    req = None if requested in (None, "auto") else requested
    if req is not None and req not in ATTENTION_IMPLS:
        raise ValueError(f"attention impl {requested!r} not in "
                         f"{ATTENTION_IMPLS + ('auto',)}")
    if req == "dense":
        choice = "dense"
    else:
        blk = pick_block_size(t_q, block_size)
        ready = fa.flash_attention_supported(t_q, t_k, head_dim)
        if req == "pallas" and not ready:
            _warn_pallas_unavailable_once(t_q, head_dim)
            req = None
        if req == "pallas":
            choice = "pallas"
        elif req == "blockwise":
            choice = "blockwise" if blk else "dense"
        elif block_size == 0 and t_q >= 2048 and t_q == t_k and ready:
            choice = "pallas"
        else:
            choice = "blockwise" if blk else "dense"
    _count_attention_impl(choice)
    return choice


def single_device_attention(q: Tensor, k: Tensor, v: Tensor, *,
                            causal: bool = False,
                            key_mask: Optional[Tensor] = None,
                            segment_ids: Optional[Tensor] = None,
                            impl: Optional[str] = None,
                            block_size: int = 0) -> Tensor:
    """Dispatching front door for unsharded attention: the flash route,
    blockwise or dense per `select_attention_impl`, with dense_attention's
    signature and semantics. `segment_ids` ([batch, time] int) enables
    packed-batch attention; every impl applies the same masks."""
    choice = select_attention_impl(q.shape[1], q.shape[-1], requested=impl,
                                   block_size=block_size, t_k=k.shape[1])
    if choice == "pallas":
        return fa.flash_attention(q, k, v, causal=causal, key_mask=key_mask,
                                  segment_ids=segment_ids)
    if choice == "blockwise":
        blk = pick_block_size(q.shape[1], block_size)
        return blockwise_attention(q, k, v, causal=causal, key_mask=key_mask,
                                   segment_ids=segment_ids, q_block=blk,
                                   kv_block=blk)
    return dense_attention(q, k, v, causal=causal, key_mask=key_mask,
                           segment_ids=segment_ids)


def _acc(q: Tensor) -> torch.dtype:
    """At least float32, never demoting float64."""
    return torch.promote_types(q.dtype, torch.float32)


def dense_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
                    key_mask: Optional[Tensor] = None,
                    segment_ids: Optional[Tensor] = None,
                    kv_segment_ids: Optional[Tensor] = None) -> Tensor:
    """Plain softmax attention. q/k/v: [batch, time, heads, head_dim];
    key_mask: [batch, time_k] (> 0 = real key); segment_ids [batch, time_q]
    int (pairs with different ids masked; kv_segment_ids defaults to
    segment_ids). Float32 softmax; a query with no valid key outputs 0."""
    d = q.shape[-1]
    acc = _acc(q)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) / d ** 0.5
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = (torch.arange(tk, device=q.device)[None, :]
                <= torch.arange(tq, device=q.device)[:, None])
        scores = torch.where(mask[None, None], scores, NEG)
    if key_mask is not None:
        scores = torch.where(key_mask[:, None, None, :] > 0, scores, NEG)
    if segment_ids is not None:
        q_seg = torch.as_tensor(segment_ids, device=q.device).to(torch.int32)
        k_seg = q_seg if kv_segment_ids is None else \
            torch.as_tensor(kv_segment_ids, device=q.device).to(torch.int32)
        scores = torch.where(q_seg[:, None, :, None] == k_seg[:, None, None, :],
                             scores, NEG)
    elif kv_segment_ids is not None:
        raise ValueError("kv_segment_ids requires segment_ids")
    p = torch.softmax(scores, dim=-1)
    any_valid = scores.amax(-1, keepdim=True) > NEG / 2
    p = torch.where(any_valid, p, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _kv_block_step(qi, k_blk, v_blk, km_blk, ks_blk, qseg_i, m, l, o,
                   q_pos0, kv_pos0, causal):
    """One key/value block folded into the (m, l, o) online-softmax state of
    one query block ([b, h, qb] and [b, h, qb, d])."""
    acc = qi.dtype
    scores = torch.einsum("bqhd,bkhd->bhqk", qi, k_blk.to(acc))
    if causal:
        q_pos = q_pos0 + torch.arange(qi.shape[1], device=qi.device)
        kv_pos = kv_pos0 + torch.arange(k_blk.shape[1], device=qi.device)
        scores = torch.where((kv_pos[None, :] <= q_pos[:, None])[None, None],
                             scores, NEG)
    if km_blk is not None:
        scores = torch.where(km_blk[:, None, None, :] > 0, scores, NEG)
    if ks_blk is not None:
        same = qseg_i[:, :, None] == ks_blk[:, None, :]
        scores = torch.where(same[:, None], scores, NEG)
    new_m = torch.maximum(m, scores.amax(-1))
    corr = torch.exp(m - new_m)
    p = torch.exp(scores - new_m[..., None])
    p = torch.where(new_m[..., None] <= NEG / 2, torch.zeros_like(p), p)
    l = l * corr + p.sum(-1)
    o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.to(acc))
    return new_m, l, o


def blockwise_attention(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = False,
                        key_mask: Optional[Tensor] = None,
                        segment_ids: Optional[Tensor] = None,
                        q_block: int = 1024, kv_block: int = 1024) -> Tensor:
    """Memory-efficient attention on one device: dense_attention's math as
    an online softmax over key/value blocks, never holding the [T, T] score
    matrix. Causal runs visit only the blocks on or below the diagonal. Each
    block step is checkpointed (`torch.utils.checkpoint`, as the JAX package
    `jax.checkpoint`s it), so the backward recomputes block scores instead of
    saving them. Requires time % q_block == 0 and time % kv_block == 0."""
    b, t, h, d = q.shape
    if t % q_block or t % kv_block:
        raise ValueError(f"time {t} must divide q_block={q_block} and "
                         f"kv_block={kv_block}")
    nq, nk = t // q_block, t // kv_block
    acc = _acc(q)
    qf = (q.to(acc) / d ** 0.5).reshape(b, nq, q_block, h, d)
    kb = k.reshape(b, nk, kv_block, h, d)
    vb = v.reshape(b, nk, kv_block, h, d)
    kmb = None if key_mask is None else key_mask.reshape(b, nk, kv_block)
    sqb = skb = None
    if segment_ids is not None:
        seg = torch.as_tensor(segment_ids, device=q.device).to(torch.int32)
        if seg.ndim == 1:
            seg = seg.expand(b, t)
        sqb = seg.reshape(b, nq, q_block)
        skb = seg.reshape(b, nk, kv_block)
    outs = []
    for i in range(nq):  # causal: only the blocks on or below the diagonal
        q_pos0 = i * q_block
        hi = nk if not causal else \
            min(nk, (q_pos0 + q_block + kv_block - 1) // kv_block)
        m = torch.full((b, h, q_block), NEG, dtype=acc, device=q.device)
        l = torch.zeros((b, h, q_block), dtype=acc, device=q.device)
        o = torch.zeros((b, h, q_block, d), dtype=acc, device=q.device)
        qseg_i = None if sqb is None else sqb[:, i]
        for j in range(hi):
            m, l, o = checkpoint(
                _kv_block_step, qf[:, i], kb[:, j], vb[:, j],
                None if kmb is None else kmb[:, j],
                None if skb is None else skb[:, j], qseg_i, m, l, o,
                q_pos0, j * kv_block, causal, use_reentrant=False)
        out = o / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 2, 1, 3))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# Ring attention
# ---------------------------------------------------------------------------

def _ring_body(q: Tensor, k: Tensor, v: Tensor, key_mask: Optional[Tensor],
               my: int, n: int, causal: bool, block_size: int, hop) -> Tensor:
    """One shard's ring with the plain online softmax: local q/k/v blocks
    [b, t_loc, h, d] of seq shard `my` of `n`; `hop(block, s)` gives the
    (k, v, key mask) block held after hop s. With 0 < block_size < t_loc
    each visiting block is folded in sub-blocks of `block_size`, each step
    checkpointed (the blockwise recipe inside the ring)."""
    b, t_loc, h, d = q.shape
    acc = _acc(q)
    qf = q.to(acc) / d ** 0.5
    m = torch.full((b, h, t_loc), NEG, dtype=acc, device=q.device)
    l = torch.zeros((b, h, t_loc), dtype=acc, device=q.device)
    o = torch.zeros((b, h, t_loc, d), dtype=acc, device=q.device)
    block = (k, v, key_mask)
    for s in range(n):
        kb, vb, kmb = block
        kv_pos0 = ((my - s) % n) * t_loc
        if block_size and block_size < t_loc:
            for j in range(t_loc // block_size):
                sub = slice(j * block_size, (j + 1) * block_size)
                m, l, o = checkpoint(
                    _kv_block_step, qf, kb[:, sub], vb[:, sub],
                    None if kmb is None else kmb[:, sub], None, None, m, l, o,
                    my * t_loc, kv_pos0 + j * block_size, causal,
                    use_reentrant=False)
        else:
            m, l, o = _kv_block_step(qf, kb, vb, kmb, None, None, m, l, o,
                                     my * t_loc, kv_pos0, causal)
        if s < n - 1:   # the last block is never needed again
            block = hop(block, s + 1)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _ring_body_flash(q: Tensor, k: Tensor, v: Tensor,
                     key_mask: Optional[Tensor], my: int, n: int,
                     causal: bool, q_block: int, kv_block: int, hop) -> Tensor:
    """One shard's ring over the flash route: each hop is `flash_attention`
    of the local queries against the visiting block, at the global
    positions my * t_loc + i and src * t_loc + j, with the lse; the hops'
    normalized pairs merge as

        new = max(lse_acc, lse_hop),  w_i = exp(lse_i - new)
        o_acc = (o_acc w_acc + o_hop w_hop) / (w_acc + w_hop)
        lse_acc = new + log(w_acc + w_hop)

    in float32. A hop the masks hide whole comes back (0, NEG) and merges
    with weight 0; a row no hop lets see a key outputs 0, as
    dense_attention's does. The merge takes the lse, so its cotangent
    reaches the backward (g_lse in K4 and K5)."""
    b, t_loc, h, d = q.shape
    acc = _acc(q)
    q_pos = my * t_loc + torch.arange(t_loc, dtype=torch.int32, device=q.device)
    o_acc = torch.zeros((b, t_loc, h, d), dtype=acc, device=q.device)
    lse_acc = torch.full((b, t_loc, h), NEG, dtype=acc, device=q.device)
    block = (k, v, key_mask)
    for s in range(n):
        kb, vb, kmb = block
        kv_pos = ((my - s) % n) * t_loc + torch.arange(
            t_loc, dtype=torch.int32, device=q.device)
        o_hop, lse_hop = fa.flash_attention(
            q, kb, vb, causal=causal, key_mask=kmb, q_pos=q_pos, kv_pos=kv_pos,
            q_block=q_block, kv_block=kv_block, with_lse=True)
        lse_hop = lse_hop.to(acc)
        new = torch.maximum(lse_acc, lse_hop)
        w_acc = torch.exp(lse_acc - new)
        w_hop = torch.exp(lse_hop - new)
        denom = w_acc + w_hop
        o_acc = (o_acc * w_acc[..., None] + o_hop.to(acc) * w_hop[..., None]) \
            / denom[..., None]
        lse_acc = torch.where(new <= NEG / 2, NEG, new + torch.log(denom))
        if s < n - 1:
            block = hop(block, s + 1)
    return o_acc.to(q.dtype)


def _ring_route(t_loc: int, head_dim: int, block_size: int,
                use_flash: Optional[bool], q_block: int, kv_block: int) -> str:
    """The ring's inner step: "pallas" (the flash body) by default wherever
    the flash geometry is supported, else "blockwise" or "dense"."""
    if use_flash is None:
        use_flash = fa.flash_attention_supported(t_loc, t_loc, head_dim,
                                                 q_block=q_block,
                                                 kv_block=kv_block)
    if use_flash:
        return "pallas"
    return "blockwise" if block_size else "dense"


def _ring(route: str, q, k, v, key_mask, my, n, causal, block_size, q_block,
          kv_block, hop):
    if route == "pallas":
        return _ring_body_flash(q, k, v, key_mask, my, n, causal, q_block,
                                kv_block, hop)
    return _ring_body(q, k, v, key_mask, my, n, causal, block_size, hop)


def ring_self_attention(q: Tensor, k: Tensor, v: Tensor, mesh, *,
                        axis: str = "seq", causal: bool = False,
                        key_mask: Optional[Tensor] = None,
                        batch_axis: Optional[str] = None,
                        head_axis: Optional[str] = None,
                        block_size: int = 0,
                        use_flash: Optional[bool] = None,
                        flash_q_block: int = 0,
                        flash_kv_block: int = 0) -> Tensor:
    """Sequence-parallel attention over whole q/k/v [batch, time, heads,
    head_dim]: time cut over `axis` of `mesh` (batch over `batch_axis` and
    heads over `head_axis` where given), every shard's ring run in turn on
    its position's device, a hop moving the visiting block there; the
    output is whole again, on q's device. Differentiable through the hops.

    `use_flash`: None = the flash body wherever its geometry is supported
    (the JAX package's gate at the shard's time and the explicit blocks),
    True/False force it (the JAX package's `flash_interpret`, its CPU
    tests' switch, has no counterpart: the CPU runs the kernels' plain
    versions)."""
    n = mesh.axis_size(axis)
    t = q.shape[1]
    if t % n:
        raise ValueError(f"time axis {t} must divide the {n}-device "
                         f"'{axis}' mesh axis")
    nh = mesh.axis_size(head_axis) if head_axis is not None else 1
    if head_axis is not None and q.shape[2] % nh:
        raise ValueError(f"heads {q.shape[2]} must divide the {nh}-device "
                         f"'{head_axis}' mesh axis")
    t_loc = t // n
    if block_size and t_loc % block_size:
        raise ValueError(f"per-device time {t_loc} must divide "
                         f"block_size={block_size}")
    route = _ring_route(t_loc, q.shape[-1], block_size, use_flash,
                        flash_q_block, flash_kv_block)
    _count_attention_impl(route)
    nb = mesh.axis_size(batch_axis) if batch_axis is not None else 1
    if q.shape[0] % nb:
        raise ValueError(f"batch {q.shape[0]} must divide the {nb}-device "
                         f"'{batch_axis}' mesh axis")
    cut = lambda x, dim, i, c: x.narrow(dim, i * (x.shape[dim] // c),
                                        x.shape[dim] // c)
    rows = []
    for bi in range(nb):
        heads = []
        for hi in range(nh):
            def dev(my):
                at = {axis: my}
                if batch_axis is not None:
                    at[batch_axis] = bi
                if head_axis is not None:
                    at[head_axis] = hi
                return mesh.devices[mesh.position(**at)]

            def piece(x, my, head=True):
                x = cut(x, 0, bi, nb)
                if head:
                    x = cut(x, 2, hi, nh)
                return cut(x, 1, my, n).to(dev(my))

            blocks = [(piece(k, j), piece(v, j),
                       None if key_mask is None else piece(key_mask, j, False))
                      for j in range(n)]
            outs = []
            for my in range(n):
                hop = lambda block, s, my=my: tuple(
                    None if x is None else x.to(dev(my))
                    for x in blocks[(my - s) % n])
                kb, vb, kmb = blocks[my]
                outs.append(_ring(route, piece(q, my), kb, vb, kmb, my, n,
                                  causal, block_size, flash_q_block,
                                  flash_kv_block, hop).to(q.device))
            heads.append(torch.cat(outs, 1))
        rows.append(torch.cat(heads, 2))
    return torch.cat(rows, 0)


def ring_attention_shard(q: Tensor, k: Tensor, v: Tensor, my: int, n: int,
                         hop, *, causal: bool = False,
                         key_mask: Optional[Tensor] = None,
                         block_size: int = 0, count: bool = True) -> Tensor:
    """Shard `my` of an `n`-shard ring inside a sequence-parallel step: q/k/v
    [b, t_loc, h, d] are its blocks and `hop(block)` hands in the ring
    predecessor's (k, v, key mask) block. `count`: whether this call counts
    the ring's route (one shard of each ring does)."""
    t_loc = q.shape[1]
    if block_size and t_loc % block_size:
        raise ValueError(f"per-device time {t_loc} must divide "
                         f"block_size={block_size}")
    route = _ring_route(t_loc, q.shape[-1], block_size, None, 0, 0)
    if count:
        _count_attention_impl(route)
    return _ring(route, q, k, v, key_mask, my, n, causal, block_size, 0, 0,
                 lambda block, s: hop(block))
