"""Fused flash attention, forward and backward.

Port of `deeplearning4j_tpu/ops/flash_attention.py` (`flash_attention` with
its custom VJP: `_fwd_kernel` forward, `_bwd_dkv_kernel` and `_bwd_dq_kernel`
backward). Over q [batch, t_q, heads, d] and k, v [batch, t_k, heads, d]:

    s = q k^T / sqrt(d) under the masks,  lse = logsumexp(s),
    o = softmax(s) v,   ds = p (do v^T - di + g_lse),  di = rowsum(o do)
    dq = ds k / sqrt(d),  dk = ds^T q / sqrt(d),  dv = p^T do

Masks compose by conjunction: causal (kv_pos <= q_pos, int32 positions
compared as data), a key mask broadcast over heads, and segment ids. A query
row that no key may see gives o = 0 and lse = NEG. The lse is [batch, t_q,
heads] float32 and has a cotangent (`g_lse`), which the backward folds into
ds as the JAX package's does.

On CUDA tensors `FlashAttentionFunction` launches the hand-written kernels of
``csrc/flash_attention.cu``: K3 (`dl4j_flash_fwd`) forward, K4
(`dl4j_flash_bwd_dkv`) and K5 (`dl4j_flash_bwd_dq`) backward, float32 or
bfloat16 with float32 sums, at head_dim up to MAX_HEAD_DIM. Wider heads, and
the backward with a bfloat16 accumulator at any head_dim, run the sliced arms
at the end of the same file (`dl4j_flash_wide_fwd`,
`dl4j_flash_wide_bwd_dkv`, `dl4j_flash_wide_bwd_dq`), which cut head_dim
into chunks of 128 columns and have no head_dim limit of their own. They run
one thread-block cluster a tile, a block for each chunk (up to 8;
`wide_geometry`), which compute the tile's scores once, summed across the
cluster, and each write their own chunk of the output. The products run on
the tensor cores: bfloat16 on `wgmma` in the sliced arms and on `mma.sync`
elsewhere, float32 as three TF32 `mma.sync` products per
float32 one (the 3xTF32 split, which keeps float32 accuracy). The notes
there say what bounds them and how they are laid out. On CPU
tensors it runs `flash_fwd_reference` and `flash_bwd_reference`. There is no
fallback from one to the other: a CUDA tensor the kernels do not take raises.

`bwd_acc_dtype="bfloat16"` is the JAX package's backward accumulator knob.
Its kernels (`_bwd_dkv_kernel`, `_bwd_dq_kernel`) keep dk, dv and dq in a
bfloat16 scratch across their sequential sweep and, for each block of the
sweep (`q_block` query rows for dk and dv, `kv_block` keys for dq), add
that block's product into it: the dot carries `preferred_element_type=
bfloat16`, which XLA's CPU dot computes as a float32 sum rounded once to
bfloat16; for dk and dq that rounded product is multiplied by the softmax
scale, itself a bfloat16 there (a Python float against a bfloat16 array is
weakly typed), and rounded again; then the bfloat16 add rounds the running
sum:

    dv = bf16(dv + bf16(p_blk^T do_blk))
    dk = bf16(dk + bf16(bf16(ds_blk^T q_blk) * bf16(scale)))
    dq = bf16(dq + bf16(bf16(ds_blk k_blk) * bf16(scale)))

(a probe against the JAX kernels in interpret mode matched this bitwise in
bfloat16 and to the odd float32 rounding of the block product otherwise, and
no other placement of the roundings did). So the result depends on the block
size, and the plain version (`_bwd_reference` with `acc_blocks`) loops over
the JAX package's blocks and rounds where it rounds; the kernels take the
block size as an argument, sum their own tiles within one block in float32
and round at its edges.

`decode_attention` is the port of the JAX package's single-query decode
attention (`decode_attention`, which there runs `_fwd_kernel` with one query
row). On CUDA tensors it launches K7 (`dl4j_decode_attention` of
``csrc/decode_attention.cu``), a split-KV kernel that reads only the valid
prefix of the cache, with a wide arm (K7w) for head_dim 129-4096; on CPU
tensors it runs `decode_attention_reference`.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from . import cuda_build

Tensor = torch.Tensor

NEG = -1e30  # mask sentinel; matches ops/attention.py (finite: -inf NaNs grads)

#: The widest head the d <= 128 kernels (K3-K5 of ``flash_attention.cu``,
#: K7's first arm) take; wider heads go to the sliced arms, which take any
#: head_dim, and to K7's wide arm, up to DECODE_WIDE_MAX_HEAD_DIM. The flash
#: kernels tile by 64 query or key rows and mask the ragged edge, so any
#: t >= 1.
MAX_HEAD_DIM = 128

#: The JAX package's blocks (`DEFAULT_BLOCK_Q`, `DEFAULT_BLOCK_KV`), its
#: lane width and VMEM budget: the gate below is its rule, and the bfloat16
#: accumulator rounds at its block edges.
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_KV = 128
_LANE = 128
_VMEM_BUDGET = 8 * 1024 * 1024

#: Kernel launches made in this process, one count a kernel: `fwd_launches`
#: K3, `bwd_dkv_launches` K4 and `bwd_dq_launches` K5 (head_dim <= 128, float32
#: sums); `fwd_wide_launches`, `bwd_dkv_wide_launches` and
#: `bwd_dq_wide_launches` their sliced arms (head_dim > 128);
#: `bwd_dkv_acc16_launches` and `bwd_dq_acc16_launches` the sliced K4 and K5
#: with the bfloat16 accumulator (any head_dim). Tests and the chip smoke reset
#: them to 0 and read them to show a path ran through the kernels.
fwd_launches = 0
bwd_dkv_launches = 0
bwd_dq_launches = 0
fwd_wide_launches = 0
bwd_dkv_wide_launches = 0
bwd_dq_wide_launches = 0
bwd_dkv_acc16_launches = 0
bwd_dq_acc16_launches = 0
#: K7 launches, one for each `decode_attention` call on CUDA tensors:
#: `decode_launches` at head_dim <= 128, `decode_wide_launches` above
decode_launches = 0
decode_wide_launches = 0
_launches_lock = threading.Lock()

_POINTERS = {"dl4j_flash_fwd": 10, "dl4j_flash_bwd_dkv": 14,
             "dl4j_flash_bwd_dq": 13, "dl4j_flash_wide_fwd": 10,
             "dl4j_flash_wide_bwd_dkv": 14, "dl4j_flash_wide_bwd_dq": 13}
#: the wide entry points take the bfloat16 accumulator's block (0: float32)
_ACC_BLOCK = ("dl4j_flash_wide_bwd_dkv", "dl4j_flash_wide_bwd_dq")
_fns = {}

#: The sliced arms cut head_dim into chunks of WIDE_CHUNK columns. They (K3w,
#: K4w, K5w) launch one thread-block cluster a tile, one block a chunk up to
#: the portable cluster of MAX_CLUSTER; above that a block owns several
#: chunks and the tile runs in passes (`wide_geometry`).
WIDE_CHUNK = 128
MAX_CLUSTER = 8
#: Shared memory a block may take on the H100 (227 KB)
SMEM_LIMIT = 232_448
#: K3w's key tiles and K4w's query tiles, by input type; K3w's blocks an SM
_CLUSTER_KEYS = {torch.float32: 24, torch.bfloat16: 32}
FWD_BLOCKS_PER_SM = {torch.float32: 2, torch.bfloat16: 3}
_CLUSTER_QUERIES = {torch.float32: 32, torch.bfloat16: 64}
#: K5w's key tiles, and its layout by input type: two warpgroups (one S, one
#: dP, each half of dq's 128 columns; True) or one (False), whose bfloat16
#: accumulator then lives in shared memory
_DQ_KEYS = 32
DQ_SPLIT = {torch.float32: True, torch.bfloat16: False}


def wide_geometry(head_dim: int) -> dict:
    """How K3w, K4w and K5w cut head_dim (as the kernels' launch does): `chunks`
    of 128 columns; `passes`, the clusters a tile runs in (1 up to 8
    chunks); `cluster`, the blocks of one. Block `rank` owns the chunks
    rank, rank + cluster, ... of every operand and, in pass p, the output
    slice p * cluster + rank (none past the last chunk)."""
    nc = -(-head_dim // WIDE_CHUNK)
    passes = -(-nc // MAX_CLUSTER)
    return {"chunks": nc, "passes": passes, "cluster": -(-nc // passes)}


def wide_block_chunks(head_dim: int, rank: int, pass_: int) -> list:
    """The chunks block `rank` of pass `pass_` takes, in the order of its
    steps: its own chunks, the one of its output slice last (its ring slot
    then still holds what the products need)."""
    g = wide_geometry(head_dim)
    c = g["cluster"]
    steps = -(-(g["chunks"] - rank) // c)
    return [rank + c * ((pass_ + 1 + k) % steps) for k in range(steps)]


def load_width(head_dim: int, itemsize: int, ptrs) -> int:
    """Bytes a load of the sliced arms moves: the widest of 16, 8 and 4 that
    a row (head_dim * itemsize bytes) and every pointer divide, else one
    element."""
    for w in (16, 8, 4):
        if head_dim * itemsize % w == 0 and all(p % w == 0 for p in ptrs if p):
            return w
    return itemsize


def wide_smem(head_dim: int, dtype: torch.dtype) -> dict:
    """Dynamic shared memory (bytes) of K3w (`fwd`), K4w (`dkv`, and
    `dkv_acc16` with the bfloat16 accumulator) and K5w (`dq`, `dq_acc16`) at
    this head_dim: 1024 bytes of alignment slack; [rows x 128] tiles, padded
    16 bytes a row in float32 and swizzled without padding in bfloat16 (K3w:
    Q's chunk, and a two-slot ring of K and V tiles, which also carries Q's
    chunks above one pass; K4w: K's and V's chunks and a two-slot ring of Q's
    and dO's; K5w: Q's and dO's chunks and a two-slot ring of K's and V's,
    above one pass a ring of a Q or dO chunk beside a K or V chunk); the
    cluster's exchange buffers (a float4 a fragment a thread, two) and a
    pair's two mbarriers; K4w's P^T hand-over and K5w's p and dP hand-over
    (two warpgroups); the mask data; K5w's accumulator (one warpgroup)."""
    size = 4 if dtype == torch.float32 else 2
    tile = lambda rows: rows * (WIDE_CHUNK + (16 // size if size == 4 else 0)) * size
    bk, bq, dk = _CLUSTER_KEYS[dtype], _CLUSTER_QUERIES[dtype], _DQ_KEYS
    one = wide_geometry(head_dim)["passes"] == 1
    fwd = (1024 + (tile(64) if one else 0) + 2 * ((0 if one else tile(64)) + 2 * tile(bk))
           + 2 * (bk // 8) * 128 * 16 + 2 * 12 * bk + 16)
    dkv = (1024 + 2 * tile(64) + 4 * tile(bq) + 2 * (bq // 8) * 256 * 16
           + 4 * (bq // 8) * 32 * 16 + 2 * 20 * bq + 16)
    split = DQ_SPLIT[dtype]
    dq = (1024 + (2 * tile(64) if one else 0) + 2 * (2 * tile(dk) if one else tile(64) + tile(dk))
          + 2 * 2 * (dk // 8) * 128 * 16 + (2 * 4 * (dk // 8) * 32 * 16 if split else 0)
          + 2 * 12 * dk + 16)
    return {"fwd": fwd, "dkv": dkv, "dkv_acc16": dkv + 32 * 256 * 4, "dq": dq,
            "dq_acc16": dq + (0 if split else 32 * 128 * 4)}


def kernel_wide_geometry(head_dim: int, dtype: torch.dtype) -> dict:
    """`wide_geometry` and `wide_smem` as the CUDA source computes them
    (`dl4j_flash_wide_geometry`; builds the library)."""
    fn = _fns.get("dl4j_flash_wide_geometry")
    if fn is None:
        fn = getattr(cuda_build.load("flash_attention"), "dl4j_flash_wide_geometry")
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
        _fns["dl4j_flash_wide_geometry"] = fn
    out = (ctypes.c_longlong * 8)()
    if fn(head_dim, int(dtype == torch.bfloat16), out) != 0:
        raise ValueError(f"dl4j_flash_wide_geometry refused head_dim {head_dim}")
    return {"chunks": out[0], "passes": out[1], "cluster": out[2], "fwd": out[3],
            "dkv": out[4], "dkv_acc16": out[5], "dq": out[6], "dq_acc16": out[7]}


#: `kernel_dq_ring`'s names of the operands a K5w ring step loads
DQ_RING_OPERANDS = ("K V", "dO V", "Q K")


def kernel_dq_ring(head_dim: int, rank: int, pass_: int) -> list:
    """K5w's ring steps for each key tile, as the kernel takes them
    (`dl4j_flash_wide_dq_ring` reads the `dq_ring_step` that the kernel's
    loads and products call): [(chunk, operands)] for block `rank` of pass
    `pass_`. Builds the library; the card's check holds it against
    `wide_block_chunks`."""
    fn = _fns.get("dl4j_flash_wide_dq_ring")
    if fn is None:
        fn = cuda_build.load("flash_attention").dl4j_flash_wide_dq_ring
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        fn.restype = ctypes.c_int
        _fns["dl4j_flash_wide_dq_ring"] = fn
    cap = 2 * wide_geometry(head_dim)["chunks"]
    out = (ctypes.c_int * (2 * cap))()
    n = fn(head_dim, rank, pass_, out, cap)
    if n < 0:
        raise ValueError(f"dl4j_flash_wide_dq_ring refused head_dim {head_dim}, rank {rank}, "
                         f"pass {pass_}")
    return [(out[2 * i], DQ_RING_OPERANDS[out[2 * i + 1]]) for i in range(n)]


def _blocks_divide(t_q: int, t_k: int, q_block: int, kv_block: int) -> bool:
    """Explicit blocks (> 0) divide the time axes; 0 is always taken."""
    return not (q_block and t_q % q_block) and not (kv_block and t_k % kv_block)


def pick_kernel_block(t: int, want: int) -> int:
    """Largest divisor of t that is <= want (t >= 1): the JAX package's
    block rule (`pick_kernel_block`), copied."""
    b = max(1, min(want, t))
    while t % b:
        b -= 1
    return b


def flash_attention_supported(t_q: int, t_k: int, head_dim: int, *,
                              q_block: int = 0, kv_block: int = 0) -> bool:
    """The JAX package's geometry gate (`flash_attention_supported`): exact
    block tiling, with blocks from `pick_kernel_block(t, 128)` or the
    caller's, and its VMEM estimate of the dk/dv kernel, 4 ((2 qb + 4 kb) dp
    + 2 qb kb) bytes within 8 MiB, head_dim padded to dp, a multiple of 128.
    The port's kernels take every geometry it passes (and more: they tile by
    64 rows and need no exact tiling), so the card and the CPU choose the
    JAX package's route."""
    if t_q < 1 or t_k < 1 or head_dim < 1:
        return False
    qb = q_block or pick_kernel_block(t_q, DEFAULT_BLOCK_Q)
    kb = kv_block or pick_kernel_block(t_k, DEFAULT_BLOCK_KV)
    if t_q % qb or t_k % kb:
        return False
    dp = head_dim + ((-head_dim) % _LANE)
    return 4 * ((2 * qb + 4 * kb) * dp + 2 * qb * kb) <= _VMEM_BUDGET


# ---------------------------------------------------------------------------
# Plain versions: dense math, a chunk of (batch * head) slices at a time.
# ---------------------------------------------------------------------------

def _acc_dtype(t: Tensor) -> torch.dtype:
    """float32, or float64 for float64 inputs (gradient checks)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _fold(t: Tensor, acc: torch.dtype) -> Tensor:
    """[b, t, h, d] -> [b * h, t, d] in `acc`."""
    b, n, h, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * h, n, d).to(acc)


def _unfold(t3: Tensor, b: int, h: int, dtype: torch.dtype) -> Tensor:
    """[b * h, t, ...] -> contiguous [b, t, h, ...] in `dtype`."""
    return t3.reshape(b, h, *t3.shape[1:]).transpose(1, 2).to(dtype).contiguous()


def _chunks(n: int, per_slice: int):
    """(lo, hi) ranges over n slices, each holding at most 2**28 scores."""
    step = max(1, (1 << 28) // max(1, per_slice))
    return ((lo, min(n, lo + step)) for lo in range(0, n, step))


def _allowed(lo, hi, h, km, qs, ks, qp, kp, causal):
    """Which scores of slices [lo, hi) the masks keep: bool, broadcastable
    to [hi - lo, t_q, t_k]."""
    batch = torch.arange(lo, hi, device=qp.device) // h
    keep = torch.ones(1, qp.shape[0], kp.shape[0], dtype=torch.bool,
                      device=qp.device)
    if causal:
        keep = keep & (kp[None, :] <= qp[:, None])[None]
    if km is not None:
        keep = keep & (km[batch] > 0)[:, None, :]
    if qs is not None:
        keep = keep & (qs[batch][:, :, None] == ks[batch][:, None, :])
    return keep


def flash_fwd_reference(q, k, v, km, qs, ks, qp, kp, scale, causal):
    """Plain torch forward: (o [b, t_q, h, d] in q's dtype, lse [b, t_q, h]
    float32). In bfloat16, p is rounded to v's dtype before the p.v product,
    as `_fwd_kernel` does; every sum is float32."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    acc = _acc_dtype(q)
    q3, k3, v3 = _fold(q, acc), _fold(k, acc), _fold(v, acc)
    o3 = torch.empty(b * h, tq, d, dtype=acc, device=q.device)
    lse3 = torch.empty(b * h, tq, dtype=acc, device=q.device)
    for lo, hi in _chunks(b * h, tq * tk):
        s = torch.matmul(q3[lo:hi], k3[lo:hi].transpose(1, 2)) * scale
        s = torch.where(_allowed(lo, hi, h, km, qs, ks, qp, kp, causal), s, NEG)
        m = s.amax(-1, keepdim=True)
        p = torch.where(m > NEG / 2, torch.exp(s - m), 0.0)
        l = p.sum(-1, keepdim=True)
        pv = torch.matmul(p.to(v.dtype).to(acc), v3[lo:hi])
        o3[lo:hi] = pv * torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0), 0.0)
        lse3[lo:hi] = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)),
                                  NEG)[..., 0]
    return _unfold(o3, b, h, q.dtype), _unfold(lse3, b, h, acc)


def _bf16_round(x: Tensor) -> Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _bf16_sweep(parts, scale):
    """The JAX package's bfloat16 accumulator over one sweep: for each block's
    float32 product, acc = bf16(acc + bf16(bf16(product) * scale)), the
    scale a bfloat16 (None: dv, no scale). Returns acc (bfloat16 values)."""
    acc = None
    sb = None if scale is None else float(torch.tensor(scale, dtype=torch.bfloat16))
    for part in parts:
        x = _bf16_round(part)
        if sb is not None:
            x = _bf16_round(x * sb)
        acc = x if acc is None else _bf16_round(acc + x)
    return acc


def _bwd_reference(q, k, v, do, lse, di, gl, km, qs, ks, qp, kp, scale, causal,
                   want_dq, want_dkv, acc_blocks=(0, 0)):
    """dq and/or (dk, dv), each recomputing p and ds (as K5 and K4 do). With
    `acc_blocks` (qb, kb) nonzero, the bfloat16 accumulator: dk and dv summed
    over query blocks of qb rows, dq over key blocks of kb keys, each block's
    product rounded into a bfloat16 sum as the JAX kernels do
    (`_bf16_sweep`)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    qb, kb = acc_blocks
    if qb and (tq % qb or tk % kb):
        raise ValueError(f"time ({tq}, {tk}) must divide the accumulator's blocks "
                         f"({qb}, {kb})")
    acc = _acc_dtype(q)
    q3, k3, v3, do3 = (_fold(t, acc) for t in (q, k, v, do))
    row = lambda t: t.transpose(1, 2).reshape(b * h, tq, 1).to(acc)
    lse3, di3, gl3 = row(lse), row(di), row(gl)
    dq3, dk3, dv3 = (torch.empty_like(t) for t in (q3, k3, v3))
    for lo, hi in _chunks(b * h, tq * tk):
        sl = slice(lo, hi)
        s = torch.matmul(q3[sl], k3[sl].transpose(1, 2)) * scale
        keep = _allowed(lo, hi, h, km, qs, ks, qp, kp, causal) & (lse3[sl] > NEG / 2)
        p = torch.where(keep, torch.exp(s - lse3[sl]), 0.0)
        dp = torch.matmul(do3[sl], v3[sl].transpose(1, 2))
        ds = p * (dp - di3[sl] + gl3[sl])
        pt = lambda: p.to(do.dtype).to(acc).transpose(1, 2)
        dst = lambda: ds.to(q.dtype).to(acc).transpose(1, 2)
        dsk = lambda: ds.to(k.dtype).to(acc)
        if qb:   # the bfloat16 accumulator, block by block
            rows = [slice(j, j + qb) for j in range(0, tq, qb)]
            cols = [slice(j, j + kb) for j in range(0, tk, kb)]
            if want_dkv:
                pt_, dst_ = pt(), dst()
                dv3[sl] = _bf16_sweep((torch.matmul(pt_[:, :, r], do3[sl][:, r])
                                       for r in rows), None)
                dk3[sl] = _bf16_sweep((torch.matmul(dst_[:, :, r], q3[sl][:, r])
                                       for r in rows), scale)
            if want_dq:
                dsk_ = dsk()
                dq3[sl] = _bf16_sweep((torch.matmul(dsk_[:, :, c], k3[sl][:, c])
                                       for c in cols), scale)
            continue
        if want_dkv:
            dv3[sl] = torch.matmul(pt(), do3[sl])
            dk3[sl] = torch.matmul(dst(), q3[sl]) * scale
        if want_dq:
            dq3[sl] = torch.matmul(dsk(), k3[sl]) * scale
    out = (_unfold(dq3, b, h, q.dtype),) if want_dq else ()
    if want_dkv:
        out += (_unfold(dk3, b, h, k.dtype), _unfold(dv3, b, h, v.dtype))
    return out


def flash_bwd_dkv_reference(*args, acc_block: int = 0):
    """Plain torch (dk, dv), the function of K4: p recomputed from lse,
    ds = p (dp - di + g_lse), dv = p^T do, dk = scale ds^T q. In bfloat16, p
    and ds are rounded to the input type before the products, as
    `_bwd_dkv_kernel` does. Arguments as `flash_bwd_reference`'s;
    `acc_block` > 0: the bfloat16 accumulator over query blocks of that
    many rows."""
    return _bwd_reference(*args, want_dq=False, want_dkv=True,
                          acc_blocks=(acc_block, acc_block and args[1].shape[1]))


def flash_bwd_dq_reference(*args, acc_block: int = 0):
    """Plain torch dq = scale ds k, the function of K5 (`_bwd_dq_kernel`);
    `acc_block` > 0: the bfloat16 accumulator over key blocks of that many
    keys."""
    dq, = _bwd_reference(*args, want_dq=True, want_dkv=False,
                         acc_blocks=(acc_block and args[0].shape[1], acc_block))
    return dq


def flash_bwd_reference(q, k, v, do, lse, di, gl, km, qs, ks, qp, kp, scale,
                        causal, acc_blocks=(0, 0)):
    """Plain torch backward: (dq, dk, dv) in the inputs' dtypes from p
    recomputed from lse and ds = p (dp - di + g_lse), dq and dk scaled by
    `scale`. In bfloat16, p and ds are rounded to the input type before the
    dv and dk/dq products, as `_bwd_dkv_kernel` and `_bwd_dq_kernel` do.
    `acc_blocks` (qb, kb), nonzero: the bfloat16 accumulator, rounding at
    the edges of query blocks of qb rows (dk, dv) and key blocks of kb keys
    (dq)."""
    return _bwd_reference(q, k, v, do, lse, di, gl, km, qs, ks, qp, kp, scale,
                          causal, want_dq=True, want_dkv=True,
                          acc_blocks=acc_blocks)


# ---------------------------------------------------------------------------
# The CUDA kernels.
# ---------------------------------------------------------------------------

def _kernel_fn(name: str):
    """A C entry point of ``csrc/flash_attention.cu``, built and typed at
    first use."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(cuda_build.load("flash_attention"), name)
        fn.argtypes = [ctypes.c_void_p] * _POINTERS[name] + [
            ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int] + (
            [ctypes.c_int] if name in _ACC_BLOCK else []) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _check_kernel_inputs(q, k, v, km, qs, ks, qp, kp):
    """Raise on anything the kernels do not take; returns (b, h, tq, tk, d)."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (b, tk, h, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not [b, t, h, d] alike")
    if d < 1 or b * h > 65535:
        raise ValueError(f"flash attention kernels take head_dim >= 1 and batch * "
                         f"heads <= 65535 (a grid dimension), got {d} and {b * h}")
    want = [(km, torch.float32, (b, tk)), (qs, torch.int32, (b, tq)),
            (ks, torch.int32, (b, tk)), (qp, torch.int32, (tq,)),
            (kp, torch.int32, (tk,))]
    for t in (q, k, v) + tuple(w[0] for w in want):
        if t is not None and (t.device != q.device or not t.is_contiguous()):
            raise ValueError("flash attention kernels need contiguous tensors on "
                             "one CUDA device")
    for t, dtype, shape in want:
        if t is not None and (t.dtype != dtype or tuple(t.shape) != shape):
            raise ValueError(f"mask operand {t.dtype} {tuple(t.shape)}: expected "
                             f"{dtype} {shape}")
    return b, h, tq, tk, d


def _launch(name: str, ptrs, dims, scale, causal, bf16, device, acc_block=None):
    fn = _kernel_fn(name)
    extra = () if acc_block is None else (int(acc_block),)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, *dims, float(scale), int(causal), int(bf16), *extra, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _count(name: str):
    with _launches_lock:
        globals()[name] += 1


def _launch_fwd(q, k, v, km, qs, ks, qp, kp, scale, causal):
    """K3 (head_dim <= MAX_HEAD_DIM) or its sliced arm: (o, lse)."""
    b, h, tq, tk, d = _check_kernel_inputs(q, k, v, km, qs, ks, qp, kp)
    o = torch.empty_like(q)
    lse = torch.empty(b, tq, h, dtype=torch.float32, device=q.device)
    wide = d > MAX_HEAD_DIM
    _launch("dl4j_flash_wide_fwd" if wide else "dl4j_flash_fwd",
            [_ptr(t) for t in (q, k, v, km, qs, ks, qp, kp, o, lse)],
            (b, h, tq, tk, d), scale, causal, q.dtype == torch.bfloat16, q.device)
    _count("fwd_wide_launches" if wide else "fwd_launches")
    return o, lse


def _bwd_args(q, k, v, do, lse, di, gl, km, qs, ks, qp, kp):
    """Check the backward's operands; returns (the pointers both backward
    kernels take first, (b, h, tq, tk, d))."""
    dims = _check_kernel_inputs(q, k, v, km, qs, ks, qp, kp)
    b, h, tq = dims[:3]
    for t, shape, dtype in ((do, q.shape, q.dtype), (lse, (b, tq, h), torch.float32),
                            (di, (b, tq, h), torch.float32),
                            (gl, (b, tq, h), torch.float32)):
        if (t.shape != shape or t.dtype != dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"backward operand {t.dtype} {tuple(t.shape)}: "
                             f"expected contiguous {dtype} {tuple(shape)}")
    return [_ptr(t) for t in (q, k, v, do, lse, di, gl, km, qs, ks, qp, kp)], dims


def _bwd_arm(kernel: str, d: int, acc_block: int, t: int):
    """(entry point, launch counter, the block passed) of K4 ("dkv") or K5
    ("dq"): the d <= 128 kernel for float32 sums, else the sliced arm;
    acc_block > 0 (the bfloat16 accumulator) must divide t, the swept axis."""
    if acc_block < 0 or (acc_block and t % acc_block):
        raise ValueError(f"the bfloat16 accumulator's block {acc_block} must "
                         f"divide the swept axis ({t})")
    if acc_block:
        return f"dl4j_flash_wide_bwd_{kernel}", f"bwd_{kernel}_acc16_launches", acc_block
    if d > MAX_HEAD_DIM:
        return f"dl4j_flash_wide_bwd_{kernel}", f"bwd_{kernel}_wide_launches", 0
    return f"dl4j_flash_bwd_{kernel}", f"bwd_{kernel}_launches", None


def _launch_bwd_dkv(q, k, v, do, lse, di, gl, km, qs, ks, qp, kp, scale, causal,
                    acc_block: int = 0):
    """K4 or its sliced arm: (dk, dv); `acc_block` > 0 the bfloat16
    accumulator over query blocks of that many rows."""
    ptrs, dims = _bwd_args(q, k, v, do, lse, di, gl, km, qs, ks, qp, kp)
    name, counter, block = _bwd_arm("dkv", dims[4], acc_block, dims[2])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(name, ptrs + [_ptr(dk), _ptr(dv)], dims, scale, causal,
            q.dtype == torch.bfloat16, q.device, block)
    _count(counter)
    return dk, dv


def _launch_bwd_dq(q, k, v, do, lse, di, gl, km, qs, ks, qp, kp, scale, causal,
                   acc_block: int = 0):
    """K5 or its sliced arm: dq; `acc_block` > 0 the bfloat16 accumulator
    over key blocks of that many keys."""
    ptrs, dims = _bwd_args(q, k, v, do, lse, di, gl, km, qs, ks, qp, kp)
    name, counter, block = _bwd_arm("dq", dims[4], acc_block, dims[3])
    dq = torch.empty_like(q)
    _launch(name, ptrs + [_ptr(dq)], dims, scale, causal,
            q.dtype == torch.bfloat16, q.device, block)
    _count(counter)
    return dq


def _check_device(q: Tensor):
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, got {q.device}")


def flash_fwd(q, k, v, km, qs, ks, qp, kp, scale, causal):
    """(o, lse) without autograd: K3 for CUDA tensors, `flash_fwd_reference`
    for CPU tensors."""
    _check_device(q)
    if q.device.type == "cuda":
        return _launch_fwd(q, k, v, km, qs, ks, qp, kp, scale, causal)
    return flash_fwd_reference(q, k, v, km, qs, ks, qp, kp, scale, causal)


def flash_bwd(q, k, v, do, lse, di, gl, km, qs, ks, qp, kp, scale, causal,
              acc_blocks=(0, 0)):
    """(dq, dk, dv): K4 then K5 for CUDA tensors, `flash_bwd_reference` for
    CPU tensors; `acc_blocks` (qb, kb) nonzero: the bfloat16 accumulator."""
    _check_device(q)
    args = (q, k, v, do, lse, di, gl, km, qs, ks, qp, kp, scale, causal)
    if q.device.type == "cuda":
        dk, dv = _launch_bwd_dkv(*args, acc_block=acc_blocks[0])
        return _launch_bwd_dq(*args, acc_block=acc_blocks[1]), dk, dv
    return flash_bwd_reference(*args, acc_blocks=acc_blocks)


class FlashAttentionFunction(torch.autograd.Function):
    """(o, lse) with their backward. Saves q, k, v, o and lse, as
    `_flash_fwd` does; the backward takes di = rowsum(o do) in float32 with
    a torch op, then runs `flash_bwd` (with `acc_blocks`, the bfloat16
    accumulator's blocks, (0, 0) for float32 sums). Autograd hands a
    cotangent of zeros for an output the caller did not use (lse, usually),
    so g_lse = 0 then. The masks, segment ids and positions get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, km, qs, ks, qp, kp, scale, causal, acc_blocks=(0, 0)):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_fwd(q, k, v, km, qs, ks, qp, kp, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse, km, qs, ks, qp, kp)
        ctx.scale, ctx.causal, ctx.acc_blocks = scale, causal, acc_blocks
        return o, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, g_lse):
        q, k, v, o, lse, km, qs, ks, qp, kp = ctx.saved_tensors
        do = do.contiguous()
        di = (o.to(lse.dtype) * do.to(lse.dtype)).sum(-1)
        kw = {"acc_blocks": ctx.acc_blocks} if any(ctx.acc_blocks) else {}
        dq, dk, dv = flash_bwd(q, k, v, do, lse, di, g_lse.to(lse.dtype).contiguous(),
                               km, qs, ks, qp, kp, ctx.scale, ctx.causal, **kw)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
                    key_mask: Optional[Tensor] = None,
                    segment_ids: Optional[Tensor] = None,
                    kv_segment_ids: Optional[Tensor] = None,
                    q_pos: Optional[Tensor] = None,
                    kv_pos: Optional[Tensor] = None, q_block: int = 0,
                    kv_block: int = 0, with_lse: bool = False,
                    bwd_acc_dtype: str = "float32"):
    """Fused flash attention over [batch, time, heads, head_dim], with the
    semantics of the JAX package's `flash_attention`.

    `key_mask` [batch, t_k] (> 0 = a real key) is broadcast over heads.
    `segment_ids` ([batch, t_q] or 1-D [t_q], shared by the batch) mask every
    pair whose ids differ; `kv_segment_ids` defaults to `segment_ids` and
    needs it. `q_pos`/`kv_pos` (1-D int) replace the arange positions of the
    causal mask. The softmax scale is 1/sqrt(head_dim). A query row with no
    key to see outputs 0 (and lse NEG). `with_lse=True` also returns the lse,
    [batch, t_q, heads] float32, whose cotangent is taken. `q_block` and
    `kv_block` keep the JAX package's contract (explicit blocks must divide
    the time axes, else ValueError; 0 picks `pick_kernel_block(t, 128)`); the
    CUDA kernels tile by 64 rows and mask the ragged edge themselves, and
    the blocks matter only to `bwd_acc_dtype="bfloat16"`, the JAX package's
    bfloat16 backward accumulator, which rounds at their edges (module
    docstring)."""
    if str(bwd_acc_dtype) not in ("float32", "bfloat16"):
        raise ValueError(f"bwd_acc_dtype must be 'float32' or 'bfloat16', got "
                         f"{bwd_acc_dtype!r}")
    b, tq, hh, d = q.shape
    tk = k.shape[1]
    if not _blocks_divide(tq, tk, q_block, kv_block):
        raise ValueError(f"time ({tq}, {tk}) must divide blocks ({q_block}, "
                         f"{kv_block})")
    acc_blocks = (0, 0)
    if str(bwd_acc_dtype) == "bfloat16":
        acc_blocks = (q_block or pick_kernel_block(tq, DEFAULT_BLOCK_Q),
                      kv_block or pick_kernel_block(tk, DEFAULT_BLOCK_KV))
    dev = q.device
    as_int = lambda t: torch.as_tensor(t, device=dev).to(torch.int32)
    km = None if key_mask is None else \
        torch.as_tensor(key_mask, device=dev).to(torch.float32).contiguous()
    qp = (torch.arange(tq, dtype=torch.int32, device=dev) if q_pos is None
          else as_int(q_pos).reshape(tq).contiguous())
    kp = (torch.arange(tk, dtype=torch.int32, device=dev) if kv_pos is None
          else as_int(kv_pos).reshape(tk).contiguous())
    if kv_segment_ids is not None and segment_ids is None:
        raise ValueError("kv_segment_ids requires segment_ids")
    qs = ks = None
    if segment_ids is not None:
        def seg_rows(seg, t):  # -> [b, t] int32
            seg = as_int(seg)
            return (seg.expand(b, t) if seg.ndim == 1 else seg).contiguous()
        qs = seg_rows(segment_ids, tq)
        ks = seg_rows(segment_ids if kv_segment_ids is None else kv_segment_ids, tk)
    # the softmax scale uses the true head_dim (the JAX package pads it to 128)
    o, lse = FlashAttentionFunction.apply(q, k, v, km, qs, ks, qp, kp,
                                          1.0 / math.sqrt(d), bool(causal),
                                          acc_blocks)
    return (o, lse) if with_lse else o


# ---------------------------------------------------------------------------
# Decode: one query row against a KV cache (K7).
# ---------------------------------------------------------------------------

DECODE_IMPLS = ("auto", "flash", "dense")
#: K7's split rule (`decode_splits`): about DECODE_BLOCKS_PER_SM blocks an SM
#: in all, a block for every DECODE_MIN_CHUNK keys of the bucket at most, and
#: no more than DECODE_MAX_SPLITS blocks a (row, head), the portable cluster
#: that merges them. The host cannot see cache_len (it lives on the device),
#: so the rule reads the bucket length; each row's keys are then split by its
#: own length on the device. Measured on an H100 (chip_smoke.py's
#: `ms_by_splits`): at the decode engine's 32 (row, head) pairs a 64-key
#: bucket is fastest on one block, a 256-key bucket on two (one block takes
#: its keys in too many dependent steps, four pay more in cluster barriers
#: than they save); 64 pairs of 8192 keys want the whole cluster of 8.
DECODE_MIN_CHUNK = 128
DECODE_BLOCKS_PER_SM = 4
DECODE_MAX_SPLITS = 8
#: K7w's split rule (`decode_wide_splits`, head_dim > 128): at most
#: DECODE_WIDE_BLOCKS_PER_SM blocks an SM in all (its ring takes most of an
#: SM's shared memory, so more blocks wait for a second wave), each taking at
#: least DECODE_WIDE_MIN_BYTES of K and V of the bucket, at most
#: DECODE_MAX_SPLITS blocks a (row, head). Set from chip_smoke.py's cold
#: `ms_cold_by_splits` at DECODE_WIDE_CASES on an H100 (what the engine sees:
#: K and V from device memory): 64 (row, head) pairs of 256-wide heads take
#: two blocks each at 512 KB of bucket a (row, head) (a float32 256-key
#: bucket), one at 256 KB or less (the wide decoder's 128-key bucket, or
#: bfloat16), where a second block's merge costs more than it saves; the 8
#: pairs at head_dim 2688 take eight.
DECODE_WIDE_BLOCKS_PER_SM = 1
DECODE_WIDE_MIN_BYTES = 256 * 1024
#: The widest head K7w takes; past it the wrapper raises
DECODE_WIDE_MAX_HEAD_DIM = 4096
#: K7w's cut of a row and its ring (`decode_wide_geometry`, as
#: csrc/decode_attention.cu's `wide_geometry`)
_DW_THREADS = 256
_DW_WARPS = _DW_THREADS // 32
_DW_MIN_GROUP = 8
_DW_MAX_GROUPS = _DW_THREADS // _DW_MIN_GROUP
_DW_MAX_STAGES = 6
_DW_RING = 192 * 1024
_DW_TWO_KEY_STAGE = 64 * 1024   # a group takes two keys a tile up to this stage


def _decode_valid(cache_len: Tensor, tk: int, device) -> Tensor:
    """[b, tk] bool: key j of row i is in its valid prefix."""
    n = torch.as_tensor(cache_len, device=device).to(torch.int64)
    return torch.arange(tk, device=device)[None, :] < n[:, None]


def decode_attention_reference(q: Tensor, k: Tensor, v: Tensor,
                               cache_len: Tensor) -> Tensor:
    """Plain torch version of K7: for each row i and head, the softmax of
    q k^T / sqrt(d) over the first cache_len[i] keys (all t_kv where it is
    larger) times v, sums in float32 (float64 for float64 inputs), the
    output rounded once to q's dtype; a row with cache_len <= 0 outputs 0,
    as a fully masked row of the flash arm. Keys past a row's prefix weigh
    exactly 0 and, as in K7, whatever they hold (NaN too) never reaches the
    output."""
    d = q.shape[-1]
    acc = _acc_dtype(q)
    valid = _decode_valid(cache_len, k.shape[1], q.device)
    keys = valid[:, :, None, None]
    k = torch.where(keys, k.to(acc), 0.0)
    v = torch.where(keys, v.to(acc), 0.0)
    valid = valid[:, None, None, :]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k) / math.sqrt(d)
    s = torch.where(valid, s, NEG)
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    p = p / torch.where(l > 0, l, 1.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def _decode_dense(q: Tensor, k: Tensor, v: Tensor, cache_len: Tensor) -> Tensor:
    """The JAX function's dense arm: float32 scores, NEG where masked, a
    softmax, and the weights cast to v's dtype before the product."""
    d = q.shape[-1]
    acc = _acc_dtype(q)
    valid = _decode_valid(cache_len, k.shape[1], q.device)[:, None, None, :]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) / math.sqrt(d)
    w = torch.softmax(torch.where(valid, s, NEG), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v).to(q.dtype)


_sm_count = {}


def decode_splits(device: torch.device, bh: int, t_kv: int) -> int:
    """K7's blocks a (row, head), 1..DECODE_MAX_SPLITS: enough for
    DECODE_BLOCKS_PER_SM an SM, each taking at least DECODE_MIN_CHUNK keys
    of the bucket. Reads no device tensor: the same (SM count, bh, t_kv)
    always give the same count."""
    want = -(-DECODE_BLOCKS_PER_SM * _sms(device) // max(1, bh))
    return max(1, min(want, -(-t_kv // DECODE_MIN_CHUNK), DECODE_MAX_SPLITS))


def _sms(device: torch.device) -> int:
    sms = _sm_count.get(device.index)
    if sms is None:
        sms = _sm_count[device.index] = \
            torch.cuda.get_device_properties(device).multi_processor_count
    return sms


def decode_wide_splits(device: torch.device, bh: int, t_kv: int, head_dim: int,
                       itemsize: int) -> int:
    """K7w's blocks a (row, head), 1..DECODE_MAX_SPLITS: no more than
    DECODE_WIDE_BLOCKS_PER_SM an SM in all, each taking at least
    DECODE_WIDE_MIN_BYTES of the bucket's K and V (2 head_dim itemsize bytes
    a key). Reads no device tensor: the same arguments always give the same
    count."""
    want = DECODE_WIDE_BLOCKS_PER_SM * _sms(device) // max(1, bh)
    by_bytes = -(-t_kv * 2 * head_dim * itemsize // DECODE_WIDE_MIN_BYTES)
    return max(1, min(want, by_bytes, DECODE_MAX_SPLITS))


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def decode_wide_geometry(head_dim: int, dtype: torch.dtype, vec: bool = True) -> dict:
    """K7w's cut at this head_dim, on the 16-byte route (`vec`) or the
    element route, as csrc/decode_attention.cu's `wide_geometry` computes
    it: a block of `threads` in groups of `group` threads that share a key,
    each thread holding `per` pieces (16 bytes, or one element) of a row, at
    most 32 floats; `keys` keys a group (1 or 2) and `tile` keys a block a
    tile; a ring of `stages` tiles of K and V; `smem` bytes of dynamic shared
    memory (0 where the arm refuses the head_dim)."""
    elem = 2 if dtype == torch.bfloat16 else 4
    vw = 16 // elem if vec else 1
    most = (8 if elem == 4 else 4) if vec else 16
    pieces = -(-head_dim // vw)
    group = _DW_MIN_GROUP
    while group < _DW_THREADS and -(-pieces // group) > most:
        group *= 2
    need = -(-pieces // group)
    out = {"threads": _DW_THREADS, "group": group, "per": 0, "keys": 0, "tile": 0,
           "stages": 0, "smem": 0}
    if head_dim <= MAX_HEAD_DIM or head_dim > DECODE_WIDE_MAX_HEAD_DIM or need > most:
        return out
    if not vec:
        per = 8 if need <= 8 else 16
    elif elem == 2:
        per = max(2, need)
    else:
        per = next(p for p in (2, 4, 6, 8) if need <= p)
    groups = _DW_THREADS // group
    row = _round16(per * group * vw * elem)
    keys = 2 if groups * 2 * 2 * row <= _DW_TWO_KEY_STAGE else 1
    tile = groups * keys
    stage = tile * 2 * row
    stages = min(max(_DW_RING // stage, 2), _DW_MAX_STAGES)
    cols = pieces * vw
    area = max(stages * stage, _round16(groups * cols * 4))
    tail = (2 * _DW_WARPS * 2 * 4 + 3 * _DW_MAX_GROUPS * 4 + 16
            + _round16((cols + 3 * DECODE_MAX_SPLITS) * 4))
    out.update(per=per, keys=keys, tile=tile, stages=stages, smem=area + tail)
    return out


def kernel_decode_wide_geometry(head_dim: int, dtype: torch.dtype, vec: bool = True) -> dict:
    """`decode_wide_geometry` as the CUDA source computes it
    (`dl4j_decode_wide_geometry`; builds the library). Raises where the
    arm refuses the head_dim."""
    fn = _fns.get("dl4j_decode_wide_geometry")
    if fn is None:
        fn = cuda_build.load("decode_attention").dl4j_decode_wide_geometry
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
        _fns["dl4j_decode_wide_geometry"] = fn
    out = (ctypes.c_longlong * 7)()
    if fn(head_dim, int(dtype == torch.bfloat16), int(vec), out) != 0:
        raise ValueError(f"dl4j_decode_wide_geometry refused head_dim {head_dim}")
    return dict(zip(("threads", "group", "per", "keys", "tile", "stages", "smem"), out))


def _launch_decode(q: Tensor, k: Tensor, v: Tensor, cache_len: Tensor, *,
                   splits: Optional[int] = None) -> Tensor:
    """K7 on CUDA tensors, one launch; raises on anything it does not take.
    `splits` overrides `decode_splits` (for measuring the rule). Above
    MAX_HEAD_DIM, up to DECODE_WIDE_MAX_HEAD_DIM, the kernel's wide arm
    (K7w) runs, its splits from `decode_wide_splits`."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the decode kernel takes float32 or bfloat16, got {q.dtype}")
    b, _, h, d = q.shape
    tk = k.shape[1]
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (b, tk, h, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected [b, 1, h, d] and [b, t, h, d]")
    if d < 1:
        raise ValueError(f"the decode kernel takes head_dim >= 1, got {d}")
    for t in (k, v):   # any batch and key strides; heads and rows contiguous
        if t.device != q.device or t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError("k and v must lie on q's device with each key's "
                             "heads contiguous ([b, t, h, d] strides (*, *, d, 1))")
    q = q.contiguous()
    lens = cache_len.to(device=q.device, dtype=torch.int32).contiguous()
    if lens.shape != (b,):
        raise ValueError(f"cache_len {tuple(lens.shape)}: expected ({b},)")
    wide = d > MAX_HEAD_DIM
    if d > DECODE_WIDE_MAX_HEAD_DIM:
        raise ValueError(f"the decode kernel takes head_dim <= "
                         f"{DECODE_WIDE_MAX_HEAD_DIM}, got {d}")
    if splits is None:
        splits = (decode_wide_splits(q.device, b * h, tk, d, q.element_size()) if wide
                  else decode_splits(q.device, b * h, tk))
    elif not 1 <= splits <= DECODE_MAX_SPLITS:
        raise ValueError(f"splits {splits}: the decode kernel takes 1.."
                         f"{DECODE_MAX_SPLITS}")
    if b * h * splits > 2 ** 31 - 1:
        raise ValueError(f"the decode kernel takes batch * heads * splits <= 2**31 - 1 "
                         f"(its grid), got {b} * {h} * {splits}")
    o = torch.empty_like(q)
    fn = _fns.get("dl4j_decode_attention")
    if fn is None:
        fn = cuda_build.load("decode_attention").dl4j_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["dl4j_decode_attention"] = fn
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                 o.data_ptr(), b, h, tk, d, k.stride(0), k.stride(1), v.stride(0),
                 v.stride(1), splits, int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"dl4j_decode_attention launch failed: CUDA error {err}")
    _count("decode_wide_launches" if wide else "decode_launches")
    return o


def decode_attention(q: Tensor, k: Tensor, v: Tensor, cache_len, *,
                     impl: str = "auto") -> Tensor:
    """Single-query-row attention against a growing KV cache, with the
    semantics of the JAX package's `decode_attention`.

    q [batch, 1, heads, head_dim] is this step's query; k, v [batch, t_kv,
    heads, head_dim] the bucketed cache view (rows past cache_len are
    garbage and never weigh); cache_len [batch] int, the valid prefix of
    each row including the current token. Returns [batch, 1, heads,
    head_dim] in q's dtype.

    `impl="flash"` launches K7 on CUDA tensors (a geometry K7 does not take
    raises there) and runs `decode_attention_reference` on CPU tensors;
    `"dense"` is the JAX function's einsum arm; `"auto"` is "flash" where the
    JAX package's gate (`flash_attention_supported(1, t_kv, head_dim)`)
    passes and "dense" where it refuses, as the JAX function chooses. No
    backward: decode is inference only."""
    b, tq, hh, d = q.shape
    if tq != 1:
        raise ValueError(f"decode_attention takes one query row, got {tq}")
    if impl not in DECODE_IMPLS:
        raise ValueError(f"unknown decode_attention impl {impl!r}")
    _check_device(q)
    cache_len = torch.as_tensor(cache_len, device=q.device)
    if impl == "dense" or (impl == "auto" and not flash_attention_supported(
            1, k.shape[1], d)):
        return _decode_dense(q, k, v, cache_len)
    if q.device.type == "cuda":
        return _launch_decode(q, k, v, cache_len)
    return decode_attention_reference(q, k, v, cache_len)
