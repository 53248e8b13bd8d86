"""Heads wider than 128 and the bfloat16 backward accumulator in the torch
port, against the JAX package on the CPU.

Inputs come from a numpy seed. The JAX package's Pallas kernels run in
interpret mode (`interpret=True`), as its own tests run them; the port runs
its kernels' plain versions (on the card the same wrappers launch the sliced
arms of ``csrc/flash_attention.cu`` and K7's sliced arm).

- `flash_attention` forward (o, lse) and backward (dq, dk, dv, with an lse
  cotangent) at head_dim 256 and 300, t 64, causal, with a key mask (rows
  that see no key) and with packed segments. The JAX package pads head_dim
  to 256 and 384 lanes and scales by the true head_dim; so does the port's
  scale. Tolerance: rtol 1e-5 / atol 1e-5 on o and lse, and on gradients
  rtol 1e-5 / atol 3e-5 (sums of 64 products over 256-300 terms each, taken
  in another order).
- `decode_attention` at head_dim 256 against the JAX function's dense arm:
  rtol 1e-5 / atol 1e-6; at 131, 300 and 2688 (ragged lengths, a row at
  cache_len 0) against its dense arm and its flash arm in interpret mode:
  rtol 1e-5, atol 1e-6 for each 128 of head_dim.
- A 2-layer SelfAttentionLayer network, 512 wide over 2 heads, t 32: the
  JAX network holds the port's parameters (params_to_numpy) and runs dense
  attention (its Pallas probe fails off-TPU); the port runs the flash route
  (`attention_impl="pallas"`). output, score and every gradient: rtol 1e-5
  / atol 1e-6, gradients atol 1e-5.
- A 1-layer TransformerDecoder with 2 heads of 256 carrying the JAX
  package's weights: prefill, then 6 greedy steps on KV views each package
  keeps itself; logits within rtol 1e-5 / atol 1e-5 and the same tokens.
- `bwd_acc_dtype="bfloat16"` at q_block = kv_block 32 and 128 (head_dim 24,
  so the softmax scale is not a power of two and its bfloat16 rounding
  shows): float32 inputs through `flash_attention` forward and backward,
  bfloat16 inputs through the backward on the JAX forward's o and lse (the
  two bfloat16 forwards differ by rounding, which would move every rounding
  of the backward). The bound: the mean |port - JAX| under a tenth of each
  of two differences in the JAX package's own results on the same inputs,
  bfloat16 at block 32 against block 128 and float32 against bfloat16
  accumulation, and the largest under a quarter of the smaller of their
  largest. A port that ignores the block size, or sums in float32, breaks
  it (checked on both).

The JAX modules are imported at the top: this file runs only where JAX is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
import deeplearning4j_tpu as ref
from deeplearning4j_torch.ops import attention as port_att
from deeplearning4j_torch.ops import flash_attention as port_fa
from deeplearning4j_torch.serving import decode as td
from deeplearning4j_torch.utils import params as port_params
from deeplearning4j_tpu.nn.conf.builders import \
    MultiLayerConfiguration as RefConfiguration
from deeplearning4j_tpu.ops import attention as ref_att
from deeplearning4j_tpu.ops import flash_attention as ref_fa
from deeplearning4j_tpu.serving import decode as jd
from test_torch_word2vec import one_torch_thread  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-5, atol=3e-5)


def _inputs(seed, b, t, h, d):
    rng = np.random.default_rng(seed)
    q, k, v, g_o = (rng.standard_normal((b, t, h, d)).astype(np.float32)
                    for _ in range(4))
    g_lse = rng.standard_normal((b, t, h)).astype(np.float32)
    return q, k, v, g_o, g_lse


def _port(q, k, v, g_o, g_lse, dtype=torch.float32, **kw):
    """(o, lse, dq, dk, dv) of the port's flash_attention and autograd."""
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    args = {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for n, a in kw.items()}
    o, lse = port_fa.flash_attention(*ts, with_lse=True, **args)
    torch.autograd.backward([o, lse], [torch.from_numpy(g_o).to(dtype),
                                       torch.from_numpy(g_lse)])
    return [t.detach().float().numpy() for t in (o, lse)] + \
        [t.grad.float().numpy() for t in ts]


def _jax(q, k, v, g_o, g_lse, dtype=jnp.float32, **kw):
    """(o, lse, dq, dk, dv) of the JAX package's Pallas kernels, interpreted,
    in one jitted function."""
    args = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for n, a in kw.items()}
    statics = {n: a for n, a in args.items() if not hasattr(a, "shape")}
    arrays = {n: a for n, a in args.items() if hasattr(a, "shape")}

    @jax.jit
    def run(a, b, c, go, gl, arrays):
        out, vjp = jax.vjp(lambda x, y, z: ref_fa.flash_attention(
            x, y, z, interpret=True, with_lse=True, **statics, **arrays), a, b, c)
        return out + vjp((go, gl))

    res = run(*(jnp.asarray(x, dtype) for x in (q, k, v, g_o)), jnp.asarray(g_lse),
              arrays)
    return [np.asarray(x, np.float32) for x in res]


def _key_mask(b, t, seed):
    km = (np.random.default_rng(seed).random((b, t)) > 0.3).astype(np.float32)
    km[:, :5] = 0.0   # under the causal mask, rows 0-4 see no key
    return km


def _segments(b, t):
    seg = np.zeros((b, t), np.int32)
    seg[0] = np.repeat([1, 2, 3], [20, 24, t - 44])
    seg[1:] = np.repeat([1, 2, 0], [30, 26, t - 56])
    return seg


B, T, H = 2, 64, 2
VARIANTS = {
    "causal": lambda: {"causal": True},
    "key_mask": lambda: {"causal": True, "key_mask": _key_mask(B, T, 3)},
    "segments": lambda: {"causal": True, "segment_ids": _segments(B, T),
                         "key_mask": (_segments(B, T) > 0).astype(np.float32)},
}


@pytest.mark.parametrize("d", [256, 300])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_flash_attention_matches_jax_at_wide_heads(d, variant):
    kw = VARIANTS[variant]()
    q, k, v, g_o, g_lse = _inputs(d + len(variant), B, T, H, d)
    got = _port(q, k, v, g_o, g_lse, **kw)
    want = _jax(q, k, v, g_o, g_lse, **kw)
    for what, g, w in zip(("o", "lse"), got[:2], want[:2]):
        np.testing.assert_allclose(g, w, err_msg=what, **FWD)
    for what, g, w in zip(("dq", "dk", "dv"), got[2:], want[2:]):
        np.testing.assert_allclose(g, w, err_msg=what, **GRAD)
    if variant == "key_mask":   # rows that see no key: 0, NEG, no gradient
        assert np.all(got[0][:, :5] == 0.0) and np.all(got[1][:, :5] == port_fa.NEG)
        assert np.all(got[2][:, :5] == 0.0)


def test_decode_attention_matches_jax_dense_at_head_dim_256():
    rng = np.random.default_rng(5)
    b, t, h, d = 3, 40, 2, 256
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(2))
    lens = np.array([1, 17, 40], np.int32)
    want = np.asarray(ref_fa.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), jnp.asarray(lens),
                                              impl="dense"))
    args = [torch.from_numpy(x) for x in (q, k, v, lens)]
    for impl in ("auto", "flash", "dense"):
        got = port_fa.decode_attention(*args, impl=impl).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=impl)


@pytest.mark.parametrize("d", [131, 300, 2688])
def test_decode_attention_matches_jax_at_wide_heads(d):
    """`decode_attention` at head_dims K7w takes (131 and 300: rows that are
    not whole 16-byte pieces in bfloat16, the element route; 2688: a group
    of 128 lanes a key) with ragged lengths and a row at cache_len 0,
    against the JAX function's dense arm (the rows it defines: cache_len >=
    1) and its flash arm, the Pallas kernel in interpret mode (every row:
    the one at cache_len 0 is 0 under its key mask). rtol 1e-5, atol 1e-6
    for each 128 of head_dim (a score sums head_dim products, in another
    order)."""
    rng = np.random.default_rng(d)
    b, t, h = 4, 24, 2
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(2))
    lens = np.array([0, 1, 13, t], np.int32)
    args = [torch.from_numpy(x) for x in (q, k, v, lens)]
    got = port_fa.decode_attention(*args, impl="flash").numpy()
    jq, jk, jv, jl = (jnp.asarray(x) for x in (q, k, v, lens))
    flash = np.asarray(ref_fa.decode_attention(jq, jk, jv, jl, impl="flash", interpret=True))
    dense = np.asarray(ref_fa.decode_attention(jq, jk, jv, jl, impl="dense"))
    tol = dict(rtol=1e-5, atol=1e-6 * d / 128)
    np.testing.assert_allclose(got, flash, err_msg="flash", **tol)
    np.testing.assert_allclose(got[1:], dense[1:], err_msg="dense", **tol)
    assert np.all(got[0] == 0.0)


# ------------------------------------------------ a network with wide heads

WIDTH, HEADS, VOCAB, NT, BATCH = 512, 2, 11, 32, 2


def _conf(pkg, impl):
    attn = lambda: pkg.SelfAttentionLayer(n_out=WIDTH, n_heads=HEADS, causal=True,
                                          activation="relu", attention_impl=impl)
    return (pkg.NeuralNetConfiguration.builder().seed(0).updater(pkg.Sgd(0.1)).list()
            .layer(attn()).layer(attn())
            .layer(pkg.RnnOutputLayer(n_out=VOCAB, activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.recurrent(VOCAB)).build())


def test_network_with_256_wide_heads_matches_jax():
    from deeplearning4j_torch.data.dataset import DataSet
    from deeplearning4j_tpu.data.dataset import DataSet as RefDataSet
    rng = np.random.default_rng(9)
    idx = rng.integers(0, VOCAB, (BATCH, NT))
    eye = np.eye(VOCAB, dtype=np.float32)
    x, y = eye[idx], eye[np.roll(idx, -1, 1)]
    net = port.MultiLayerNetwork(_conf(port, "pallas")).init(device="cpu")
    jnet = ref.MultiLayerNetwork(
        RefConfiguration.from_json(_conf(port, "dense").to_json())).init()
    jnet.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(net.params_tree))
    counts = dict(port_att.attention_kernel_selected_total)
    np.testing.assert_allclose(net.output(x), jnet.output(x), rtol=1e-5, atol=1e-6)
    assert port_att.attention_kernel_selected_total["pallas"] == counts["pallas"] + 2
    np.testing.assert_allclose(net.score(DataSet(x, y)), jnet.score(RefDataSet(x, y)),
                               rtol=1e-5)
    grads, score = net.compute_gradient_and_score(DataSet(x, y))
    jgrads, jscore = jnet.compute_gradient_and_score(RefDataSet(x, y))
    np.testing.assert_allclose(score, jscore, rtol=1e-5)
    got = port_params.params_to_numpy(grads)
    want = jax.tree_util.tree_map(np.asarray, jgrads)
    for i, (gl, wl) in enumerate(zip(got, want)):
        assert sorted(gl) == sorted(wl)
        for name in gl:
            np.testing.assert_allclose(gl[name], wl[name], rtol=1e-5, atol=1e-5,
                                       err_msg=f"{i}.{name}")


# ------------------------------------------------ a decoder with wide heads

def test_decoder_with_256_wide_heads_matches_jax_greedy_steps():
    vocab, heads, hd, ctx, pack, kv = 64, 2, 256, 32, 16, 32
    jm = jd.TransformerDecoder(vocab=vocab, layers=1, heads=heads, head_dim=hd, ff=64,
                               max_context=ctx, seed=0)
    tree = jax.tree_util.tree_map(np.asarray, jm.params_tree)
    pm = port_params.transformer_decoder_from_numpy(tree, heads=heads, max_context=ctx,
                                                    device="cpu")
    prompt = np.random.default_rng(3).integers(0, vocab, 7).astype(np.int32)
    p = len(prompt)
    row, seg, pos = (np.zeros((1, pack), np.int32) for _ in range(3))
    row[0, :p], seg[0, :p], pos[0, :p] = prompt, 1, np.arange(p)
    j_logits, j_k, j_v = (np.asarray(a) for a in jm.prefill(row, seg, pos))
    p_logits, p_k, p_v = (a.numpy() for a in pm.prefill(row, seg, pos))
    np.testing.assert_allclose(p_logits, j_logits, rtol=1e-5, atol=1e-5)
    views = {}
    for who, k_, v_ in (("jax", j_k, j_v), ("port", p_k, p_v)):
        vk = np.zeros((1, kv) + k_.shape[2:], np.float32)
        vv = np.zeros_like(vk)
        vk[0, :p], vv[0, :p] = k_[0, :p], v_[0, :p]
        views[who] = (vk, vv)
    pk, pv = (torch.from_numpy(x) for x in views["port"])
    tok = np.array([int(j_logits[0, p - 1].argmax())], np.int32)
    toks = [int(tok[0])]
    for n in range(p, p + 6):
        lens = np.array([n], np.int32)
        want, k_new, v_new = (np.asarray(a) for a in jm.step(tok, lens, *views["jax"],
                                                             lens))
        views["jax"][0][0, n], views["jax"][1][0, n] = k_new[0], v_new[0]
        got = pm.step(torch.from_numpy(tok), torch.from_numpy(lens), pk, pv,
                      torch.from_numpy(lens))[0].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=f"step {n}")
        assert int(got[0].argmax()) == int(want[0].argmax())
        tok = np.array([int(want[0].argmax())], np.int32)
        toks.append(int(tok[0]))
    assert len(toks) == 7


# ------------------------------------------------ the bfloat16 accumulator

ACC_B, ACC_T, ACC_H, ACC_D = 1, 128, 2, 24


@pytest.fixture(scope="module")
def acc_runs():
    """The JAX package's gradients on one set of inputs: bfloat16
    accumulation at blocks 32 and 128 in float32 and bfloat16 inputs, and
    float32 accumulation at block 32."""
    q, k, v, g_o, _ = _inputs(11, ACC_B, ACC_T, ACC_H, ACC_D)
    g_lse = np.zeros((ACC_B, ACC_T, ACC_H), np.float32)
    out = {"inputs": (q, k, v, g_o, g_lse)}
    for name, dtype in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        for blk in (32, 128):
            res = _jax(q, k, v, g_o, g_lse, dtype=dtype, causal=True, q_block=blk,
                       kv_block=blk, bwd_acc_dtype="bfloat16")
            out[name, blk, "bfloat16"] = res[2:]
            out[name, blk, "residuals"] = res[:2]
    out["float32", 32, "float32"] = _jax(q, k, v, g_o, g_lse, causal=True, q_block=32,
                                         kv_block=32)[2:]
    return out


def _acc_bound(runs, dtype):
    """(mean, max) bounds from the JAX package's own differences, per
    gradient: a tenth of the smaller mean and a quarter of the smaller
    largest of |bf16 at 32 - bf16 at 128| and |f32 - bf16 at 32| (float32
    inputs' f32 run for both input types)."""
    a32, a128 = runs[dtype, 32, "bfloat16"], runs[dtype, 128, "bfloat16"]
    f32 = runs["float32", 32, "float32"]
    out = []
    for i in range(3):
        blocks, types = np.abs(a32[i] - a128[i]), np.abs(f32[i] - a32[i])
        out.append((0.1 * min(blocks.mean(), types.mean()),
                    0.25 * min(blocks.max(), types.max())))
    return out


def _port_bwd_on_jax_residuals(runs, block):
    """The port's backward (the plain version, bfloat16 accumulator) on
    bfloat16 inputs and the JAX forward's own o and lse: the two forwards
    round o to bfloat16 at other running maxima (two ulps apart, see
    tests/test_torch_flash_attention.py), which moves di and so every
    rounding of the backward; given the same residuals, only the
    accumulator is compared."""
    q, k, v, g_o, g_lse = (torch.from_numpy(a) for a in runs["inputs"])
    o, lse = (torch.from_numpy(a.copy()) for a in runs["bfloat16", block, "residuals"])
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, g_o))
    di = (o.to(torch.bfloat16).float() * do.float()).sum(-1)
    t = q.shape[1]
    pos = torch.arange(t, dtype=torch.int32)
    grads = port_fa.flash_bwd(q, k, v, do, lse, di, g_lse, None, None, None, pos, pos,
                              ACC_D ** -0.5, True, acc_blocks=(block, block))
    return [g.float().numpy() for g in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [32, 128])
def test_bfloat16_accumulator_matches_jax(acc_runs, dtype, block):
    """float32 inputs through the public entry point (forward and backward);
    bfloat16 inputs through the backward on the JAX forward's residuals."""
    q, k, v, g_o, g_lse = acc_runs["inputs"]
    if dtype == "float32":
        got = _port(q, k, v, g_o, g_lse, causal=True, q_block=block, kv_block=block,
                    bwd_acc_dtype="bfloat16")[2:]
    else:
        got = _port_bwd_on_jax_residuals(acc_runs, block)
    want = acc_runs[dtype, block, "bfloat16"]
    for what, g, w, (mean_bound, max_bound) in zip(("dq", "dk", "dv"), got, want,
                                                   _acc_bound(acc_runs, dtype)):
        err = np.abs(g - w)
        assert mean_bound > 0 and err.mean() < mean_bound, (what, err.mean(), mean_bound)
        assert err.max() < max_bound, (what, err.max(), max_bound)


@pytest.mark.parametrize("fault", ["other_block", "float32_sums"])
def test_bfloat16_accumulator_bound_catches_a_wrong_accumulator(acc_runs, fault):
    """The bound refuses the port's own gradients at the other block size, and
    its float32-accumulated ones."""
    q, k, v, g_o, g_lse = acc_runs["inputs"]
    kw = {"q_block": 128, "kv_block": 128, "bwd_acc_dtype": "bfloat16"} \
        if fault == "other_block" else {"q_block": 32, "kv_block": 32}
    got = _port(q, k, v, g_o, g_lse, causal=True, **kw)[2:]
    want = acc_runs["float32", 32, "bfloat16"]
    bounds = _acc_bound(acc_runs, "float32")
    assert any(np.abs(g - w).mean() >= mb or np.abs(g - w).max() >= xb
               for g, w, (mb, xb) in zip(got, want, bounds))


def test_bfloat16_accumulator_needs_blocks_that_divide():
    q = torch.zeros(1, 96, 1, 8)
    with pytest.raises(ValueError, match="must divide"):
        port_fa.flash_attention(q, q, q, q_block=64, bwd_acc_dtype="bfloat16")
    with pytest.raises(ValueError, match="bwd_acc_dtype"):
        port_fa.flash_attention(q, q, q, bwd_acc_dtype="float16")
    # the default blocks are the JAX package's: the largest divisor <= 128
    assert port_fa.pick_kernel_block(96, 128) == ref_fa.pick_kernel_block(96, 128) == 96
    assert port_fa.pick_kernel_block(300, 128) == ref_fa.pick_kernel_block(300, 128) == 100


def test_route_parity_reaches_every_head_dim_of_the_gate():
    """The JAX gate and the port's are one rule (the dispatch table is in
    tests/test_torch_attention.py); here its edges at 128-row blocks."""
    for hd, t, want in ((2688, 128, True), (2689, 128, False), (2689, 64, True)):
        assert ref_fa.flash_attention_supported(t, t, hd) is want
        assert port_fa.flash_attention_supported(t, t, hd) is want
    assert ref_att.select_attention_impl(4096, 2688, interpret=True) == \
        port_att.select_attention_impl(4096, 2688)


# ------------------------------------------------- the clustered arms' geometry
# (host-side arithmetic of K3w and K4w; the CUDA source computes the same
# and chip_smoke.py holds it to these functions on the card)

def test_wide_cluster_geometry_covers_every_chunk_once():
    """At every head_dim 129-2689: a cluster of at most 8 blocks, one block a
    chunk up to 8 chunks (one pass); above that passes x cluster covers the
    chunks. Block rank takes its chunks rank, rank + cluster, ... with its
    output slice last, and every output slice has one block in one pass."""
    for d in range(129, 2690):
        g = port_fa.wide_geometry(d)
        nc, c, p = g["chunks"], g["cluster"], g["passes"]
        assert nc == -(-d // 128) and 1 <= c <= port_fa.MAX_CLUSTER and p * c >= nc
        assert (p == 1) == (d <= 1024) and (p > 1 or c == nc)
        slices = []
        for rank in range(c):
            for pass_ in range(p):
                order = port_fa.wide_block_chunks(d, rank, pass_)
                assert sorted(order) == list(range(rank, nc, c)) and len(order) <= p
                if pass_ * c + rank < nc:
                    assert order[-1] == pass_ * c + rank
                    slices.append(order[-1])
        assert sorted(slices) == list(range(nc))
    assert port_fa.wide_geometry(1024) == {"chunks": 8, "passes": 1, "cluster": 8}
    assert port_fa.wide_geometry(1152) == {"chunks": 9, "passes": 2, "cluster": 5}
    assert port_fa.wide_geometry(2689) == {"chunks": 22, "passes": 3, "cluster": 8}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_shared_memory_fits_a_block(dtype):
    """K3w and K4w (with and without the bfloat16 accumulator) within a
    block's 232,448 bytes at every head_dim 129-2689; K3w in one pass small
    enough for its blocks an SM, two in float32 and three in bfloat16 (228
    KB, 1 KB reserved a block)."""
    blocks = port_fa.FWD_BLOCKS_PER_SM[dtype]
    for d in range(129, 2690):
        smem = port_fa.wide_smem(d, dtype)
        assert max(smem.values()) <= port_fa.SMEM_LIMIT, (d, smem)
        if d <= 1024:
            assert blocks * (smem["fwd"] + 1024) <= 233_472, (d, smem)


@pytest.mark.parametrize("d, itemsize, offset, want", [
    (256, 2, 0, 16), (300, 2, 0, 8), (300, 2, 8, 8), (256, 2, 8, 8), (302, 2, 0, 4),
    (301, 2, 0, 2), (256, 2, 2, 2), (256, 4, 0, 16), (2689, 4, 0, 4), (258, 4, 0, 8),
    (256, 4, 4, 4)])
def test_wide_load_width(d, itemsize, offset, want):
    """The widest copy a row of d elements and every pointer allow: a
    bfloat16 row of 300 (600 bytes) 8 bytes a copy, an odd one element by
    element, one pointer off 16 bytes enough to narrow every load."""
    base = 1 << 20
    assert port_fa.load_width(d, itemsize, [base, base + offset, base, base]) == want
    x = torch.zeros(d + 8, dtype=torch.bfloat16 if itemsize == 2 else torch.float32)
    view = x[offset // itemsize:][:d]
    assert port_fa.load_width(d, itemsize, [view.data_ptr()]) == \
        port_fa.load_width(d, itemsize, [x.data_ptr() + offset])
