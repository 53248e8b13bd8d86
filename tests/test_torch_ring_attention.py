"""The port's ring attention against the JAX package's.

`ring_self_attention` of both packages on the same inputs from a numpy
seed: the JAX one over the conftest's virtual CPU devices (shard_map, its
flash body in interpret mode), the port's over a mesh that lists the CPU
once per shard (each shard's ring run in turn, a hop moving the block).
Both bodies (the flash body, and the plain one, blockwise inside each hop
where block_size asks), causal and bidirectional, with and without a key
mask, over data x seq meshes of 1 x 8, 2 x 4 and 4 x 2; the output and
the gradients of q, k and v within rtol 1e-4, atol 1e-5. Then the ring
inside a sequence-parallel step (one thread per shard, hops through
`shards.ring_hop`) against the whole-tensor ring, the hop a causal mask
hides whole (o 0, lse NEG, no gradient) and the counter's routes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import attention as ref_attention
from deeplearning4j_tpu.parallel.sequence import seq_parallel_mesh as ref_mesh
from deeplearning4j_torch.nn import shards
from deeplearning4j_torch.ops import attention as port_attention
from deeplearning4j_torch.ops import flash_attention as port_fa
from deeplearning4j_torch.parallel import seq_parallel_mesh

B, T, H, D = 8, 16, 4, 4    # width 16 over 4 heads
TOL = dict(rtol=1e-4, atol=1e-5)


def inputs(seed=0, masked=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32)
               for _ in range(3))
    g = rng.standard_normal((B, T, H, D)).astype(np.float32)
    km = None
    if masked:
        km = np.ones((B, T), np.float32)
        km[:, 11:] = 0.0
        km[1, :] = 0.0      # a row with no key: its output is 0
    return q, k, v, km, g


def jax_ring(q, k, v, km, g, mesh, causal, body, block):
    kw = dict(axis="seq", causal=causal, batch_axis="data"
              if mesh.shape["data"] > 1 else None)
    if body == "flash":
        kw.update(use_flash=True, flash_interpret=True)
    else:
        kw.update(use_flash=False, block_size=block)
    kmj = None if km is None else jnp.asarray(km)

    def f(q, k, v):
        out = ref_attention.ring_self_attention(q, k, v, mesh, key_mask=kmj, **kw)
        return jnp.sum(out * g), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2),
                                                 has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in grads]


def port_ring(q, k, v, km, g, mesh, causal, body, block):
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = port_attention.ring_self_attention(
        qt, kt, vt, mesh, causal=causal,
        key_mask=None if km is None else torch.tensor(km),
        batch_axis="data" if mesh.axis_size("data") > 1 else None,
        use_flash=body == "flash", block_size=0 if body == "flash" else block)
    grads = torch.autograd.grad((out * torch.tensor(g)).sum(), (qt, kt, vt))
    return out.detach().numpy(), [x.numpy() for x in grads]


# (causal, key-masked, body, data shards); the seq axis is 8 / data. The
# JAX package's flash body compiles in interpret mode for about 10 s a case,
# so it runs two cases; the port's flash body runs in every case of
# test_flash_body_matches_dense too.
CASES = [(True, True, "flash", 4), (False, True, "flash", 2),
         (False, False, "plain", 1), (True, True, "plain", 1),
         (True, False, "plain", 2), (False, True, "plain", 2),
         (True, True, "blockwise", 2), (False, False, "blockwise", 2)]


@pytest.mark.parametrize("causal,masked,body,data", CASES)
def test_ring_matches_jax(causal, masked, body, data):
    q, k, v, km, g = inputs(seed=3 + data, masked=masked)
    seq = 8 // data
    block = (T // seq) // 2 if body == "blockwise" else 0
    want, want_g = jax_ring(q, k, v, km, g, ref_mesh(data_devices=data),
                            causal, body, block)
    got, got_g = port_ring(q, k, v, km, g, seq_parallel_mesh(
        devices=["cpu"] * 8, data_devices=data), causal, body, block)
    np.testing.assert_allclose(got, want, **TOL)
    for a, b, name in zip(got_g, want_g, "qkv"):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **TOL)
    if masked:
        assert np.all(got[1] == 0.0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("data", [1, 2])
def test_flash_body_matches_dense(causal, data):
    """The port's flash body over 8 / data seq shards, key-masked, against
    dense attention on the whole tensors (the JAX package's own check of
    its ring)."""
    q, k, v, km, g = inputs(seed=7 + data, masked=True)
    got, got_g = port_ring(q, k, v, km, g, seq_parallel_mesh(
        devices=["cpu"] * 8, data_devices=data), causal, "flash", 0)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    want = port_attention.dense_attention(*leaves, causal=causal,
                                          key_mask=torch.tensor(km))
    want_g = torch.autograd.grad((want * torch.tensor(g)).sum(), leaves)
    np.testing.assert_allclose(got, want.detach().numpy(), **TOL)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b.numpy(), **TOL)


def test_errors_are_the_jax_packages():
    mesh = seq_parallel_mesh(devices=["cpu"] * 8)
    x = torch.zeros(2, 12, 4, 4)
    with pytest.raises(ValueError, match="time axis 12 must divide the 8-device"):
        port_attention.ring_self_attention(x, x, x, mesh)
    x = torch.zeros(2, 16, 3, 4)
    mesh3 = seq_parallel_mesh(devices=["cpu"] * 8, data_devices=1,
                              model_devices=2)
    with pytest.raises(ValueError, match="heads 3 must divide"):
        port_attention.ring_self_attention(x, x, x, mesh3, head_axis="model")
    x = torch.zeros(2, 32, 4, 4)
    with pytest.raises(ValueError, match="per-device time 4 must divide "
                                         "block_size=3"):
        port_attention.ring_self_attention(x, x, x, mesh, block_size=3)


def test_head_axis_matches_whole_heads():
    """Heads cut over a model axis give the ring of every head."""
    q, k, v, km, _ = inputs(seed=9, masked=True)
    qt, kt, vt, kmt = (torch.tensor(a) for a in (q, k, v, km))
    mesh = seq_parallel_mesh(devices=["cpu"] * 8, model_devices=2)
    got = port_attention.ring_self_attention(qt, kt, vt, mesh, causal=True,
                                             key_mask=kmt, head_axis="model")
    want = port_attention.dense_attention(qt, kt, vt, causal=True, key_mask=kmt)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def _sharded_ring(q, k, v, km, n, causal):
    """Each shard's ring on a thread of its own, hops through
    `shards.ring_hop`: the blocks each shard outputs, joined."""
    tl = q.shape[1] // n
    grid = shards.Grid((1, 1, n), [(0, 0, s) for s in range(n)],
                       [torch.device("cpu")] * n)
    group = shards.ShardGroup(n)
    ctxs = [shards.ShardContext(i, n, 0, q.shape[0], q.shape[0], group, None,
                                grid, i * tl, tl, q.shape[1]) for i in range(n)]
    cut = lambda x, i: None if x is None else x[:, i * tl:(i + 1) * tl]
    outs = shards.run(n, lambda i: port_attention.ring_attention_shard(
        cut(q, i), cut(k, i), cut(v, i), i, n, shards.ring_hop, causal=causal,
        key_mask=cut(km, i)), ctxs)
    return torch.cat(outs, 1)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_inside_a_step_matches_the_whole_tensor_ring(causal):
    q, k, v, km, g = inputs(seed=11, masked=True)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    kmt = torch.tensor(km)
    got = _sharded_ring(*leaves, kmt, 4, causal)
    got_g = torch.autograd.grad((got * torch.tensor(g)).sum(), leaves)
    want = port_attention.dense_attention(*leaves, causal=causal, key_mask=kmt)
    want_g = torch.autograd.grad((want * torch.tensor(g)).sum(), leaves)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **TOL)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_a_hop_the_causal_mask_hides_whole_gives_zero():
    """Shard 0 of a causal ring meets shard 1's keys (src > my): every pair
    is masked, so o = 0, lse = NEG and no gradient reaches q, k or v."""
    q, k, v, _, g = inputs(seed=5)
    tl = T // 2
    qt, kt, vt = (torch.tensor(a[:, :tl], requires_grad=True) for a in (q, k, v))
    pos = lambda s: torch.arange(tl, dtype=torch.int32) + s * tl
    o, lse = port_fa.flash_attention(qt, kt, vt, causal=True, q_pos=pos(0),
                                     kv_pos=pos(1), with_lse=True)
    assert torch.all(o == 0) and torch.all(lse == port_fa.NEG)
    grads = torch.autograd.grad((o * torch.tensor(g[:, :tl])).sum() + lse.sum(),
                                (qt, kt, vt))
    assert all(torch.all(x == 0) for x in grads)


def test_counter_counts_the_ring_route():
    q, k, v, _, _ = inputs()
    qt, kt, vt = (torch.tensor(a) for a in (q, k, v))
    mesh = seq_parallel_mesh(devices=["cpu"] * 8)
    before = dict(port_attention.attention_kernel_selected_total)
    port_attention.ring_self_attention(qt, kt, vt, mesh)
    port_attention.ring_self_attention(qt, kt, vt, mesh, use_flash=False)
    port_attention.ring_self_attention(qt, kt, vt, mesh, use_flash=False,
                                       block_size=1)
    after = port_attention.attention_kernel_selected_total
    assert {i: after[i] - before[i] for i in after} == \
        {"pallas": 1, "dense": 1, "blockwise": 1}


def test_context_nesting():
    mesh = seq_parallel_mesh(devices=["cpu"] * 8)
    assert port_attention.active_sequence_parallel() is None
    with port_attention.sequence_parallel(mesh, "seq", None):
        assert port_attention.active_sequence_parallel() == (mesh, "seq", None,
                                                             None)
        with port_attention.sequence_parallel(mesh, "seq", "data", "model"):
            assert port_attention.active_sequence_parallel()[2:] == ("data",
                                                                     "model")
    assert port_attention.active_sequence_parallel() is None
