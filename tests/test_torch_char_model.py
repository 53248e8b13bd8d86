"""The long-context char model (two causal SelfAttentionLayers with ReLU, an
RnnOutputLayer softmax/MCXENT head, Sgd(0.1): bench.py's
attention_longctx network) in the torch port against the JAX package, at
width 16, 4 heads (head_dim 4), vocab 11, t 32, batch 2.

The JAX network holds the port network's parameters (carried with
params_to_numpy). The port runs its attention through the flash route
(`attention_impl="pallas"`: the plain versions of K3-K5 on the CPU) and
through "dense"; the JAX network, built from the same configuration's JSON,
runs dense attention on the CPU (its Pallas probe fails off-TPU, so a
requested "pallas" falls back there). Checked: `output`, `score`,
`compute_gradient_and_score` per layer, and 3 `fit` steps, without masks,
with a features mask (padding at the end of one row; labels mask the same),
and with packed segment ids (`packed_segments=True`). And the JSON
configuration both ways, the parameters' carry, and a bfloat16 network.

Tolerance in float32: rtol 1e-5 / atol 1e-6 for outputs, scores,
gradients and the parameters after 3 steps (the network sums over 32 keys
and 2 x 32 steps in another order). bfloat16 states its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.data.dataset import DataSet
from deeplearning4j_torch.ops import attention as port_att
from deeplearning4j_torch.ops import flash_attention as port_fa
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.data.dataset import DataSet as RefDataSet
from deeplearning4j_tpu.nn.conf.builders import \
    MultiLayerConfiguration as RefConfiguration
from test_torch_word2vec import one_torch_thread  # noqa: F401

WIDTH, HEADS, VOCAB, T, BATCH = 16, 4, 11, 32, 2
TOL = dict(rtol=1e-5, atol=1e-6)


def _conf(pkg, impl, packed=False, t=T):
    attn = lambda: pkg.SelfAttentionLayer(
        n_out=WIDTH, n_heads=HEADS, causal=True, activation="relu",
        attention_impl=impl, packed_segments=packed)
    return (pkg.NeuralNetConfiguration.builder().seed(0)
            .updater(pkg.Sgd(0.1)).list()
            .layer(attn()).layer(attn())
            .layer(pkg.RnnOutputLayer(n_out=VOCAB, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(pkg.InputType.recurrent(VOCAB))
            .build())


def _data(n, kind, seed=0, t=T):
    """(x, y, features mask, labels mask): one-hot characters and their
    successors; `kind` None (no masks), "mask" (0/1, one row padded at the
    end) or "packed" (segment ids 1..3 in one row, 1..2 and padding in the
    other)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, VOCAB, (n, t))
    eye = np.eye(VOCAB, dtype=np.float32)
    x, y = eye[idx], eye[np.roll(idx, -1, 1)]
    if kind is None:
        return x, y, None, None
    fm = np.ones((n, t), np.float32)
    if kind == "mask":
        fm[1::2, t - 9:] = 0.0
    else:
        fm[0::2] = np.repeat([1, 2, 3], [10, 12, t - 22])
        fm[1::2] = np.repeat([1, 2, 0], [15, 9, t - 24])
    return x, y, fm, (fm > 0).astype(np.float32)


def _port_net(impl, packed, dtype=torch.float32, t=T):
    return port.MultiLayerNetwork(_conf(port, impl, packed, t)).init(
        device="cpu", dtype=dtype)


def _ref_net(port_net, packed):
    """A JAX network built from the port configuration's JSON (attention
    switched to "dense", which is what a requested "pallas" runs on the
    CPU), holding the port network's parameters."""
    conf = RefConfiguration.from_json(_conf(port, "dense", packed).to_json())
    net = ref.MultiLayerNetwork(conf).init()
    net.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(port_net.params_tree))
    return net


KINDS = [None, "mask", "packed"]


@pytest.fixture(scope="module")
def reference():
    """Per data kind, the JAX package's output, score, gradients and the
    parameters after 3 fit steps of 2 rows, from the port network's initial
    parameters (the same for every attention_impl: one seed)."""
    out = {}
    for kind in KINDS:
        port_net = _port_net("dense", kind == "packed")
        x, y, fm, lm = _data(2 * BATCH + 2, kind)
        ds = RefDataSet(x[:BATCH], y[:BATCH], None if fm is None else fm[:BATCH],
                        None if lm is None else lm[:BATCH])
        net = _ref_net(port_net, kind == "packed")
        grads, score = net.compute_gradient_and_score(ds)
        res = {"params0": port_params.params_to_numpy(port_net.params_tree),
               "output": net.output(x[:BATCH], features_mask=ds.features_mask),
               "score": net.score(ds), "grad_score": score,
               "grads": jax.tree_util.tree_map(np.asarray, grads)}
        net.fit(RefDataSet(x, y, fm, lm), batch_size=BATCH, use_async=False)
        res["fit_params"] = jax.tree_util.tree_map(np.asarray, net.params_tree)
        res["fit_score"] = float(net.score_value)
        out[kind] = res
    return out


def _assert_trees_close(got, want, what):
    assert [sorted(l) for l in got] == [sorted(l) for l in want], what
    for i, (gl, wl) in enumerate(zip(got, want)):
        for k in wl:
            np.testing.assert_allclose(gl[k], np.asarray(wl[k]),
                                       err_msg=f"{what} {i}.{k}", **TOL)


@pytest.mark.parametrize("kind", KINDS, ids=["plain", "mask", "packed"])
@pytest.mark.parametrize("impl", ["pallas", "dense"])
def test_matches_reference(reference, impl, kind, monkeypatch):
    want = reference[kind]
    counts = {i: 0 for i in port_att.ATTENTION_IMPLS}
    monkeypatch.setattr(port_att, "attention_kernel_selected_total", counts)
    net = _port_net(impl, kind == "packed")
    _assert_trees_close(port_params.params_to_numpy(net.params_tree),
                        want["params0"], "initial params")
    x, y, fm, lm = _data(2 * BATCH + 2, kind)
    ds = DataSet(x[:BATCH], y[:BATCH], None if fm is None else fm[:BATCH],
                 None if lm is None else lm[:BATCH])
    out = net.output(x[:BATCH], features_mask=ds.features_mask)
    np.testing.assert_allclose(out, want["output"], **TOL)
    np.testing.assert_allclose(net.score(ds), want["score"], **TOL)
    grads, score = net.compute_gradient_and_score(ds)
    np.testing.assert_allclose(score, want["grad_score"], **TOL)
    _assert_trees_close(port_params.params_to_numpy(grads), want["grads"],
                        "gradients")
    net.fit(DataSet(x, y, fm, lm), batch_size=BATCH)
    assert net.iteration == 3
    np.testing.assert_allclose(float(net.score_value), want["fit_score"], **TOL)
    _assert_trees_close(port_params.params_to_numpy(net.params_tree),
                        want["fit_params"], "params after 3 steps")
    # every attention call took the requested route: 2 layers x (output,
    # score, gradients, 3 steps)
    assert counts[impl] == 2 * 6 and sum(counts.values()) == counts[impl]


def test_json_round_trips_both_ways():
    for packed in (False, True):
        mine = _conf(port, "pallas", packed)
        theirs = RefConfiguration.from_json(mine.to_json())
        assert [type(l).__name__ for l in theirs.layers] == \
            ["SelfAttentionLayer", "SelfAttentionLayer", "RnnOutputLayer"]
        back = port.MultiLayerConfiguration.from_json(theirs.to_json())
        assert back.to_json() == mine.to_json()
        assert back.layers[0] == mine.layers[0]
        assert back.layers[0].attention_impl == "pallas"
        assert back.layers[1].packed_segments is packed
        written = _conf(ref, "pallas", packed).to_json()
        assert port.MultiLayerConfiguration.from_json(written).to_json() == written


def test_params_carry_unchanged():
    """params_to_numpy / params_from_numpy leave attention and RNN-output
    parameters as they are (2-D [in, out] matrices and biases), bitwise, in
    the JAX package's names and shapes."""
    net = _port_net("pallas", False)
    want = ref.MultiLayerNetwork(_conf(ref, "pallas")).init().params_tree
    tree = port_params.params_to_numpy(net.params_tree)
    for got_l, want_l in zip(tree, want):
        assert {k: v.shape for k, v in got_l.items()} == \
            {k: tuple(v.shape) for k, v in want_l.items()}
    assert tree[0]["Wq"].shape == (VOCAB, WIDTH)
    assert tree[1]["Wo"].shape == (WIDTH, WIDTH)
    assert tree[2]["W"].shape == (WIDTH, VOCAB)
    back = port_params.params_from_numpy(tree, device="cpu")
    for a, b in zip(back, net.params_tree):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k])
            np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())


def _bf16_nets(t):
    """A port and a JAX network in bfloat16 holding the same bfloat16
    parameters (float32 draws rounded once)."""
    port_net = _port_net("pallas", False, t=t)
    tree = port_params.params_to_numpy(port_net.params_tree)
    bf16_net = _port_net("pallas", False, dtype=torch.bfloat16, t=t)
    bf16_net.params_tree = tuple({k: torch.from_numpy(v).to(torch.bfloat16)
                                  for k, v in layer.items()} for layer in tree)
    conf = RefConfiguration.from_json(_conf(port, "dense", False, t).to_json())
    ref_net = ref.MultiLayerNetwork(conf).init(dtype=jnp.bfloat16)
    ref_net.params_tree = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    return bf16_net, ref_net


def test_bfloat16_score_counts_masked_steps_exactly():
    """A bfloat16 network keeps labels and masks in float32, as the JAX
    package does. With 257 present steps a bfloat16 mask would count 256
    (257 is not a bfloat16 number), moving the score by 1/257 = 3.9e-3
    relative. Both networks run bfloat16 projections with float32 epilogues
    and float32 attention (matmul_any), so the scores agree to 5e-4
    relative: bfloat16 rounding of the projections' products summed in
    another order."""
    t = 258
    net, ref_net = _bf16_nets(t)
    x, y, _, _ = _data(1, None, seed=3, t=t)
    lm = np.ones((1, t), np.float32)
    lm[0, -1] = 0.0  # 257 present steps
    got = net.score(DataSet(x, y, None, lm))
    want = ref_net.score(RefDataSet(x, y, None, lm))
    np.testing.assert_allclose(got, want, rtol=5e-4)
    assert net._as_labels(lm).dtype == torch.float32
    assert torch.sum(net._as_labels(lm)).item() == 257.0


def test_bfloat16_trains():
    """`init(dtype=torch.bfloat16)` trains the net: bfloat16 parameters stay
    bfloat16, and one Sgd step lands where the JAX package's does to within
    one bfloat16 ulp of each parameter (at most 2^-7 relative; atol 2^-12
    for entries near zero): p - lr g rounds to bfloat16 on both sides, from
    gradients summed in another order."""
    net, ref_net = _bf16_nets(T)
    x, y, _, _ = _data(BATCH, None, seed=4)
    net.fit(x, y, batch_size=BATCH)
    ref_net.fit(x, y, batch_size=BATCH, use_async=False)
    assert np.isfinite(float(net.score_value))
    np.testing.assert_allclose(float(net.score_value),
                               float(ref_net.score_value), rtol=5e-4)
    for got_l, want_l in zip(net.params_tree, ref_net.params_tree):
        for k, w in want_l.items():
            assert got_l[k].dtype == torch.bfloat16
            np.testing.assert_allclose(got_l[k].float().numpy(),
                                       np.asarray(w, np.float32),
                                       rtol=2 ** -7, atol=2 ** -12, err_msg=k)


def test_cpu_net_never_reaches_the_kernels(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU network reached a CUDA kernel")

    monkeypatch.setattr(port_fa.cuda_build, "load", boom)
    before = (port_fa.fwd_launches, port_fa.bwd_dkv_launches,
              port_fa.bwd_dq_launches)
    net = _port_net("pallas", False)
    x, y, _, _ = _data(BATCH, None)
    net.fit(x, y, batch_size=BATCH)
    net.output(x)
    assert (port_fa.fwd_launches, port_fa.bwd_dkv_launches,
            port_fa.bwd_dq_launches) == before
