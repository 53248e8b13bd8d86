"""The port's pretrain layers and `MultiLayerNetwork.pretrain` against the JAX
package's.

Given the same parameters, the same data and the same noise (the JAX
package's own draws, rebuilt here with ``jax.random`` from its keys and fed to
the port's pure forms):

- AutoEncoder (mse and xent), every VariationalAutoencoder reconstruction
  distribution (the composite of tests/test_pretrain.py among them, two
  samples a step) and RBM CD-1 and CD-2: one step's loss and gradients
  within 1e-5 of the largest value, leaf by leaf, in float32, and 1e-10 in
  float64;
- the uniforms rebuilt for the RBM are the JAX package's Bernoulli draws, so
  its `pretrain_grads(rng)` and the port's given form agree;
- a whole deterministic AE `pretrain` (corruption 0, two epochs, two
  stacked AEs under a classifier): parameters within 1e-5; the network's
  optimizer state and counters are left alone, a frozen layer is skipped;
- the VAE's supervised forward, `generate` and `reconstruction_error`, and a
  configuration's JSON, as the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref

F32_REL, F64_REL = 1e-5, 1e-10
COMPOSITE = (("bernoulli", 5), ("gaussian_learned", 4), ("exponential", 3))


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _dtypes(name):
    return ({"float32": jnp.float32, "float64": jnp.float64}[name],
            {"float32": torch.float32, "float64": torch.float64}[name],
            {"float32": F32_REL, "float64": F64_REL}[name])


def _data(n, d, seed, kind="normal"):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        return (rng.random((n, d)) < 0.4).astype(np.float64)
    if kind == "unit":
        return rng.random((n, d))
    if kind == "positive":
        return np.abs(rng.standard_normal((n, d)))
    return rng.standard_normal((n, d))


def _layers(kind, d_in, **kw):
    """The same layer in both packages, inputs bound."""
    out = []
    for pkg in (ref, port):
        layer = getattr(pkg, kind)(weight_init=pkg.WeightInit.XAVIER, **kw)
        layer.set_input_type(pkg.InputType.feed_forward(d_in))
        out.append(layer)
    return out


def _ref_params(layer, jdt, seed=3):
    """Parameters drawn by the port's init (the JAX package's init compiles a
    program per draw), biases moved off zero, as the JAX package's arrays;
    the keys and shapes are the JAX init's (checked by `jax.eval_shape`)."""
    want = jax.eval_shape(lambda k: layer.init_params(k, jdt), jax.random.PRNGKey(seed))
    twin = getattr(port, type(layer).__name__)(
        n_in=layer.n_in, n_out=layer.n_out, weight_init=port.WeightInit.XAVIER)
    for f in ("encoder_layer_sizes", "decoder_layer_sizes",
              "reconstruction_distribution"):
        if hasattr(layer, f):
            setattr(twin, f, getattr(layer, f))
    drawn = twin.init_params(torch.Generator().manual_seed(seed), torch.float64)
    drawn = {k: (t + 0.1 * torch.arange(t.numel(), dtype=t.dtype).reshape(t.shape)
                 .sin() if t.ndim == 1 else t) for k, t in drawn.items()}
    assert sorted(drawn) == sorted(want)
    assert all(tuple(drawn[k].shape) == want[k].shape for k in want)
    return {k: jnp.asarray(t.numpy(), jdt) for k, t in drawn.items()}


def _to_port(params, tdt):
    return {k: torch.from_numpy(np.array(v)).to(tdt) for k, v in params.items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _check(loss, grads, want_loss, want_grads, tol):
    assert _rel(float(loss), float(want_loss)) <= tol
    assert set(grads) == set(want_grads)
    for k in want_grads:
        assert _rel(grads[k].numpy(), want_grads[k]) <= tol, k


def _autograd(fn, params):
    leaves = {k: t.clone().requires_grad_() for k, t in params.items()}
    loss = fn(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(t) if g is None else g
                           for (k, t), g in zip(leaves.items(), grads)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("loss", ["mse", "xent"])
def test_autoencoder_step_given_the_same_keep_mask(x64, dtype, loss):
    jdt, tdt, tol = _dtypes(dtype)
    act = "sigmoid" if loss == "xent" else "tanh"
    r, p = _layers("AutoEncoder", 12, n_out=7, activation=act,
                   corruption_level=0.3, reconstruction_loss=loss)
    params = _ref_params(r, jdt)
    x = jnp.asarray(_data(16, 12, 0, "unit" if loss == "xent" else "normal"), jdt)

    def reference(q, v):   # one program: the step, its keep mask, no noise
        rng = jax.random.PRNGKey(11)
        return (jax.value_and_grad(r.pretrain_loss)(q, v, rng),
                jax.random.bernoulli(rng, 0.7, v.shape),
                jax.value_and_grad(r.pretrain_loss)(q, v, None))

    (want_loss, want_grads), keep, want0 = jax.jit(reference)(params, x)
    keep = torch.from_numpy(np.array(keep))
    xt = torch.from_numpy(np.asarray(x))
    got = _autograd(lambda q: p.pretrain_loss_given(q, xt, keep), _to_port(params, tdt))
    _check(*got, want_loss, want_grads, tol)
    # the Layer hook's autograd gives the same for the uncorrupted loss
    _check(*p.pretrain_grads(_to_port(params, tdt), xt, None), *want0, tol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("dist", ["gaussian", "bernoulli", "gaussian_learned",
                                  "exponential", "composite"])
def test_vae_step_given_the_same_eps(x64, dtype, dist):
    jdt, tdt, tol = _dtypes(dtype)
    spec = COMPOSITE if dist == "composite" else dist
    r, p = _layers("VariationalAutoencoder", 12, n_out=4,
                   encoder_layer_sizes=(9, 7), decoder_layer_sizes=(8,),
                   activation="tanh", reconstruction_distribution=spec,
                   num_samples=2, pzx_activation="identity")
    params = _ref_params(r, jdt)
    kind = {"bernoulli": "binary", "exponential": "positive",
            "composite": "positive"}.get(dist, "normal")
    x = jnp.asarray(_data(10, 12, 1, kind), jdt)

    def reference(q, v):   # one program: the step and its two eps draws
        rng = jax.random.PRNGKey(5)
        return (jax.value_and_grad(r.pretrain_loss)(q, v, rng),
                [jax.random.normal(jax.random.fold_in(rng, s), (10, 4), jdt)
                 for s in range(2)])

    (want_loss, want_grads), eps = jax.jit(reference)(params, x)
    eps = [torch.from_numpy(np.array(e)) for e in eps]
    xt = torch.from_numpy(np.asarray(x))
    got = _autograd(lambda q: p.pretrain_loss_given(q, xt, eps), _to_port(params, tdt))
    _check(*got, want_loss, want_grads, tol)
    assert list(got[1]) == list(params)   # e0W ... vb_ ... pb, in order
    with pytest.raises(ValueError, match="eps draws"):
        p.pretrain_loss_given(_to_port(params, tdt), xt, eps[:1])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("cd_k", [1, 2])
def test_rbm_cd_k_given_the_same_uniforms(x64, dtype, cd_k):
    jdt, tdt, tol = _dtypes(dtype)
    r, p = _layers("RBM", 12, n_out=6, cd_k=cd_k)
    params = _ref_params(r, jdt)
    x = jnp.asarray(_data(16, 12, 2, "binary"), jdt)
    shapes = p.noise_shapes(16)
    assert len(shapes) == 2 * cd_k

    def reference(q, v):   # one program: CD-k and the uniforms of its draws
        rng = jax.random.PRNGKey(9)
        keys = jax.random.split(rng, 2 * cd_k + 1)
        return (r.pretrain_grads(q, v, rng),
                [jax.random.uniform(keys[i], sh, jdt) for i, sh in enumerate(shapes)])

    (want_loss, want_grads), uniforms = jax.jit(reference)(params, x)
    uniforms = [torch.from_numpy(np.array(u)) for u in uniforms]
    xt = torch.from_numpy(np.asarray(x))
    _check(*p.pretrain_grads_given(_to_port(params, tdt), xt, uniforms),
           want_loss, want_grads, tol)


def test_generator_forms_are_deterministic_and_draw_noise():
    _, ae = _layers("AutoEncoder", 12, n_out=5, corruption_level=0.5,
                    activation="tanh")
    _, vae = _layers("VariationalAutoencoder", 12, n_out=3,
                     encoder_layer_sizes=(6,), decoder_layer_sizes=(6,))
    _, rbm = _layers("RBM", 12, n_out=5, cd_k=2)
    x = torch.from_numpy(_data(8, 12, 3, "binary").astype(np.float32))
    g = lambda: torch.Generator().manual_seed(4)
    for layer in (ae, vae, rbm):
        params = layer.init_params(torch.Generator().manual_seed(1))
        a = layer.pretrain_grads(params, x, g())
        b = layer.pretrain_grads(params, x, g())
        assert torch.equal(a[0], b[0]) and np.isfinite(float(a[0]))
        c = layer.pretrain_grads(params, x, torch.Generator().manual_seed(5))
        assert not torch.equal(a[0], c[0])
    # without a generator the AE is uncorrupted, as without a key
    params = ae.init_params(torch.Generator().manual_seed(1))
    assert torch.equal(ae.pretrain_loss(params, x), ae.pretrain_loss_given(params, x, None))


# ------------------------------------------------------------ the network

def _stack(pkg, frozen=False):
    return (pkg.NeuralNetConfiguration.builder().seed(21)
            .updater(pkg.Adam(learning_rate=1e-2)).weight_init(pkg.WeightInit.XAVIER)
            .list()
            .layer(pkg.AutoEncoder(n_out=8, activation="tanh", corruption_level=0.0))
            .layer(pkg.AutoEncoder(n_out=5, activation="sigmoid", corruption_level=0.0,
                                   updater=pkg.Sgd(learning_rate=0.1), frozen=frozen))
            .layer(pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(12)).build())


def _pair(frozen=False):
    port_net = port.MultiLayerNetwork(_stack(port, frozen)).init(device="cpu")
    ref_net = ref.MultiLayerNetwork(_stack(ref, frozen)).init()
    ref_net.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(port_net.params_tree))
    return port_net, ref_net


@pytest.mark.parametrize("frozen", [False, True])
def test_deterministic_autoencoder_pretrain_matches(frozen):
    port_net, ref_net = _pair(frozen)
    x = _data(40, 12, 7).astype(np.float32)
    before = port_params.tree_copy(port_net.params_tree)
    opt_before = port_params.tree_copy(port_net.opt_state)
    port_net.pretrain(x, epochs=2, batch_size=16)
    ref_net.pretrain(x, epochs=2, batch_size=16)
    got = port_params.params_to_numpy(port_net.params_tree)
    want = jax.tree_util.tree_map(np.asarray, ref_net.params_tree)
    for g, w in zip(got, want):
        for k in w:
            assert _rel(g[k], w[k]) <= F32_REL, k
    assert _rel(float(port_net.score_value), float(ref_net.score_value)) <= F32_REL
    assert port_net.iteration == 0 and port_net.epoch == 0
    for a, b in zip(port_params.tree_leaves(opt_before),
                    port_params.tree_leaves(port_net.opt_state)):
        assert torch.equal(a, b)
    for i, lp in enumerate(port_net.params_tree):
        same = all(torch.equal(lp[k], before[i][k]) for k in lp)
        assert same == (i == 2 or (frozen and i == 1)), i


def test_pretrain_takes_an_iterator_and_fit_follows():
    port_net, _ = _pair()
    x = _data(32, 12, 8).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.arange(32) % 3]
    it = port.ListDataSetIterator(port.DataSet(x, y), batch_size=8)
    port_net.pretrain(it, epochs=1)
    port_net.fit(x, y, batch_size=8)
    assert port_net.iteration == 4 and np.isfinite(port_net.score())


def test_vae_forward_generate_and_reconstruction_error():
    r, p = _layers("VariationalAutoencoder", 12, n_out=3,
                   encoder_layer_sizes=(6,), decoder_layer_sizes=(6,),
                   activation="leakyrelu", reconstruction_distribution=COMPOSITE)
    params = _ref_params(r, jnp.float32)
    tp = _to_port(params, torch.float32)
    x = _data(6, 12, 4, "positive").astype(np.float32)
    z = _data(6, 3, 5).astype(np.float32)
    xt, zt = torch.from_numpy(x), torch.from_numpy(z)
    assert _rel(p.forward(tp, xt).numpy(), r.forward(params, {}, x)[0]) <= F32_REL
    assert _rel(p.generate(tp, zt).numpy(), r.generate(params, z)) <= F32_REL
    assert _rel(float(p.reconstruction_error(tp, xt)),
                float(r.reconstruction_error(params, x))) <= F32_REL
    assert p._pre_out_size() == r._pre_out_size() == 5 + 8 + 3


def test_configuration_json_matches_the_reference():
    def conf(pkg):
        return (pkg.NeuralNetConfiguration.builder().seed(3).list()
                .layer(pkg.RBM(n_out=10, cd_k=2))
                .layer(pkg.VariationalAutoencoder(
                    n_out=2, encoder_layer_sizes=(8, 8), decoder_layer_sizes=(8,),
                    reconstruction_distribution="bernoulli", num_samples=3))
                .layer(pkg.AutoEncoder(n_out=4, reconstruction_loss="xent"))
                .layer(pkg.OutputLayer(n_out=2, activation="softmax"))
                .set_input_type(pkg.InputType.feed_forward(16)).build())
    js = conf(port).to_json()
    assert js == conf(ref).to_json()
    back = port.MultiLayerConfiguration.from_json(js)
    assert back.to_json() == js
    ref.MultiLayerConfiguration.from_json(js)   # the JAX package loads it too
    net = port.MultiLayerNetwork(back)
    net.init(device="cpu")
    assert [type(l).__name__ for l in net.layers] == [
        "RBM", "VariationalAutoencoder", "AutoEncoder", "OutputLayer"]
