"""The port's gradient checks against the JAX package's.

On float64 networks on the CPU holding the same parameters, a dense net with
L2 and a masked-free conv net (HWIO kernels in the flat vector) pass both
packages' `gradient_check_mln`, and the port's flat vector is `params()`.
`gradient_check_fn` gives the JAX package's verdict on a function whose
gradient is right and on one whose gradient is cut (a stop-gradient in JAX, a
detach in the port), over every parameter and over a seeded sample of them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.utils import gradient_check as port_gc
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.utils import gradient_check as ref_gc


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _conf(pkg, kind):
    b = pkg.NeuralNetConfiguration.builder().seed(5).l2(1e-3).list()
    if kind == "conv":
        b = b.layer(pkg.ConvolutionLayer(kernel_size=(2, 2), n_out=2,
                                         activation="tanh"))
    b = (b.layer(pkg.DenseLayer(n_out=5, activation="tanh"))
         .layer(pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent")))
    it = (pkg.InputType.convolutional(4, 4, 2) if kind == "conv"
          else pkg.InputType.feed_forward(6))
    return b.set_input_type(it).build()


@pytest.mark.parametrize("kind", ["dense", "conv"])
def test_gradient_check_mln_passes_in_both(x64, kind):
    net = port.MultiLayerNetwork(_conf(port, kind)).init(dtype=torch.float64,
                                                         device="cpu")
    want = ref.MultiLayerNetwork(_conf(ref, kind)).init(dtype=jnp.float64)
    want.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(net.params_tree))
    rng = np.random.default_rng(3)
    shape = (4, 4, 4, 2) if kind == "conv" else (4, 6)
    x = rng.standard_normal(shape)
    y = np.eye(3)[rng.integers(0, 3, 4)]
    np.testing.assert_array_equal(port_gc._flat(net.params_tree).numpy(), net.params())
    np.testing.assert_array_equal(net.params(), np.asarray(want.params()))
    assert port_gc.gradient_check_mln(net, x, y, max_params=8) is True
    assert ref_gc.gradient_check_mln(want, x, y, max_params=8) is True


def _tree(rng):
    return {"a": rng.standard_normal((3, 4)), "k": rng.standard_normal((2, 2, 1, 3))}


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("max_params", [None, 7])
def test_gradient_check_fn_gives_the_reference_verdict(x64, cut, max_params):
    tree = _tree(np.random.default_rng(4))
    port_tree = port_params.params_from_numpy(tree, "cpu")
    stop = lambda v: jax.lax.stop_gradient(v) if cut else v
    detach = lambda v: v.detach() if cut else v

    def ref_fn(p):
        return jnp.sum(p["a"] ** 3) + jnp.sum(jnp.sin(stop(p["k"])) * p["k"])

    def port_fn(p):
        return torch.sum(p["a"] ** 3) + torch.sum(torch.sin(detach(p["k"])) * p["k"])

    got = port_gc.gradient_check_fn(port_fn, port_tree, max_params=max_params)
    want = ref_gc.gradient_check_fn(ref_fn, jax.tree_util.tree_map(jnp.asarray, tree),
                                    max_params=max_params)
    assert got is want is (not cut)


def test_unflat_inverts_flat_through_the_kernel_layout():
    tree = port_params.params_from_numpy(_tree(np.random.default_rng(6)), "cpu")
    back = port_gc._unflat(tree, port_gc._flat(tree))
    for k in tree:
        assert torch.equal(back[k], tree[k])
