"""Each layer kind of the torch port against the JAX package's layer.

Every case builds the layer in the JAX package, serializes its config to
JSON and loads that JSON in the port (so the config fields must agree),
hands the same numpy weights to both (in the JAX package's layout, carried
into the port's with `params_from_numpy`), and compares the two forwards on
the same numpy input.
Tolerance: rtol 1e-5, atol 2e-5 — float32 on both sides, with the
convolutions' sums taken in another order by XLA and by torch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.nn.conf import inputs as port_inputs
from deeplearning4j_torch.utils import params as port_params
from deeplearning4j_torch.utils import serde as port_serde
from deeplearning4j_tpu.nn.conf import inputs as ref_inputs
from deeplearning4j_tpu.nn.layers import convolution as rc
from deeplearning4j_tpu.nn.layers import core as rcore
from deeplearning4j_tpu.utils import serde as ref_serde

TRUNC, SAME = rc.ConvolutionMode.TRUNCATE, rc.ConvolutionMode.SAME

# (id, reference layer, input shape NHWC or [batch, features])
CASES = [
    ("conv_truncate_padded",
     rc.ConvolutionLayer(kernel_size=(3, 3), stride=(1, 1), padding=(1, 1),
                         n_out=8, activation="relu", convolution_mode=TRUNC),
     (2, 9, 9, 4)),
    # in 8, k 3, s 2: SAME pads (0, 1), which torch's padding= cannot express
    ("conv_same_stride2_asymmetric",
     rc.ConvolutionLayer(kernel_size=(3, 3), stride=(2, 2), n_out=6,
                         activation="tanh", convolution_mode=SAME),
     (2, 8, 8, 5)),
    # AlexNet's stem: padded extent 64 divides by 4, so the JAX package
    # runs its space-to-depth reparametrisation and the port the plain conv
    ("conv_stem_11x11_s4_space_to_depth",
     rc.ConvolutionLayer(kernel_size=(11, 11), stride=(4, 4), padding=(2, 2),
                         n_out=16, activation="relu", convolution_mode=TRUNC),
     (2, 60, 60, 3)),
    ("maxpool_truncate_pad1",
     rc.SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2), padding=(1, 1),
                         pooling_type=rc.PoolingType.MAX,
                         convolution_mode=TRUNC),
     (2, 11, 11, 5)),
    ("maxpool_same_asymmetric",
     rc.SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                         pooling_type=rc.PoolingType.MAX,
                         convolution_mode=SAME),
     (2, 8, 8, 3)),
    ("avgpool_same_asymmetric",
     rc.SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                         pooling_type=rc.PoolingType.AVG,
                         convolution_mode=SAME),
     (2, 8, 8, 3)),
    ("sumpool_truncate_pad1",
     rc.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2), padding=(1, 1),
                         pooling_type=rc.PoolingType.SUM,
                         convolution_mode=TRUNC),
     (2, 7, 7, 3)),
    ("pnormpool_same",
     rc.SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2), pnorm=3,
                         pooling_type=rc.PoolingType.PNORM,
                         convolution_mode=SAME),
     (2, 8, 8, 3)),
    ("lrn",
     rc.LocalResponseNormalization(alpha=1e-2),
     (2, 5, 5, 12)),
    ("dense_tanh",
     rcore.DenseLayer(n_in=12, n_out=7, activation="tanh"),
     (3, 12)),
    ("output_softmax",
     rcore.OutputLayer(n_in=12, n_out=5, activation="softmax"),
     (3, 12)),
]


def _numpy_params(layer, seed=3):
    """Weights in the JAX package's layout and shapes (read from
    init_params without running it), drawn with numpy at a fan-in scale."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(layer.init_params, jax.random.PRNGKey(0))
    return {k: (rng.standard_normal(s.shape)
                / np.sqrt(np.prod(s.shape[:-1]) if len(s.shape) > 1 else 10.0)
                ).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("layer,shape", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_layer_forward_matches_reference(layer, shape):
    if len(shape) == 4:
        layer.set_input_type(ref_inputs.ConvolutionalType(*shape[1:]))
    port_layer = port_serde.from_json(ref_serde.to_json(layer))
    np_p = _numpy_params(layer)
    port_p, = port_params.params_from_numpy((np_p,), device="cpu")
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    want, _ = layer.forward(jax.tree_util.tree_map(jnp.asarray, np_p), {},
                            jnp.asarray(x))
    got = port_layer.forward(port_p, torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=2e-5)


def test_space_to_depth_case_takes_that_route_in_the_reference():
    """The stem case above only tests the reparametrisation if the JAX
    package really takes it at that shape."""
    layer = CASES[2][1]
    w = jnp.zeros((11, 11, 3, 16))
    x = jnp.zeros((2, 60, 60, 3))
    assert layer._use_space_to_depth(x, w, (4, 4), (1, 1), ((2, 2), (2, 2)))


def test_cnn_to_feedforward_flattens_nhwc():
    x = np.random.default_rng(2).standard_normal((2, 3, 4, 5)).astype(np.float32)
    ref = ref_inputs.CnnToFeedForwardPreProcessor(3, 4, 5)
    port = port_inputs.CnnToFeedForwardPreProcessor(3, 4, 5)
    # a channels-last NCHW view, as a conv leaves it, flattens the same way
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(port(xt).numpy(),
                                  np.asarray(ref(jnp.asarray(x))))


def test_params_round_trip_is_bitwise():
    rng = np.random.default_rng(0)
    tree = ({"W": rng.standard_normal((5, 5, 3, 8)).astype(np.float32),
             "b": rng.standard_normal(8).astype(np.float32)},
            {},
            {"W": rng.standard_normal((12, 7)).astype(np.float32),
             "b": rng.standard_normal(7).astype(np.float32)})
    port = port_params.params_from_numpy(tree, device="cpu")
    assert tuple(port[0]["W"].shape) == (8, 3, 5, 5)  # OIHW
    back = port_params.params_to_numpy(port)
    for a, b in zip(tree, back):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_dropout_is_identity_at_inference_and_inverted_in_training():
    from deeplearning4j_torch.nn.layers.core import dropout
    x = torch.ones(4000)
    assert dropout(x, 0.5, False, None) is x
    y = dropout(x, 0.25, True, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.03
