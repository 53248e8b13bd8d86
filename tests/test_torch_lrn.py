"""LRN in the torch port against the JAX package.

The port's plain version (`deeplearning4j_torch.ops.lrn.lrn_reference`, the
CPU path of `lrn`) is held to the JAX package's `lrn_reference` and to its
Pallas kernel run in interpret mode, as tests/test_pallas_kernels.py runs
it. Tolerance rtol 1e-5 / atol 1e-6: float32 on both sides, the window sums
taken in another order.

The CUDA kernel itself runs only on a GPU: `test_kernel_matches_plain_on_card`
is marked `cuda` and skips without one (run it on a GPU machine with
``python -m pytest tests/test_torch_lrn.py -m cuda``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.ops import lrn as port_lrn
from deeplearning4j_tpu.ops import pallas_kernels as pk

K, ALPHA, BETA = 2.0, 1e-2, 0.75  # alpha large enough that the window matters


def _x(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 3.0
            ).astype(np.float32)


@pytest.mark.parametrize("c", [1, 3, 64, 192])
@pytest.mark.parametrize("n", [1, 3, 4, 5])
def test_plain_matches_reference_and_pallas(n, c):
    # 3*11*13 = 429 rows: not a multiple of the Pallas kernel's 256-row block
    x = _x((3, 11, 13, c), seed=n * 1000 + c)
    got = port_lrn.lrn(torch.from_numpy(x), K, ALPHA, BETA, n).numpy()
    want = np.asarray(pk.lrn_reference(jnp.asarray(x), K, ALPHA, BETA, n))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    pallas = np.asarray(pk.lrn(jnp.asarray(x), K, ALPHA, BETA, n, True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-6)


def test_cpu_tensor_never_reaches_the_kernel(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU tensor was sent to the CUDA kernel")

    monkeypatch.setattr(port_lrn, "_launch_kernel", boom)
    monkeypatch.setattr(port_lrn.cuda_build, "load", boom)
    before = port_lrn.launches
    x = torch.from_numpy(_x((2, 4, 4, 8), seed=1))
    y = port_lrn.lrn(x, K, ALPHA, BETA, 5)
    assert y.device.type == "cpu" and y.shape == x.shape
    assert port_lrn.launches == before


def test_rejects_bad_window():
    with pytest.raises(ValueError):
        port_lrn.lrn(torch.zeros(1, 1, 1, 4), K, ALPHA, BETA, 0)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for shape, n in (((2, 55, 55, 64), 5), ((3, 7, 9, 3), 4), ((5, 1, 1, 1), 5)):
        x = torch.from_numpy(_x(shape, seed=7)).cuda()
        before = port_lrn.launches
        got = port_lrn.lrn(x, K, ALPHA, BETA, n)
        torch.cuda.synchronize()
        assert port_lrn.launches == before + 1
        want = port_lrn.lrn_reference(x, K, ALPHA, BETA, n)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
