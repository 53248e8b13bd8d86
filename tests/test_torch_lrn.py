"""LRN in the torch port against the JAX package.

The port's plain versions (`lrn_reference` and `lrn_bwd_reference`, the CPU
paths of `lrn` and its backward) are held to the JAX package's
`lrn_reference` (and `jax.vjp` of it) and to its Pallas kernels run in
interpret mode, as tests/test_pallas_kernels.py runs them. Tolerance rtol
1e-5 / atol 1e-6: float32 on both sides, the window sums taken in another
order. `LRNFunction` is checked against finite differences in float64.

The CUDA kernels themselves run only on a GPU: the tests marked `cuda` skip
without one (run them on a GPU machine with
``python -m pytest tests/test_torch_lrn.py -m cuda``).
"""
import numpy as np
import pytest
import torch

from deeplearning4j_torch.ops import lrn as port_lrn


@pytest.fixture(scope="module")
def ref():
    """(jax, jax.numpy, the JAX package's pallas_kernels), imported here and
    not at the top so the card-only tests also run where JAX is absent."""
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu.ops import pallas_kernels
    return jax, jax.numpy, pallas_kernels

K, ALPHA, BETA = 2.0, 1e-2, 0.75  # alpha large enough that the window matters


def _x(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 3.0
            ).astype(np.float32)


@pytest.mark.parametrize("c", [1, 3, 64, 192])
@pytest.mark.parametrize("n", [1, 3, 4, 5])
def test_plain_matches_reference_and_pallas(ref, n, c):
    _, jnp, pk = ref
    # 3*11*13 = 429 rows: not a multiple of the Pallas kernel's 256-row block
    x = _x((3, 11, 13, c), seed=n * 1000 + c)
    got = port_lrn.lrn(torch.from_numpy(x), K, ALPHA, BETA, n).numpy()
    want = np.asarray(pk.lrn_reference(jnp.asarray(x), K, ALPHA, BETA, n))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    pallas = np.asarray(pk.lrn(jnp.asarray(x), K, ALPHA, BETA, n, True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("c", [1, 3, 64, 67, 192])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 10])
def test_plain_backward_matches_vjp_and_pallas(ref, n, c):
    jax, jnp, pk = ref
    x = _x((3, 11, 13, c), seed=n * 1000 + c)
    g = _x((3, 11, 13, c), seed=n * 1000 + c + 1) / 3.0
    got = port_lrn.lrn_bwd_reference(torch.from_numpy(x), torch.from_numpy(g),
                                     K, ALPHA, BETA, n).numpy()
    _, vjp = jax.vjp(lambda v: pk.lrn_reference(v, K, ALPHA, BETA, n),
                     jnp.asarray(x))
    want, = vjp(jnp.asarray(g))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    pallas = pk._lrn_bwd_pallas(jnp.asarray(x), jnp.asarray(g), K, ALPHA,
                                BETA, n, True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-6)
    # and through autograd of the port's lrn, which takes the same path
    xt = torch.from_numpy(x).requires_grad_()
    port_lrn.lrn(xt, K, ALPHA, BETA, n).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), got)


@pytest.mark.parametrize("n", [1, 4, 5])
def test_lrn_function_gradcheck_float64(n):
    x = torch.from_numpy(_x((2, 3, 2, 7), seed=n).astype(np.float64))
    x.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda v: port_lrn.LRNFunction.apply(v, K, ALPHA, BETA, n), (x,),
        eps=1e-6, atol=1e-7, rtol=1e-5)


def test_cpu_tensor_never_reaches_the_kernel(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU tensor was sent to the CUDA kernel")

    monkeypatch.setattr(port_lrn, "_launch_kernel", boom)
    monkeypatch.setattr(port_lrn, "_launch_bwd_kernel", boom)
    monkeypatch.setattr(port_lrn.cuda_build, "load", boom)
    before = port_lrn.launches, port_lrn.bwd_launches
    x = torch.from_numpy(_x((2, 4, 4, 8), seed=1)).requires_grad_()
    y = port_lrn.lrn(x, K, ALPHA, BETA, 5)
    assert y.device.type == "cpu" and y.shape == x.shape
    y.sum().backward()
    assert x.grad.shape == x.shape
    assert (port_lrn.launches, port_lrn.bwd_launches) == before


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


@pytest.mark.cuda
def test_backward_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    # K2's tiles hold 2048 // C rows: (3, 17, 19, 67) is 32 tiles and a
    # ragged one with C not a multiple of 4, n 10 a window wider than 4 a side
    for shape, n in (((2, 55, 55, 64), 5), ((3, 7, 9, 3), 4), ((5, 1, 1, 1), 5),
                     ((2, 3, 5, 2048), 7), ((3, 17, 19, 67), 5),
                     ((2, 9, 11, 64), 10), ((4, 14, 14, 192), 5)):
        x = torch.from_numpy(_x(shape, seed=7)).cuda()
        g = torch.from_numpy(_x(shape, seed=8)).cuda()
        before = port_lrn.bwd_launches
        got = port_lrn.lrn_bwd(x, g, K, ALPHA, BETA, n)
        torch.cuda.synchronize()
        assert port_lrn.bwd_launches == before + 1
        want = port_lrn.lrn_bwd_reference(x, g, K, ALPHA, BETA, n)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_autograd_reaches_both_kernels_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x = torch.from_numpy(_x((2, 9, 9, 64), seed=3)).cuda().requires_grad_()
    g = torch.from_numpy(_x((2, 9, 9, 64), seed=4)).cuda()
    before = port_lrn.launches, port_lrn.bwd_launches
    port_lrn.lrn(x, K, ALPHA, BETA, 5).backward(g)
    torch.cuda.synchronize()
    assert (port_lrn.launches, port_lrn.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    want = port_lrn.lrn_bwd_reference(x.detach(), g, K, ALPHA, BETA, 5)
    torch.testing.assert_close(x.grad, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_backward_kernel_takes_an_unaligned_tensor_on_card():
    """A contiguous view one float into its buffer is 4-byte aligned only:
    K2 takes its 4-byte copies there, and gives the same answer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    shape = (2, 9, 9, 64)
    flat = torch.from_numpy(_x((2 * 9 * 9 * 64 + 1,), seed=9)).cuda()
    x = flat[1:].view(shape)
    g = torch.from_numpy(_x(shape, seed=10)).cuda()
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    got = port_lrn.lrn_bwd(x, g, K, ALPHA, BETA, 5)
    torch.cuda.synchronize()
    want = port_lrn.lrn_bwd_reference(x, g, K, ALPHA, BETA, 5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
