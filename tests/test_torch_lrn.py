"""LRN in the torch port against the JAX package.

The port's plain versions (`lrn_reference` and `lrn_bwd_reference`, the CPU
paths of `lrn` and its backward) are held to the JAX package's
`lrn_reference` (and `jax.vjp` of it) and to its Pallas kernels run in
interpret mode, as tests/test_pallas_kernels.py runs them. Tolerance rtol
1e-5 / atol 1e-6: float32 on both sides, the window sums taken in another
order. `LRNFunction` is checked against finite differences in float64.

In bfloat16 (the type of the JAX package's benchmark AlexNet) the plain
versions compute op by op in bfloat16, as the JAX package's `lrn_reference`
does; they are held to it, to `jax.vjp` of it and to the Pallas kernels in
interpret mode on the same bfloat16 inputs at 2e-2 of max|ref|, two
bfloat16 ulps of the largest value (each side rounds every op; measured
within 1.2e-2 forward and 1.6e-2 backward over these cases).

The CUDA kernels themselves run only on a GPU: the tests marked `cuda` skip
without one (run them on a GPU machine with
``python -m pytest tests/test_torch_lrn.py -m cuda``). There a bfloat16
kernel is held to the float32 plain version on the upcast input, rounded
once, within one bfloat16 ulp of each value (`chip_smoke.bf16_ulp_check`).
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


BF16_REL = 2e-2   # of max|ref|: two bfloat16 ulps of the largest value
BF16_C = [1, 3, 64, 67, 192]
BF16_N = [1, 4, 5, 10]


def _bf16(a, jnp):
    """A float32 numpy array as bfloat16 in both packages (the same
    round-to-nearest-even values)."""
    return torch.from_numpy(a).to(torch.bfloat16), jnp.asarray(a, jnp.bfloat16)


def _assert_rel(got, want, label):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= BF16_REL * np.abs(want).max(), (label, err, np.abs(want).max())


@pytest.mark.parametrize("c", BF16_C)
@pytest.mark.parametrize("n", BF16_N)
def test_bf16_plain_matches_reference_and_pallas(ref, n, c):
    _, jnp, pk = ref
    xt, xj = _bf16(_x((2, 5, 7, c), seed=n * 100 + c), jnp)
    got = port_lrn.lrn(xt, K, ALPHA, BETA, n)
    assert got.dtype == torch.bfloat16
    want = pk.lrn_reference(xj, K, ALPHA, BETA, n)
    assert want.dtype == jnp.bfloat16
    _assert_rel(got, want, "lrn_reference")
    pallas = pk.lrn(xj, K, ALPHA, BETA, n, True)
    assert pallas.dtype == jnp.bfloat16
    _assert_rel(got, pallas, "pallas")


@pytest.mark.parametrize("c", BF16_C)
@pytest.mark.parametrize("n", BF16_N)
def test_bf16_plain_backward_matches_vjp_and_pallas(ref, n, c):
    jax, jnp, pk = ref
    xt, xj = _bf16(_x((2, 5, 7, c), seed=n * 100 + c), jnp)
    gt, gj = _bf16(_x((2, 5, 7, c), seed=n * 100 + c + 1) / 3.0, jnp)
    got = port_lrn.lrn_bwd_reference(xt, gt, K, ALPHA, BETA, n)
    assert got.dtype == torch.bfloat16
    _, vjp = jax.vjp(lambda v: pk.lrn_reference(v, K, ALPHA, BETA, n), xj)
    want, = vjp(gj)
    _assert_rel(got, want, "vjp")
    pallas = pk._lrn_bwd_pallas(xj, gj, K, ALPHA, BETA, n, True)
    assert pallas.dtype == jnp.bfloat16
    _assert_rel(got, pallas, "pallas")
    # and through autograd of the port's lrn, which takes the same path
    xg = xt.clone().requires_grad_()
    port_lrn.lrn(xg, K, ALPHA, BETA, n).backward(gt)
    assert xg.grad.dtype == torch.bfloat16
    assert torch.equal(xg.grad, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_input_check_takes_float32_and_bfloat16(dtype):
    assert port_lrn._check_kernel_input("lrn", torch.zeros(2, 3, 5, dtype=dtype)) == 5


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_kernel_input_check_refuses_other_types(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        port_lrn._check_kernel_input("lrn", torch.zeros(2, 3, 5, dtype=dtype))


def test_cpu_bfloat16_tensor_never_reaches_the_kernel(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU tensor was sent to the CUDA kernel")

    monkeypatch.setattr(port_lrn, "_launch_kernel", boom)
    monkeypatch.setattr(port_lrn, "_launch_bwd_kernel", boom)
    monkeypatch.setattr(port_lrn.cuda_build, "load", boom)
    before = port_lrn.launches, port_lrn.bwd_launches
    x = torch.from_numpy(_x((2, 4, 4, 8), seed=1)).to(torch.bfloat16).requires_grad_()
    y = port_lrn.lrn(x, K, ALPHA, BETA, 5)
    assert y.device.type == "cpu" and y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and x.grad.shape == x.shape
    assert (port_lrn.launches, port_lrn.bwd_launches) == before


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
    """Float32 K1 against the plain version, on these shapes and on
    chip_smoke's LRN_CASES with an unaligned view."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cases = [(f"{shape} n {n}", lambda dtype, shape=shape: torch.from_numpy(
        _x(shape, seed=7)).cuda(), n, ALPHA)
        for shape, n in (((2, 55, 55, 64), 5), ((3, 7, 9, 3), 4), ((5, 1, 1, 1), 5))]
    for label, make, n, alpha in cases + list(_lrn_cases_and_an_unaligned_view()):
        x = make(torch.float32)
        before = port_lrn.launches
        got = port_lrn.lrn(x, K, alpha, BETA, n)
        torch.cuda.synchronize()
        assert port_lrn.launches == before + 1
        want = port_lrn.lrn_reference(x, K, alpha, BETA, n)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6, msg=label)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_reaches_both_kernels_on_card(dtype):
    """In bfloat16 the gradient is held to the float32 plain version on the
    upcast inputs, rounded once, within one bfloat16 ulp of each value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x = torch.from_numpy(_x((2, 9, 9, 64), seed=3)).cuda().to(dtype).requires_grad_()
    g = torch.from_numpy(_x((2, 9, 9, 64), seed=4)).cuda().to(dtype)
    before = port_lrn.launches, port_lrn.bwd_launches
    port_lrn.lrn(x, K, ALPHA, BETA, 5).backward(g)
    torch.cuda.synchronize()
    assert (port_lrn.launches, port_lrn.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    assert x.grad.dtype == dtype
    want = port_lrn.lrn_bwd_reference(x.detach().float(), g.float(), K, ALPHA, BETA, 5)
    if dtype == torch.float32:
        torch.testing.assert_close(x.grad, want, rtol=1e-5, atol=1e-6)
    else:
        import chip_smoke
        chip_smoke.bf16_ulp_check(torch, "autograd", x.grad, want, 1e-6)


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


def _lrn_cases_and_an_unaligned_view():
    """chip_smoke's LRN_CASES (AlexNet's two calls at batch 128 and 32, and
    the edge shapes), then a contiguous view one element into its buffer,
    which only the one-channel path takes: (label, x maker, n, alpha)."""
    import chip_smoke
    gen = torch.Generator(device="cuda").manual_seed(5)
    for label, shape, n, alpha, scale, _ in chip_smoke.LRN_CASES:
        yield label, lambda dtype, shape=shape, scale=scale: (
            torch.randn(shape, device="cuda", generator=gen) * scale).to(dtype), n, alpha

    def unaligned(dtype, shape=(2, 9, 9, 64)):
        flat = (torch.randn(int(np.prod(shape)) + 1, device="cuda", generator=gen)
                * 3.0).to(dtype)
        return flat[1:].view(shape)

    yield "unaligned_view", unaligned, 5, ALPHA


@pytest.mark.cuda
def test_bf16_kernels_match_the_rounded_plain_versions_on_card():
    """K1 and K2 on bfloat16 tensors: each value within one bfloat16 ulp of
    the float32 plain version on the upcast inputs, rounded once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import chip_smoke
    for label, make, n, alpha in _lrn_cases_and_an_unaligned_view():
        x, g = make(torch.bfloat16), make(torch.bfloat16) / 3.0
        hyper = (K, alpha, BETA, n)
        before = port_lrn.launches, port_lrn.bwd_launches
        y = port_lrn.lrn_fwd(x, *hyper)
        dx = port_lrn.lrn_bwd(x, g, *hyper)
        torch.cuda.synchronize()
        assert (port_lrn.launches, port_lrn.bwd_launches) == (before[0] + 1, before[1] + 1)
        assert y.dtype == dx.dtype == torch.bfloat16
        chip_smoke.bf16_ulp_check(torch, f"K1 {label}", y,
                                  port_lrn.lrn_reference(x.float(), *hyper), 1e-6)
        chip_smoke.bf16_ulp_check(torch, f"K2 {label}", dx, port_lrn.lrn_bwd_reference(
            x.float(), g.float(), *hyper), 1e-6)


@pytest.mark.cuda
def test_kernels_refuse_float16_and_float64_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for dtype in (torch.float16, torch.float64):
        x = torch.ones(2, 3, 3, 8, device="cuda", dtype=dtype)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            port_lrn.lrn(x, K, ALPHA, BETA, 5)
