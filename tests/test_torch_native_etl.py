"""The port's host ETL library against the JAX package's.

The port builds its own copy of `etl.cpp` with the JAX package's flags (the
tests need g++, as the JAX package's own native ETL tests do), and:

- its native arm is bitwise the JAX package's native arm for every function;
- its numpy arm (forced with `numpy_arm`) is bitwise the JAX package's numpy
  arm;
- the native resize is within one grey level of the numpy resize (the
  numpy arm samples in float64, `etl.cpp` in float32);
- `available()` says which arm runs and `calls` counts each arm;
  the library's name carries a hash of the source and the flags;
- where g++ cannot link OpenMP, the library built without `-fopenmp` is
  still bitwise the JAX package's native arm.
"""
import threading

import numpy as np
import pytest

from deeplearning4j_torch import native_etl as port_etl
from deeplearning4j_tpu import native_etl as ref_etl


@pytest.fixture
def ref_numpy(monkeypatch):
    """The JAX package's numpy arm (its optional-library contract)."""
    monkeypatch.setattr(ref_etl, "_lib", None)
    monkeypatch.setattr(ref_etl, "_tried", True)


def _cases():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    x = rng.normal(3, 2, (50, 7)).astype(np.float32)
    table = rng.standard_normal((20, 6)).astype(np.float32)
    return {
        "u8_to_f32_scaled": ((rng.integers(0, 256, (4, 9, 9, 2), dtype=np.uint8),
                              255.0, -1.0, 1.0), {}),
        "standardize": ((x, x.mean(0), x.std(0) + 0.1), {}),
        "parse_csv_floats": (("1.5,2.25,-3\n4e2,0.125,nope,7\n,,8.5\n7.5abc, .5\n",),
                             {}),
        "gather_rows": ((table, np.array([3, 0, 19, 3], np.int32)), {}),
        "one_hot": ((np.array([2, 0, -1, 9, 4], np.int32), 5), {}),
        "resize_down": ((img, 24, 31), {}),
        "resize_up": ((img, 61, 90), {}),
        "resize_gray": ((img[:, :, :1], 16, 16), {}),
    }


def _call(mod, name, args, kw):
    fn = "resize_bilinear" if name.startswith("resize") else name
    return getattr(mod, fn)(*args, **kw)


@pytest.mark.parametrize("name", list(_cases()))
def test_native_arm_is_bitwise_the_reference_native_arm(name):
    assert port_etl.available()
    assert ref_etl.available()
    args, kw = _cases()[name]
    before = port_etl.calls["native"]
    got = _call(port_etl, name, args, kw)
    want = _call(ref_etl, name, args, kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert port_etl.calls["native"] == before + 1


@pytest.mark.parametrize("name", list(_cases()))
def test_numpy_arm_is_bitwise_the_reference_numpy_arm(ref_numpy, name):
    args, kw = _cases()[name]
    before = dict(port_etl.calls)
    with port_etl.numpy_arm():
        assert not port_etl.available()
        got = _call(port_etl, name, args, kw)
    assert port_etl.available()
    want = _call(ref_etl, name, args, kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert port_etl.calls["numpy"] == before["numpy"] + 1
    assert port_etl.calls["native"] == before["native"]


@pytest.mark.parametrize("shape,out", [((256, 256, 3), (224, 224)),
                                       ((40, 40, 3), (24, 24)),
                                       ((17, 29, 1), (32, 9))])
def test_native_resize_within_one_grey_level_of_numpy(shape, out):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    native = port_etl.resize_bilinear(img, *out)
    with port_etl.numpy_arm():
        plain = port_etl.resize_bilinear(img, *out)
    diff = np.abs(native.astype(np.int16) - plain.astype(np.int16))
    assert diff.max() <= 1
    # boundary cases only (1.15% of noise pixels at 256 -> 224); a wrong
    # rounding or sampling grid would move about half of them
    assert np.mean(diff > 0) < 0.05


def test_same_size_resize_runs_no_arm_and_errors_match():
    img = np.zeros((5, 6, 3), np.uint8)
    before = dict(port_etl.calls)
    assert port_etl.resize_bilinear(img, 5, 6) is img
    assert port_etl.calls == before
    with pytest.raises(ValueError):
        port_etl.resize_bilinear(img[:, :, 0], 2, 2)
    with pytest.raises(ValueError, match="stats length"):
        port_etl.standardize(np.zeros((2, 3), np.float32), np.zeros(2), np.ones(2))
    with pytest.raises(IndexError):
        port_etl.gather_rows(np.zeros((2, 3), np.float32), np.array([2]))
    with pytest.raises(ValueError):
        port_etl.one_hot(np.zeros((2, 2), np.int32), 3)
    # the cap is per thread, and torch may share the OpenMP runtime: cap a
    # thread of its own, never the caller's (its torch ops would go serial)
    worker = threading.Thread(target=port_etl.set_omp_threads, args=(1,))
    worker.start()
    worker.join(timeout=30)
    assert not worker.is_alive()


def test_library_is_named_by_source_and_flags():
    assert port_etl.available()   # built at the first call
    path = port_etl.library_path()
    assert path.exists() and path.parent.name == "torch_kernels"
    assert port_etl.built_with() == port_etl.CXX_FLAGS
    assert port_etl.library_path(port_etl.CXX_FLAGS + ("-DX",)) != path
    port_etl.reset_calls()
    assert port_etl.calls == {"native": 0, "numpy": 0}


def test_built_without_openmp_gives_the_same_bytes(monkeypatch, tmp_path):
    monkeypatch.setattr(port_etl, "BUILD_DIR", tmp_path)
    for name, value in (("_lib", None), ("_tried", False), ("_flags", None)):
        monkeypatch.setattr(port_etl, name, value)
    build = port_etl._build
    monkeypatch.setattr(port_etl, "_build", lambda lib, flags: (
        "-fopenmp" not in flags and build(lib, flags)))
    assert port_etl.available()
    assert port_etl.built_with() == tuple(f for f in port_etl.CXX_FLAGS
                                          if f != "-fopenmp")
    for name, (args, kw) in _cases().items():
        np.testing.assert_array_equal(_call(port_etl, name, args, kw),
                                      _call(ref_etl, name, args, kw))
