"""The host ETL library: a ctypes binding of `native/etl.cpp`.

Port of `deeplearning4j_tpu/native_etl.py`. This is host code, not a GPU
kernel: uint8 -> float32 scaling, standardization, CSV float parsing, row
gathers, one-hot labels and the bilinear HWC resize of the image reader.

The source is the port's own copy of the JAX package's `native/etl.cpp`,
built at first use with the JAX package's flags (``g++ -O3 -mtune=native
-Wall -fPIC -shared -std=c++17 -fopenmp``) into ``build/torch_kernels/``,
the library named by a hash of the source and the flags, as
`ops/cuda_build.py` names the CUDA libraries. Where g++ cannot link OpenMP
(a toolchain without libgomp's spec file), the same source is built without
``-fopenmp``: the same arithmetic, one thread a call, its OpenMP pragmas
ignored; `built_with()` gives the flags of the library in use, and the
fallback is logged. Nothing is built when the module is imported.

Two arms, as in the JAX package: the native library, and numpy, the plain
version, which runs where no C++ compiler can build the library. Which arm
runs is never hidden: `available()` says it, `calls` counts each arm's
calls (a resize to the image's own size runs neither), and `numpy_arm()`
forces the plain version within a block. The numpy arm is
bitwise the JAX package's numpy arm. The native resize samples in float32
and the numpy one in float64, so a pixel whose value lands near a ``+0.5``
rounding boundary can come out one grey level apart between the two arms.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import re
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .ops.cuda_build import BUILD_DIR

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "native" / "etl.cpp"
CXX_FLAGS = ("-O3", "-mtune=native", "-Wall", "-fPIC", "-shared", "-std=c++17",
             "-fopenmp")
ABI_VERSION = 2

#: calls each arm has carried in this process
calls: Dict[str, int] = {"native": 0, "numpy": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_flags: Optional[Tuple[str, ...]] = None
_tried = False
_forced_numpy = 0


def _without_openmp(flags: Sequence[str]) -> Tuple[str, ...]:
    return tuple(f for f in flags if f != "-fopenmp")


def library_path(flags: Sequence[str] = CXX_FLAGS) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"libdl4j_etl-{digest.hexdigest()[:16]}.so"


def _build(lib: Path, flags: Sequence[str]) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        log.warning("no C++ compiler: the host ETL runs its numpy arm")
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        log.warning("the host ETL build with %s failed:\n%s", " ".join(flags),
                    proc.stderr)
        return False
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.c_int64
    lib.u8_to_f32_scaled.argtypes = [u8p, f32p, i64, ctypes.c_float,
                                     ctypes.c_float, ctypes.c_float]
    lib.u8_to_f32_scaled.restype = None
    lib.f32_standardize.argtypes = [f32p, i64, i64, f32p, f32p]
    lib.f32_standardize.restype = None
    lib.parse_csv_floats.argtypes = [ctypes.c_char_p, i64, ctypes.c_char, f32p,
                                     i64]
    lib.parse_csv_floats.restype = i64
    lib.one_hot_f32.argtypes = [i32p, f32p, i64, i64]
    lib.one_hot_f32.restype = None
    lib.gather_rows_f32.argtypes = [f32p, i32p, f32p, i64, i64]
    lib.gather_rows_f32.restype = None
    lib.u8_resize_bilinear_hwc.argtypes = [u8p, i64, i64, i64, u8p, i64, i64]
    lib.u8_resize_bilinear_hwc.restype = None
    lib.etl_set_omp_threads.argtypes = [ctypes.c_int]
    lib.etl_set_omp_threads.restype = None
    lib.etl_abi_version.argtypes = []
    lib.etl_abi_version.restype = ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The native library, built at the first call; None where it cannot be
    built or loaded."""
    global _lib, _flags, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        for flags in (CXX_FLAGS, _without_openmp(CXX_FLAGS)):
            path = library_path(flags)
            if path.exists() or _build(path, flags):
                break
        else:
            log.warning("the host ETL runs its numpy arm")
            return None
        if flags != CXX_FLAGS:
            log.warning("the host ETL library is built without OpenMP: one "
                        "thread a call")
        try:
            lib = _bind(ctypes.CDLL(str(path)))
        except OSError as e:
            log.warning("the host ETL library did not load (%s); the numpy "
                        "arm runs", e)
            return None
        if lib.etl_abi_version() != ABI_VERSION:
            log.warning("the host ETL library has ABI %d, not %d; the numpy "
                        "arm runs", lib.etl_abi_version(), ABI_VERSION)
            return None
        _lib, _flags = lib, tuple(flags)
        return _lib


def _native() -> Optional[ctypes.CDLL]:
    """The library for this call, or None for the numpy arm; counts the
    call to the arm that will run it."""
    lib = None if _forced_numpy else _load()
    with _lock:
        calls["native" if lib is not None else "numpy"] += 1
    return lib


def available() -> bool:
    """True when the native arm carries the calls (built, loaded, and not
    forced off by `numpy_arm`)."""
    return not _forced_numpy and _load() is not None


def built_with() -> Optional[Tuple[str, ...]]:
    """The compiler flags of the library in use, None without one."""
    _load()
    return _flags


def reset_calls() -> None:
    with _lock:
        calls.update(native=0, numpy=0)


@contextmanager
def numpy_arm():
    """Force the numpy arm inside the block, in every thread."""
    global _forced_numpy
    with _lock:
        _forced_numpy += 1
    try:
        yield
    finally:
        with _lock:
            _forced_numpy -= 1


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def u8_to_f32_scaled(src: np.ndarray, max_pixel: float = 255.0,
                     min_range: float = 0.0,
                     max_range: float = 1.0) -> np.ndarray:
    """uint8 -> float32 in [min_range, max_range] (ImagePreProcessingScaler's
    hot loop)."""
    src = np.ascontiguousarray(src, np.uint8)
    lib = _native()
    if lib is None:
        x = src.astype(np.float32) / max_pixel
        return x * (max_range - min_range) + min_range
    out = np.empty(src.shape, np.float32)
    lib.u8_to_f32_scaled(_u8ptr(src), _fptr(out), src.size, max_pixel,
                         min_range, max_range)
    return out


def standardize(data: np.ndarray, mean: np.ndarray,
                std: np.ndarray) -> np.ndarray:
    """(x - mean) / std over the trailing feature axis (NormalizerStandardize's
    hot loop); a new array."""
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    c = np.asarray(data).shape[-1]
    if mean.shape != (c,) or std.shape != (c,):
        raise ValueError(f"standardize: feature axis {c} != stats length "
                         f"{mean.shape[0]}")
    lib = _native()
    if lib is None:
        return ((np.asarray(data) - mean) / std).astype(np.float32)
    out = np.array(data, np.float32, order="C")
    lib.f32_standardize(_fptr(out), out.size // c, c, _fptr(mean), _fptr(std))
    return out


_NUMBER = re.compile(rb"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?")


def parse_csv_floats(text, delimiter: str = ",",
                     max_out: Optional[int] = None) -> np.ndarray:
    """Every float of a CSV chunk (CSVRecordReader's inner loop): the
    longest numeric prefix of each token, spaces and newlines as separators,
    tokens with no numeric prefix skipped."""
    if isinstance(text, str):
        text = text.encode()
    lib = _native()
    if lib is None:
        out = []
        for chunk in re.split(rb"[\n\r \t]|" + re.escape(delimiter.encode()),
                              text):
            m = _NUMBER.match(chunk)
            if m:
                out.append(float(m.group(0)))
        return np.array(out, np.float32)
    cap = max_out if max_out is not None else len(text) // 2 + 1
    out = np.empty(cap, np.float32)
    n = lib.parse_csv_floats(text, len(text), delimiter.encode(), _fptr(out), cap)
    return out[:n]


def gather_rows(table: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """out[i] = table[idx[i]]; the indices must be in range."""
    table = np.ascontiguousarray(table, np.float32)
    idx = np.ascontiguousarray(idx, np.int32)
    if idx.ndim != 1 or table.ndim != 2:
        raise ValueError("gather_rows needs 1-D idx over a 2-D table")
    if idx.size and (idx.min() < 0 or idx.max() >= table.shape[0]):
        raise IndexError("gather_rows index out of range")
    lib = _native()
    if lib is None:
        return table[idx]
    out = np.empty((idx.shape[0], table.shape[1]), np.float32)
    lib.gather_rows_f32(_fptr(table), _i32ptr(idx), _fptr(out), idx.shape[0],
                        table.shape[1])
    return out


def set_omp_threads(n: int) -> None:
    """Cap the calling thread's OpenMP team for the native calls. Pool
    workers that work at the image level pass 1, so the two layers of
    parallelism do not nest and oversubscribe the host. Where torch uses the
    same OpenMP runtime, the cap also makes that thread's torch CPU ops
    serial: call it on worker threads, not on the caller's."""
    lib = None if _forced_numpy else _load()
    if lib is not None:
        lib.etl_set_omp_threads(int(n))


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """HWC uint8 bilinear resize with half-pixel centers (OpenCV's
    INTER_LINEAR, which DataVec's NativeImageLoader uses); an image already
    of that size comes back as it is."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3:
        raise ValueError(f"resize_bilinear needs [H,W,C], got {img.shape}")
    h, w, c = img.shape
    if (h, w) == (out_h, out_w):
        return img
    lib = _native()
    if lib is None:
        fy = np.clip((np.arange(out_h) + 0.5) * (h / out_h) - 0.5, 0, None)
        fx = np.clip((np.arange(out_w) + 0.5) * (w / out_w) - 0.5, 0, None)
        y0 = np.minimum(fy.astype(np.int64), h - 1)
        x0 = np.minimum(fx.astype(np.int64), w - 1)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        wy = (fy - y0)[:, None, None]
        wx = (fx - x0)[None, :, None]
        f = img.astype(np.float32)
        top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
        bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
        return (top * (1 - wy) + bot * wy + 0.5).astype(np.uint8)
    out = np.empty((out_h, out_w, c), np.uint8)
    lib.u8_resize_bilinear_hwc(_u8ptr(img), h, w, c, _u8ptr(out), out_h, out_w)
    return out


def one_hot(labels: np.ndarray, classes: int) -> np.ndarray:
    """1-D int labels -> [n, classes] one-hot; a label outside [0, classes)
    gives an all-zero row on both arms."""
    labels = np.ascontiguousarray(labels, np.int32)
    if labels.ndim != 1:
        raise ValueError(f"one_hot needs 1-D labels, got {labels.shape}")
    lib = _native()
    if lib is None:
        out = np.zeros((labels.shape[0], classes), np.float32)
        valid = (labels >= 0) & (labels < classes)
        out[np.nonzero(valid)[0], labels[valid]] = 1.0
        return out
    out = np.empty((labels.shape[0], classes), np.float32)
    lib.one_hot_f32(_i32ptr(labels), _fptr(out), labels.shape[0], classes)
    return out
