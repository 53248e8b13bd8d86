"""Built-in dataset fetchers and iterators: MNIST (the IDX binary format),
Iris, CIFAR-10 (its binary batch format), LFW (a directory of images) and
curves.

Port of `deeplearning4j_tpu/data/fetchers.py` (reference deeplearning4j-core
datasets/fetchers/{MnistDataFetcher, IrisDataFetcher, CurvesDataFetcher}.java
and datasets/iterator/impl/{Mnist,Iris,Cifar,LFW}DataSetIterator.java).
Nothing is downloaded: the readers take the reference's file formats from a
local directory (`path=`, default ``~/.deeplearning4j_torch/<name>``), and
with `synthesize=True` a deterministic stand-in is first written in the same
format (real IDX files, CIFAR binary batches, a directory of PPM images) and
read back through the same parsers, so the readers carry every run. Iris and
curves are synthesized in memory. The files and the DataSets are the JAX
package's, byte for byte, for the same arguments and seeds.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from .dataset import DataSet
from .iterators import DataSetIterator, ListDataSetIterator

IDX_IMAGES_MAGIC = 2051  # 0x803: idx3-ubyte (images)
IDX_LABELS_MAGIC = 2049  # 0x801: idx1-ubyte (labels)

MNIST_FILES = {
    "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _open_maybe_gz(path: str, mode: str = "rb"):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", mode)
    return open(path, mode)


def read_idx_images(path: str) -> np.ndarray:
    """Parse idx3-ubyte (reference MnistImageFile.java): big-endian magic,
    count, rows, cols, then uint8 pixels."""
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">iiii", f.read(16))
        if magic != IDX_IMAGES_MAGIC:
            raise ValueError(f"{path}: bad magic {magic} (want "
                             f"{IDX_IMAGES_MAGIC})")
        data = np.frombuffer(f.read(n * rows * cols), np.uint8)
    return data.reshape(n, rows, cols)


def read_idx_labels(path: str) -> np.ndarray:
    """Parse idx1-ubyte (reference MnistLabelFile.java)."""
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">ii", f.read(8))
        if magic != IDX_LABELS_MAGIC:
            raise ValueError(f"{path}: bad magic {magic} (want "
                             f"{IDX_LABELS_MAGIC})")
        return np.frombuffer(f.read(n), np.uint8)


def write_idx_images(path: str, images: np.ndarray) -> None:
    n, rows, cols = images.shape
    with open(path, "wb") as f:
        f.write(struct.pack(">iiii", IDX_IMAGES_MAGIC, n, rows, cols))
        f.write(np.ascontiguousarray(images, np.uint8).tobytes())


def write_idx_labels(path: str, labels: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack(">ii", IDX_LABELS_MAGIC, labels.shape[0]))
        f.write(np.ascontiguousarray(labels, np.uint8).tobytes())


def synthesize_mnist_idx(directory: str, n_train: int = 1024,
                         n_test: int = 256, seed: int = 42) -> None:
    """Write a deterministic MNIST-shaped dataset as REAL idx files:
    each class k is a distinct blob pattern + noise, so small models can
    genuinely learn from it (tests/benches need learnable structure)."""
    rng = np.random.default_rng(seed)
    protos = np.zeros((10, 28, 28), np.float32)
    for k in range(10):
        r, c = 4 + (k % 5) * 4, 4 + (k // 5) * 9
        yy, xx = np.mgrid[0:28, 0:28]
        protos[k] = 200 * np.exp(-((yy - r) ** 2 + (xx - c) ** 2)
                                 / (2 * 9.0))
    os.makedirs(directory, exist_ok=True)
    for split, n in (("train", n_train), ("test", n_test)):
        labels = rng.integers(0, 10, n).astype(np.uint8)
        imgs = protos[labels] + rng.normal(0, 20, (n, 28, 28))
        imgs = np.clip(imgs, 0, 255).astype(np.uint8)
        img_f, lab_f = MNIST_FILES[split]
        write_idx_images(os.path.join(directory, img_f), imgs)
        write_idx_labels(os.path.join(directory, lab_f), labels)


class MnistDataFetcher:
    """Load MNIST from idx binaries (reference MnistDataFetcher.java,
    nothing downloaded)."""

    def __init__(self, path: Optional[str] = None, train: bool = True,
                 synthesize: bool = False, seed: int = 42):
        if path is None:
            path = os.path.join(os.path.expanduser("~"), ".deeplearning4j_torch",
                                "mnist")
        self.path = path
        img_f, lab_f = MNIST_FILES["train" if train else "test"]
        img_p = os.path.join(path, img_f)
        lab_p = os.path.join(path, lab_f)
        if not (os.path.exists(img_p) or os.path.exists(img_p + ".gz")):
            if not synthesize:
                raise FileNotFoundError(
                    f"MNIST idx files not found under {path!r}. Place "
                    "train-images-idx3-ubyte etc. there (nothing is "
                    "downloaded), or pass synthesize=True for a "
                    "deterministic MNIST-shaped stand-in.")
            synthesize_mnist_idx(path, seed=seed)
        self.images = read_idx_images(img_p)
        self.labels = read_idx_labels(lab_p)

    def as_dataset(self, num_examples: Optional[int] = None,
                   flatten: bool = True) -> DataSet:
        imgs = self.images[:num_examples].astype(np.float32)
        labs = self.labels[:num_examples]
        x = imgs.reshape(len(imgs), -1) if flatten \
            else imgs[..., None]  # NHWC
        y = np.eye(10, dtype=np.float32)[labs]
        return DataSet(x, y)


class MnistDataSetIterator(ListDataSetIterator):
    """Reference MnistDataSetIterator(batch, numExamples, ...). Pixels
    stay raw 0-255 like the reference default (attach an
    ImagePreProcessingScaler / NormalizerStandardize via
    set_pre_processor, exactly the reference workflow)."""

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 train: bool = True, flatten: bool = True,
                 shuffle: bool = False, seed: Optional[int] = None,
                 path: Optional[str] = None, synthesize: bool = False):
        fetcher = MnistDataFetcher(path=path, train=train,
                                   synthesize=synthesize)
        ds = fetcher.as_dataset(num_examples, flatten=flatten)
        super().__init__(ds, batch_size=batch_size, shuffle=shuffle,
                         seed=seed)


def iris_dataset(seed: int = 6) -> DataSet:
    """150x4, 3 balanced classes (synthesized clusters with roughly the
    classic species' means/spreads; see module docstring)."""
    rng = np.random.default_rng(seed)
    means = np.array([[5.0, 3.4, 1.5, 0.25],
                      [5.9, 2.8, 4.3, 1.3],
                      [6.6, 3.0, 5.6, 2.0]], np.float32)
    stds = np.array([[0.35, 0.38, 0.17, 0.10],
                     [0.51, 0.31, 0.47, 0.20],
                     [0.63, 0.32, 0.55, 0.27]], np.float32)
    xs, ys = [], []
    for k in range(3):
        xs.append(rng.normal(means[k], stds[k], (50, 4)).astype(np.float32))
        ys.append(np.full(50, k))
    x = np.concatenate(xs)
    y = np.eye(3, dtype=np.float32)[np.concatenate(ys)]
    order = rng.permutation(150)
    return DataSet(x[order], y[order])


class IrisDataSetIterator(ListDataSetIterator):
    """Reference IrisDataSetIterator(batch, numExamples)."""

    def __init__(self, batch_size: int = 150,
                 num_examples: Optional[int] = None, seed: int = 6):
        ds = iris_dataset(seed)
        if num_examples is not None:
            ds = DataSet(ds.features[:num_examples],
                         ds.labels[:num_examples])
        super().__init__(ds, batch_size=batch_size)


# ---------------------------------------------------------------------------
# CIFAR-10 (binary batch format)
# ---------------------------------------------------------------------------

CIFAR_TRAIN_FILES = [f"data_batch_{i}.bin" for i in range(1, 6)]
CIFAR_TEST_FILES = ["test_batch.bin"]
CIFAR_RECORD_BYTES = 1 + 3 * 32 * 32  # label byte + CHW planar pixels
CIFAR_LABELS = ["airplane", "automobile", "bird", "cat", "deer", "dog",
                "frog", "horse", "ship", "truck"]


def read_cifar_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse one CIFAR-10 binary batch file (the format the reference's
    CifarDataSetIterator consumes via CifarLoader): records of
    [label u8][3072 u8 CHW planar]. Returns (uint8 NHWC images,
    labels)."""
    raw = np.fromfile(path, np.uint8)
    if raw.size % CIFAR_RECORD_BYTES:
        raise ValueError(f"{path}: size {raw.size} not a multiple of the "
                         f"{CIFAR_RECORD_BYTES}-byte CIFAR record")
    recs = raw.reshape(-1, CIFAR_RECORD_BYTES)
    labels = recs[:, 0].copy()
    chw = recs[:, 1:].reshape(-1, 3, 32, 32)
    # whole-batch vectorized transpose: one numpy op over all records
    imgs = np.ascontiguousarray(chw.transpose(0, 2, 3, 1))
    return imgs, labels


def write_cifar_bin(path: str, images: np.ndarray,
                    labels: np.ndarray) -> None:
    """uint8 NHWC images + labels -> CIFAR-10 binary batch format."""
    images = np.ascontiguousarray(images, np.uint8)
    n = images.shape[0]
    recs = np.empty((n, CIFAR_RECORD_BYTES), np.uint8)
    recs[:, 0] = labels
    recs[:, 1:] = images.transpose(0, 3, 1, 2).reshape(n, -1)
    recs.tofile(path)


def synthesize_cifar_bin(directory: str, n_train: int = 1024,
                         n_test: int = 256, seed: int = 43) -> None:
    """Deterministic CIFAR-shaped dataset written as REAL binary batch
    files (class = colored blob at a class-specific position + noise, so
    conv models genuinely learn; same contract as synthesize_mnist_idx)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:32, 0:32]
    protos = np.zeros((10, 32, 32, 3), np.float32)
    for k in range(10):
        r, c = 6 + (k % 5) * 5, 6 + (k // 5) * 16
        blob = 180 * np.exp(-((yy - r) ** 2 + (xx - c) ** 2) / (2 * 16.0))
        for ch in range(3):
            protos[k, :, :, ch] = blob * (0.4 + 0.6 * ((k + ch) % 3 == 0))
    os.makedirs(directory, exist_ok=True)
    per_file = -(-n_train // len(CIFAR_TRAIN_FILES))
    done = 0
    for fn in CIFAR_TRAIN_FILES:
        n = min(per_file, n_train - done)
        if n <= 0:
            n = 1
        labels = rng.integers(0, 10, n).astype(np.uint8)
        imgs = np.clip(protos[labels] + rng.normal(0, 25, (n, 32, 32, 3)),
                       0, 255).astype(np.uint8)
        write_cifar_bin(os.path.join(directory, fn), imgs, labels)
        done += n
    labels = rng.integers(0, 10, n_test).astype(np.uint8)
    imgs = np.clip(protos[labels] + rng.normal(0, 25, (n_test, 32, 32, 3)),
                   0, 255).astype(np.uint8)
    write_cifar_bin(os.path.join(directory, CIFAR_TEST_FILES[0]), imgs,
                    labels)


class CifarDataSetIterator(ListDataSetIterator):
    """Reference datasets/iterator/impl/CifarDataSetIterator.java (over
    CifarLoader's binary batches), nothing downloaded: reads the CIFAR-10
    binary format from `path`; synthesize=True writes a deterministic
    stand-in in the same format first (module docstring contract).
    Features are NHWC floats, raw 0-255 like the reference default —
    attach ImagePreProcessingScaler via set_pre_processor."""

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 train: bool = True, path: Optional[str] = None,
                 synthesize: bool = False, shuffle: bool = False,
                 seed: Optional[int] = None):
        if path is None:
            path = os.path.join(os.path.expanduser("~"),
                                ".deeplearning4j_torch", "cifar10")
        files = CIFAR_TRAIN_FILES if train else CIFAR_TEST_FILES
        first = os.path.join(path, files[0])
        if not os.path.exists(first):
            if not synthesize:
                raise FileNotFoundError(
                    f"CIFAR-10 binary batches not found under {path!r} "
                    "(nothing is downloaded); pass "
                    "synthesize=True for a deterministic stand-in")
            synthesize_cifar_bin(path)
        img_parts, lab_parts = [], []
        for fn in files:
            p = os.path.join(path, fn)
            if os.path.exists(p):
                im, lb = read_cifar_bin(p)
                img_parts.append(im)
                lab_parts.append(lb)
        imgs = np.concatenate(img_parts)[:num_examples]
        labels = np.concatenate(lab_parts)[:num_examples]
        ds = DataSet(imgs.astype(np.float32),
                     np.eye(10, dtype=np.float32)[labels])
        super().__init__(ds, batch_size=batch_size, shuffle=shuffle,
                         seed=seed)


# ---------------------------------------------------------------------------
# LFW (labeled faces — directory-of-images layout)
# ---------------------------------------------------------------------------


def synthesize_lfw_dir(directory: str, num_people: int = 6,
                       per_person: int = 8, size: int = 48,
                       seed: int = 44) -> None:
    """Deterministic LFW-shaped corpus: root/<person>/<img>.ppm with a
    per-person base face pattern + noise (REAL image files on disk so
    ImageRecordReader's decode+resize path stays load-bearing)."""
    from .images import write_ppm
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    for p in range(num_people):
        pdir = os.path.join(directory, f"person_{p:02d}")
        os.makedirs(pdir, exist_ok=True)
        cy, cx = size // 2 + (p % 3 - 1) * size // 6, \
            size // 2 + (p // 3 - 1) * size // 6
        base = 160 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                            / (2 * (size / 5.0) ** 2))
        for i in range(per_person):
            img = np.clip(
                base[:, :, None] * (0.5 + 0.5 * np.eye(3)[p % 3])
                + rng.normal(0, 20, (size, size, 3)), 0, 255
            ).astype(np.uint8)
            write_ppm(os.path.join(pdir, f"img_{i:03d}.ppm"), img)


class LFWDataSetIterator(DataSetIterator):
    """Reference datasets/iterator/impl/LFWDataSetIterator.java:
    directory-of-faces -> resized NHWC batches with person labels, via
    ImageRecordReader (nothing downloaded: synthesize=True writes a
    deterministic PPM corpus in the same layout)."""

    def __init__(self, batch_size: int, image_shape=(64, 64, 3),
                 path: Optional[str] = None, synthesize: bool = False,
                 num_examples: Optional[int] = None):
        from .images import ImageRecordReader, \
            ImageRecordReaderDataSetIterator
        if path is None:
            path = os.path.join(os.path.expanduser("~"),
                                ".deeplearning4j_torch", "lfw")
        has_people = os.path.isdir(path) and any(
            os.path.isdir(os.path.join(path, d))
            for d in os.listdir(path) if not d.startswith("."))
        if not has_people:
            if not synthesize:
                raise FileNotFoundError(
                    f"no LFW-style directory tree under {path!r} (this "
                    "package downloads nothing); pass synthesize=True")
            synthesize_lfw_dir(path)
        h, w, c = image_shape
        self._reader = ImageRecordReader(h, w, c, root=path)
        self._inner = ImageRecordReaderDataSetIterator(
            self._reader, batch_size=batch_size, scale=True)
        self._limit = num_examples
        self._served = 0

    @property
    def labels(self):
        return self._reader.labels

    def reset(self):
        self._inner.reset()
        self._served = 0

    def batch_size(self):
        return self._inner.batch_size()

    def total_examples(self):
        n = len(self._reader)
        return n if self._limit is None else min(n, self._limit)

    def __next__(self) -> DataSet:
        if self._limit is not None and self._served >= self._limit:
            raise StopIteration
        ds = next(self._inner)
        if self._limit is not None and \
                self._served + ds.features.shape[0] > self._limit:
            keep = self._limit - self._served
            ds = DataSet(ds.features[:keep], ds.labels[:keep])
        self._served += ds.features.shape[0]
        return self._maybe_preprocess(ds)


# ---------------------------------------------------------------------------
# Curves (the classic deep-autoencoder dataset shape)
# ---------------------------------------------------------------------------


def curves_dataset(n: int = 2048, seed: int = 45) -> DataSet:
    """The reference's CurvesDataFetcher downloads curves.ser — 28x28
    rasterized random smooth curves, the Hinton deep-autoencoder
    benchmark shape. Nothing is downloaded: deterministic synthesis of the same
    kind of data (three-control-point quadratic Bezier curves rasterized
    to 28x28, values in [0,1]); features == labels (reconstruction
    task), exactly how the reference serves it (CurvesDataFetcher.java)."""
    rng = np.random.default_rng(seed)
    size = 28
    imgs = np.zeros((n, size, size), np.float32)
    t = np.linspace(0.0, 1.0, 64)[:, None]
    for i in range(n):
        p = rng.uniform(3, size - 4, (3, 2))
        pts = ((1 - t) ** 2 * p[0] + 2 * (1 - t) * t * p[1] + t ** 2 * p[2])
        xi = np.clip(pts[:, 0].round().astype(int), 0, size - 1)
        yi = np.clip(pts[:, 1].round().astype(int), 0, size - 1)
        imgs[i, yi, xi] = 1.0
    flat = imgs.reshape(n, size * size)
    return DataSet(flat, flat.copy())


class CurvesDataSetIterator(ListDataSetIterator):
    """Reference datasets/fetchers/CurvesDataFetcher.java served through
    the iterator SPI (features == labels, autoencoder-style)."""

    def __init__(self, batch_size: int = 128, num_examples: int = 2048,
                 seed: int = 45):
        super().__init__(curves_dataset(num_examples, seed),
                         batch_size=batch_size)
