"""The image record reader and its iterator (the DataVec image path).

Port of `deeplearning4j_tpu/data/images.py` (reference DataVec's
ImageRecordReader: walk a directory tree, the label from the parent
directory's name (ParentPathLabelGenerator), decode, scale to the network's
[height, width, channels]; the records feed the image path of
RecordReaderDataSetIterator).

Decoded frames stay uint8 HWC on the host through the resize (the host ETL's
bilinear resize, native_etl.py) and the batch assembly; the float conversion
happens once a batch (`native_etl.u8_to_f32_scaled`). PPM/PGM (binary P6/P5)
have a parser of their own, so the reader needs no optional dependency;
PNG, JPEG and the other formats decode through Pillow where it is installed
and raise ImportError where it is not.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import native_etl
from .dataset import DataSet
from .iterators import DataSetIterator
from .records import RecordReader

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".ppm", ".pgm")


def read_pnm(path: str) -> np.ndarray:
    """Minimal P5 (grayscale) / P6 (RGB) binary PNM decoder -> uint8 HWC."""
    with open(path, "rb") as f:
        data = f.read()
    fields: List[bytes] = []
    i = 0
    while len(fields) < 4 and i < len(data):
        # skip whitespace and comments
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while i < len(data) and data[i] != 0x0A:
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        fields.append(data[i:j])
        i = j
    magic, w, h, maxval = fields[0], int(fields[1]), int(fields[2]), \
        int(fields[3])
    if magic not in (b"P5", b"P6"):
        raise ValueError(f"{path}: unsupported PNM magic {magic!r}")
    if maxval > 255:
        raise ValueError(f"{path}: 16-bit PNM not supported")
    c = 1 if magic == b"P5" else 3
    pixels = np.frombuffer(data, np.uint8, count=h * w * c, offset=i + 1)
    return pixels.reshape(h, w, c)


def write_ppm(path: str, img: np.ndarray) -> None:
    """uint8 HWC (1 or 3 channels) -> binary PNM (tests/synthesizers)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    magic = b"P5" if c == 1 else b"P6"
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def decode_image(path: str, channels: int = 3) -> np.ndarray:
    """File -> uint8 HWC with the requested channel count."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".ppm", ".pgm"):
        img = read_pnm(path)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                f"decoding {ext} needs Pillow; PPM/PGM work without it"
            ) from e
        with Image.open(path) as im:
            im = im.convert("L" if channels == 1 else "RGB")
            img = np.asarray(im, np.uint8)
        if img.ndim == 2:
            img = img[:, :, None]
    if img.shape[2] == channels:
        return img
    if channels == 1:  # rgb -> luma (ITU-R 601, what OpenCV uses)
        f = img.astype(np.float32)
        return (0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
                + 0.5).astype(np.uint8)[:, :, None]
    if img.shape[2] == 1:  # gray -> replicate
        return np.repeat(img, channels, axis=2)
    raise ValueError(f"{path}: cannot convert {img.shape[2]} channels "
                     f"to {channels}")


class ImageRecordReader(RecordReader):
    """Directory tree -> (uint8 HWC image, label index) records.

    `root/<label>/<file>` layout (ParentPathLabelGenerator); `labels`
    is the sorted label vocabulary. Images are resized to
    (height, width) through the native bilinear kernel."""

    def __init__(self, height: int, width: int, channels: int = 3,
                 root: Optional[str] = None,
                 paths: Optional[Sequence[Tuple[str, int]]] = None,
                 labels: Optional[Sequence[str]] = None,
                 shuffle: bool = False, seed: int = 123):
        self.height, self.width, self.channels = height, width, channels
        if root is not None:
            self.labels = sorted(
                d for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d)))
            self._items = []
            for li, lab in enumerate(self.labels):
                d = os.path.join(root, lab)
                for fn in sorted(os.listdir(d)):
                    if fn.lower().endswith(_IMAGE_EXTS):
                        self._items.append((os.path.join(d, fn), li))
        elif paths is not None:
            self._items = [(p, int(li)) for p, li in paths]
            self.labels = list(labels) if labels is not None else [
                str(i) for i in range(
                    max(li for _, li in self._items) + 1
                    if self._items else 0)]
        else:
            raise ValueError("ImageRecordReader needs root= or paths=")
        if not self._items:
            raise ValueError("ImageRecordReader found no images")
        if shuffle:
            rng = np.random.default_rng(seed)
            order = rng.permutation(len(self._items))
            self._items = [self._items[i] for i in order]
        self._i = 0

    def num_labels(self) -> int:
        return len(self.labels)

    def __len__(self):
        return len(self._items)

    def reset(self):
        self._i = 0

    @property
    def items(self) -> List[Tuple[str, int]]:
        """The (path, label index) records, in iteration order."""
        return self._items

    def load(self, item: Tuple[str, int]) -> Tuple[np.ndarray, int]:
        """Decode + resize one record — THE single implementation of the
        per-record pipeline (the sequential __next__ and the batched
        iterator's worker pool both call it)."""
        path, label = item
        img = decode_image(path, self.channels)
        return native_etl.resize_bilinear(img, self.height,
                                          self.width), label

    def __next__(self) -> Tuple[np.ndarray, int]:
        if self._i >= len(self._items):
            raise StopIteration
        item = self._items[self._i]
        self._i += 1
        return self.load(item)


class ImageRecordReaderDataSetIterator(DataSetIterator):
    """Image records -> NHWC float DataSets (the image path of the
    reference RecordReaderDataSetIterator). Scaling u8->f32 happens once
    per batch through the native ETL kernel (ImagePreProcessingScaler's
    hot loop); attach other normalizers via set_preprocessor."""

    def __init__(self, reader: ImageRecordReader, batch_size: int = 32,
                 num_classes: Optional[int] = None, scale: bool = True,
                 max_pixel: float = 255.0, workers: int = 1):
        self.reader = reader
        self._batch = int(batch_size)
        self.num_classes = num_classes or reader.num_labels()
        self.scale = scale
        self.max_pixel = max_pixel
        # decode+resize fan out over a thread pool: the hot loops (native
        # resize via ctypes, PNM frombuffer, PIL decode) all release the
        # GIL, so threads scale near-linearly (the reference's
        # FileSplitParallelDataSetIterator / multi-worker ETL role)
        self.workers = max(1, int(workers))
        self._pool = None
        self._i = 0

    def reset(self):
        self.reader.reset()
        self._i = 0

    def batch_size(self):
        return self._batch

    def total_examples(self):
        return len(self.reader)

    def __next__(self) -> DataSet:
        items = self.reader.items[self._i:self._i + self._batch]
        if not items:
            raise StopIteration
        self._i += len(items)
        if self.workers > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                # parallelism lives at the image level here; each worker
                # caps its own OpenMP team at 1 so the native kernels
                # don't nest a second layer and oversubscribe the host
                self._pool = ThreadPoolExecutor(
                    self.workers,
                    initializer=native_etl.set_omp_threads,
                    initargs=(1,))
            decoded = list(self._pool.map(self.reader.load, items))
        else:
            decoded = [self.reader.load(it) for it in items]
        batch = np.stack([d[0] for d in decoded])  # uint8 [B, H, W, C]
        labels = [d[1] for d in decoded]
        feats = native_etl.u8_to_f32_scaled(batch, self.max_pixel) \
            if self.scale else batch
        y = native_etl.one_hot(np.asarray(labels, np.int32),
                               self.num_classes)
        return self._maybe_preprocess(DataSet(feats, y))
