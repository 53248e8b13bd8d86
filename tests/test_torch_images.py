"""The port's image reader against the JAX package's.

PNM files written by either package read back in the other (P5 and P6, a
comment in the header); `decode_image` converts channels as the JAX package
does (RGB -> luma, grey -> RGB) and decodes a PNG through Pillow where it is
installed, raising the JAX package's ImportError where it is not; over a
`root/<label>/<file>` directory, `ImageRecordReader` lists the same labels
and records (shuffled by the same seed), and
`ImageRecordReaderDataSetIterator` gives bitwise the JAX package's batches
with one worker and with a thread pool, scaled and as uint8.
"""
import os
import sys

import numpy as np
import pytest

import deeplearning4j_torch.data.images as port_img
import deeplearning4j_tpu.data.images as ref_img


def _img(seed, h, w, c):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


@pytest.mark.parametrize("c", [1, 3])
def test_pnm_written_by_either_reads_in_the_other(tmp_path, c):
    img = _img(c, 7, 9, c)
    ext = ".pgm" if c == 1 else ".ppm"
    port_img.write_ppm(str(tmp_path / f"p{ext}"), img)
    ref_img.write_ppm(str(tmp_path / f"r{ext}"), img)
    assert (tmp_path / f"p{ext}").read_bytes() == (tmp_path / f"r{ext}").read_bytes()
    np.testing.assert_array_equal(ref_img.read_pnm(str(tmp_path / f"p{ext}")), img)
    np.testing.assert_array_equal(port_img.read_pnm(str(tmp_path / f"r{ext}")), img)
    magic = b"P5" if c == 1 else b"P6"
    (tmp_path / f"c{ext}").write_bytes(magic + b"\n# a comment\n9 7\n255\n" + img.tobytes())
    np.testing.assert_array_equal(port_img.read_pnm(str(tmp_path / f"c{ext}")), img)
    for ch in (1, 3):
        np.testing.assert_array_equal(
            port_img.decode_image(str(tmp_path / f"p{ext}"), ch),
            ref_img.decode_image(str(tmp_path / f"p{ext}"), ch))


def test_png_through_pillow_or_the_reference_import_error(tmp_path, monkeypatch):
    pil = pytest.importorskip("PIL.Image")
    path = str(tmp_path / "a.png")
    pil.fromarray(_img(5, 6, 8, 3)).save(path)
    for ch in (1, 3):
        np.testing.assert_array_equal(port_img.decode_image(path, ch),
                                      ref_img.decode_image(path, ch))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError) as got:
        port_img.decode_image(path)
    with pytest.raises(ImportError) as want:
        ref_img.decode_image(path)
    assert str(got.value) == str(want.value)


def _tree(root, labels=("cat", "dog", "eel"), per=5, size=(14, 18)):
    for li, lab in enumerate(labels):
        os.makedirs(os.path.join(root, lab), exist_ok=True)
        for i in range(per):
            port_img.write_ppm(os.path.join(root, lab, f"{i}.ppm"),
                               _img(10 * li + i, *size, 3))
    (root / "notes.txt").write_text("not an image directory entry")
    (root / "cat" / "skip.txt").write_text("not an image")
    return str(root)


@pytest.mark.parametrize("shuffle", [False, True])
def test_reader_lists_the_reference_records(tmp_path, shuffle):
    root = _tree(tmp_path)
    got = port_img.ImageRecordReader(8, 8, 3, root=root, shuffle=shuffle, seed=3)
    want = ref_img.ImageRecordReader(8, 8, 3, root=root, shuffle=shuffle, seed=3)
    assert got.labels == want.labels == ["cat", "dog", "eel"]
    assert got.items == want.items and len(got) == 15
    img, label = next(iter(got))
    ref_first = next(iter(want))
    np.testing.assert_array_equal(img, ref_first[0])
    assert label == ref_first[1]
    with pytest.raises(ValueError):
        port_img.ImageRecordReader(8, 8, 3)


@pytest.mark.parametrize("workers,scale,hw", [(1, True, (10, 12)), (3, True, (10, 12)),
                                               (2, False, (6, 6)), (1, True, (14, 18))])
def test_iterator_matches_the_reference(tmp_path, workers, scale, hw):
    root = _tree(tmp_path)
    make = lambda mod: mod.ImageRecordReaderDataSetIterator(
        mod.ImageRecordReader(*hw, 3, root=root), batch_size=4, num_classes=5,
        scale=scale, workers=workers)
    got, want = list(make(port_img)), list(make(ref_img))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.features.dtype == w.features.dtype
        np.testing.assert_array_equal(g.features, w.features)
        np.testing.assert_array_equal(g.labels, w.labels)
    assert got[0].features.shape == (4, *hw, 3) and got[0].labels.shape == (4, 5)
