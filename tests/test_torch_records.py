"""The port's record readers and record-reader iterators against the JAX
package's: the same CSV files (written here from a numpy seed) give bitwise
the same DataSets, for classification, regression over a label span, no
label, a header skipped and another delimiter; `ListStringRecordReader`; and
the sequence iterator over ragged CSV sequences, with label files
(classification, regression) and with the label as a column, masks
included. A second pass after `reset` repeats the first.
"""
import numpy as np
import pytest

import deeplearning4j_torch.data.records as port_rec
import deeplearning4j_tpu.data.records as ref_rec


def _batches(it):
    return [(ds.features, ds.labels, ds.features_mask, ds.labels_mask) for ds in it]


def _same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def _csv(tmp_path, rows=23, delim=",", header=False, seed=0):
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((rows, 4)), 4)
    cls = rng.integers(0, 3, rows)
    lines = (["a,b,c,d,label,t1,t2"] if header else []) + [
        delim.join([*(f"{v:g}" for v in x[i]), str(cls[i]),
                    f"{x[i, 0] * 2:g}", f"{x[i, 1] - 1:g}"]) for i in range(rows)]
    path = tmp_path / f"data{seed}.csv"
    path.write_text("\n".join(lines) + "\n\n")
    return str(path)


@pytest.mark.parametrize("mode", ["classification", "regression", "unlabelled",
                                  "header", "semicolon"])
def test_csv_iterator_matches(tmp_path, mode):
    delim = ";" if mode == "semicolon" else ","
    path = _csv(tmp_path, delim=delim, header=mode == "header")
    kw = {"classification": dict(label_index=4, num_classes=3),
          "regression": dict(label_index=5, label_index_to=6, regression=True),
          "unlabelled": {}, "header": dict(label_index=4, num_classes=3),
          "semicolon": dict(label_index=4, num_classes=3)}[mode]
    make = lambda mod: mod.RecordReaderDataSetIterator(
        mod.CSVRecordReader(path, skip_lines=int(mode == "header"), delimiter=delim),
        batch_size=5, **kw)
    it = make(port_rec)
    got = _batches(it)
    _same(got, _batches(make(ref_rec)))
    _same(_batches(it), got)   # iterating again resets
    assert it.batch_size() == 5


def test_list_string_reader_and_errors():
    rows = [["1", "2", "0"], ["3", "4", "1"], ["5", "6", "1"]]
    got = _batches(port_rec.RecordReaderDataSetIterator(
        port_rec.ListStringRecordReader(rows), batch_size=2, label_index=2,
        num_classes=2))
    want = _batches(ref_rec.RecordReaderDataSetIterator(
        ref_rec.ListStringRecordReader(rows), batch_size=2, label_index=2,
        num_classes=2))
    _same(got, want)
    with pytest.raises(ValueError, match="num_classes"):
        port_rec.RecordReaderDataSetIterator(port_rec.ListStringRecordReader(rows),
                                             label_index=0)


def _sequences(tmp_path, n=5, seed=1):
    rng = np.random.default_rng(seed)
    feats, labels, regs = [], [], []
    for i in range(n):
        t = int(rng.integers(2, 7))
        x = np.round(rng.standard_normal((t, 3)), 3)
        c = rng.integers(0, 4, t)
        for kind, rows in (("f", [",".join(f"{v:g}" for v in r) + f",{k}"
                                  for r, k in zip(x, c)]),
                           ("l", [str(k) for k in c]),
                           ("r", [f"{v:g},{-v:g}" for v in x[:, 0]])):
            p = tmp_path / f"{kind}{i}.csv"
            p.write_text("\n".join(rows) + "\n")
            {"f": feats, "l": labels, "r": regs}[kind].append(str(p))
    return feats, labels, regs


@pytest.mark.parametrize("mode", ["label_files", "regression_files",
                                  "label_column", "regression_column"])
def test_sequence_iterator_matches(tmp_path, mode):
    feats, labels, regs = _sequences(tmp_path)

    def make(mod):
        f = mod.CSVSequenceRecordReader(feats)
        if mode == "label_files":
            return mod.SequenceRecordReaderDataSetIterator(
                f, mod.CSVSequenceRecordReader(labels), batch_size=2, num_classes=4)
        if mode == "regression_files":
            return mod.SequenceRecordReaderDataSetIterator(
                f, mod.CSVSequenceRecordReader(regs), batch_size=3, regression=True)
        if mode == "label_column":
            return mod.SequenceRecordReaderDataSetIterator(
                f, batch_size=2, num_classes=4, label_index=3)
        return mod.SequenceRecordReaderDataSetIterator(
            f, batch_size=4, regression=True, label_index=-1)

    got = _batches(make(port_rec))
    _same(got, _batches(make(ref_rec)))
    assert all(g[2] is not None and g[0].ndim == 3 for g in got)
