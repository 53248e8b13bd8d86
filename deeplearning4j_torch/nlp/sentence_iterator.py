"""Sentence / document iterators.

Port of `deeplearning4j_tpu/nlp/sentence_iterator.py`, unchanged: host code.

Reference parity: text/sentenceiterator/ (BasicLineIterator,
CollectionSentenceIterator, FileSentenceIterator, preprocessor hook) and
text/documentiterator/ (LabelAwareIterator, LabelsSource) used by
ParagraphVectors."""
from __future__ import annotations

import os
from typing import Callable, Iterable, Iterator, List, Optional


class SentenceIterator:
    def __iter__(self) -> Iterator[str]:
        raise NotImplementedError

    pre_processor: Optional[Callable[[str], str]] = None

    def _prep(self, s: str) -> str:
        return self.pre_processor(s) if self.pre_processor else s


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Iterable[str]):
        self._sentences = list(sentences)

    def __iter__(self):
        for s in self._sentences:
            yield self._prep(s)


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a file (reference BasicLineIterator)."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self):
        with open(self.path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield self._prep(line)


class FileSentenceIterator(SentenceIterator):
    """All files under a directory, line by line (reference
    FileSentenceIterator)."""

    def __init__(self, root: str):
        self.root = root

    def __iter__(self):
        for dirpath, _, files in os.walk(self.root):
            for name in sorted(files):
                with open(os.path.join(dirpath, name), "r",
                          encoding="utf-8", errors="replace") as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            yield self._prep(line)


class LabelsSource:
    """Document label generator/registry (reference
    text/documentiterator/LabelsSource)."""

    def __init__(self, template: str = "DOC_%d"):
        self.template = template
        self.labels: List[str] = []

    def next_label(self) -> str:
        label = self.template % len(self.labels)
        self.labels.append(label)
        return label

    def store_label(self, label: str):
        if label not in self.labels:
            self.labels.append(label)


class LabelledDocument:
    def __init__(self, content: str, labels: List[str]):
        self.content = content
        self.labels = list(labels)


class LabelAwareIterator:
    def __iter__(self) -> Iterator[LabelledDocument]:
        raise NotImplementedError


class SimpleLabelAwareIterator(LabelAwareIterator):
    def __init__(self, docs: Iterable[LabelledDocument]):
        self._docs = list(docs)

    def __iter__(self):
        return iter(self._docs)
