"""WordVectorSerializer: word2vec-C text/binary + CSV formats.

Port of `deeplearning4j_tpu/nlp/serializer.py`, unchanged: a file either
package writes reads back bitwise in the other.

Reference parity: models/embeddings/loader/WordVectorSerializer.java
(2,829 LoC): writeWordVectors (text), writeWord2VecModel,
loadGoogleModel(file, binaryMode) reading the original word2vec C formats,
loadTxtVectors. The zip'd full-model format (syn1 + vocab huffman state)
is served by the framework's generic checkpointing instead; what matters
for interop is the C text/binary round trip, which these functions keep
bit-compatible (binary: "V D\\n" header then "<word> " + D float32 LE)."""
from __future__ import annotations

import gzip

import numpy as np

from .vocab import VocabCache
from .word2vec import WordVectors


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


class WordVectorSerializer:
    # ------------------------------------------------------------- writing
    @staticmethod
    def write_word_vectors(vectors: WordVectors, path: str) -> None:
        """word2vec C TEXT format (reference writeWordVectors): one line
        per word: `word v1 v2 ...` (no header, like the reference's
        basic writer)."""
        mat = vectors.get_word_vector_matrix()
        with _open(path, "wt") as f:
            for i in range(mat.shape[0]):
                word = vectors.vocab.word_for_index(i)
                vals = " ".join(f"{x:.6g}" for x in mat[i])
                f.write(f"{word} {vals}\n")

    @staticmethod
    def write_word2vec_model(vectors: WordVectors, path: str,
                             binary: bool = True) -> None:
        """Google word2vec format WITH `V D` header, text or binary
        (reference writeWord2VecModel / the C tool's output)."""
        mat = np.asarray(vectors.get_word_vector_matrix(), np.float32)
        V, D = mat.shape
        if binary:
            with _open(path, "wb") as f:
                f.write(f"{V} {D}\n".encode("utf-8"))
                for i in range(V):
                    word = vectors.vocab.word_for_index(i)
                    f.write(word.encode("utf-8") + b" ")
                    f.write(mat[i].astype("<f4").tobytes())
                    f.write(b"\n")
        else:
            with _open(path, "wt") as f:
                f.write(f"{V} {D}\n")
                for i in range(V):
                    word = vectors.vocab.word_for_index(i)
                    vals = " ".join(repr(float(x)) for x in mat[i])
                    f.write(f"{word} {vals}\n")

    # ------------------------------------------------------------- loading
    @staticmethod
    def load_google_model(path: str, binary: bool = True) -> WordVectors:
        """Read Google word2vec format (reference loadGoogleModel)."""
        return (WordVectorSerializer._load_binary(path) if binary
                else WordVectorSerializer._load_text(path, header=True))

    @staticmethod
    def load_txt_vectors(path: str) -> WordVectors:
        """Read headerless text vectors (reference loadTxtVectors)."""
        return WordVectorSerializer._load_text(path, header=False)

    @staticmethod
    def _load_binary(path: str) -> WordVectors:
        with _open(path, "rb") as f:
            header = f.readline().decode("utf-8").strip().split()
            V, D = int(header[0]), int(header[1])
            words = []
            mat = np.empty((V, D), np.float32)
            for i in range(V):
                # word is whitespace-terminated utf-8
                chars = []
                while True:
                    ch = f.read(1)
                    if not ch or ch == b" ":
                        break
                    if ch != b"\n":  # leading newline from previous row
                        chars.append(ch)
                words.append(b"".join(chars).decode("utf-8"))
                mat[i] = np.frombuffer(f.read(4 * D), dtype="<f4")
        return WordVectorSerializer._make(words, mat)

    @staticmethod
    def _load_text(path: str, header: bool) -> WordVectors:
        words = []
        rows = []
        with _open(path, "rt") as f:
            first = f.readline()
            if header:
                parts = first.strip().split()
                V, D = int(parts[0]), int(parts[1])
            else:
                parts = first.rstrip("\n").split(" ")
                words.append(parts[0])
                rows.append(np.array(parts[1:], np.float32))
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < 2:
                    continue
                words.append(parts[0])
                rows.append(np.array(parts[1:], np.float32))
        mat = np.vstack(rows)
        return WordVectorSerializer._make(words, mat)

    @staticmethod
    def _make(words, mat) -> WordVectors:
        # Index in FILE order (vocab row i ↔ matrix row i); VocabCache
        # .finish() would re-sort by frequency and break the mapping.
        cache = VocabCache()
        for i, w in enumerate(words):
            cache.add_token(w, count=1)
            cache.words[w].index = i
        cache.index2word = list(words)
        return WordVectors(cache, mat)
