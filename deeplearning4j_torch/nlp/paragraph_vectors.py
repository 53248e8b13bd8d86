"""ParagraphVectors (doc2vec): DBOW + DM with inferVector.

Port of `deeplearning4j_tpu/nlp/paragraph_vectors.py` (reference
models/paragraphvectors/ParagraphVectors.java, learning/impl/sequence/
{DBOW.java, DM.java}, text/documentiterator/LabelsSource), on the same
batched device steps as nlp/embeddings.py:
  * DBOW: the element objective with the DOCUMENT vector as the predictor,
    i.e. `_hs_step`/`_ns_step` with the doc table as `syn0`.
  * DM: CBOW where the averaged context includes the doc vector; one step
    updates the doc rows, the word rows and the output table together.
  * inferVector: the word and output tables frozen, SGD on one fresh doc
    row (a Python loop of steps where the JAX package runs a fori_loop).
    Its HS form has no MAX_EXP skip, unlike training, as in the JAX
    package.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .embeddings import (_hs_step, _ns_step, generate_cbow, hs_grads,
                         ns_grads, row_counts, scatter_update)
from .tokenization import DefaultTokenizerFactory
from .vocab import VocabConstructor
from .word2vec import WordVectors


class LabelsSource:
    """Doc label bookkeeping (reference text/documentiterator/
    LabelsSource.java): auto-generates DOC_<n> or records given labels."""

    def __init__(self, template: str = "DOC_%d"):
        self.template = template
        self.labels: List[str] = []
        self._index: Dict[str, int] = {}

    def next_label(self) -> str:
        label = self.template % len(self.labels)
        self.add(label)
        return label

    def add(self, label: str) -> int:
        if label not in self._index:
            self._index[label] = len(self.labels)
            self.labels.append(label)
        return self._index[label]

    def index_of(self, label: str) -> int:
        return self._index.get(label, -1)

    def __len__(self):
        return len(self.labels)


def _dm_predictor(tables, docids, contexts):
    """h = (sum of the unmasked context rows + the doc row) / (count + 1)."""
    syn0 = tables["syn0"]
    mask = (contexts >= 0).to(syn0.dtype)                # [B, W]
    ctx = syn0[contexts.clamp_min(0).long()]
    dvec = tables["docs"][docids.long()]                 # [B, D]
    denom = mask.sum(-1, keepdim=True) + 1.0             # + doc slot
    return ((ctx * mask[..., None]).sum(1) + dvec) / denom, mask, denom


def _dm_input_update(tables, docids, contexts, gh, lr, mask, denom):
    """Scatter the predictor's gradient into the word rows and doc rows."""
    g_in = gh / denom
    syn0, docs = tables["syn0"], tables["docs"]
    scatter_update(syn0, contexts, g_in[:, None, :] * mask[..., None],
                   row_counts(syn0.shape[0], contexts, contexts >= 0), lr)
    scatter_update(docs, docids, g_in, row_counts(docs.shape[0], docids), lr)


def _dm_ns_step(tables, docids, contexts, centers, negatives, lr):
    """PV-DM negative-sampling step (reference DM.java), in place on
    {"docs", "syn0", "syn1neg"}: the predictor is the mean of the context
    word vectors and the doc vector. Returns (tables, loss / batch)."""
    h, mask, denom = _dm_predictor(tables, docids, contexts)
    syn1neg = tables["syn1neg"]
    pos = syn1neg[centers.long()]
    neg = syn1neg[negatives.long()]
    loss, gh, g_pos, g_neg = ns_grads(h, pos, neg)
    syn1_idx = torch.cat([centers.reshape(-1, 1).long(), negatives.long()], dim=1)
    _dm_input_update(tables, docids, contexts, gh, lr, mask, denom)
    scatter_update(syn1neg, syn1_idx, torch.cat([g_pos[:, None, :], g_neg], dim=1),
                   row_counts(syn1neg.shape[0], syn1_idx), lr)
    return tables, loss / docids.shape[0]


def _dm_hs_step(tables, docids, contexts, codes, points, lr):
    """PV-DM hierarchical-softmax step (doc + context mean against the
    huffman path of the center word), with the MAX_EXP skip, in place on
    {"docs", "syn0", "syn1"}."""
    h, mask, denom = _dm_predictor(tables, docids, contexts)
    syn1 = tables["syn1"]
    pts = syn1[points.clamp_min(0).long()]
    loss, gh, g_pts = hs_grads(h, pts, codes)
    _dm_input_update(tables, docids, contexts, gh, lr, mask, denom)
    scatter_update(syn1, points, g_pts, row_counts(syn1.shape[0], points, codes >= 0),
                   lr)
    return tables, loss / docids.shape[0]


def _infer_ns(doc, syn1neg, targets, negatives, lrs, steps: int):
    """inferVector (NS): `steps` SGD steps on the single doc row [D] against
    the frozen output table; negatives [steps, N, K], lrs [steps]."""
    tmask = (targets >= 0).to(doc.dtype)                 # [N]
    denom = (targets >= 0).sum().to(doc.dtype).clamp_min(1.0)
    pos = syn1neg[targets.clamp_min(0).long()]           # [N, D]
    for i in range(steps):
        neg = syn1neg[negatives[i].long()]               # [N, K, D]
        d_pos = -torch.sigmoid(-(pos @ doc)) * tmask
        d_neg = torch.sigmoid(neg @ doc) * tmask[:, None]
        g = d_pos @ pos + torch.einsum("nk,nkd->d", d_neg, neg)
        doc = doc - lrs[i] * g / denom
    return doc


def _infer_hs(doc, syn1, codes, points, lrs, steps: int):
    """inferVector (HS): `steps` SGD steps on the single doc row against the
    huffman paths [N, L] of the document's words; no MAX_EXP skip."""
    pts = syn1[points.clamp_min(0).long()]               # [N, L, D]
    denom = (codes[:, 0] >= 0).sum().to(doc.dtype).clamp_min(1.0)
    for i in range(steps):
        _, gh, _ = hs_grads(doc.expand(pts.shape[0], -1), pts, codes, skip=False)
        doc = doc - lrs[i] * gh.sum(0) / denom
    return doc


def init_doc_table(seed: int, n_docs: int, D: int,
                   device: torch.device) -> torch.Tensor:
    """The doc table's float32 init, U(-0.5/D, 0.5/D), drawn on `device`
    from a generator seeded `seed`. The JAX package draws it with
    `jax.random.uniform(PRNGKey(seed), ...)`; tests replace this function by
    that draw, carried."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand((n_docs, D), generator=gen, device=device, dtype=torch.float32)
    return u * (1.0 / D) - 0.5 / D


class ParagraphVectors(WordVectors):
    """Builder-configured doc2vec (reference ParagraphVectors.Builder)."""

    def __init__(self, **kw):
        self._kw = kw
        self.labels_source: LabelsSource = kw.get("labels_source",
                                                  LabelsSource())
        self._doc_vectors: Optional[np.ndarray] = None
        self._trainer = None
        self.vocab = None
        self._vectors = None
        self._normed = None

    @staticmethod
    def builder() -> "ParagraphVectorsBuilder":
        return ParagraphVectorsBuilder()

    # ------------------------------------------------------------------ fit
    def fit(self) -> "ParagraphVectors":
        kw = self._kw
        it = kw["iterate"]
        tf = kw.get("tokenizer_factory", DefaultTokenizerFactory())
        labels = kw.get("labels")

        docs = [tf.create(s).get_tokens() for s in it]
        if labels is None:
            labels = [self.labels_source.next_label() for _ in docs]
        else:
            for lb in labels:
                self.labels_source.add(lb)
        if len(labels) != len(docs):
            raise ValueError(f"{len(labels)} labels for {len(docs)} docs")

        cache = VocabConstructor(
            min_word_frequency=kw.get("min_word_frequency", 1)).build(docs)
        self.vocab = cache

        from .embeddings import BatchedEmbeddingTrainer
        self._trainer = BatchedEmbeddingTrainer(
            cache,
            layer_size=kw.get("layer_size", 100),
            window=kw.get("window_size", 5),
            negative=kw.get("negative", 0),
            use_hierarchic_softmax=kw.get("use_hierarchic_softmax", True),
            cbow=False,
            learning_rate=kw.get("learning_rate", 0.025),
            min_learning_rate=kw.get("min_learning_rate", 1e-4),
            batch_size=kw.get("batch_size", 1024),
            sampling=kw.get("sampling", 0.0),
            seed=kw.get("seed", 42), device=kw.get("device"))
        trainer = self._trainer
        # Index once, preserving empty docs so doc-row ↔ label alignment
        # survives docs whose tokens all fall under min frequency.
        indexed_all = []
        for tokens in docs:
            ids = [cache.index_of(t) for t in tokens]
            indexed_all.append(np.array([i for i in ids if i >= 0],
                                        dtype=np.int32))
        indexed = [ids for ids in indexed_all if len(ids) > 1]

        epochs = kw.get("epochs", 1) * kw.get("iterations", 1)
        if kw.get("train_word_vectors", True) and indexed:
            trainer.fit_sentences(indexed, epochs=epochs)

        self._fit_docs(indexed_all, epochs)
        self._vectors = trainer.vectors()
        self._normed = None
        return self

    def _gen_doc_pairs(self, indexed_docs, algo: str, window: int, rng):
        """One epoch of training rows. DBOW: (doc, word) — every word
        predicted from the doc vector. DM: (doc, context-window, center) —
        CBOW rows tagged with their doc (reference DM.java consumes
        label + context jointly)."""
        if algo == "dbow":
            dids, tgts = [], []
            for d, ids in enumerate(indexed_docs):
                dids.extend([d] * len(ids))
                tgts.extend(ids.tolist())
            return (np.asarray(dids, np.int32), None,
                    np.asarray(tgts, np.int32))
        if algo == "dm":
            dids, ctx_rows, centers = [], [], []
            for d, ids in enumerate(indexed_docs):
                if len(ids) < 2:
                    continue
                ctxs, cents = generate_cbow([ids], window, rng)
                dids.extend([d] * len(cents))
                ctx_rows.append(ctxs)
                centers.append(cents)
            if not dids:
                return (np.empty(0, np.int32), None, np.empty(0, np.int32))
            return (np.asarray(dids, np.int32), np.vstack(ctx_rows),
                    np.concatenate(centers).astype(np.int32))
        raise ValueError(f"Unknown sequence algorithm {algo!r}")

    def _fit_docs(self, indexed_docs, epochs: int):
        """DBOW or DM passes over the doc table, sharing the trainer's
        output tables (syn1/syn1neg)."""
        kw = self._kw
        trainer = self._trainer
        rng = np.random.default_rng(kw.get("seed", 42) + 1)
        D = trainer.layer_size
        dev = trainer.device
        doc_tab = init_doc_table(kw.get("seed", 42) + 1, len(indexed_docs), D,
                                 dev)
        put = lambda a: torch.as_tensor(a, device=dev)
        algo = kw.get("sequence_learning_algorithm", "dbow").lower()
        B = trainer.batch_size
        lr0 = trainer.lr
        total = None  # sized from the FIRST epoch's true row count
        step = 0
        for _ in range(epochs):
            dids, ctxs, tgts = self._gen_doc_pairs(
                indexed_docs, algo, trainer.window, rng)
            n = len(dids)
            if n == 0:
                continue
            if total is None:
                total = max(1, epochs * ((n + B - 1) // B))
            order = rng.permutation(n)
            dids, tgts = dids[order], tgts[order]
            if ctxs is not None:
                ctxs = ctxs[order]
            for start in range(0, n, B):
                end = min(start + B, n)
                lr = float(np.float32(
                    max(trainer.min_lr, lr0 * (1.0 - step / total))))
                dc = put(dids[start:end])
                tg = put(tgts[start:end])
                t_np = tgts[start:end]
                if algo == "dbow":
                    # DBOW == skip-gram with the doc table as predictor
                    if trainer.use_hs:
                        tables = {"syn0": doc_tab,
                                  "syn1": trainer.tables["syn1"]}
                        tables, _ = _hs_step(
                            tables, dc, tg, put(trainer._codes[t_np]),
                            put(trainer._points[t_np]), lr)
                        doc_tab = tables["syn0"]
                        trainer.tables["syn1"] = tables["syn1"]
                    if trainer.negative > 0:
                        negs = rng.choice(trainer._unigram,
                                          size=(end - start, trainer.negative))
                        tables = {"syn0": doc_tab,
                                  "syn1neg": trainer.tables["syn1neg"]}
                        tables, _ = _ns_step(tables, dc, tg, put(negs), lr)
                        doc_tab = tables["syn0"]
                        trainer.tables["syn1neg"] = tables["syn1neg"]
                else:  # dm
                    cx = put(ctxs[start:end])
                    if trainer.use_hs:
                        tables = {"docs": doc_tab,
                                  "syn0": trainer.tables["syn0"],
                                  "syn1": trainer.tables["syn1"]}
                        tables, _ = _dm_hs_step(
                            tables, dc, cx, put(trainer._codes[t_np]),
                            put(trainer._points[t_np]), lr)
                        doc_tab = tables["docs"]
                        trainer.tables["syn0"] = tables["syn0"]
                        trainer.tables["syn1"] = tables["syn1"]
                    if trainer.negative > 0:
                        negs = rng.choice(trainer._unigram,
                                          size=(end - start, trainer.negative))
                        tables = {"docs": doc_tab,
                                  "syn0": trainer.tables["syn0"],
                                  "syn1neg": trainer.tables["syn1neg"]}
                        tables, _ = _dm_ns_step(tables, dc, cx, tg, put(negs), lr)
                        doc_tab = tables["docs"]
                        trainer.tables["syn0"] = tables["syn0"]
                        trainer.tables["syn1neg"] = tables["syn1neg"]
                step += 1
        self._doc_vectors = doc_tab.detach().cpu().numpy()

    # -------------------------------------------------------------- queries
    def doc_vector(self, label: str) -> Optional[np.ndarray]:
        i = self.labels_source.index_of(label)
        if i < 0 or self._doc_vectors is None:
            return None
        return self._doc_vectors[i]

    def similarity_docs(self, label1: str, label2: str) -> float:
        a, b = self.doc_vector(label1), self.doc_vector(label2)
        if a is None or b is None:
            return float("nan")
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        return float(a @ b / denom) if denom else 0.0

    def infer_vector(self, text_or_tokens, iterations: int = 50,
                     learning_rate: float = 0.025,
                     min_learning_rate: float = 1e-4) -> np.ndarray:
        """Embed an UNSEEN document: fresh doc row trained against frozen
        tables (reference ParagraphVectors.inferVector)."""
        if self._trainer is None:
            raise RuntimeError("Call fit() before infer_vector()")
        kw = self._kw
        tf = kw.get("tokenizer_factory", DefaultTokenizerFactory())
        tokens = (text_or_tokens if isinstance(text_or_tokens, (list, tuple))
                  else tf.create(text_or_tokens).get_tokens())
        ids = np.array([i for i in (self.vocab.index_of(t) for t in tokens)
                        if i >= 0], np.int32)
        trainer = self._trainer
        D = trainer.layer_size
        put = lambda a: torch.as_tensor(a, device=trainer.device)
        # hash of an int tuple is the same in every process: the same seed
        # as the JAX package's, so the same doc init and negatives
        rng = np.random.default_rng(abs(hash(tuple(ids.tolist()))) % (2**31))
        doc = put(rng.uniform(-0.5 / D, 0.5 / D, D).astype(np.float32))
        lrs = put(np.maximum(
            min_learning_rate,
            learning_rate * (1.0 - np.arange(iterations) / iterations)
        ).astype(np.float32))
        if len(ids) == 0:
            return doc.cpu().numpy()
        with torch.no_grad():
            if trainer.use_hs:
                doc = _infer_hs(doc, trainer.tables["syn1"].float(),
                                put(trainer._codes[ids]),
                                put(trainer._points[ids]), lrs, int(iterations))
            if trainer.negative > 0:
                negs = rng.choice(trainer._unigram,
                                  size=(iterations, len(ids), trainer.negative))
                doc = _infer_ns(doc, trainer.tables["syn1neg"].float(), put(ids),
                                put(negs), lrs, int(iterations))
        return doc.cpu().numpy()


class ParagraphVectorsBuilder:
    """Fluent builder mirroring reference ParagraphVectors.Builder."""

    def __init__(self):
        self._kw = {}

    def _set(self, k, v):
        self._kw[k] = v
        return self

    def iterate(self, it):
        from .sentence_iterator import CollectionSentenceIterator
        if isinstance(it, (list, tuple)):
            it = CollectionSentenceIterator(it)
        return self._set("iterate", it)

    def labels(self, labels: Sequence[str]):
        return self._set("labels", list(labels))

    def labels_source(self, src: LabelsSource):
        return self._set("labels_source", src)

    def tokenizer_factory(self, tf):
        return self._set("tokenizer_factory", tf)

    def layer_size(self, n):
        return self._set("layer_size", int(n))

    def window_size(self, n):
        return self._set("window_size", int(n))

    def min_word_frequency(self, n):
        return self._set("min_word_frequency", int(n))

    def negative_sample(self, n):
        return self._set("negative", int(n))

    def use_hierarchic_softmax(self, b=True):
        return self._set("use_hierarchic_softmax", bool(b))

    def sequence_learning_algorithm(self, name: str):
        """'dbow' (PV-DBOW) or 'dm' (PV-DM) — reference
        setSequenceLearningAlgorithm(DBOW/DM class names)."""
        return self._set("sequence_learning_algorithm",
                         name.rsplit(".", 1)[-1].lower())

    def train_word_vectors(self, b: bool):
        return self._set("train_word_vectors", bool(b))

    def learning_rate(self, lr):
        return self._set("learning_rate", float(lr))

    def min_learning_rate(self, lr):
        return self._set("min_learning_rate", float(lr))

    def epochs(self, n):
        return self._set("epochs", int(n))

    def iterations(self, n):
        return self._set("iterations", int(n))

    def batch_size(self, n):
        return self._set("batch_size", int(n))

    def seed(self, s):
        return self._set("seed", int(s))

    def device(self, device):
        """Where the tables live and train: None (the default) means CUDA;
        the CPU only when named."""
        return self._set("device", device)

    def build(self) -> ParagraphVectors:
        if "iterate" not in self._kw:
            raise ValueError("ParagraphVectors.builder(): call iterate(...)")
        return ParagraphVectors(**self._kw)
