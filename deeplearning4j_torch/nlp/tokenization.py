"""Tokenization pipeline.

Port of `deeplearning4j_tpu/nlp/tokenization.py`, unchanged: host code.

Reference parity: deeplearning4j-nlp text/tokenization/ —
TokenizerFactory SPI (DefaultTokenizerFactory, NGramTokenizerFactory),
Tokenizer with TokenPreProcess (CommonPreprocessor: lowercase + strip
punctuation, EndingPreProcessor), and text/stopwords/StopWords."""
from __future__ import annotations

import re
from typing import List, Optional

# Subset of the reference's stopwords list (text/stopwords; the reference
# ships a file — a compact built-in default serves the same role). One
# owner for the whole package; nlp.ENGLISH_STOP_WORDS aliases this.
STOP_WORDS = frozenset("""a an and are as at be but by for from has have he
her his i if in into is it its me my no not of on or our she so such that
the their them then there these they this to was we were what when which
who will with you your""".split())


class TokenPreProcess:
    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits (reference
    tokenizer/preprocessor/CommonPreprocessor)."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token):
        return self._PUNCT.sub("", token.lower())


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token):
        return token.lower()


class EndingPreProcessor(TokenPreProcess):
    """Crude stemmer (reference EndingPreProcessor: strips s/ed/ing/ly)."""

    def pre_process(self, token):
        for suffix in ("ing", "ed", "ly", "s"):
            if token.endswith(suffix) and len(token) > len(suffix) + 2:
                return token[: -len(suffix)]
        return token


class Tokenizer:
    def __init__(self, tokens: List[str],
                 pre_processor: Optional[TokenPreProcess] = None):
        self._tokens = tokens
        self._pre = pre_processor

    def get_tokens(self) -> List[str]:
        if self._pre is None:
            return list(self._tokens)
        out = []
        for t in self._tokens:
            t = self._pre.pre_process(t)
            if t:
                out.append(t)
        return out


class TokenizerFactory:
    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self._pre = pre
        return self


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace tokenizer (reference DefaultTokenizerFactory wraps a
    StringTokenizer)."""

    def __init__(self):
        self._pre: Optional[TokenPreProcess] = None

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(text.split(), self._pre)


class NGramTokenizerFactory(TokenizerFactory):
    """N-gram tokens over the base tokenizer (reference
    NGramTokenizerFactory)."""

    def __init__(self, base: TokenizerFactory, min_n: int, max_n: int):
        self._base = base
        self.min_n, self.max_n = int(min_n), int(max_n)
        self._pre = None

    def create(self, text):
        toks = self._base.create(text).get_tokens()
        out = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(toks) - n + 1):
                out.append(" ".join(toks[i:i + n]))
        return Tokenizer(out, self._pre)


class CharacterTokenizerFactory(TokenizerFactory):
    """Character-level tokenizer — the offline stand-in for the
    reference's CJK submodules (deeplearning4j-nlp-japanese/-korean
    vendor Kuromoji/KoreanTokenizer; character tokenization is the
    standard dependency-free baseline for unsegmented scripts)."""

    def __init__(self, keep_whitespace: bool = False):
        self._pre: Optional[TokenPreProcess] = None
        self.keep_whitespace = keep_whitespace

    def create(self, text: str) -> Tokenizer:
        chars = list(text) if self.keep_whitespace else \
            [c for c in text if not c.isspace()]
        return Tokenizer(chars, self._pre)


class RegexTokenizerFactory(TokenizerFactory):
    """Tokens = regex matches (reference nlp's PosUimaTokenizer niche of
    pattern-driven tokenization, without UIMA)."""

    def __init__(self, pattern: str = r"\w+"):
        self._re = re.compile(pattern)
        self._pre: Optional[TokenPreProcess] = None

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(self._re.findall(text), self._pre)
