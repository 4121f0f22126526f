"""The reference's data structures: the corpus, queries, alignment, lexical
table and suffix-array index, as the sequential specification reads them
(the cdec loaders' semantics: ids interned in order of first appearance from
2, separator 1 after every sentence, then a 1 and a unique sentinel; query
words outside the source vocabulary are -1)."""

from __future__ import annotations

import dataclasses

import numpy as np

UNALIGNED = 255
SEPARATOR_ID = 1


@dataclasses.dataclass
class Vocab:
    word_to_id: dict
    id_to_word: list  # index by id; entries 0/1 are None

    def lookup(self, word: str) -> int:
        return self.word_to_id.get(word, -1)


@dataclasses.dataclass
class SourceCorpus:
    str_: np.ndarray          # int32 [toklen] token ids (with separators + sentinel)
    P: np.ndarray             # uint8 [toklen] in-sentence position
    sentenceind: np.ndarray   # int32 [n_sentences + 1]
    vocab: Vocab

    @property
    def toklen(self) -> int:
        return int(self.str_.shape[0])


@dataclasses.dataclass
class TargetCorpus:
    str_: np.ndarray          # int32 [toklen]
    sentenceind: np.ndarray   # int32 [n_sentences + 1]
    vocab: Vocab

    @property
    def toklen(self) -> int:
        return int(self.str_.shape[0])


@dataclasses.dataclass
class QuerySet:
    offsets: np.ndarray        # int32 [qryscount]
    tokens: np.ndarray         # int32 [totaltokens] source ids, OOV = -1
    tok_to_qry: np.ndarray     # int32 [totaltokens]

    @property
    def qryscount(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def totaltokens(self) -> int:
        return int(self.tokens.shape[0])

    def query_end(self, q: int) -> int:
        if q == self.qryscount - 1:
            return self.totaltokens
        return int(self.offsets[q + 1])


def load_queries(sentences, vocab: Vocab) -> QuerySet:
    """``sentences``: lists of words."""
    offsets, toks, tok_to_qry = [], [], []
    for q, words in enumerate(sentences):
        offsets.append(len(toks))
        for w in words:
            toks.append(vocab.lookup(w))
            tok_to_qry.append(q)
    return QuerySet(offsets=np.asarray(offsets, dtype=np.int32),
                    tokens=np.asarray(toks, dtype=np.int32),
                    tok_to_qry=np.asarray(tok_to_qry, dtype=np.int32))


@dataclasses.dataclass
class Alignment:
    L_tar: np.ndarray   # uint8 [target toklen] min aligned source pos (255 unaligned)
    R_tar: np.ndarray   # uint8 [target toklen] max aligned source pos
    RLP: np.ndarray     # uint32 [source toklen] L<<24 | R<<16 | P<<8; separators: target sentence start


@dataclasses.dataclass
class LexTable:
    keys_src: np.ndarray   # int32 [n]
    keys_tgt: np.ndarray   # int32 [n]
    val1: np.ndarray       # float32 [n] P(s|t)
    val2: np.ndarray       # float32 [n] P(t|s)


@dataclasses.dataclass
class SAIndex:
    sa: np.ndarray        # int32 [n]
    lcp: np.ndarray       # int32 [n]   lcp[i] = LCP(SA[i-1], SA[i]); lcp[0] = 0
    lcpleft: np.ndarray   # int32 [n]
    lcpright: np.ndarray  # int32 [n]
