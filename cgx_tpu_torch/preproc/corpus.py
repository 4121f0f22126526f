"""Corpus / query / alignment / lexical-table loading.

Reimplements the reference's host-side loaders with the same observable semantics:

* Source corpus (``Start.cu:240-380``): whitespace tokens interned in order of first
  appearance with ids starting at **2**; a sentence-separator token **1** appended after
  every sentence; after the last sentence an extra ``1`` and a unique sentinel token
  ``max_id + 1``; per-token in-sentence position ``P`` (uint8).
* Target corpus (``Start.cu:142-238``): same interning with its own vocabulary.
* Queries (``Start.cu:50-132``): tokens mapped through the *source* vocabulary,
  OOV -> ``-1``; flat token array plus per-query offsets; no separators appended.
* Alignment (``ExtractPair.cu:2639-2739``): "i-j" pairs split on spaces *and* dashes;
  per-source-token min/max aligned target position (``L/R``, 255 = unaligned) and the
  symmetric target-side arrays; packed source ``RLP`` word ``L<<24|R<<16|P<<8`` with
  sentence-separator slots holding the *target* sentence start offset.
* Lexical table (``ExtractPair.cu:2442-2526``): ``src tgt P(s|t) P(t|s)`` lines; words
  missing from the vocab are skipped unless they are ``NULL`` (id -1); probabilities are
  float32; the table is sorted by ``(src_id, tgt_id)`` for binary search.

Host code carried over from ``cgx_tpu/preproc/corpus.py``; the device copy of the
query tokens lives on the index (``TorchGrammarIndex.query_tokens``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

UNALIGNED = 255
SEPARATOR_ID = 1


@dataclasses.dataclass
class Vocab:
    """String <-> id interning; ids start at 2 (0 = DC3 pad, 1 = separator)."""

    word_to_id: dict
    id_to_word: list  # index by id; entries 0/1 are None

    def lookup(self, word: str) -> int:
        return self.word_to_id.get(word, -1)


def _tokenize(line: str) -> list:
    return line.split()


def _intern_corpus(lines):
    """Shared source/target corpus interning; returns (tokens, sentenceind, P, vocab).

    ``tokens`` includes a separator (1) after every sentence but *not* the trailing
    extra separator/sentinel; callers append those per side.
    """
    word_to_id: dict = {}
    id_to_word: list = [None, None]
    toks: list = []
    pos: list = []
    sentenceind = [0]
    for line in lines:
        local = 0
        for w in _tokenize(line):
            tid = word_to_id.get(w)
            if tid is None:
                tid = len(word_to_id) + 2
                word_to_id[w] = tid
                id_to_word.append(w)
            toks.append(tid)
            pos.append(local & 0xFF)  # uint8 wrap, matching the reference's uint8 P
            local += 1
        toks.append(SEPARATOR_ID)
        pos.append(0)
        sentenceind.append(len(toks))
    return toks, pos, sentenceind, Vocab(word_to_id, id_to_word)


@dataclasses.dataclass
class SourceCorpus:
    str_: np.ndarray          # int32 [toklen] token ids (with separators + sentinel)
    P: np.ndarray             # uint8 [toklen] in-sentence position
    sentenceind: np.ndarray   # int32 [n_sentences + 1]
    vocab: Vocab

    @property
    def toklen(self) -> int:
        return int(self.str_.shape[0])

    @property
    def sentence_count(self) -> int:
        return int(self.sentenceind.shape[0]) - 1


@dataclasses.dataclass
class TargetCorpus:
    str_: np.ndarray          # int32 [toklen]
    sentenceind: np.ndarray   # int32 [n_sentences + 1]
    vocab: Vocab

    @property
    def toklen(self) -> int:
        return int(self.str_.shape[0])


def load_source_corpus(lines) -> SourceCorpus:
    toks, pos, sentenceind, vocab = _intern_corpus(lines)
    last = len(vocab.word_to_id) + 2  # max assigned id + 1 (Start.cu:324-325)
    toks.append(SEPARATOR_ID)
    pos.append(0)
    toks.append(last)
    pos.append(0)
    return SourceCorpus(
        str_=np.asarray(toks, dtype=np.int32),
        P=np.asarray(pos, dtype=np.uint8),
        sentenceind=np.asarray(sentenceind, dtype=np.int32),
        vocab=vocab,
    )


def load_target_corpus(lines) -> TargetCorpus:
    toks, _pos, sentenceind, vocab = _intern_corpus(lines)
    last = len(vocab.word_to_id) + 2
    toks.append(SEPARATOR_ID)
    toks.append(last)
    return TargetCorpus(
        str_=np.asarray(toks, dtype=np.int32),
        sentenceind=np.asarray(sentenceind, dtype=np.int32),
        vocab=vocab,
    )


@dataclasses.dataclass
class QuerySet:
    offsets: np.ndarray        # int32 [qryscount] start offset of each query's tokens
    tokens: np.ndarray         # int32 [totaltokens] source-vocab ids, OOV = -1
    tok_to_qry: np.ndarray     # int32 [totaltokens] token index -> query index

    @property
    def qryscount(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def totaltokens(self) -> int:
        return int(self.tokens.shape[0])

    def query_end(self, q: int) -> int:
        """First token index past query q (Start.cu pattern used throughout kernels)."""
        if q == self.qryscount - 1:
            return self.totaltokens
        return int(self.offsets[q + 1])

    def padded_tokens(self) -> np.ndarray:
        """Host query tokens padded for +2 lookahead indexing.  Cached on the
        instance (not an id()-keyed engine dict) so the cache's lifetime is
        the query set's — no address-reuse aliasing in long-lived servers."""
        pt = self.__dict__.get("_padded_tokens")
        if pt is None:
            from cgx_tpu_torch.search.passes import pad_query_tokens
            pt = self.__dict__["_padded_tokens"] = pad_query_tokens(self.tokens)
        return pt


def load_queries(lines, vocab: Vocab) -> QuerySet:
    offsets: list = []
    toks: list = []
    tok_to_qry: list = []
    for q, line in enumerate(lines):
        offsets.append(len(toks))
        for w in _tokenize(line):
            toks.append(vocab.lookup(w))
            tok_to_qry.append(q)
    return QuerySet(
        offsets=np.asarray(offsets, dtype=np.int32),
        tokens=np.asarray(toks, dtype=np.int32),
        tok_to_qry=np.asarray(tok_to_qry, dtype=np.int32),
    )


@dataclasses.dataclass
class Alignment:
    L_tar: np.ndarray   # uint8 [target toklen] min aligned source pos (255 unaligned)
    R_tar: np.ndarray   # uint8 [target toklen] max aligned source pos
    RLP: np.ndarray     # uint32 [source toklen]


def load_alignment(lines, source: SourceCorpus, target: TargetCorpus) -> Alignment:
    n_src = source.toklen
    n_tar = target.toklen
    L_src = np.full(n_src, UNALIGNED, dtype=np.int32)
    R_src = np.full(n_src, UNALIGNED, dtype=np.int32)
    L_tar = np.full(n_tar, UNALIGNED, dtype=np.uint8)
    R_tar = np.full(n_tar, UNALIGNED, dtype=np.uint8)

    for q, line in enumerate(lines):
        # strtok(line, " -") == split on spaces and dashes -> flat int list.
        nums = [int(t) for t in line.replace("-", " ").split()]
        if len(nums) % 2 != 0:
            raise ValueError(f"alignment line {q}: odd token count")
        src_base = int(source.sentenceind[q])
        tar_base = int(target.sentenceind[q])
        for s_no, t_no in zip(nums[0::2], nums[1::2]):
            if s_no >= 255 or t_no >= 255 or s_no < 0 or t_no < 0:
                raise ValueError(f"alignment line {q}: sentence too long ({s_no}-{t_no})")
            si = src_base + s_no
            if L_src[si] == UNALIGNED or R_src[si] == UNALIGNED:
                L_src[si] = t_no
                R_src[si] = t_no
            elif t_no > R_src[si]:
                R_src[si] = t_no
            elif t_no < L_src[si]:
                L_src[si] = t_no
            ti = tar_base + t_no
            if L_tar[ti] == UNALIGNED or R_tar[ti] == UNALIGNED:
                L_tar[ti] = s_no
                R_tar[ti] = s_no
            elif s_no > R_tar[ti]:
                R_tar[ti] = s_no
            elif s_no < L_tar[ti]:
                L_tar[ti] = s_no

    # RLP packing (ExtractPair.cu:2717-2731): vectorized; separator slots (the token
    # *before* each sentence start) carry the target sentence start offset instead.
    RLP = (
        (L_src.astype(np.uint32) << 24)
        | (R_src.astype(np.uint32) << 16)
        | (source.P.astype(np.uint32) << 8)
    )
    sep_slots = source.sentenceind[1:] - 1          # end-separator of each sentence
    RLP[sep_slots] = target.sentenceind[1:].astype(np.uint32)
    return Alignment(L_tar=L_tar, R_tar=R_tar, RLP=RLP)


@dataclasses.dataclass
class LexTable:
    """Sorted (src_id, tgt_id) -> (P(s|t)=val1, P(t|s)=val2) table, float32."""

    keys_src: np.ndarray   # int32 [n]
    keys_tgt: np.ndarray   # int32 [n]
    val1: np.ndarray       # float32 [n]
    val2: np.ndarray       # float32 [n]


def load_lex_table(text_tokens, source_vocab: Vocab, target_vocab: Vocab) -> LexTable:
    """``text_tokens``: the whitespace-token stream of the lex file."""
    srcs: list = []
    tgts: list = []
    v1: list = []
    v2: list = []
    it = iter(text_tokens)
    while True:
        try:
            cw = next(it)
        except StopIteration:
            break
        try:
            ew = next(it)
            a = next(it)
            b = next(it)
        except StopIteration:
            break  # trailing partial record: the reference's file.good() loop drops it
        cid = source_vocab.lookup(cw)
        if cid == -1 and cw != "NULL":
            continue
        eid = target_vocab.lookup(ew)
        if eid == -1 and ew != "NULL":
            continue
        srcs.append(cid)
        tgts.append(eid)
        v1.append(np.float32(a))
        v2.append(np.float32(b))
    keys_src = np.asarray(srcs, dtype=np.int32)
    keys_tgt = np.asarray(tgts, dtype=np.int32)
    order = np.lexsort((keys_tgt, keys_src))  # stable sort by (src, tgt)
    return LexTable(
        keys_src=keys_src[order],
        keys_tgt=keys_tgt[order],
        val1=np.asarray(v1, dtype=np.float32)[order],
        val2=np.asarray(v2, dtype=np.float32)[order],
    )


def read_lines(path: str) -> list:
    with open(path, "r", encoding="utf-8") as fh:
        return fh.read().splitlines()


def read_tokens(path: str) -> list:
    with open(path, "r", encoding="utf-8") as fh:
        return fh.read().split()


# ---------------------------------------------------------------------------
# Native-tokenizer fast path (C++ interning; identical results to the Python
# loaders above, test-enforced).  Operates on raw corpus text.
# ---------------------------------------------------------------------------

def _native_tokenize(text: str):
    """Returns (ids, line_counts, vocab) via the C++ interner, or None."""
    import ctypes

    from cgx_tpu_torch.preproc import native_build

    lib = native_build.load_native()
    if lib is None:
        return None
    data = text.encode("utf-8")
    n = len(data)
    if n == 0:
        return np.empty(0, np.int32), np.empty(0, np.int32), Vocab({}, [None, None])
    cap = n // 2 + 2  # max tokens/lines/words bounded by bytes/2 + 1
    ids = np.empty(cap, dtype=np.int32)
    linetok = np.empty(cap, dtype=np.int32)
    word_off = np.empty(cap, dtype=np.int64)
    word_len = np.empty(cap, dtype=np.int32)
    n_lines = ctypes.c_long()
    n_words = ctypes.c_long()
    ntok = lib.cgx_tokenize(
        data, n,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        linetok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        word_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        word_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(n_lines), ctypes.byref(n_words))
    nl, nw = n_lines.value, n_words.value
    id_to_word = [None, None] + [
        data[word_off[i]:word_off[i] + word_len[i]].decode("utf-8")
        for i in range(nw)]
    vocab = Vocab(word_to_id={w: i + 2 for i, w in enumerate(id_to_word[2:])},
                  id_to_word=id_to_word)
    return ids[:ntok], linetok[:nl], vocab


def _with_separators(ids: np.ndarray, linetok: np.ndarray):
    """Interleave the separator token after every line; returns
    (str_, P, sentenceind) pre-sentinel."""
    nl = len(linetok)
    total = len(ids) + nl
    out = np.ones(total, dtype=np.int32)
    ends = np.cumsum(linetok.astype(np.int64) + 1)          # post-separator ends
    sentenceind = np.concatenate([[0], ends]).astype(np.int32)
    tok_line = np.repeat(np.arange(nl), linetok)
    tok_pos = np.arange(len(ids), dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(linetok.astype(np.int64))])[:-1], linetok)
    out_idx = tok_pos + (ends - linetok - 1)[tok_line]
    out[out_idx] = ids
    P = np.zeros(total, dtype=np.uint8)
    P[out_idx] = (tok_pos & 0xFF).astype(np.uint8)
    return out, P, sentenceind


def load_source_corpus_text(text: str) -> SourceCorpus:
    nat = _native_tokenize(text)
    if nat is None:
        return load_source_corpus(text.splitlines())
    ids, linetok, vocab = nat
    str_, P, sentenceind = _with_separators(ids, linetok)
    last = len(vocab.word_to_id) + 2
    str_ = np.concatenate([str_, np.asarray([SEPARATOR_ID, last], np.int32)])
    P = np.concatenate([P, np.zeros(2, np.uint8)])
    return SourceCorpus(str_=str_, P=P, sentenceind=sentenceind, vocab=vocab)


def load_target_corpus_text(text: str) -> TargetCorpus:
    nat = _native_tokenize(text)
    if nat is None:
        return load_target_corpus(text.splitlines())
    ids, linetok, vocab = nat
    str_, _P, sentenceind = _with_separators(ids, linetok)
    last = len(vocab.word_to_id) + 2
    str_ = np.concatenate([str_, np.asarray([SEPARATOR_ID, last], np.int32)])
    return TargetCorpus(str_=str_, sentenceind=sentenceind, vocab=vocab)


def load_alignment_fast(lines, source: SourceCorpus,
                        target: TargetCorpus) -> Alignment:
    """Vectorized alignment loader (scatter min/max via ufunc.at)."""
    srcs, tars = [], []
    for q, line in enumerate(lines):
        nums = np.fromstring(line.replace("-", " "), dtype=np.int64, sep=" ") \
            if line.strip() else np.empty(0, np.int64)
        if len(nums) % 2:
            raise ValueError(f"alignment line {q}: odd token count")
        nums = nums.reshape(-1, 2)
        srcs.append(nums[:, 0] + int(source.sentenceind[q]))
        tars.append((nums[:, 0] * 0 + nums[:, 1],
                     nums[:, 1] + int(target.sentenceind[q]),
                     nums[:, 0]))
    si = np.concatenate(srcs) if srcs else np.empty(0, np.int64)
    t_no = np.concatenate([t[0] for t in tars]) if tars else si
    ti = np.concatenate([t[1] for t in tars]) if tars else si
    s_no = np.concatenate([t[2] for t in tars]) if tars else si
    if len(si) and (int(s_no.max(initial=0)) >= 255
                    or int(t_no.max(initial=0)) >= 255
                    or int(min(s_no.min(initial=0), t_no.min(initial=0))) < 0):
        raise ValueError("alignment: sentence too long")

    n_src, n_tar = source.toklen, target.toklen
    L_src = np.full(n_src, 256, dtype=np.int32)
    R_src = np.full(n_src, -1, dtype=np.int32)
    np.minimum.at(L_src, si, t_no)
    np.maximum.at(R_src, si, t_no)
    L_src = np.where(L_src == 256, UNALIGNED, L_src)
    R_src = np.where(R_src == -1, UNALIGNED, R_src)
    L_tar = np.full(n_tar, 256, dtype=np.int32)
    R_tar = np.full(n_tar, -1, dtype=np.int32)
    np.minimum.at(L_tar, ti, s_no)
    np.maximum.at(R_tar, ti, s_no)
    L_tar = np.where(L_tar == 256, UNALIGNED, L_tar).astype(np.uint8)
    R_tar = np.where(R_tar == -1, UNALIGNED, R_tar).astype(np.uint8)

    RLP = ((L_src.astype(np.uint32) << 24)
           | (R_src.astype(np.uint32) << 16)
           | (source.P.astype(np.uint32) << 8))
    sep_slots = source.sentenceind[1:] - 1
    RLP[sep_slots] = target.sentenceind[1:].astype(np.uint32)
    return Alignment(L_tar=L_tar, R_tar=R_tar, RLP=RLP)
