"""The reference's corpus index, built from the generator's arrays with plain
numpy: the interned corpus, the alignment words, the lexical table, the
suffix array with its LCP array and interval LCP tree, and the
frequent-pair precomputation.  It shares no code and no data with the
program: the program reads the rendered text, the reference the arrays.

Built once per corpus and kept in the benchmark's cache (``save``/``load``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from perfbench.reference.config import ExtractorConfig
from perfbench.reference.corpus import (SEPARATOR_ID, UNALIGNED, Alignment,
                                        LexTable, SAIndex, SourceCorpus,
                                        TargetCorpus, Vocab)
from perfbench.reference.search import check_boundary_gap_many
from perfbench.reference.types import Precomp


@dataclasses.dataclass
class RefIndex:
    source: SourceCorpus
    target: TargetCorpus
    align: Alignment
    lex: LexTable
    sa: SAIndex
    pc: Precomp


def _intern(ids: np.ndarray, lens: np.ndarray, prefix: str):
    """Ids in order of first appearance from 2, a separator after each
    sentence, then a separator and the sentinel (max id + 1).  Returns
    (str_, in-sentence positions, sentenceind, vocab, old id of each new)."""
    uniq, first = np.unique(ids, return_index=True)
    words = uniq[np.argsort(first, kind="stable")]
    new = np.zeros(int(uniq[-1]) + 1, np.int32)
    new[words] = 2 + np.arange(len(words), dtype=np.int32)
    n = len(lens)
    sentenceind = np.concatenate(
        [[0], np.cumsum(lens.astype(np.int64) + 1)]).astype(np.int32)
    str_ = np.full(int(sentenceind[-1]) + 2, SEPARATOR_ID, np.int32)
    tok_at = (np.arange(len(ids), dtype=np.int64)
              + np.repeat(np.arange(n, dtype=np.int64), lens))
    str_[tok_at] = new[ids]
    str_[-1] = len(words) + 2
    pos = np.zeros(len(str_), np.int64)
    pos[tok_at] = tok_at - np.repeat(sentenceind[:-1].astype(np.int64), lens)
    id_to_word = [None, None] + [f"{prefix}{w}" for w in words.tolist()]
    vocab = Vocab({w: i for i, w in enumerate(id_to_word) if i >= 2},
                  id_to_word)
    return str_, pos, sentenceind, vocab, new


def _alignment(c, src: SourceCorpus, tgt: TargetCorpus, P) -> Alignment:
    sent = np.repeat(np.arange(len(c.link_len), dtype=np.int64), c.link_len)
    si = src.sentenceind[:-1].astype(np.int64)[sent] + c.link_s
    ti = tgt.sentenceind[:-1].astype(np.int64)[sent] + c.link_t
    L_src = np.full(src.toklen, 1 << 30, np.int64)
    R_src = np.full(src.toklen, -1, np.int64)
    np.minimum.at(L_src, si, c.link_t.astype(np.int64))
    np.maximum.at(R_src, si, c.link_t.astype(np.int64))
    un = R_src < 0
    L_src[un] = UNALIGNED
    R_src[un] = UNALIGNED
    L_tar = np.full(tgt.toklen, 1 << 30, np.int64)
    R_tar = np.full(tgt.toklen, -1, np.int64)
    np.minimum.at(L_tar, ti, c.link_s.astype(np.int64))
    np.maximum.at(R_tar, ti, c.link_s.astype(np.int64))
    un = R_tar < 0
    L_tar[un] = UNALIGNED
    R_tar[un] = UNALIGNED
    RLP = ((L_src.astype(np.uint32) << 24) | (R_src.astype(np.uint32) << 16)
           | ((P & 0xFF).astype(np.uint32) << 8))
    RLP[src.sentenceind[1:] - 1] = tgt.sentenceind[1:].astype(np.uint32)
    return Alignment(L_tar=L_tar.astype(np.uint8), R_tar=R_tar.astype(np.uint8),
                     RLP=RLP)


def _lex(c, new_src, new_tgt) -> LexTable:
    ks = np.where(c.lex_src < 0, -1, new_src[np.maximum(c.lex_src, 0)])
    kt = np.where(c.lex_tgt < 0, -1, new_tgt[np.maximum(c.lex_tgt, 0)])
    # the values as the lexical file prints them, read back in float32
    v1 = np.array([np.float32(f"{p:.7f}") for p in c.lex_p1.tolist()],
                  np.float32)
    v2 = np.array([np.float32(f"{p:.7f}") for p in c.lex_p2.tolist()],
                  np.float32)
    order = np.lexsort((kt, ks))
    return LexTable(keys_src=ks[order].astype(np.int32),
                    keys_tgt=kt[order].astype(np.int32),
                    val1=v1[order], val2=v2[order])


def suffix_array(s: np.ndarray):
    """Prefix doubling.  Returns (SA, the rank arrays of the prefixes of
    length 1, 2, 4, ...): equal ranks at level k mean equal k-prefixes.
    The sentinel at the end is unique, so all suffixes differ."""
    n = len(s)
    rank = s.astype(np.int64)
    levels = [rank.astype(np.int32)]
    k = 1
    while True:
        key = rank * (n + 2)
        key[:n - k] += rank[k:] + 1
        order = np.argsort(key, kind="stable")
        ks = key[order]
        new = np.empty(n, np.int64)
        new[order] = np.cumsum(np.concatenate([[0], ks[1:] != ks[:-1]]))
        rank = new
        levels.append(rank.astype(np.int32))
        k *= 2
        if int(rank.max()) == n - 1:
            return order.astype(np.int32), levels


def lcp_array(sa: np.ndarray, levels: list) -> np.ndarray:
    """lcp[r] = LCP(suffix sa[r-1], suffix sa[r]); lcp[0] = 0, by binary
    lifting over the doubling ranks."""
    n = len(sa)
    a = sa[:-1].astype(np.int64)
    b = sa[1:].astype(np.int64)
    h = np.zeros(n - 1, np.int64)
    for lv in range(len(levels) - 2, -1, -1):
        k = 1 << lv
        r = levels[lv]
        ia, ib = a + h, b + h
        ok = (ia < n) & (ib < n)
        eq = np.zeros(n - 1, bool)
        eq[ok] = r[ia[ok]] == r[ib[ok]]
        h += np.where(eq, k, 0)
    return np.concatenate([[0], h]).astype(np.int32)


def interval_tree(lcp: np.ndarray):
    """The midpoint tree of the reference's binary search
    (SuffixArray.c:131-179): for each interval (L, R) of the recursion from
    (0, n-1), M = (L+R)//2, lcpleft[M] = min lcp over (L, M] and
    lcpright[M] = min lcp over (M, R]."""
    n = len(lcp)
    left = np.zeros(n, np.int32)
    right = np.zeros(n, np.int32)
    if n < 2:
        return left, right
    levels = []
    L = np.array([0], np.int64)
    R = np.array([n - 1], np.int64)
    while len(L):
        levels.append((L, R))
        inner = R - L > 1
        Li, Ri = L[inner], R[inner]
        Mi = (Li + Ri) // 2
        L = np.stack([Li, Mi], 1).ravel()
        R = np.stack([Mi, Ri], 1).ravel()
    child = None
    for L, R in reversed(levels):
        inner = R - L > 1
        val = np.empty(len(L), np.int32)
        val[~inner] = lcp[R[~inner]]
        if inner.any():
            cv = child.reshape(-1, 2)
            M = (L[inner] + R[inner]) // 2
            left[M] = cv[:, 0]
            right[M] = cv[:, 1]
            val[inner] = np.minimum(cv[:, 0], cv[:, 1])
        child = val
    return left, right


def precompute(source: SourceCorpus, sa: np.ndarray, align: Alignment,
               cfg: ExtractorConfig) -> Precomp:
    """The frequent-pair table (SuffixArray.cu:1132-1340, GappyLook.cu:
    740-869): for the ``precompute_count`` most frequent tokens, every
    occurrence of a pair (a, b) with 1 + min_gap <= gap end - a < span and
    no separator between them; rows whose gap passes checkBoundaryGap, the
    others counted as ``feature_missing``.  The scan from either end finds
    the same pairs when the minimum gap is one token."""
    if cfg.min_gap_size != 1:
        raise ValueError("the reference precomputes for min_gap_size 1")
    s = source.str_
    n = len(s)
    first = s[sa]
    valid = first >= 2
    toks, starts, counts = np.unique(first[valid], return_index=True,
                                     return_counts=True)
    starts = starts + int(np.argmax(valid))
    P = min(cfg.precompute_count, len(toks))
    top = np.argsort(-counts, kind="stable")[:P]
    top = np.sort(top)                 # ascending token id
    frequent = toks[top].astype(np.int32)
    slot = np.full(int(s.max()) + 1, -1, np.int64)
    slot[frequent] = np.arange(P)
    sl = slot[s]
    sep = np.concatenate([[0], np.cumsum(s < 2)])
    cells, a_pos, lens, ok = [], [], [], []
    for d in range(1 + cfg.min_gap_size, cfg.max_rule_span):
        i = np.flatnonzero((sl[:n - d] >= 0) & (sl[d:] >= 0))
        i = i[sep[i + d] - sep[i + 1] == 0]
        cells.append(sl[i] * P + sl[i + d])
        a_pos.append(i)
        lens.append(np.full(len(i), d, np.int64))
    cells = np.concatenate(cells)
    a_pos = np.concatenate(a_pos)
    lens = np.concatenate(lens)
    good = check_boundary_gap_many(a_pos + 1, a_pos + lens - 1, align.L_tar,
                                   align.R_tar, align.RLP, cfg.max_rule_span)
    missing = np.bincount(cells[~good], minlength=P * P).astype(np.int32)
    cells, a_pos, lens = cells[good], a_pos[good], lens[good]
    order = np.lexsort((lens, a_pos, cells))
    cells, a_pos, lens = cells[order], a_pos[order], lens[order]
    index_start = np.ones(P * P, np.int32)
    index_end = np.zeros(P * P, np.int32)
    if len(cells):
        uniq, fi, cnt = np.unique(cells, return_index=True,
                                  return_counts=True)
        index_start[uniq] = fi
        index_end[uniq] = fi + cnt - 1
    return Precomp(frequent_list=frequent,
                   tok_start=starts[top].astype(np.int32),
                   tok_len=counts[top].astype(np.int32),
                   index_start=index_start, index_end=index_end,
                   onegap_start=a_pos.astype(np.int32),
                   onegap_length=lens.astype(np.int32),
                   feature_missing=missing, count=int(len(cells)))


def build(c, cfg: ExtractorConfig) -> RefIndex:
    """The index of generator corpus ``c`` (``perfbench.gen.corpus.Corpus``)."""
    s_str, s_pos, s_ind, s_vocab, s_new = _intern(c.src, c.src_len, "f")
    t_str, _, t_ind, t_vocab, t_new = _intern(c.tgt, c.tgt_len, "e")
    source = SourceCorpus(str_=s_str, P=(s_pos & 0xFF).astype(np.uint8),
                          sentenceind=s_ind, vocab=s_vocab)
    target = TargetCorpus(str_=t_str, sentenceind=t_ind, vocab=t_vocab)
    align = _alignment(c, source, target, s_pos)
    lex = _lex(c, s_new, t_new)
    sa, levels = suffix_array(s_str)
    lcp = lcp_array(sa, levels)
    del levels
    left, right = interval_tree(lcp)
    sai = SAIndex(sa=sa, lcp=lcp, lcpleft=left, lcpright=right)
    pc = precompute(source, sa, align, cfg)
    return RefIndex(source, target, align, lex, sai, pc)


_PC = ("frequent_list", "tok_start", "tok_len", "index_start", "index_end",
       "onegap_start", "onegap_length", "feature_missing")


def save(path: str, ix: RefIndex) -> None:
    """Arrays to ``path`` (an ``.npz``), written under a temporary name and
    renamed, so a half-written file is never loaded."""
    arrays = dict(
        s_str=ix.source.str_, s_P=ix.source.P, s_ind=ix.source.sentenceind,
        t_str=ix.target.str_, t_ind=ix.target.sentenceind,
        l_tar=ix.align.L_tar, r_tar=ix.align.R_tar, rlp=ix.align.RLP,
        lex_s=ix.lex.keys_src, lex_t=ix.lex.keys_tgt, lex_v1=ix.lex.val1,
        lex_v2=ix.lex.val2, sa=ix.sa.sa, lcp=ix.sa.lcp,
        lcpleft=ix.sa.lcpleft, lcpright=ix.sa.lcpright,
        s_words=np.array([int(w[1:]) for w in ix.source.vocab.id_to_word[2:]],
                         np.int64),
        t_words=np.array([int(w[1:]) for w in ix.target.vocab.id_to_word[2:]],
                         np.int64),
        **{f"pc_{k}": getattr(ix.pc, k) for k in _PC})
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _vocab(prefix: str, words: np.ndarray) -> Vocab:
    id_to_word = [None, None] + [f"{prefix}{w}" for w in words.tolist()]
    return Vocab({w: i for i, w in enumerate(id_to_word) if i >= 2},
                 id_to_word)


def load(path: str) -> RefIndex:
    with np.load(path) as z:
        a = {k: z[k] for k in z.files}
    pc = Precomp(**{k: a[f"pc_{k}"] for k in _PC},
                 count=int(len(a["pc_onegap_start"])))
    return RefIndex(
        source=SourceCorpus(str_=a["s_str"], P=a["s_P"], sentenceind=a["s_ind"],
                            vocab=_vocab("f", a["s_words"])),
        target=TargetCorpus(str_=a["t_str"], sentenceind=a["t_ind"],
                            vocab=_vocab("e", a["t_words"])),
        align=Alignment(L_tar=a["l_tar"], R_tar=a["r_tar"], RLP=a["rlp"]),
        lex=LexTable(keys_src=a["lex_s"], keys_tgt=a["lex_t"],
                     val1=a["lex_v1"], val2=a["lex_v2"]),
        sa=SAIndex(sa=a["sa"], lcp=a["lcp"], lcpleft=a["lcpleft"],
                   lcpright=a["lcpright"]),
        pc=pc)
