"""Gap pattern enumeration and the distinct-pattern scans (host).

Copy of ``cgx_tpu/search/enumerate_fast.py``: NumPy reformulations of
oneGapEnumeration / twoGapEnumeration (SuffixArray.cu:928-1039, 816-926) and
the host distinct scans (SuffixArray.cu:1667-1719, 2056-2097), in the
canonical order (token asc, start-len asc, gap position asc, end-len asc).  The grids are small by
construction: start-len <= max_rule_symbols - 2 and spans <= max_rule_span,
so each query token contributes at most 3 x 16 x 3 candidates.
"""

from __future__ import annotations

import numpy as np

from cgx_tpu_torch.config import ExtractorConfig
from cgx_tpu_torch.preproc.corpus import QuerySet
from cgx_tpu_torch.types import (OneGapEnum, OneGapSearch, Pass1Result,
                                 TwoGapEnum, TwoGapSearch)

SIMAX = 3   # max a-length: si + 1 + ei <= MAX_rule_symbols with ei >= 1
EIMAX = 3
OFFW = 16   # gap-position offset width (span <= MAX_rule_span)


def fast_one_gap_enumeration(queries: QuerySet, p1: Pass1Result,
                             cfg: ExtractorConfig) -> OneGapEnum:
    ntok = queries.totaltokens
    S = cfg.max_rule_symbols
    toks = np.asarray(queries.tokens, dtype=np.int64)
    lm = np.asarray(p1.longestmatch, dtype=np.int64)
    qid = np.asarray(queries.tok_to_qry, dtype=np.int64)
    qend = np.asarray([queries.query_end(int(q)) for q in qid], dtype=np.int64)

    # grid axes in canonical order: (tok, si, st_offset, ei)
    tok = np.arange(ntok, dtype=np.int64)
    si = np.arange(1, SIMAX + 1, dtype=np.int64)
    off = np.arange(OFFW, dtype=np.int64)  # st = tok + si + mgs + off
    ei = np.arange(1, EIMAX + 1, dtype=np.int64)
    T, I, O, E = ntok, SIMAX, OFFW, EIMAX
    tok4 = tok[:, None, None, None]
    si4 = si[None, :, None, None]
    off4 = off[None, None, :, None]
    ei4 = ei[None, None, None, :]
    st4 = tok4 + si4 + cfg.min_gap_size + off4
    st4c = np.clip(st4, 0, ntok - 1)
    ok = (tok4 < ntok - 1)
    ok = ok & (tok4 != qend[:, None, None, None] - 1)
    ok = ok & (tok4 != qend[:, None, None, None] - 2)
    ok = ok & (si4 <= lm[:, None, None, None])
    ok = ok & (st4 < qend[:, None, None, None])
    ok = ok & (st4 - tok4 <= cfg.max_rule_span_pattern)
    ok = ok & (toks[st4c] != -1)
    ok = ok & (si4 + 1 + ei4 <= S)
    ok = ok & (ei4 <= lm[st4c])
    ok = ok & (st4 - tok4 + ei4 - 1 <= cfg.max_rule_span_pattern)

    idx = np.nonzero(ok.reshape(T, I, O, E))
    ti, sii, oi, eii = idx
    qs = ti
    qsl = sii + 1
    eil = eii + 1
    st = ti + qsl + cfg.min_gap_size + oi
    gap = st - ti - qsl
    n = len(ti)
    pat = np.full((n, S), -2, dtype=np.int32)
    for i in range(S):
        in_a = i < qsl
        is_gap = i == qsl
        in_b = (i > qsl) & (i < qsl + 1 + eil)
        src = np.where(in_a, ti + i, np.where(in_b, st + i - 1 - qsl, 0))
        val = np.where(in_a | in_b, toks[np.clip(src, 0, ntok - 1)], -1)
        val = np.where(is_gap, -1, np.where(in_a | in_b, val, -2))
        pat[:, i] = val
    return OneGapEnum(
        qrystart=qs.astype(np.int32), qrystart_len=qsl.astype(np.int32),
        qryend_len=eil.astype(np.int32), gap=gap.astype(np.int32),
        pattern=pat, number=(qsl + 1 + eil).astype(np.int32))


def _empty_search(queries: QuerySet) -> OneGapSearch:
    """The distinct-pattern table of an empty enumeration (what the
    sequential ``sort_and_dedup_onegap`` returns for it)."""
    def z():
        return np.empty(0, dtype=np.int32)
    return OneGapSearch(qrystart=z(), qrystart_len=z(), qryend_len=z(),
                        gap=z(), position=z(), start_on_salist=z(),
                        end_on_salist=z(),
                        query_with_id=[[] for _ in range(queries.qryscount)])


def fast_sort_and_dedup_onegap(enum: OneGapEnum, queries: QuerySet) -> tuple:
    """Stable sort by (number, pattern) and the distinct scan -> (sorted
    OneGapEnum, OneGapSearch)."""
    n = len(enum.qrystart)
    if n == 0:
        return enum, _empty_search(queries)
    keys = tuple(enum.pattern[:, i]
                 for i in range(enum.pattern.shape[1] - 1, -1, -1))
    order = np.lexsort(keys + (enum.number,))
    se = OneGapEnum(
        qrystart=enum.qrystart[order], qrystart_len=enum.qrystart_len[order],
        qryend_len=enum.qryend_len[order], gap=enum.gap[order],
        pattern=enum.pattern[order], number=enum.number[order])
    new = np.empty(n, dtype=bool)
    new[0] = True
    new[1:] = (se.number[1:] != se.number[:-1]) | \
        (se.pattern[1:] != se.pattern[:-1]).any(axis=1)
    run_id = np.cumsum(new) - 1
    firsts = np.flatnonzero(new)
    d = len(firsts)
    qids = np.asarray(queries.tok_to_qry)[se.qrystart]
    pairs = np.unique(np.stack([qids.astype(np.int64), run_id.astype(np.int64)],
                               axis=1), axis=0)
    query_with_id = [[] for _ in range(queries.qryscount)]
    for q, r in pairs:
        query_with_id[int(q)].append(int(r))
    search = OneGapSearch(
        qrystart=se.qrystart[firsts].astype(np.int32),
        qrystart_len=se.qrystart_len[firsts].astype(np.int32),
        qryend_len=se.qryend_len[firsts].astype(np.int32),
        gap=se.gap[firsts].astype(np.int32),
        position=firsts.astype(np.int32),
        start_on_salist=np.full(d, -1, dtype=np.int32),
        end_on_salist=np.full(d, -1, dtype=np.int32),
        query_with_id=query_with_id)
    return se, search


def fast_two_gap_enumeration(queries: QuerySet, p1: Pass1Result,
                             enum_sorted: OneGapEnum, search: OneGapSearch,
                             cfg: ExtractorConfig) -> TwoGapEnum:
    """Per instance of every distinct one-gap pattern that occurs in the
    corpus, one candidate c token per legal second-gap position."""
    n_enum = len(enum_sorted.qrystart)
    D = len(search.qrystart)
    ntok = queries.totaltokens
    lm = np.asarray(p1.longestmatch, dtype=np.int64)
    toks = np.asarray(queries.tokens, dtype=np.int64)
    qid_of = np.asarray(queries.tok_to_qry, dtype=np.int64)
    qend_of = np.asarray([queries.query_end(int(q)) for q in qid_of],
                         dtype=np.int64)

    limit = (cfg.max_rule_symbols - 2 - search.qrystart_len.astype(np.int64)
             - search.qryend_len.astype(np.int64))
    eligible = (search.start_on_salist != -1) & (search.end_on_salist != -1) & \
        (limit >= 1)
    # instances of eligible patterns, canonical (pattern, instance) order
    pos = search.position.astype(np.int64)
    ender = np.concatenate([pos[1:], [n_enum]])
    counts = np.where(eligible, ender - pos, 0)
    sp = np.repeat(np.arange(D, dtype=np.int64), counts)
    offs = np.concatenate([[0], np.cumsum(counts)])[:-1]
    tx = pos[sp] + (np.arange(int(counts.sum())) - np.repeat(offs, counts))
    k = max(1, cfg.max_rule_symbols - 4)
    if len(sp) == 0:
        return TwoGapEnum(*(np.empty(0, np.int32) for _ in range(3)),
                          pattern=np.empty((0, k), np.int32),
                          number=np.empty(0, np.int32))
    search_start = (enum_sorted.qrystart[tx].astype(np.int64)
                    + enum_sorted.qrystart_len[tx].astype(np.int64)
                    + enum_sorted.gap[tx].astype(np.int64)
                    + enum_sorted.qryend_len[tx].astype(np.int64) - 1)
    in_corpus = search_start <= ntok - 1
    qend = np.where(in_corpus, qend_of[np.clip(search_start, 0, ntok - 1)], 0)
    qrystart = enum_sorted.qrystart[tx].astype(np.int64)

    off = np.arange(OFFW, dtype=np.int64)
    st = search_start[:, None] + cfg.min_gap_size + 1 + off[None, :]
    stc = np.clip(st, 0, ntok - 1)
    ok = in_corpus[:, None] & (st < qend[:, None])
    ok = ok & (lm[stc] >= 1)
    ok = ok & (st - qrystart[:, None] <= cfg.max_rule_span_pattern)
    ii, oi = np.nonzero(ok)
    st_sel = st[ii, oi]
    pat = np.full((len(ii), k), -2, dtype=np.int32)
    pat[:, 0] = toks[st_sel]
    return TwoGapEnum(
        blockid=sp[ii].astype(np.int32), gap2=st_sel.astype(np.int32),
        qryend_len=np.ones(len(ii), dtype=np.int32), pattern=pat,
        number=np.ones(len(ii), dtype=np.int32))


def fast_sort_and_dedup_twogap(enum: TwoGapEnum, queries: QuerySet) -> tuple:
    """Stable sort by (one-gap pattern, number, c tokens) and the distinct
    scan -> (sorted TwoGapEnum, TwoGapSearch).  An empty enumeration gives
    itself and an empty table (what the sequential
    ``sort_and_dedup_twogap`` returns for it)."""
    n = len(enum.blockid)
    if n == 0:
        def z():
            return np.empty(0, dtype=np.int32)
        return enum, TwoGapSearch(
            blockid=z(), position=z(), qryend_len=z(), gap2=z(),
            start_on_salist=z(), end_on_salist=z(),
            query_with_id=[[] for _ in range(queries.qryscount)])
    keys = tuple(enum.pattern[:, i]
                 for i in range(enum.pattern.shape[1] - 1, -1, -1))
    order = np.lexsort(keys + (enum.number, enum.blockid))
    se = TwoGapEnum(
        blockid=enum.blockid[order], gap2=enum.gap2[order],
        qryend_len=enum.qryend_len[order], pattern=enum.pattern[order],
        number=enum.number[order])
    new = np.empty(n, dtype=bool)
    new[0] = True
    new[1:] = (se.number[1:] != se.number[:-1]) | \
        (se.blockid[1:] != se.blockid[:-1]) | \
        (se.pattern[1:] != se.pattern[:-1]).any(axis=1)
    run_id = np.cumsum(new) - 1
    firsts = np.flatnonzero(new)
    d = len(firsts)
    qids = np.asarray(queries.tok_to_qry)[se.gap2]
    pairs = np.unique(np.stack([qids.astype(np.int64), run_id.astype(np.int64)],
                               axis=1), axis=0)
    query_with_id = [[] for _ in range(queries.qryscount)]
    for q, r in pairs:
        query_with_id[int(q)].append(int(r))
    search2 = TwoGapSearch(
        blockid=se.blockid[firsts].astype(np.int32),
        position=firsts.astype(np.int32),
        qryend_len=se.qryend_len[firsts].astype(np.int32),
        gap2=se.gap2[firsts].astype(np.int32),
        start_on_salist=np.full(d, -1, dtype=np.int32),
        end_on_salist=np.full(d, -1, dtype=np.int32),
        query_with_id=query_with_id)
    return se, search2
