"""Oracle search engine: exact sequential semantics of the reference's matching
kernels (SuffixArray.cu pass 1/2, gap enumeration, GappyLook.cu lookups, precompute).

Every function here mirrors the CUDA control flow statement-for-statement, executed
sequentially in canonical order (DESIGN.md).  This is the spec the TPU pipeline must
reproduce; it is deliberately loop-heavy Python — correctness anchor, not speed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cgx_tpu_torch.config import ExtractorConfig
from cgx_tpu_torch.preproc.corpus import QuerySet, SourceCorpus, Alignment
from cgx_tpu_torch.preproc.suffix_array import SAIndex
from cgx_tpu_torch.types import (SEP, GapOnSA, OneGapEnum, OneGapSearch, Pass1Result,
                           Pass2Result, Precomp, TwoGapEnum, TwoGapSearch)


def _pass1_one_token(refstr, refsa, lcpleft, lcpright, reflen,
                     tokens, tok_global, suffixlen):
    """suffixArrayFindLwRwKernelTwoWayTDI (SuffixArray.cu:402-767) for one token,
    both up/down duties.  Returns (longestmatch, up, down, ffh, ffhL, ffhR)."""
    ntok_total = len(tokens)

    def q(off):
        i = tok_global + off
        return int(tokens[i]) if i < ntok_total else -2  # guarded OOB read

    a = q(0)
    if a == -1:
        return 0, -1, -1, -1, -1, -1

    L, R = 0, reflen - 1
    Llcp, Rlcp = 0, 0
    foundexactlcp = 0
    firstfindhit = firstfindhitL = firstfindhitR = -1
    longlen = -1

    # Boundary probe COMP1 against SA[R] (SuffixArray.cu:484-514).
    m = 0
    ok = 0
    s1 = int(refsa[R])
    while True:
        ref = int(refstr[s1 + m]) if s1 + m < reflen else 0
        qv = q(m)
        if m < suffixlen and ref == qv and ref != SEP and qv != -1:
            m += 1
            continue
        break
    if qv == -1 or m == suffixlen:
        ok = 1
    Rlcp = m
    if Rlcp > 0 and ok == 1:
        foundexactlcp = 1
        longlen = Rlcp
    boundary_down = None
    if Rlcp > 0:
        firstfindhit, firstfindhitL, firstfindhitR = R, L, R
        boundary_down = R  # down duty returns early with down = R

    if foundexactlcp == 0:
        longlen = 0
        while R - L > 1:
            longlen = 0
            M = (L + R) >> 1
            if Llcp >= Rlcp:
                longlen = Llcp
                if L == M - 1:
                    skip = int(lcpleft[M])
                else:
                    ht = (L + M) >> 1
                    skip = min(int(lcpleft[ht]), int(lcpright[ht]))
                if longlen < skip:
                    L = M
                    continue
                if longlen > skip:
                    R = M
                    Rlcp = skip
                    continue
            else:
                longlen = Rlcp
                if R == M + 1:
                    skip = int(lcpright[M])
                else:
                    ht = (R + M) >> 1
                    skip = min(int(lcpleft[ht]), int(lcpright[ht]))
                if longlen < skip:
                    R = M
                    continue
                if longlen > skip:
                    L = M
                    Llcp = skip
                    continue
            # longlen == skip: character comparison at M
            startREF = int(refsa[M]) + longlen
            a = q(longlen)
            b = int(refstr[startREF]) if startREF < reflen else 0
            if longlen >= suffixlen or a == -1:
                foundexactlcp = 1
                break
            temp = -1
            if a != -1 and b != SEP:
                temp = a - b
                while a != -1 and b != SEP and temp == 0:
                    longlen += 1
                    startREF += 1
                    if firstfindhit == -1 and M >= 0:
                        firstfindhit, firstfindhitL, firstfindhitR = M, L, R
                    if longlen >= suffixlen:
                        foundexactlcp = 1
                        break
                    a = q(longlen)
                    b = int(refstr[startREF]) if startREF < reflen else 0
                    if a == -1:
                        foundexactlcp = 1
                        break
                    if a != -1 and b != SEP:
                        temp = a - b
                if foundexactlcp == 1:
                    break
            if a == -1:
                R = M
                L = M
            elif b == SEP:
                L = M
                Llcp = longlen
            elif temp > 0:
                L = M
                Llcp = longlen
            else:
                R = M
                Rlcp = longlen

    longestmatch = longlen if longlen > 0 else 0
    up = down = -1
    if firstfindhit != -1 and longlen > 0:
        # up walk (SuffixArray.cu:714-736)
        Rw, Lw = firstfindhit, firstfindhitL
        longest = firstfindhit
        while Rw - Lw > 1:
            M = (Lw + Rw) >> 1
            if Rw == M + 1:
                skip = int(lcpright[M])
            else:
                ht = (Rw + M) >> 1
                skip = min(int(lcpleft[ht]), int(lcpright[ht]))
            if skip >= 1:
                longest = M
                Rw = M
            else:
                Lw = M
        up = longest
        # down walk (SuffixArray.cu:737-763)
        if boundary_down is not None:
            down = boundary_down
        else:
            Rw, Lw = firstfindhitR, firstfindhit
            longest = firstfindhit
            while Rw - Lw > 1:
                M = (Lw + Rw) >> 1
                if Lw == M - 1:
                    skip = int(lcpleft[M])
                else:
                    ht = (Lw + M) >> 1
                    skip = min(int(lcpleft[ht]), int(lcpright[ht]))
                if skip >= 1:
                    longest = M
                    Lw = M
                else:
                    Rw = M
            down = longest
    return longestmatch, up, down, firstfindhit, firstfindhitL, firstfindhitR


def pass1(source: SourceCorpus, sa: SAIndex, queries: QuerySet) -> Pass1Result:
    n = queries.totaltokens
    out = Pass1Result(*(np.full(n, -1, dtype=np.int32) for _ in range(6)))
    out.longestmatch[:] = 0
    reflen = source.toklen
    for q in range(queries.qryscount):
        off = int(queries.offsets[q])
        end = queries.query_end(q)
        for t in range(off, end):
            lm, up, down, ffh, ffhL, ffhR = _pass1_one_token(
                source.str_, sa.sa, sa.lcpleft, sa.lcpright, reflen,
                queries.tokens, t, end - t)  # suffixlen = toklen - tokindex
            out.longestmatch[t] = lm
            out.up[t] = up
            out.down[t] = down
            out.firstfindhit[t] = ffh
            out.firstfindhitL[t] = ffhL
            out.firstfindhitR[t] = ffhR
    return out


def _pass2_one(refstr, refsa, lcpleft, lcpright, reflen, tokens, tok_global,
               match, LL, MM, RR):
    """suffixArrayFindConnectionTwoWayTDI (SuffixArray.cu:109-400) for one
    (token, match-length); returns (up, down) or None when no hit (impossible)."""
    ntok_total = len(tokens)

    def q(off):
        i = tok_global + off
        return int(tokens[i]) if i < ntok_total else -2

    L, R = LL, RR
    foundexactlcp = 0
    firstfindhit = firstfindhitL = firstfindhitR = -1
    longlen = 0
    Llcp = Rlcp = 0
    while R - L > 1:
        longlen = 0
        if L == LL and R == RR:
            M = MM
        else:
            M = (L + R) >> 1
        if Llcp >= Rlcp:
            longlen = Llcp
            if L == M - 1:
                skip = int(lcpleft[M])
            else:
                ht = (L + M) >> 1
                skip = min(int(lcpleft[ht]), int(lcpright[ht]))
            if longlen < skip:
                L = M
                continue
            if longlen > skip:
                R = M
                Rlcp = skip
                continue
        else:
            longlen = Rlcp
            if R == M + 1:
                skip = int(lcpright[M])
            else:
                ht = (R + M) >> 1
                skip = min(int(lcpleft[ht]), int(lcpright[ht]))
            if longlen < skip:
                R = M
                continue
            if longlen > skip:
                L = M
                Llcp = skip
                continue
        startREF = int(refsa[M]) + longlen
        a = q(longlen)
        b = int(refstr[startREF]) if startREF < reflen else 0
        if a == -1:
            foundexactlcp = 1
            break
        temp = -1
        if a != -1 and b != SEP:
            temp = a - b
            while a != -1 and b != SEP and temp == 0:
                longlen += 1
                startREF += 1
                if firstfindhit == -1 and M >= 0 and longlen >= match:
                    firstfindhit, firstfindhitL, firstfindhitR = M, L, R
                    foundexactlcp = 1
                    break
                a = q(longlen)
                b = int(refstr[startREF]) if startREF < reflen else 0
                if a == -1:
                    foundexactlcp = 1
                    break
                if a != -1 and b != SEP:
                    temp = a - b
            if foundexactlcp == 1:
                break
        if a == -1:
            R = M
            L = M
        elif b == SEP:
            L = M
            Llcp = longlen
        elif temp > 0:
            L = M
            Llcp = longlen
        else:
            R = M
            Rlcp = longlen

    if firstfindhit == -1:
        raise AssertionError(
            f"pass2: no hit for token {tok_global} match {match} (reference "
            "guarantees a hit for match <= longestmatch)")
    if not (longlen > 0 and foundexactlcp == 1):
        raise AssertionError("pass2: inconsistent search state")

    # up walk (skip >= match)
    Rw, Lw = firstfindhit, firstfindhitL
    longest = firstfindhit
    while Rw - Lw > 1:
        M = (Lw + Rw) >> 1
        if Rw == M + 1:
            skip = int(lcpright[M])
        else:
            ht = (Rw + M) >> 1
            skip = min(int(lcpleft[ht]), int(lcpright[ht]))
        if skip >= match:
            longest = M
            Rw = M
        else:
            Lw = M
    up = longest
    # down walk
    Rw, Lw = firstfindhitR, firstfindhit
    longest = firstfindhit
    while Rw - Lw > 1:
        M = (Lw + Rw) >> 1
        if Lw == M - 1:
            skip = int(lcpleft[M])
        else:
            ht = (Lw + M) >> 1
            skip = min(int(lcpleft[ht]), int(lcpright[ht]))
        if skip >= match:
            longest = M
            Lw = M
        else:
            Rw = M
    down = longest
    return up, down


def pass2(source: SourceCorpus, sa: SAIndex, queries: QuerySet,
          p1: Pass1Result) -> Pass2Result:
    n = queries.totaltokens
    connectoffset = np.full(n, -1, dtype=np.int32)
    total = 0
    for t in range(n):  # host scan (SuffixArray.cu:1464-1474)
        if int(p1.longestmatch[t]) - 1 > 0:
            connectoffset[t] = total
            total += int(p1.longestmatch[t]) - 1
    up = np.full(total, -1, dtype=np.int32)
    down = np.full(total, -1, dtype=np.int32)
    reflen = source.toklen
    for t in range(n):
        lm = int(p1.longestmatch[t])
        if lm <= 1 or connectoffset[t] < 0:
            continue
        LL = int(p1.firstfindhitL[t])
        MM = int(p1.firstfindhit[t])
        RR = int(p1.firstfindhitR[t])
        base = int(connectoffset[t])
        for match in range(2, lm + 1):
            u, d = _pass2_one(source.str_, sa.sa, sa.lcpleft, sa.lcpright,
                              reflen, queries.tokens, t, match, LL, MM, RR)
            up[base + match - 2] = u
            down[base + match - 2] = d
    return Pass2Result(connectoffset=connectoffset, up=up, down=down)


# ---------------------------------------------------------------------------
# Gap enumeration (SuffixArray.cu:928-1039 / 816-926) + distinct scans.
# ---------------------------------------------------------------------------

def one_gap_enumeration(queries: QuerySet, p1: Pass1Result,
                        cfg: ExtractorConfig) -> OneGapEnum:
    qs, qsl, qel, gp, pats, nums = [], [], [], [], [], []
    ntok = queries.totaltokens
    S = cfg.max_rule_symbols
    for tok in range(ntok - 1):
        q = int(queries.tok_to_qry[tok])
        end = queries.query_end(q)
        if tok == end - 1 or tok == end - 2:
            continue
        lls = int(p1.longestmatch[tok])
        for si in range(1, lls + 1):
            st = tok + si + cfg.min_gap_size
            while st < end and st - tok <= cfg.max_rule_span_pattern:
                if int(queries.tokens[st]) != -1:
                    lle = int(p1.longestmatch[st])
                    ei = 1
                    while (si + 1 + ei <= S and ei <= lle
                           and st - tok + ei - 1 <= cfg.max_rule_span_pattern):
                        pat = [-2] * S
                        for i in range(si + 1 + ei):
                            if i < si:
                                pat[i] = int(queries.tokens[tok + i])
                            elif i == si:
                                pat[i] = -1
                            else:
                                pat[i] = int(queries.tokens[st + i - 1 - si])
                        qs.append(tok)
                        qsl.append(si)
                        qel.append(ei)
                        gp.append(st - tok - si)
                        pats.append(pat)
                        nums.append(si + 1 + ei)
                        ei += 1
                st += 1
    return OneGapEnum(
        qrystart=np.asarray(qs, dtype=np.int32),
        qrystart_len=np.asarray(qsl, dtype=np.int32),
        qryend_len=np.asarray(qel, dtype=np.int32),
        gap=np.asarray(gp, dtype=np.int32),
        pattern=np.asarray(pats, dtype=np.int32).reshape(len(qs), S),
        number=np.asarray(nums, dtype=np.int32),
    )


def sort_and_dedup_onegap(enum: OneGapEnum, queries: QuerySet) -> tuple:
    """Stable sort by (number, pattern) (oneGapEnumerationCompare,
    SuffixArray.cu:51-67) + the host distinct scan (SuffixArray.cu:1667-1719).

    Returns (sorted OneGapEnum, OneGapSearch)."""
    n = len(enum.qrystart)
    if n:
        keys = tuple(enum.pattern[:, i] for i in range(enum.pattern.shape[1] - 1, -1, -1))
        order = np.lexsort(keys + (enum.number,))
    else:
        order = np.empty(0, dtype=np.int64)
    se = OneGapEnum(
        qrystart=enum.qrystart[order], qrystart_len=enum.qrystart_len[order],
        qryend_len=enum.qryend_len[order], gap=enum.gap[order],
        pattern=enum.pattern[order] if n else enum.pattern,
        number=enum.number[order])
    # distinct marks
    qrystart, qsl, qel, gap, position = [], [], [], [], []
    query_with_id = [[] for _ in range(queries.qryscount)]
    seen_q = set()
    for i in range(n):
        new = i == 0 or (se.number[i] != se.number[i - 1]
                         or not np.array_equal(se.pattern[i], se.pattern[i - 1]))
        if new:
            seen_q = set()
            position.append(i)
            qrystart.append(int(se.qrystart[i]))
            qsl.append(int(se.qrystart_len[i]))
            qel.append(int(se.qryend_len[i]))
            gap.append(int(se.gap[i]))
        qid = int(queries.tok_to_qry[se.qrystart[i]])
        if qid not in seen_q:
            seen_q.add(qid)
            query_with_id[qid].append(len(position) - 1)
    d = len(position)
    search = OneGapSearch(
        qrystart=np.asarray(qrystart, dtype=np.int32),
        qrystart_len=np.asarray(qsl, dtype=np.int32),
        qryend_len=np.asarray(qel, dtype=np.int32),
        gap=np.asarray(gap, dtype=np.int32),
        position=np.asarray(position, dtype=np.int32),
        start_on_salist=np.full(d, -1, dtype=np.int32),
        end_on_salist=np.full(d, -1, dtype=np.int32),
        query_with_id=query_with_id,
    )
    return se, search


# ---------------------------------------------------------------------------
# Frequent-pair precomputation (SuffixArray.cu:1132-1340, GappyLook.cu:740-869).
# ---------------------------------------------------------------------------

def check_boundary_gap(start, ender, L_tar, R_tar, RLP, max_rule_span):
    """checkBoundaryGap (GappyLook.cu:43-126): target-consistency of a source gap."""
    min_L, max_R = 255, 0
    sen_target_begin = -1
    tempind = 0
    for k in range(start, ender + 1):
        temp = int(RLP[k])
        L = (temp >> 24) & 0xFF
        R = (temp >> 16) & 0xFF
        if (L == 255 or R == 255) and (k == start or k == ender):
            return False
        elif L == 255 or R == 255:
            pass
        elif k == start:
            tempind = k - ((temp >> 8) & 0xFF) - 1
            sen_target_begin = 0 if tempind == -1 else int(RLP[tempind])
            min_L, max_R = L, R
        else:
            if min_L > L:
                min_L = L
            if max_R < R:
                max_R = R
    if min_L <= max_R and max_R - min_L < max_rule_span:
        tempind += 1
        ts = min_L + sen_target_begin
        te = max_R + sen_target_begin
        bmin, bmax = 255, 0
        for k in range(ts, te + 1):
            L = int(L_tar[k])
            R = int(R_tar[k])
            if L == 255 or R == 255:
                pass
            elif k == ts:
                bmin, bmax = L, R
            else:
                if bmin > L:
                    bmin = L
                if bmax < R:
                    bmax = R
        return tempind + bmin == start and tempind + bmax == ender
    return False


def precompute(source: SourceCorpus, sa: SAIndex, align: Alignment,
               cfg: ExtractorConfig) -> Precomp:
    refstr = source.str_
    refsa = sa.sa
    n = source.toklen
    # token runs over SA (skip tokens < 2, which sort first)
    first = refstr[refsa]
    runs = []  # (token, count, start_sa_index)
    i = 0
    while i < n and first[i] < 2:
        i += 1
    start = i
    while i < n:
        j = i
        while j < n and first[j] == first[i]:
            j += 1
        runs.append((int(first[i]), j - i, i))
        i = j
    # top-P by count, canonical tie-break: stable over SA order (ascending token id)
    P = min(cfg.precompute_count, len(runs))
    top = sorted(runs, key=lambda r: -r[1])[:P]
    top.sort(key=lambda r: r[0])  # ascending token id (compareUserTotal2)
    frequent = np.asarray([t[0] for t in top], dtype=np.int32)
    tok_len = np.asarray([t[1] for t in top], dtype=np.int32)
    tok_start = np.asarray([t[2] for t in top], dtype=np.int32)

    feature_missing = np.zeros(P * P, dtype=np.int32)
    rows = []  # (cell, start, length) in canonical order
    for cc in range(P):
        for jj in range(P):
            cell = cc * P + jj
            tok_a, tok_b = int(frequent[cc]), int(frequent[jj])
            reverse = tok_len[jj] >= tok_len[cc]
            if reverse:
                occ_start, occ_len = int(tok_start[cc]), int(tok_len[cc])
            else:
                occ_start, occ_len = int(tok_start[jj]), int(tok_len[jj])
            for tid in range(occ_start, occ_start + occ_len):
                gostart = int(refsa[tid])
                move = 0
                flager = True
                if reverse:
                    # forward scan from a's occurrence for b (GappyLook.cu:787-822)
                    while flager:
                        if move == 0:
                            if int(refstr[gostart + cfg.min_gap_size]) < 2:
                                flager = False
                        pos = gostart + 1 + cfg.min_gap_size + move
                        temp = int(refstr[pos]) if pos < n else 0
                        if temp < 2:
                            flager = False
                        elif flager and temp == tok_b:
                            if check_boundary_gap(gostart + 1,
                                                  gostart + move + 1 + cfg.min_gap_size - 1,
                                                  align.L_tar, align.R_tar, align.RLP,
                                                  cfg.max_rule_span):
                                rows.append((cell, gostart, move + 1 + cfg.min_gap_size))
                            else:
                                feature_missing[cell] += 1
                        move += 1
                        if 1 + cfg.min_gap_size + move + 1 > cfg.max_rule_span:
                            flager = False
                else:
                    # backward scan from b's occurrence for a (GappyLook.cu:829-863)
                    while flager:
                        if move == 0 and gostart - cfg.min_gap_size >= 0:
                            if int(refstr[gostart - cfg.min_gap_size]) < 2:
                                flager = False
                        if flager and gostart - 1 - cfg.min_gap_size - move >= 0:
                            temp = int(refstr[gostart - 1 - cfg.min_gap_size - move])
                            if temp < 2:
                                flager = False
                            elif flager and temp == tok_a:
                                s0 = gostart - 1 - cfg.min_gap_size - move
                                if check_boundary_gap(s0 + 1, gostart - 1,
                                                      align.L_tar, align.R_tar,
                                                      align.RLP, cfg.max_rule_span):
                                    rows.append((cell, s0, move + 1 + cfg.min_gap_size))
                                else:
                                    feature_missing[cell] += 1
                        else:
                            flager = False
                        move += 1
                        if 1 + cfg.min_gap_size + move + 1 > cfg.max_rule_span:
                            flager = False
    # canonical stable sort by (cell, start, length) (compareUserTotal3 intent)
    rows.sort(key=lambda r: (r[0], r[1], r[2]))
    cells = np.asarray([r[0] for r in rows], dtype=np.int32)
    index_start = np.ones(P * P, dtype=np.int32)
    index_end = np.zeros(P * P, dtype=np.int32)
    if len(rows):
        uniq, first_idx, counts = np.unique(cells, return_index=True, return_counts=True)
        index_start[uniq] = first_idx.astype(np.int32)
        index_end[uniq] = (first_idx + counts - 1).astype(np.int32)
    return Precomp(
        frequent_list=frequent, tok_start=tok_start, tok_len=tok_len,
        index_start=index_start, index_end=index_end,
        onegap_start=np.asarray([r[1] for r in rows], dtype=np.int32),
        onegap_length=np.asarray([r[2] for r in rows], dtype=np.int32),
        feature_missing=feature_missing, count=len(rows))


# ---------------------------------------------------------------------------
# 1-gap SA lookup (oneGapLookUpSA, GappyLook.cu:128-473).
# ---------------------------------------------------------------------------

def _range_for(tok, length, p1: Pass1Result, p2: Pass2Result):
    if length == 1:
        return int(p1.up[tok]), int(p1.down[tok])
    cc = int(p2.connectoffset[tok]) + length - 2
    return int(p2.up[cc]), int(p2.down[cc])


def one_gap_lookup(source: SourceCorpus, sa: SAIndex, align: Alignment,
                   queries: QuerySet, p1: Pass1Result, p2: Pass2Result,
                   search: OneGapSearch, pc: Precomp,
                   cfg: ExtractorConfig) -> GapOnSA:
    refstr, refsa = source.str_, sa.sa
    n = source.toklen
    rows = []  # (position, str_position, length) canonical emission order
    D = len(search.qrystart)
    for blockId in range(D):
        sl = int(search.qrystart_len[blockId])
        el = int(search.qryend_len[blockId])
        tok = int(search.qrystart[blockId])
        stok = tok + int(search.gap[blockId]) + sl
        a_last = int(queries.tokens[tok + sl - 1])
        b_first = int(queries.tokens[stok])
        pci = pc.cell_of(a_last, b_first)
        forward = True
        if pci == -1:
            r1u, r1d = _range_for(tok, sl, p1, p2)
            r2u, r2d = _range_for(stok, el, p1, p2)
            dis, dis2 = r1d - r1u, r2d - r2u
            if dis <= dis2:
                t_start, t_end = r1u, r1d
                forward = True
            else:
                dis = dis2
                t_start, t_end = r2u, r2d
                forward = False
        else:
            t_start = int(pc.index_start[pci])
            t_end = int(pc.index_end[pci])
            dis = t_end - t_start
        if pci != -1 and sl == 1 and el == 1 and dis >= 0:
            rows.append((blockId, pci, 0))
            continue
        for tx in range(dis + 1):
            if pci != -1:
                pstart = int(pc.onegap_start[t_start + tx])
                plen = int(pc.onegap_length[t_start + tx])
                flager = True
                if plen + 1 + sl - 1 + el - 1 > cfg.max_rule_span:
                    flager = False
                if flager and sl > 1:
                    backoff = 0
                    stop = False
                    while flager and not stop:
                        backoff += 1
                        if (pstart - backoff < 0
                                or int(refstr[pstart - backoff])
                                != int(queries.tokens[tok + sl - 1 - backoff])):
                            flager = False
                        if sl - backoff <= 1:
                            stop = True
                if flager and el > 1:
                    fwd = 1
                    while fwd < el and flager:
                        fwd += 1
                        if (int(refstr[pstart + plen + fwd - 1])
                                != int(queries.tokens[stok + fwd - 1])):
                            flager = False
                if flager:
                    rows.append((blockId, pstart - sl + 1, plen + sl - 1 + el - 1))
            elif forward:
                gostart = int(refsa[tx + t_start])
                move = 0
                flager = True
                while flager:
                    if move == 0:
                        if int(refstr[gostart + sl]) < 2:
                            flager = False
                    pos = gostart + sl + cfg.min_gap_size + move
                    temp = int(refstr[pos]) if pos < n else 0
                    if temp < 2:
                        flager = False
                    elif flager and temp == b_first:
                        matchcount = 1
                        stop = False
                        while (not stop and matchcount < el
                               and sl + cfg.min_gap_size + move + 1 + matchcount
                               <= cfg.max_rule_span):
                            bo = int(refstr[pos + matchcount])
                            if bo < 2:
                                stop = True
                                flager = False
                            elif bo == int(queries.tokens[stok + matchcount]):
                                matchcount += 1
                            else:
                                stop = True
                        if matchcount == el and check_boundary_gap(
                                gostart + sl,
                                gostart + sl + cfg.min_gap_size + move - 1,
                                align.L_tar, align.R_tar, align.RLP,
                                cfg.max_rule_span):
                            rows.append((blockId, gostart,
                                         sl + cfg.min_gap_size + move + el - 1))
                    move += 1
                    if sl + cfg.min_gap_size + move + el > cfg.max_rule_span:
                        flager = False
            else:
                gostart = int(refsa[tx + t_start])
                move = 0
                flager = True
                while flager:
                    if move == 0:
                        if int(refstr[gostart - 1]) < 2:
                            flager = False
                    if gostart - 1 - cfg.min_gap_size - move < 0:
                        temp = -1
                    else:
                        temp = int(refstr[gostart - 1 - cfg.min_gap_size - move])
                    if temp < 2:
                        flager = False
                    elif flager and temp == a_last:
                        matchcount = 1
                        stop = False
                        while (not stop and matchcount < sl
                               and el + cfg.min_gap_size + move + 1 + matchcount
                               <= cfg.max_rule_span):
                            p_ = gostart - 1 - cfg.min_gap_size - move - matchcount
                            bo = int(refstr[p_]) if p_ >= 0 else -1
                            if bo < 2:
                                stop = True
                                flager = False
                            elif bo == int(queries.tokens[tok + sl - 1 - matchcount]):
                                matchcount += 1
                            else:
                                stop = True
                        if matchcount == sl and check_boundary_gap(
                                gostart - 1 - cfg.min_gap_size - move + 1,
                                gostart - 1,
                                align.L_tar, align.R_tar, align.RLP,
                                cfg.max_rule_span):
                            rows.append((blockId,
                                         gostart - 1 - cfg.min_gap_size - move - sl + 1,
                                         el + cfg.min_gap_size + move + sl - 1))
                    move += 1
                    if sl + cfg.min_gap_size + move + el > cfg.max_rule_span:
                        flager = False
    rows.sort(key=lambda r: (r[0], r[1], r[2]))  # canonical (oneGapSACompare + tiebreak)
    out = GapOnSA(
        position=np.asarray([r[0] for r in rows], dtype=np.int32),
        str_position=np.asarray([r[1] for r in rows], dtype=np.int32),
        length=np.asarray([r[2] for r in rows], dtype=np.int32),
        length2=np.zeros(len(rows), dtype=np.int32))
    # fill start/end_on_salist (SuffixArray.cu:1854-1875)
    for i in range(len(rows)):
        p = rows[i][0]
        if search.start_on_salist[p] == -1:
            search.start_on_salist[p] = i
        search.end_on_salist[p] = i
    return out


# ---------------------------------------------------------------------------
# 2-gap enumeration (twoGapEnumeration, SuffixArray.cu:816-926) + distinct scan
# (SuffixArray.cu:2056-2097) + lookup (twoGapLookUpSA, GappyLook.cu:476-737).
# ---------------------------------------------------------------------------

def two_gap_enumeration(queries: QuerySet, p1: Pass1Result,
                        enum_sorted: OneGapEnum, search: OneGapSearch,
                        cfg: ExtractorConfig) -> TwoGapEnum:
    blockids, gap2s, qels, pats, nums = [], [], [], [], []
    n_enum = len(enum_sorted.qrystart)
    D = len(search.qrystart)
    ntok = queries.totaltokens
    for sp in range(D):
        if search.start_on_salist[sp] == -1 or search.end_on_salist[sp] == -1:
            continue
        limit_symbol = (cfg.max_rule_symbols - 1 - 1
                        - int(search.qrystart_len[sp]) - int(search.qryend_len[sp]))
        if limit_symbol < 1:
            continue
        ender = n_enum if sp == D - 1 else int(search.position[sp + 1])
        for tx in range(int(search.position[sp]), ender):
            search_start = (int(enum_sorted.qrystart[tx])
                            + int(enum_sorted.qrystart_len[tx])
                            + int(enum_sorted.gap[tx])
                            + int(enum_sorted.qryend_len[tx]) - 1)
            st = search_start + cfg.min_gap_size + 1
            if search_start > ntok - 1:
                continue
            qid = int(queries.tok_to_qry[search_start])
            end = queries.query_end(qid)
            while st < end:
                lle = int(p1.longestmatch[st])
                it = 1
                while (it <= limit_symbol and it <= lle
                       and st - int(enum_sorted.qrystart[tx]) + it - 1
                       <= cfg.max_rule_span_pattern):
                    blockids.append(sp)
                    gap2s.append(st)
                    qels.append(it)
                    pats.append([int(queries.tokens[st + i]) if i < it else -2
                                 for i in range(cfg.max_rule_symbols - 4)])
                    nums.append(it)
                    it += 1
                st += 1
    k = max(1, cfg.max_rule_symbols - 4)
    return TwoGapEnum(
        blockid=np.asarray(blockids, dtype=np.int32),
        gap2=np.asarray(gap2s, dtype=np.int32),
        qryend_len=np.asarray(qels, dtype=np.int32),
        pattern=np.asarray(pats, dtype=np.int32).reshape(len(blockids), k),
        number=np.asarray(nums, dtype=np.int32))


def sort_and_dedup_twogap(enum: TwoGapEnum, queries: QuerySet) -> tuple:
    n = len(enum.blockid)
    if n:
        keys = tuple(enum.pattern[:, i] for i in range(enum.pattern.shape[1] - 1, -1, -1))
        order = np.lexsort(keys + (enum.number, enum.blockid))
    else:
        order = np.empty(0, dtype=np.int64)
    se = TwoGapEnum(
        blockid=enum.blockid[order], gap2=enum.gap2[order],
        qryend_len=enum.qryend_len[order],
        pattern=enum.pattern[order] if n else enum.pattern,
        number=enum.number[order])
    blockid, position, qel, gap2 = [], [], [], []
    query_with_id = [[] for _ in range(queries.qryscount)]
    seen_q = set()
    for i in range(n):
        new = i == 0 or (se.number[i] != se.number[i - 1]
                         or se.blockid[i] != se.blockid[i - 1]
                         or not np.array_equal(se.pattern[i], se.pattern[i - 1]))
        if new:
            seen_q = set()
            blockid.append(int(se.blockid[i]))
            position.append(i)
            qel.append(int(se.qryend_len[i]))
            gap2.append(int(se.gap2[i]))
        qid = int(queries.tok_to_qry[se.gap2[i]])
        if qid not in seen_q:
            seen_q.add(qid)
            query_with_id[qid].append(len(position) - 1)
    d = len(position)
    search2 = TwoGapSearch(
        blockid=np.asarray(blockid, dtype=np.int32),
        position=np.asarray(position, dtype=np.int32),
        qryend_len=np.asarray(qel, dtype=np.int32),
        gap2=np.asarray(gap2, dtype=np.int32),
        start_on_salist=np.full(d, -1, dtype=np.int32),
        end_on_salist=np.full(d, -1, dtype=np.int32),
        query_with_id=query_with_id)
    return se, search2


def two_gap_lookup(source: SourceCorpus, align: Alignment, queries: QuerySet,
                   search1: OneGapSearch, onegap_sa: GapOnSA,
                   search2: TwoGapSearch, pc: Precomp,
                   cfg: ExtractorConfig) -> GapOnSA:
    refstr = source.str_
    n = source.toklen
    rows = []  # (position, str_position, length, length2)
    D2 = len(search2.blockid)
    for twoId in range(D2):
        oneId = int(search2.blockid[twoId])
        startSA = int(search1.start_on_salist[oneId])
        endSA = int(search1.end_on_salist[oneId])
        if startSA == -1 and endSA == -1:
            continue
        stok = int(search2.gap2[twoId])
        el = int(search2.qryend_len[twoId])
        pre_cache = int(queries.tokens[stok])
        dis = endSA - startSA + 1
        precomp_mode = dis == 1 and int(onegap_sa.length[startSA]) == 0
        if precomp_mode:
            pci = int(onegap_sa.str_position[startSA])
            dis = int(pc.index_end[pci]) - int(pc.index_start[pci]) + 1
            base = int(pc.index_start[pci])
        for tx in range(dis):
            if precomp_mode:
                pstart = int(pc.onegap_start[base + tx])
                plen = int(pc.onegap_length[base + tx])
            else:
                pstart = int(onegap_sa.str_position[startSA + tx])
                plen = int(onegap_sa.length[startSA + tx])
            gostart = pstart + plen
            move = 0
            flager = True
            while flager:
                if move == 0:
                    if int(refstr[gostart + cfg.min_gap_size]) < 2:
                        flager = False
                pos = gostart + 1 + cfg.min_gap_size + move
                temp = int(refstr[pos]) if pos < n else 0
                if plen + 1 + cfg.min_gap_size + move + 1 > cfg.max_rule_span:
                    flager = False
                if temp < 2:
                    flager = False
                elif flager and temp == pre_cache:
                    matchcount = 1
                    stop = False
                    while (not stop and matchcount < el
                           and plen + matchcount + cfg.min_gap_size + move + 1 + 1
                           <= cfg.max_rule_span):
                        bo = int(refstr[pos + matchcount]) if pos + matchcount < n else 0
                        if bo < 2:
                            stop = True
                            flager = False
                        elif bo == int(queries.tokens[stok + matchcount]):
                            matchcount += 1
                        else:
                            stop = True
                    if matchcount == el and check_boundary_gap(
                            pstart + plen + 1,
                            pstart + 1 + plen + cfg.min_gap_size + move - 1,
                            align.L_tar, align.R_tar, align.RLP,
                            cfg.max_rule_span):
                        rows.append((twoId, pstart, plen,
                                     plen + 1 + cfg.min_gap_size + move + el - 1))
                move += 1
    rows.sort(key=lambda r: (r[0], r[1], r[2], r[3]))
    out = GapOnSA(
        position=np.asarray([r[0] for r in rows], dtype=np.int32),
        str_position=np.asarray([r[1] for r in rows], dtype=np.int32),
        length=np.asarray([r[2] for r in rows], dtype=np.int32),
        length2=np.asarray([r[3] for r in rows], dtype=np.int32))
    for i in range(len(rows)):
        p = rows[i][0]
        if search2.start_on_salist[p] == -1:
            search2.start_on_salist[p] = i
        search2.end_on_salist[p] = i
    return out
