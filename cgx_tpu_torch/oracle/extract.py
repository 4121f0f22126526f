"""Oracle extraction: blocks + alignment-consistent rule extraction.

Mirrors GenerateBlocks (ExtractPair.cu:2742-2903) and the three extraction kernels
extractConsistentPairs_Gappy / _OneGap / _TwoGap (ExtractPair.cu:1055-1795, 351-889,
891-1053), executed sequentially in canonical order (DESIGN.md)."""

from __future__ import annotations

import dataclasses

import numpy as np

from cgx_tpu_torch.config import ExtractorConfig
from cgx_tpu_torch.preproc.corpus import Alignment, QuerySet, SourceCorpus
from cgx_tpu_torch.preproc.suffix_array import SAIndex
from cgx_tpu_torch.types import (Blocks, ContigRules, GapOnSA, GapRules, OneGapSearch,
                           Pass1Result, Pass2Result, Precomp, TwoGapSearch)
from cgx_tpu_torch.extract.blocks import LONGESTCHSOURCE, generate_blocks, sample_indices  # noqa: F401



def _consistent(ts, te, L_tar, R_tar, start_chk, end_chk, startpos_source):
    """consistent() (ExtractPair.cu:103-133): target span back-projects exactly."""
    min_L, max_R = 255, 0
    for k in range(ts, te + 1):
        L = int(L_tar[k])
        R = int(R_tar[k])
        if L == 255 or R == 255:
            pass
        elif k == ts:
            min_L, max_R = L, R
        else:
            if min_L > L:
                min_L = L
            if max_R < R:
                max_R = R
    return (startpos_source + min_L == start_chk
            and startpos_source + max_R == end_chk)


def _check_boundary_fast(start, ender, RLP, max_rule_span=15):
    """checkBoundaryFast (ExtractPair.cu:135-194): returns
    (ok, min_L, max_R, sen_target_begin, tempind); no target back-check."""
    min_L, max_R = 255, 0
    sen_target_begin = -1
    tempind = 0
    for k in range(start, ender + 1):
        temp = int(RLP[k])
        L = (temp >> 24) & 0xFF
        R = (temp >> 16) & 0xFF
        if (L == 255 or R == 255) and (k == start or k == ender):
            return False, min_L, max_R, sen_target_begin, tempind
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
        return True, min_L, max_R, sen_target_begin, tempind + 1
    return False, min_L, max_R, sen_target_begin, tempind


def _check_boundary_fast2(start, ender, RLP, max_rule_span):
    """checkBoundaryFast2 (ExtractPair.cu:196-250): -> (ok, target_start, target_end).
    Same span test as checkBoundaryFast; no back-projection (its consistent() call is
    commented out at ExtractPair.cu:246)."""
    ok, min_L, max_R, stb, _ = _check_boundary_fast(start, ender, RLP, max_rule_span)
    return ok, min_L + stb, max_R + stb


def _check_boundary(start, ender, L_tar, R_tar, RLP, max_rule_span):
    """checkBoundary (ExtractPair.cu:252-342): error codes
    0 plain-false / 1 ok / 2 front-unaligned / 3 end-unaligned / 4 both.
    Returns (code, target_start, target_end, sen_target_begin, tempind)."""
    min_L, max_R = 255, 0
    sen_target_begin = -1
    tempind = 0
    front_end_wrong = 0
    for k in range(start, ender + 1):
        temp = int(RLP[k])
        L = (temp >> 24) & 0xFF
        R = (temp >> 16) & 0xFF
        if (L == 255 or R == 255) and (k == start or k == ender):
            if start == ender and front_end_wrong == 0:
                front_end_wrong = 4
            elif front_end_wrong == 0 and k == start:
                front_end_wrong = 2
            elif front_end_wrong == 0 and k == ender:
                front_end_wrong = 3
            elif front_end_wrong != 0:
                front_end_wrong = 4
            if k == start:
                tempind = k - ((temp >> 8) & 0xFF) - 1
                sen_target_begin = 0 if tempind == -1 else int(RLP[tempind])
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
    ts = min_L + sen_target_begin
    te = max_R + sen_target_begin
    if front_end_wrong != 0:
        return front_end_wrong, ts, te, sen_target_begin, tempind
    if min_L <= max_R and max_R - min_L < max_rule_span:
        tempind += 1
        if _consistent(ts, te, L_tar, R_tar, start, ender, tempind):
            return 1, ts, te, sen_target_begin, tempind
        return 0, ts, te, sen_target_begin, tempind
    return 0, ts, te, sen_target_begin, tempind


def _mk_gaprules(rows) -> GapRules:
    a = np.asarray(rows, dtype=np.int64).reshape(len(rows), 7)
    return GapRules(
        ref_str_start=a[:, 0].astype(np.int32), end=a[:, 1].astype(np.int32),
        gap1=a[:, 2].astype(np.int32), gap1_1=a[:, 3].astype(np.int32),
        gap2=a[:, 4].astype(np.int32), gap2_1=a[:, 5].astype(np.int32),
        gappy_index=a[:, 6].astype(np.int32))


def extract_contiguous(source: SourceCorpus, sa: SAIndex, align: Alignment,
                       blocks: Blocks, cfg: ExtractorConfig):
    """extractConsistentPairs_Gappy (ExtractPair.cu:1055-1795).

    Returns (ContigRules, GapRules for Xab/abX, GapRules for XabX),
    each stably sorted by its id key as the host code does."""
    refstr, refsa, RLP = source.str_, sa.sa, align.RLP
    L_tar, R_tar = align.L_tar, align.R_tar
    MRS = cfg.max_rule_span
    out_ab = []     # (blocknumber, tar_start, tar_end)
    out_1g = []     # 7-tuple rows, gappy_index = bnum (Xab) / G + bnum (abX)
    out_2g = []     # 7-tuple rows, gappy_index = bnum (XabX)
    G = len(blocks.start)
    for bnum in range(G):
        bstart, bend = int(blocks.start[bnum]), int(blocks.end[bnum])
        lm = int(blocks.matchlen[bnum])
        if lm < 1:
            continue
        for rel in sample_indices(bend - bstart + 1, cfg.sampler, cfg.is_sample):
            cs = int(refsa[bstart + rel])
            min_L, max_R = 255, 0
            tempind = 0
            sen_target_begin = -1
            ab = Xab = abX = XabX = True
            XabNoSuccess = abXNoSuccess = True
            XabCount = abXCount = 0
            for k in range(cs, cs + lm):
                temp = int(RLP[k])
                L = (temp >> 24) & 0xFF
                R = (temp >> 16) & 0xFF
                if k == cs:
                    tempind = k - ((temp >> 8) & 0xFF) - 1
                    sen_target_begin = 0 if tempind == -1 else int(RLP[tempind])
                if (L == 255 or R == 255) and (k == cs or k == cs + lm - 1):
                    ab = False
                    if k == cs:
                        abXNoSuccess = False
                    else:
                        XabNoSuccess = False
                elif L == 255 or R == 255:
                    pass
                else:
                    if min_L > L:
                        min_L = L
                    if max_R < R:
                        max_R = R
            if min_L > max_R or max_R - min_L >= MRS:
                ab = Xab = abX = XabX = False
            tempind += 1
            ender = cs + lm - 1
            if ab:
                if _consistent(min_L + sen_target_begin, max_R + sen_target_begin,
                               L_tar, R_tar, cs, ender, tempind):
                    out_ab.append((bnum, min_L + sen_target_begin, max_R - min_L))
            if lm + 1 > cfg.max_rule_symbols:
                abX = Xab = False
            if lm + 2 > cfg.max_rule_symbols:
                XabX = False
            i = 1
            min_L_Xab, max_R_Xab = 255, 0
            min_L_abX, max_R_abX = 255, 0
            while lm + i <= MRS and (abXNoSuccess or XabNoSuccess or XabX):
                # ---- Xab: grow left (ExtractPair.cu:1282-1398)
                if Xab and cs - i >= 0 and int(refstr[cs - i]) >= 2:
                    next_ = True
                    temp = int(RLP[cs - i])
                    L = (temp >> 24) & 0xFF
                    R = (temp >> 16) & 0xFF
                    if L == 255 or R == 255:
                        next_ = False
                        if i == 1:
                            Xab = False
                            XabX = False
                    else:
                        if min_L_Xab > L:
                            min_L_Xab = L
                        if max_R_Xab < R:
                            max_R_Xab = R
                    if max_R_Xab - min_L_Xab >= MRS:
                        next_ = False
                        Xab = False
                    if next_:
                        g1s = sen_target_begin + min_L_Xab
                        g1e = sen_target_begin + max_R_Xab
                        next_ = _consistent(g1s, g1e, L_tar, R_tar,
                                            cs - i, cs - 1, tempind)
                        if next_:
                            XabCount = i
                    if XabNoSuccess and next_:
                        ts = sen_target_begin + min(min_L_Xab, min_L)
                        te = sen_target_begin + max(max_R_Xab, max_R)
                        if te - ts >= MRS:
                            next_ = False
                            Xab = False
                        if next_:
                            next_ = _consistent(ts, te, L_tar, R_tar,
                                                cs - i, ender, tempind)
                        if next_:
                            out_1g.append((ts, te - ts, g1s - ts, g1e - ts,
                                           0, 0, bnum))
                            XabNoSuccess = False
                else:
                    Xab = False
                # ---- abX: grow right (ExtractPair.cu:1403-1509)
                if abX and int(refstr[ender + i]) >= 2:
                    next_ = True
                    temp = int(RLP[ender + i])
                    L = (temp >> 24) & 0xFF
                    R = (temp >> 16) & 0xFF
                    if L == 255 or R == 255:
                        next_ = False
                        if i == 1:
                            abX = False
                            XabX = False
                    else:
                        if min_L_abX > L:
                            min_L_abX = L
                        if max_R_abX < R:
                            max_R_abX = R
                    if max_R_abX - min_L_abX >= MRS:
                        next_ = False
                        abX = False
                    if next_:
                        g1s = sen_target_begin + min_L_abX
                        g1e = sen_target_begin + max_R_abX
                        next_ = _consistent(g1s, g1e, L_tar, R_tar,
                                            ender + 1, ender + i, tempind)
                        if next_:
                            abXCount = i
                    if abXNoSuccess and next_:
                        ts = sen_target_begin + min(min_L_abX, min_L)
                        te = sen_target_begin + max(max_R_abX, max_R)
                        if te - ts >= MRS:
                            next_ = False
                            abX = False
                        if next_:
                            next_ = _consistent(ts, te, L_tar, R_tar,
                                                cs, ender + i, tempind)
                        if next_:
                            out_1g.append((ts, te - ts, g1s - ts, g1e - ts,
                                           0, 0, G + bnum))
                            abXNoSuccess = False
                else:
                    abX = False
                # ---- XabX (ExtractPair.cu:1514-1777)
                if XabX and (abX or Xab):
                    if XabCount == i:
                        min_X, max_X = 255, 0
                        icount = 1
                        while XabX and icount <= abXCount:
                            next_ = True
                            if icount + XabCount + lm <= MRS:
                                temp = int(RLP[ender + icount])
                                L = (temp >> 24) & 0xFF
                                R = (temp >> 16) & 0xFF
                                if L == 255 or R == 255:
                                    next_ = False
                                else:
                                    if min_X > L:
                                        min_X = L
                                    if max_X < R:
                                        max_X = R
                            else:
                                next_ = False
                                icount = abXCount + 1
                                continue
                            if next_ and max_X - min_X >= MRS:
                                next_ = False
                                icount = abXCount + 1
                                continue
                            if next_:
                                g2s = sen_target_begin + min_X
                                g2e = sen_target_begin + max_X
                                next_ = _consistent(g2s, g2e, L_tar, R_tar,
                                                    ender + 1, ender + icount,
                                                    tempind)
                            if next_:
                                ts = sen_target_begin + min(min(min_X, min_L_Xab),
                                                            min_L)
                                te = sen_target_begin + max(max(max_X, max_R_Xab),
                                                            max_R)
                                if te - ts >= MRS:
                                    next_ = False
                                    icount = abXCount + 1
                                    continue
                                next_ = _consistent(ts, te, L_tar, R_tar,
                                                    cs - XabCount, ender + icount,
                                                    tempind)
                                if next_:
                                    g1s = sen_target_begin + min_L_Xab
                                    g1e = sen_target_begin + max_R_Xab
                                    out_2g.append((ts, te - ts, g1s - ts, g1e - ts,
                                                   g2s - ts, g2e - ts, bnum))
                                    XabX = False
                            icount += 1
                    if XabX and abXCount == i:
                        min_X, max_X = 255, 0
                        icount = 1
                        while XabX and icount <= XabCount:
                            next_ = True
                            if icount + abXCount + lm <= MRS:
                                temp = int(RLP[cs - icount])
                                L = (temp >> 24) & 0xFF
                                R = (temp >> 16) & 0xFF
                                if L == 255 or R == 255:
                                    next_ = False
                                else:
                                    if min_X > L:
                                        min_X = L
                                    if max_X < R:
                                        max_X = R
                            else:
                                icount = XabCount + 1
                                continue
                            if next_ and max_X - min_X >= MRS:
                                icount = XabCount + 1
                                continue
                            if next_:
                                g1s = sen_target_begin + min_X
                                g1e = sen_target_begin + max_X
                                next_ = _consistent(g1s, g1e, L_tar, R_tar,
                                                    cs - icount, cs - 1, tempind)
                            if next_:
                                ts = sen_target_begin + min(min(min_X, min_L_abX),
                                                            min_L)
                                te = sen_target_begin + max(max(max_X, max_R_abX),
                                                            max_R)
                                if te - ts >= MRS:
                                    next_ = False
                                    icount = XabCount + 1
                                    continue
                                next_ = _consistent(ts, te, L_tar, R_tar,
                                                    cs - icount, ender + abXCount,
                                                    tempind)
                                if next_:
                                    g2s = sen_target_begin + min_L_abX
                                    g2e = sen_target_begin + max_R_abX
                                    out_2g.append((ts, te - ts, g1s - ts, g1e - ts,
                                                   g2s - ts, g2e - ts, bnum))
                                    XabX = False
                            icount += 1
                else:
                    XabX = False
                if not XabX:
                    if not Xab and XabNoSuccess:
                        XabNoSuccess = False
                    if not abX and abXNoSuccess:
                        abXNoSuccess = False
                i += 1
    out_ab.sort(key=lambda r: r[0])  # stable by blocknumber (continousResCompare)
    out_1g.sort(key=lambda r: r[6])  # stable by gappy_index (oneGapResCompare)
    out_2g.sort(key=lambda r: r[6])
    contig = ContigRules(
        tar_start=np.asarray([r[1] for r in out_ab], dtype=np.int32),
        tar_end=np.asarray([r[2] for r in out_ab], dtype=np.int32),
        blocknumber=np.asarray([r[0] for r in out_ab], dtype=np.int32))
    return contig, _mk_gaprules(out_1g), _mk_gaprules(out_2g)


def extract_onegap(source: SourceCorpus, align: Alignment,
                   search1: OneGapSearch, onegap_sa: GapOnSA, pc: Precomp,
                   cfg: ExtractorConfig):
    """extractConsistentPairs_OneGap (ExtractPair.cu:351-889).

    Returns (GapRules aXb [ids oneBlockId], GapRules XaXb/aXbX
    [ids oneBlockId / D1+oneBlockId]), each stably sorted by id."""
    refstr, RLP = source.str_, align.RLP
    L_tar, R_tar = align.L_tar, align.R_tar
    MRS = cfg.max_rule_span
    D1 = len(search1.qrystart)
    out_1g, out_2g = [], []
    for oneId in range(D1):
        startSA = int(search1.start_on_salist[oneId])
        endSA = int(search1.end_on_salist[oneId])
        if startSA == -1 and endSA == -1:
            continue
        sl = int(search1.qrystart_len[oneId])
        el = int(search1.qryend_len[oneId])
        dis = 1 + endSA - startSA
        precomp_mode = dis == 1 and int(onegap_sa.length[startSA]) == 0
        if precomp_mode:
            pci = int(onegap_sa.str_position[startSA])
            startSA = int(pc.index_start[pci])
            endSA = int(pc.index_end[pci])
            dis = 1 + endSA - startSA
        for tx in sample_indices(dis, cfg.sampler_onegap, cfg.is_sample):
            if precomp_mode:
                cs = int(pc.onegap_start[startSA + tx])
                first_end = int(pc.onegap_length[startSA + tx])
            else:
                cs = int(onegap_sa.str_position[startSA + tx])
                first_end = int(onegap_sa.length[startSA + tx])
            ender = cs + first_end
            ok, min_L, max_R, stb, tempind = _check_boundary_fast(
                cs + sl, ender - el, RLP, MRS)
            if not ok:
                raise AssertionError("one-gap extraction: first gap must be "
                                     "consistent (checked at lookup time)")
            gap1_start = min_L + stb
            gap1_end = max_R + stb
            code, ts, te, stb2, _ti = _check_boundary(cs, ender, L_tar, R_tar,
                                                      RLP, MRS)
            min_L = ts - stb
            max_R = te - stb
            left = right = True
            if code == 1:
                out_1g.append((ts, te - ts, gap1_start - ts, gap1_end - ts,
                               0, 0, oneId))
            elif code == 2:
                right = False
            elif code == 3:
                left = False
            elif code == 4:
                left = right = False
            if sl + el + 1 + 1 <= cfg.max_rule_symbols:
                og_s, og_e = gap1_start, gap1_end
                min_XaXb, max_XaXb = 255, 0
                min_aXbX, max_aXbX = 255, 0
                i = 1
                while first_end + 1 + i <= MRS and (left or right):
                    # XaXb: prepend X (ExtractPair.cu:639-760)
                    if left and cs - i >= 0 and int(refstr[cs - i]) >= 2:
                        next_ = True
                        temp = int(RLP[cs - i])
                        L = (temp >> 24) & 0xFF
                        R = (temp >> 16) & 0xFF
                        if L == 255 or R == 255:
                            next_ = False
                            if i == 1:
                                left = False
                        else:
                            if min_XaXb > L:
                                min_XaXb = L
                            if max_XaXb < R:
                                max_XaXb = R
                        if max_XaXb - min_XaXb >= MRS:
                            next_ = False
                            left = False
                        if next_:
                            g1s = stb + min_XaXb
                            g1e = stb + max_XaXb
                            next_ = _consistent(g1s, g1e, L_tar, R_tar,
                                                cs - i, cs - 1, tempind)
                        if next_:
                            ts2 = stb + min(min_XaXb, min_L)
                            te2 = stb + max(max_XaXb, max_R)
                            if te2 - ts2 >= MRS:
                                next_ = False
                                left = False
                            if next_:
                                next_ = _consistent(ts2, te2, L_tar, R_tar,
                                                    cs - i, ender, tempind)
                        if next_:
                            out_2g.append((ts2, te2 - ts2, g1s - ts2, g1e - ts2,
                                           og_s - ts2, og_e - ts2, oneId))
                            left = False
                    else:
                        left = False
                    # aXbX: append X (ExtractPair.cu:763-880)
                    if right and int(refstr[ender + i]) >= 2:
                        next_ = True
                        temp = int(RLP[ender + i])
                        L = (temp >> 24) & 0xFF
                        R = (temp >> 16) & 0xFF
                        if L == 255 or R == 255:
                            next_ = False
                            if i == 1:
                                right = False
                        else:
                            if min_aXbX > L:
                                min_aXbX = L
                            if max_aXbX < R:
                                max_aXbX = R
                        if max_aXbX - min_aXbX >= MRS:
                            next_ = False
                            right = False
                        if next_:
                            g2s = stb + min_aXbX
                            g2e = stb + max_aXbX
                            next_ = _consistent(g2s, g2e, L_tar, R_tar,
                                                ender + 1, ender + i, tempind)
                        if next_:
                            ts2 = stb + min(min_aXbX, min_L)
                            te2 = stb + max(max_aXbX, max_R)
                            if te2 - ts2 >= MRS:
                                next_ = False
                                right = False
                            if next_:
                                next_ = _consistent(ts2, te2, L_tar, R_tar,
                                                    cs, ender + i, tempind)
                        if next_:
                            out_2g.append((ts2, te2 - ts2, og_s - ts2, og_e - ts2,
                                           g2s - ts2, g2e - ts2, D1 + oneId))
                            right = False
                    else:
                        right = False
                    i += 1
    out_1g.sort(key=lambda r: r[6])
    out_2g.sort(key=lambda r: r[6])
    return _mk_gaprules(out_1g), _mk_gaprules(out_2g)


def extract_twogap(source: SourceCorpus, align: Alignment,
                   search1: OneGapSearch, search2: TwoGapSearch,
                   twogap_sa: GapOnSA, cfg: ExtractorConfig) -> GapRules:
    """extractConsistentPairs_TwoGap (ExtractPair.cu:891-1053): aXbXc rules,
    gappy_index = twoBlockId, stably sorted."""
    RLP = align.RLP
    L_tar, R_tar = align.L_tar, align.R_tar
    MRS = cfg.max_rule_span
    out = []
    D2 = len(search2.blockid)
    for twoId in range(D2):
        startSA = int(search2.start_on_salist[twoId])
        endSA = int(search2.end_on_salist[twoId])
        if startSA == -1 and endSA == -1:
            continue
        oneId = int(search2.blockid[twoId])
        sl = int(search1.qrystart_len[oneId])
        el = int(search1.qryend_len[oneId])
        cl = int(search2.qryend_len[twoId])
        dis = endSA - startSA + 1
        for tx in sample_indices(dis, cfg.sampler_twogap, cfg.is_sample):
            cs = int(twogap_sa.str_position[startSA + tx])
            first_end = int(twogap_sa.length[startSA + tx])
            second_end = int(twogap_sa.length2[startSA + tx])
            ok1, g1s, g1e = _check_boundary_fast2(cs + sl, cs + first_end - el,
                                                  RLP, MRS)
            if not ok1:
                raise AssertionError("two-gap extraction: gap1 must be consistent")
            ok2, g2s, g2e = _check_boundary_fast2(cs + first_end + 1,
                                                  cs + second_end - cl, RLP, MRS)
            if not ok2:
                raise AssertionError("two-gap extraction: gap2 must be consistent")
            code, ts, te, _stb, _ti = _check_boundary(cs, cs + second_end,
                                                      L_tar, R_tar, RLP, MRS)
            if code == 1:
                out.append((ts, te - ts, g1s - ts, g1e - ts,
                            g2s - ts, g2e - ts, twoId))
    out.sort(key=lambda r: r[6])
    return _mk_gaprules(out)
