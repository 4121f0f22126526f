"""Host stage: lexicon build (dedup + counts + rule strings + features).

Mirrors createLexiconFast / createLexiconGappyFast / createLexiconTwoGapFast
(ExtractPair.c:515-1276) and the per-id up/down print index (extractGlobalPairsUpDown
+ host scans at ExtractPair.cu:3743-3756, 3810-3816).  A frozen copy of the
sequential specification's ``create_lexicon_*`` loops, with their float32
conventions.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference.config import ExtractorConfig
from perfbench.reference.corpus import SourceCorpus, TargetCorpus
from perfbench.reference.types import (Blocks, ContigRules, FastSpeed, GapOnSA,
                                 GapRules, LexTask, OneGapEnum, OneGapSearch,
                                 Precomp, TwoGapEnum, TwoGapSearch)

X1 = "[X,1]"
X2 = "[X,2]"


def _fsample_score(fs: int) -> np.float32:
    return np.float32(np.log10(np.float64(1 + fs)))


def _finish_aa_bb(rules):
    for r in rules:
        ratio = np.float32(r.paircount) / np.float32(r.fsample)
        r.aa = np.float32(-np.log10(ratio))
        r.bb = np.float32(np.log10(np.float64(1 + r.paircount)))


def _source_name(source: SourceCorpus, blocks: Blocks, bnum: int) -> str:
    ss = int(blocks.string_start[bnum])
    ml = int(blocks.matchlen[bnum])
    return " ".join(source.vocab.id_to_word[int(source.str_[ss + k])]
                    for k in range(ml))


def create_lexicon_contig(contig: ContigRules, source: SourceCorpus,
                          target: TargetCorpus, blocks: Blocks,
                          cfg: ExtractorConfig, tasks: list):
    """createLexiconFast (ExtractPair.c:515-662)."""
    G = len(blocks.start)
    fsample_arr = np.zeros(G, dtype=np.int64)
    for b in contig.blocknumber:
        fsample_arr[int(b)] += 1
    rules: list = []
    index_of: dict = {}  # combine string -> rule index (global hash `lexic`)
    n = len(contig.blocknumber)
    for i in range(n):
        bnum = int(contig.blocknumber[i])
        ss = int(blocks.string_start[bnum])
        ml = int(blocks.matchlen[bnum])
        t0 = int(contig.tar_start[i])
        t1 = t0 + int(contig.tar_end[i])
        tgt = " ".join(target.vocab.id_to_word[int(target.str_[jj])]
                       for jj in range(t0, t1 + 1))
        combine = _source_name(source, blocks, bnum) + " ||| " + tgt
        idx = index_of.get(combine)
        if idx is None:
            index_of[combine] = len(rules)
            src_pat = [int(source.str_[ss + k]) for k in range(ml)]
            tasks.append(LexTask(fast_speed_id=len(rules), source_pattern=src_pat,
                                 target_start=t0, end=int(contig.tar_end[i]),
                                 kind="contig"))
            fs = 1 + int(blocks.end[bnum]) - int(blocks.start[bnum])
            if cfg.is_sample and fs > cfg.sampler:
                fs = cfg.sampler
            rules.append(FastSpeed(
                blocknumber=bnum, lexical=combine, fsample=fs,
                fsample_score=_fsample_score(fs), f=int(fsample_arr[bnum]),
                paircount=1))
        else:
            rules[idx].paircount += 1
    _finish_aa_bb(rules)
    return rules


def _onegap_source(search1: OneGapSearch, enum1: OneGapEnum, one_id: int,
                   source: SourceCorpus):
    """Source string + token ids of distinct 1-gap pattern (aXb form)."""
    pos = int(search1.position[one_id])
    number = int(enum1.number[pos])
    pat = enum1.pattern[pos]
    parts, ids = [], []
    for jj in range(number):
        p = int(pat[jj])
        if p >= 0:
            ids.append(p)
            parts.append(source.vocab.id_to_word[p])
        else:
            parts.append(X1)
    return " ".join(parts), ids


def _gap_target(target: TargetCorpus, ts, te, g1s, g1e, g2s=None, g2e=None):
    """Target-side stringification with [X,1]/[X,2] gap substitution
    (ExtractPair.c:813-837, 1141-1163)."""
    parts = []
    jj = ts
    while jj <= te:
        if g1s <= jj <= g1e:
            parts.append(X1)
            jj = g1e + 1
            continue
        if g2s is not None and g2s <= jj <= g2e:
            parts.append(X2)
            jj = g2e + 1
            continue
        parts.append(target.vocab.id_to_word[int(target.str_[jj])])
        jj += 1
    return " ".join(parts)


def create_lexicon_onegap(rules1: GapRules, source: SourceCorpus,
                          target: TargetCorpus, blocks: Blocks,
                          search1: OneGapSearch, enum1: OneGapEnum,
                          onegap_sa: GapOnSA, pc: Precomp, separator: int,
                          cfg: ExtractorConfig, tasks: list):
    """createLexiconGappyFast (ExtractPair.c:664-936).

    ``rules1`` holds Xab/abX rows [0, separator) then aXb rows; ids already
    converted per segment at read time (Xab=bnum, abX=G+bnum, aXb=2G+oneId)."""
    G = len(blocks.start)
    D1 = len(search1.qrystart)
    fsample_arr = np.zeros(2 * G + D1, dtype=np.int64)
    n = len(rules1.gappy_index)
    for i in range(n):
        gi = int(rules1.gappy_index[i])
        cid = gi if i < separator else 2 * G + gi
        fsample_arr[cid] += 1

    rules: list = []
    dedup: dict = {}
    cur_src = ""
    cur_ids: list = []
    for i in range(n):
        gi = int(rules1.gappy_index[i])
        if i == 0 or gi != int(rules1.gappy_index[i - 1]) or i == separator:
            dedup = {}
            if i < separator:
                if gi < G:
                    cur_src = X1 + " " + _source_name(source, blocks, gi)
                    base = gi
                else:
                    cur_src = _source_name(source, blocks, gi - G) + " " + X1
                    base = gi - G
                ss = int(blocks.string_start[base])
                ml = int(blocks.matchlen[base])
                cur_ids = [int(source.str_[ss + k]) for k in range(ml)]
            else:
                cur_src, cur_ids = _onegap_source(search1, enum1, gi, source)
        cid = gi if i < separator else 2 * G + gi
        ts = int(rules1.ref_str_start[i])
        te = ts + int(rules1.end[i])
        g1s = ts + int(rules1.gap1[i])
        g1e = ts + int(rules1.gap1_1[i])
        tgt = _gap_target(target, ts, te, g1s, g1e)
        key = tgt
        idx = dedup.get(key)
        if idx is None:
            dedup[key] = len(rules)
            tasks.append(LexTask(
                fast_speed_id=len(rules), source_pattern=list(cur_ids),
                target_start=ts, end=int(rules1.end[i]),
                gap1=int(rules1.gap1[i]), gap1_1=int(rules1.gap1_1[i]),
                kind="onegap"))
            if i < separator:
                base = gi if gi < G else gi - G
                fs = 1 + int(blocks.end[base]) - int(blocks.start[base])
            else:
                fs = (1 + int(search1.end_on_salist[gi])
                      - int(search1.start_on_salist[gi]))
                if fs == 1 and int(onegap_sa.length[int(search1.start_on_salist[gi])]) == 0:
                    pci = int(onegap_sa.str_position[int(search1.start_on_salist[gi])])
                    fs = (1 - int(pc.index_start[pci]) + int(pc.index_end[pci])
                          + int(pc.feature_missing[pci]))
            if cfg.is_sample and fs > cfg.sampler:
                fs = cfg.sampler
            rules.append(FastSpeed(
                blocknumber=cid, lexical=cur_src + " ||| " + tgt, fsample=fs,
                fsample_score=_fsample_score(fs), f=int(fsample_arr[cid]),
                paircount=1))
        else:
            rules[idx].paircount += 1
    _finish_aa_bb(rules)
    return rules


def create_lexicon_twogap(rules2: GapRules, source: SourceCorpus,
                          target: TargetCorpus, blocks: Blocks,
                          search1: OneGapSearch, enum1: OneGapEnum,
                          search2: TwoGapSearch, enum2: TwoGapEnum,
                          onegap_sa: GapOnSA, pc: Precomp,
                          sep1: int, sep2: int,
                          cfg: ExtractorConfig, tasks: list):
    """createLexiconTwoGapFast (ExtractPair.c:939-1276).

    Segments of ``rules2``: [0,sep1) XabX by bnum; [sep1,sep2) aXbXc by twoId;
    [sep2,n) XaXb (oneId) / aXbX (D1+oneId)."""
    G = len(blocks.start)
    D1 = len(search1.qrystart)
    D2 = len(search2.blockid)
    fsample_arr = np.zeros(G + 2 * D1 + D2, dtype=np.int64)
    n = len(rules2.gappy_index)

    def converted(i: int) -> int:
        gi = int(rules2.gappy_index[i])
        if i < sep1:
            return gi
        if i < sep2:
            return G + gi
        return G + D2 + gi

    for i in range(n):
        fsample_arr[converted(i)] += 1

    rules: list = []
    dedup: dict = {}
    cur_src = ""
    cur_ids: list = []
    for i in range(n):
        gi = int(rules2.gappy_index[i])
        if (i == 0 or gi != int(rules2.gappy_index[i - 1])
                or i == sep1 or i == sep2):
            dedup = {}
            cur_ids = []
            if i < sep1:  # XabX
                cur_src = X1 + " " + _source_name(source, blocks, gi) + " " + X2
                ss = int(blocks.string_start[gi])
                ml = int(blocks.matchlen[gi])
                cur_ids = [int(source.str_[ss + k]) for k in range(ml)]
            elif i < sep2:  # aXbXc
                one_id = int(search2.blockid[gi])
                s, ids = _onegap_source(search1, enum1, one_id, source)
                cur_ids = list(ids)
                pos2 = int(search2.position[gi])
                num2 = int(enum2.number[pos2])
                tail = []
                for jj in range(num2):
                    p = int(enum2.pattern[pos2][jj])
                    cur_ids.append(p)
                    tail.append(source.vocab.id_to_word[p])
                cur_src = s + " " + X2 + " " + " ".join(tail)
            else:  # XaXb / aXbX
                if gi >= D1:
                    one_id = gi - D1
                    xaxb = False
                else:
                    one_id = gi
                    xaxb = True
                pos = int(search1.position[one_id])
                number = int(enum1.number[pos])
                pat = enum1.pattern[pos]
                parts = [X1] if xaxb else []
                for jj in range(number):
                    p = int(pat[jj])
                    if p >= 0:
                        cur_ids.append(p)
                        parts.append(source.vocab.id_to_word[p])
                    else:
                        parts.append(X2 if xaxb else X1)
                if not xaxb:
                    parts.append(X2)
                cur_src = " ".join(parts)
        cid = converted(i)
        ts = int(rules2.ref_str_start[i])
        te = ts + int(rules2.end[i])
        g1s = ts + int(rules2.gap1[i])
        g1e = ts + int(rules2.gap1_1[i])
        g2s = ts + int(rules2.gap2[i])
        g2e = ts + int(rules2.gap2_1[i])
        tgt = _gap_target(target, ts, te, g1s, g1e, g2s, g2e)
        idx = dedup.get(tgt)
        if idx is None:
            dedup[tgt] = len(rules)
            tasks.append(LexTask(
                fast_speed_id=len(rules), source_pattern=list(cur_ids),
                target_start=ts, end=int(rules2.end[i]),
                gap1=int(rules2.gap1[i]), gap1_1=int(rules2.gap1_1[i]),
                gap2=int(rules2.gap2[i]), gap2_1=int(rules2.gap2_1[i]),
                kind="twogap"))
            if i < sep1:
                fs = 1 + int(blocks.end[gi]) - int(blocks.start[gi])
            elif i < sep2:
                fs = (1 + int(search2.end_on_salist[gi])
                      - int(search2.start_on_salist[gi]))
            else:
                rid = gi - D1 if gi >= D1 else gi
                fs = (1 + int(search1.end_on_salist[rid])
                      - int(search1.start_on_salist[rid]))
                if fs == 1 and int(onegap_sa.length[int(search1.start_on_salist[rid])]) == 0:
                    pci = int(onegap_sa.str_position[int(search1.start_on_salist[rid])])
                    fs = (1 - int(pc.index_start[pci]) + int(pc.index_end[pci])
                          + int(pc.feature_missing[pci]))
            if cfg.is_sample and fs > cfg.sampler:
                fs = cfg.sampler
            rules.append(FastSpeed(
                blocknumber=cid, lexical=cur_src + " ||| " + tgt, fsample=fs,
                fsample_score=_fsample_score(fs), f=int(fsample_arr[cid]),
                paircount=1))
        else:
            rules[idx].paircount += 1
    _finish_aa_bb(rules)
    return rules


def updown_index(rules, total_ids: int) -> np.ndarray:
    """First/last rule index per id (globalOnPairsUpDown*, ExtractPair.cu:3743-3756);
    [:, 0] = down (first), [:, 1] = up (last); -1 when absent."""
    bn = np.array([r.blocknumber for r in rules], np.int64)
    out = np.full((total_ids, 2), -1, dtype=np.int64)
    if len(bn):
        ids, first = np.unique(bn, return_index=True)
        out[ids, 0] = first
        ids_r, first_r = np.unique(bn[::-1], return_index=True)
        out[ids_r, 1] = len(bn) - 1 - first_r
    return out
