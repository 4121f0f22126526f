"""Host stage: lexicon build (dedup + counts + rule strings + features).

Mirrors createLexiconFast / createLexiconGappyFast / createLexiconTwoGapFast
(ExtractPair.c:515-1276) and the per-id up/down print index (extractGlobalPairsUpDown
+ host scans at ExtractPair.cu:3743-3756, 3810-3816).  A copy of
``cgx_tpu/features/lexicon.py``: the oracle spec's ``create_lexicon_*`` loops
and the vectorized path the pipeline runs; all the float32 conventions of
DESIGN.md live here.
"""

from __future__ import annotations

import dataclasses as _dc

import numpy as np

from cgx_tpu_torch.config import ExtractorConfig
from cgx_tpu_torch.preproc.corpus import SourceCorpus, TargetCorpus
from cgx_tpu_torch.types import (Blocks, ContigRules, FastSpeed, GapOnSA,
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


@_dc.dataclass
class RuleTable:
    """Distinct scored rules as struct-of-arrays (red_dup_t, ComTypes.h:244-255,
    as dense columns instead of per-rule objects; the object-per-rule form,
    ``FastSpeed``, only survives in the oracle spec above)."""

    blocknumber: np.ndarray    # int64 [n] converted print id
    lexical: list              # [n] "src ||| tgt" strings
    fsample: np.ndarray        # int64 [n] clamped sample size
    fsample_score: np.ndarray  # float32 [n]
    f: np.ndarray              # int64 [n] pre-dedup instance count per id
    paircount: np.ndarray      # int64 [n]
    aa: np.ndarray             # float32 [n]
    bb: np.ndarray             # float32 [n]
    max_lex_fge: np.ndarray    # float32 [n]
    max_lex_egf: np.ndarray    # float32 [n]

    def __len__(self) -> int:
        return len(self.lexical)

    @classmethod
    def from_fastspeed(cls, rules) -> "RuleTable":
        """Convert a FastSpeed list (oracle spec output) to columns."""
        n = len(rules)
        return cls(
            blocknumber=np.array([r.blocknumber for r in rules], np.int64),
            lexical=[r.lexical for r in rules],
            fsample=np.array([r.fsample for r in rules], np.int64),
            fsample_score=np.array([r.fsample_score for r in rules],
                                   np.float32),
            f=np.array([r.f for r in rules], np.int64),
            paircount=np.array([r.paircount for r in rules], np.int64),
            aa=np.array([r.aa for r in rules], np.float32),
            bb=np.array([r.bb for r in rules], np.float32),
            max_lex_fge=np.array([r.max_lex_fge for r in rules], np.float32)
            if n else np.empty(0, np.float32),
            max_lex_egf=np.array([r.max_lex_egf for r in rules], np.float32)
            if n else np.empty(0, np.float32))



def updown_index(rules, total_ids: int) -> np.ndarray:
    """First/last rule index per id (globalOnPairsUpDown*, ExtractPair.cu:3743-3756);
    [:, 0] = down (first), [:, 1] = up (last); -1 when absent."""
    bn = (rules.blocknumber if isinstance(rules, RuleTable)
          else np.array([r.blocknumber for r in rules], np.int64))
    out = np.full((total_ids, 2), -1, dtype=np.int64)
    if len(bn):
        ids, first = np.unique(bn, return_index=True)
        out[ids, 0] = first
        ids_r, first_r = np.unique(bn[::-1], return_index=True)
        out[ids_r, 1] = len(bn) - 1 - first_r
    return out


# ---------------------------------------------------------------------------
# Vectorized lexicon build.
#
# Same observable semantics as the JAX package's create_lexicon_* loops (the
# oracle spec): dedup is by the rendered rule string, which is equivalent to a numeric key of the
# target token sequence with each gap span collapsed to a single marker (-1 for
# [X,1], -3 for [X,2]) plus the converted rule id (group boundaries are id
# boundaries).  Counts/fsample/feature plumbing identical; strings are built only
# for distinct rules.
#
# Feature math (fsample clamp, f, paircount, aa/bb/fsample_score in the exact
# float32 convention of DESIGN.md) and the MaxLex task fields are computed as
# numpy arrays over the distinct-rule axis; only rule-string rendering stays in a
# Python loop.  The fast functions return (rules, TaskArrays) — the TaskArrays rows
# are the family's distinct rules in order (fast_speed_id == row index).
# ---------------------------------------------------------------------------

KEYW = 16  # max rendered target symbols (span < max_rule_span)
SRCW = 5   # max source words per rule (MAX_rule_symbols)


@_dc.dataclass
class TaskArrays:
    """Dense MaxLex work items for one rule family (lexicalTask,
    ComTypes.h:376-389): row d scores the family's distinct rule d."""

    src_pat: np.ndarray   # int32 [n, SRCW], -99 pad
    t0: np.ndarray        # int32 [n] target start
    tend: np.ndarray      # int32 [n] offset of last target token
    g1: np.ndarray        # int32 [n] gap offsets rel. t0; -1 = none
    g11: np.ndarray
    g2: np.ndarray
    g21: np.ndarray


def _compact_pattern_rows(pat):
    """Left-compact the >=0 token ids of enumeration pattern rows
    (gaps -1 / pads -2 dropped), -99 padding."""
    pat = pat[:, :SRCW] if pat.shape[1] >= SRCW else np.concatenate(
        [pat, np.full((len(pat), SRCW - pat.shape[1]), -2, pat.dtype)], axis=1)
    valid = pat >= 0
    order = np.argsort(~valid, axis=1, kind="stable")
    comp = np.take_along_axis(pat, order, axis=1).astype(np.int32)
    comp[~np.take_along_axis(valid, order, axis=1)] = -99
    return comp


def _block_pattern_rows(source, blocks, bids):
    """Source token ids of contiguous blocks as [n, SRCW] rows."""
    refstr = np.asarray(source.str_)
    ss = blocks.string_start[bids].astype(np.int64, copy=False)
    ml = blocks.matchlen[bids].astype(np.int64, copy=False)
    pos = ss[:, None] + np.arange(SRCW)
    m = np.arange(SRCW)[None, :] < ml[:, None]
    return np.where(m, refstr[np.clip(pos, 0, len(refstr) - 1)],
                    -99).astype(np.int32)


def _target_key_rows(tgt_str, ts, te, g1s=None, g1e=None, g2s=None, g2e=None):
    """[n, KEYW] numeric rendering keys; gaps collapse to one marker.

    Runs in fixed-size chunks over preallocated buffers (every elementwise op
    lands in an ``out=`` buffer): the straightforward whole-array expression
    allocated ~15 fresh [n, KEYW] temporaries per call, and at 512-query scale
    (n in the hundreds of thousands) fresh-page faults made this one function
    >50% of the whole two-gap lexicon family on this host."""
    n = len(ts)
    i32 = np.int32
    ts = ts.astype(i32, copy=False)
    te = te.astype(i32, copy=False)
    gaps = [(gs.astype(i32, copy=False), ge.astype(i32, copy=False), marker)
            for gs, ge, marker in ((g1s, g1e, -1), (g2s, g2e, -3))
            if gs is not None]
    tgt = tgt_str.astype(i32, copy=False)
    key = np.full((n, KEYW + 1), -2, dtype=i32)
    if not n:
        return key[:, :KEYW]
    C = 131072
    ar = np.arange(KEYW, dtype=i32)[None, :]
    m = min(n, C)
    pos = np.empty((m, KEYW), i32)
    emit = np.empty((m, KEYW), bool)
    tok = np.empty((m, KEYW), i32)
    oidx = np.empty((m, KEYW), i32)
    b1 = np.empty((m, KEYW), bool)
    b2 = np.empty((m, KEYW), bool)
    t1 = np.empty((m, KEYW), i32)
    for s in range(0, n, C):
        e = min(s + C, n)
        c = e - s
        P, E, T, O = pos[:c], emit[:c], tok[:c], oidx[:c]
        B1, B2, T1 = b1[:c], b2[:c], t1[:c]
        np.add(ts[s:e, None], ar, out=P)
        np.less_equal(P, te[s:e, None], out=E)
        np.clip(P, 0, len(tgt) - 1, out=T1)
        np.take(tgt, T1, out=T)
        np.subtract(P, ts[s:e, None], out=O)
        for gs, ge, marker in gaps:
            G1 = gs[s:e, None]
            G2 = ge[s:e, None]
            np.greater_equal(P, G1, out=B1)
            np.less_equal(P, G2, out=B2)
            np.logical_and(B1, B2, out=B1)          # B1 = inside-gap
            np.copyto(T, i32(marker), where=B1)
            np.equal(P, G1, out=B2)                 # B2 = gap start
            np.logical_not(B1, out=B1)
            np.logical_or(B1, B2, out=B1)           # keep: ~ing | (pos==gs)
            np.logical_and(E, B1, out=E)
            np.greater(P, G2, out=B2)               # past the gap: shift left
            np.multiply(B2, np.subtract(ge[s:e], gs[s:e])[:, None],
                        out=T1, casting="unsafe")
            np.subtract(O, T1, out=O)
        np.minimum(O, KEYW - 1, out=O)
        np.copyto(T1, i32(KEYW))
        np.copyto(T1, O, where=E)                   # T1 = slot index (dump=KEYW)
        np.copyto(P, i32(-2))
        np.copyto(P, T, where=E)                    # P = value (-2 off-emit)
        np.put_along_axis(key[s:e], T1, P, axis=1)
    return key[:, :KEYW]


def _dedup(cid, key_rows):
    """Group+dedup by (cid, key); returns (uniq_first_idx sorted by appearance,
    inverse mapping instance->distinct, counts).  Key columns are paired into
    int64 words and grouped with one stable lexsort over the word columns +
    vectorized adjacent-row comparison — np.unique(axis=0)'s void-record sort
    memcmp-compares 72-byte records per swap and was ~4x slower at
    512-query scale.  Row sort order is irrelevant (appearance order is
    restored below); stability makes each group's first sorted element its
    earliest instance, exactly like np.unique's return_index."""
    n = len(cid)
    full = np.concatenate([cid[:, None].astype(np.int32),
                           key_rows.astype(np.int32, copy=False)], axis=1)
    if full.shape[1] % 2:
        full = np.concatenate(
            [full, np.zeros((len(full), 1), np.int32)], axis=1)
    packed = np.ascontiguousarray(full).view(np.int64)
    # constant columns (trailing pad words, single-symbol corpora) can't
    # split groups: drop them before paying a radix pass + gather each
    cols = [c for k in range(packed.shape[1])
            for c in [packed[:, k]]
            if n == 0 or c[0] != c[-1] or (c != c[0]).any()]
    if not cols:
        cols = [packed[:, 0]] if packed.shape[1] else [np.zeros(n, np.int64)]
    perm = np.lexsort(cols[::-1])           # stable; primary key = column 0
    neq = np.zeros(n - 1, dtype=bool) if n else np.zeros(0, dtype=bool)
    for c in cols:
        cs = c[perm]
        np.logical_or(neq, cs[1:] != cs[:-1], out=neq)
    new = np.empty(n, dtype=bool)
    if n:
        new[0] = True
        new[1:] = neq
    starts = np.flatnonzero(new)
    first = perm[starts]                    # earliest instance per group
    counts = np.diff(np.concatenate([starts, [n]]))
    gid_sorted = np.cumsum(new) - 1
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = gid_sorted
    # appearance order (matches the previous np.unique-based contract)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return first[order], rank[inv], counts[order]


def _dedup_spans_native(lib, cid, tgt_str, ts, end, g1, g11, g2, g21):
    """One-pass native hash dedup (cgx_dedup_rules): the uthash grouping of
    createLexicon*Fast (ExtractPair.c:548-556) with the key rendering fused
    in — groups discovered in first-appearance order, no sorts and no
    [n, KEYW] intermediate.  Same (first_idx, counts, keys_d) contract as the
    numpy path below."""
    import ctypes
    n = len(cid)
    i64 = np.int64
    c = np.ascontiguousarray(cid, i64)
    t = np.ascontiguousarray(ts, i64)
    e = np.ascontiguousarray(end, i64)
    tgt = np.ascontiguousarray(tgt_str, np.int32)
    i64p = ctypes.POINTER(ctypes.c_int64)

    def p64(a):
        return a.ctypes.data_as(i64p) if a is not None else None

    gaps = [None if g is None else np.ascontiguousarray(g, i64)
            for g in (g1, g11, g2, g21)]
    out_first = np.empty(n, i64)
    out_counts = np.empty(n, i64)
    out_keys = np.empty((n, KEYW), np.int32)
    nd = lib.cgx_dedup_rules(
        p64(c), p64(t), p64(e), *(p64(g) for g in gaps), int(n),
        tgt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), int(len(tgt)),
        p64(out_first), p64(out_counts),
        out_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out_first[:nd], out_counts[:nd], out_keys[:nd]


def _dedup_spans(cid, tgt_str, ts, end, g1=None, g11=None, g2=None, g21=None):
    """Two-stage (cid, rendered target key) dedup.

    The rendered key row is a pure function of (cid, ts, end, gap offsets), so
    identical tuples are grouped first with one packed-int64 lexsort — far
    cheaper than building [n, KEYW] key rows — and the rendering + row-dedup
    run only on tuple representatives (distinct tuples can still render equal
    rows, e.g. equal token spans at different positions, so the second stage
    keeps exact reference semantics).  Returns (first_idx, counts, keys_d):
    the global first-appearance instance per distinct rule, its duplicate
    count, and the distinct rendered key rows, in appearance order."""
    n = len(cid)
    ts = ts.astype(np.int64, copy=False)
    end = end.astype(np.int64, copy=False)
    if n:
        from cgx_tpu_torch.preproc.native_build import load_native
        lib = load_native()
        if lib is not None:
            return _dedup_spans_native(lib, cid, tgt_str, ts, end,
                                       g1, g11, g2, g21)
    minus1 = np.full(n, -1, np.int64)
    gs = [(g.astype(np.int64, copy=False) if g is not None else minus1)
          for g in (g1, g11, g2, g21)]
    # 5-bit offset fields (+1 bias) are collision-free while every offset is
    # in [-1, 30] — the state machines emit end in [0, 15] and gap offsets in
    # [-1, 15] (max_rule_span <= 15, validated by ExtractorConfig); guard the
    # packing width against a future relaxation of that bound
    if n:
        assert all(int(x.min()) >= -1 and int(x.max()) <= 30
                   for x in (end, *gs)), \
            "_dedup_spans 5-bit packing requires offsets in [-1, 30]"
    w2 = (end + 1) | ((gs[0] + 1) << 5) | ((gs[1] + 1) << 10) \
        | ((gs[2] + 1) << 15) | ((gs[3] + 1) << 20)
    cid = cid.astype(np.int64, copy=False)
    b_ts = int(ts.max()).bit_length() if n else 1
    b_cid = int(cid.max()).bit_length() if n else 1
    if b_cid + b_ts + 25 <= 63:
        # one stable argsort of a single packed key: ~2x cheaper than the
        # 2-key lexsort, and stability makes each group's first sorted
        # element the earliest instance (no group-min reduction needed)
        key = (cid << (b_ts + 25)) | (ts << 25) | w2
        order = np.argsort(key, kind="stable")
        sk = key[order]
        new = np.empty(n, bool)
        new[0] = True
        new[1:] = sk[1:] != sk[:-1]
    else:
        w1 = (cid << 32) | ts
        order = np.lexsort((w2, w1))    # stable
        sw1 = w1[order]
        sw2 = w2[order]
        new = np.empty(n, bool)
        new[0] = True
        new[1:] = (sw1[1:] != sw1[:-1]) | (sw2[1:] != sw2[:-1])
    starts = np.flatnonzero(new)
    first = order[starts]               # stable sort => earliest instance
    c1 = np.diff(np.concatenate([starts, [n]]))
    rord = np.argsort(first, kind="stable")          # appearance order
    rep_idx = first[rord]
    c1 = c1[rord]
    keys_rep = _target_key_rows(
        tgt_str, ts[rep_idx], ts[rep_idx] + end[rep_idx],
        *(None if g is None else ts[rep_idx] + g[rep_idx]
          for g in (g1, g11, g2, g21)))
    first2, inv2, _ = _dedup(cid[rep_idx], keys_rep)
    counts = np.bincount(inv2, weights=c1.astype(np.float64)).astype(np.int64)
    return rep_idx[first2], counts, keys_rep[first2]


def _render_targets(target: TargetCorpus, key_rows) -> list:
    """Batch _render_target: object-array symbol lookup + per-row join."""
    idw = target.vocab.id_to_word
    ext = np.empty(len(idw) + 3, dtype=object)
    ext[3:] = idw
    ext[0] = X2        # marker -3
    ext[1] = ""        # pad -2 (cut below)
    ext[2] = X1        # marker -1
    words = ext[key_rows + 3]
    pad = key_rows == -2
    n = np.where(pad.any(axis=1), pad.argmax(axis=1), key_rows.shape[1])
    return [" ".join(w[:c]) for w, c in zip(words, n)]


def _finalize_fast(cids, first_idx, counts, fsample_arr, fs_dist, src_of,
                   keys_d, target, cfg):
    """Distinct-rule finalization with vectorized feature math: fsample clamp,
    SampleCountF/CountEF/EgivenFCoherent in the reference's float32 order.
    ``keys_d``: the distinct rendered key rows (row d = distinct rule d)."""
    cid_d = cids[first_idx].astype(np.int64, copy=False)
    fs = fs_dist.astype(np.int64, copy=False)
    if cfg.is_sample:
        fs = np.minimum(fs, cfg.sampler)
    fscore = np.log10((1 + fs).astype(np.float64)).astype(np.float32)
    pc = counts.astype(np.int64, copy=False)
    ratio = pc.astype(np.float32) / fs.astype(np.float32)
    aa = (-np.log10(ratio)).astype(np.float32)
    bb = np.log10((1 + pc).astype(np.float64)).astype(np.float32)
    f_arr = fsample_arr[cid_d]
    tgt_strs = _render_targets(target, keys_d)
    n = len(first_idx)
    z = np.zeros(n, np.float32)
    # the source name is a pure function of the pattern id (cid) — build each
    # once and index, instead of n python-call + dict-lookup round trips
    uc, ufirst, uinv = np.unique(cid_d, return_index=True,
                                 return_inverse=True)
    names = [src_of(int(first_idx[k])) for k in ufirst]
    return RuleTable(
        blocknumber=cid_d,
        lexical=[names[j] + " ||| " + t
                 for j, t in zip(uinv, tgt_strs)],
        fsample=fs.astype(np.int64, copy=False), fsample_score=fscore,
        f=f_arr.astype(np.int64, copy=False),
        paircount=pc,
        aa=aa, bb=bb, max_lex_fge=z, max_lex_egf=z.copy())


def _empty_rules() -> RuleTable:
    z64 = np.empty(0, np.int64)
    z32 = np.empty(0, np.float32)
    return RuleTable(blocknumber=z64, lexical=[], fsample=z64,
                     fsample_score=z32, f=z64, paircount=z64, aa=z32, bb=z32,
                     max_lex_fge=z32, max_lex_egf=z32)


def _empty_tasks():
    z = np.empty(0, np.int32)
    return TaskArrays(src_pat=np.empty((0, SRCW), np.int32), t0=z, tend=z,
                      g1=z, g11=z, g2=z, g21=z)


def fast_create_lexicon_contig(contig: ContigRules, source: SourceCorpus,
                               target: TargetCorpus, blocks: Blocks,
                               cfg: ExtractorConfig):
    """Vectorized createLexiconFast (ExtractPair.c:515-662)."""
    G = len(blocks.start)
    n = len(contig.blocknumber)
    if n == 0:
        return _empty_rules(), _empty_tasks()
    cid = contig.blocknumber.astype(np.int64, copy=False)
    fsample_arr = np.bincount(cid, minlength=G)
    ts = contig.tar_start.astype(np.int64, copy=False)
    first_idx, counts, keys_d = _dedup_spans(
        cid, np.asarray(target.str_), ts,
        contig.tar_end.astype(np.int64, copy=False))
    cid_d = cid[first_idx]
    fs_dist = 1 + blocks.end[cid_d].astype(np.int64, copy=False) \
        - blocks.start[cid_d].astype(np.int64, copy=False)
    src_names = {}

    def src_of(i):
        b = int(cid[i])
        if b not in src_names:
            src_names[b] = _source_name(source, blocks, b)
        return src_names[b]

    nd = len(first_idx)
    m1 = np.full(nd, -1, np.int32)
    tasks = TaskArrays(
        src_pat=_block_pattern_rows(source, blocks, cid_d),
        t0=ts[first_idx].astype(np.int32),
        tend=contig.tar_end[first_idx].astype(np.int32, copy=False),
        g1=m1, g11=m1, g2=m1, g21=m1)
    rules = _finalize_fast(cid, first_idx, counts, fsample_arr, fs_dist,
                           src_of, keys_d, target, cfg)
    return rules, tasks


def _onegap_fs_dist(search1, onegap_sa, pc, oid):
    """Vectorized per-distinct-pattern sample size with the precomp
    feature_missing correction (ExtractPair.c:899-908)."""
    so = search1.start_on_salist[oid].astype(np.int64, copy=False)
    eo = search1.end_on_salist[oid].astype(np.int64, copy=False)
    fs = 1 + eo - so
    if len(onegap_sa.length):
        soc = np.clip(so, 0, len(onegap_sa.length) - 1)
        pcmode = (fs == 1) & (onegap_sa.length[soc] == 0)
        pci = np.clip(onegap_sa.str_position[soc].astype(np.int64, copy=False),
                      0, len(pc.index_start) - 1)
        fs_pc = (1 - pc.index_start[pci].astype(np.int64, copy=False)
                 + pc.index_end[pci].astype(np.int64, copy=False)
                 + pc.feature_missing[pci].astype(np.int64, copy=False))
        fs = np.where(pcmode, fs_pc, fs)
    return fs


def fast_create_lexicon_onegap(rules1: GapRules, source: SourceCorpus,
                               target: TargetCorpus, blocks: Blocks,
                               search1: OneGapSearch, enum1: OneGapEnum,
                               onegap_sa: GapOnSA, pc: Precomp, separator: int,
                               cfg: ExtractorConfig):
    """Vectorized createLexiconGappyFast (ExtractPair.c:664-936)."""
    G = len(blocks.start)
    D1 = len(search1.qrystart)
    n = len(rules1.gappy_index)
    if n == 0:
        return _empty_rules(), _empty_tasks()
    gi = rules1.gappy_index.astype(np.int64, copy=False)
    seg2 = np.arange(n) >= separator
    cid = np.where(seg2, 2 * G + gi, gi)
    fsample_arr = np.bincount(cid, minlength=2 * G + D1)
    ts = rules1.ref_str_start.astype(np.int64, copy=False)
    first_idx, counts, keys_d = _dedup_spans(
        cid, np.asarray(target.str_), ts, rules1.end,
        rules1.gap1, rules1.gap1_1)

    seg2_d = seg2[first_idx]
    gi_d = gi[first_idx]
    base_d = np.where(gi_d < G, gi_d, gi_d - G)
    if G:
        base_c = np.clip(base_d, 0, G - 1)
        fs_blk = 1 + blocks.end[base_c].astype(np.int64, copy=False) \
            - blocks.start[base_c].astype(np.int64, copy=False)
    else:  # no contiguous blocks: every row is a seg2 (aXb) rule
        base_c = base_d
        fs_blk = np.zeros(len(first_idx), dtype=np.int64)
    oid_c = np.clip(gi_d, 0, max(D1 - 1, 0))
    fs_gap = _onegap_fs_dist(search1, onegap_sa, pc, oid_c) if D1 else fs_blk
    fs_dist = np.where(seg2_d, fs_gap, fs_blk)

    if len(enum1.number):
        pos_c = np.clip(search1.position[oid_c].astype(np.int64, copy=False),
                        0, len(enum1.number) - 1)
        pat_rows = _compact_pattern_rows(enum1.pattern[pos_c])
    else:   # no one-gap patterns (the block half alone): every row is seg1
        pat_rows = np.full((len(first_idx), SRCW), -99, np.int32)
    src_pat = np.where(seg2_d[:, None], pat_rows,
                       _block_pattern_rows(source, blocks, base_c)
                       if G else pat_rows)
    m1 = np.full(len(first_idx), -1, np.int32)
    tasks = TaskArrays(
        src_pat=src_pat, t0=ts[first_idx].astype(np.int32),
        tend=rules1.end[first_idx].astype(np.int32, copy=False),
        g1=rules1.gap1[first_idx].astype(np.int32, copy=False),
        g11=rules1.gap1_1[first_idx].astype(np.int32, copy=False),
        g2=m1, g21=m1)

    src_cache = {}

    def src_of(i):
        c = int(cid[i])
        if c not in src_cache:
            if i < separator:
                if c < G:
                    src_cache[c] = X1 + " " + _source_name(source, blocks, c)
                else:
                    src_cache[c] = _source_name(source, blocks, c - G) + " " + X1
            else:
                src_cache[c] = _onegap_source(search1, enum1, int(gi[i]),
                                              source)[0]
        return src_cache[c]

    rules = _finalize_fast(cid, first_idx, counts, fsample_arr, fs_dist,
                           src_of, keys_d, target, cfg)
    return rules, tasks


def fast_create_lexicon_twogap(rules2: GapRules, source: SourceCorpus,
                               target: TargetCorpus, blocks: Blocks,
                               search1: OneGapSearch, enum1: OneGapEnum,
                               search2: TwoGapSearch, enum2: TwoGapEnum,
                               onegap_sa: GapOnSA, pc: Precomp,
                               sep1: int, sep2: int,
                               cfg: ExtractorConfig):
    """Vectorized createLexiconTwoGapFast (ExtractPair.c:939-1276)."""
    G = len(blocks.start)
    D1 = len(search1.qrystart)
    D2 = len(search2.blockid)
    n = len(rules2.gappy_index)
    if n == 0:
        return _empty_rules(), _empty_tasks()
    gi = rules2.gappy_index.astype(np.int64, copy=False)
    idx = np.arange(n)
    cid = np.where(idx < sep1, gi,
                   np.where(idx < sep2, G + gi, G + D2 + gi))
    fsample_arr = np.bincount(cid, minlength=G + 2 * D1 + D2)
    ts = rules2.ref_str_start.astype(np.int64, copy=False)
    first_idx, counts, keys_d = _dedup_spans(
        cid, np.asarray(target.str_), ts, rules2.end,
        rules2.gap1, rules2.gap1_1, rules2.gap2, rules2.gap2_1)

    # distinct-rule segments + fsample
    gi_d = gi[first_idx]
    segA = first_idx < sep1                      # XabX by block
    segB = (first_idx >= sep1) & (first_idx < sep2)  # aXbXc by twoId
    if G:
        blk_c = np.clip(gi_d, 0, G - 1)
        fsA = 1 + blocks.end[blk_c].astype(np.int64, copy=False) \
            - blocks.start[blk_c].astype(np.int64, copy=False)
    else:  # no contiguous blocks: segA is empty
        blk_c = gi_d
        fsA = np.zeros(len(first_idx), dtype=np.int64)
    two_c = np.clip(gi_d, 0, max(D2 - 1, 0))
    fsB = (1 + search2.end_on_salist[two_c].astype(np.int64, copy=False)
           - search2.start_on_salist[two_c].astype(np.int64, copy=False)) \
        if D2 else fsA
    rid = np.where(gi_d >= D1, gi_d - D1, gi_d)
    rid_c = np.clip(rid, 0, max(D1 - 1, 0))
    fsC = _onegap_fs_dist(search1, onegap_sa, pc, rid_c) if D1 else fsA
    fs_dist = np.where(segA, fsA, np.where(segB, fsB, fsC))

    # task source patterns per segment
    nd = len(first_idx)
    if len(enum1.number):
        pos1 = np.clip(search1.position[rid_c].astype(np.int64, copy=False),
                       0, len(enum1.number) - 1)
        patC = _compact_pattern_rows(enum1.pattern[pos1])
    else:
        patC = np.full((nd, SRCW), -99, np.int32)
    src_pat = np.where(segA[:, None],
                       _block_pattern_rows(source, blocks, blk_c)
                       if G else patC, patC)
    if D2 and segB.any():
        one_of_two = np.clip(
            search2.blockid[two_c].astype(np.int64, copy=False), 0,
            max(D1 - 1, 0))
        posB = np.clip(search1.position[one_of_two].astype(np.int64,
                                                           copy=False),
                       0, len(enum1.number) - 1)
        patB = _compact_pattern_rows(enum1.pattern[posB])
        pos2 = np.clip(search2.position[two_c].astype(np.int64, copy=False),
                       0, max(len(enum2.number) - 1, 0))
        ncore = (patB != -99).sum(axis=1)
        num2 = enum2.number[pos2].astype(np.int64, copy=False)
        for jj in range(enum2.pattern.shape[1]):
            have = jj < num2
            col = np.clip(ncore + jj, 0, SRCW - 1)
            vals = enum2.pattern[pos2, jj]
            rowsel = segB & have
            patB[np.arange(nd)[rowsel], col[rowsel]] = vals[rowsel]
        src_pat = np.where(segB[:, None], patB, src_pat)
    tasks = TaskArrays(
        src_pat=src_pat.astype(np.int32, copy=False),
        t0=ts[first_idx].astype(np.int32),
        tend=rules2.end[first_idx].astype(np.int32, copy=False),
        g1=rules2.gap1[first_idx].astype(np.int32, copy=False),
        g11=rules2.gap1_1[first_idx].astype(np.int32, copy=False),
        g2=rules2.gap2[first_idx].astype(np.int32, copy=False),
        g21=rules2.gap2_1[first_idx].astype(np.int32, copy=False))

    src_cache = {}

    def src_of(i):
        c = int(cid[i])
        if c in src_cache:
            return src_cache[c]
        g = int(gi[i])
        if i < sep1:  # XabX
            s = X1 + " " + _source_name(source, blocks, g) + " " + X2
        elif i < sep2:  # aXbXc
            one_id = int(search2.blockid[g])
            s0, _ = _onegap_source(search1, enum1, one_id, source)
            pos2 = int(search2.position[g])
            num2 = int(enum2.number[pos2])
            tail = [source.vocab.id_to_word[int(enum2.pattern[pos2][jj])]
                    for jj in range(num2)]
            s = s0 + " " + X2 + " " + " ".join(tail)
        else:  # XaXb / aXbX
            xaxb = g < D1
            one_id = g if xaxb else g - D1
            pos = int(search1.position[one_id])
            number = int(enum1.number[pos])
            pat = enum1.pattern[pos]
            parts = [X1] if xaxb else []
            for jj in range(number):
                pv = int(pat[jj])
                parts.append(source.vocab.id_to_word[pv] if pv >= 0
                             else (X2 if xaxb else X1))
            if not xaxb:
                parts.append(X2)
            s = " ".join(parts)
        src_cache[c] = s
        return s

    rules = _finalize_fast(cid, first_idx, counts, fsample_arr, fs_dist,
                           src_of, keys_d, target, cfg)
    return rules, tasks
