"""Pass 1 / pass 2 suffix-array search.

Port of ``cgx_tpu/search/passes.py``'s two single-device engines:

* the default, seeded interval refinement (``build_seed_tables``,
  ``seed_intervals``, ``drive_refinement``, ``refine_passes``).  For a query
  token, the SA interval of its length-(L+1) prefix is a sub-interval of its
  length-L interval, and within that interval the (L+1)-th suffix tokens are
  sorted, so each depth needs two integer lower-bound searches over
  ``refstr[sa[M] + L]``.  Depths 0-2 are answered on the host from seed
  tables; the device ladder (kernel A1, ``refine_chunk``) runs the deeper
  levels for the lanes still alive;
* the LCP-accelerated binary search (``pass1_lcp``, ``pass2_lcp``, kernel
  B1), a transcription of suffixArrayFindLwRwKernelTwoWayTDI (pass 1,
  SuffixArray.cu:402-767) and suffixArrayFindConnectionTwoWayTDI (pass 2,
  SuffixArray.cu:109-400) over the interval-LCP tree ``lcpleft/lcpright``:
  one lane per query token (pass 1) or per (token, match length) item
  (pass 2).  Its up/down/longestmatch equal the refinement's; pass 1 also
  returns the search's ``firstfindhit*`` window, which seeds pass 2.

The reference's SA-end boundary probe (COMP1, SuffixArray.cu:484-514) is
omitted: the corpus ends in a unique sentinel larger than every vocab id, so
``SA[reflen-1]`` is the sentinel suffix and the probe never matches
(``index.container.build_index`` checks that invariant).
"""

from __future__ import annotations

import numpy as np
import torch

from cgx_tpu_torch.kernels import build as kb
from cgx_tpu_torch.types import SEP, Pass1Result, Pass2Result
from cgx_tpu_torch.utils import batching
from cgx_tpu_torch.utils.views import take

QPAD = 8  # guarded out-of-range query reads return -2 (never matches anything)

# refinement depths per kernel launch: most lanes' intervals empty within a
# few depths, so the first launch stays shallow; survivors run 16 at a time
DEPTH_CHUNK = 4
DEPTH_CHUNK_DEEP = 16
DEPTH_LADDER_SWITCH = 6   # switch to deep chunks once depth >= this

# trigram seed packing budget: 3 x 21-bit token ids per int64 key.  Corpora
# whose id space (incl. the sentinel) exceeds this skip the depth-3 table and
# start the device ladder at depth 2.
SEED3_MAX_TOKEN = 1 << 21


def pad_query_tokens(tokens: np.ndarray) -> np.ndarray:
    return batching.pad_tokens(
        np.concatenate([tokens.astype(np.int32),
                        np.full(QPAD, -2, dtype=np.int32)]), np.int32(-2))


def pad_refstr(refstr: np.ndarray, qry_max: int) -> np.ndarray:
    """Pad so ``refsa[M] + longlen`` reads stay in-bounds (longlen <= qry_max)."""
    return np.concatenate([refstr.astype(np.int32),
                           np.zeros(qry_max + 16, dtype=np.int32)])


def build_seed_tables(refstr_padded: np.ndarray, sa_np: np.ndarray):
    """Host seed tables answering refinement depths 0-2: refstr[sa] is
    nondecreasing, so depth-1 intervals are bucket boundaries (exclusive
    bincount cumsum); packed (first << 32 | second) keys are globally sorted,
    so depth-2 intervals are one vectorized searchsorted; packed 21-bit
    trigram keys extend the same argument to depth 3 (id space permitting)."""
    first = refstr_padded[sa_np].astype(np.int64)      # nondecreasing
    second = refstr_padded[sa_np + 1].astype(np.int64)
    seed_pk = (first << 32) | second                   # globally sorted
    counts1 = np.bincount(first, minlength=int(first[-1]) + 2)
    seed_hi1 = np.cumsum(counts1, dtype=np.int64)
    seed_lo1 = seed_hi1 - counts1
    seed_pk3 = None
    if int(first[-1]) < SEED3_MAX_TOKEN:   # first[-1] = the sentinel (max id)
        third = refstr_padded[sa_np + 2].astype(np.int64)
        seed_pk3 = (first << 42) | (second << 21) | third
    return seed_lo1, seed_hi1, seed_pk, seed_pk3


def seed_intervals(seed_lo1, seed_hi1, seed_pk, seed_pk3, reflen,
                   v0, v1, v2, sls):
    """Depth-0/1/2 refinement intervals from the host seed tables, bit-equal
    to what the device refinement would compute at those depths (an exhausted
    lane collapses to [prev_lo, prev_lo)).  The depth-3 pair is (None, None)
    when the trigram table is absent."""
    nv = len(seed_lo1) - 1
    ok0 = (v0 >= 0) & (v0 < nv)
    v0c = np.clip(v0, 0, nv - 1)
    # depth 0: token bucket; v0 < 0 -> [0, 0); v0 >= nv -> [reflen, reflen)
    lo1 = np.where(ok0, seed_lo1[v0c], np.where(v0 < 0, 0, reflen))
    hi1 = np.where(ok0, seed_hi1[v0c], np.where(v0 < 0, 0, reflen))
    # depth 1: packed-key searchsorted; collapses to [lo1, lo1) when the lane
    # is past the query end (sl < 2), the bucket is empty, or v1 is OOV
    key = (v0c.astype(np.int64) << 32) | np.clip(v1, 0, None).astype(np.int64)
    ext = ok0 & (sls >= 2) & (hi1 > lo1) & (v1 >= 0)
    lo2 = np.where(ext, np.searchsorted(seed_pk, key, side="left"), lo1)
    hi2 = np.where(ext, np.searchsorted(seed_pk, key, side="right"), lo1)
    if seed_pk3 is None:
        lo3 = hi3 = None
    else:
        key3 = (v0c.astype(np.int64) << 42) \
            | (np.clip(v1, 0, None).astype(np.int64) << 21) \
            | np.clip(v2, 0, None).astype(np.int64)
        ext3 = ext & (sls >= 3) & (hi2 > lo2) & (v2 >= 0)
        lo3 = np.where(ext3, np.searchsorted(seed_pk3, key3, side="left"),
                       lo2).astype(np.int32)
        hi3 = np.where(ext3, np.searchsorted(seed_pk3, key3, side="right"),
                       lo2).astype(np.int32)
    return (lo1.astype(np.int32), hi1.astype(np.int32),
            lo2.astype(np.int32), hi2.astype(np.int32), lo3, hi3)


def refine_chunk_plain(sa, refstr, qtok, toks, sls, lo, hi, d0: int,
                       depths: int, need: dict = None):
    """Plain PyTorch version of kernel A1, vectorized over lanes like the JAX
    ``vmap``: each lower-bound search iterates until every lane converged,
    updating only the lanes still searching.  Given a ``need`` dict, it
    also records what each bisection step reads (``tools/reads.py``
    ``refine_need``): per array, (positions, needed) pairs of [n] tensors
    (``sa``: the rows, ``refstr``: the key positions, ``qtok``: each
    depth's query token, needed where the depth is inside the query and
    the interval is not empty)."""
    def lower_bound(l, h, key, depth):
        while True:
            act = h > l
            if not bool(act.any()):
                return l
            M = (l + h) >> 1
            pos = take(sa, M) + depth
            if need is not None:
                need.setdefault("sa", []).append((M, act))
                need.setdefault("refstr", []).append((pos, act))
            t = take(refstr, pos)
            ge = t >= key
            l = torch.where(act & ~ge, M + 1, l)
            h = torch.where(act & ge, M, h)

    ups, downs = [], []
    for c in range(depths):
        depth = d0 + c
        qt = torch.where(depth < sls, take(qtok, toks + depth),
                         torch.full_like(toks, -1))
        if need is not None:
            need.setdefault("qtok", []).append((toks + depth,
                                                (depth < sls) & (hi > lo)))
        nlo = lower_bound(lo, hi, qt, depth)
        nhi = lower_bound(nlo, hi, qt + 1, depth)
        ups.append(nlo)
        downs.append(nhi - 1)
        lo, hi = nlo, nhi
    return (torch.stack(ups, dim=1), torch.stack(downs, dim=1), lo, hi)


def refine_chunk(sa, refstr, qtok, toks, sls, lo, hi, d0: int, depths: int):
    """Kernel A1 (``csrc/refine.cu``): ``depths`` refinement levels starting
    at depth ``d0`` for every lane (query token ``toks[i]`` with remaining
    length ``sls[i]`` and SA interval ``[lo[i], hi[i])``).  Returns
    (ups, downs) int32 [n, depths] and the final (lo, hi) int32 [n].

    Replaces ``_refine_chunk_local`` (cgx_tpu/search/passes.py:371).  On
    CUDA tensors it launches the kernel; on CPU tensors it runs
    ``refine_chunk_plain``."""
    device = toks.device
    if not kb.route("A1", device):
        return refine_chunk_plain(sa, refstr, qtok, toks, sls, lo, hi, d0,
                                  depths)
    kb.check_inputs("A1", device, torch.int32, sa=sa, refstr=refstr,
                    qtok=qtok, toks=toks, sls=sls, lo=lo, hi=hi)
    n = toks.shape[0]
    if not (sls.shape[0] == lo.shape[0] == hi.shape[0] == n):
        raise ValueError("A1: lane arrays differ in length")
    ups = torch.empty((n, depths), dtype=torch.int32, device=device)
    downs = torch.empty_like(ups)
    lo_out = torch.empty(n, dtype=torch.int32, device=device)
    hi_out = torch.empty_like(lo_out)
    if n:
        lib = kb.library("refine")
        kb.check("refine", lib.cgx_refine(
            kb.ptr(sa), sa.shape[0], kb.ptr(refstr), refstr.shape[0],
            kb.ptr(qtok), qtok.shape[0], kb.ptr(toks), kb.ptr(sls),
            kb.ptr(lo), kb.ptr(hi), n, d0, depths, kb.ptr(ups),
            kb.ptr(downs), kb.ptr(lo_out), kb.ptr(hi_out), kb.stream(device)))
        kb.LAUNCHES["A1"] += 1
    return ups, downs, lo_out, hi_out


# ---------------------------------------------------------------------------
# LCP-accelerated pass 1 / pass 2 (kernel B1)
# ---------------------------------------------------------------------------
# Plain versions: every lane of the JAX vmap is one row, and each JAX
# while_loop is a Python loop that runs until no lane is active, updating
# only the active lanes.
#
# Given a ``need`` dict, they also record what each lane reads and needs
# (``tools/reads.py`` counts it, the tests check the kernel's rounds against
# it): per array, (positions, needed) pairs of [n] tensors, one per read;
# per search step the active lanes and their window ("search": (active, L,
# R)), likewise per walk step ("walk_up", "walk_down"); and per search step
# the lanes that compare and how far each got past ll0 ("compare": (eq,
# ll - ll0)).

PASS2_SUFFIXLEN = 2 ** 30   # pass 2 never stops at the end of the suffix


def _note(need, name: str, pos, keep):
    """Records a read of array ``name`` at ``pos`` (needed where ``keep``)."""
    if need is not None:
        need.setdefault(name, []).append((pos, keep))


def _skip_at(lcpleft, lcpright, other, M, direct):
    """LCP(M, M') via the midpoint tree (SuffixArray.cu:536-541, 614-619):
    ``other`` is L (left flavour) or R (right flavour); ``direct`` is
    lcpleft[M] (left) or lcpright[M] (right), used when |other - M| == 1."""
    ht = (other + M) >> 1
    tree = torch.minimum(take(lcpleft, ht), take(lcpright, ht))
    return torch.where((other - M).abs() == 1, direct, tree)


def _bound_walk(lcpleft, lcpright, ffh, ffl, ffr, match, go_up: bool,
                need=None):
    """Final up/down bound walk (SuffixArray.cu:714-763): narrow from the
    firstfindhit window to the outermost SA index whose skip >= match."""
    L = (ffl if go_up else ffh).clone()
    R = (ffh if go_up else ffr).clone()
    longest = ffh.clone()
    valid = ffh >= 0
    while True:
        act = valid & (R - L > 1)
        if not bool(act.any()):
            return longest
        M = (L + R) >> 1
        if need is not None:
            need.setdefault("walk_up" if go_up else "walk_down", []).append(
                (act, L, R))
            other = R if go_up else L
            adj = (other - M).abs() == 1
            _note(need, "lcpr" if go_up else "lcpl", M, act & adj)
            for name in ("lcpl", "lcpr"):
                _note(need, name, (other + M) >> 1, act & ~adj)
        if go_up:
            skip = _skip_at(lcpleft, lcpright, R, M, take(lcpright, M))
        else:
            skip = _skip_at(lcpleft, lcpright, L, M, take(lcpleft, M))
        tk = act & (skip >= match)
        nt = act & ~(skip >= match)
        longest = torch.where(tk, M, longest)
        if go_up:
            R = torch.where(tk, M, R)
            L = torch.where(nt, M, L)
        else:
            L = torch.where(tk, M, L)
            R = torch.where(nt, M, R)


def _lcp_search(refstr, sa, lcpleft, lcpright, qtok, tok, suffixlen, L, R,
                require_match, pin, need=None):
    """The LCP binary search for every lane until it narrows to adjacent
    bounds or finds its answer (``_search_body`` under the JAX while_loop).
    Pass 1: ``require_match`` None (record firstfindhit on the first matched
    token, never break on it; break at the end of the suffix), ``pin`` None.
    Pass 2: ``require_match`` int32 [n] (record and break once that many
    tokens match), ``pin`` (LL, MM, RR): the first midpoint is MM while
    (L, R) == (LL, RR).  Returns (longlen, ffh, ffl, ffr)."""
    pass1 = require_match is None
    neg = torch.full_like(tok, -1)
    zero = torch.zeros_like(tok)
    Llcp, Rlcp, longlen, temp = zero, zero, zero, neg
    ffh, ffl, ffr = neg, neg, neg
    # pass 1: a query token outside the vocabulary has no match
    found = take(qtok, tok) == -1
    if not pass1:
        found = torch.zeros_like(found)
    else:
        _note(need, "qtok", tok, torch.ones_like(found))
    while True:
        active = (R - L > 1) & ~found
        if not bool(active.any()):
            return longlen, ffh, ffl, ffr
        if need is not None:
            need.setdefault("search", []).append((active, L, R))
        M = (L + R) >> 1
        if pin is not None:
            LL, MM, RR = pin
            M = torch.where((L == LL) & (R == RR) & (MM >= 0), MM, M)
        use_l = Llcp >= Rlcp
        ll0 = torch.where(use_l, Llcp, Rlcp)
        skip = torch.where(
            use_l, _skip_at(lcpleft, lcpright, L, M, take(lcpleft, M)),
            _skip_at(lcpleft, lcpright, R, M, take(lcpright, M)))
        lt = ll0 < skip
        gt = ll0 > skip
        eq = ~lt & ~gt
        # eq-case character comparison (SuffixArray.cu:550-611)
        sref = take(sa, M) + ll0
        a = take(qtok, tok + ll0)
        b = take(refstr, sref)
        pre_break = (a == -1) | (pass1 & (ll0 >= suffixlen))
        enter = active & eq & ~pre_break & (a != -1) & (b != SEP)
        if need is not None:
            # the used flavour's skip words, and the compare's where eq
            adj = torch.where(use_l, (L - M).abs() == 1, (R - M).abs() == 1)
            _note(need, "lcpl", M, active & use_l & adj)
            _note(need, "lcpr", M, active & ~use_l & adj)
            ht = torch.where(use_l, (L + M) >> 1, (R + M) >> 1)
            for name in ("lcpl", "lcpr"):
                _note(need, name, ht, active & ~adj)
            _note(need, "sa", M, active & eq)
            _note(need, "qtok", tok + ll0,
                  active & eq & ~(pass1 & (ll0 >= suffixlen)))
            _note(need, "refstr", sref, active & eq & ~pre_break)
        tp = torch.where(enter, a - b, temp)
        ll = ll0
        fh, fl, fr = ffh, ffl, ffr
        ifound = torch.zeros_like(enter)
        while True:
            act = enter & (a != -1) & (b != SEP) & (tp == 0) & ~ifound
            if not bool(act.any()):
                break
            ll = torch.where(act, ll + 1, ll)
            sref = torch.where(act, sref + 1, sref)
            if pass1:
                rec = act & (fh == -1)
                brk = act & (ll >= suffixlen)
            else:
                rec = act & (fh == -1) & (ll >= require_match)
                brk = rec
            fh = torch.where(rec, M, fh)
            fl = torch.where(rec, L, fl)
            fr = torch.where(rec, R, fr)
            step = act & ~brk
            qpos = tok + torch.minimum(ll, suffixlen + QPAD - 1)
            a = torch.where(step, take(qtok, qpos), a)
            b = torch.where(step, take(refstr, sref), b)
            _note(need, "qtok", qpos, step)
            _note(need, "refstr", sref, step & (a != -1))
            a_end = step & (a == -1)
            ifound = ifound | brk | a_end
            upd = step & ~a_end & (a != -1) & (b != SEP)
            tp = torch.where(upd, a - b, tp)
        found_eq = eq & (pre_break | ifound)
        if need is not None:
            need.setdefault("compare", []).append((active & eq, ll - ll0))
        # post-compare branch (SuffixArray.cu:598-610) for eq lanes that did
        # not break
        post = eq & ~found_eq
        a_neg = post & (a == -1)
        b_sep = post & ~a_neg & (b == SEP)
        t_pos = post & ~a_neg & ~b_sep & (tp > 0)
        t_neg = post & ~a_neg & ~b_sep & ~t_pos
        go_left = active & ((lt & use_l) | (gt & ~use_l) | b_sep | t_pos
                            | a_neg)
        go_right = active & ((lt & ~use_l) | (gt & use_l) | t_neg | a_neg)
        nLlcp = torch.where(gt & ~use_l, skip,
                            torch.where(b_sep | t_pos, ll, Llcp))
        nRlcp = torch.where(gt & use_l, skip, torch.where(t_neg, ll, Rlcp))
        L = torch.where(go_left, M, L)
        R = torch.where(go_right, M, R)
        Llcp = torch.where(active, nLlcp, Llcp)
        Rlcp = torch.where(active, nRlcp, Rlcp)
        longlen = torch.where(active, torch.where(eq, ll, ll0), longlen)
        temp = torch.where(active, tp, temp)
        ffh = torch.where(active, fh, ffh)
        ffl = torch.where(active, fl, ffl)
        ffr = torch.where(active, fr, ffr)
        found = found | (active & found_eq)


def pass1_plain(refstr, sa, lcpleft, lcpright, qtok, toks, suffixlens,
                reflen: int, need=None):
    """Plain PyTorch version of kernel B1's pass 1 -> six int32 [T]
    (longestmatch, up, down, firstfindhit, firstfindhitL, firstfindhitR)."""
    oov = take(qtok, toks) == -1
    longlen, ffh, ffl, ffr = _lcp_search(
        refstr, sa, lcpleft, lcpright, qtok, toks, suffixlens,
        torch.zeros_like(toks), torch.full_like(toks, reflen - 1), None, None,
        need)
    hit = ~oov & (ffh != -1) & (longlen > 0)
    neg = torch.full_like(toks, -1)
    ffh_s = torch.where(hit, ffh, neg)
    up = _bound_walk(lcpleft, lcpright, ffh_s, ffl, ffr, 1, True, need)
    down = _bound_walk(lcpleft, lcpright, ffh_s, ffl, ffr, 1, False, need)
    lm = torch.where(oov | (longlen <= 0), 0, longlen)
    return (lm, torch.where(hit, up, neg), torch.where(hit, down, neg),
            torch.where(hit, ffh, neg), torch.where(hit, ffl, neg),
            torch.where(hit, ffr, neg))


def pass2_plain(refstr, sa, lcpleft, lcpright, qtok, toks, matches, LLs, MMs,
                RRs, need=None):
    """Plain PyTorch version of kernel B1's pass 2 -> (up, down) int32 [I]."""
    _, ffh, ffl, ffr = _lcp_search(
        refstr, sa, lcpleft, lcpright, qtok, toks,
        torch.full_like(toks, PASS2_SUFFIXLEN), LLs, RRs, matches,
        (LLs, MMs, RRs), need)
    neg = torch.full_like(toks, -1)
    up = _bound_walk(lcpleft, lcpright, ffh, ffl, ffr, matches, True, need)
    down = _bound_walk(lcpleft, lcpright, ffh, ffl, ffr, matches, False,
                       need)
    ok = ffh != -1
    return torch.where(ok, up, neg), torch.where(ok, down, neg)


def _check_lanes(kernel, n, *cols):
    if any(c.dim() != 1 or c.shape[0] != n for c in cols):
        raise ValueError(f"{kernel}: lane arrays differ in length")
    kb.check_count(kernel, n)


def pass1(refstr, sa, lcpleft, lcpright, qtok, toks, suffixlens, reflen: int):
    """Kernel B1, pass 1 (``csrc/lcp.cu``, ``cgx_pass1``): the LCP binary
    search of query token ``toks[i]`` (``suffixlens[i]`` tokens to its
    query's end) over the first ``reflen`` suffixes.  Returns six int32 [T]
    (longestmatch, up, down, firstfindhit, firstfindhitL, firstfindhitR).

    Replaces ``_pass1_batch`` (cgx_tpu/search/passes.py:221).  On CUDA
    tensors it launches the kernel; on CPU tensors it runs
    ``pass1_plain``."""
    device = toks.device
    if not kb.route("B1p1", device):
        return pass1_plain(refstr, sa, lcpleft, lcpright, qtok, toks,
                           suffixlens, reflen)
    kb.check_inputs("B1p1", device, torch.int32, refstr=refstr, sa=sa,
                    lcpleft=lcpleft, lcpright=lcpright, qtok=qtok, toks=toks,
                    suffixlens=suffixlens)
    n = toks.shape[0]
    _check_lanes("B1p1", n, suffixlens)
    out = torch.empty((6, n), dtype=torch.int32, device=device)
    if n:
        lib = kb.library("lcp")
        kb.check("lcp", lib.cgx_pass1(
            kb.ptr(refstr), refstr.shape[0], kb.ptr(sa), sa.shape[0],
            kb.ptr(lcpleft), kb.ptr(lcpright), lcpleft.shape[0], kb.ptr(qtok),
            qtok.shape[0], kb.ptr(toks), kb.ptr(suffixlens), n, reflen,
            kb.ptr(out), kb.stream(device)))
        kb.LAUNCHES["B1p1"] += 1
    return tuple(out)


def pass2(refstr, sa, lcpleft, lcpright, qtok, toks, matches, LLs, MMs, RRs):
    """Kernel B1, pass 2 (``csrc/lcp.cu``, ``cgx_pass2``): for each item
    (query token ``toks[i]``, match length ``matches[i]``, pass 1's
    firstfindhit window ``LLs[i] <= MMs[i] <= RRs[i]``) the SA range of the
    token's length-``matches[i]`` prefix.  Returns (up, down) int32 [I].

    Replaces ``_pass2_batch`` (cgx_tpu/search/passes.py:229).  On CUDA
    tensors it launches the kernel; on CPU tensors it runs
    ``pass2_plain``."""
    device = toks.device
    if not kb.route("B1p2", device):
        return pass2_plain(refstr, sa, lcpleft, lcpright, qtok, toks, matches,
                           LLs, MMs, RRs)
    kb.check_inputs("B1p2", device, torch.int32, refstr=refstr, sa=sa,
                    lcpleft=lcpleft, lcpright=lcpright, qtok=qtok, toks=toks,
                    matches=matches, LLs=LLs, MMs=MMs, RRs=RRs)
    n = toks.shape[0]
    _check_lanes("B1p2", n, matches, LLs, MMs, RRs)
    out = torch.empty((2, n), dtype=torch.int32, device=device)
    if n:
        lib = kb.library("lcp")
        kb.check("lcp", lib.cgx_pass2(
            kb.ptr(refstr), refstr.shape[0], kb.ptr(sa), sa.shape[0],
            kb.ptr(lcpleft), kb.ptr(lcpright), lcpleft.shape[0], kb.ptr(qtok),
            qtok.shape[0], kb.ptr(toks), kb.ptr(matches), kb.ptr(LLs),
            kb.ptr(MMs), kb.ptr(RRs), n, kb.ptr(out), kb.stream(device)))
        kb.LAUNCHES["B1p2"] += 1
    return tuple(out)


def _suffix_lens(queries) -> np.ndarray:
    """Per query token, the tokens from it to its query's end."""
    ends = np.array([queries.query_end(int(q)) for q in queries.tok_to_qry],
                    dtype=np.int32)
    return ends - np.arange(queries.totaltokens, dtype=np.int32)


def _on(dev, *arrays):
    """int32 copies of numpy arrays on ``dev``."""
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
            for a in arrays]


def pass1_lcp(index, queries) -> Pass1Result:
    """Pass 1 by the LCP search on a ``TorchGrammarIndex`` (kernel B1p1 on
    the index's device)."""
    n = queries.totaltokens
    lcpleft, lcpright = index.lcp_tables()
    toks, sls = _on(index.device, np.arange(n, dtype=np.int32),
                    _suffix_lens(queries))
    lm, up, down, ffh, ffl, ffr = (
        t.cpu().numpy() for t in pass1(
            index.refstr_padded, index.sa, lcpleft, lcpright,
            index.query_tokens(queries), toks, sls, index.reflen))
    return Pass1Result(up=up, down=down, firstfindhit=ffh, firstfindhitL=ffl,
                       firstfindhitR=ffr, longestmatch=lm)


def pass2_lcp(index, queries, p1: Pass1Result) -> Pass2Result:
    """Pass 2 by the LCP search (kernel B1p2), one item per (token, match
    length 2..longestmatch), seeded with pass 1's firstfindhit window."""
    connectoffset, toks, matches = pass2_work_items(p1)
    if len(toks) == 0:
        return Pass2Result(connectoffset=connectoffset,
                           up=np.empty(0, np.int32), down=np.empty(0, np.int32))
    lcpleft, lcpright = index.lcp_tables()
    up, down = (t.cpu().numpy() for t in pass2(
        index.refstr_padded, index.sa, lcpleft, lcpright,
        index.query_tokens(queries),
        *_on(index.device, toks, matches, p1.firstfindhitL[toks],
             p1.firstfindhit[toks], p1.firstfindhitR[toks])))
    return Pass2Result(connectoffset=connectoffset, up=up, down=down)


def pass2_work_items(p1: Pass1Result):
    """Pass-2 work list (the host scan at SuffixArray.cu:1464-1474): per
    token with longestmatch > 1, one item per match length 2..longestmatch.
    Returns (connectoffset, toks, matches)."""
    lm = p1.longestmatch.astype(np.int64)
    cnt = np.maximum(lm - 1, 0)
    ends = np.cumsum(cnt)
    starts = ends - cnt
    connectoffset = np.where(cnt > 0, starts, -1).astype(np.int32)
    total = int(ends[-1]) if len(cnt) else 0
    toks = np.repeat(np.arange(len(cnt), dtype=np.int32),
                     cnt).astype(np.int32)
    matches = (np.arange(total, dtype=np.int64)
               - np.repeat(starts, cnt) + 2).astype(np.int32)
    return connectoffset, toks, matches


def drive_refinement(queries, reflen, seed, dispatch, stats: dict = None):
    """Pass-1/2 driver over a refinement dispatcher.

    ``seed``: (seed_lo1, seed_hi1, seed_pk, seed_pk3) host tables.
    ``dispatch(toks, sls, lo, hi, depth, dchunk)`` runs ``dchunk`` levels for
    the given alive lanes (int32 numpy) and returns numpy
    (ups, downs [n, dchunk], lo, hi [n]).  ``stats`` (optional dict) receives
    ``interval_words`` and ``max_depth``.  Returns (Pass1Result, Pass2Result)
    with the search-path internals ``firstfindhit*`` reported as -1."""
    n = queries.totaltokens
    toks = np.arange(n, dtype=np.int32)
    sls = _suffix_lens(queries)
    qtok_host = np.asarray(queries.padded_tokens())

    # depths 0-2 answered on host (seed tables), ladder starts at depth 3
    # (depth 2 when the corpus id space exceeds the trigram packing budget)
    has3 = seed[3] is not None
    if n:
        lo1, hi1, lo2, hi2, lo3, hi3 = seed_intervals(
            *seed, reflen, qtok_host[toks], qtok_host[toks + 1],
            qtok_host[toks + 2], sls)
    else:
        lo1 = hi1 = lo2 = hi2 = lo3 = hi3 = np.zeros(0, np.int32)
    # sparse per-chunk records (d0_1indexed, idx-or-None, ups, downs): each
    # chunk stores intervals only for its alive lanes, so host memory is
    # O(total intervals computed), not O(n x reached_depth)
    records = [(1, None, lo1.reshape(-1, 1), (hi1 - 1).reshape(-1, 1)),
               (2, None, lo2.reshape(-1, 1), (hi2 - 1).reshape(-1, 1))]
    if has3:
        records.append((3, None, lo3.reshape(-1, 1),
                        (hi3 - 1).reshape(-1, 1)))
        lo, hi = lo3.copy(), hi3.copy()
        depth = 3
    else:
        lo, hi = lo2.copy(), hi2.copy()
        depth = 2
    # lanes with sl <= seeded depth are fully answered by the seed tables
    alive = (hi > lo) & (sls > depth)
    max_depth = int(sls.max()) if n else 0
    while alive.any() and depth < max_depth:
        dchunk = DEPTH_CHUNK if depth < DEPTH_LADDER_SWITCH \
            else DEPTH_CHUNK_DEEP
        idx = np.flatnonzero(alive)
        ups, downs, lo2c, hi2c = dispatch(toks[idx], sls[idx], lo[idx],
                                          hi[idx], depth, dchunk)
        records.append((depth + 1, idx, ups, downs))
        lo[idx] = lo2c
        hi[idx] = hi2c
        alive[idx] = hi2c > lo2c
        depth += dchunk

    if stats is not None:
        stats["interval_words"] = sum(u.size + d.size
                                      for _, _, u, d in records)
        stats["max_depth"] = depth

    # longestmatch: deepest depth with a non-empty interval.  Intervals are
    # nested, so ascending overwrite per record yields the deepest hit.
    lm = np.zeros(n, np.int32)
    for d0, idx, ups, downs in records:
        for c in range(ups.shape[1]):
            hit = (ups[:, c] >= 0) & (downs[:, c] >= ups[:, c])
            if idx is None:
                lm = np.where(hit, np.int32(d0 + c), lm)
            else:
                lm[idx[hit]] = d0 + c
    neg = np.full(n, -1, np.int32)
    hit1 = (lm >= 1)
    up1 = np.where(hit1, records[0][2][:, 0], -1).astype(np.int32)
    down1 = np.where(hit1, records[0][3][:, 0], -1).astype(np.int32)
    p1 = Pass1Result(up=up1, down=down1, firstfindhit=neg.copy(),
                     firstfindhitL=neg.copy(), firstfindhitR=neg.copy(),
                     longestmatch=lm)

    connectoffset, toks2, matches = pass2_work_items(p1)
    if len(toks2) == 0:
        p2 = Pass2Result(connectoffset=connectoffset,
                         up=np.empty(0, np.int32),
                         down=np.empty(0, np.int32))
    else:
        # match length m consumes 1-indexed depth m; every item's token was
        # alive in the chunk covering that depth, so the searchsorted
        # position always lands on the token's own row
        up2 = np.empty(len(toks2), np.int32)
        down2 = np.empty(len(toks2), np.int32)
        for d0, idx, ups, downs in records:
            sel = (matches >= d0) & (matches < d0 + ups.shape[1])
            it = np.flatnonzero(sel)
            if not len(it):
                continue
            t2 = toks2[it]
            c = matches[it] - d0
            rows = t2 if idx is None else np.searchsorted(idx, t2)
            up2[it] = ups[rows, c]
            down2[it] = downs[rows, c]
        p2 = Pass2Result(connectoffset=connectoffset, up=up2, down=down2)
    return p1, p2


def refine_passes(index, queries, stats: dict = None):
    """Pass 1 + pass 2 on a ``TorchGrammarIndex``: the alive lanes of each
    ladder step go to the index's device, kernel A1 runs there, and the
    intervals come back to the host driver."""
    qtok = index.query_tokens(queries)
    dev = index.device

    def dispatch(toks, sls, lo, hi, depth, dchunk):
        out = refine_chunk(index.sa, index.refstr_padded, qtok,
                           *_on(dev, toks, sls, lo, hi), depth, dchunk)
        return tuple(t.cpu().numpy() for t in out)

    return drive_refinement(queries, index.reflen, index.seed_host, dispatch,
                            stats=stats)
