"""Rule extraction per sampled occurrence:

* contiguous blocks (extractConsistentPairs_Gappy, ExtractPair.cu:1055-1795):
  ab + Xab/abX/XabX, kernel A6 (``contig``, ``csrc/contig.cu``), or on the
  sharded index B3c (``contig_pos``: occurrences by corpus position);
* one-gap patterns (extractConsistentPairs_OneGap, ExtractPair.cu:351-889):
  aXb + XaXb/aXbX, kernel A7 (``onegap``, ``csrc/onegap.cu``);
* two-gap patterns (extractConsistentPairs_TwoGap, ExtractPair.cu:891-1053):
  aXbXc, kernel A8 (``twogap``, ``csrc/twogap.cu``).

Port of ``cgx_tpu/extract/device.py``: the host orchestration
(``extract_contiguous``, ``extract_onegap``, ``extract_twogap``, the
compaction into ``GapRules``, ``unpack_family``) and each kernel's plain
PyTorch version (``contig_plain``, ``onegap_plain``, ``twogap_plain``), a
lane-vectorized transcription of the JAX item function.  Sampling happens on the host when
the occurrence lists are built (``extract.blocks.occurrence_lists``).
"""

from __future__ import annotations

import numpy as np
import torch

from cgx_tpu_torch.config import ExtractorConfig
from cgx_tpu_torch.extract.blocks import occurrence_lists
from cgx_tpu_torch.kernels import build as kb
from cgx_tpu_torch.types import (Blocks, ContigRules, GapOnSA, GapRules,
                                 OneGapSearch, Precomp, TwoGapSearch)
from cgx_tpu_torch.utils.views import take

IMAX = 14   # max growth distance: lm + i <= max_rule_span with lm >= 1
CWID = 16   # base span scan width


def unpack_family(ts, pk, two_gaps=False):
    """Host inverse of the kernel's packing -> (v, ts, te, g1s, g1e[, g2s, g2e])."""
    pk = np.asarray(pk, np.int64)
    ts = np.asarray(ts, np.int64)
    v = (pk & 1).astype(bool)
    out = [v, ts, ts + ((pk >> 1) & 15), ts + ((pk >> 5) & 15),
           ts + ((pk >> 9) & 15)]
    if two_gaps:
        out += [ts + ((pk >> 13) & 15), ts + ((pk >> 17) & 15)]
    return tuple(out)


# ---------------------------------------------------------------------------
# Plain PyTorch version of kernel A6: every per-lane quantity of the JAX item
# function carries a leading lane axis N.
# ---------------------------------------------------------------------------

def _rlp_lr(rlp, pos):
    """(L, R, aligned) from RLP words; positions < 0 read as unaligned."""
    oob = pos < 0
    t = take(rlp, pos)
    L = torch.where(oob, 255, (t >> 24) & 0xFF)
    R = torch.where(oob, 255, (t >> 16) & 0xFF)
    return L, R, (L != 255) & (R != 255)


def _sent_anchor(rlp, pos):
    """(sentstart, stb) at a span's first token (ExtractPair.cu:1183-1191)."""
    p = (take(rlp, pos) >> 8) & 0xFF
    tempind = pos - p - 1
    stb = torch.where(tempind == -1, 0, take(rlp, tempind))
    return tempind + 1, stb


def _window(lr_tar, anchor, H):
    """Forward/backward prefix min(L)/max(R) of the target window around
    ``anchor``: four [N, H + 1] tables."""
    offs = torch.arange(-H, H + 1, dtype=torch.int32, device=anchor.device)
    w = take(lr_tar, anchor[:, None] + offs)
    L = w >> 8
    R = w & 255
    al = (L != 255) & (R != 255)
    Lv = torch.where(al, L, 256)
    Rv = torch.where(al, R, -1)
    return (torch.cummin(Lv[:, H:], dim=1).values,
            torch.cummin(Lv[:, :H + 1].flip(1), dim=1).values,
            torch.cummax(Rv[:, H:], dim=1).values,
            torch.cummax(Rv[:, :H + 1].flip(1), dim=1).values)


def _win_check(pref, anchor, ts, te, start_chk, end_chk, sentstart, H):
    """consistent() over [ts, te] (each [N, K]) from the anchored prefixes."""
    fwdL, bwdL, fwdR, bwdR = pref
    lo = (anchor[:, None] - ts).clamp(0, H).long()
    hi = (te - anchor[:, None]).clamp(0, H).long()
    bmin = torch.minimum(bwdL.gather(1, lo), fwdL.gather(1, hi))
    bmax = torch.maximum(bwdR.gather(1, lo), fwdR.gather(1, hi))
    empty = ts > te
    bmin = torch.where(empty, 256, bmin)
    bmax = torch.where(empty, -1, bmax)
    s = sentstart[:, None]
    return (s + bmin == start_chk) & (s + bmax == end_chk)


def _grow_side(refstr, rlp, lr_tar, base, step, sentstart, stb, span_lo,
               span_hi, H):
    """[N, IMAX] token, aligned, prefix min/max and X-gap consistency of one
    growth side (``_grow_side_arrays``)."""
    steps = torch.arange(1, IMAX + 1, dtype=torch.int32, device=base.device)
    pos = base[:, None] + step * steps
    tok = torch.where(pos < 0, -1, take(refstr, pos))
    L, R, al = _rlp_lr(rlp, pos)
    pmin = torch.cummin(torch.where(al, L, 255), dim=1).values
    pmax = torch.cummax(torch.where(al, R, 0), dim=1).values
    first = al.to(torch.int32).argmax(dim=1, keepdim=True)   # 0 if none
    anchor = stb + L.gather(1, first)[:, 0]
    pref = _window(lr_tar, anchor, H)
    gap = _win_check(pref, anchor, stb[:, None] + pmin, stb[:, None] + pmax,
                     span_lo, span_hi, sentstart, H)
    return tok, al, pmin, pmax, gap


def _whole_span(base_pref, mL, mR, pmin, pmax, H):
    """[N, IMAX] range-min(L)/max(R) of the target window over the base span
    grown by each step of one side (device.py:225-234)."""
    fwdL, bwdL, fwdR, bwdR = base_pref
    lo = (mL - pmin).clamp(0, H).long()
    hi = (torch.maximum(pmax, mR) - mL).clamp(0, H).long()
    return (torch.minimum(bwdL.gather(1, lo), fwdL.gather(1, hi)),
            torch.maximum(bwdR.gather(1, lo), fwdR.gather(1, hi)))


def _pack(v, ts, te, g1s, g1e, g2s=None, g2e=None):
    def off(x, sh):
        return torch.where(v, x - ts, 0).clamp(0, 15) << sh
    pk = v.to(torch.int32) | off(te, 1) | off(g1s, 5) | off(g1e, 9)
    if g2s is not None:
        pk = pk | off(g2s, 13) | off(g2e, 17)
    return [ts, pk]


def _put(rule, emit, vals):
    """A family's slot after an emission step: valid |= emit, fields where
    emit."""
    return [rule[0] | emit] + [torch.where(emit, v, r)
                               for v, r in zip(vals, rule[1:])]


def contig_plain(refstr, sa, rlp, lr_tar, sa_pos, lm, mrs: int, msym: int):
    """Plain PyTorch version of kernel A6 -> int32 [8, N]."""
    return contig_pos_plain(refstr, rlp, lr_tar, take(sa, sa_pos), lm, mrs,
                            msym)


def contig_pos_plain(refstr, rlp, lr_tar, cs, lm, mrs: int, msym: int):
    """Plain PyTorch version of kernel B3c (``_extract_contig_item`` for
    occurrences at corpus positions ``cs``) -> int32 [8, N]."""
    return _contig_body(refstr, rlp, lr_tar, cs, lm, mrs, msym)


def _contig_body(refstr, rlp, lr_tar, cs, lm, mrs: int, msym: int,
                 need: dict | None = None):
    """``contig_pos_plain``.  Given ``need``, it also records there what the
    function looked at, for ``tools.reads.contig_reads``: per growth step
    [N, IMAX] of each side (``l_*`` left, ``r_*`` right) whether its token
    (``*_tok``), its RLP word (``*_rlp``), its X gap's window check
    (``*_gap``) and its whole-span part-vector (``*_part``) decided
    anything, ``ab`` where the base window checked the ab span, the outer
    and inner growth steps run per item (``steps``, ``inner``), and the
    values that place those reads."""
    dev = cs.device
    i32 = torch.int32
    ender = cs + lm - 1
    sentstart, stb = _sent_anchor(rlp, cs)

    # base span scan (ExtractPair.cu:1178-1231)
    ks = cs[:, None] + torch.arange(CWID, dtype=i32, device=dev)
    L0, R0, al0 = _rlp_lr(rlp, ks)
    kin = (ks < (cs + lm)[:, None]) & al0
    first_un = ~al0[:, 0]
    last_un = ~al0.gather(1, (lm - 1).clamp(0, CWID - 1).long()[:, None])[:, 0]
    min_L = torch.where(kin, L0, 256).amin(dim=1)
    max_R = torch.where(kin, R0, -1).amax(dim=1)
    dead = (min_L > max_R) | (max_R - min_L >= mrs)
    ab = ~first_un & ~last_un & ~dead
    abXNoSuccess = ~first_un
    XabNoSuccess = ~last_un

    H = mrs - 1
    anchor = stb + min_L.clamp(max=255)
    base_pref = _window(lr_tar, anchor, H)
    ab_ts = min_L + stb
    ab_len = max_R - min_L
    ab_ok = ab & _win_check(base_pref, anchor, ab_ts[:, None],
                            (max_R + stb)[:, None], cs[:, None],
                            ender[:, None], sentstart, H)[:, 0]
    Xab = ~dead & (lm + 1 <= msym)
    abX = ~dead & (lm + 1 <= msym)
    XabX = ~dead & (lm + 2 <= msym)

    ir = torch.arange(IMAX, dtype=i32, device=dev)
    col = torch.zeros((1, IMAX), dtype=i32, device=dev)
    ltok, lal, lmin, lmax, lgap = _grow_side(
        refstr, rlp, lr_tar, cs, -1, sentstart, stb, cs[:, None] - (ir + 1),
        (cs - 1)[:, None] + col, H)
    rtok, ral, rmin, rmax, rgap = _grow_side(
        refstr, rlp, lr_tar, ender, 1, sentstart, stb,
        (ender + 1)[:, None] + col, ender[:, None] + (ir + 1), H)

    # whole-span (one X) and factorised XabX consistency tables
    mL, mR = min_L[:, None], max_R[:, None]
    mnL, mxL = _whole_span(base_pref, mL, mR, lmin, lmax, H)
    mnR, mxR = _whole_span(base_pref, mL, mR, rmin, rmax, H)
    s0, t0 = sentstart[:, None], stb[:, None]
    wl_ts = t0 + torch.minimum(lmin, mL)
    wl_te = t0 + torch.maximum(lmax, mR)
    wl_ok = (s0 + mnL == cs[:, None] - (ir + 1)) & (s0 + mxL == ender[:, None])
    wr_ts = t0 + torch.minimum(rmin, mL)
    wr_te = t0 + torch.maximum(rmax, mR)
    wr_ok = (s0 + mnR == cs[:, None]) & (s0 + mxR == ender[:, None] + (ir + 1))
    # [N, left extent, right extent]
    w2_ts = stb[:, None, None] + torch.minimum(
        torch.minimum(lmin[:, :, None], rmin[:, None, :]), min_L[:, None, None])
    w2_te = stb[:, None, None] + torch.maximum(
        torch.maximum(lmax[:, :, None], rmax[:, None, :]), max_R[:, None, None])
    s2 = sentstart[:, None, None]
    w2_ok = (s2 + torch.minimum(mnL[:, :, None], mnR[:, None, :])
             == cs[:, None, None] - (ir[None, :, None] + 1)) & \
        (s2 + torch.maximum(mxL[:, :, None], mxR[:, None, :])
         == ender[:, None, None] + (ir[None, None, :] + 1))

    zero = torch.zeros_like(cs)
    F = torch.zeros_like(ab)
    xab = [F, zero, zero, zero, zero]
    abx = [F, zero, zero, zero, zero]
    xabx = [F, zero, zero, zero, zero, zero, zero]
    if need is not None:
        need.update({f"{s}_{w}": torch.zeros((cs.shape[0], IMAX),
                                             dtype=torch.bool, device=dev)
                     for s in "lr" for w in ("tok", "rlp", "gap", "part")})
        need.update(ab=ab, steps=zero.clone(), inner=zero.clone(),
                    sentstart=sentstart, stb=stb, min_L=min_L, max_R=max_R,
                    l=(lal, lmin, lmax), r=(ral, rmin, rmax))

    def mark(key, col, mask):
        if need is not None:
            need[key][:, col] |= mask

    def xabx_scan(i, alive, XabX, xabx, count_limit, al_k, pmin_k, pmax_k,
                  gap_k, w_ts_k, w_te_k, w_ok_k, o_min, o_max, scan_is_left):
        """One XabX inner branch: scan extents k = 1..count_limit of one side
        with the other side's extent fixed at i (ExtractPair.cu:1514-1777)."""
        for k in range(1, IMAX + 1):
            k0 = k - 1
            run = alive & (k <= count_limit) & XabX
            budget = k + i + lm <= mrs
            alive = alive & ~(run & ~budget)
            nx = run & budget & al_k[:, k0]
            spank2 = pmax_k[:, k0] - pmin_k[:, k0] >= mrs
            alive = alive & ~(nx & spank2)
            nx = nx & ~spank2 & gap_k[:, k0]
            bad = w_te_k[:, k0] - w_ts_k[:, k0] >= mrs
            alive = alive & ~(nx & bad)
            nx = nx & ~bad
            if need is not None:   # w_ok reads both sides' part-vectors
                need["inner"] += run
                mark("l_part", k0 if scan_is_left else i - 1, nx)
                mark("r_part", i - 1 if scan_is_left else k0, nx)
            nx = nx & w_ok_k[:, k0]
            emit = nx & XabX
            scanned = (stb + pmin_k[:, k0], stb + pmax_k[:, k0])
            other = (stb + o_min, stb + o_max)
            g1, g2 = (scanned, other) if scan_is_left else (other, scanned)
            xabx = _put(xabx, emit, (w_ts_k[:, k0], w_te_k[:, k0]) + g1 + g2)
            XabX = XabX & ~emit
        return XabX, xabx

    XabCount = torch.zeros_like(cs)
    abXCount = torch.zeros_like(cs)
    # sequential growth (ExtractPair.cu:1280-1791)
    for i in range(1, IMAX + 1):
        i0 = i - 1
        active = (lm + i <= mrs) & (abXNoSuccess | XabNoSuccess | XabX)
        # ---- Xab (left)
        l_has = (cs - i >= 0) & (ltok[:, i0] >= 2)
        l_proc = active & Xab & l_has
        mark("l_tok", i0, active & Xab)
        mark("l_rlp", i0, l_proc)
        Xab = Xab & ~(active & ~l_has)
        nxt = l_proc & lal[:, i0]
        first_unal = l_proc & ~lal[:, i0] & (i == 1)
        Xab = Xab & ~first_unal
        XabX = XabX & ~first_unal
        spank = lmax[:, i0] - lmin[:, i0] >= mrs
        Xab = Xab & ~(l_proc & spank)
        mark("l_gap", i0, nxt & ~spank)
        nxt = nxt & ~spank & lgap[:, i0]
        XabCount = torch.where(nxt, i, XabCount)
        wkill = l_proc & XabNoSuccess & nxt & (wl_te[:, i0] - wl_ts[:, i0] >= mrs)
        Xab = Xab & ~wkill
        mark("l_part", i0, l_proc & XabNoSuccess & nxt & ~wkill)
        emit = l_proc & XabNoSuccess & nxt & ~wkill & wl_ok[:, i0]
        xab = _put(xab, emit, (wl_ts[:, i0], wl_te[:, i0], stb + lmin[:, i0],
                               stb + lmax[:, i0]))
        XabNoSuccess = XabNoSuccess & ~emit
        # ---- abX (right)
        r_has = rtok[:, i0] >= 2
        r_proc = active & abX & r_has
        mark("r_tok", i0, active & abX)
        mark("r_rlp", i0, r_proc)
        abX = abX & ~(active & ~r_has)
        nxt = r_proc & ral[:, i0]
        first_unal = r_proc & ~ral[:, i0] & (i == 1)
        abX = abX & ~first_unal
        XabX = XabX & ~first_unal
        spank = rmax[:, i0] - rmin[:, i0] >= mrs
        abX = abX & ~(r_proc & spank)
        mark("r_gap", i0, nxt & ~spank)
        nxt = nxt & ~spank & rgap[:, i0]
        abXCount = torch.where(nxt, i, abXCount)
        wkill = r_proc & abXNoSuccess & nxt & (wr_te[:, i0] - wr_ts[:, i0] >= mrs)
        abX = abX & ~wkill
        mark("r_part", i0, r_proc & abXNoSuccess & nxt & ~wkill)
        if need is not None:
            need["steps"] += active
        emit = r_proc & abXNoSuccess & nxt & ~wkill & wr_ok[:, i0]
        abx = _put(abx, emit, (wr_ts[:, i0], wr_te[:, i0], stb + rmin[:, i0],
                               stb + rmax[:, i0]))
        abXNoSuccess = abXNoSuccess & ~emit
        # ---- XabX
        xcond = active & XabX & (abX | Xab)
        XabX, xabx = xabx_scan(i, xcond & (XabCount == i), XabX, xabx,
                               abXCount, ral, rmin, rmax, rgap,
                               w2_ts[:, i0, :], w2_te[:, i0, :],
                               w2_ok[:, i0, :], lmin[:, i0], lmax[:, i0],
                               False)
        XabX, xabx = xabx_scan(i, xcond & XabX & (abXCount == i), XabX, xabx,
                               XabCount, lal, lmin, lmax, lgap,
                               w2_ts[:, :, i0], w2_te[:, :, i0],
                               w2_ok[:, :, i0], rmin[:, i0], rmax[:, i0],
                               True)
        XabX = XabX & ~(active & ~(abX | Xab))
        # spin sync (ExtractPair.cu:1782-1789)
        sync = active & ~XabX
        XabNoSuccess = XabNoSuccess & ~(sync & ~Xab)
        abXNoSuccess = abXNoSuccess & ~(sync & ~abX)

    ab_te = ab_ts + torch.where(ab_ok, ab_len, 0)
    return torch.stack(_pack(ab_ok, ab_ts, ab_te, ab_ts, ab_ts)
                       + _pack(*xab) + _pack(*abx) + _pack(*xabx))


def contig(refstr, sa, rlp, lr_tar, sa_pos, lm, mrs: int, msym: int):
    """Kernel A6 (``csrc/contig.cu``): for each sampled occurrence
    (``sa[sa_pos[i]]``, block length ``lm[i]``) the ab, Xab, abX and XabX
    emissions as int32 [8, n] rows (ts, packed) per family.

    Replaces ``_contig_batch`` (cgx_tpu/extract/device.py:382).  On CUDA
    tensors it launches the kernel; on CPU tensors it runs ``contig_plain``."""
    device = sa_pos.device
    if not kb.route("A6", device):
        return contig_plain(refstr, sa, rlp, lr_tar, sa_pos, lm, mrs, msym)
    kb.check_inputs("A6", device, torch.int32, refstr=refstr, sa=sa, rlp=rlp,
                    lr_tar=lr_tar, sa_pos=sa_pos, lm=lm)
    n = sa_pos.shape[0]
    if lm.shape[0] != n:
        raise ValueError("A6: sa_pos and lm differ in length")
    out = torch.empty((8, n), dtype=torch.int32, device=device)
    if n:
        lib = kb.library("contig")
        kb.check("contig", lib.cgx_contig(
            kb.ptr(refstr), refstr.shape[0], kb.ptr(sa), sa.shape[0],
            kb.ptr(rlp), rlp.shape[0], kb.ptr(lr_tar), lr_tar.shape[0],
            kb.ptr(sa_pos), kb.ptr(lm), n, mrs, msym, kb.ptr(out),
            kb.stream(device)))
        kb.LAUNCHES["A6"] += 1
    return out


def contig_pos(refstr, rlp, lr_tar, cs, lm, mrs: int, msym: int):
    """Kernel B3c (``csrc/contig.cu``, ``cgx_contig_pos``): A6 for sampled
    occurrences given by corpus position ``cs[i]`` (resolved from the
    rank-sharded SA), on ``OffsetView``s of one shard's slices (or whole
    arrays) -> int32 [8, n].

    Replaces ``_contig_batch_pos`` (cgx_tpu/extract/device.py:391).  On CUDA
    tensors it launches the kernel; on CPU tensors it runs
    ``contig_pos_plain``."""
    device = cs.device
    if not kb.route("B3c", device):
        return contig_pos_plain(refstr, rlp, lr_tar, cs, lm, mrs, msym)
    kb.check_inputs("B3c", device, torch.int32, refstr=refstr, rlp=rlp,
                    lr_tar=lr_tar, cs=cs, lm=lm)
    n = cs.shape[0]
    if lm.shape[0] != n:
        raise ValueError("B3c: cs and lm differ in length")
    kb.check_count("B3c", n)
    out = torch.empty((8, n), dtype=torch.int32, device=device)
    if n:
        lib = kb.library("contig")
        kb.check("contig", lib.cgx_contig_pos(
            *kb.view(refstr), *kb.view(rlp), *kb.view(lr_tar), kb.ptr(cs),
            kb.ptr(lm), n, mrs, msym, kb.ptr(out), kb.stream(device)))
        kb.LAUNCHES["B3c"] += 1
    return out


def _empty_gaprules() -> GapRules:
    return GapRules(*(np.empty(0, np.int32) for _ in range(7)))


def extract_contiguous(engine, blocks: Blocks, cfg: ExtractorConfig):
    """Host orchestration for extractConsistentPairs_Gappy: sampled
    occurrence list -> the contiguous extraction on ``engine``
    (``cgx_tpu_torch.engine``) -> canonical compaction + stable id sort.  Returns (ContigRules, Xab/abX GapRules, XabX GapRules)."""
    G = len(blocks.start)
    lo = np.where(blocks.matchlen >= 1, blocks.start, 0)
    hi = np.where(blocks.matchlen >= 1, blocks.end, -1)
    bnums, tx = occurrence_lists(lo, hi, cfg.sampler, cfg.is_sample)
    if len(bnums) == 0:
        return (ContigRules(*(np.empty(0, np.int32) for _ in range(3))),
                _empty_gaprules(), _empty_gaprules())
    sa_pos = blocks.start.astype(np.int64)[bnums] + tx
    lms = blocks.matchlen.astype(np.int64)[bnums]
    out = engine.contig(sa_pos, lms)
    return _finish_contig(out, bnums, G)


def _gaprules(parts) -> GapRules:
    """Valid emissions of the given families as GapRules rows (gap offsets
    relative to the target start), stably sorted by rule id.  ``parts``:
    (v, ts, te, g1s, g1e, g2s, g2e, id) per family."""
    rows = []
    for v, ts, te, g1s, g1e, g2s, g2e, gid in parts:
        if not v.any():
            continue
        rows.append(np.stack([
            ts[v], (te - ts)[v], (g1s - ts)[v], (g1e - ts)[v],
            (g2s - ts)[v], (g2e - ts)[v], gid[v]], axis=1).astype(np.int64))
    if not rows:
        return _empty_gaprules()
    a = np.concatenate(rows, axis=0)
    a = a[np.argsort(a[:, 6], kind="stable")]
    return GapRules(ref_str_start=a[:, 0].astype(np.int32),
                    end=a[:, 1].astype(np.int32),
                    gap1=a[:, 2].astype(np.int32),
                    gap1_1=a[:, 3].astype(np.int32),
                    gap2=a[:, 4].astype(np.int32),
                    gap2_1=a[:, 5].astype(np.int32),
                    gappy_index=a[:, 6].astype(np.int32))


def _finish_contig(out, bnums, G):
    (ab_tsp, ab_pk, x_tsp, x_pk, a_tsp, a_pk, t_tsp, t_pk) = out
    ab_v, ab_ts, ab_te, _, _ = unpack_family(ab_tsp, ab_pk)
    x_v, x_ts, x_te, x_g1s, x_g1e = unpack_family(x_tsp, x_pk)
    a_v, a_ts, a_te, a_g1s, a_g1e = unpack_family(a_tsp, a_pk)
    t_v, t_ts, t_te, t_g1s, t_g1e, t_g2s, t_g2e = unpack_family(
        t_tsp, t_pk, two_gaps=True)

    m = ab_v
    contig_rules = ContigRules(tar_start=ab_ts[m].astype(np.int32),
                               tar_end=(ab_te - ab_ts)[m].astype(np.int32),
                               blocknumber=bnums[m].astype(np.int32))
    # one-gap rules carry no second gap: store 0 offsets like the oracle
    rules1 = _gaprules([
        (x_v, x_ts, x_te, x_g1s, x_g1e, x_ts, x_ts, bnums),            # Xab
        (a_v, a_ts, a_te, a_g1s, a_g1e, a_ts, a_ts, G + bnums),        # abX
    ])
    rules2 = _gaprules([
        (t_v, t_ts, t_te, t_g1s, t_g1e, t_g2s, t_g2e, bnums),          # XabX
    ])
    return contig_rules, rules1, rules2


# ---------------------------------------------------------------------------
# One-gap extraction (extractConsistentPairs_OneGap, ExtractPair.cu:351-889)
# ---------------------------------------------------------------------------

def _consistent(lr_tar, ts, te, start_chk, end_chk, sentstart):
    """consistent() (ExtractPair.cu:103-133) over a target span at most CWID
    wide (``_consistent_dev``)."""
    ks = ts[:, None] + torch.arange(CWID, dtype=torch.int32, device=ts.device)
    w = take(lr_tar, ks)
    L = w >> 8
    R = w & 255
    al = (ks <= te[:, None]) & (L != 255) & (R != 255)
    bmin = torch.where(al, L, 256).amin(dim=1)
    bmax = torch.where(al, R, -1).amax(dim=1)
    return (sentstart + bmin == start_chk) & (sentstart + bmax == end_chk)


def check_boundary(rlp, lr_tar, start, ender, mrs: int):
    """checkBoundary (ExtractPair.cu:252-342) for spans at most CWID wide
    (``_check_boundary_dev``) -> (code 0-4, ts, te, check: where
    consistent() decides between codes 1 and 0)."""
    ks = start[:, None] + torch.arange(CWID, dtype=torch.int32,
                                       device=start.device)
    L, R, al = _rlp_lr(rlp, ks)
    span = ender - start
    end_off = span.clamp(0, CWID - 1).long()
    first_un = ~al[:, 0]
    last_un = ~al.gather(1, end_off[:, None])[:, 0]
    code_fw = torch.where(first_un & ((span == 0) | last_un), 4,
                          torch.where(first_un, 2,
                                      torch.where(last_un, 3, 0)))
    inside = (ks <= ender[:, None]) & al
    min_L = torch.where(inside, L, 256).amin(dim=1)
    max_R = torch.where(inside, R, -1).amax(dim=1)
    sentstart, stb = _sent_anchor(rlp, start)
    ts = min_L + stb
    te = max_R + stb
    check = (code_fw == 0) & (min_L <= max_R) & (max_R - min_L < mrs)
    cons = _consistent(lr_tar, ts, te, start, ender, sentstart)
    code = torch.where(check, cons.to(code_fw.dtype), code_fw)
    return code, ts, te, check


def onegap_plain(refstr, rlp, lr_tar, cs, first_end, sl, el, mrs: int,
                 msym: int):
    """Plain PyTorch version of kernel A7 -> int32 [6, N]."""
    return _onegap_body(refstr, rlp, lr_tar, cs, first_end, sl, el, mrs,
                        msym)


def _onegap_body(refstr, rlp, lr_tar, cs, first_end, sl, el, mrs: int,
                 msym: int, need: dict | None = None):
    """``onegap_plain``.  Given ``need``, it also records there what the
    function looked at, for ``tools.reads.onegap_reads`` and the tests: per
    growth step [N, IMAX] of each side (``l_*`` left, ``r_*`` right) its
    token test (``*_has``), alignment (``*_al``), prefix min(L)/max(R)
    (``*_pmin``, ``*_pmax``), X gap check (``*_gap``), grown target span
    (``*_wts``, ``*_wte``) and its whole-span check (``*_wok``), and
    whether the loop ran the step for that side (``*_run``); each side's
    flag before the loop (``*_alive``), the output's valid bits
    (``valid``: aXb, XaXb, aXbX), and the values that place the reads."""
    dev = cs.device
    i32 = torch.int32
    ender = cs + first_end
    # first gap span [cs + sl, ender - el]; its sentence anchor serves the
    # whole item
    gstart = cs + sl
    sentstart, stb = _sent_anchor(rlp, gstart)
    gks = gstart[:, None] + torch.arange(CWID, dtype=i32, device=dev)
    gL, gR, gal = _rlp_lr(rlp, gks)
    gin = (gks <= (ender - el)[:, None]) & gal
    gap1s = torch.where(gin, gL, 256).amin(dim=1) + stb
    gap1e = torch.where(gin, gR, -1).amax(dim=1) + stb

    code, ts, te, check = check_boundary(rlp, lr_tar, cs, ender, mrs)
    min_L = ts - stb
    max_R = te - stb
    # code 2 (front unaligned) kills aXbX, code 3 (end unaligned) kills XaXb,
    # code 4 both (ExtractPair.cu:574-588)
    grow = sl + el + 2 <= msym
    left = (code != 3) & (code != 4) & grow
    right = (code != 2) & (code != 4) & grow

    H = mrs - 1
    anchor = stb + min_L.clamp(max=255)
    base_pref = _window(lr_tar, anchor, H)
    ir = torch.arange(IMAX, dtype=i32, device=dev)
    col = torch.zeros((1, IMAX), dtype=i32, device=dev)
    ltok, lal, lmin, lmax, lgap = _grow_side(
        refstr, rlp, lr_tar, cs, -1, sentstart, stb, cs[:, None] - (ir + 1),
        (cs - 1)[:, None] + col, H)
    rtok, ral, rmin, rmax, rgap = _grow_side(
        refstr, rlp, lr_tar, ender, 1, sentstart, stb,
        (ender + 1)[:, None] + col, ender[:, None] + (ir + 1), H)
    lhas = (cs[:, None] - (ir + 1) >= 0) & (ltok >= 2)
    rhas = rtok >= 2
    mL, mR = min_L[:, None], max_R[:, None]
    mnL, mxL = _whole_span(base_pref, mL, mR, lmin, lmax, H)
    mnR, mxR = _whole_span(base_pref, mL, mR, rmin, rmax, H)
    s0, t0 = sentstart[:, None], stb[:, None]
    wl_ts = t0 + torch.minimum(lmin, mL)
    wl_te = t0 + torch.maximum(lmax, mR)
    wl_ok = (s0 + mnL == cs[:, None] - (ir + 1)) & (s0 + mxL == ender[:, None])
    wr_ts = t0 + torch.minimum(rmin, mL)
    wr_te = t0 + torch.maximum(rmax, mR)
    wr_ok = (s0 + mnR == cs[:, None]) & (s0 + mxR == ender[:, None] + (ir + 1))
    if need is not None:
        need.update(l_has=lhas, l_al=lal, l_pmin=lmin, l_pmax=lmax,
                    l_gap=lgap, l_wts=wl_ts, l_wte=wl_te, l_wok=wl_ok,
                    r_has=rhas, r_al=ral, r_pmin=rmin, r_pmax=rmax,
                    r_gap=rgap, r_wts=wr_ts, r_wte=wr_te, r_wok=wr_ok,
                    l_alive=left, r_alive=right,
                    l_run=torch.zeros_like(lal), r_run=torch.zeros_like(ral),
                    stb=stb, sentstart=sentstart, min_L=min_L, max_R=max_R,
                    ts=ts, te=te, check=check)

    zero = torch.zeros_like(cs)
    F = torch.zeros_like(left)
    xaxb = [F, zero, zero, zero, zero]
    axbx = [F, zero, zero, zero, zero]
    for i in range(1, IMAX + 1):
        i0 = i - 1
        active = (first_end + 1 + i <= mrs) & (left | right)
        if need is not None:
            need["l_run"][:, i0] = active & left
            need["r_run"][:, i0] = active & right
        # ---- XaXb (prepend X), ExtractPair.cu:639-760
        l_proc = active & left & lhas[:, i0]
        left = left & ~(active & ~lhas[:, i0])
        nxt = l_proc & lal[:, i0]
        left = left & ~(l_proc & ~lal[:, i0] & (i == 1))
        spank = lmax[:, i0] - lmin[:, i0] >= mrs
        left = left & ~(l_proc & spank)
        nxt = nxt & ~spank & lgap[:, i0]
        wkill = nxt & (wl_te[:, i0] - wl_ts[:, i0] >= mrs)
        left = left & ~wkill
        emit = nxt & ~wkill & wl_ok[:, i0]
        xaxb = _put(xaxb, emit, (wl_ts[:, i0], wl_te[:, i0],
                                 stb + lmin[:, i0], stb + lmax[:, i0]))
        left = left & ~emit
        # ---- aXbX (append X), ExtractPair.cu:763-880
        r_proc = active & right & rhas[:, i0]
        right = right & ~(active & ~rhas[:, i0])
        nxt = r_proc & ral[:, i0]
        right = right & ~(r_proc & ~ral[:, i0] & (i == 1))
        spank = rmax[:, i0] - rmin[:, i0] >= mrs
        right = right & ~(r_proc & spank)
        nxt = nxt & ~spank & rgap[:, i0]
        wkill = nxt & (wr_te[:, i0] - wr_ts[:, i0] >= mrs)
        right = right & ~wkill
        emit = nxt & ~wkill & wr_ok[:, i0]
        axbx = _put(axbx, emit, (wr_ts[:, i0], wr_te[:, i0],
                                 stb + rmin[:, i0], stb + rmax[:, i0]))
        right = right & ~emit

    # the original gap rides in each grown family: XaXb's second gap, aXbX's
    # first (an empty slot keeps ts there)
    xv, axv = xaxb[0], axbx[0]
    if need is not None:
        need["valid"] = (code == 1, xv, axv)
    return torch.stack(
        _pack(code == 1, ts, te, gap1s, gap1e)
        + _pack(*xaxb, torch.where(xv, gap1s, xaxb[1]),
                torch.where(xv, gap1e, xaxb[1]))
        + _pack(axv, axbx[1], axbx[2], torch.where(axv, gap1s, axbx[1]),
                torch.where(axv, gap1e, axbx[1]), axbx[3], axbx[4]))


def onegap(refstr, rlp, lr_tar, cs, first_end, sl, el, mrs: int, msym: int):
    """Kernel A7 (``csrc/onegap.cu``): for each sampled aXb occurrence
    (corpus start ``cs[i]``, span end offset ``first_end[i]``, a and b
    lengths ``sl[i]``, ``el[i]``) the aXb, XaXb and aXbX emissions as int32
    [6, n] rows (ts, packed) per family.  ``refstr``, ``rlp`` and ``lr_tar``
    are the whole arrays or ``OffsetView``s of one shard's slices.

    Replaces ``_onegap_batch`` (cgx_tpu/extract/device.py:616).  On CUDA
    tensors it launches the kernel; on CPU tensors it runs
    ``onegap_plain``."""
    device = cs.device
    if not kb.route("A7", device):
        return onegap_plain(refstr, rlp, lr_tar, cs, first_end, sl, el, mrs,
                            msym)
    kb.check_inputs("A7", device, torch.int32, refstr=refstr, rlp=rlp,
                    lr_tar=lr_tar, cs=cs, first_end=first_end, sl=sl, el=el)
    n = cs.shape[0]
    if not (first_end.shape[0] == sl.shape[0] == el.shape[0] == n):
        raise ValueError("A7: item arrays differ in length")
    kb.check_count("A7", n)
    out = torch.empty((6, n), dtype=torch.int32, device=device)
    if n:
        lib = kb.library("onegap")
        kb.check("onegap", lib.cgx_onegap(
            *kb.view(refstr), *kb.view(rlp), *kb.view(lr_tar), kb.ptr(cs),
            kb.ptr(first_end),
            kb.ptr(sl), kb.ptr(el), n, mrs, msym, kb.ptr(out),
            kb.stream(device)))
        kb.LAUNCHES[kb.launch_id("A7", rlp)] += 1
    return out


def _onegap_occurrences(search1, onegap_sa, pc, sampler, is_sample):
    """Per-pattern occurrence expansion with precomp-cell redirection ->
    (pattern ids, corpus starts, span end offsets)."""
    lo0 = search1.start_on_salist.astype(np.int64)
    hi0 = search1.end_on_salist.astype(np.int64)
    has = lo0 >= 0
    loc = np.clip(lo0, 0, max(len(onegap_sa.length) - 1, 0))
    if len(onegap_sa.length):
        pcmode = has & (hi0 == lo0) & (onegap_sa.length[loc] == 0)
        pci = onegap_sa.str_position[loc].astype(np.int64)
    else:
        pcmode = np.zeros_like(has)
        pci = np.zeros_like(lo0)
    pcic = np.clip(pci, 0, len(pc.index_start) - 1)
    lo = np.where(pcmode, pc.index_start[pcic], lo0)
    hi = np.where(pcmode, pc.index_end[pcic], hi0)
    lo = np.where(has, lo, -1)
    hi = np.where(has, hi, -2)
    ids, tx = occurrence_lists(lo, hi, sampler, is_sample)
    row = lo[ids] + tx
    pcm = pcmode[ids]
    row_sa = np.clip(row, 0, max(len(onegap_sa.length) - 1, 0))
    row_pc = np.clip(row, 0, max(len(pc.onegap_start) - 1, 0))
    if len(onegap_sa.length):
        css = np.where(pcm, pc.onegap_start[row_pc] if len(pc.onegap_start)
                       else 0, onegap_sa.str_position[row_sa])
        fes = np.where(pcm, pc.onegap_length[row_pc] if len(pc.onegap_length)
                       else 0, onegap_sa.length[row_sa])
    else:
        css = pc.onegap_start[row_pc]
        fes = pc.onegap_length[row_pc]
    return ids, css.astype(np.int64), fes.astype(np.int64)


def extract_onegap(engine, search1: OneGapSearch, onegap_sa: GapOnSA,
                   pc: Precomp, cfg: ExtractorConfig):
    """Host orchestration for extractConsistentPairs_OneGap: sampled
    occurrence list -> kernel A7 on ``engine`` -> compaction.  Returns (aXb GapRules, XaXb/aXbX GapRules)."""
    D1 = len(search1.qrystart)
    ids, css, fes = _onegap_occurrences(search1, onegap_sa, pc,
                                        cfg.sampler_onegap, cfg.is_sample)
    if len(ids) == 0:
        return _empty_gaprules(), _empty_gaprules()
    ids = np.asarray(ids, dtype=np.int64)
    out = engine.onegap(
        css, fes, search1.qrystart_len[ids], search1.qryend_len[ids])
    return _finish_onegap(out, ids, D1)


def _finish_onegap(out, ids, D1):
    (b_tsp, b_pk, l_tsp, l_pk, r_tsp, r_pk) = out
    b_v, b_ts, b_te, b_g1s, b_g1e = unpack_family(b_tsp, b_pk)
    l_v, l_ts, l_te, l_g1s, l_g1e, l_og1s, l_og1e = unpack_family(
        l_tsp, l_pk, two_gaps=True)
    r_v, r_ts, r_te, r_og1s, r_og1e, r_g2s, r_g2e = unpack_family(
        r_tsp, r_pk, two_gaps=True)
    rules1 = _gaprules([(b_v, b_ts, b_te, b_g1s, b_g1e, b_ts, b_ts, ids)])
    # XaXb: gap1 = new left X, gap2 = original aXb gap; aXbX: gap1 =
    # original, gap2 = new right X (ExtractPair.cu:745-757, 866-877)
    rules2 = _gaprules([
        (l_v, l_ts, l_te, l_g1s, l_g1e, l_og1s, l_og1e, ids),           # XaXb
        (r_v, r_ts, r_te, r_og1s, r_og1e, r_g2s, r_g2e, D1 + ids),      # aXbX
    ])
    return rules1, rules2


# ---------------------------------------------------------------------------
# Two-gap extraction (extractConsistentPairs_TwoGap, ExtractPair.cu:891-1053)
# ---------------------------------------------------------------------------

def _gap_span(rlp, start, ender):
    """Target span of the source gap [start, ender] (at most CWID wide),
    anchored at its own first token's sentence."""
    ks = start[:, None] + torch.arange(CWID, dtype=torch.int32,
                                       device=start.device)
    L, R, al = _rlp_lr(rlp, ks)
    inside = (ks <= ender[:, None]) & al
    _, stb = _sent_anchor(rlp, start)
    return (torch.where(inside, L, 256).amin(dim=1) + stb,
            torch.where(inside, R, -1).amax(dim=1) + stb)


def twogap_plain(refstr, rlp, lr_tar, cs, first_end, second_end, sl, el, cl,
                 mrs: int):
    """Plain PyTorch version of kernel A8 -> int32 [2, N]."""
    g1s, g1e = _gap_span(rlp, cs + sl, cs + first_end - el)
    g2s, g2e = _gap_span(rlp, cs + first_end + 1, cs + second_end - cl)
    code, ts, te, _ = check_boundary(rlp, lr_tar, cs, cs + second_end, mrs)
    return torch.stack(_pack(code == 1, ts, te, g1s, g1e, g2s, g2e))


def twogap(refstr, rlp, lr_tar, cs, first_end, second_end, sl, el, cl,
           mrs: int):
    """Kernel A8 (``csrc/twogap.cu``): for each sampled aXbXc occurrence
    (corpus start ``cs[i]``, end offsets ``first_end[i]`` of b and
    ``second_end[i]`` of c, lengths ``sl[i]``, ``el[i]``, ``cl[i]`` of a, b
    and c) the aXbXc emission as int32 [2, n] rows (ts, packed with both
    gaps).  The arrays are whole or ``OffsetView``s, as for ``onegap``.

    Replaces ``_twogap_batch`` (cgx_tpu/extract/device.py:744).  On CUDA
    tensors it launches the kernel; on CPU tensors it runs
    ``twogap_plain``."""
    device = cs.device
    if not kb.route("A8", device):
        return twogap_plain(refstr, rlp, lr_tar, cs, first_end, second_end,
                            sl, el, cl, mrs)
    kb.check_inputs("A8", device, torch.int32, refstr=refstr, rlp=rlp,
                    lr_tar=lr_tar, cs=cs, first_end=first_end,
                    second_end=second_end, sl=sl, el=el, cl=cl)
    n = cs.shape[0]
    if not (first_end.shape[0] == second_end.shape[0] == sl.shape[0]
            == el.shape[0] == cl.shape[0] == n):
        raise ValueError("A8: item arrays differ in length")
    kb.check_count("A8", n)
    out = torch.empty((2, n), dtype=torch.int32, device=device)
    if n:
        lib = kb.library("twogap")
        kb.check("twogap", lib.cgx_twogap(
            *kb.view(refstr), *kb.view(rlp), *kb.view(lr_tar), kb.ptr(cs),
            kb.ptr(first_end),
            kb.ptr(second_end), kb.ptr(sl), kb.ptr(el), kb.ptr(cl), n, mrs,
            kb.ptr(out), kb.stream(device)))
        kb.LAUNCHES[kb.launch_id("A8", rlp)] += 1
    return out


def extract_twogap(engine, search1: OneGapSearch, search2: TwoGapSearch,
                   twogap_sa: GapOnSA, cfg: ExtractorConfig) -> GapRules:
    """Host orchestration for extractConsistentPairs_TwoGap: sampled
    occurrence list -> kernel A8 on ``engine`` -> compaction.  Returns the aXbXc GapRules."""
    ids, tx = occurrence_lists(search2.start_on_salist, search2.end_on_salist,
                               cfg.sampler_twogap, cfg.is_sample)
    if len(ids) == 0:
        return _empty_gaprules()
    ids = np.asarray(ids, dtype=np.int64)
    row = search2.start_on_salist.astype(np.int64)[ids] + tx
    one_ids = search2.blockid.astype(np.int64)[ids]
    ts, pk = engine.twogap(
        twogap_sa.str_position[row], twogap_sa.length[row],
        twogap_sa.length2[row], search1.qrystart_len[one_ids],
        search1.qryend_len[one_ids], search2.qryend_len[ids])
    return _gaprules([unpack_family(ts, pk, two_gaps=True) + (ids,)])
