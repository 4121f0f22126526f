"""Contiguous-block rule extraction (extractConsistentPairs_Gappy,
ExtractPair.cu:1055-1795): ab + Xab/abX/XabX per sampled occurrence.

Port of the contiguous part of ``cgx_tpu/extract/device.py``: the host
orchestration (``extract_contiguous``, ``_finish_contig``, ``unpack_family``)
and kernel A6 (``contig``, ``csrc/contig.cu``) with its plain PyTorch version
(``contig_plain``), a lane-vectorized transcription of
``_extract_contig_item``.  Sampling happens on the host when the occurrence
lists are built (``extract.blocks.occurrence_lists``).
"""

from __future__ import annotations

import numpy as np
import torch

from cgx_tpu_torch.config import ExtractorConfig
from cgx_tpu_torch.extract.blocks import occurrence_lists
from cgx_tpu_torch.kernels import build as kb
from cgx_tpu_torch.types import Blocks, ContigRules, GapRules
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


def _pack(v, ts, te, g1s, g1e, g2s=None, g2e=None):
    def off(x, sh):
        return torch.where(v, x - ts, 0).clamp(0, 15) << sh
    pk = v.to(torch.int32) | off(te, 1) | off(g1s, 5) | off(g1e, 9)
    if g2s is not None:
        pk = pk | off(g2s, 13) | off(g2e, 17)
    return [ts, pk]


def contig_plain(refstr, sa, rlp, lr_tar, sa_pos, lm, mrs: int, msym: int):
    """Plain PyTorch version of kernel A6 -> int32 [8, N]."""
    dev = sa_pos.device
    i32 = torch.int32
    cs = take(sa, sa_pos)
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
    fwdL, bwdL, fwdR, bwdR = base_pref
    mL, mR = min_L[:, None], max_R[:, None]

    def part(pmin, pmax):
        lo = (mL - pmin).clamp(0, H).long()
        hi = (torch.maximum(pmax, mR) - mL).clamp(0, H).long()
        return (torch.minimum(bwdL.gather(1, lo), fwdL.gather(1, hi)),
                torch.maximum(bwdR.gather(1, lo), fwdR.gather(1, hi)))
    mnL, mxL = part(lmin, lmax)
    mnR, mxR = part(rmin, rmax)
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

    def put(rule, emit, vals):
        return [rule[0] | emit] + [torch.where(emit, v, r)
                                   for v, r in zip(vals, rule[1:])]

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
            nx = nx & ~bad & w_ok_k[:, k0]
            emit = nx & XabX
            scanned = (stb + pmin_k[:, k0], stb + pmax_k[:, k0])
            other = (stb + o_min, stb + o_max)
            g1, g2 = (scanned, other) if scan_is_left else (other, scanned)
            xabx = put(xabx, emit, (w_ts_k[:, k0], w_te_k[:, k0]) + g1 + g2)
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
        Xab = Xab & ~(active & ~l_has)
        nxt = l_proc & lal[:, i0]
        first_unal = l_proc & ~lal[:, i0] & (i == 1)
        Xab = Xab & ~first_unal
        XabX = XabX & ~first_unal
        spank = lmax[:, i0] - lmin[:, i0] >= mrs
        Xab = Xab & ~(l_proc & spank)
        nxt = nxt & ~spank & lgap[:, i0]
        XabCount = torch.where(nxt, i, XabCount)
        wkill = l_proc & XabNoSuccess & nxt & (wl_te[:, i0] - wl_ts[:, i0] >= mrs)
        Xab = Xab & ~wkill
        emit = l_proc & XabNoSuccess & nxt & ~wkill & wl_ok[:, i0]
        xab = put(xab, emit, (wl_ts[:, i0], wl_te[:, i0], stb + lmin[:, i0],
                              stb + lmax[:, i0]))
        XabNoSuccess = XabNoSuccess & ~emit
        # ---- abX (right)
        r_has = rtok[:, i0] >= 2
        r_proc = active & abX & r_has
        abX = abX & ~(active & ~r_has)
        nxt = r_proc & ral[:, i0]
        first_unal = r_proc & ~ral[:, i0] & (i == 1)
        abX = abX & ~first_unal
        XabX = XabX & ~first_unal
        spank = rmax[:, i0] - rmin[:, i0] >= mrs
        abX = abX & ~(r_proc & spank)
        nxt = nxt & ~spank & rgap[:, i0]
        abXCount = torch.where(nxt, i, abXCount)
        wkill = r_proc & abXNoSuccess & nxt & (wr_te[:, i0] - wr_ts[:, i0] >= mrs)
        abX = abX & ~wkill
        emit = r_proc & abXNoSuccess & nxt & ~wkill & wr_ok[:, i0]
        abx = put(abx, emit, (wr_ts[:, i0], wr_te[:, i0], stb + rmin[:, i0],
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


def _empty_gaprules() -> GapRules:
    return GapRules(*(np.empty(0, np.int32) for _ in range(7)))


def extract_contiguous(index, blocks: Blocks, cfg: ExtractorConfig):
    """Host orchestration for extractConsistentPairs_Gappy: sampled
    occurrence list -> kernel A6 on the index's device -> canonical
    compaction + stable id sort.  Returns (ContigRules, Xab/abX GapRules,
    XabX GapRules)."""
    G = len(blocks.start)
    lo = np.where(blocks.matchlen >= 1, blocks.start, 0)
    hi = np.where(blocks.matchlen >= 1, blocks.end, -1)
    bnums, tx = occurrence_lists(lo, hi, cfg.sampler, cfg.is_sample)
    if len(bnums) == 0:
        return (ContigRules(*(np.empty(0, np.int32) for _ in range(3))),
                _empty_gaprules(), _empty_gaprules())
    sa_pos = blocks.start.astype(np.int64)[bnums] + tx
    lms = blocks.matchlen.astype(np.int64)[bnums]
    dev = index.device
    out = contig(index.refstr_padded, index.sa, index.rlp, index.lr_tar,
                 torch.from_numpy(sa_pos.astype(np.int32)).to(dev),
                 torch.from_numpy(lms.astype(np.int32)).to(dev),
                 cfg.max_rule_span, cfg.max_rule_symbols)
    return _finish_contig(tuple(out.cpu().numpy()), bnums, G)


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

    def gaprules(parts):
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

    # one-gap rules carry no second gap: store 0 offsets like the oracle
    rules1 = gaprules([
        (x_v, x_ts, x_te, x_g1s, x_g1e, x_ts, x_ts, bnums),            # Xab
        (a_v, a_ts, a_te, a_g1s, a_g1e, a_ts, a_ts, G + bnums),        # abX
    ])
    rules2 = gaprules([
        (t_v, t_ts, t_te, t_g1s, t_g1e, t_g2s, t_g2e, bnums),          # XabX
    ])
    return contig_rules, rules1, rules2
