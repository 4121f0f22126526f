// A6's item body, _extract_contig_item (cgx_tpu/extract/device.py:177-378),
// shared by kernels A6 and B3c (contig.cu) and B4 (dist.cu): the base `ab`
// consistency check plus the 14-step left/right growth state machine
// emitting Xab, abX and XabX for one occurrence (see contig.cu).
#pragma once

#include "extract_common.cuh"

namespace {

// _extract_contig_item for the occurrence at corpus position cs with block
// length lm; writes column `item` of out [8, n] and returns how many of
// the four families it emits (the valid bits, bit 0 of each packed word)
__device__ int contig_item(const Arrays& a, int cs, int lm, int n, int mrs,
                           int msym, int item, int* __restrict__ out) {
    const int ender = cs + lm - 1;
    int sentstart, stb;
    sent_anchor(a, cs, sentstart, stb);

    // base span scan (ExtractPair.cu:1178-1231)
    int min_L = 256, max_R = -1;
    bool al_first = false, al_last = false;
    const int last_off = clip(lm - 1, 0, CWID - 1);
    for (int k = 0; k < CWID; ++k) {
        int L, R;
        bool al;
        rlp_lr(a, cs + k, L, R, al);
        if (k == 0) al_first = al;
        if (k == last_off) al_last = al;
        if (k < lm && al) { min_L = min(min_L, L); max_R = max(max_R, R); }
    }
    bool ab = al_first && al_last;
    bool abXNoSuccess = al_first;
    bool XabNoSuccess = al_last;
    const bool dead = (min_L > max_R) || (max_R - min_L >= mrs);
    ab = ab && !dead;
    bool Xab = !dead, abX = !dead, XabX = !dead;

    const int H = mrs - 1;
    const int anchor = stb + min(min_L, 255);
    Window bw;
    window(a, anchor, H, bw);
    const int ab_ts = min_L + stb;
    const int ab_len = max_R - min_L;
    const bool ab_ok = ab && win_check(bw, anchor, ab_ts, max_R + stb, cs,
                                       ender, sentstart, H);
    Xab = Xab && (lm + 1 <= msym);
    abX = abX && (lm + 1 <= msym);
    XabX = XabX && (lm + 2 <= msym);

    Side ls, rs;
    grow_side(a, true, cs, ender, sentstart, stb, H, ls);
    grow_side(a, false, cs, ender, sentstart, stb, H, rs);

    // whole-span range-min(L)/max(R) part-vectors (device.py:225-234)
    int mnL[IMAX], mxL[IMAX], mnR[IMAX], mxR[IMAX];
    for (int k = 0; k < IMAX; ++k) {
        int loL = clip(min_L - ls.pmin[k], 0, H);
        int hiL = clip(max(ls.pmax[k], max_R) - min_L, 0, H);
        int loR = clip(min_L - rs.pmin[k], 0, H);
        int hiR = clip(max(rs.pmax[k], max_R) - min_L, 0, H);
        mnL[k] = min(bw.bwdL[loL], bw.fwdL[hiL]);
        mxL[k] = max(bw.bwdR[loL], bw.fwdR[hiL]);
        mnR[k] = min(bw.bwdL[loR], bw.fwdL[hiR]);
        mxR[k] = max(bw.bwdR[loR], bw.fwdR[hiR]);
    }
    auto wl_ts = [&](int k) { return stb + min(ls.pmin[k], min_L); };
    auto wl_te = [&](int k) { return stb + max(ls.pmax[k], max_R); };
    auto wl_ok = [&](int k) {
        return sentstart + mnL[k] == cs - (k + 1) && sentstart + mxL[k] == ender;
    };
    auto wr_ts = [&](int k) { return stb + min(rs.pmin[k], min_L); };
    auto wr_te = [&](int k) { return stb + max(rs.pmax[k], max_R); };
    auto wr_ok = [&](int k) {
        return sentstart + mnR[k] == cs && sentstart + mxR[k] == ender + (k + 1);
    };
    // XabX span with left extent l + 1 and right extent r + 1
    auto w2_ts = [&](int l, int r) {
        return stb + min(min(ls.pmin[l], rs.pmin[r]), min_L);
    };
    auto w2_te = [&](int l, int r) {
        return stb + max(max(ls.pmax[l], rs.pmax[r]), max_R);
    };
    auto w2_ok = [&](int l, int r) {
        return sentstart + min(mnL[l], mnR[r]) == cs - (l + 1)
            && sentstart + max(mxL[l], mxR[r]) == ender + (r + 1);
    };

    Rule xab = {}, abx = {}, xabx = {};
    int XabCount = 0, abXCount = 0;
    // sequential growth (ExtractPair.cu:1280-1791; device.py:298-374)
    for (int i = 1; i <= IMAX; ++i) {
        const int i0 = i - 1;
        const bool active = (lm + i <= mrs)
            && (abXNoSuccess || XabNoSuccess || XabX);
        // ---- Xab (left)
        const bool l_has = (cs - i >= 0) && (ls.tok[i0] >= 2);
        const bool l_proc = active && Xab && l_has;
        if (active && !l_has) Xab = false;
        bool nxt = l_proc && ls.al[i0];
        if (l_proc && !ls.al[i0] && i == 1) { Xab = false; XabX = false; }
        bool spank = ls.pmax[i0] - ls.pmin[i0] >= mrs;
        if (l_proc && spank) Xab = false;
        nxt = nxt && !spank && ls.gap[i0];
        if (nxt) XabCount = i;
        bool wkill = l_proc && XabNoSuccess && nxt
            && (wl_te(i0) - wl_ts(i0) >= mrs);
        if (wkill) Xab = false;
        if (l_proc && XabNoSuccess && nxt && !wkill && wl_ok(i0)) {
            xab = {true, wl_ts(i0), wl_te(i0), stb + ls.pmin[i0],
                   stb + ls.pmax[i0], 0, 0};
            XabNoSuccess = false;
        }
        // ---- abX (right)
        const bool r_has = rs.tok[i0] >= 2;
        const bool r_proc = active && abX && r_has;
        if (active && !r_has) abX = false;
        nxt = r_proc && rs.al[i0];
        if (r_proc && !rs.al[i0] && i == 1) { abX = false; XabX = false; }
        spank = rs.pmax[i0] - rs.pmin[i0] >= mrs;
        if (r_proc && spank) abX = false;
        nxt = nxt && !spank && rs.gap[i0];
        if (nxt) abXCount = i;
        wkill = r_proc && abXNoSuccess && nxt && (wr_te(i0) - wr_ts(i0) >= mrs);
        if (wkill) abX = false;
        if (r_proc && abXNoSuccess && nxt && !wkill && wr_ok(i0)) {
            abx = {true, wr_ts(i0), wr_te(i0), stb + rs.pmin[i0],
                   stb + rs.pmax[i0], 0, 0};
            abXNoSuccess = false;
        }
        // ---- XabX (ExtractPair.cu:1514-1777)
        const bool xcond = active && XabX && (abX || Xab);
        // branch 1 scans the right side, left extent fixed at i
        bool alive = xcond && (XabCount == i);
        for (int k = 1; k <= IMAX; ++k) {
            const int k0 = k - 1;
            const bool run = alive && (k <= abXCount) && XabX;
            const bool budget = k + i + lm <= mrs;
            if (run && !budget) alive = false;
            bool nx = run && budget && rs.al[k0];
            const bool spank2 = rs.pmax[k0] - rs.pmin[k0] >= mrs;
            if (nx && spank2) alive = false;
            nx = nx && !spank2 && rs.gap[k0];
            const int ts = w2_ts(i0, k0), te = w2_te(i0, k0);
            const bool bad = te - ts >= mrs;
            if (nx && bad) alive = false;
            nx = nx && !bad && w2_ok(i0, k0);
            if (nx && XabX) {
                xabx = {true, ts, te, stb + ls.pmin[i0], stb + ls.pmax[i0],
                        stb + rs.pmin[k0], stb + rs.pmax[k0]};
                XabX = false;
            }
        }
        // branch 2 scans the left side, right extent fixed at i
        alive = xcond && XabX && (abXCount == i);
        for (int k = 1; k <= IMAX; ++k) {
            const int k0 = k - 1;
            const bool run = alive && (k <= XabCount) && XabX;
            const bool budget = k + i + lm <= mrs;
            if (run && !budget) alive = false;
            bool nx = run && budget && ls.al[k0];
            const bool spank2 = ls.pmax[k0] - ls.pmin[k0] >= mrs;
            if (nx && spank2) alive = false;
            nx = nx && !spank2 && ls.gap[k0];
            const int ts = w2_ts(k0, i0), te = w2_te(k0, i0);
            const bool bad = te - ts >= mrs;
            if (nx && bad) alive = false;
            nx = nx && !bad && w2_ok(k0, i0);
            if (nx && XabX) {
                xabx = {true, ts, te, stb + ls.pmin[k0], stb + ls.pmax[k0],
                        stb + rs.pmin[i0], stb + rs.pmax[i0]};
                XabX = false;
            }
        }
        if (active && !(abX || Xab)) XabX = false;
        // spin sync (ExtractPair.cu:1782-1789)
        const bool sync = active && !XabX;
        if (sync && !Xab) XabNoSuccess = false;
        if (sync && !abX) abXNoSuccess = false;
    }

    const Rule abr = {ab_ok, ab_ts, ab_ts + (ab_ok ? ab_len : 0), ab_ts, ab_ts,
                      0, 0};
    pack(abr, false, out, 0, n, item);
    pack(xab, false, out, 2, n, item);
    pack(abx, false, out, 4, n, item);
    pack(xabx, true, out, 6, n, item);
    return (int)abr.v + (int)xab.v + (int)abx.v + (int)xabx.v;
}

}  // namespace
