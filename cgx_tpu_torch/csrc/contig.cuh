// A6's warp body, _extract_contig_item (cgx_tpu/extract/device.py:177-378)
// for 32 occurrences, shared by kernels A6 and B3c (contig.cu) and B4's
// extraction kernel (dist.cu): the base `ab` consistency check plus the
// 14-step left/right growth state machine emitting Xab, abX and XabX.
//
// Two phases per warp of 32 items:
//
// 1. Gathers and per-step tables, a half-warp per item (items 2it and
//    2it + 1 in step it), on the half-warp helpers of extract_common.cuh
//    (shared with A7 and A8): the base span (CWID = 16 RLP words) and
//    each side's IMAX = 14 refstr and RLP words are one 64-byte request
//    each; a (2H + 1)-wide target window is lane k's words anchor +- k and
//    two 4-step prefix scans, each lookup two shuffles.  An item's reads
//    come in three dependent rounds (the words that
//    need only cs and lm; the sentence anchor's word; the three windows),
//    and the first two rounds of pair it + 1 are issued while pair it's
//    windows are in flight.  Lane k writes step k of the item's record to
//    shared memory; the owning lane (i for item i) takes the item's scalars
//    by shuffle and its six 14-bit step masks by ballot, and keeps them in
//    registers.
// 2. The growth state machine, a lane per item (its ~2,000 dependent
//    operations would serve 2 items per warp instruction on half-warps):
//    lane i runs item i's outer and inner steps from its record, with the
//    flag updates of the JAX function in the same order, reading no global
//    memory, and writes its 8 output words, each row one coalesced store
//    per warp.  A loop ends at its first step that would change nothing
//    (every later one would not either), so most items run a few outer
//    steps and no inner ones, where the JAX function runs all 14 x 29.
//
// The record of one item, per growth step k < IMAX (3 words; the masks and
// scalars stay in the owning lane's registers):
//   rec[0][k] = lmin | lmax << 8 | rmin << 16 | rmax << 24 (each side's
//               prefix min(L) and max(R), 0..255)
//   rec[1][k] = mnL | (mxL + 1) << 16, rec[2][k] = mnR | (mxR + 1) << 16
//               (the whole-span part-vectors, 0..256 and -1..254)
// laid out [3][IMAX][33] per warp with the item fastest: lane k's writes
// (bank k + item) and lane i's reads (bank k + i) are conflict-free.  That
// is 5,544 bytes a warp, 22,176 a block of kContigThreads = 128, so shared
// memory admits 10 blocks (40 warps) per SM; __launch_bounds__ holds the
// registers to 6 blocks (24 warps), under which the body needs no stack
// (chip_smoke.py prints the ptxas report; 8 blocks would cap a thread at
// 64 registers).
//
// What bounds it: the dependent rounds of phase 1 (16 pairs a warp, each a
// few hundred-cycle gathers; 133 SHFL in the kernel's SASS) at 24 warps an
// SM.  It gathers ~90 scattered words an item, of which the function needs
// a fraction (the words of the steps that run and the window entries
// looked up: tools/reads.py, what the bound counts).
//
// Every lane stays to the end (tail lanes are masked, never returned),
// since the shuffles and ballots name the whole warp; a warp wholly past
// the end returns at once.
#pragma once

#include "extract_common.cuh"

#define CONTIG_REC 33   // record row stride: 32 items and one pad word

namespace {

constexpr int kContigThreads = 128;
// blocks per SM that __launch_bounds__ holds the registers to (<= 85 a
// thread); the shared records would admit 10
constexpr int kContigBlocks = 6;

// the value of `v` on lane 0 of this half for even lanes, lane 16 for odd:
// lanes 2it and 2it + 1 take items 2it and 2it + 1's values
__device__ __forceinline__ int from_half(int v) {
    return __shfl_sync(kFull, v, (lane_id() & 1) << 4);
}

// a 14-bit step mask of this lane's item: bit k of half (lane & 1)
__device__ __forceinline__ unsigned from_ballot(bool p) {
    return (__ballot_sync(kFull, p) >> ((lane_id() & 1) << 4)) & 0x3FFFu;
}

// _extract_contig_item for the warp's 32 occurrences: lane i holds item i's
// corpus position cs and block length lm (`valid` false past the end: its
// words are not written) and writes column j of out [8, n].  Returns how
// many of the four families lane i's item emits (0 if not valid).  Called
// by every lane of a block of kContigThreads.
__device__ int contig_warp(const Arrays& a, int cs, int lm, bool valid, int j,
                           int n, int mrs, int msym, int* __restrict__ out) {
    __shared__ unsigned rec_all[kContigThreads / 32][3][IMAX][CONTIG_REC];
    unsigned (*rec)[IMAX][CONTIG_REC] = rec_all[threadIdx.x >> 5];
    const int lane = lane_id();
    const int k = lane & 15;
    const int H = mrs - 1;

    // 1. gathers and per-step tables, a half-warp per item.  The reads of an
    // item form three dependent rounds: the words that need only cs and lm
    // (span, sides), the sentence anchor's word, the three target windows.
    // The first two rounds of pair it + 1 are issued while pair it's
    // windows are in flight.
    struct Words { unsigned tb, lt, rt; int ltok, rtok; };
    auto words = [&](int it) {   // lane k: span word k, side steps k
        const int src = 2 * it + (lane >> 4);
        const int c = __shfl_sync(kFull, cs, src);
        const int ender = c + __shfl_sync(kFull, lm, src) - 1;
        const int lpos = c - (k + 1), rpos = ender + (k + 1);
        Words w = {(unsigned)a.rlp.atg(c + k), 0u, 0u, -1, -1};
        if (k < IMAX && lpos >= 0) {
            w.ltok = a.refstr.atg(lpos);
            w.lt = (unsigned)a.rlp.atg(lpos);
        }
        if (k < IMAX && rpos >= 0) {
            w.rtok = a.refstr.atg(rpos);
            w.rt = (unsigned)a.rlp.atg(rpos);
        }
        return w;
    };
    // tempind of the span's first token (_sent_anchor), from span word 0
    auto tempind_of = [&](int it, unsigned tb) {
        return sent_tempind(__shfl_sync(kFull, cs, 2 * it + (lane >> 4)), tb);
    };
    int sentstart = 0, stb = 0, min_L = 0, max_R = 0, flags = 0;
    unsigned lhas = 0, lal = 0, lgap = 0, rhas = 0, ral = 0, rgap = 0;
    Words cur = words(0);
    int cur_sb = sent_stb(a.rlp, tempind_of(0, cur.tb));
#pragma unroll 1
    for (int it = 0; it < 16; ++it) {
        const int src = 2 * it + (lane >> 4);
        const int c = __shfl_sync(kFull, cs, src);
        const int m = __shfl_sync(kFull, lm, src);
        const int ender = c + m - 1;
        Words nxt = cur;
        if (it < 15) nxt = words(it + 1);
        const int ss = tempind_of(it, cur.tb) + 1;
        const int sb = cur_sb;

        // base span scan (ExtractPair.cu:1178-1231)
        const HalfSpan span = span_scan(c, ender, cur.tb);
        const int mnL = span.mn, mxR = span.mx;
        const bool al_first = span.al_first, al_last = span.al_last;
        const bool dead = (mnL > mxR) || (mxR - mnL >= mrs);

        // the three windows' words in flight together, then pair it + 1's
        // sentence anchor word
        HalfStep ls = side_step(c - (k + 1), cur.ltok, cur.lt);
        HalfStep rs = side_step(ender + (k + 1), cur.rtok, cur.rt);
        const int anchor = sb + min(mnL, 255);
        const int l_anchor = side_anchor(ls, sb);
        const int r_anchor = side_anchor(rs, sb);
        const WinWords bww = window_words(a.lr_tar, anchor, H);
        const WinWords lww = window_words(a.lr_tar, l_anchor, H);
        const WinWords rww = window_words(a.lr_tar, r_anchor, H);
        int nxt_sb = cur_sb;
        if (it < 15) nxt_sb = sent_stb(a.rlp, tempind_of(it + 1, nxt.tb));

        // the base window and the `ab` check, the growth sides
        const HalfWindow bw = window_scan(bww);
        const bool wc = half_win_check(bw, anchor, mnL + sb, mxR + sb, c,
                                       ender, ss, H);
        const bool ab_ok = al_first && al_last && !dead && wc;
        side_prefix(ls);
        side_prefix(rs);
        side_gap(ls, lww, l_anchor, true, c, ender, ss, sb, H);
        side_gap(rs, rww, r_anchor, false, c, ender, ss, sb, H);

        // whole-span range-min(L)/max(R) part-vectors (device.py:225-234)
        const int loL = clip(mnL - ls.pmin, 0, H);
        const int hiL = clip(max(ls.pmax, mxR) - mnL, 0, H);
        const int loR = clip(mnL - rs.pmin, 0, H);
        const int hiR = clip(max(rs.pmax, mxR) - mnL, 0, H);
        int pmnL, pmxL, pmnR, pmxR;
        window_range(bw, loL, hiL, pmnL, pmxL);
        window_range(bw, loR, hiR, pmnR, pmxR);
        if (k < IMAX) {
            const int item = src;
            rec[0][k][item] = (unsigned)ls.pmin | (unsigned)ls.pmax << 8
                              | (unsigned)rs.pmin << 16
                              | (unsigned)rs.pmax << 24;
            rec[1][k][item] = (unsigned)pmnL | (unsigned)(pmxL + 1) << 16;
            rec[2][k][item] = (unsigned)pmnR | (unsigned)(pmxR + 1) << 16;
        }

        // the owning lanes take the item's scalars and step masks
        const int f = (int)ab_ok | (int)al_first << 1 | (int)al_last << 2
                      | (int)dead << 3;
        const int v_ss = from_half(ss), v_sb = from_half(sb);
        const int v_mnL = from_half(mnL), v_mxR = from_half(mxR);
        const int v_f = from_half(f);
        const unsigned b_lhas = from_ballot(ls.has), b_lal = from_ballot(ls.al);
        const unsigned b_lgap = from_ballot(ls.gap), b_rhas = from_ballot(rs.has);
        const unsigned b_ral = from_ballot(rs.al), b_rgap = from_ballot(rs.gap);
        if ((lane >> 1) == it) {
            sentstart = v_ss; stb = v_sb; min_L = v_mnL; max_R = v_mxR;
            flags = v_f;
            lhas = b_lhas; lal = b_lal; lgap = b_lgap;
            rhas = b_rhas; ral = b_ral; rgap = b_rgap;
        }
        cur = nxt;
        cur_sb = nxt_sb;
    }
    __syncwarp();

    // 2. the growth state machine, lane i on item i
    const int ender = cs + lm - 1;
    const bool al_first = flags & 2, al_last = flags & 4, dead = flags & 8;
    bool abXNoSuccess = al_first;
    bool XabNoSuccess = al_last;
    bool Xab = !dead && (lm + 1 <= msym);
    bool abX = Xab;
    bool XabX = !dead && (lm + 2 <= msym);
    auto lmin = [&](int s) { return (int)(rec[0][s][lane] & 0xFF); };
    auto lmax = [&](int s) { return (int)((rec[0][s][lane] >> 8) & 0xFF); };
    auto rmin = [&](int s) { return (int)((rec[0][s][lane] >> 16) & 0xFF); };
    auto rmax = [&](int s) { return (int)(rec[0][s][lane] >> 24); };
    auto mnL = [&](int s) { return (int)(rec[1][s][lane] & 0xFFFF); };
    auto mxL = [&](int s) { return (int)(rec[1][s][lane] >> 16) - 1; };
    auto mnR = [&](int s) { return (int)(rec[2][s][lane] & 0xFFFF); };
    auto mxR = [&](int s) { return (int)(rec[2][s][lane] >> 16) - 1; };
    auto bit = [](unsigned mask, int s) { return ((mask >> s) & 1u) != 0; };
    auto wl_ts = [&](int s) { return stb + min(lmin(s), min_L); };
    auto wl_te = [&](int s) { return stb + max(lmax(s), max_R); };
    auto wl_ok = [&](int s) {
        return sentstart + mnL(s) == cs - (s + 1) && sentstart + mxL(s) == ender;
    };
    auto wr_ts = [&](int s) { return stb + min(rmin(s), min_L); };
    auto wr_te = [&](int s) { return stb + max(rmax(s), max_R); };
    auto wr_ok = [&](int s) {
        return sentstart + mnR(s) == cs && sentstart + mxR(s) == ender + (s + 1);
    };
    // XabX span with left extent l + 1 and right extent r + 1
    auto w2_ts = [&](int l, int r) {
        return stb + min(min(lmin(l), rmin(r)), min_L);
    };
    auto w2_te = [&](int l, int r) {
        return stb + max(max(lmax(l), rmax(r)), max_R);
    };
    auto w2_ok = [&](int l, int r) {
        return sentstart + min(mnL(l), mnR(r)) == cs - (l + 1)
            && sentstart + max(mxL(l), mxR(r)) == ender + (r + 1);
    };

    Rule xab = {}, abx = {}, xabx = {};
    int XabCount = 0, abXCount = 0;
    // sequential growth (ExtractPair.cu:1280-1791; device.py:298-374).  A
    // step that is not active changes nothing, and every later step is
    // inactive too (lm + i grows, the flags only fall), so the loop ends
    // there; the inner scans end likewise at their first step that is not
    // `run`.  The steps that do run are the JAX function's, in its order.
    for (int i = 1; i <= IMAX; ++i) {
        const int i0 = i - 1;
        const bool active = (lm + i <= mrs)
            && (abXNoSuccess || XabNoSuccess || XabX);
        if (!active) break;
        // ---- Xab (left)
        const bool l_has = bit(lhas, i0);
        const bool l_proc = active && Xab && l_has;
        if (active && !l_has) Xab = false;
        bool nxt = l_proc && bit(lal, i0);
        if (l_proc && !bit(lal, i0) && i == 1) { Xab = false; XabX = false; }
        bool spank = lmax(i0) - lmin(i0) >= mrs;
        if (l_proc && spank) Xab = false;
        nxt = nxt && !spank && bit(lgap, i0);
        if (nxt) XabCount = i;
        bool wkill = l_proc && XabNoSuccess && nxt
            && (wl_te(i0) - wl_ts(i0) >= mrs);
        if (wkill) Xab = false;
        if (l_proc && XabNoSuccess && nxt && !wkill && wl_ok(i0)) {
            xab = {true, wl_ts(i0), wl_te(i0), stb + lmin(i0),
                   stb + lmax(i0), 0, 0};
            XabNoSuccess = false;
        }
        // ---- abX (right)
        const bool r_has = bit(rhas, i0);
        const bool r_proc = active && abX && r_has;
        if (active && !r_has) abX = false;
        nxt = r_proc && bit(ral, i0);
        if (r_proc && !bit(ral, i0) && i == 1) { abX = false; XabX = false; }
        spank = rmax(i0) - rmin(i0) >= mrs;
        if (r_proc && spank) abX = false;
        nxt = nxt && !spank && bit(rgap, i0);
        if (nxt) abXCount = i;
        wkill = r_proc && abXNoSuccess && nxt && (wr_te(i0) - wr_ts(i0) >= mrs);
        if (wkill) abX = false;
        if (r_proc && abXNoSuccess && nxt && !wkill && wr_ok(i0)) {
            abx = {true, wr_ts(i0), wr_te(i0), stb + rmin(i0),
                   stb + rmax(i0), 0, 0};
            abXNoSuccess = false;
        }
        // ---- XabX (ExtractPair.cu:1514-1777)
        const bool xcond = active && XabX && (abX || Xab);
        // branch 1 scans the right side, left extent fixed at i (each step
        // runs while alive, XabX and s <= abXCount hold)
        bool alive = xcond && (XabCount == i);
        for (int s = 1; s <= IMAX && alive && XabX && s <= abXCount; ++s) {
            const int s0 = s - 1;
            const bool budget = s + i + lm <= mrs;
            if (!budget) alive = false;
            bool nx = budget && bit(ral, s0);
            const bool spank2 = rmax(s0) - rmin(s0) >= mrs;
            if (nx && spank2) alive = false;
            nx = nx && !spank2 && bit(rgap, s0);
            const int ts = w2_ts(i0, s0), te = w2_te(i0, s0);
            const bool bad = te - ts >= mrs;
            if (nx && bad) alive = false;
            nx = nx && !bad && w2_ok(i0, s0);
            if (nx && XabX) {
                xabx = {true, ts, te, stb + lmin(i0), stb + lmax(i0),
                        stb + rmin(s0), stb + rmax(s0)};
                XabX = false;
            }
        }
        // branch 2 scans the left side, right extent fixed at i
        alive = xcond && XabX && (abXCount == i);
        for (int s = 1; s <= IMAX && alive && XabX && s <= XabCount; ++s) {
            const int s0 = s - 1;
            const bool budget = s + i + lm <= mrs;
            if (!budget) alive = false;
            bool nx = budget && bit(lal, s0);
            const bool spank2 = lmax(s0) - lmin(s0) >= mrs;
            if (nx && spank2) alive = false;
            nx = nx && !spank2 && bit(lgap, s0);
            const int ts = w2_ts(s0, i0), te = w2_te(s0, i0);
            const bool bad = te - ts >= mrs;
            if (nx && bad) alive = false;
            nx = nx && !bad && w2_ok(s0, i0);
            if (nx && XabX) {
                xabx = {true, ts, te, stb + lmin(s0), stb + lmax(s0),
                        stb + rmin(i0), stb + rmax(i0)};
                XabX = false;
            }
        }
        if (active && !(abX || Xab)) XabX = false;
        // spin sync (ExtractPair.cu:1782-1789)
        const bool sync = active && !XabX;
        if (sync && !Xab) XabNoSuccess = false;
        if (sync && !abX) abXNoSuccess = false;
    }

    const bool ab_ok = flags & 1;
    const int ab_ts = min_L + stb;
    const Rule abr = {ab_ok, ab_ts, ab_ts + (ab_ok ? max_R - min_L : 0), ab_ts,
                      ab_ts, 0, 0};
    if (!valid) return 0;
    pack(abr, false, out, 0, n, j);
    pack(xab, false, out, 2, n, j);
    pack(abx, false, out, 4, n, j);
    pack(xabx, true, out, 6, n, j);
    return (int)abr.v + (int)xab.v + (int)abx.v + (int)xabx.v;
}

}  // namespace
