// Device functions shared by the extraction kernels A6 (contig.cu, through
// contig.cuh), A7 (onegap.cu) and A8 (twogap.cu): the per-item helpers of
// cgx_tpu/extract/device.py, one thread per item.  A6's warp body takes
// only Arrays, Rule and pack from here; the per-thread windows and growth
// sides (Window, grow_side) serve A7.  Every JAX read of
// refstr/rlp/lr_tar here is bounded explicitly by jnp.clip against the
// array's (global) length, so every read is View::atg (common.cuh): the
// replicated index passes identity views, the sharded one a shard's slices.
#pragma once

#include "common.cuh"

#define IMAX 14   // max growth distance (lm + i <= max_rule_span, lm >= 1)
#define CWID 16   // span scan width
#define HMAX 14   // H = max_rule_span - 1 <= 14 (ExtractorConfig bound)

namespace {

struct Arrays {
    View refstr;
    View rlp;        // uint32 RLP words stored as int32
    View lr_tar;     // (L << 8) | R per target token
};

// (L, R, aligned) from an RLP word; positions before the corpus start read
// as unaligned (_rlp_LR)
__device__ __forceinline__ void rlp_lr(const Arrays& a, int pos, int& L, int& R,
                                       bool& al) {
    if (pos < 0) { L = 255; R = 255; al = false; return; }
    unsigned t = (unsigned)a.rlp.atg(pos);
    L = (int)((t >> 24) & 0xFF);
    R = (int)((t >> 16) & 0xFF);
    al = (L != 255) && (R != 255);
}

// sentence anchor of a span's first token (_sent_anchor)
__device__ __forceinline__ void sent_anchor(const Arrays& a, int pos,
                                            int& sentstart, int& stb) {
    unsigned t = (unsigned)a.rlp.atg(pos);
    int p = (int)((t >> 8) & 0xFF);
    int tempind = pos - p - 1;
    stb = tempind == -1 ? 0 : a.rlp.atg(tempind);
    sentstart = tempind + 1;
}

// consistent() over a target span [ts, ts + CWID) cut at te (_consistent_dev)
__device__ __forceinline__ bool consistent(const Arrays& a, int ts, int te,
                                           int start_chk, int end_chk,
                                           int sentstart) {
    int bmin = 256, bmax = -1;
    for (int k = 0; k < CWID; ++k) {
        if (ts + k > te) break;
        int w = a.lr_tar.atg(ts + k);
        int L = w >> 8, R = w & 255;
        if (L != 255 && R != 255) { bmin = min(bmin, L); bmax = max(bmax, R); }
    }
    return sentstart + bmin == start_chk && sentstart + bmax == end_chk;
}

// checkBoundary (ExtractPair.cu:252-342) for spans <= CWID wide: code 0-4
// and the target span (_check_boundary_dev)
__device__ __forceinline__ int check_boundary(const Arrays& a, int start,
                                              int ender, int mrs, int& ts,
                                              int& te) {
    const int end_off = clip(ender - start, 0, CWID - 1);
    int min_L = 256, max_R = -1;
    bool al_first = false, al_last = false;
    for (int k = 0; k < CWID; ++k) {
        int L, R;
        bool al;
        rlp_lr(a, start + k, L, R, al);
        if (k == 0) al_first = al;
        if (k == end_off) al_last = al;
        if (start + k <= ender && al) { min_L = min(min_L, L); max_R = max(max_R, R); }
    }
    const bool first_un = !al_first, last_un = !al_last;
    int code = first_un && (ender == start || last_un) ? 4
             : first_un ? 2 : last_un ? 3 : 0;
    int sentstart, stb;
    sent_anchor(a, start, sentstart, stb);
    ts = min_L + stb;
    te = max_R + stb;
    if (code == 0) {
        const bool ok_span = min_L <= max_R && max_R - min_L < mrs;
        code = ok_span && consistent(a, ts, te, start, ender, sentstart) ? 1 : 0;
    }
    return code;
}

// prefix min(L)/max(R) of the target window around `anchor`, forward
// (anchor..anchor+k) and backward (anchor-k..anchor) (_tar_window_prefixes)
struct Window { int fwdL[HMAX + 1], bwdL[HMAX + 1], fwdR[HMAX + 1], bwdR[HMAX + 1]; };

__device__ void window(const Arrays& a, int anchor, int H, Window& w) {
    int mnF = 256, mxF = -1, mnB = 256, mxB = -1;
    for (int k = 0; k <= H; ++k) {
        int wf = a.lr_tar.atg(anchor + k);
        int Lf = wf >> 8, Rf = wf & 255;
        if (Lf != 255 && Rf != 255) { mnF = min(mnF, Lf); mxF = max(mxF, Rf); }
        w.fwdL[k] = mnF;
        w.fwdR[k] = mxF;
        int wb = a.lr_tar.atg(anchor - k);
        int Lb = wb >> 8, Rb = wb & 255;
        if (Lb != 255 && Rb != 255) { mnB = min(mnB, Lb); mxB = max(mxB, Rb); }
        w.bwdL[k] = mnB;
        w.bwdR[k] = mxB;
    }
}

// consistent() over [ts, te] from the anchored prefixes (_win_check)
__device__ __forceinline__ bool win_check(const Window& w, int anchor, int ts,
                                          int te, int start_chk, int end_chk,
                                          int sentstart, int H) {
    int lo = clip(anchor - ts, 0, H);
    int hi = clip(te - anchor, 0, H);
    int bmin = min(w.bwdL[lo], w.fwdL[hi]);
    int bmax = max(w.bwdR[lo], w.fwdR[hi]);
    if (ts > te) { bmin = 256; bmax = -1; }
    return sentstart + bmin == start_chk && sentstart + bmax == end_chk;
}

// per-step arrays of one growth side (_grow_side_arrays)
struct Side { int tok[IMAX], pmin[IMAX], pmax[IMAX]; bool al[IMAX], gap[IMAX]; };

__device__ void grow_side(const Arrays& a, bool left, int cs, int ender,
                          int sentstart, int stb, int H, Side& s) {
    int base = left ? cs : ender, step = left ? -1 : 1;
    int L0 = 255;
    bool seen = false;
    int mn = 255, mx = 0;
    for (int k = 0; k < IMAX; ++k) {
        int pos = base + step * (k + 1);
        s.tok[k] = pos < 0 ? -1 : a.refstr.atg(pos);
        int L, R;
        bool al;
        rlp_lr(a, pos, L, R, al);
        // anchor at the first aligned step; jnp.argmax of an all-false mask
        // is 0, so with no aligned step the anchor is step 0's L (unused)
        if (k == 0 || (al && !seen)) L0 = L;
        seen |= al;
        s.al[k] = al;
        if (al) { mn = min(mn, L); mx = max(mx, R); }
        s.pmin[k] = mn;
        s.pmax[k] = mx;
    }
    int anchor = stb + L0;
    Window w;
    window(a, anchor, H, w);
    for (int k = 0; k < IMAX; ++k) {
        int i = k + 1;
        int lo_chk = left ? cs - i : ender + 1;
        int hi_chk = left ? cs - 1 : ender + i;
        s.gap[k] = win_check(w, anchor, stb + s.pmin[k], stb + s.pmax[k],
                             lo_chk, hi_chk, sentstart, H);
    }
}

struct Rule { bool v; int ts, te, g1s, g1e, g2s, g2e; };

// one int32 per family: valid bit + 4-bit offsets from ts (_pack_family)
__device__ __forceinline__ int off(bool v, int x, int ts, int sh) {
    return clip(v ? x - ts : 0, 0, 15) << sh;
}

__device__ __forceinline__ void pack(const Rule& r, bool two_gaps, int* out,
                                     int col, int n, int item) {
    int pk = (int)r.v | off(r.v, r.te, r.ts, 1) | off(r.v, r.g1s, r.ts, 5)
             | off(r.v, r.g1e, r.ts, 9);
    if (two_gaps) pk |= off(r.v, r.g2s, r.ts, 13) | off(r.v, r.g2e, r.ts, 17);
    out[(long long)col * n + item] = r.ts;
    out[(long long)(col + 1) * n + item] = pk;
}

}  // namespace
