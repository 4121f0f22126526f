// The fused nested-window gap check (checkBoundaryGap), shared by kernels A4
// (gapcheck.cu) and A2 (scan.cu): a transcription of
// cgx_tpu/search/lookup.py:_gap_check_grow (lookup.py:805-863) for one item.
//
// The MMOV = 16 gap spans of one anchor are nested: [fixed, fixed + base_off
// + m] growing right, or [fixed - base_off - m, fixed] growing left.  One
// mrs-wide RLP window gives every span's min(L)/max(R) as a prefix, and every
// valid target span lies in one 16-wide lr_tar window anchored at the
// smallest valid target start, so the back-projection is one window load
// plus a 16 x 16 masked min/max.  Bit m of the result is move m's check.
// Every read is bounded explicitly against the global length, as in JAX
// (View::atg), so the same body runs on the replicated arrays and on a
// shard's slices.
#pragma once

#include "common.cuh"

#define MMOV 16   // move axis width (real moves are bounded by mrs - 2)

namespace {

__device__ __forceinline__ unsigned gap_check_grow(
        const View& rlp, const View& lr_tar, int fixed, int base_off,
        int mrs, bool grow_right) {
    // prefix min(L)/max(R) over the RLP window; ks < 0 reads as unaligned
    int minLp[MMOV], maxRp[MMOV];
    bool unal[MMOV];
    int mn = 256, mx = -1;
    for (int w = 0; w < mrs; ++w) {
        const int ks = grow_right ? fixed + w : fixed - w;
        const unsigned t = (unsigned)rlp.atg(ks);
        const int L = (int)((t >> 24) & 0xFF), R = (int)((t >> 16) & 0xFF);
        const bool un = L == 255 || R == 255 || ks < 0;
        if (!un) { mn = min(mn, L); mx = max(mx, R); }
        minLp[w] = mn;
        maxRp[w] = mx;
        unal[w] = un;
    }
    // sentence anchor at the spans' start token (the innermost one growing
    // left); stb is the RLP word reinterpreted as int32
    const int start_tok = grow_right ? fixed : fixed - base_off;
    const unsigned t0 = (unsigned)rlp.atg(start_tok);
    const int tempind = start_tok - (int)((t0 >> 8) & 0xFF) - 1;
    const int stb = tempind == -1 ? 0 : rlp.atg(tempind);

    int ts[MMOV], te[MMOV];
    bool ok1[MMOV];
    int anchor = 1 << 30;
    for (int m = 0; m < MMOV; ++m) {
        const int span = base_off + m;
        const int off = clip(span, 0, mrs - 1);
        const bool fail0 = unal[0] || unal[off] || span < 0 || span > mrs - 1;
        ok1[m] = !fail0 && minLp[off] <= maxRp[off]
                 && maxRp[off] - minLp[off] < mrs;
        ts[m] = minLp[off] + stb;
        te[m] = maxRp[off] + stb;
        if (ok1[m]) anchor = min(anchor, ts[m]);
    }
    if (anchor == 1 << 30) anchor = 0;

    int L2[MMOV], R2[MMOV];
    bool al2[MMOV];
    for (int k = 0; k < MMOV; ++k) {
        const int w = lr_tar.atg(anchor + k);
        L2[k] = w >> 8;
        R2[k] = w & 255;
        al2[k] = L2[k] != 255 && R2[k] != 255;
    }
    unsigned mask = 0;
    for (int m = 0; m < MMOV; ++m) {
        int bmin = 256, bmax = -1;
        for (int k = 0; k < MMOV; ++k) {
            const int win = anchor + k;
            if (al2[k] && win >= ts[m] && win <= te[m]) {
                bmin = min(bmin, L2[k]);
                bmax = max(bmax, R2[k]);
            }
        }
        const int span = base_off + m;
        const int src_start = grow_right ? fixed : fixed - span;
        const int src_end = grow_right ? fixed + span : fixed;
        if (ok1[m] && tempind + 1 + bmin == src_start
                && tempind + 1 + bmax == src_end)
            mask |= 1u << m;
    }
    return mask;
}

}  // namespace
