// The fused nested-window gap check (checkBoundaryGap): a transcription of
// cgx_tpu/search/lookup.py:_gap_check_grow (lookup.py:805-863) for one item,
// in two forms with one result.
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
//
// gap_check_half: the 16 lanes of a half-warp per item, lane m holding
// window word m and move m (A4 in gapcheck.cu; A2 and A5 with its C1t and
// B3t forms in scan.cu): each window is one 64-byte request, the prefix
// min/max a 4-step shuffle scan, and the lr_tar window is not read at all
// when no move passes the first test (every bit needs it).  gap_check_grow:
// one thread per item, each window read word by word; only the per-thread
// lookup1 scan `scan_item` (B3f/B3b, C1f/C1b) still calls it, and both go
// when that scan moves onto A2's half-warp scan.
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

// lane m's RLP word of gap_check_half: fixed +- m (words past mrs - 1 are
// read but never selected)
__device__ __forceinline__ unsigned gap_check_word(const View& rlp, int fixed,
                                                   bool grow_right) {
    const int m = lane_id() & 15;
    return (unsigned)rlp.atg(grow_right ? fixed + m : fixed - m);
}

// gap_check_grow for one item, called by all 16 lanes of a half-warp with
// the same item; lane m = lane_id() & 15 takes window word m and move m, t
// (gap_check_word, which a caller may read ahead).  Returns the 16-bit mask
// on every lane of the half.  The other half of the warp may run another
// item or none: every shuffle names this half alone.
__device__ __forceinline__ unsigned gap_check_half(
        const View& rlp, const View& lr_tar, int fixed, int base_off,
        int mrs, bool grow_right, unsigned t) {
    const unsigned hm = half_mask();
    const int m = lane_id() & 15;
    // ks < 0 reads as unaligned
    const int ks = grow_right ? fixed + m : fixed - m;
    const int L = (int)((t >> 24) & 0xFF), R = (int)((t >> 16) & 0xFF);
    const bool un = L == 255 || R == 255 || ks < 0;
    int mn = un ? 256 : L, mx = un ? -1 : R;
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) {      // inclusive prefix over 0..m
        const int omn = __shfl_up_sync(hm, mn, d, 16);
        const int omx = __shfl_up_sync(hm, mx, d, 16);
        if (m >= d) { mn = min(mn, omn); mx = max(mx, omx); }
    }
    const int span = base_off + m;
    const int off = clip(span, 0, mrs - 1);
    const int minL = __shfl_sync(hm, mn, off, 16);
    const int maxR = __shfl_sync(hm, mx, off, 16);
    const bool un_off = __shfl_sync(hm, (int)un, off, 16) != 0;
    const bool un0 = __shfl_sync(hm, (int)un, 0, 16) != 0;
    // the start token is window word 0 growing right, word base_off growing
    // left (read apart only if that lies outside the window)
    const int start_tok = grow_right ? fixed : fixed - base_off;
    const int src = grow_right ? 0 : base_off;
    unsigned t0 = (unsigned)__shfl_sync(hm, (int)t, src & 15, 16);
    if (src < 0 || src > 15) t0 = (unsigned)rlp.atg(start_tok);
    const int tempind = start_tok - (int)((t0 >> 8) & 0xFF) - 1;
    // one address for the whole half: a single request
    const int stb = tempind == -1 ? 0 : rlp.atg(tempind);

    const bool fail0 = un0 || un_off || span < 0 || span > mrs - 1;
    const bool ok1 = !fail0 && minL <= maxR && maxR - minL < mrs;
    if (__ballot_sync(hm, ok1) == 0) return 0;    // every bit needs ok1
    const int ts = minL + stb, te = maxR + stb;
    int anchor = __reduce_min_sync(hm, ok1 ? ts : 1 << 30);
    if (anchor == 1 << 30) anchor = 0;

    // lane k reads lr_tar word anchor + k; lane m folds all 16 over its span
    const int w2 = lr_tar.atg(anchor + m);
    int bmin = 256, bmax = -1;
#pragma unroll
    for (int k = 0; k < MMOV; ++k) {
        const int w = __shfl_sync(hm, w2, k, 16);
        const int L2 = w >> 8, R2 = w & 255;
        const int win = anchor + k;
        if (L2 != 255 && R2 != 255 && win >= ts && win <= te) {
            bmin = min(bmin, L2);
            bmax = max(bmax, R2);
        }
    }
    const int src_start = grow_right ? fixed : fixed - span;
    const int src_end = grow_right ? fixed + span : fixed;
    const bool bit = ok1 && tempind + 1 + bmin == src_start
                     && tempind + 1 + bmax == src_end;
    return (__ballot_sync(hm, bit) >> (lane_id() & 16)) & 0xFFFFu;
}

__device__ __forceinline__ unsigned gap_check_half(
        const View& rlp, const View& lr_tar, int fixed, int base_off,
        int mrs, bool grow_right) {
    return gap_check_half(rlp, lr_tar, fixed, base_off, mrs, grow_right,
                          gap_check_word(rlp, fixed, grow_right));
}

}  // namespace
