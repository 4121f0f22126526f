// The fused nested-window gap check (checkBoundaryGap): a transcription of
// cgx_tpu/search/lookup.py:_gap_check_grow (lookup.py:805-863) for one item,
// run by the 16 lanes of a half-warp (gap_check_half), its one device body.
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
// Lane m holds window word m and move m: each window is one 64-byte
// request, the prefix min/max a 4-step shuffle scan, and the lr_tar window
// is not read at all when no move passes the first test (every bit needs
// it).  Its callers: A4 and A4v (gapcheck.cu), lookup1's scan_warp (A2,
// B3f/B3b, C1f/C1b) and lookup2's two_warp (A5, C1t, B3t) in scan.cu.  The
// plain PyTorch version is cgx_tpu_torch/search/lookup.py:gap_check_grow.
#pragma once

#include "common.cuh"

#define MMOV 16   // move axis width (real moves are bounded by mrs - 2)

namespace {

// lane m's RLP word of gap_check_half: fixed +- m (words past mrs - 1 are
// read but never selected)
__device__ __forceinline__ unsigned gap_check_word(const View& rlp, int fixed,
                                                   bool grow_right) {
    const int m = lane_id() & 15;
    return (unsigned)rlp.atg(grow_right ? fixed + m : fixed - m);
}

// The gap check for one item, called by all 16 lanes of a half-warp with
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
