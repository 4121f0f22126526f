// The seeded interval refinement's warp body, shared by A1 (refine.cu, the
// replicated index) and B2r (sharded.cu, the sharded index).
//
// For each of `depths` levels a lane narrows its SA interval [l, h) with two
// lower bounds over the key column key(M, depth) = refstr[sa[M] + depth]
// (keys qt and qt + 1), writing the level's (lo, hi - 1) to ups/downs, then
// the final interval to lo_out/hi_out.  The body is templated over the key
// reader: A1 reads the replicated arrays (`SaKey`), B2r reads through the
// shards' ownership rules (sharded.cu).
//
// Bound on the H100: every search step is a dependent pair of scattered
// gathers, the SA word and then the token -- latency, not bandwidth or
// arithmetic -- and a launch has few lanes (250 at europarl).  The design:
// a warp per lane (4 a block, so the lanes spread over the SMs), both
// searches of a depth at once on its two half-warps, and each search
// 16-ary: per round the 16 lanes of a half gather the keys at 16 evenly
// spaced pivots M_i = a + i (b - a) / 16 of the open range [a, b), a
// ballot finds the first pivot whose key is >= the search key, and the
// next round searches the bracket between it and the pivot before (a range
// of at most 16 rows is probed whole and ends the search).  That takes
// about log16(h - l) rounds of one dependent pair each, against log2(h - l
// + 1) for the binary loop.  Pivot 0 is the range's own start, so a search
// whose answer is the start ends in one round: a lane past its query's end
// (key -1, every interval collapsing to [l, l)) finishes at once, and an
// empty interval makes no read at all.  Depths stay sequential: depth c + 1
// searches the interval that depth c left.
//
// Why the result is exact.  The binary loop and the 16-ary search both
// return the first row M of [l, h) with key(M) >= key (h if none) whenever
// the key column is non-decreasing over [l, h); then that row is unique, so
// any correct search finds it.  The column is non-decreasing over every
// interval the refinement searches: the SA is the unique suffix array of a
// corpus that ends in a unique sentinel, drive_refinement seeds each lane
// with the SA interval of the suffixes that share their first d0 tokens
// (the query's own), and each level keeps only the suffixes that share one
// token more.  Suffixes that share their first `depth` tokens are ordered
// by the token at `depth`, and none of them ends inside the shared prefix
// (the sentinel is unique, so an interval of two or more suffixes never
// holds it there), so sa[M] + depth stays inside the corpus and key(M) is
// that token.  The same order gives lower_bound(nlo, h, qt + 1) ==
// lower_bound(l, h, qt + 1), which lets both searches of a depth start
// together.  Through the shards the same holds because every row M the
// search reads lies in [l, h) inside the SA and every position sa[M] +
// depth inside the corpus, so exactly one shard owns each and the key read
// through them is the replicated key.  The CPU tests
// tests/test_torch_passes.py::test_refined_intervals_are_sorted and
// tests/test_torch_sharded.py::test_shard_reads_keep_the_keys_sorted check
// the premise on every interval the refinement searches.
#pragma once

#include "common.cuh"

constexpr int kRefineThreads = 128;   // 4 warps: a refinement lane each

// A1's key reader: the replicated SA and corpus, every read clamped as the
// JAX gathers clamp (views.py:9-13)
struct SaKey {
    const int* __restrict__ sa;
    int sa_len;
    const int* __restrict__ refstr;
    int ref_len;

    __device__ __forceinline__ int operator()(int M, int depth) const {
        return refstr[clampi(sa[clampi(M, sa_len)] + depth, ref_len)];
    }
};

// The first row of [a, b) whose key is >= key (b if none), found by the 16
// lanes of the caller's half-warp together; every shuffle and ballot names
// this half alone.  Returns the row on every lane of the half.
template <class Key>
__device__ __forceinline__ int lower_bound_half(const Key& key_of, int a,
                                                int b, int key, int depth) {
    const unsigned hm = half_mask();
    const int i = lane_id() & 15;
    const int shift = lane_id() & 16;
    while (b > a) {
        const int n = b - a;
        const bool few = n <= 16;
        const int M = few ? a + i : a + (int)(((long long)i * n) >> 4);
        const bool ge = (!few || i < n) && key_of(M, depth) >= key;
        const unsigned bits = (__ballot_sync(hm, ge) >> shift) & 0xFFFFu;
        if (bits == 0) {                  // every pivot's key is below key
            if (few) return b;
            a = __shfl_sync(hm, M, 15, 16) + 1;
            continue;
        }
        const int f = __ffs(bits) - 1;
        if (f == 0 || few) return __shfl_sync(hm, M, f, 16);
        const int prev = __shfl_sync(hm, M, f - 1, 16);
        b = __shfl_sync(hm, M, f, 16);    // key(b) >= key: the bracket's end
        a = prev + 1;
    }
    return a;
}

// A lane's scalars, loaded by every lane of its warp: its query position
// and remaining length, its interval, and lane c's query token at depth
// d0 + c (past the query's end -1: both searches return l, so the interval
// collapses to [l, l))
struct RefineLane {
    int tok, sl, l, h, qv;
};

__device__ __forceinline__ RefineLane refine_lane(
        const int* __restrict__ qtok, int q_len, const int* __restrict__ toks,
        const int* __restrict__ sls, const int* __restrict__ lo,
        const int* __restrict__ hi, int i, int d0, int depths) {
    const int lane = lane_id();
    RefineLane r;
    r.tok = toks[i];
    r.sl = sls[i];
    r.l = lo[i];
    r.h = hi[i];
    const int dq = d0 + lane;
    r.qv = lane < depths && dq < r.sl ? qtok[clampi(r.tok + dq, q_len)] : -1;
    return r;
}

// Lane i of the launch on one warp, its scalars loaded: the lower half
// searches qt, the upper half qt + 1.  Every lane of the warp calls this.
template <class Key>
__device__ __forceinline__ void refine_warp(
        const Key& key_of, RefineLane ln, const int* __restrict__ qtok,
        int q_len, int i, int d0, int depths, int* __restrict__ ups,
        int* __restrict__ downs, int* __restrict__ lo_out,
        int* __restrict__ hi_out) {
    const int lane = lane_id();
    int l = ln.l, h = ln.h;
    const bool upper = lane >= 16;
    for (int c = 0; c < depths; ++c) {
        const int depth = d0 + c;
        int qt = __shfl_sync(kFull, ln.qv, c & 31);
        if (c >= 32)
            qt = depth < ln.sl ? qtok[clampi(ln.tok + depth, q_len)] : -1;
        int nlo = l, nhi = l;             // an empty interval stays [l, l)
        if (h > l) {
            const int r = lower_bound_half(key_of, l, h,
                                           upper ? qt + 1 : qt, depth);
            nlo = __shfl_sync(kFull, r, 0);
            nhi = __shfl_sync(kFull, r, 16);
        }
        if (lane == (c & 31)) {
            ups[(long long)i * depths + c] = nlo;
            downs[(long long)i * depths + c] = nhi - 1;
        }
        l = nlo;
        h = nhi;
    }
    if (lane == 0) {
        lo_out[i] = l;
        hi_out[i] = h;
    }
}
