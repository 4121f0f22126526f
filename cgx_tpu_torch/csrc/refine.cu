// A1: seeded interval refinement of the pass-1/pass-2 suffix-array search.
//
// Replaces cgx_tpu/search/passes.py:_refine_chunk_local (one vmap lane per
// live query token).  For each of `depths` levels it narrows the lane's SA
// interval [l, h) with two lower bounds over the key column
// key(M) = refstr[sa[M] + depth] (keys qt and qt + 1), writing the level's
// (lo, hi - 1) to ups/downs, then the final interval to lo_out/hi_out.
//
// Bound on the H100: every search step is a dependent pair of scattered
// gathers, sa[M] then refstr[sa[M] + depth] -- latency, not bandwidth or
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
// searches the interval that depth c left.  Every read keeps its clamp
// (clampi), as the JAX gathers clamp (views.py:9-13).
//
// Why the result is exact.  The binary loop and the 16-ary search both
// return the first row M of [l, h) with key(M) >= key (h if none) whenever
// the key column is non-decreasing over [l, h); then that row is unique, so
// any correct search finds it.  The column is non-decreasing over every
// interval the refinement searches: the SA is the unique suffix array of a
// corpus that ends in a unique sentinel, drive_refinement seeds each lane
// with the SA interval of the suffixes that share their first d0 tokens
// (the query's own), and each level keeps only the suffixes that share one
// token more.
// Suffixes that share their first `depth` tokens are ordered by the token
// at `depth`, and none of them ends inside the shared prefix (the sentinel
// is unique, so an interval of two or more suffixes never holds it there),
// so sa[M] + depth stays inside the corpus and key(M) is that token.  The
// same order gives lower_bound(nlo, h, qt + 1) == lower_bound(l, h, qt + 1),
// which lets both searches of a depth start together.  The CPU test
// tests/test_torch_passes.py::test_refined_intervals_are_sorted checks the
// premise on every interval the refinement searches.
#include "common.cuh"

namespace {

constexpr int kRefineThreads = 128;   // 4 warps: a refinement lane each

__device__ __forceinline__ int sa_key(const int* __restrict__ sa, int sa_len,
                                      const int* __restrict__ refstr,
                                      int ref_len, int M, int depth) {
    return refstr[clampi(sa[clampi(M, sa_len)] + depth, ref_len)];
}

// The first row of [a, b) whose key is >= key (b if none), found by the 16
// lanes of the caller's half-warp together; every shuffle and ballot names
// this half alone.  Returns the row on every lane of the half.
__device__ __forceinline__ int lower_bound_half(
        const int* __restrict__ sa, int sa_len,
        const int* __restrict__ refstr, int ref_len, int a, int b, int key,
        int depth) {
    const unsigned hm = half_mask();
    const int i = lane_id() & 15;
    const int shift = lane_id() & 16;
    while (b > a) {
        const int n = b - a;
        const bool few = n <= 16;
        const int M = few ? a + i : a + (int)(((long long)i * n) >> 4);
        const bool ge = (!few || i < n) &&
                        sa_key(sa, sa_len, refstr, ref_len, M, depth) >= key;
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

// A warp per lane: the lower half searches qt, the upper half qt + 1.
__global__ void __launch_bounds__(kRefineThreads)
refine_warp_kernel(const int* __restrict__ sa, int sa_len,
                   const int* __restrict__ refstr, int ref_len,
                   const int* __restrict__ qtok, int q_len,
                   const int* __restrict__ toks, const int* __restrict__ sls,
                   const int* __restrict__ lo, const int* __restrict__ hi,
                   int n, int d0, int depths, int* __restrict__ ups,
                   int* __restrict__ downs, int* __restrict__ lo_out,
                   int* __restrict__ hi_out) {
    const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (i >= n) return;                   // the whole warp
    const int lane = lane_id();
    const int tok = toks[i], sl = sls[i];
    int l = lo[i], h = hi[i];
    // lane c's query token at depth d0 + c; past the query's end the key is
    // -1: both searches return l, so the interval collapses to [l, l)
    const int dq = d0 + lane;
    const int qv = lane < depths && dq < sl ? qtok[clampi(tok + dq, q_len)]
                                            : -1;
    const bool upper = lane >= 16;
    for (int c = 0; c < depths; ++c) {
        const int depth = d0 + c;
        int qt = __shfl_sync(kFull, qv, c & 31);
        if (c >= 32) qt = depth < sl ? qtok[clampi(tok + depth, q_len)] : -1;
        int nlo = l, nhi = l;             // an empty interval stays [l, l)
        if (h > l) {
            const int r = lower_bound_half(sa, sa_len, refstr, ref_len, l, h,
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

}  // namespace

CGX_EXPORT int cgx_refine(const int* sa, int sa_len, const int* refstr,
                          int ref_len, const int* qtok, int q_len,
                          const int* toks, const int* sls, const int* lo,
                          const int* hi, int n, int d0, int depths, int* ups,
                          int* downs, int* lo_out, int* hi_out, void* stream) {
    refine_warp_kernel<<<cgx_grid(n, kRefineThreads / 32), kRefineThreads,
                         0, (cudaStream_t)stream>>>(
        sa, sa_len, refstr, ref_len, qtok, q_len, toks, sls, lo, hi, n, d0,
        depths, ups, downs, lo_out, hi_out);
    return (int)cudaGetLastError();
}
