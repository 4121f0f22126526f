// A1: seeded interval refinement of the pass-1/pass-2 suffix-array search.
//
// Replaces cgx_tpu/search/passes.py:_refine_chunk_local (one vmap lane per
// live query token).  One thread per lane: for each of `depths` levels it
// narrows the lane's SA interval [lo, hi) with two lower-bound binary searches
// over refstr[sa[M] + depth] (keys qt and qt + 1), writing the level's
// (lo, hi - 1) to ups/downs, then the final interval to lo_out/hi_out.
//
// Bound on the H100: two dependent random gathers per bisection step
// (sa[M], then refstr[...]) -- latency, not bandwidth or arithmetic.  The
// design keeps one lane per thread with no shared memory, so the card hides
// the latency with many resident warps; lanes that finish early idle.
#include "common.cuh"

namespace {

__device__ __forceinline__ int lower_bound(const int* __restrict__ sa, int sa_len,
                                           const int* __restrict__ refstr,
                                           int ref_len, int l, int h, int key,
                                           int depth) {
    while (h > l) {
        int M = (l + h) >> 1;
        int t = refstr[clampi(sa[clampi(M, sa_len)] + depth, ref_len)];
        if (t >= key) h = M; else l = M + 1;
    }
    return l;
}

__global__ void refine_kernel(const int* __restrict__ sa, int sa_len,
                              const int* __restrict__ refstr, int ref_len,
                              const int* __restrict__ qtok, int q_len,
                              const int* __restrict__ toks,
                              const int* __restrict__ sls,
                              const int* __restrict__ lo,
                              const int* __restrict__ hi, int n, int d0,
                              int depths, int* __restrict__ ups,
                              int* __restrict__ downs,
                              int* __restrict__ lo_out,
                              int* __restrict__ hi_out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int tok = toks[i], sl = sls[i], l = lo[i], h = hi[i];
    for (int c = 0; c < depths; ++c) {
        int depth = d0 + c;
        // past the query's end the key is -1: both searches return l, so the
        // interval collapses to [l, l)
        int qt = depth < sl ? qtok[clampi(tok + depth, q_len)] : -1;
        int nlo = lower_bound(sa, sa_len, refstr, ref_len, l, h, qt, depth);
        int nhi = lower_bound(sa, sa_len, refstr, ref_len, nlo, h, qt + 1, depth);
        ups[(long long)i * depths + c] = nlo;
        downs[(long long)i * depths + c] = nhi - 1;
        l = nlo;
        h = nhi;
    }
    lo_out[i] = l;
    hi_out[i] = h;
}

}  // namespace

CGX_EXPORT int cgx_refine(const int* sa, int sa_len, const int* refstr,
                          int ref_len, const int* qtok, int q_len,
                          const int* toks, const int* sls, const int* lo,
                          const int* hi, int n, int d0, int depths, int* ups,
                          int* downs, int* lo_out, int* hi_out, void* stream) {
    const int threads = 256;
    refine_kernel<<<cgx_grid(n, threads), threads, 0, (cudaStream_t)stream>>>(
        sa, sa_len, refstr, ref_len, qtok, q_len, toks, sls, lo, hi, n, d0,
        depths, ups, downs, lo_out, hi_out);
    return (int)cudaGetLastError();
}
