// A1: seeded interval refinement of the pass-1/pass-2 suffix-array search.
//
// Replaces cgx_tpu/search/passes.py:_refine_chunk_local (one vmap lane per
// live query token) on the replicated index: refine.cuh's warp body (a warp
// per lane, 16-ary searches on its two half-warps) over the SA and corpus
// read directly (`SaKey`).  B2r (sharded.cu) runs the same body through the
// shards' ownership rules.
#include "refine.cuh"

namespace {

__global__ void __launch_bounds__(kRefineThreads)
refine_warp_kernel(SaKey key, const int* __restrict__ qtok, int q_len,
                   const int* __restrict__ toks, const int* __restrict__ sls,
                   const int* __restrict__ lo, const int* __restrict__ hi,
                   int n, int d0, int depths, int* __restrict__ ups,
                   int* __restrict__ downs, int* __restrict__ lo_out,
                   int* __restrict__ hi_out) {
    const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (i >= n) return;                   // the whole warp
    refine_warp(key,
                refine_lane(qtok, q_len, toks, sls, lo, hi, i, d0, depths),
                qtok, q_len, i, d0, depths, ups, downs, lo_out, hi_out);
}

}  // namespace

CGX_EXPORT int cgx_refine(const int* sa, int sa_len, const int* refstr,
                          int ref_len, const int* qtok, int q_len,
                          const int* toks, const int* sls, const int* lo,
                          const int* hi, int n, int d0, int depths, int* ups,
                          int* downs, int* lo_out, int* hi_out, void* stream) {
    refine_warp_kernel<<<cgx_grid(n, kRefineThreads / 32), kRefineThreads,
                         0, (cudaStream_t)stream>>>(
        SaKey{sa, sa_len, refstr, ref_len}, qtok, q_len, toks, sls, lo, hi, n,
        d0, depths, ups, downs, lo_out, hi_out);
    return (int)cudaGetLastError();
}
