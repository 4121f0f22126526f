// B4 (cgx_dp_step): one shard of the query-data-parallel search step, two
// kernels on the caller's stream.
//
// Replaces the per-shard body of cgx_tpu/parallel/dist.py:
// make_sharded_search_step (dist.py:56-83), the function `step` (:60-74)
// that shard_map runs on every "dp" shard: pass 1 over the shard's
// (toks, suffixlens) lanes (a vmap of passes._pass1_token), the contiguous
// extraction over its (sa_pos, lms) items with cs = refsa[sa_pos] (a vmap
// of device._extract_contig_item), and the shard's two partial counts that
// the JAX step psums: sum(p1[0] > 0) and the valid bits (bit 0) of the four
// families' packed words.  The bodies are B1's pass-1 warp (lcp.cuh), a
// warp per lane, and A6's warp body (contig.cuh), 32 items a warp; a
// pass-1 warp adds its one hit, an extraction warp its partial count summed
// with __reduce_add_sync, atomically into the shard's int32 [2] counter,
// which the wrapper zeroes before the launch.
// The adds are unsigned, so the counts wrap as the JAX int32 sums do.  The
// wrapper sums the S shards' counters (the psum).
//
// Two __global__s rather than one grid with two lane ranges: A6's warp body
// needs blocks of kContigThreads with a shared record per warp
// (contig.cuh), and the pass-1 warps need neither; as two launches each body
// keeps its own block shape and registers.
//
// Bound on the H100: as B1 pass 1 (a chain of dependent scattered reads per
// lane; lcp.cu's note) plus A6 (the words its function needs per item,
// tools/reads.py, and the packed row).  The pass-1 half is B1's warp body
// (rounds of independent reads, the walks side by side); the extraction
// half is A6's body (contig.cuh: half-warp gathers into a shared record,
// then a lane per item's growth), see contig.cu's note.
#include "contig.cuh"
#include "lcp.cuh"

namespace {

// every lane of the warp calls this (no thread has returned)
__device__ __forceinline__ void add_count(unsigned v,
                                          unsigned* __restrict__ counter) {
    v = __reduce_add_sync(0xFFFFFFFFu, v);
    if ((threadIdx.x & 31) == 0 && v != 0u) atomicAdd(counter, v);
}

__global__ void __launch_bounds__(kLcpThreads)
dp_pass1_kernel(Index x, const int* __restrict__ toks,
                const int* __restrict__ suffixlens, int n, int reflen,
                int* __restrict__ out, unsigned* __restrict__ counts) {
    const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (i >= n) return;    // the whole warp
    const int lm = pass1_warp(x, toks[i], suffixlens[i], reflen, n, i, out);
    if (lane_id() == 0 && lm > 0) atomicAdd(counts, 1u);
}

// a warp wholly past m returns at once (before any shuffle)
__global__ void __launch_bounds__(kContigThreads, kContigBlocks)
dp_contig_kernel(Arrays a, const int* __restrict__ sa, int sa_len,
                 const int* __restrict__ sa_pos, const int* __restrict__ lms,
                 int m, int mrs, int msym, int* __restrict__ out,
                 unsigned* __restrict__ counts) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j - lane_id() >= m) return;
    const bool valid = j < m;
    const int cs = valid ? sa[clampi(sa_pos[j], sa_len)] : 0;
    add_count((unsigned)contig_warp(a, cs, valid ? lms[j] : 1, valid, j, m,
                                    mrs, msym, out),
              counts + 1);
}

}  // namespace

// One shard.  Index arrays as B1 pass 1 and A6 take them (refstr, SA, the
// LCP tree, padded query tokens, RLP words, lr_tar); the shard's lanes
// toks, suffixlens int32 [n] and items sa_pos, lms int32 [m].  p1: int32
// [6, n] as B1 pass 1 writes it; ex: int32 [8, m] as A6 writes it; counts:
// int32 [2], zero on entry, gets (sum(p1[0] > 0), the valid bits of ex[1],
// ex[3], ex[5], ex[7]).
CGX_EXPORT int cgx_dp_step(const int* refstr, int ref_len, const int* sa,
                           int sa_len, const int* lcpleft,
                           const int* lcpright, int lcp_len, const int* qtok,
                           int q_len, const int* rlp, int rlp_len,
                           const int* lr_tar, int lr_len, const int* toks,
                           const int* suffixlens, int n, int reflen,
                           const int* sa_pos, const int* lms, int m, int mrs,
                           int msym, int* p1, int* ex, int* counts,
                           void* stream) {
    if (reflen < 1 || reflen > sa_len || lcp_len < 1 || q_len < 1 || mrs < 1
        || mrs - 1 > HMAX)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (n > 0) {
        const Index x = {refstr, ref_len, sa, sa_len, lcpleft, lcpright,
                         lcp_len, qtok, q_len};
        dp_pass1_kernel<<<cgx_grid(n, kLcpThreads / 32), kLcpThreads, 0,
                          s>>>(x, toks, suffixlens, n, reflen, p1,
                               (unsigned*)counts);
    }
    if (m > 0) {
        const Arrays a = {identity_view(refstr, ref_len),
                          identity_view(rlp, rlp_len),
                          identity_view(lr_tar, lr_len)};
        dp_contig_kernel<<<cgx_grid(m, kContigThreads), kContigThreads, 0,
                           s>>>(a, sa, sa_len, sa_pos, lms, m, mrs, msym, ex,
                                (unsigned*)counts);
    }
    return (int)cudaGetLastError();
}
