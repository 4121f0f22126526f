// B1: the LCP-accelerated suffix-array search, pass 1 (cgx_pass1) and pass 2
// (cgx_pass2), one warp per lane on one device search body (lcp.cuh, which
// kernel B4 in dist.cu shares too).
//
// Replaces cgx_tpu/search/passes.py:_pass1_batch (passes.py:220-225, a vmap
// of _pass1_token, :166-192) and _pass2_batch (:228-232, a vmap of
// _pass2_item, :195-217), with the shared _search_body (:84-163), _skip_at
// (:46-53) and _bound_walk (:56-81): the binary search of
// suffixArrayFindLwRwKernelTwoWayTDI / suffixArrayFindConnectionTwoWayTDI
// (SuffixArray.cu:402-767, 109-400):
//
// * pass 1 (one warp per query token): search from [0, reflen - 1], record
//   the firstfindhit window (M, L, R) on the first matched token and never
//   break on it; the compare breaks at the end of the query suffix and
//   clamps its query reads to suffixlen + QPAD - 1;
// * pass 2 (one warp per (token, match length) item): search from pass 1's
//   window with the first midpoint pinned to MM while (L, R) == (LL, RR);
//   record and break once `match` tokens agree; no suffix-end check (its
//   reads run into the next query's tokens and the -2 padding, as in JAX);
// * both end with the up and down bound walks over the LCP tree.
//
// Bound on the H100: a lane's search is a chain of dependent scattered
// reads over the corpus, SA and LCP tree (136 MB at europarl, most of it
// missing the 50 MB L2), so its time is the chain's length, not bytes.  The
// one-thread body took ~3 dependent reads a level (the node's LCP words,
// then sa[M], then the corpus token) plus one a matched token, and the two
// walks one after the other; the warp body (lcp.cuh) takes one round of
// independent reads per kSearchLevels levels plus one a compare of up to 32
// tokens, and the walks side by side, kWalkLevels levels a round
// (tools/reads.py lcp_reads counts the chain).
#include "lcp.cuh"

namespace {

__global__ void __launch_bounds__(kLcpThreads)
pass1_kernel(Index x, const int* __restrict__ toks,
             const int* __restrict__ suffixlens, int n, int reflen,
             int* __restrict__ out) {
    const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (i >= n) return;    // the whole warp
    pass1_warp(x, toks[i], suffixlens[i], reflen, n, i, out);
}

__global__ void __launch_bounds__(kLcpThreads)
pass2_kernel(Index x, const int* __restrict__ toks,
             const int* __restrict__ matches, const int* __restrict__ LLs,
             const int* __restrict__ MMs, const int* __restrict__ RRs, int n,
             int* __restrict__ out) {
    const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (i >= n) return;    // the whole warp
    const int match = matches[i], LL = LLs[i], RR = RRs[i];
    const Pin pin = {true, LL, MMs[i], RR};
    const Found f = search_warp<false>(x, toks[i], 1 << 30, LL, RR, match,
                                       pin);
    const int w = f.ffh != -1 ? walks_half(x, f.ffh, f.ffl, f.ffr, match)
                              : -1;
    if (lane_id() == 0) out[i] = w;
    else if (lane_id() == 16) out[(long long)n + i] = w;
}

}  // namespace

// Pass 1.  toks, suffixlens int32 [n]; lcpleft/lcpright int32 [lcp_len].
// out: int32 [6, n] = (longestmatch, up, down, firstfindhit, firstfindhitL,
// firstfindhitR).
CGX_EXPORT int cgx_pass1(const int* refstr, int ref_len, const int* sa,
                         int sa_len, const int* lcpleft, const int* lcpright,
                         int lcp_len, const int* qtok, int q_len,
                         const int* toks, const int* suffixlens, int n,
                         int reflen, int* out, void* stream) {
    if (reflen < 1 || reflen > sa_len || lcp_len < 1 || q_len < 1)
        return (int)cudaErrorInvalidValue;
    const Index x = {refstr, ref_len, sa, sa_len, lcpleft, lcpright, lcp_len,
                     qtok, q_len};
    pass1_kernel<<<cgx_grid(n, kLcpThreads / 32), kLcpThreads, 0,
                   (cudaStream_t)stream>>>(x, toks, suffixlens, n, reflen,
                                           out);
    return (int)cudaGetLastError();
}

// Pass 2.  toks, matches, LLs, MMs, RRs int32 [n].  out: int32 [2, n] =
// (up, down).
CGX_EXPORT int cgx_pass2(const int* refstr, int ref_len, const int* sa,
                         int sa_len, const int* lcpleft, const int* lcpright,
                         int lcp_len, const int* qtok, int q_len,
                         const int* toks, const int* matches, const int* LLs,
                         const int* MMs, const int* RRs, int n, int* out,
                         void* stream) {
    if (lcp_len < 1 || q_len < 1 || sa_len < 1)
        return (int)cudaErrorInvalidValue;
    const Index x = {refstr, ref_len, sa, sa_len, lcpleft, lcpright, lcp_len,
                     qtok, q_len};
    pass2_kernel<<<cgx_grid(n, kLcpThreads / 32), kLcpThreads, 0,
                   (cudaStream_t)stream>>>(x, toks, matches, LLs, MMs, RRs, n,
                                           out);
    return (int)cudaGetLastError();
}
