// B1: the LCP-accelerated suffix-array search, pass 1 (cgx_pass1) and pass 2
// (cgx_pass2), one thread per lane sharing one device search body (lcp.cuh,
// which kernel B4 in dist.cu shares too).
//
// Replaces cgx_tpu/search/passes.py:_pass1_batch (passes.py:220-225, a vmap
// of _pass1_token, :166-192) and _pass2_batch (:228-232, a vmap of
// _pass2_item, :195-217), with the shared _search_body (:84-163), _skip_at
// (:46-53) and _bound_walk (:56-81): the binary search of
// suffixArrayFindLwRwKernelTwoWayTDI / suffixArrayFindConnectionTwoWayTDI
// (SuffixArray.cu:402-767, 109-400).  Each JAX lockstep while_loop becomes
// the lane's own loop, so a lane stops as soon as it is done:
//
// * pass 1 (one lane per query token): search from [0, reflen - 1], record
//   the firstfindhit window (M, L, R) on the first matched token and never
//   break on it; the compare loop breaks at the end of the query suffix and
//   clamps its query reads to suffixlen + QPAD - 1;
// * pass 2 (one lane per (token, match length) item): search from pass 1's
//   window with the first midpoint pinned to MM while (L, R) == (LL, RR);
//   record and break once `match` tokens agree; no suffix-end check (its
//   reads run into the next query's tokens and the -2 padding, as in JAX);
// * both end with the up and down bound walks over the LCP tree.
//
// Bound on the H100: per lane O(log2 reflen) outer steps, each with ~5
// dependent scattered reads (two LCP-tree words, one SA word, one corpus and
// one query token) plus the compare loop's sequential reads; a chain of
// dependent loads per lane, so latency-bound.  The design keeps the whole
// search state in registers and launches once over all lanes.
#include "lcp.cuh"

namespace {

__global__ void pass1_kernel(Index x, const int* __restrict__ toks,
                             const int* __restrict__ suffixlens, int n,
                             int reflen, int* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    pass1_lane(x, toks[i], suffixlens[i], reflen, n, i, out);
}

__global__ void pass2_kernel(Index x, const int* __restrict__ toks,
                             const int* __restrict__ matches,
                             const int* __restrict__ LLs,
                             const int* __restrict__ MMs,
                             const int* __restrict__ RRs, int n,
                             int* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int match = matches[i], LL = LLs[i], MM = MMs[i], RR = RRs[i];
    const Found f = search(x, toks[i], 1 << 30, LL, RR, false, match, LL, MM,
                           RR);
    const bool ok = f.ffh != -1;
    out[i] = ok ? bound_walk(x, f.ffh, f.ffl, f.ffr, match, true) : -1;
    out[(long long)n + i] = ok ? bound_walk(x, f.ffh, f.ffl, f.ffr, match,
                                            false) : -1;
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
    const int threads = 128;
    pass1_kernel<<<cgx_grid(n, threads), threads, 0, (cudaStream_t)stream>>>(
        x, toks, suffixlens, n, reflen, out);
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
    const int threads = 128;
    pass2_kernel<<<cgx_grid(n, threads), threads, 0, (cudaStream_t)stream>>>(
        x, toks, matches, LLs, MMs, RRs, n, out);
    return (int)cudaGetLastError();
}
