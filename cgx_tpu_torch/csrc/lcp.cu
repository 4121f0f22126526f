// B1: the LCP-accelerated suffix-array search, pass 1 (cgx_pass1) and pass 2
// (cgx_pass2), one thread per lane sharing one device search body.
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
#include "common.cuh"

#define QPAD 8   // guarded query reads past a query's end return -2
#define SEP 1    // sentence separator token id

namespace {

struct Index {
    const int* refstr; int ref_len;
    const int* sa; int sa_len;
    const int* lcpl; const int* lcpr; int lcp_len;
    const int* qtok; int q_len;
};

// LCP(M, M') via the midpoint tree: the direct word when |other - M| == 1,
// else min(lcpleft, lcpright) at the midpoint of (other, M)
__device__ __forceinline__ int skip_at(const Index& x, int other, int M,
                                       int direct) {
    if (abs(other - M) == 1) return direct;
    const int ht = clampi((other + M) >> 1, x.lcp_len);
    return min(x.lcpl[ht], x.lcpr[ht]);
}

// the outermost SA index from the firstfindhit window whose skip >= match
__device__ int bound_walk(const Index& x, int ffh, int ffl, int ffr,
                          int match, bool go_up) {
    int L = go_up ? ffl : ffh, R = go_up ? ffh : ffr;
    int longest = ffh;
    if (ffh < 0) return longest;
    while (R - L > 1) {
        const int M = (L + R) >> 1;
        const int skip = go_up
            ? skip_at(x, R, M, x.lcpr[clampi(M, x.lcp_len)])
            : skip_at(x, L, M, x.lcpl[clampi(M, x.lcp_len)]);
        if (skip >= match) {
            longest = M;
            if (go_up) R = M; else L = M;
        } else {
            if (go_up) L = M; else R = M;
        }
    }
    return longest;
}

struct Found { int longlen, ffh, ffl, ffr; };

// the LCP binary search of one lane (_search_body under the while_loop);
// pass1: require_match unused, no pin
__device__ Found search(const Index& x, int tok, int suffixlen, int L, int R,
                        bool pass1, int require_match, int LL, int MM,
                        int RR) {
    int Llcp = 0, Rlcp = 0, longlen = 0, temp = -1;
    int ffh = -1, ffl = -1, ffr = -1;
    bool found = pass1 && x.qtok[clampi(tok, x.q_len)] == -1;
    while (R - L > 1 && !found) {
        int M = (L + R) >> 1;
        if (!pass1 && L == LL && R == RR && MM >= 0) M = MM;
        const bool use_l = Llcp >= Rlcp;
        const int ll0 = use_l ? Llcp : Rlcp;
        const int skip = use_l
            ? skip_at(x, L, M, x.lcpl[clampi(M, x.lcp_len)])
            : skip_at(x, R, M, x.lcpr[clampi(M, x.lcp_len)]);
        const bool lt = ll0 < skip, gt = ll0 > skip, eq = !lt && !gt;
        // eq-case character comparison (SuffixArray.cu:550-611)
        int sref = x.sa[clampi(M, x.sa_len)] + ll0;
        int a = x.qtok[clampi(tok + ll0, x.q_len)];
        int b = x.refstr[clampi(sref, x.ref_len)];
        const bool pre_break = a == -1 || (pass1 && ll0 >= suffixlen);
        const bool enter = eq && !pre_break && a != -1 && b != SEP;
        int tp = enter ? a - b : temp;
        int ll = ll0;
        bool ifound = false;
        if (enter) {
            while (a != -1 && b != SEP && tp == 0 && !ifound) {
                ++ll;
                ++sref;
                bool brk;
                if (pass1) {
                    if (ffh == -1) { ffh = M; ffl = L; ffr = R; }
                    brk = ll >= suffixlen;
                } else {
                    brk = ffh == -1 && ll >= require_match;
                    if (brk) { ffh = M; ffl = L; ffr = R; }
                }
                if (brk) { ifound = true; break; }
                a = x.qtok[clampi(tok + min(ll, suffixlen + QPAD - 1), x.q_len)];
                b = x.refstr[clampi(sref, x.ref_len)];
                if (a == -1) { ifound = true; break; }
                if (b != SEP) tp = a - b;
            }
        }
        const bool found_eq = eq && (pre_break || ifound);
        // post-compare branch (SuffixArray.cu:598-610) for eq lanes that did
        // not break
        const bool post = eq && !found_eq;
        const bool a_neg = post && a == -1;
        const bool b_sep = post && !a_neg && b == SEP;
        const bool t_pos = post && !a_neg && !b_sep && tp > 0;
        const bool t_neg = post && !a_neg && !b_sep && !t_pos;
        const bool go_left = (lt && use_l) || (gt && !use_l) || b_sep || t_pos
                             || a_neg;
        const bool go_right = (lt && !use_l) || (gt && use_l) || t_neg || a_neg;
        const int nLlcp = (gt && !use_l) ? skip : ((b_sep || t_pos) ? ll : Llcp);
        const int nRlcp = (gt && use_l) ? skip : (t_neg ? ll : Rlcp);
        if (go_left) L = M;
        if (go_right) R = M;
        Llcp = nLlcp;
        Rlcp = nRlcp;
        longlen = eq ? ll : ll0;
        temp = tp;
        found = found_eq;
    }
    return {longlen, ffh, ffl, ffr};
}

__global__ void pass1_kernel(Index x, const int* __restrict__ toks,
                             const int* __restrict__ suffixlens, int n,
                             int reflen, int* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int tok = toks[i];
    const bool oov = x.qtok[clampi(tok, x.q_len)] == -1;
    const Found f = search(x, tok, suffixlens[i], 0, reflen - 1, true, 0, 0,
                           0, 0);
    const bool hit = !oov && f.ffh != -1 && f.longlen > 0;
    int up = -1, down = -1;
    if (hit) {
        up = bound_walk(x, f.ffh, f.ffl, f.ffr, 1, true);
        down = bound_walk(x, f.ffh, f.ffl, f.ffr, 1, false);
    }
    out[i] = oov || f.longlen <= 0 ? 0 : f.longlen;
    out[(long long)n + i] = up;
    out[2LL * n + i] = down;
    out[3LL * n + i] = hit ? f.ffh : -1;
    out[4LL * n + i] = hit ? f.ffl : -1;
    out[5LL * n + i] = hit ? f.ffr : -1;
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
