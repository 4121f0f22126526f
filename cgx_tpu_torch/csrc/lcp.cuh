// The LCP-accelerated suffix-array search of one lane, shared by kernel B1
// (lcp.cu: pass 1 and pass 2) and kernel B4 (dist.cu: the query-DP step's
// pass-1 lanes).
//
// A transcription of cgx_tpu/search/passes.py's _search_body (:84-163),
// _skip_at (:46-53), _bound_walk (:56-81) and _pass1_token (:166-192): the
// binary search of suffixArrayFindLwRwKernelTwoWayTDI /
// suffixArrayFindConnectionTwoWayTDI (SuffixArray.cu:402-767, 109-400).
// Each JAX lockstep while_loop becomes the lane's own loop, so a lane stops
// as soon as it is done.
#pragma once

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

// _pass1_token for lane i of n: search from [0, reflen - 1] and write the
// six pass-1 words of column i of out [6, n]; returns the longestmatch word
__device__ int pass1_lane(const Index& x, int tok, int suffixlen, int reflen,
                          int n, int i, int* __restrict__ out) {
    const bool oov = x.qtok[clampi(tok, x.q_len)] == -1;
    const Found f = search(x, tok, suffixlen, 0, reflen - 1, true, 0, 0, 0, 0);
    const bool hit = !oov && f.ffh != -1 && f.longlen > 0;
    int up = -1, down = -1;
    if (hit) {
        up = bound_walk(x, f.ffh, f.ffl, f.ffr, 1, true);
        down = bound_walk(x, f.ffh, f.ffl, f.ffr, 1, false);
    }
    const int lm = oov || f.longlen <= 0 ? 0 : f.longlen;
    out[i] = lm;
    out[(long long)n + i] = up;
    out[2LL * n + i] = down;
    out[3LL * n + i] = hit ? f.ffh : -1;
    out[4LL * n + i] = hit ? f.ffl : -1;
    out[5LL * n + i] = hit ? f.ffr : -1;
    return lm;
}

}  // namespace
