// The LCP-accelerated suffix-array search, one warp per search, shared by
// kernel B1 (lcp.cu: pass 1 and pass 2) and kernel B4 (dist.cu: the
// query-DP step's pass-1 lanes).
//
// A transcription of cgx_tpu/search/passes.py's _search_body (:84-163),
// _skip_at (:46-53), _bound_walk (:56-81) and _pass1_token (:166-192): the
// binary search of suffixArrayFindLwRwKernelTwoWayTDI /
// suffixArrayFindConnectionTwoWayTDI (SuffixArray.cu:402-767, 109-400).
//
// The search is a chain of dependent reads: each step's midpoint depends on
// the last step's decision.  But from a window (L, R) the midpoints of the
// next kSearchLevels levels follow from plain bisection (31 nodes in heap
// order; pass 2's first midpoint is the pin MM while (L, R) == (LL, RR)), so
// a round lets lane j load every LCP-tree and SA word that node j's step can
// use on either branch (lcpleft[M], lcpright[M], both words of the midpoint
// tree at (L + M) >> 1 and at (R + M) >> 1, sa[M]) as independent reads,
// then decides the levels in order with the sequential step's own
// arithmetic, taking each word from its node's lane by shuffle.  Only the
// eq-case compare still reads the corpus and the query, 32 positions a
// round (lane k at position k), a ballot finding where the sequential loop
// stops.  The two bound walks decide on LCP-tree words alone: the up walk
// on lanes 0-15 and the down walk on lanes 16-31 run side by side, a round
// of 15 nodes deciding kWalkLevels levels by one ballot.
//
// Exactness: the arrays are read-only, and each step takes the word at the
// same clamped address that the sequential step reads (the node's window is
// the step's window, since a step moves exactly one of L, R to M unless the
// search ends).  A node past the search's end (found, or R - L <= 1) reads
// clamped addresses, and its words are never used.  All state is uniform
// over the warp, so every branch is; a warp returns as a whole.
// tests/test_torch_passes.py (test_b1_round_loads_cover_every_read) holds
// every read of the plain search and walks against its round's words;
// kSearchLevels and kWalkLevels are tools/reads.py's SEARCH_LEVELS and
// WALK_LEVELS there.
#pragma once

#include "common.cuh"

#define QPAD 8   // guarded query reads past a query's end return -2
#define SEP 1    // sentence separator token id

constexpr int kLcpThreads = 128;     // 4 warps, a search each
constexpr int kSearchLevels = 5;     // 31 nodes a round, one a lane
constexpr int kWalkLevels = 4;       // 15 nodes a round, one a lane of a half

namespace {

struct Index {
    const int* refstr; int ref_len;
    const int* sa; int sa_len;
    const int* lcpl; const int* lcpr; int lcp_len;
    const int* qtok; int q_len;
};

// pass 2's first midpoint is MM while (L, R) == (LL, RR)
struct Pin {
    bool on; int LL, MM, RR;

    __device__ __forceinline__ int mid(int L, int R) const {
        return on && L == LL && R == RR && MM >= 0 ? MM : (L + R) >> 1;
    }
};

// the window of heap node j below (L, R): the bits of j + 1 after its
// leading one, most significant first, are the path (1: L = M, 0: R = M),
// so node j's children are 2j + 1 (R = M) and 2j + 2 (L = M)
__device__ __forceinline__ void node_window(int j, const Pin& pin, int& L,
                                            int& R) {
    const int n = j + 1;
    for (int k = 30 - __clz(n); k >= 0; --k) {
        const int M = pin.mid(L, R);
        if ((n >> k) & 1) L = M;
        else R = M;
    }
}

// LCP(M, other) via the midpoint tree (_skip_at): the direct word when
// |other - M| == 1, else min(lcpleft, lcpright) at the midpoint of (other, M)
__device__ __forceinline__ int skip_at(const Index& x, int other, int M,
                                       const int* direct) {
    if (abs(other - M) == 1) return direct[clampi(M, x.lcp_len)];
    const int ht = clampi((other + M) >> 1, x.lcp_len);
    return min(x.lcpl[ht], x.lcpr[ht]);
}

struct Found { int longlen, ffh, ffl, ffr; };

// The LCP binary search of one lane (_search_body under the while_loop), by
// the whole warp.  Pass 1: no pin, record (M, L, R) at the first matched
// token and break at the end of the suffix; pass 2: record and break once
// require_match tokens agree, no suffix-end check (suffixlen 1 << 30).
template <bool kPass1>
__device__ Found search_warp(const Index& x, int tok, int suffixlen, int L,
                             int R, int require_match, const Pin& pin) {
    const int lane = lane_id();
    int Llcp = 0, Rlcp = 0, longlen = 0, temp = -1;
    int ffh = -1, ffl = -1, ffr = -1;
    bool found = kPass1 && x.qtok[clampi(tok, x.q_len)] == -1;
    while (R - L > 1 && !found) {
        // the round: lane j < 31 loads node j's words (lane 31's go unused)
        int wl = L, wr = R;
        node_window(lane, pin, wl, wr);
        const int wm = pin.mid(wl, wr);
        const int skl = skip_at(x, wl, wm, x.lcpl);
        const int skr = skip_at(x, wr, wm, x.lcpr);
        const int saw = x.sa[clampi(wm, x.sa_len)];
        for (int d = 0, j = 0; d < kSearchLevels && R - L > 1 && !found;
             ++d) {
            const int M = pin.mid(L, R);
            const bool use_l = Llcp >= Rlcp;
            const int ll0 = use_l ? Llcp : Rlcp;
            const int skip = __shfl_sync(kFull, use_l ? skl : skr, j);
            const bool lt = ll0 < skip, gt = ll0 > skip, eq = !lt && !gt;
            int ll = ll0, tp = temp, a = 0, b = 0;
            bool found_eq = false;
            if (eq) {
                // the compare (SuffixArray.cu:550-611): position m = ll0 + k
                // of lane k; the sequential loop stops at the first m with
                // a break (m = 0: the pre-break), a == -1, b == SEP or a != b
                const int sm = __shfl_sync(kFull, saw, j);
                int ms = 0;
                for (int base = 0;; base += 32) {
                    const int m = base + lane, pos = ll0 + m;
                    const int am = x.qtok[clampi(
                        tok + min(pos, suffixlen + QPAD - 1), x.q_len)];
                    const int bm = x.refstr[clampi(sm + pos, x.ref_len)];
                    const bool brk = m == 0
                        ? kPass1 && ll0 >= suffixlen
                        : (kPass1 ? pos >= suffixlen
                                  : ffh == -1 && pos >= require_match);
                    const unsigned ev = __ballot_sync(
                        kFull, brk || am == -1 || bm == SEP || am != bm);
                    if (ev == 0u) continue;
                    const int f = __ffs(ev) - 1;
                    a = __shfl_sync(kFull, am, f);
                    b = __shfl_sync(kFull, bm, f);
                    ms = base + f;
                    break;
                }
                if (ms == 0) {
                    // no loop step: pre-break, not entered (b == SEP, tp
                    // stays temp) or a mismatch at ll0
                    if (a == -1 || (kPass1 && ll0 >= suffixlen))
                        found_eq = true;
                    else if (b != SEP)
                        tp = a - b;
                } else {
                    // ms loop steps ran over matching tokens (tp == 0)
                    ll = ll0 + ms;
                    const bool brk = kPass1
                        ? ll >= suffixlen
                        : ffh == -1 && ll >= require_match;
                    if (kPass1 ? ffh == -1 : brk) {
                        ffh = M;
                        ffl = L;
                        ffr = R;
                    }
                    tp = 0;
                    if (brk || a == -1) found_eq = true;
                    else if (b != SEP) tp = a - b;
                }
            }
            // post-compare branch (SuffixArray.cu:598-610) for eq lanes that
            // did not break
            const bool post = eq && !found_eq;
            const bool a_neg = post && a == -1;
            const bool b_sep = post && !a_neg && b == SEP;
            const bool t_pos = post && !a_neg && !b_sep && tp > 0;
            const bool t_neg = post && !a_neg && !b_sep && !t_pos;
            const bool go_left = (lt && use_l) || (gt && !use_l) || b_sep
                                 || t_pos || a_neg;
            const bool go_right = (lt && !use_l) || (gt && use_l) || t_neg
                                  || a_neg;
            const int nLlcp = (gt && !use_l) ? skip
                              : ((b_sep || t_pos) ? ll : Llcp);
            const int nRlcp = (gt && use_l) ? skip : (t_neg ? ll : Rlcp);
            if (go_left) L = M;
            if (go_right) R = M;
            Llcp = nLlcp;
            Rlcp = nRlcp;
            longlen = ll;
            temp = tp;
            found = found_eq;
            j = 2 * j + (go_left ? 2 : 1);
        }
    }
    return {longlen, ffh, ffl, ffr};
}

// Both bound walks from the firstfindhit window (_bound_walk): lanes 0-15
// walk up, lanes 16-31 down, to the outermost SA index whose skip >= match
// -> the lane's own walk's result.  Every lane of the warp calls it.
__device__ int walks_half(const Index& x, int ffh, int ffl, int ffr,
                          int match) {
    const bool up = lane_id() < 16;
    const int p = lane_id() & 15;
    const Pin none = {false, 0, 0, 0};
    int L = up ? ffl : ffh, R = up ? ffh : ffr, longest = ffh;
    while (__any_sync(kFull, R - L > 1)) {
        bool take = false;
        if (R - L > 1 && p < 15) {
            int wl = L, wr = R;
            node_window(p, none, wl, wr);
            const int wm = (wl + wr) >> 1;
            take = (up ? skip_at(x, wr, wm, x.lcpr)
                       : skip_at(x, wl, wm, x.lcpl)) >= match;
        }
        const unsigned bits = __ballot_sync(kFull, take) >> (lane_id() & 16);
        for (int d = 0, j = 0; d < kWalkLevels && R - L > 1; ++d) {
            const int M = (L + R) >> 1;
            const bool t = (bits >> j) & 1u;
            if (t) longest = M;
            // up: a take moves R to M; down: a take moves L to M
            const bool left = up != t;
            if (left) L = M;
            else R = M;
            j = 2 * j + (left ? 2 : 1);
        }
    }
    return longest;
}

// _pass1_token for lane i of n, by the whole warp: search from [0, reflen -
// 1] and write the six pass-1 words of column i of out [6, n]; returns the
// longestmatch word (on every lane)
__device__ int pass1_warp(const Index& x, int tok, int suffixlen, int reflen,
                          int n, int i, int* __restrict__ out) {
    const bool oov = x.qtok[clampi(tok, x.q_len)] == -1;
    const Pin none = {false, 0, 0, 0};
    const Found f = search_warp<true>(x, tok, suffixlen, 0, reflen - 1, 0,
                                      none);
    const bool hit = !oov && f.ffh != -1 && f.longlen > 0;
    const int w = hit ? walks_half(x, f.ffh, f.ffl, f.ffr, 1) : -1;
    const int lm = oov || f.longlen <= 0 ? 0 : f.longlen;
    if (lane_id() == 0) {
        out[i] = lm;
        out[(long long)n + i] = w;
        out[3LL * n + i] = hit ? f.ffh : -1;
        out[4LL * n + i] = hit ? f.ffl : -1;
        out[5LL * n + i] = hit ? f.ffr : -1;
    } else if (lane_id() == 16) {
        out[2LL * n + i] = w;
    }
    return lm;
}

}  // namespace
