// Device functions shared by the extraction kernels A6 (contig.cu and B4's
// dist.cu, through contig.cuh), A7 (onegap.cu) and A8 (twogap.cu): the
// per-item helpers of cgx_tpu/extract/device.py on a half-warp, lane k
// (0..15) on span word k, target window entry k or growth step k.  All 32
// lanes call each function that shuffles or ballots together, so the
// masks name the whole warp (bare SHFL/VOTE, no convergence scaffolding)
// and a width of 16 keeps a shuffle inside its half.  Every read is
// View::atg (common.cuh), as the JAX reads are clipped to the (global)
// array: identity views on the replicated index, a shard's slices else.
#pragma once

#include "common.cuh"

#define IMAX 14   // max growth distance (lm + i <= max_rule_span, lm >= 1)
#define CWID 16   // span scan width
#define HMAX 14   // H = max_rule_span - 1 <= 14 (ExtractorConfig bound)

namespace {

struct Arrays {
    View refstr;
    View rlp;        // uint32 RLP words stored as int32
    View lr_tar;     // (L << 8) | R per target token
};

// (L, R) of the RLP word `t` read at `pos`; positions before the corpus
// start read as unaligned (_rlp_LR)
struct LR { int L, R; bool al; };

__device__ __forceinline__ LR decode_lr(int pos, unsigned t) {
    LR w = {255, 255, false};
    if (pos >= 0) {
        w.L = (int)((t >> 24) & 0xFF);
        w.R = (int)((t >> 16) & 0xFF);
    }
    w.al = w.L != 255 && w.R != 255;
    return w;
}

// a target span's min(L) and 255 - max(R) in the high and low halfwords
// of one word, so that one __vminu2 folds both; an unaligned entry is
// (256, 256), which reads back as min 256 and max -1
constexpr unsigned kNoLR = (256u << 16) | 256u;

__device__ __forceinline__ unsigned pack_lr(int L, int R) {
    return ((unsigned)L << 16) | (unsigned)(255 - R);
}

// an lr_tar word ((L << 8) | R) packed, kNoLR where unaligned
__device__ __forceinline__ unsigned pack_tar(int w) {
    const int L = w >> 8, R = w & 255;
    return L != 255 && R != 255 ? pack_lr(L, R) : kNoLR;
}

__device__ __forceinline__ void unpack_lr(unsigned p, int& mn, int& mx) {
    mn = (int)(p >> 16);
    mx = 255 - (int)(p & 0xFFFFu);
}

// __vminu2 over the half's 16 lanes
__device__ __forceinline__ unsigned half_min2(unsigned v) {
#pragma unroll
    for (int d = 8; d; d >>= 1)
        v = __vminu2(v, __shfl_xor_sync(kFull, v, d, 16));
    return v;
}

// inclusive prefix of __vminu2 over lanes 0..k of the half
__device__ __forceinline__ unsigned prefix_min2(unsigned v) {
    const int k = lane_id() & 15;
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) {
        const unsigned o = __shfl_up_sync(kFull, v, d, 16);
        if (k >= d) v = __vminu2(v, o);
    }
    return v;
}

// a source span [start, ender] of at most CWID words, lane k on the RLP
// word `t` at start + k: min(L)/max(R) over its aligned words, and whether
// its first and last words are aligned (checkBoundary's scan, the gap
// spans of the JAX gapspan)
struct HalfSpan { int mn, mx; bool al_first, al_last; };

__device__ __forceinline__ HalfSpan span_scan(int start, int ender,
                                              unsigned t) {
    const int k = lane_id() & 15;
    const LR w = decode_lr(start + k, t);
    HalfSpan s;
    const bool in = start + k <= ender && w.al;
    unpack_lr(half_min2(in ? pack_lr(w.L, w.R) : kNoLR), s.mn, s.mx);
    s.al_first = __shfl_sync(kFull, (int)w.al, 0, 16) != 0;
    s.al_last = __shfl_sync(kFull, (int)w.al,
                            clip(ender - start, 0, CWID - 1), 16) != 0;
    return s;
}

// _sent_anchor of the span starting at `pos`: tempind from the span's word
// 0 (lane 0's `t`; sentstart is tempind + 1), then stb = rlp[tempind], one
// address for the whole half
__device__ __forceinline__ int sent_tempind(int pos, unsigned t) {
    const unsigned t0 = __shfl_sync(kFull, t, 0, 16);
    return pos - (int)((t0 >> 8) & 0xFF) - 1;
}

__device__ __forceinline__ int sent_stb(const View& rlp, int tempind) {
    return tempind == -1 ? 0 : rlp.atg(tempind);
}

// checkBoundary (ExtractPair.cu:252-342, _check_boundary_dev) of the source
// span [start, ender] from its scan and sentence anchor: code 4, 2 or 3
// where its first or last word is unaligned, the target span [ts, te], and
// `check` where consistent() over it decides between codes 1 and 0
// (consistent_word, boundary_code)
struct Boundary { int code, ts, te, sentstart; bool check; };

__device__ __forceinline__ Boundary boundary(const HalfSpan& s, int start,
                                             int ender, int tempind, int stb,
                                             int mrs) {
    const bool first_un = !s.al_first, last_un = !s.al_last;
    Boundary b;
    b.code = first_un && (ender == start || last_un) ? 4
           : first_un ? 2 : last_un ? 3 : 0;
    b.ts = s.mn + stb;
    b.te = s.mx + stb;
    b.sentstart = tempind + 1;
    b.check = b.code == 0 && s.mn <= s.mx && s.mx - s.mn < mrs;
    return b;
}

// lane k's lr_tar word ts + k of consistent()'s target span, read only
// where the check is made and ts + k <= te (an unaligned word elsewhere)
__device__ __forceinline__ int consistent_word(const View& lr_tar,
                                               const Boundary& b) {
    const int pos = b.ts + (lane_id() & 15);
    return b.check && pos <= b.te ? lr_tar.atg(pos) : 255 << 8;
}

// the code: where the check is made, 1 if consistent() holds over the
// words (_consistent_dev) and 0 if not
__device__ __forceinline__ int boundary_code(const Boundary& b, int w,
                                             int start, int ender) {
    int bmin, bmax;
    unpack_lr(half_min2(pack_tar(w)), bmin, bmax);
    const bool cons = b.sentstart + bmin == start
                      && b.sentstart + bmax == ender;
    return b.check ? (int)cons : b.code;
}

// lane k's words anchor + k and anchor - k of a (2H + 1)-wide target
// window (k <= H; the others read as unaligned and are never looked up)
struct WinWords { int f, b; };

__device__ __forceinline__ WinWords window_words(const View& lr_tar,
                                                 int anchor, int H) {
    const int k = lane_id() & 15;
    WinWords w = {255 << 8, 255 << 8};
    if (k <= H) {
        w.f = lr_tar.atg(anchor + k);
        w.b = lr_tar.atg(anchor - k);
    }
    return w;
}

// the anchored target window of one item: lane k holds entry k (k <= H) of
// the forward (anchor..anchor+k) and backward (anchor-k..anchor) prefix
// min(L)/max(R) (_tar_window_prefixes), packed (pack_lr)
struct HalfWindow { unsigned f, b; };

__device__ __forceinline__ HalfWindow window_scan(const WinWords& ww) {
    return {prefix_min2(pack_tar(ww.f)), prefix_min2(pack_tar(ww.b))};
}

// range-min(L)/max(R) over window offsets -lo..hi: the backward prefix at
// lo and the forward one at hi, from lanes lo and hi (each lane may ask
// for its own range)
__device__ __forceinline__ void window_range(const HalfWindow& w, int lo,
                                             int hi, int& mn, int& mx) {
    unpack_lr(__vminu2(__shfl_sync(kFull, w.b, lo, 16),
                       __shfl_sync(kFull, w.f, hi, 16)), mn, mx);
}

// consistent() over [ts, te] from the anchored prefixes (_win_check)
__device__ __forceinline__ bool half_win_check(const HalfWindow& w,
                                               int anchor, int ts, int te,
                                               int start_chk, int end_chk,
                                               int sentstart, int H) {
    int bmin, bmax;
    window_range(w, clip(anchor - ts, 0, H), clip(te - anchor, 0, H), bmin,
                 bmax);
    if (ts > te) { bmin = 256; bmax = -1; }
    return sentstart + bmin == start_chk && sentstart + bmax == end_chk;
}

// the first lane of the half where `p` holds, 0 where none does
__device__ __forceinline__ int first_lane(bool p) {
    return (__ffs((__ballot_sync(kFull, p) >> (lane_id() & 16)) | 0x10000u)
            - 1) & 15;
}

// growth step k (lane k < IMAX) of one side (_grow_side_arrays), from the
// step's position, token and raw RLP word: its (L, R), a token >= 2 at
// pos >= 0 (has) and aligned; side_prefix adds the prefix min(L)/max(R)
// over the aligned steps 0..k, side_gap the X gap's consistency
struct HalfStep { int L, R, pmin, pmax; bool has, al, gap; };

__device__ __forceinline__ HalfStep side_step(int pos, int tok, unsigned t) {
    const bool in = (lane_id() & 15) < IMAX;
    const LR w = decode_lr(pos, t);
    HalfStep s = {w.L, w.R, 255, 0, false, false, false};
    s.al = in && w.al;
    s.has = in && pos >= 0 && tok >= 2;
    return s;
}

// the side's window anchor: L at the first aligned step; jnp.argmax of an
// all-false mask is 0, so with no aligned step step 0's L (unused)
__device__ __forceinline__ int side_anchor(const HalfStep& s, int stb) {
    return stb + __shfl_sync(kFull, s.L, first_lane(s.al), 16);
}

__device__ __forceinline__ void side_prefix(HalfStep& s) {
    unpack_lr(prefix_min2(pack_lr(s.al ? s.L : 255, s.al ? s.R : 0)), s.pmin,
              s.pmax);
}

__device__ __forceinline__ void side_gap(HalfStep& s, const WinWords& ww,
                                         int anchor, bool left, int cs,
                                         int ender, int sentstart, int stb,
                                         int H) {
    const int k = lane_id() & 15;
    const HalfWindow w = window_scan(ww);
    const int i = k + 1;
    const bool gap = half_win_check(w, anchor, stb + s.pmin, stb + s.pmax,
                                    left ? cs - i : ender + 1,
                                    left ? cs - 1 : ender + i, sentstart, H);
    s.gap = k < IMAX && gap;
}

struct Rule { bool v; int ts, te, g1s, g1e, g2s, g2e; };

// one int32 per family: valid bit + 4-bit offsets from ts (_pack_family)
__device__ __forceinline__ int off(bool v, int x, int ts, int sh) {
    return clip(v ? x - ts : 0, 0, 15) << sh;
}

__device__ __forceinline__ void pack(const Rule& r, bool two_gaps, int* out,
                                     int col, int n, int item) {
    int pk = (int)r.v | off(r.v, r.te, r.ts, 1) | off(r.v, r.g1s, r.ts, 5)
             | off(r.v, r.g1e, r.ts, 9);
    if (two_gaps) pk |= off(r.v, r.g2s, r.ts, 13) | off(r.v, r.g2e, r.ts, 17);
    out[(long long)col * n + item] = r.ts;
    out[(long long)(col + 1) * n + item] = pk;
}

}  // namespace
