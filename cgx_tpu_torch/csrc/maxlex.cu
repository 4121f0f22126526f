// A9 / A10: MaxLex feature probes and accumulation (lexicalTaskMaxEF,
// ExtractPair.cu:2144-2432).
//
// Replace cgx_tpu/features/maxlex.py:_accum_batch_dense (A9: dense [ns, nt]
// neg-log tables) and _accum_batch_range (A10: per-source row ranges plus a
// binary search over the sorted target column, for vocabularies whose dense
// square exceeds DEV_DENSE_LIMIT).  Per distinct rule: mask the rule's 16
// target positions, take the min neg-log over up to 5 source x 16 target
// probes plus the NULL row/column, and accumulate the two features in
// float32 in exactly the order of _accum_sequential (maxlex.py:146-158):
// source words j ascending, then target positions p ascending.  The adds are
// __fadd_rn, so the compiler can neither contract nor reorder them; the
// tables hold +0 for probability 1 (±0 canonicalised on the host) and +inf for
// missing pairs, so every min compares bit-distinct values consistently.
//
// A9 (dense_quad_kernel) is four lanes per rule, eight rules a warp, lane g
// on target positions g, g + 4, g + 8, g + 12: up to 2 x 5 x 16 + 16 + 5
// scattered 4-byte table reads a rule (tables up to 2 x 512 MB miss the L2
// when the vocabulary is large), every probe of a lane an independent read
// issued at once, three dependent rounds a rule (the rule's columns, its
// target tokens, the probes).  Where the tables sit in L1 the launch is
// bound by the instructions it issues a rule (the columns, the masks, the
// shuffles of the butterflies and the gathers): a half-warp per rule
// issued about twice as many and ran 1.7x longer (PERF.md).
// A10 (range_half_kernel) is a half-warp per rule: its probes are chains of
// dependent bisection reads (up to `steps` = bit_length(max rows of one
// source) each), latency-bound, so the design runs one search per distinct
// (row, target) pair for both value columns (at most 101, where the JAX
// function runs 181), spreads them over a half-warp's lanes with several
// chains in flight per lane, and stops each chain at its range's end.
#include <math.h>

#include "common.cuh"

#define SRCW 5
#define TPOSW 16

constexpr int kDenseThreads = 128;   // A9: 32 groups of 4 lanes, a rule each
constexpr int kRangeThreads = 128;   // A10: 8 half-warps, a rule each

namespace {

__device__ __forceinline__ float fmin_(float a, float b) { return b < a ? b : a; }

// neg-log -> feature term: +inf (no probability) scores maxscore
__device__ __forceinline__ float term(float best, float maxscore) {
    return isfinite(best) ? best : maxscore;
}

// One rule's input on its half-warp (_probe_masks): lanes 0-4 load the
// source ids (`w`, -99 pad), lanes 5-10 the six item columns, passed on by
// shuffle; lane p holds target position p's token and whether the rule
// keeps it; `tbits` the kept positions, `nsrc` the ids that are not pad.
struct HalfRule {
    int w, ttok, nsrc;
    bool kept;
    unsigned tbits;
};

__device__ __forceinline__ HalfRule half_rule(
        unsigned hm, int r, const int* __restrict__ tgt, int tgt_len,
        const int* __restrict__ sp, const int* __restrict__ t0v,
        const int* __restrict__ tendv, const int* __restrict__ g1v,
        const int* __restrict__ g11v, const int* __restrict__ g2v,
        const int* __restrict__ g21v) {
    const int p = lane_id() & 15;
    const int shift = lane_id() & 16;
    int w = -99;
    if (p < SRCW) w = sp[(long long)r * SRCW + p];
    else if (p == SRCW) w = t0v[r];
    else if (p == SRCW + 1) w = tendv[r];
    else if (p == SRCW + 2) w = g1v[r];
    else if (p == SRCW + 3) w = g11v[r];
    else if (p == SRCW + 4) w = g2v[r];
    else if (p == SRCW + 5) w = g21v[r];
    const int t0 = __shfl_sync(hm, w, SRCW, 16);
    const int tend = __shfl_sync(hm, w, SRCW + 1, 16);
    const int g1 = __shfl_sync(hm, w, SRCW + 2, 16);
    const int g11 = __shfl_sync(hm, w, SRCW + 3, 16);
    const int g2 = __shfl_sync(hm, w, SRCW + 4, 16);
    const int g21 = __shfl_sync(hm, w, SRCW + 5, 16);
    HalfRule u;
    u.w = w;
    u.nsrc = __popc((__ballot_sync(hm, p < SRCW && w != -99) >> shift)
                    & 0xFFFFu);
    const int pos = t0 + p;
    u.ttok = tgt[clampi(pos, tgt_len)];
    const bool inside = pos <= t0 + tend;
    const bool out1 = g1 < 0 || pos < t0 + g1 || pos > t0 + g11;
    const bool out2 = g2 < 0 || pos < t0 + g2 || pos > t0 + g21;
    u.kept = inside && out1 && out2;
    u.tbits = (__ballot_sync(hm, u.kept) >> shift) & 0xFFFFu;
    return u;
}

// The accumulation of A9 and A10 (_accum_sequential, maxlex.py:146-158) on
// a group of G lanes (G divides 32, groups aligned; `m` the lanes that call
// it), target position p held by lane p % G at slot p / G.  row[j] is the
// lane's min over its slots of source row j's P(t|s) probes (+inf where a
// position is not kept), nul[s] source (s * G + lane)'s target -1 probe,
// te[s] the min over the rows of the P(s|t) probes at the lane's slot s.
// tf[j] is row j's min over the group by an xor butterfly and source j's -1
// probe; lane 0 of the group adds j ascending, then p ascending, with
// round-to-nearest adds.
template <int G>
__device__ __forceinline__ void accumulate_group(
        unsigned m, const float (&row)[SRCW],
        const float (&nul)[(SRCW + G - 1) / G], const float (&te)[TPOSW / G],
        int nsrc, unsigned tbits, float maxscore, float& fge, float& egf) {
    float a = 0.0f;
#pragma unroll
    for (int j = 0; j < SRCW; ++j) {
        float r = row[j];
#pragma unroll
        for (int d = G / 2; d >= 1; d >>= 1)
            r = fmin_(r, __shfl_xor_sync(m, r, d, G));
        const float n = __shfl_sync(m, nul[j / G], j % G, G);
        if (j < nsrc) a = __fadd_rn(a, term(fmin_(r, n), maxscore));
    }
    float b = 0.0f;
#pragma unroll
    for (int q = 0; q < TPOSW; ++q) {
        const float e = __shfl_sync(m, te[q / G], q % G, G);
        if ((tbits >> q) & 1u) b = __fadd_rn(b, term(e, maxscore));
    }
    fge = a;
    egf = b;
}

// A9: four lanes per rule, eight rules a warp, over the dense [ns, nt]
// tables, src id s at row s + 1, tgt id t at column t + 1.  Word k of the
// rule's columns (the five source ids, then t0, tend, g1, g11, g2, g21) is
// loaded once, by lane k % 4, and passed on by shuffle.  Lane g holds
// target positions g, g + 4, g + 8, g + 12 and issues their probes as
// independent reads where the rule keeps them: L2 and L1 at each valid
// source row, and L1's NULL row; and the NULL column of L2 for its sources
// g and g + 4 where any position is kept.  Whole-warp masks: a warp returns
// only when all its rules lie past T, and a tail group repeats the last
// rule and writes nothing.
constexpr int kDenseGroup = 4;

__device__ __forceinline__ int rule_word(int k, int r,
                                         const int* __restrict__ sp,
                                         const int* __restrict__ t0v,
                                         const int* __restrict__ tendv,
                                         const int* __restrict__ g1v,
                                         const int* __restrict__ g11v,
                                         const int* __restrict__ g2v,
                                         const int* __restrict__ g21v) {
    if (k < SRCW) return sp[(long long)r * SRCW + k];
    switch (k) {
        case SRCW: return t0v[r];
        case SRCW + 1: return tendv[r];
        case SRCW + 2: return g1v[r];
        case SRCW + 3: return g11v[r];
        case SRCW + 4: return g2v[r];
        case SRCW + 5: return g21v[r];
        default: return 0;
    }
}

__global__ void __launch_bounds__(kDenseThreads)
dense_quad_kernel(const float* __restrict__ L1, const float* __restrict__ L2,
                  int ns, int nt, const int* __restrict__ tgt, int tgt_len,
                  float maxscore, const int* __restrict__ sp,
                  const int* __restrict__ t0v, const int* __restrict__ tendv,
                  const int* __restrict__ g1v, const int* __restrict__ g11v,
                  const int* __restrict__ g2v, const int* __restrict__ g21v,
                  int T, float* __restrict__ fge, float* __restrict__ egf) {
    constexpr int G = kDenseGroup;
    constexpr int PL = TPOSW / G;              // positions a lane
    constexpr int CW = (SRCW + 6 + G - 1) / G; // column words a lane
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if ((t >> 5) * (32 / G) >= T) return;      // the whole warp
    const int r = min(t / G, T - 1);
    const int g = lane_id() & (G - 1);
    int c[CW];
#pragma unroll
    for (int s = 0; s < CW; ++s)
        c[s] = rule_word(g + G * s, r, sp, t0v, tendv, g1v, g11v, g2v, g21v);
    int src[SRCW];
#pragma unroll
    for (int j = 0; j < SRCW; ++j)
        src[j] = __shfl_sync(kFull, c[j / G], j % G, G);
    const int t0 = __shfl_sync(kFull, c[SRCW / G], SRCW % G, G);
    const int tend = __shfl_sync(kFull, c[(SRCW + 1) / G], (SRCW + 1) % G, G);
    const int g1 = __shfl_sync(kFull, c[(SRCW + 2) / G], (SRCW + 2) % G, G);
    const int g11 = __shfl_sync(kFull, c[(SRCW + 3) / G], (SRCW + 3) % G, G);
    const int g2 = __shfl_sync(kFull, c[(SRCW + 4) / G], (SRCW + 4) % G, G);
    const int g21 = __shfl_sync(kFull, c[(SRCW + 5) / G], (SRCW + 5) % G, G);
    int nsrc = 0;
#pragma unroll
    for (int j = 0; j < SRCW; ++j) nsrc += src[j] != -99;
    int ti[PL];
    bool probe[PL];
    unsigned local = 0u;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
        const int pos = t0 + g + G * i;
        const int tok = tgt[clampi(pos, tgt_len)];
        const bool inside = pos <= t0 + tend;
        const bool out1 = g1 < 0 || pos < t0 + g1 || pos > t0 + g11;
        const bool out2 = g2 < 0 || pos < t0 + g2 || pos > t0 + g21;
        const bool kept = inside && out1 && out2;
        local |= (unsigned)kept << (g + G * i);
        ti[i] = tok + 1;
        probe[i] = kept && ti[i] >= 0 && ti[i] < nt;
    }
    unsigned tbits = local;
#pragma unroll
    for (int d = G / 2; d >= 1; d >>= 1)
        tbits |= __shfl_xor_sync(kFull, tbits, d, G);
    float te[PL], row[SRCW];
#pragma unroll
    for (int i = 0; i < PL; ++i) te[i] = probe[i] ? L1[ti[i]] : INFINITY;
#pragma unroll
    for (int j = 0; j < SRCW; ++j) {
        const int si = src[j] + 1;
        const bool ok = si >= 0 && si < ns;
        row[j] = INFINITY;
#pragma unroll
        for (int i = 0; i < PL; ++i) {
            if (probe[i] && ok) {
                const long long at = (long long)si * nt + ti[i];
                row[j] = fmin_(row[j], L2[at]);
                te[i] = fmin_(te[i], L1[at]);
            }
        }
    }
    float nul[(SRCW + G - 1) / G];
#pragma unroll
    for (int s = 0; s < (SRCW + G - 1) / G; ++s) {
        const int si = c[s] + 1;       // source g + G * s, where one
        nul[s] = g + G * s < SRCW && si >= 0 && si < ns && tbits != 0u
                     ? L2[(long long)si * nt] : INFINITY;
    }
    float a, b;
    accumulate_group<G>(kFull, row, nul, te, nsrc, tbits, maxscore, a, b);
    if (g == 0 && t / G < T) {
        fge[r] = a;
        egf[r] = b;
    }
}

// A10: a half-warp per rule over the source row ranges [rs[s + 1],
// re[s + 1]) of the (src, tgt)-sorted target column lt and its neg-log
// value columns.
//
// One search per distinct (row, target) pair serves both value columns: the
// lower bound of t in lt[lo, hi) gives loc, and the pair is present when lo
// < hi_init and lt[loc] == t; then lnv2[loc] is its P(t|s) probe and
// lnv1[loc] its P(s|t) probe.  The pairs a rule needs: each valid source
// row x the kept target positions (both columns), each valid source row x
// the target -1 when any position is kept (lnv2), and the NULL row [rs[0],
// re[0]) x the kept positions (lnv1): at most 5 x 16 + 5 + 16 = 101.  An
// invalid source (si outside [0, ns)) is the empty range and an empty range
// is +inf with no read.
//
// Lane p of the half takes target position p: the searches of the five
// source rows and the NULL row at p, and lanes 0-4 also source p's target
// -1 search.  Each search keeps the midpoint sequence (lo + hi) >> 1 of the
// fixed-`steps` loop (_tgt_range_lookup_neglog) and stops at lo >= hi or
// after `steps` steps, which gives the same lo; a lane interleaves its
// searches' steps, and the final lt word and both value words are read
// together.  te[p] is the lane's own min over the rows, tf[j] the min over
// the position lanes by a butterfly, and lane 0 takes the -1 probes and the
// te[p] by shuffles and accumulates in the reference order with __fadd_rn.
// Min is exact in any order: the tables hold +0-canonicalised neg-logs or
// +inf, no -0, no NaN.  A half-warp rather than a warp per rule: a rule
// needs ~11 searches at europarl, and two rules a warp halve the warps to
// about one wave on the card (40 registers, no stack), 1.2x faster than a
// warp per rule measured in the same run (PERF.md).
__global__ void __launch_bounds__(kRangeThreads)
range_half_kernel(const int* __restrict__ rs, const int* __restrict__ re,
                  int ns, const int* __restrict__ lt,
                  const float* __restrict__ lnv1,
                  const float* __restrict__ lnv2, int nlex, int steps,
                  const int* __restrict__ tgt, int tgt_len, float maxscore,
                  const int* __restrict__ sp, const int* __restrict__ t0v,
                  const int* __restrict__ tendv,
                  const int* __restrict__ g1v,
                  const int* __restrict__ g11v,
                  const int* __restrict__ g2v,
                  const int* __restrict__ g21v, int T,
                  float* __restrict__ fge, float* __restrict__ egf) {
    const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 4;
    if (r >= T) return;                   // the whole half-warp
    const unsigned hm = half_mask();
    const HalfRule u = half_rule(hm, r, tgt, tgt_len, sp, t0v, tendv, g1v,
                                 g11v, g2v, g21v);
    const int rs0 = rs[0], re0 = re[0];
    // source lane j's row range (the empty range when invalid)
    const int si = u.w + 1;
    const bool ok = (lane_id() & 15) < SRCW && si >= 0 && si < ns;
    const int slo = ok ? rs[si] : 0, shi = ok ? re[si] : 0;
    const int ttok = u.ttok;
    const bool kept = u.kept;

    // k < 5: source row k at position p; k = 5: the NULL row; k = 6:
    // source p's target -1 (lanes 0-4)
    constexpr int K = SRCW + 2;
    int lo[K], hi[K], key[K];
#pragma unroll
    for (int k = 0; k < SRCW; ++k) {
        const int a = __shfl_sync(hm, slo, k, 16);
        const int b = __shfl_sync(hm, shi, k, 16);
        lo[k] = a;
        hi[k] = kept ? b : a;
        key[k] = ttok;
    }
    lo[SRCW] = rs0;
    hi[SRCW] = kept ? re0 : rs0;
    key[SRCW] = ttok;
    lo[K - 1] = slo;
    hi[K - 1] = u.tbits != 0 ? shi : slo;
    key[K - 1] = -1;
    int hi_init[K];
#pragma unroll
    for (int k = 0; k < K; ++k) hi_init[k] = hi[k];
    for (int s = 0; s < steps; ++s) {
        int mid[K], v[K];
        bool live = false;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            mid[k] = (lo[k] + hi[k]) >> 1;
            v[k] = 0;
            if (lo[k] < hi[k]) {
                v[k] = lt[clampi(mid[k], nlex)];
                live = true;
            }
        }
        if (!live) break;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            if (lo[k] < hi[k]) {
                if (v[k] < key[k]) lo[k] = mid[k] + 1;
                else hi[k] = mid[k];
            }
        }
    }
    float v1[K], v2[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        v1[k] = INFINITY;
        v2[k] = INFINITY;
        if (lo[k] < hi_init[k]) {
            const int loc = clampi(lo[k], nlex);
            const int at = lt[loc];
            const float a1 = lnv1[loc], a2 = lnv2[loc];
            if (at == key[k]) {
                v1[k] = a1;
                v2[k] = a2;
            }
        }
    }
    // te[p]: the min over the lane's rows
    float te = v1[SRCW];
#pragma unroll
    for (int k = 0; k < SRCW; ++k) te = fmin_(te, v1[k]);
    float row[SRCW];
#pragma unroll
    for (int k = 0; k < SRCW; ++k) row[k] = v2[k];
    const float nul[1] = {v2[K - 1]}, tes[1] = {te};
    float a, b;
    accumulate_group<16>(hm, row, nul, tes, u.nsrc, u.tbits, maxscore, a, b);
    if ((lane_id() & 15) == 0) {
        fge[r] = a;
        egf[r] = b;
    }
}

}  // namespace

CGX_EXPORT int cgx_maxlex_dense(const float* L1, const float* L2, int ns,
                                int nt, const int* tgt, int tgt_len,
                                float maxscore, const int* sp, const int* t0,
                                const int* tend, const int* g1, const int* g11,
                                const int* g2, const int* g21, int T,
                                float* fge, float* egf, void* stream) {
    dense_quad_kernel<<<cgx_grid(T, kDenseThreads / kDenseGroup),
                        kDenseThreads, 0,
                        (cudaStream_t)stream>>>(
        L1, L2, ns, nt, tgt, tgt_len, maxscore, sp, t0, tend, g1, g11, g2, g21,
        T, fge, egf);
    return (int)cudaGetLastError();
}

CGX_EXPORT int cgx_maxlex_range(const int* rs, const int* re, int ns,
                                const int* lt, const float* lnv1,
                                const float* lnv2, int nlex, int steps,
                                const int* tgt, int tgt_len, float maxscore,
                                const int* sp, const int* t0, const int* tend,
                                const int* g1, const int* g11, const int* g2,
                                const int* g21, int T, float* fge, float* egf,
                                void* stream) {
    range_half_kernel<<<cgx_grid(T, kRangeThreads / 16), kRangeThreads, 0,
                        (cudaStream_t)stream>>>(
        rs, re, ns, lt, lnv1, lnv2, nlex, steps, tgt, tgt_len, maxscore, sp, t0,
        tend, g1, g11, g2, g21, T, fge, egf);
    return (int)cudaGetLastError();
}
