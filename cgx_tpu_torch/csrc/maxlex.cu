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
// A9 (dense_kernel) is one thread per rule: up to 2 x 80 scattered 4-byte
// table reads, gather latency; the arithmetic is ~100 adds and compares.
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

constexpr int kRangeThreads = 128;   // A10: 8 half-warps, a rule each

namespace {

struct Rule {
    int sp[SRCW];          // source ids, -99 pad
    int ttok[TPOSW];       // target tokens at t0 + p (clamped read)
    bool tmask[TPOSW];     // target position p is a terminal of the rule
    bool any_t;
    int nsrc;
};

// _probe_masks
__device__ void load_rule(int r, const int* __restrict__ tgt, int tgt_len,
                          const int* __restrict__ sp, const int* __restrict__ t0v,
                          const int* __restrict__ tendv,
                          const int* __restrict__ g1v,
                          const int* __restrict__ g11v,
                          const int* __restrict__ g2v,
                          const int* __restrict__ g21v, Rule& u) {
    const int t0 = t0v[r], tend = tendv[r];
    const int g1 = g1v[r], g11 = g11v[r], g2 = g2v[r], g21 = g21v[r];
    u.nsrc = 0;
    for (int j = 0; j < SRCW; ++j) {
        u.sp[j] = sp[(long long)r * SRCW + j];
        u.nsrc += u.sp[j] != -99;
    }
    u.any_t = false;
    for (int p = 0; p < TPOSW; ++p) {
        const int pos = t0 + p;
        u.ttok[p] = tgt[clampi(pos, tgt_len)];
        const bool inside = pos <= t0 + tend;
        const bool out1 = g1 < 0 || pos < t0 + g1 || pos > t0 + g11;
        const bool out2 = g2 < 0 || pos < t0 + g2 || pos > t0 + g21;
        u.tmask[p] = inside && out1 && out2;
        u.any_t = u.any_t || u.tmask[p];
    }
}

__device__ __forceinline__ float fmin_(float a, float b) { return b < a ? b : a; }

// neg-log -> feature term: +inf (no probability) scores maxscore
__device__ __forceinline__ float term(float best, float maxscore) {
    return isfinite(best) ? best : maxscore;
}

// _accum_sequential: j ascending, then p ascending, round-to-nearest adds
__device__ __forceinline__ void accumulate(const Rule& u, const float* tf,
                                          const float* te, float& fge,
                                          float& egf) {
    float a = 0.0f;
    for (int j = 0; j < SRCW; ++j)
        if (j < u.nsrc) a = __fadd_rn(a, tf[j]);
    float b = 0.0f;
    for (int p = 0; p < TPOSW; ++p)
        if (u.tmask[p]) b = __fadd_rn(b, te[p]);
    fge = a;
    egf = b;
}

// A9: dense [ns, nt] tables, src id s at row s + 1, tgt id t at column t + 1
__global__ void dense_kernel(const float* __restrict__ L1,
                             const float* __restrict__ L2, int ns, int nt,
                             const int* __restrict__ tgt, int tgt_len,
                             float maxscore, const int* __restrict__ sp,
                             const int* __restrict__ t0,
                             const int* __restrict__ tend,
                             const int* __restrict__ g1,
                             const int* __restrict__ g11,
                             const int* __restrict__ g2,
                             const int* __restrict__ g21, int T,
                             float* __restrict__ fge, float* __restrict__ egf) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= T) return;
    Rule u;
    load_rule(r, tgt, tgt_len, sp, t0, tend, g1, g11, g2, g21, u);
    int sic[SRCW], tic[TPOSW];
    bool oks[SRCW], okt[TPOSW];
    for (int j = 0; j < SRCW; ++j) {
        const int si = u.sp[j] + 1;
        oks[j] = si >= 0 && si < ns;
        sic[j] = oks[j] ? si : 0;
    }
    for (int p = 0; p < TPOSW; ++p) {
        const int ti = u.ttok[p] + 1;
        okt[p] = ti >= 0 && ti < nt;
        tic[p] = okt[p] ? ti : 0;
    }
    float tf[SRCW], te[TPOSW];
    for (int j = 0; j < SRCW; ++j) {
        float best = INFINITY;
        for (int p = 0; p < TPOSW; ++p)
            if (u.tmask[p] && oks[j] && okt[p])
                best = fmin_(best, L2[(long long)sic[j] * nt + tic[p]]);
        if (u.any_t && oks[j]) best = fmin_(best, L2[(long long)sic[j] * nt]);
        tf[j] = term(best, maxscore);
    }
    for (int p = 0; p < TPOSW; ++p) {
        float best = INFINITY;
        for (int j = 0; j < SRCW; ++j)
            if (u.sp[j] >= -1 && oks[j] && okt[p])
                best = fmin_(best, L1[(long long)sic[j] * nt + tic[p]]);
        if (okt[p]) best = fmin_(best, L1[tic[p]]);
        te[p] = term(best, maxscore);
    }
    accumulate(u, tf, te, fge[r], egf[r]);
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
    const int p = lane_id() & 15;
    const int shift = lane_id() & 16;
    // lanes 0-4 load the source ids, lanes 5-10 the six item columns
    int w = -99;
    if (p < SRCW) w = sp[(long long)r * SRCW + p];
    else if (p == SRCW) w = t0v[r];
    else if (p == SRCW + 1) w = tendv[r];
    else if (p == SRCW + 2) w = g1v[r];
    else if (p == SRCW + 3) w = g11v[r];
    else if (p == SRCW + 4) w = g2v[r];
    else if (p == SRCW + 5) w = g21v[r];
    const int rs0 = rs[0], re0 = re[0];
    const int t0 = __shfl_sync(hm, w, SRCW, 16);
    const int tend = __shfl_sync(hm, w, SRCW + 1, 16);
    const int g1 = __shfl_sync(hm, w, SRCW + 2, 16);
    const int g11 = __shfl_sync(hm, w, SRCW + 3, 16);
    const int g2 = __shfl_sync(hm, w, SRCW + 4, 16);
    const int g21 = __shfl_sync(hm, w, SRCW + 5, 16);
    const int nsrc = __popc((__ballot_sync(hm, p < SRCW && w != -99)
                             >> shift) & 0xFFFFu);
    // source lane j's row range (the empty range when invalid)
    const int si = w + 1;
    const bool ok = p < SRCW && si >= 0 && si < ns;
    const int slo = ok ? rs[si] : 0, shi = ok ? re[si] : 0;
    // position p's target token and mask (_probe_masks)
    const int pos = t0 + p;
    const int ttok = tgt[clampi(pos, tgt_len)];
    const bool inside = pos <= t0 + tend;
    const bool out1 = g1 < 0 || pos < t0 + g1 || pos > t0 + g11;
    const bool out2 = g2 < 0 || pos < t0 + g2 || pos > t0 + g21;
    const bool kept = inside && out1 && out2;
    const unsigned tbits = (__ballot_sync(hm, kept) >> shift) & 0xFFFFu;

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
    hi[K - 1] = tbits != 0 ? shi : slo;
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
    // te[p]: the min over the lane's rows; tf[j]: row j's min over the
    // kept positions and its -1 probe; lane 0 accumulates j ascending,
    // then p ascending (accumulate)
    float te = v1[SRCW];
#pragma unroll
    for (int k = 0; k < SRCW; ++k) te = fmin_(te, v1[k]);
    float a = 0.0f;
#pragma unroll
    for (int j = 0; j < SRCW; ++j) {
        float row = v2[j];
#pragma unroll
        for (int d = 8; d >= 1; d >>= 1)
            row = fmin_(row, __shfl_xor_sync(hm, row, d, 16));
        const float nul = __shfl_sync(hm, v2[K - 1], j, 16);
        if (j < nsrc) a = __fadd_rn(a, term(fmin_(row, nul), maxscore));
    }
    float b = 0.0f;
#pragma unroll
    for (int q = 0; q < TPOSW; ++q) {
        const float e = __shfl_sync(hm, te, q, 16);
        if ((tbits >> q) & 1u) b = __fadd_rn(b, term(e, maxscore));
    }
    if (p == 0) {
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
    const int threads = 128;
    dense_kernel<<<cgx_grid(T, threads), threads, 0, (cudaStream_t)stream>>>(
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
