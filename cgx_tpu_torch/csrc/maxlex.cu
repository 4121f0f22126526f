// A9 / A10: MaxLex feature probes and accumulation (lexicalTaskMaxEF,
// ExtractPair.cu:2144-2432).
//
// Replace cgx_tpu/features/maxlex.py:_accum_batch_dense (A9: dense [ns, nt]
// neg-log tables) and _accum_batch_range (A10: per-source row ranges plus a
// binary search over the sorted target column, for vocabularies whose dense
// square exceeds DEV_DENSE_LIMIT).  One thread per distinct rule: it masks the
// rule's 16 target positions, takes the min neg-log over up to 5 source x 16
// target probes plus the NULL row/column, and accumulates the two features in
// float32 in exactly the order of _accum_sequential (maxlex.py:146-158):
// source words j ascending, then target positions p ascending.  The adds are
// __fadd_rn, so the compiler can neither contract nor reorder them; the
// tables hold +0 for probability 1 (±0 canonicalised on the host) and +inf for
// missing pairs, so every min compares bit-distinct values consistently.
//
// Bound on the H100: up to 2 x 80 scattered 4-byte table reads per rule
// (A10: times log2(rows per source) bisection steps) -- gather latency; the
// arithmetic is ~100 adds and compares.  The design reads only the probes the
// masks keep, and shares the masks and accumulation between A9 and A10.
#include <math.h>

#include "common.cuh"

#define SRCW 5
#define TPOSW 16

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

// neg-log value at target id t within the sorted row range [lo, hi), +inf
// when absent; exactly `steps` bisection steps (_tgt_range_lookup_neglog)
__device__ float range_lookup(const int* __restrict__ lt,
                              const float* __restrict__ lv, int nlex, int lo,
                              int hi, int t, int steps) {
    const int hi_init = hi;
    for (int s = 0; s < steps; ++s) {
        const int mid = (lo + hi) >> 1;
        const bool less = lt[clampi(mid, nlex)] < t;
        const bool sel = lo < hi;
        if (sel && less) lo = mid + 1;
        if (sel && !less) hi = mid;
    }
    const int loc = clampi(lo, nlex);
    return (lo < hi_init && lt[loc] == t) ? lv[loc] : INFINITY;
}

// A10: source row ranges [rs[s + 1], re[s + 1]) over the (src, tgt)-sorted
// target column lt and its neg-log value columns
__global__ void range_kernel(const int* __restrict__ rs,
                             const int* __restrict__ re, int ns,
                             const int* __restrict__ lt,
                             const float* __restrict__ lnv1,
                             const float* __restrict__ lnv2, int nlex,
                             int steps, const int* __restrict__ tgt,
                             int tgt_len, float maxscore,
                             const int* __restrict__ sp,
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
    int lo[SRCW], hi[SRCW];
    for (int j = 0; j < SRCW; ++j) {
        const int si = u.sp[j] + 1;
        const bool ok = si >= 0 && si < ns;   // else the empty range [0, 0)
        lo[j] = ok ? rs[si] : 0;
        hi[j] = ok ? re[si] : 0;
    }
    float tf[SRCW], te[TPOSW];
    for (int j = 0; j < SRCW; ++j) {
        float best = INFINITY;
        for (int p = 0; p < TPOSW; ++p)
            if (u.tmask[p])
                best = fmin_(best, range_lookup(lt, lnv2, nlex, lo[j], hi[j],
                                                u.ttok[p], steps));
        if (u.any_t)
            best = fmin_(best, range_lookup(lt, lnv2, nlex, lo[j], hi[j], -1,
                                            steps));
        tf[j] = term(best, maxscore);
    }
    for (int p = 0; p < TPOSW; ++p) {
        float best = INFINITY;
        for (int j = 0; j < SRCW; ++j)
            if (u.sp[j] >= -1)
                best = fmin_(best, range_lookup(lt, lnv1, nlex, lo[j], hi[j],
                                                u.ttok[p], steps));
        // source NULL (id -1) is row range 0
        best = fmin_(best, range_lookup(lt, lnv1, nlex, rs[0], re[0],
                                        u.ttok[p], steps));
        te[p] = term(best, maxscore);
    }
    accumulate(u, tf, te, fge[r], egf[r]);
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
    const int threads = 128;
    range_kernel<<<cgx_grid(T, threads), threads, 0, (cudaStream_t)stream>>>(
        rs, re, ns, lt, lnv1, lnv2, nlex, steps, tgt, tgt_len, maxscore, sp, t0,
        tend, g1, g11, g2, g21, T, fge, egf);
    return (int)cudaGetLastError();
}
