// A6: contiguous-block rule extraction (extractConsistentPairs_Gappy,
// ExtractPair.cu:1055-1795): the base `ab` consistency check plus the
// 14-step left/right growth state machine emitting Xab, abX and XabX.
//
// Replaces cgx_tpu/extract/device.py:_contig_batch, a vmap over
// _extract_contig_item (device.py:177-378).  One thread per sampled
// occurrence transcribes the per-item function itself: the anchored
// (2H+1)-wide target window prefixes (H = mrs - 1), the IMAX = 14 side arrays,
// the factorised XabX whole-span table (computed on the fly from the four
// IMAX part-vectors instead of stored 14 x 14) and the outer/inner growth
// loops with the same flag updates in the same order.  Every read of
// refstr/rlp/lr_tar clamps to the padded length like the JAX gathers.
//
// Bound on the H100: per item ~100 scattered 4-byte reads (RLP words and
// target spans around the occurrence) and a few hundred integer ops over
// ~200 words of per-thread state, which lives in local memory (L1-resident).
// The design keeps one item per thread and no inter-thread traffic; a faster
// kernel would stage the target window in shared memory (a later change).
#include "common.cuh"

#define IMAX 14   // max growth distance (lm + i <= max_rule_span, lm >= 1)
#define CWID 16   // base span scan width
#define HMAX 14   // H = max_rule_span - 1 <= 14 (ExtractorConfig bound)

namespace {

struct Arrays {
    const int* refstr; int ref_len;
    const int* rlp; int rlp_len;       // uint32 RLP words stored as int32
    const int* lr_tar; int lr_len;     // (L << 8) | R per target token
};

// (L, R, aligned) from an RLP word; positions before the corpus start read
// as unaligned (_rlp_LR)
__device__ __forceinline__ void rlp_lr(const Arrays& a, int pos, int& L, int& R,
                                       bool& al) {
    if (pos < 0) { L = 255; R = 255; al = false; return; }
    unsigned t = (unsigned)a.rlp[clampi(pos, a.rlp_len)];
    L = (int)((t >> 24) & 0xFF);
    R = (int)((t >> 16) & 0xFF);
    al = (L != 255) && (R != 255);
}

// sentence anchor of a span's first token (_sent_anchor)
__device__ __forceinline__ void sent_anchor(const Arrays& a, int pos,
                                            int& sentstart, int& stb) {
    unsigned t = (unsigned)a.rlp[clampi(pos, a.rlp_len)];
    int p = (int)((t >> 8) & 0xFF);
    int tempind = pos - p - 1;
    stb = tempind == -1 ? 0 : a.rlp[clampi(tempind, a.rlp_len)];
    sentstart = tempind + 1;
}

// prefix min(L)/max(R) of the target window around `anchor`, forward
// (anchor..anchor+k) and backward (anchor-k..anchor) (_tar_window_prefixes)
struct Window { int fwdL[HMAX + 1], bwdL[HMAX + 1], fwdR[HMAX + 1], bwdR[HMAX + 1]; };

__device__ void window(const Arrays& a, int anchor, int H, Window& w) {
    int mnF = 256, mxF = -1, mnB = 256, mxB = -1;
    for (int k = 0; k <= H; ++k) {
        int wf = a.lr_tar[clampi(anchor + k, a.lr_len)];
        int Lf = wf >> 8, Rf = wf & 255;
        if (Lf != 255 && Rf != 255) { mnF = min(mnF, Lf); mxF = max(mxF, Rf); }
        w.fwdL[k] = mnF;
        w.fwdR[k] = mxF;
        int wb = a.lr_tar[clampi(anchor - k, a.lr_len)];
        int Lb = wb >> 8, Rb = wb & 255;
        if (Lb != 255 && Rb != 255) { mnB = min(mnB, Lb); mxB = max(mxB, Rb); }
        w.bwdL[k] = mnB;
        w.bwdR[k] = mxB;
    }
}

// consistent() over [ts, te] from the anchored prefixes (_win_check)
__device__ __forceinline__ bool win_check(const Window& w, int anchor, int ts,
                                          int te, int start_chk, int end_chk,
                                          int sentstart, int H) {
    int lo = clip(anchor - ts, 0, H);
    int hi = clip(te - anchor, 0, H);
    int bmin = min(w.bwdL[lo], w.fwdL[hi]);
    int bmax = max(w.bwdR[lo], w.fwdR[hi]);
    if (ts > te) { bmin = 256; bmax = -1; }
    return sentstart + bmin == start_chk && sentstart + bmax == end_chk;
}

// per-step arrays of one growth side (_grow_side_arrays)
struct Side { int tok[IMAX], pmin[IMAX], pmax[IMAX]; bool al[IMAX], gap[IMAX]; };

__device__ void grow_side(const Arrays& a, bool left, int cs, int ender,
                          int sentstart, int stb, int H, Side& s) {
    int base = left ? cs : ender, step = left ? -1 : 1;
    int L0 = 255;
    bool seen = false;
    int mn = 255, mx = 0;
    for (int k = 0; k < IMAX; ++k) {
        int pos = base + step * (k + 1);
        s.tok[k] = pos < 0 ? -1 : a.refstr[clampi(pos, a.ref_len)];
        int L, R;
        bool al;
        rlp_lr(a, pos, L, R, al);
        // anchor at the first aligned step; jnp.argmax of an all-false mask
        // is 0, so with no aligned step the anchor is step 0's L (unused)
        if (k == 0 || (al && !seen)) L0 = L;
        seen |= al;
        s.al[k] = al;
        if (al) { mn = min(mn, L); mx = max(mx, R); }
        s.pmin[k] = mn;
        s.pmax[k] = mx;
    }
    int anchor = stb + L0;
    Window w;
    window(a, anchor, H, w);
    for (int k = 0; k < IMAX; ++k) {
        int i = k + 1;
        int lo_chk = left ? cs - i : ender + 1;
        int hi_chk = left ? cs - 1 : ender + i;
        s.gap[k] = win_check(w, anchor, stb + s.pmin[k], stb + s.pmax[k],
                             lo_chk, hi_chk, sentstart, H);
    }
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

__global__ void contig_kernel(Arrays a, const int* __restrict__ sa, int sa_len,
                              const int* __restrict__ sa_pos,
                              const int* __restrict__ lms, int n, int mrs,
                              int msym, int* __restrict__ out) {
    int item = blockIdx.x * blockDim.x + threadIdx.x;
    if (item >= n) return;
    const int cs = sa[clampi(sa_pos[item], sa_len)];
    const int lm = lms[item];
    const int ender = cs + lm - 1;
    int sentstart, stb;
    sent_anchor(a, cs, sentstart, stb);

    // base span scan (ExtractPair.cu:1178-1231)
    int min_L = 256, max_R = -1;
    bool al_first = false, al_last = false;
    const int last_off = clip(lm - 1, 0, CWID - 1);
    for (int k = 0; k < CWID; ++k) {
        int L, R;
        bool al;
        rlp_lr(a, cs + k, L, R, al);
        if (k == 0) al_first = al;
        if (k == last_off) al_last = al;
        if (k < lm && al) { min_L = min(min_L, L); max_R = max(max_R, R); }
    }
    bool ab = al_first && al_last;
    bool abXNoSuccess = al_first;
    bool XabNoSuccess = al_last;
    const bool dead = (min_L > max_R) || (max_R - min_L >= mrs);
    ab = ab && !dead;
    bool Xab = !dead, abX = !dead, XabX = !dead;

    const int H = mrs - 1;
    const int anchor = stb + min(min_L, 255);
    Window bw;
    window(a, anchor, H, bw);
    const int ab_ts = min_L + stb;
    const int ab_len = max_R - min_L;
    const bool ab_ok = ab && win_check(bw, anchor, ab_ts, max_R + stb, cs,
                                       ender, sentstart, H);
    Xab = Xab && (lm + 1 <= msym);
    abX = abX && (lm + 1 <= msym);
    XabX = XabX && (lm + 2 <= msym);

    Side ls, rs;
    grow_side(a, true, cs, ender, sentstart, stb, H, ls);
    grow_side(a, false, cs, ender, sentstart, stb, H, rs);

    // whole-span range-min(L)/max(R) part-vectors (device.py:225-234)
    int mnL[IMAX], mxL[IMAX], mnR[IMAX], mxR[IMAX];
    for (int k = 0; k < IMAX; ++k) {
        int loL = clip(min_L - ls.pmin[k], 0, H);
        int hiL = clip(max(ls.pmax[k], max_R) - min_L, 0, H);
        int loR = clip(min_L - rs.pmin[k], 0, H);
        int hiR = clip(max(rs.pmax[k], max_R) - min_L, 0, H);
        mnL[k] = min(bw.bwdL[loL], bw.fwdL[hiL]);
        mxL[k] = max(bw.bwdR[loL], bw.fwdR[hiL]);
        mnR[k] = min(bw.bwdL[loR], bw.fwdL[hiR]);
        mxR[k] = max(bw.bwdR[loR], bw.fwdR[hiR]);
    }
    auto wl_ts = [&](int k) { return stb + min(ls.pmin[k], min_L); };
    auto wl_te = [&](int k) { return stb + max(ls.pmax[k], max_R); };
    auto wl_ok = [&](int k) {
        return sentstart + mnL[k] == cs - (k + 1) && sentstart + mxL[k] == ender;
    };
    auto wr_ts = [&](int k) { return stb + min(rs.pmin[k], min_L); };
    auto wr_te = [&](int k) { return stb + max(rs.pmax[k], max_R); };
    auto wr_ok = [&](int k) {
        return sentstart + mnR[k] == cs && sentstart + mxR[k] == ender + (k + 1);
    };
    // XabX span with left extent l + 1 and right extent r + 1
    auto w2_ts = [&](int l, int r) {
        return stb + min(min(ls.pmin[l], rs.pmin[r]), min_L);
    };
    auto w2_te = [&](int l, int r) {
        return stb + max(max(ls.pmax[l], rs.pmax[r]), max_R);
    };
    auto w2_ok = [&](int l, int r) {
        return sentstart + min(mnL[l], mnR[r]) == cs - (l + 1)
            && sentstart + max(mxL[l], mxR[r]) == ender + (r + 1);
    };

    Rule xab = {}, abx = {}, xabx = {};
    int XabCount = 0, abXCount = 0;
    // sequential growth (ExtractPair.cu:1280-1791; device.py:298-374)
    for (int i = 1; i <= IMAX; ++i) {
        const int i0 = i - 1;
        const bool active = (lm + i <= mrs)
            && (abXNoSuccess || XabNoSuccess || XabX);
        // ---- Xab (left)
        const bool l_has = (cs - i >= 0) && (ls.tok[i0] >= 2);
        const bool l_proc = active && Xab && l_has;
        if (active && !l_has) Xab = false;
        bool nxt = l_proc && ls.al[i0];
        if (l_proc && !ls.al[i0] && i == 1) { Xab = false; XabX = false; }
        bool spank = ls.pmax[i0] - ls.pmin[i0] >= mrs;
        if (l_proc && spank) Xab = false;
        nxt = nxt && !spank && ls.gap[i0];
        if (nxt) XabCount = i;
        bool wkill = l_proc && XabNoSuccess && nxt
            && (wl_te(i0) - wl_ts(i0) >= mrs);
        if (wkill) Xab = false;
        if (l_proc && XabNoSuccess && nxt && !wkill && wl_ok(i0)) {
            xab = {true, wl_ts(i0), wl_te(i0), stb + ls.pmin[i0],
                   stb + ls.pmax[i0], 0, 0};
            XabNoSuccess = false;
        }
        // ---- abX (right)
        const bool r_has = rs.tok[i0] >= 2;
        const bool r_proc = active && abX && r_has;
        if (active && !r_has) abX = false;
        nxt = r_proc && rs.al[i0];
        if (r_proc && !rs.al[i0] && i == 1) { abX = false; XabX = false; }
        spank = rs.pmax[i0] - rs.pmin[i0] >= mrs;
        if (r_proc && spank) abX = false;
        nxt = nxt && !spank && rs.gap[i0];
        if (nxt) abXCount = i;
        wkill = r_proc && abXNoSuccess && nxt && (wr_te(i0) - wr_ts(i0) >= mrs);
        if (wkill) abX = false;
        if (r_proc && abXNoSuccess && nxt && !wkill && wr_ok(i0)) {
            abx = {true, wr_ts(i0), wr_te(i0), stb + rs.pmin[i0],
                   stb + rs.pmax[i0], 0, 0};
            abXNoSuccess = false;
        }
        // ---- XabX (ExtractPair.cu:1514-1777)
        const bool xcond = active && XabX && (abX || Xab);
        // branch 1 scans the right side, left extent fixed at i
        bool alive = xcond && (XabCount == i);
        for (int k = 1; k <= IMAX; ++k) {
            const int k0 = k - 1;
            const bool run = alive && (k <= abXCount) && XabX;
            const bool budget = k + i + lm <= mrs;
            if (run && !budget) alive = false;
            bool nx = run && budget && rs.al[k0];
            const bool spank2 = rs.pmax[k0] - rs.pmin[k0] >= mrs;
            if (nx && spank2) alive = false;
            nx = nx && !spank2 && rs.gap[k0];
            const int ts = w2_ts(i0, k0), te = w2_te(i0, k0);
            const bool bad = te - ts >= mrs;
            if (nx && bad) alive = false;
            nx = nx && !bad && w2_ok(i0, k0);
            if (nx && XabX) {
                xabx = {true, ts, te, stb + ls.pmin[i0], stb + ls.pmax[i0],
                        stb + rs.pmin[k0], stb + rs.pmax[k0]};
                XabX = false;
            }
        }
        // branch 2 scans the left side, right extent fixed at i
        alive = xcond && XabX && (abXCount == i);
        for (int k = 1; k <= IMAX; ++k) {
            const int k0 = k - 1;
            const bool run = alive && (k <= XabCount) && XabX;
            const bool budget = k + i + lm <= mrs;
            if (run && !budget) alive = false;
            bool nx = run && budget && ls.al[k0];
            const bool spank2 = ls.pmax[k0] - ls.pmin[k0] >= mrs;
            if (nx && spank2) alive = false;
            nx = nx && !spank2 && ls.gap[k0];
            const int ts = w2_ts(k0, i0), te = w2_te(k0, i0);
            const bool bad = te - ts >= mrs;
            if (nx && bad) alive = false;
            nx = nx && !bad && w2_ok(k0, i0);
            if (nx && XabX) {
                xabx = {true, ts, te, stb + ls.pmin[k0], stb + ls.pmax[k0],
                        stb + rs.pmin[i0], stb + rs.pmax[i0]};
                XabX = false;
            }
        }
        if (active && !(abX || Xab)) XabX = false;
        // spin sync (ExtractPair.cu:1782-1789)
        const bool sync = active && !XabX;
        if (sync && !Xab) XabNoSuccess = false;
        if (sync && !abX) abXNoSuccess = false;
    }

    const Rule abr = {ab_ok, ab_ts, ab_ts + (ab_ok ? ab_len : 0), ab_ts, ab_ts,
                      0, 0};
    pack(abr, false, out, 0, n, item);
    pack(xab, false, out, 2, n, item);
    pack(abx, false, out, 4, n, item);
    pack(xabx, true, out, 6, n, item);
}

}  // namespace

// out: int32 [8, n] = (ts, packed) of the ab, Xab, abX and XabX families
CGX_EXPORT int cgx_contig(const int* refstr, int ref_len, const int* sa,
                          int sa_len, const int* rlp, int rlp_len,
                          const int* lr_tar, int lr_len, const int* sa_pos,
                          const int* lm, int n, int mrs, int msym, int* out,
                          void* stream) {
    if (mrs < 1 || mrs - 1 > HMAX) return (int)cudaErrorInvalidValue;
    const Arrays a = {refstr, ref_len, rlp, rlp_len, lr_tar, lr_len};
    const int threads = 128;
    contig_kernel<<<cgx_grid(n, threads), threads, 0, (cudaStream_t)stream>>>(
        a, sa, sa_len, sa_pos, lm, n, mrs, msym, out);
    return (int)cudaGetLastError();
}
