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
// refstr/rlp/lr_tar goes through a view with the JAX bounds
// (extract_common.cuh).
//
// B3c (cgx_contig_pos) runs the same item body on occurrences given by
// corpus position, on one shard's slices: it replaces
// cgx_tpu/extract/device.py:_contig_batch_pos (device.py:391-396).
//
// Bound on the H100: per item ~100 scattered 4-byte reads (RLP words and
// target spans around the occurrence) and a few hundred integer ops over
// ~200 words of per-thread state, which lives in local memory (L1-resident).
// The design keeps one item per thread and no inter-thread traffic; a faster
// kernel would stage the target window in shared memory (a later change).
#include "extract_common.cuh"

namespace {

// _extract_contig_item for the occurrence at corpus position cs with block
// length lm; writes column `item` of out [8, n]
__device__ void contig_item(const Arrays& a, int cs, int lm, int n, int mrs,
                            int msym, int item, int* __restrict__ out) {
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

__global__ void contig_kernel(Arrays a, const int* __restrict__ sa, int sa_len,
                              const int* __restrict__ sa_pos,
                              const int* __restrict__ lms, int n, int mrs,
                              int msym, int* __restrict__ out) {
    const int item = blockIdx.x * blockDim.x + threadIdx.x;
    if (item >= n) return;
    contig_item(a, sa[clampi(sa_pos[item], sa_len)], lms[item], n, mrs, msym,
                item, out);
}

__global__ void contig_pos_kernel(Arrays a, const int* __restrict__ cs,
                                  const int* __restrict__ lms, int n, int mrs,
                                  int msym, int* __restrict__ out) {
    const int item = blockIdx.x * blockDim.x + threadIdx.x;
    if (item >= n) return;
    contig_item(a, cs[item], lms[item], n, mrs, msym, item, out);
}

}  // namespace

// out: int32 [8, n] = (ts, packed) of the ab, Xab, abX and XabX families
CGX_EXPORT int cgx_contig(const int* refstr, int ref_len, const int* sa,
                          int sa_len, const int* rlp, int rlp_len,
                          const int* lr_tar, int lr_len, const int* sa_pos,
                          const int* lm, int n, int mrs, int msym, int* out,
                          void* stream) {
    if (mrs < 1 || mrs - 1 > HMAX) return (int)cudaErrorInvalidValue;
    const Arrays a = {identity_view(refstr, ref_len),
                      identity_view(rlp, rlp_len),
                      identity_view(lr_tar, lr_len)};
    const int threads = 128;
    contig_kernel<<<cgx_grid(n, threads), threads, 0, (cudaStream_t)stream>>>(
        a, sa, sa_len, sa_pos, lm, n, mrs, msym, out);
    return (int)cudaGetLastError();
}

// B3c: as A6 for occurrences given by corpus position `cs` (resolved from
// the rank-sharded SA by B2g), on views (words, local length, global
// offset, global length) of one shard's slices.  out: int32 [8, n].
CGX_EXPORT int cgx_contig_pos(const int* ref, int ref_len, int ref_off,
                              int ref_glen, const int* rlp, int rlp_len,
                              int rlp_off, int rlp_glen, const int* lr_tar,
                              int lr_len, int lr_off, int lr_glen,
                              const int* cs, const int* lm, int n, int mrs,
                              int msym, int* out, void* stream) {
    if (mrs < 1 || mrs - 1 > HMAX) return (int)cudaErrorInvalidValue;
    const Arrays a = {View{ref, ref_len, ref_off, ref_glen},
                      View{rlp, rlp_len, rlp_off, rlp_glen},
                      View{lr_tar, lr_len, lr_off, lr_glen}};
    const int threads = 128;
    contig_pos_kernel<<<cgx_grid(n, threads), threads, 0,
                        (cudaStream_t)stream>>>(a, cs, lm, n, mrs, msym, out);
    return (int)cudaGetLastError();
}
