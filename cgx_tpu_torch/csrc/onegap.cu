// A7: one-gap rule extraction (extractConsistentPairs_OneGap,
// ExtractPair.cu:351-889): per sampled aXb occurrence the aXb rule plus the
// 14-step left/right growth emitting XaXb (prepend X) and aXbX (append X).
//
// Replaces cgx_tpu/extract/device.py:_onegap_batch (device.py:616-620), a
// vmap over _extract_onegap_item (:502-614) with _check_boundary_dev
// (:475-499).  One thread per occurrence transcribes the per-item function:
// the first gap's target span, checkBoundary (codes 0-4), the two side
// arrays and the anchored window prefixes (extract_common.cuh, shared with
// A6), then the outer growth loop with the same kill rules in the same order.
// The arrays come as views (common.cuh), so the sharded index runs the same
// kernel on each shard's slices, as JAX passes `offs` to _onegap_batch.
//
// Bound on the H100: like A6, ~100 scattered 4-byte reads per item and a few
// hundred integer ops over per-thread arrays held in local memory; one item
// per thread and no inter-thread traffic.
#include "extract_common.cuh"

namespace {

__global__ void onegap_kernel(Arrays a, const int* __restrict__ css,
                              const int* __restrict__ first_ends,
                              const int* __restrict__ sls,
                              const int* __restrict__ els, int n, int mrs,
                              int msym, int* __restrict__ out) {
    const int item = blockIdx.x * blockDim.x + threadIdx.x;
    if (item >= n) return;
    const int cs = css[item], first_end = first_ends[item];
    const int sl = sls[item], el = els[item];
    const int ender = cs + first_end;

    // first gap span [cs + sl, ender - el]; its sentence anchor serves the
    // whole item
    const int gstart = cs + sl;
    int sentstart, stb;
    sent_anchor(a, gstart, sentstart, stb);
    int gmin = 256, gmax = -1;
    for (int k = 0; k < CWID; ++k) {
        int L, R;
        bool al;
        rlp_lr(a, gstart + k, L, R, al);
        if (gstart + k <= ender - el && al) { gmin = min(gmin, L); gmax = max(gmax, R); }
    }
    const int gap1s = gmin + stb, gap1e = gmax + stb;

    int ts, te;
    const int code = check_boundary(a, cs, ender, mrs, ts, te);
    const int min_L = ts - stb, max_R = te - stb;
    const bool axb_v = code == 1;
    // code 2 (front unaligned) kills aXbX, code 3 (end unaligned) kills XaXb,
    // code 4 both (ExtractPair.cu:574-588)
    const bool grow = sl + el + 2 <= msym;
    bool left = code != 3 && code != 4 && grow;
    bool right = code != 2 && code != 4 && grow;

    const int H = mrs - 1;
    const int anchor = stb + min(min_L, 255);
    Window bw;
    window(a, anchor, H, bw);
    Side ls, rs;
    grow_side(a, true, cs, ender, sentstart, stb, H, ls);
    grow_side(a, false, cs, ender, sentstart, stb, H, rs);

    Rule xaxb = {}, axbx = {};
    for (int i = 1; i <= IMAX; ++i) {
        const int i0 = i - 1;
        const bool active = (first_end + 1 + i <= mrs) && (left || right);
        // ---- XaXb (prepend X), ExtractPair.cu:639-760
        {
            const bool l_has = (cs - i >= 0) && (ls.tok[i0] >= 2);
            const bool l_proc = active && left && l_has;
            if (active && left && !l_has) left = false;
            bool nxt = l_proc && ls.al[i0];
            if (l_proc && !ls.al[i0] && i == 1) left = false;
            const bool spank = ls.pmax[i0] - ls.pmin[i0] >= mrs;
            if (l_proc && spank) left = false;
            nxt = nxt && !spank && ls.gap[i0];
            const int w_ts = stb + min(ls.pmin[i0], min_L);
            const int w_te = stb + max(ls.pmax[i0], max_R);
            const bool wkill = nxt && (w_te - w_ts >= mrs);
            if (wkill) left = false;
            const int lo = clip(min_L - ls.pmin[i0], 0, H);
            const int hi = clip(max(ls.pmax[i0], max_R) - min_L, 0, H);
            const bool w_ok =
                sentstart + min(bw.bwdL[lo], bw.fwdL[hi]) == cs - i
                && sentstart + max(bw.bwdR[lo], bw.fwdR[hi]) == ender;
            if (nxt && !wkill && w_ok) {
                xaxb = {true, w_ts, w_te, stb + ls.pmin[i0], stb + ls.pmax[i0],
                        0, 0};
                left = false;
            }
        }
        // ---- aXbX (append X), ExtractPair.cu:763-880
        {
            const bool r_has = rs.tok[i0] >= 2;
            const bool r_proc = active && right && r_has;
            if (active && right && !r_has) right = false;
            bool nxt = r_proc && rs.al[i0];
            if (r_proc && !rs.al[i0] && i == 1) right = false;
            const bool spank = rs.pmax[i0] - rs.pmin[i0] >= mrs;
            if (r_proc && spank) right = false;
            nxt = nxt && !spank && rs.gap[i0];
            const int w_ts = stb + min(rs.pmin[i0], min_L);
            const int w_te = stb + max(rs.pmax[i0], max_R);
            const bool wkill = nxt && (w_te - w_ts >= mrs);
            if (wkill) right = false;
            const int lo = clip(min_L - rs.pmin[i0], 0, H);
            const int hi = clip(max(rs.pmax[i0], max_R) - min_L, 0, H);
            const bool w_ok =
                sentstart + min(bw.bwdL[lo], bw.fwdL[hi]) == cs
                && sentstart + max(bw.bwdR[lo], bw.fwdR[hi]) == ender + i;
            if (nxt && !wkill && w_ok) {
                axbx = {true, w_ts, w_te, 0, 0, stb + rs.pmin[i0],
                        stb + rs.pmax[i0]};
                right = false;
            }
        }
    }

    // the original gap rides in each grown family: XaXb's second gap, aXbX's
    // first (an empty slot keeps ts there, as jnp.where(v, gap1, ts))
    const Rule axb = {axb_v, ts, te, gap1s, gap1e, 0, 0};
    xaxb.g2s = xaxb.v ? gap1s : xaxb.ts;
    xaxb.g2e = xaxb.v ? gap1e : xaxb.ts;
    axbx.g1s = axbx.v ? gap1s : axbx.ts;
    axbx.g1e = axbx.v ? gap1e : axbx.ts;
    pack(axb, false, out, 0, n, item);
    pack(xaxb, true, out, 2, n, item);
    pack(axbx, true, out, 4, n, item);
}

}  // namespace

// Views: (words, local length, global offset, global length) of refstr,
// RLP and lr_tar: the whole arrays, or one shard's slices.
// out: int32 [6, n] = (ts, packed) of the aXb, XaXb and aXbX families
CGX_EXPORT int cgx_onegap(const int* ref, int ref_len, int ref_off,
                          int ref_glen, const int* rlp, int rlp_len,
                          int rlp_off, int rlp_glen, const int* lr_tar,
                          int lr_len, int lr_off, int lr_glen,
                          const int* cs, const int* first_end, const int* sl,
                          const int* el, int n, int mrs, int msym, int* out,
                          void* stream) {
    if (mrs < 1 || mrs - 1 > HMAX) return (int)cudaErrorInvalidValue;
    const Arrays a = {View{ref, ref_len, ref_off, ref_glen},
                      View{rlp, rlp_len, rlp_off, rlp_glen},
                      View{lr_tar, lr_len, lr_off, lr_glen}};
    const int threads = 128;
    onegap_kernel<<<cgx_grid(n, threads), threads, 0, (cudaStream_t)stream>>>(
        a, cs, first_end, sl, el, n, mrs, msym, out);
    return (int)cudaGetLastError();
}
