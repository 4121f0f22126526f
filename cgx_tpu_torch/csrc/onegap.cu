// A7: one-gap rule extraction (extractConsistentPairs_OneGap,
// ExtractPair.cu:351-889): per sampled aXb occurrence the aXb rule plus the
// 14-step left/right growth emitting XaXb (prepend X) and aXbX (append X).
//
// Replaces cgx_tpu/extract/device.py:_onegap_batch (device.py:616-620), a
// vmap over _extract_onegap_item (:502-614) with _check_boundary_dev
// (:475-499).  A half-warp per occurrence on the helpers of
// extract_common.cuh.  The JAX loop runs both sides under `active = ... &
// (left | right)`, true whenever the side in question is alive, so the
// sides never act on each other and a side's family is decided by its
// first event within the span limit: the step at which it dies (no token,
// unaligned at step 1, its aligned span too wide, its grown span too wide
// after the X gap check) or emits.  Lane k computes step k's event and
// emit bits at once, a ballot finds the first event, and the family emits
// iff that step does (tests/test_torch_onegap.py holds this against the
// loop).  Reads come in three dependent rounds: checkBoundary's 16 RLP
// words at cs, the gap's at cs + sl, each side's token and RLP word of
// step k; the two sentence anchors' words (the item's at the gap,
// checkBoundary's at cs: they differ across a sentence end); consistent()'s
// lr_tar words where it is called and the base and both sides' windows.
//
// Bound on the H100: per item 4 input and 6 output words and the words the
// function needs (tools/reads.py onegap_reads: the spans and anchors, each
// side's steps up to its first event, the window entries looked up); the
// body gathers every step and whole windows (up to ~200 words) so that no
// read waits on a decision.  It is bound by issued instructions, not by
// latency (32-48 warps an SM run equally fast); the one-thread body it
// replaces kept ~200 words of arrays per item in local memory.  A tail
// half repeats the last item and writes nothing.
#include "extract_common.cuh"

namespace {

constexpr int kThreads = 128;   // 8 items a block
constexpr int kBlocks = 10;     // 40 warps an SM; 12 (48) ran 2% slower

// XaXb (left, ExtractPair.cu:639-760) or aXbX (right, :763-880) from one
// side's steps: lane k's step events, the first within the `lim` steps
// that run decides (lane 0 stands for none), its values by shuffle;
// `alive` is the side's flag before the loop.  The grown X's target span
// is the family's first gap on the left, its second on the right, the
// original gap (g1s, g1e) the other (an empty slot keeps ts there, as
// jnp.where(v, gap1, ts)).
__device__ __forceinline__ Rule side_family(const HalfStep& s,
                                            const HalfWindow& bw, bool alive,
                                            bool left, int lim, int cs,
                                            int ender, int min_L, int max_R,
                                            int sentstart, int stb, int mrs,
                                            int H, int g1s, int g1e) {
    const int k = lane_id() & 15;
    const bool spank = s.pmax - s.pmin >= mrs;
    const int w_ts = stb + min(s.pmin, min_L), w_te = stb + max(s.pmax, max_R);
    int mn, mx;     // consistent() over the whole grown span
    window_range(bw, clip(min_L - s.pmin, 0, H),
                 clip(max(s.pmax, max_R) - min_L, 0, H), mn, mx);
    const bool w_ok = sentstart + mn == (left ? cs - (k + 1) : cs)
                      && sentstart + mx == (left ? ender : ender + k + 1);
    const bool nxt = s.has && s.al && !spank && s.gap;
    const bool wkill = w_te - w_ts >= mrs;
    const bool event = k < lim && (!s.has || (k == 0 && !s.al) || spank
                                   || (nxt && (wkill || w_ok)));
    // the deciding lane's emit bit and prefix min/max (0..255), one shuffle
    const unsigned mine = (unsigned)(alive && event && nxt && !wkill && w_ok)
                          << 16 | (unsigned)s.pmin << 8 | (unsigned)s.pmax;
    const unsigned got = __shfl_sync(kFull, mine, first_lane(event), 16);
    if (!(got >> 16)) return Rule{};
    const int pmin = (int)(got >> 8) & 255, pmax = (int)got & 255;
    const int ts = stb + min(pmin, min_L), te = stb + max(pmax, max_R);
    return left ? Rule{true, ts, te, stb + pmin, stb + pmax, g1s, g1e}
                : Rule{true, ts, te, g1s, g1e, stb + pmin, stb + pmax};
}

__global__ void __launch_bounds__(kThreads, kBlocks)
onegap_kernel(Arrays a, const int* __restrict__ css,
              const int* __restrict__ first_ends,
              const int* __restrict__ sls, const int* __restrict__ els,
              int n, int mrs, int msym, int* __restrict__ out) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if ((t >> 5) * 2 >= n) return;
    const int item = t >> 4;
    const bool valid = item < n;
    const int j = valid ? item : n - 1;
    const int k = lane_id() & 15;
    const int cs = css[j], fe = first_ends[j], sl = sls[j], el = els[j];
    const int ender = cs + fe, gstart = cs + sl, H = mrs - 1;

    // round 1: checkBoundary's span, the first gap's span, step k of each
    // side
    const unsigned tb = (unsigned)a.rlp.atg(cs + k);
    const unsigned tg = (unsigned)a.rlp.atg(gstart + k);
    const int lpos = cs - (k + 1), rpos = ender + (k + 1);
    int ltok = -1, rtok = -1;
    unsigned lt = 0u, rt = 0u;
    if (k < IMAX && lpos >= 0) {
        ltok = a.refstr.atg(lpos);
        lt = (unsigned)a.rlp.atg(lpos);
    }
    if (k < IMAX && rpos >= 0) {
        rtok = a.refstr.atg(rpos);
        rt = (unsigned)a.rlp.atg(rpos);
    }

    // round 2: the sentence anchors, the item's (at the gap) and
    // checkBoundary's (at cs)
    const int g_temp = sent_tempind(gstart, tg);
    const int b_temp = sent_tempind(cs, tb);
    const int stb = sent_stb(a.rlp, g_temp);
    const int b_stb = sent_stb(a.rlp, b_temp);
    const int sentstart = g_temp + 1;
    const HalfSpan gap1 = span_scan(gstart, ender - el, tg);
    const Boundary b = boundary(span_scan(cs, ender, tb), cs, ender, b_temp,
                                b_stb, mrs);
    HalfStep ls = side_step(lpos, ltok, lt);
    HalfStep rs = side_step(rpos, rtok, rt);
    const int min_L = b.ts - stb, max_R = b.te - stb;
    const int anchor = stb + min(min_L, 255);
    const int l_anchor = side_anchor(ls, stb);
    const int r_anchor = side_anchor(rs, stb);

    // round 3: consistent()'s words, the base window, the sides' windows
    const int cw = consistent_word(a.lr_tar, b);
    const WinWords bww = window_words(a.lr_tar, anchor, H);
    const WinWords lww = window_words(a.lr_tar, l_anchor, H);
    const WinWords rww = window_words(a.lr_tar, r_anchor, H);

    const int code = boundary_code(b, cw, cs, ender);
    side_prefix(ls);
    side_prefix(rs);
    side_gap(ls, lww, l_anchor, true, cs, ender, sentstart, stb, H);
    side_gap(rs, rww, r_anchor, false, cs, ender, sentstart, stb, H);
    const HalfWindow bw = window_scan(bww);
    // code 2 (front unaligned) kills aXbX, code 3 (end unaligned) kills
    // XaXb, code 4 both (ExtractPair.cu:574-588); step k runs while
    // first_end + 1 + (k + 1) <= mrs
    const bool grow = sl + el + 2 <= msym;
    const int lim = min(mrs - fe - 1, IMAX);
    const int gap1s = gap1.mn + stb, gap1e = gap1.mx + stb;
    const Rule xaxb = side_family(ls, bw, grow && code != 3 && code != 4,
                                  true, lim, cs, ender, min_L, max_R,
                                  sentstart, stb, mrs, H, gap1s, gap1e);
    const Rule axbx = side_family(rs, bw, grow && code != 2 && code != 4,
                                  false, lim, cs, ender, min_L, max_R,
                                  sentstart, stb, mrs, H, gap1s, gap1e);
    // lanes 0, 1 and 2 write the aXb, XaXb and aXbX families
    if (!valid || k > 2) return;
    Rule r = {code == 1, b.ts, b.te, gap1s, gap1e, 0, 0};
    if (k == 1) r = xaxb;
    if (k == 2) r = axbx;
    pack(r, k > 0, out, 2 * k, n, item);
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
    onegap_kernel<<<cgx_grid(16 * n, kThreads), kThreads, 0,
                    (cudaStream_t)stream>>>(a, cs, first_end, sl, el, n, mrs,
                                            msym, out);
    return (int)cudaGetLastError();
}
