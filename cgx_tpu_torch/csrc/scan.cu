// lookup1's and lookup2's device kernels: lookup1's scan (A2, B3f/B3b,
// C1f/C1b), lookup2's second-gap scan (A5, C1t, B3t) and the verifications
// (A3, B3p, C1p) a warp per 32 items, each family on one warp body.
//
// lookup1's scan, `scan_warp`: the forward/backward aXb occurrence scan of
//   cgx_tpu/search/lookup.py:_fwd_item (:110) and _bwd_item (:161) with the
//   fused _gap_check_grow (gapcheck.cuh).  Lane i holds item i's scalars;
//   a half-warp per item, lane m reading window word m, gives the candidate
//   mask of moves m (the JAX prefix-AND of "survive" is a ballot); then
//   only the items with a candidate run the cooperative gap check
//   (gap_check_half), two at a time.  This is exact: the result is cand &
//   gc, and gc does not depend on the scan (the JAX package's do_gap=False
//   split, done in the kernel).  Its three kernels differ only in how lane
//   i finds its item:
//   A2 (cgx_scan) replaces lookup.py:_scan_batch_exp (:337-353) with
//     _cumsum_expand (:298): item j belongs to pattern p, the last p with
//     offs[p] <= j (a binary search over the count prefix; patterns with no
//     items are skipped), and reads its start from the device SA;
//   B3f / B3b (cgx_fwd_items / cgx_bwd_items, the sharded index, on views of
//     one shard's slices; common.cuh) replace _fwd_batch (:237) and
//     _bwd_batch (:246): one item per input row, the compared query tokens
//     gathered from the padded query tokens as _qtok_fwd / _qtok_bwd do
//     (:224-233);
//   C1f / C1b (cgx_scan_cols, identity views) replace _scan_batch_cols
//     (:274-282): one item per row of host-resolved columns gostart, sl, el
//     and the three compared query tokens w0..w2.
// lookup2's second-gap scan, `two_warp`: _two_item (:615-639): from an aXb
//   occurrence (start, len) the 16 moves right of the core and the fused
//   gap check anchored one token past it.  A half-warp per item reads the
//   16 move words (one request), takes the candidate mask by ballot and
//   runs gap_check_half for every item (gc is part of the result), two
//   items at a time, the next pair's move and RLP words read a step ahead.
//   A5 (cgx_two) replaces lookup.py:_two_batch_exp (:662-680), the
//   occurrence read from the precomputed rows or the one-gap rows as the
//   pattern's pcmode flag says, and returns the uint32 bits cand | (gc <<
//   16) (the c token is resolved on the host); C1t (cgx_two_packed)
//   replaces _two_batch_packed (:650-658), the same word over (pstart,
//   plen) columns; B3t (cgx_two_items) replaces _two_batch (:643) on a
//   shard's views and returns cand and gc as two words.
// The verifications, `pcs_warp`: _pcs_item (:203): the span budget, up to
//   2 prefix and 2 suffix tokens per precomputed occurrence, a lane per
//   item reading only the corpus words its item needs, all in one round.
//   Its three kernels differ only in how lane i finds its item:
//   A3 (cgx_pcs) replaces lookup.py:_pcs_batch_exp (:315) with
//     _cumsum_expand (:298): the warp resolves its 32 consecutive items'
//     patterns together (`pcs_kernel`: a 32-ary search near its first
//     item, then windows of 32 patterns a round), then reads each item's
//     precomputed row; the ok bits packed 32 per word by a warp ballot;
//   B3p (cgx_pcs_items) replaces _pcs_batch (:255) on a shard's views: one
//     item per input row, its four compared query tokens gathered from the
//     padded query tokens; one word per item;
//   C1p (cgx_pcs_cols) replaces _pcs_batch_cols (:285-295) over (pstart,
//     plen, sl, el, pa1, pa2, pb2, pb3) columns, packed as A3 (any n: the
//     last word's tail bits are 0).
//
// Every body reads the corpus through views with the JAX bounds: a read the
// JAX body bounds explicitly (jnp.minimum / jnp.maximum / jnp.clip against
// the global length) is bounded so first, and every read is then clamped
// into the local slice (View::at).  The replicated entry points pass
// identity views, where both are the old clamp.
//
// Bound on the H100: lookup1's scan reads per item its scalars (A2: one
// offs search of log2 D words, one pattab row and one SA word; B3 four
// columns and three query tokens; C1 six columns), the gap-0 token and an
// 18-word corpus window, and the gap check's ~33 words only for the items
// with a candidate (under 2% at europarl; chip_smoke.py prints the share),
// all scattered (occurrences of a pattern are SA-ordered, not
// corpus-ordered); A3 a warp's share of one offs search, its window of
// offs words and pattab rows, one precomputed row and up to 4 corpus words
// per item (the rounds of that chain bound it: see pcs_kernel); A5 one
// offs search, one pattab row, one occurrence row, a 17-word corpus window
// and the gap check's ~33 words for every item (A5 cannot skip it: its
// word carries gc).  All are
// latency-bound gathers with a few hundred integer ops per item at most.
// The half-warp windows make each window one 64-byte request.  The bounds
// count only the words the functions need (tools/reads.py): the window
// words that decide a candidate (up to the first dead move and the span
// limit), not the 17-18 read, and of the gap check the RLP words up to the
// widest span and the lr_tar words only where some move passes its first
// test; PERF.md gives each time against its bound, the host's launch
// included.
#include "gapcheck.cuh"

namespace {

// last pattern p in [0, D] with offs[p] <= j, clamped to D - 1
__device__ __forceinline__ int find_pattern(const int* __restrict__ offs,
                                            int D, int j) {
    int lo = 0, hi = D + 1;
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (offs[mid] <= j) lo = mid; else hi = mid;
    }
    return min(lo, D - 1);
}

// _pcs_item for a warp's 32 items, lane i holding item i's precomputed
// occurrence (pstart, plen), sl, el and the four compared query tokens (a
// lane that holds no item, `valid` false, any values: its bit is 0).  Each
// lane reads only the corpus words its item needs, as independent loads (one
// round): none where the span budget fails; prefix word k =
// refstr[jnp.maximum(pstart - k, 0)] (k = 1, 2) only where sl > k and
// pstart - k >= 0 (below the corpus start the prefix fails unread); suffix
// word k = refstr[pstart + plen + k - 1] (k = 2, 3, unbounded but clamped
// into the view, View::at) only where el >= k.  Returns lane i's ok bit.
// Every lane of the warp calls this.
__device__ __forceinline__ bool pcs_warp(const View& ref, int pstart,
                                         int plen, int sl, int el, int pa1,
                                         int pa2, int pb2, int pb3,
                                         bool valid, int mrs) {
    const bool budget = valid && plen + 1 + sl - 1 + el - 1 <= mrs;
    const bool pre1 = budget && sl > 1, pre2 = budget && sl > 2;
    const bool suf2 = budget && el >= 2, suf3 = budget && el >= 3;
    const int p1 = pstart - 1, p2 = pstart - 2, q = pstart + plen;
    const int a1 = pre1 && p1 >= 0 ? ref.at(max(p1, 0)) : 0;
    const int a2 = pre2 && p2 >= 0 ? ref.at(max(p2, 0)) : 0;
    const int b2 = suf2 ? ref.at(q + 1) : 0;
    const int b3 = suf3 ? ref.at(q + 2) : 0;
    // bitwise, not short-circuit: every compared token is then needed on
    // every path, so its gather is issued in the same round as the corpus
    // words rather than after the first compare (the compiler sinks a load
    // that only a later && term reads into a branch)
    return budget & (!pre1 | ((p1 >= 0) & (a1 == pa1)))
           & (!pre2 | ((p2 >= 0) & (a2 == pa2))) & (!suf2 | (b2 == pb2))
           & (!suf3 | (b3 == pb3));
}

// A3's item resolution (tools/reads.py PCS_PIVOTS, PCS_WINDOW): the first
// item's search probes kPcsPivots pivots a round, and a window holds
// kPcsWindow patterns a round, a lane each
constexpr int kPcsPivots = 32;
constexpr int kPcsWindow = 32;
constexpr int kPcsThreads = 128;
constexpr int kOffsPast = 0x7FFFFFFF;   // offs past D: above every item

// The start w of the first window for item j (offs non-decreasing): w <=
// p(j), offs[w] <= j where any offs word is, and p(j) < w + kPcsWindow,
// p(j) being the last p with offs[p] <= j.  A 32-ary search by the whole
// warp: per round lane k reads pivot k of the open range [a, b) that holds
// the first index whose word is > j, until the range holds fewer than
// kPcsWindow words.  Returns it on every lane.
__device__ __forceinline__ int window_start_warp(const int* __restrict__ offs,
                                                 int D, int j) {
    const int k = lane_id();
    int a = 0, b = D + 1;
    while (b - a >= kPcsWindow) {
        const int n = b - a;
        const int M = a + (int)(((long long)k * n) / kPcsPivots);
        const unsigned bits = __ballot_sync(kFull, offs[M] > j);
        if (bits == 0) {                  // every pivot's word is <= j
            a = __shfl_sync(kFull, M, kPcsPivots - 1) + 1;
            continue;
        }
        const int f = __ffs(bits) - 1;
        if (f == 0) break;                // the first word > j is offs[a]
        const int prev = __shfl_sync(kFull, M, f - 1);
        b = __shfl_sync(kFull, M, f);     // offs[b] > j: the bracket's end
        a = prev + 1;
    }
    return max(a - 1, 0);
}

__device__ __forceinline__ int qt(const int* __restrict__ qtok, int q_len,
                                  int i) {
    return qtok[clampi(i, q_len)];
}

constexpr int kScanThreads = 256;

// ---- the warp bodies, and the replicated index's kernels (items expanded
// from the per-pattern table)

// _fwd_item / _bwd_item for a warp's 32 items, lane i holding item i's
// occurrence `gostart` (a's start forward, b's start backward), sl, el and
// the compared query tokens w0..w2 (b's first three forward, a's last three
// reversed backward); a lane that holds no item (`valid` false) any values:
// its item has gap0_bad and so no candidate.  Returns lane i's move mask.
// Every lane of the warp calls this.
__device__ __forceinline__ unsigned scan_warp(const View& ref, const View& rlp,
                                              const View& lr_tar, int gostart,
                                              int sl, int el, int w0, int w1,
                                              int w2, bool valid, int mrs,
                                              int mgs, bool fwd) {
    const int lane = lane_id();
    const int m = lane & 15;         // the move (and window word) of a lane
    // 1. the gap-0 token, lane i for its own item: refstr[gostart + sl]
    // forward, refstr[jnp.maximum(gostart - 1, 0)] backward
    bool gap0_bad = true;
    if (valid)
        gap0_bad = ref.at(fwd ? gostart + sl : max(gostart - 1, 0)) < 2;

    // 2. the scan's candidate masks, a half-warp per item, items 2it and
    // 2it + 1 in step it; lane i keeps item i's mask
    unsigned cand = 0;
#pragma unroll
    for (int it = 0; it < 16; ++it) {
        const int src = 2 * it + (lane >> 4);
        const int g = __shfl_sync(kFull, gostart, src);
        const int s = __shfl_sync(kFull, sl, src);
        const int e = __shfl_sync(kFull, el, src);
        const int q0 = __shfl_sync(kFull, w0, src);
        const int q1 = __shfl_sync(kFull, w1, src);
        const int q2 = __shfl_sync(kFull, w2, src);
        const bool g0 = __shfl_sync(kFull, (int)gap0_bad, src) != 0;
        // window word m on every lane, words 16 and 17 on lanes 0 and 1:
        // refstr[jnp.minimum(wpos, glen - 1)] forward; backward the words at
        // positions < 0 read as -1
        int lo, hi = 0;
        if (fwd) {
            const int p0 = g + s + mgs;
            lo = ref.at(min(p0 + m, ref.glen - 1));
            if (m < 2) hi = ref.at(min(p0 + 16 + m, ref.glen - 1));
        } else {
            const int p0 = g - 1 - mgs;
            lo = p0 - m < 0 ? -1 : ref.at(p0 - m);
            if (m < 2) hi = p0 - 16 - m < 0 ? -1 : ref.at(p0 - 16 - m);
        }
        // the compared side's length: b's (el) forward, a's (sl) backward
        const int side_len = fwd ? e : s;
        const int other_len = fwd ? s : e;
        const bool bad = lo < 2;
        const bool is_w = lo == q0;
        bool verify_ok = true, verify_kill = false;
#pragma unroll
        for (int k = 1; k <= 2; ++k) {
            // window word m + k (<= 17) from the lane that read it
            const int a = __shfl_sync(kFull, lo, (m + k) & 15, 16);
            const int b = __shfl_sync(kFull, hi, (m + k) & 15, 16);
            const int bo = m + k < 16 ? a : b;
            const int want = k == 1 ? q1 : q2;
            const bool need = side_len > k;
            const bool in_span = other_len + mgs + m + 1 + k <= mrs;
            const bool match = bo == want;
            const bool cmp_here = is_w && need && verify_ok && in_span;
            if (need) verify_ok = verify_ok && in_span && match;
            verify_kill = verify_kill || (cmp_here && !match && bo < 2);
        }
        // reach: no earlier move of this item stopped the scan
        const unsigned stops = __ballot_sync(kFull, bad || verify_kill)
                               >> (lane & 16);
        const bool reach = (stops & ((1u << m) - 1)) == 0;
        const bool span_ok = s + mgs + m + e <= mrs;
        const unsigned c = __ballot_sync(
            kFull, reach && span_ok && !g0 && !bad && is_w && verify_ok);
        if (lane == 2 * it) cand = c & 0xFFFFu;
        if (lane == 2 * it + 1) cand = c >> 16;
    }

    // 3. the gap check, only for items with a candidate (mask = cand & gc,
    // and gc does not depend on the scan): two such items at a time, one
    // per half-warp
    unsigned mask = 0;
    unsigned pending = __ballot_sync(kFull, cand != 0);
    while (pending) {
        const int a = __ffs(pending) - 1;
        pending &= pending - 1;
        const int b = pending ? __ffs(pending) - 1 : -1;
        if (pending) pending &= pending - 1;
        const int item = lane < 16 ? a : b;
        const int src = item < 0 ? 0 : item;
        const int g = __shfl_sync(kFull, gostart, src);
        const int s = __shfl_sync(kFull, sl, src);
        unsigned gc = 0;
        if (item >= 0)
            gc = gap_check_half(rlp, lr_tar, fwd ? g + s : g - 1, mgs - 1, mrs,
                                fwd);
        __syncwarp();
        const unsigned gc_a = __shfl_sync(kFull, gc, 0);
        const unsigned gc_b = __shfl_sync(kFull, gc, 16);
        if (lane == a) mask = cand & gc_a;
        if (lane == b) mask = cand & gc_b;
    }
    return mask;
}

// A2: a warp per 32 consecutive items.  Every lane stays to the end (tail
// lanes past n are masked, never returned), since the shuffles and ballots
// name the whole warp.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(View ref, View rlp, View lr_tar, const int* __restrict__ sa,
            int sa_len, const int* __restrict__ pattab,
            const int* __restrict__ offs, int D, int n, int mrs, int mgs,
            bool fwd, int* __restrict__ out) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const bool valid = j < n;
    // lane i for the warp's item i: the pattern, its row and the SA word
    int gostart = 0, sl = 0, el = 0, w0 = 0, w1 = 0, w2 = 0;
    if (valid) {
        const int p = find_pattern(offs, D, j);
        const int* f = pattab + 8 * p;
        gostart = sa[clip(f[0] + j - offs[p], 0, sa_len - 1)];
        sl = f[1];
        el = f[2];
        w0 = f[3];
        w1 = f[4];
        w2 = f[5];
    }
    // the scan and the gap check, then one coalesced store per warp
    const unsigned mask = scan_warp(ref, rlp, lr_tar, gostart, sl, el, w0, w1,
                                    w2, valid, mrs, mgs, fwd);
    if (valid) out[j] = (int)mask;
}

// _two_item for a warp's 32 aXb cores, lane i holding item i's (pstart,
// plen) (a tail lane any core: its words are not stored): the 16 moves right
// of the core and the fused gap check anchored one token past it, a
// half-warp per item, items 2it and 2it + 1 in step it.  Lane m reads the
// move's corpus word (one 64-byte request a half), `reach` (the AND of
// survive over the earlier moves) is a ballot, and the gap check is
// gap_check_half for every item: gc is part of the output (do_gap=True).
// Both first-round words of pair it + 1 are read while pair it's gap check
// runs.  Lane i gets item i's cand and gc.  Every lane of the warp calls
// this.
__device__ __forceinline__ void two_warp(const View& ref, const View& rlp,
                                         const View& lr_tar, int pstart,
                                         int plen, int mrs, int mgs,
                                         unsigned& cand, unsigned& gc) {
    const int lane = lane_id();
    const int m = lane & 15;
    const int gostart = pstart + plen;
    // refstr[gostart + mgs], lane i for its own item
    const bool gap0_bad = ref.at(gostart + mgs) < 2;
    // lane m's two words of pair it, read a step ahead: the move's corpus
    // word refstr[jnp.minimum(pos, glen - 1)] and the gap check's RLP word
    auto move_word = [&](int g) {
        return ref.at(min(g + 1 + mgs + m, ref.glen - 1));
    };
    int g = __shfl_sync(kFull, gostart, lane >> 4);
    int word = move_word(g);
    unsigned t = gap_check_word(rlp, g + 1, true);
    cand = 0;
    gc = 0;
#pragma unroll 1
    for (int it = 0; it < 16; ++it) {
        const int src = 2 * it + (lane >> 4);
        const int pl = __shfl_sync(kFull, plen, src);
        const bool g0 = __shfl_sync(kFull, (int)gap0_bad, src) != 0;
        int g_next = g, word_next = word;
        unsigned t_next = t;
        if (it < 15) {
            g_next = __shfl_sync(kFull, gostart, src + 2);
            word_next = move_word(g_next);
            t_next = gap_check_word(rlp, g_next + 1, true);
        }
        const bool bad = word < 2;
        const bool span_kill = pl + 1 + mgs + m + 1 > mrs;
        // reach: no earlier move of this item stopped the scan
        const unsigned stops = __ballot_sync(kFull, bad || span_kill)
                               >> (lane & 16);
        const bool reach = (stops & ((1u << m) - 1)) == 0;
        const unsigned c = __ballot_sync(kFull,
                                         reach && !g0 && !span_kill && !bad);
        const unsigned h = gap_check_half(rlp, lr_tar, g + 1, mgs - 1, mrs,
                                          true, t);
        __syncwarp();
        // lane 2it takes half 0's item, lane 2it + 1 half 1's
        const unsigned hv = __shfl_sync(kFull, h, (lane & 1) << 4);
        if ((lane >> 1) == it) {
            cand = (c >> ((lane & 1) << 4)) & 0xFFFFu;
            gc = hv;
        }
        g = g_next;
        word = word_next;
        t = t_next;
    }
}

// A3: a warp per 32 consecutive items j0 .. j0 + 31.  Item j's pattern is
// find_pattern's: the last p in [0, D] with offs[p] <= j, clamped to D - 1.
// 1. The first window's start (window_start_warp): a 32-ary search over
//    offs for the warp's first item j0 that stops once its range holds
//    under 32 words; 0 rounds for D <= 30, 1 up to D = 1,023, 2 up to
//    ~32,800.
// 2. The window: lane k reads offs[base + k] and pattab row base + k (and
//    lane 31 offs[base + 32]) in one round, as independent loads; lane i
//    finds its item's pattern among those 32 by a 5-step bisection over the
//    shuffled offs words, and takes its pattab fields and offs word by
//    shuffle from the lane that loaded them.
// 3. A lane whose item lies past the window (offs[base + 32] <= j: the
//    window started up to 31 patterns before j0's, or the warp's items span
//    more than 32 patterns) stays open, and the next window starts at base
//    + 32, where every open item's pattern lies.
// 4. The precomputed row at clip(f[0] + j - offs[p], 0, m_rows - 1), then
//    pcs_warp, then one ballot word.
// The chain is about log32(D) + 3 dependent rounds, against log2(D) + 3 for
// a per-thread bisection; the rounds a warp takes are counted by
// tools/reads.py pcs_rounds.  Every lane stays to the end (tail lanes past n
// hold no item), since the shuffles and ballots name the whole warp.
__global__ void __launch_bounds__(kPcsThreads)
pcs_kernel(View ref, const int* __restrict__ pcrows, int m_rows,
           const int* __restrict__ pattab, const int* __restrict__ offs,
           int D, int n, int mrs, int* __restrict__ out) {
    const int lane = lane_id();
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int j0 = j - lane;
    if (j0 >= n) return;                  // the whole warp
    const bool valid = j < n;
    // 1. the first window's start, at most 31 patterns before j0's
    int base = window_start_warp(offs, D, j0);
    // 2-3. lane i's pattern row fields and offs word, window by window
    int f0 = 0, sl = 0, el = 0, pa1 = 0, pa2 = 0, pb2 = 0, pb3 = 0, po = 0;
    bool open = valid;
    while (__any_sync(kFull, open)) {
        const int q = base + lane;
        const int lo = q <= D ? offs[q] : kOffsPast;
        const int past = lane == kPcsWindow - 1 && q < D ? offs[q + 1]
                                                           : kOffsPast;
        const int* r = pattab + 8 * min(q, D - 1);
        const int r0 = r[0], r1 = r[1], r2 = r[2], r3 = r[3], r4 = r[4],
                  r5 = r[5], r6 = r[6];
        // lane k's successor word offs[base + k + 1]
        const int next = __shfl_down_sync(kFull, lo, 1);
        const int hi = lane == kPcsWindow - 1 ? past : next;
        // the last window slot k with offs[base + k] <= j (slot 0 if none)
        int k = 0;
#pragma unroll
        for (int s = kPcsWindow / 2; s >= 1; s >>= 1)
            if (__shfl_sync(kFull, lo, k + s) <= j) k += s;
        const bool here = __shfl_sync(kFull, hi, k) > j;
        const int g0 = __shfl_sync(kFull, r0, k);
        const int g1 = __shfl_sync(kFull, r1, k);
        const int g2 = __shfl_sync(kFull, r2, k);
        const int g3 = __shfl_sync(kFull, r3, k);
        const int g4 = __shfl_sync(kFull, r4, k);
        const int g5 = __shfl_sync(kFull, r5, k);
        const int g6 = __shfl_sync(kFull, r6, k);
        const int go = __shfl_sync(kFull, lo, k);
        if (open && here) {
            // pattern base + k, its row clamped to D - 1 (the row lane k
            // loaded); past D - 1 (only items at or past offs[D]) its offs
            // word is offs[D - 1]
            f0 = g0;
            sl = g1;
            el = g2;
            pa1 = g3;
            pa2 = g4;
            pb2 = g5;
            pb3 = g6;
            po = base + k < D ? go : offs[D - 1];
            open = false;
        }
        base += kPcsWindow;
    }
    // 4. the precomputed occurrence (a tail lane's row is clamped too, and
    // its bit masked), the verification, one word per warp
    const int row = clip(f0 + j - po, 0, m_rows - 1);
    const int pstart = pcrows[2 * row], plen = pcrows[2 * row + 1];
    const unsigned word = __ballot_sync(
        kFull, pcs_warp(ref, pstart, plen, sl, el, pa1, pa2, pb2, pb3, valid,
                        mrs));
    if (lane == 0) out[j0 >> 5] = (int)word;
}

// A5: a warp per 32 consecutive items (two_warp); a warp wholly past n
// returns at once, and its other lanes stay to the end
__global__ void __launch_bounds__(kScanThreads)
two_kernel(View ref, View rlp, View lr_tar, const int* __restrict__ ogrows,
           int og_rows, const int* __restrict__ pcrows, int pc_rows,
           const int* __restrict__ pattab, const int* __restrict__ offs, int D,
           int n, int mrs, int mgs, int* __restrict__ out) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j - lane_id() >= n) return;
    // 1. lane i: item i's pattern, its row and the occurrence (start, len)
    int pstart = 0, plen = 0;
    if (j < n) {
        const int p = find_pattern(offs, D, j);
        const int row = pattab[2 * p] + j - offs[p];
        // the unselected table is never read, and the selected read is
        // clamped
        const int* r = pattab[2 * p + 1] > 0
                           ? pcrows + 2 * clampi(row, pc_rows)
                           : ogrows + 2 * clampi(row, og_rows);
        pstart = r[0];
        plen = r[1];
    }
    // 2-3. the candidate and gap-check masks; 4. one coalesced store
    unsigned cand, gc;
    two_warp(ref, rlp, lr_tar, pstart, plen, mrs, mgs, cand, gc);
    if (j < n) out[j] = (int)(cand | (gc << 16));
}

// ---- C1: one item per row of host-resolved columns

// C1f / C1b: a warp per 32 consecutive rows, lane i loading row i's six
// columns (one coalesced load each); a warp wholly past n returns at once
__global__ void __launch_bounds__(kScanThreads)
scan_cols_kernel(View ref, View rlp, View lr_tar,
                 const int* __restrict__ gostart, const int* __restrict__ sl,
                 const int* __restrict__ el, const int* __restrict__ w0,
                 const int* __restrict__ w1, const int* __restrict__ w2, int n,
                 int mrs, int mgs, bool fwd, int* __restrict__ out) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j - lane_id() >= n) return;
    const bool valid = j < n;
    const unsigned mask = scan_warp(
        ref, rlp, lr_tar, valid ? gostart[j] : 0, valid ? sl[j] : 0,
        valid ? el[j] : 0, valid ? w0[j] : 0, valid ? w1[j] : 0,
        valid ? w2[j] : 0, valid, mrs, mgs, fwd);
    if (valid) out[j] = (int)mask;
}

// C1p: a warp per 32 consecutive rows, lane i loading row i's eight columns
// (one coalesced load each; a tail lane the last row's, its bit masked,
// so that no branch holds the loads back), then pcs_warp and one ballot
// word
__global__ void __launch_bounds__(kPcsThreads)
pcs_cols_kernel(View ref, const int* __restrict__ pstart,
                const int* __restrict__ plen, const int* __restrict__ sl,
                const int* __restrict__ el, const int* __restrict__ pa1,
                const int* __restrict__ pa2, const int* __restrict__ pb2,
                const int* __restrict__ pb3, int n, int mrs,
                int* __restrict__ out) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j - lane_id() >= n) return;       // the whole warp
    const int r = min(j, n - 1);          // a tail lane reads the last row
    const unsigned word = __ballot_sync(
        kFull, pcs_warp(ref, pstart[r], plen[r], sl[r], el[r], pa1[r],
                        pa2[r], pb2[r], pb3[r], j < n, mrs));
    if (lane_id() == 0) out[j >> 5] = (int)word;
}

__global__ void __launch_bounds__(kScanThreads)
two_packed_kernel(View ref, View rlp, View lr_tar,
                  const int* __restrict__ pstart,
                  const int* __restrict__ plen, int n, int mrs, int mgs,
                  int* __restrict__ out) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j - lane_id() >= n) return;
    const bool valid = j < n;
    unsigned cand, gc;
    two_warp(ref, rlp, lr_tar, valid ? pstart[j] : 0, valid ? plen[j] : 0,
             mrs, mgs, cand, gc);
    if (valid) out[j] = (int)(cand | (gc << 16));
}

// ---- B3: one item per input row, on views of a shard's slices

// B3f / B3b: a warp per 32 consecutive rows, lane i loading row i's four
// columns and gathering its three compared query tokens; a warp wholly past
// n returns at once
__global__ void __launch_bounds__(kScanThreads)
scan_items_kernel(View ref, View rlp, View lr_tar,
                  const int* __restrict__ qtok, int q_len,
                  const int* __restrict__ gostart, const int* __restrict__ sl,
                  const int* __restrict__ el, const int* __restrict__ qpos,
                  int n, int mrs, int mgs, bool fwd, int* __restrict__ out) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j - lane_id() >= n) return;
    const bool valid = j < n;
    int g = 0, s = 0, e = 0, w0 = 0, w1 = 0, w2 = 0;
    if (valid) {
        const int t = qpos[j];
        g = gostart[j];
        s = sl[j];
        e = el[j];
        // _qtok_fwd (b's first three) / _qtok_bwd (a's last three, reversed)
        w0 = fwd ? qt(qtok, q_len, t) : qt(qtok, q_len, t + s - 1);
        w1 = fwd ? qt(qtok, q_len, t + 1)
                 : qt(qtok, q_len, t + max(s - 2, 0));
        w2 = fwd ? qt(qtok, q_len, t + 2)
                 : qt(qtok, q_len, t + max(s - 3, 0));
    }
    const unsigned mask = scan_warp(ref, rlp, lr_tar, g, s, e, w0, w1, w2,
                                    valid, mrs, mgs, fwd);
    if (valid) out[j] = (int)mask;
}

// B3p: a warp per 32 consecutive rows, lane i loading row i's six columns
// (a tail lane the last row's, its bit masked) and gathering its four
// compared query tokens (a's last two before b, _pcs_batch's clamped
// gathers; b's second and third), then pcs_warp; one word per item
__global__ void __launch_bounds__(kPcsThreads)
pcs_items_kernel(View ref, const int* __restrict__ qtok, int q_len,
                 const int* __restrict__ pstart, const int* __restrict__ plen,
                 const int* __restrict__ sl, const int* __restrict__ el,
                 const int* __restrict__ tok, const int* __restrict__ stok,
                 int n, int mrs, int* __restrict__ out) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j - lane_id() >= n) return;       // the whole warp
    const int r = min(j, n - 1);          // a tail lane reads the last row
    const int t = tok[r], st = stok[r], s = sl[r];
    const bool ok = pcs_warp(ref, pstart[r], plen[r], s, el[r],
                             qt(qtok, q_len, t + max(s - 2, 0)),
                             qt(qtok, q_len, t + max(s - 3, 0)),
                             qt(qtok, q_len, st + 1), qt(qtok, q_len, st + 2),
                             j < n, mrs);
    if (j < n) out[j] = (int)ok;
}

__global__ void __launch_bounds__(kScanThreads)
two_items_kernel(View ref, View rlp, View lr_tar,
                 const int* __restrict__ pstart, const int* __restrict__ plen,
                 int n, int mrs, int mgs, int* __restrict__ out) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j - lane_id() >= n) return;
    const bool valid = j < n;
    unsigned cand, gc;
    two_warp(ref, rlp, lr_tar, valid ? pstart[j] : 0, valid ? plen[j] : 0,
             mrs, mgs, cand, gc);
    if (valid) {
        out[j] = (int)cand;
        out[n + j] = (int)gc;
    }
}

}  // namespace

// A2.  pattab int32 [D, 8] = (SA-range lo, sl, el, three compared query
// tokens: b's first three forward, a's last three reversed backward); offs
// int32 [D + 1] the exclusive count prefix, n = offs[D] items.  out: int32
// [n], the move mask of each item.
CGX_EXPORT int cgx_scan(const int* refstr, int ref_len, const int* rlp,
                        int rlp_len, const int* lr_tar, int lr_len,
                        const int* sa, int sa_len, const int* pattab,
                        const int* offs, int D, int n, int mrs, int mgs,
                        int fwd, int* out, void* stream) {
    if (mrs < 1 || mrs > MMOV || D < 1) return (int)cudaErrorInvalidValue;
    scan_kernel<<<cgx_grid(n, kScanThreads), kScanThreads, 0,
                  (cudaStream_t)stream>>>(
        identity_view(refstr, ref_len), identity_view(rlp, rlp_len),
        identity_view(lr_tar, lr_len), sa, sa_len, pattab, offs, D, n, mrs,
        mgs, fwd != 0, out);
    return (int)cudaGetLastError();
}

// A3.  pcrows int32 [m_rows, 2] = (start, len) of the precomputed
// occurrences; pattab int32 [D, 8] = (pc-row base, sl, el, pa1, pa2, pb2,
// pb3, 0).  out: int32 [(n + 31) / 32], the ok bits packed 32 per word.
CGX_EXPORT int cgx_pcs(const int* refstr, int ref_len, const int* pcrows,
                       int m_rows, const int* pattab, const int* offs, int D,
                       int n, int mrs, int* out, void* stream) {
    if (m_rows < 1 || D < 1) return (int)cudaErrorInvalidValue;
    pcs_kernel<<<cgx_grid(n, kPcsThreads), kPcsThreads, 0,
                 (cudaStream_t)stream>>>(
        identity_view(refstr, ref_len), pcrows, m_rows, pattab, offs, D, n,
        mrs, out);
    return (int)cudaGetLastError();
}

// A5.  pattab int32 [D, 2] = (occurrence-row base, pcmode); ogrows and pcrows
// int32 [m, 2] = (start, len) of the one-gap and the precomputed
// occurrences.  out: int32 [n], the uint32 bits cand | (gc << 16) per item.
CGX_EXPORT int cgx_two(const int* refstr, int ref_len, const int* rlp,
                       int rlp_len, const int* lr_tar, int lr_len,
                       const int* ogrows, int og_rows, const int* pcrows,
                       int pc_rows, const int* pattab, const int* offs, int D,
                       int n, int mrs, int mgs, int* out, void* stream) {
    if (mrs < 1 || mrs > MMOV || D < 1 || og_rows < 1 || pc_rows < 1)
        return (int)cudaErrorInvalidValue;
    two_kernel<<<cgx_grid(n, kScanThreads), kScanThreads, 0,
                 (cudaStream_t)stream>>>(
        identity_view(refstr, ref_len), identity_view(rlp, rlp_len),
        identity_view(lr_tar, lr_len), ogrows, og_rows, pcrows, pc_rows,
        pattab, offs, D, n, mrs, mgs, out);
    return (int)cudaGetLastError();
}

// B3f / B3b.  Views: (words, local length, global offset, global length) of
// refstr, RLP and lr_tar.  Per item: the occurrence `gostart`, sl, el and
// the query position `qpos` (b's first token forward, a's first backward)
// into the padded query tokens `qtok`.  out: int32 [n] move masks.
static int scan_items(const int* ref, int ref_len, int ref_off, int ref_glen,
                      const int* rlp, int rlp_len, int rlp_off, int rlp_glen,
                      const int* lr_tar, int lr_len, int lr_off, int lr_glen,
                      const int* qtok, int q_len, const int* gostart,
                      const int* sl, const int* el, const int* qpos, int n,
                      int mrs, int mgs, bool fwd, int* out, void* stream) {
    if (mrs < 1 || mrs > MMOV || q_len < 1) return (int)cudaErrorInvalidValue;
    scan_items_kernel<<<cgx_grid(n, kScanThreads), kScanThreads, 0,
                        (cudaStream_t)stream>>>(
        View{ref, ref_len, ref_off, ref_glen},
        View{rlp, rlp_len, rlp_off, rlp_glen},
        View{lr_tar, lr_len, lr_off, lr_glen}, qtok, q_len, gostart, sl, el,
        qpos, n, mrs, mgs, fwd, out);
    return (int)cudaGetLastError();
}

CGX_EXPORT int cgx_fwd_items(const int* ref, int ref_len, int ref_off,
                             int ref_glen, const int* rlp, int rlp_len,
                             int rlp_off, int rlp_glen, const int* lr_tar,
                             int lr_len, int lr_off, int lr_glen,
                             const int* qtok, int q_len, const int* gostart,
                             const int* sl, const int* el, const int* stok,
                             int n, int mrs, int mgs, int* out, void* stream) {
    return scan_items(ref, ref_len, ref_off, ref_glen, rlp, rlp_len, rlp_off,
                      rlp_glen, lr_tar, lr_len, lr_off, lr_glen, qtok, q_len,
                      gostart, sl, el, stok, n, mrs, mgs, true, out, stream);
}

CGX_EXPORT int cgx_bwd_items(const int* ref, int ref_len, int ref_off,
                             int ref_glen, const int* rlp, int rlp_len,
                             int rlp_off, int rlp_glen, const int* lr_tar,
                             int lr_len, int lr_off, int lr_glen,
                             const int* qtok, int q_len, const int* gostart,
                             const int* sl, const int* el, const int* tok,
                             int n, int mrs, int mgs, int* out, void* stream) {
    return scan_items(ref, ref_len, ref_off, ref_glen, rlp, rlp_len, rlp_off,
                      rlp_glen, lr_tar, lr_len, lr_off, lr_glen, qtok, q_len,
                      gostart, sl, el, tok, n, mrs, mgs, false, out, stream);
}

// B3p.  Per item: the precomputed occurrence (pstart, plen), sl, el and the
// query positions tok (a's start) and stok (b's start).  out: int32 [n], 1
// where the occurrence verifies.
CGX_EXPORT int cgx_pcs_items(const int* ref, int ref_len, int ref_off,
                             int ref_glen, const int* qtok, int q_len,
                             const int* pstart, const int* plen,
                             const int* sl, const int* el, const int* tok,
                             const int* stok, int n, int mrs, int* out,
                             void* stream) {
    if (q_len < 1) return (int)cudaErrorInvalidValue;
    pcs_items_kernel<<<cgx_grid(n, kPcsThreads), kPcsThreads, 0,
                       (cudaStream_t)stream>>>(
        View{ref, ref_len, ref_off, ref_glen}, qtok, q_len, pstart, plen, sl,
        el, tok, stok, n, mrs, out);
    return (int)cudaGetLastError();
}

// B3t.  Per item: an aXb occurrence (pstart, plen).  out: int32 [2, n], the
// candidate masks, then the gap-check masks.
CGX_EXPORT int cgx_two_items(const int* ref, int ref_len, int ref_off,
                             int ref_glen, const int* rlp, int rlp_len,
                             int rlp_off, int rlp_glen, const int* lr_tar,
                             int lr_len, int lr_off, int lr_glen,
                             const int* pstart, const int* plen, int n,
                             int mrs, int mgs, int* out, void* stream) {
    if (mrs < 1 || mrs > MMOV) return (int)cudaErrorInvalidValue;
    two_items_kernel<<<cgx_grid(n, kScanThreads), kScanThreads, 0,
                       (cudaStream_t)stream>>>(
        View{ref, ref_len, ref_off, ref_glen},
        View{rlp, rlp_len, rlp_off, rlp_glen},
        View{lr_tar, lr_len, lr_off, lr_glen}, pstart, plen, n, mrs, mgs,
        out);
    return (int)cudaGetLastError();
}

// C1f / C1b.  Per item: the occurrence `gostart` (a's start forward, b's
// start backward, read from the host SA), sl, el and the three compared
// query tokens w0..w2 (b's first three forward, a's last three reversed
// backward).  out: int32 [n] move masks.
CGX_EXPORT int cgx_scan_cols(const int* refstr, int ref_len, const int* rlp,
                             int rlp_len, const int* lr_tar, int lr_len,
                             const int* gostart, const int* sl, const int* el,
                             const int* w0, const int* w1, const int* w2,
                             int n, int mrs, int mgs, int fwd, int* out,
                             void* stream) {
    if (mrs < 1 || mrs > MMOV) return (int)cudaErrorInvalidValue;
    scan_cols_kernel<<<cgx_grid(n, kScanThreads), kScanThreads, 0,
                       (cudaStream_t)stream>>>(
        identity_view(refstr, ref_len), identity_view(rlp, rlp_len),
        identity_view(lr_tar, lr_len), gostart, sl, el, w0, w1, w2, n, mrs,
        mgs, fwd != 0, out);
    return (int)cudaGetLastError();
}

// C1p.  Per item: a precomputed occurrence (pstart, plen), sl, el and the
// four compared query tokens.  out: int32 [(n + 31) / 32], the ok bits
// packed 32 per word.
CGX_EXPORT int cgx_pcs_cols(const int* refstr, int ref_len,
                            const int* pstart, const int* plen, const int* sl,
                            const int* el, const int* pa1, const int* pa2,
                            const int* pb2, const int* pb3, int n, int mrs,
                            int* out, void* stream) {
    pcs_cols_kernel<<<cgx_grid(n, kPcsThreads), kPcsThreads, 0,
                      (cudaStream_t)stream>>>(
        identity_view(refstr, ref_len), pstart, plen, sl, el, pa1, pa2, pb2,
        pb3, n, mrs, out);
    return (int)cudaGetLastError();
}

// C1t.  Per item: an aXb occurrence (pstart, plen).  out: int32 [n], the
// uint32 bits cand | (gc << 16).
CGX_EXPORT int cgx_two_packed(const int* refstr, int ref_len, const int* rlp,
                              int rlp_len, const int* lr_tar, int lr_len,
                              const int* pstart, const int* plen, int n,
                              int mrs, int mgs, int* out, void* stream) {
    if (mrs < 1 || mrs > MMOV) return (int)cudaErrorInvalidValue;
    two_packed_kernel<<<cgx_grid(n, kScanThreads), kScanThreads, 0,
                        (cudaStream_t)stream>>>(
        identity_view(refstr, ref_len), identity_view(rlp, rlp_len),
        identity_view(lr_tar, lr_len), pstart, plen, n, mrs, mgs, out);
    return (int)cudaGetLastError();
}
