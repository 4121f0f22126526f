// lookup1's and lookup2's device kernels, one thread per work item:
//
// A2 (cgx_scan): the forward/backward aXb occurrence scan.  Replaces
//   cgx_tpu/search/lookup.py:_scan_batch_exp (lookup.py:337-353) with
//   _cumsum_expand (:298), _fwd_item (:110), _bwd_item (:161) and the fused
//   _gap_check_grow (gapcheck.cuh).  Item j belongs to pattern p, the last p
//   with offs[p] <= j (a binary search over the count prefix; patterns with
//   no items are skipped), and reads its start from the device SA.  The 16
//   gap moves are scanned in order, so the JAX prefix-AND of "survive"
//   becomes a running flag.
// A3 (cgx_pcs): the precomp-seed verification.  Replaces
//   lookup.py:_pcs_batch_exp (:315) with _pcs_item (:203): the span budget,
//   up to 2 prefix and 2 suffix tokens per precomputed occurrence.  The ok
//   bits leave packed 32 per word; one warp ballot writes each word.
// A5 (cgx_two): lookup2's scan for a second gap.  Replaces
//   lookup.py:_two_batch_exp (:662-680) with _two_item (:615-639): from an
//   aXb occurrence (start, len), read from the precomputed rows or the
//   one-gap rows as the pattern's pcmode flag says, the 16 moves right of
//   the core and the fused gap check anchored one token past it.  The word
//   holds the uint32 bits cand | (gc << 16); the c token is resolved on the
//   host.
//
// Bound on the H100: A2 reads per item one offs search (log2 D words), one
// pattab row, one SA word, an 18-word corpus window and the gap check's ~33
// words, all scattered (occurrences of a pattern are SA-ordered, not corpus-
// ordered); A3 reads ~8 words; A5 one offs search, one pattab row, one
// occurrence row, a 17-word corpus window and the gap check.  All are
// latency-bound gathers with a few hundred integer ops per item at most; the
// design keeps every per-item array in registers and launches once over the
// whole item axis.
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

__global__ void scan_kernel(const int* __restrict__ refstr, int ref_len,
                            const int* __restrict__ rlp, int rlp_len,
                            const int* __restrict__ lr_tar, int lr_len,
                            const int* __restrict__ sa, int sa_len,
                            const int* __restrict__ pattab,
                            const int* __restrict__ offs, int D, int n,
                            int mrs, int mgs, bool fwd,
                            int* __restrict__ out) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    const int p = find_pattern(offs, D, j);
    const int* f = pattab + 8 * p;
    const int tx = j - offs[p];
    const int gostart = sa[clip(f[0] + tx, 0, sa_len - 1)];
    const int sl = f[1], el = f[2];
    const int want0 = f[3], want1 = f[4], want2 = f[5];
    // the compared side's length: b's (el) forward, a's (sl) backward
    const int side_len = fwd ? el : sl;
    const int other_len = fwd ? sl : el;

    bool gap0_bad;
    int win[MMOV + 2];
    if (fwd) {
        gap0_bad = refstr[clampi(gostart + sl, ref_len)] < 2;
        for (int k = 0; k < MMOV + 2; ++k)
            win[k] = refstr[clampi(gostart + sl + mgs + k, ref_len)];
    } else {
        gap0_bad = refstr[clampi(max(gostart - 1, 0), ref_len)] < 2;
        for (int k = 0; k < MMOV + 2; ++k) {
            const int pos = gostart - 1 - mgs - k;
            win[k] = pos < 0 ? -1 : refstr[clampi(pos, ref_len)];
        }
    }
    const unsigned gc = fwd
        ? gap_check_grow(rlp, rlp_len, lr_tar, lr_len, gostart + sl, mgs - 1,
                         mrs, true)
        : gap_check_grow(rlp, rlp_len, lr_tar, lr_len, gostart - 1, mgs - 1,
                         mrs, false);

    unsigned mask = 0;
    bool reach = true;               // AND of survive over the earlier moves
    for (int m = 0; m < MMOV; ++m) {
        const int temp = win[m];
        const bool bad = temp < 2;
        const bool is_w = temp == want0;
        bool verify_ok = true, verify_kill = false;
        for (int k = 1; k <= 2; ++k) {
            const int want = k == 1 ? want1 : want2;
            const bool need = side_len > k;
            const bool in_span = other_len + mgs + m + 1 + k <= mrs;
            const int bo = win[m + k];
            const bool match = bo == want;
            const bool cmp_here = is_w && need && verify_ok && in_span;
            if (need) verify_ok = verify_ok && in_span && match;
            verify_kill = verify_kill || (cmp_here && !match && bo < 2);
        }
        const bool span_ok = sl + mgs + m + el <= mrs;
        const bool cand = reach && span_ok && !gap0_bad && !bad && is_w
                          && verify_ok;
        if (cand && ((gc >> m) & 1u)) mask |= 1u << m;
        reach = reach && !bad && !verify_kill;
    }
    out[j] = (int)mask;
}

__global__ void pcs_kernel(const int* __restrict__ refstr, int ref_len,
                           const int* __restrict__ pcrows, int m_rows,
                           const int* __restrict__ pattab,
                           const int* __restrict__ offs, int D, int n,
                           int mrs, int* __restrict__ out) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    bool ok = false;
    if (j < n) {
        const int p = find_pattern(offs, D, j);
        const int* f = pattab + 8 * p;
        const int row = clip(f[0] + j - offs[p], 0, m_rows - 1);
        const int pstart = pcrows[2 * row], plen = pcrows[2 * row + 1];
        const int sl = f[1], el = f[2];
        ok = plen + 1 + sl - 1 + el - 1 <= mrs;
        // prefix: backoff k = 1, 2 (sl <= 3)
        for (int k = 1; k <= 2; ++k) {
            const int p0 = pstart - k;
            const bool good = p0 >= 0
                && refstr[clampi(max(p0, 0), ref_len)] == f[2 + k];
            if (sl > k) ok = ok && good;
        }
        // suffix: forward k = 2, 3 (el <= 3)
        for (int k = 2; k <= 3; ++k) {
            const bool good =
                refstr[clampi(pstart + plen + k - 1, ref_len)] == f[3 + k];
            if (el >= k) ok = ok && good;
        }
    }
    // bit (j % 32) of word j / 32; blockDim is a multiple of 32, so lane
    // (threadIdx.x & 31) == j % 32
    const unsigned word = __ballot_sync(0xFFFFFFFFu, ok);
    if ((threadIdx.x & 31) == 0 && j < n) out[j >> 5] = (int)word;
}

__global__ void two_kernel(const int* __restrict__ refstr, int ref_len,
                           const int* __restrict__ rlp, int rlp_len,
                           const int* __restrict__ lr_tar, int lr_len,
                           const int* __restrict__ ogrows, int og_rows,
                           const int* __restrict__ pcrows, int pc_rows,
                           const int* __restrict__ pattab,
                           const int* __restrict__ offs, int D, int n,
                           int mrs, int mgs, int* __restrict__ out) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    const int p = find_pattern(offs, D, j);
    const int row = pattab[2 * p] + j - offs[p];
    // the unselected table is never read, and the selected read is clamped
    const int* r = pattab[2 * p + 1] > 0 ? pcrows + 2 * clampi(row, pc_rows)
                                         : ogrows + 2 * clampi(row, og_rows);
    const int pstart = r[0], plen = r[1];
    const int gostart = pstart + plen;
    const bool gap0_bad = refstr[clampi(gostart + mgs, ref_len)] < 2;
    unsigned cand = 0;
    bool reach = true;               // AND of survive over the earlier moves
    for (int m = 0; m < MMOV; ++m) {
        const bool bad = refstr[clampi(gostart + 1 + mgs + m, ref_len)] < 2;
        const bool span_kill = plen + 1 + mgs + m + 1 > mrs;
        if (reach && !gap0_bad && !span_kill && !bad) cand |= 1u << m;
        reach = reach && !bad && !span_kill;
    }
    const unsigned gc = gap_check_grow(rlp, rlp_len, lr_tar, lr_len,
                                       gostart + 1, mgs - 1, mrs, true);
    out[j] = (int)(cand | (gc << 16));
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
    const int threads = 128;
    scan_kernel<<<cgx_grid(n, threads), threads, 0, (cudaStream_t)stream>>>(
        refstr, ref_len, rlp, rlp_len, lr_tar, lr_len, sa, sa_len, pattab,
        offs, D, n, mrs, mgs, fwd != 0, out);
    return (int)cudaGetLastError();
}

// A3.  pcrows int32 [m_rows, 2] = (start, len) of the precomputed
// occurrences; pattab int32 [D, 8] = (pc-row base, sl, el, pa1, pa2, pb2,
// pb3, 0).  out: int32 [(n + 31) / 32], the ok bits packed 32 per word.
CGX_EXPORT int cgx_pcs(const int* refstr, int ref_len, const int* pcrows,
                       int m_rows, const int* pattab, const int* offs, int D,
                       int n, int mrs, int* out, void* stream) {
    if (m_rows < 1 || D < 1) return (int)cudaErrorInvalidValue;
    const int threads = 128;
    pcs_kernel<<<cgx_grid(n, threads), threads, 0, (cudaStream_t)stream>>>(
        refstr, ref_len, pcrows, m_rows, pattab, offs, D, n, mrs, out);
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
    const int threads = 128;
    two_kernel<<<cgx_grid(n, threads), threads, 0, (cudaStream_t)stream>>>(
        refstr, ref_len, rlp, rlp_len, lr_tar, lr_len, ogrows, og_rows, pcrows,
        pc_rows, pattab, offs, D, n, mrs, mgs, out);
    return (int)cudaGetLastError();
}
