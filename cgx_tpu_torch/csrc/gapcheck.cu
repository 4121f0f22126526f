// A4: the precompute gap check.  For every occurrence of a frequent token,
// the target-side gap-consistency check of all 16 nested gap moves next to
// it, as one packed 16-bit mask.
//
// Replaces cgx_tpu/search/precompute.py:_gc_batch (precompute.py:38-53), a
// vmap of lookup._gap_check_grow over anchors gostart + 1 (forward) or
// gostart - 1 (backward).  The RLP and target arrays come as views
// (common.cuh): the whole arrays on the replicated index, a shard's slices
// with their global offsets on the sharded one (JAX passes `offs`).
//
// Bound on the H100: per item 2 + mrs RLP words and one 16-word lr_tar
// window (~33 words, mostly within one or two 128-byte lines), then ~300
// integer ops.  Neighbouring occurrences of a token lie far apart in the
// corpus, so items share no lines, and each item is a chain of three
// dependent reads (the RLP window, the sentence anchor at tempind, the
// target window): latency and the L1's wavefronts bound it, not bytes.
// Design: one half-warp per occurrence (gap_check_half, gapcheck.cuh), lane m
// reading window word m, so each window is one 64-byte request instead of 16
// per-thread loads that keep 16 lines per thread resident; the target window
// is skipped when no move passes the first test.  The two halves of a warp
// read their two adjacent gostart words in one request, and write their
// masks the same way.  On the H100 at europarl it takes about 7x its byte
// bound (PERF.md): the three dependent reads of each item remain.
#include "gapcheck.cuh"

namespace {

constexpr int kThreads = 256;             // 16 items per block

__global__ void __launch_bounds__(kThreads)
gap_check_kernel(View rlp, View lr_tar, const int* __restrict__ gostart,
                 int n, int mrs, int mgs, bool fwd, int* __restrict__ out) {
    const int item = blockIdx.x * (kThreads / 16) + (threadIdx.x >> 4);
    if (item >= n) return;        // the whole half-warp leaves together
    const int anchor = fwd ? gostart[item] + 1 : gostart[item] - 1;
    const unsigned mask = gap_check_half(rlp, lr_tar, anchor, mgs - 1, mrs,
                                         fwd);
    if ((lane_id() & 15) == 0) out[item] = (int)mask;
}

}  // namespace

// Views: (words, local length, global offset, global length).  out: int32
// [n], the uint32 move mask of each occurrence.
CGX_EXPORT int cgx_gap_check(const int* rlp, int rlp_len, int rlp_off,
                             int rlp_glen, const int* lr_tar, int lr_len,
                             int lr_off, int lr_glen, const int* gostart,
                             int n, int mrs, int mgs, int fwd, int* out,
                             void* stream) {
    if (mrs < 1 || mrs > MMOV) return (int)cudaErrorInvalidValue;
    const View r{rlp, rlp_len, rlp_off, rlp_glen};
    const View t{lr_tar, lr_len, lr_off, lr_glen};
    gap_check_kernel<<<cgx_grid(n, kThreads / 16), kThreads, 0,
                       (cudaStream_t)stream>>>(r, t, gostart, n, mrs, mgs,
                                               fwd != 0, out);
    return (int)cudaGetLastError();
}
