// A4: the precompute gap check.  For every occurrence of a frequent token,
// the target-side gap-consistency check of all 16 nested gap moves next to
// it, as one packed 16-bit mask.
//
// Replaces cgx_tpu/search/precompute.py:_gc_batch (precompute.py:38-53), a
// vmap of lookup._gap_check_grow over anchors gostart + 1 (forward) or
// gostart - 1 (backward).  One thread per occurrence runs the shared
// gap_check_grow (gapcheck.cuh).  The RLP and target arrays come as views
// (common.cuh): the whole arrays on the replicated index, a shard's slices
// with their global offsets on the sharded one (JAX passes `offs`).
//
// Bound on the H100: per item 2 + mrs scattered RLP words and one 16-word
// lr_tar window (~33 reads, mostly within one or two 128-byte lines), then
// ~300 integer ops on registers.  Neighbouring occurrences of a token lie far
// apart in the corpus, so the reads do not coalesce; the design keeps the
// state in registers and issues each window as one short run of reads.
#include "gapcheck.cuh"

namespace {

__global__ void gap_check_kernel(View rlp, View lr_tar,
                                 const int* __restrict__ gostart, int n,
                                 int mrs, int mgs, bool fwd,
                                 int* __restrict__ out) {
    const int item = blockIdx.x * blockDim.x + threadIdx.x;
    if (item >= n) return;
    const int anchor = fwd ? gostart[item] + 1 : gostart[item] - 1;
    out[item] = (int)gap_check_grow(rlp, lr_tar, anchor, mgs - 1, mrs, fwd);
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
    const int threads = 128;
    gap_check_kernel<<<cgx_grid(n, threads), threads, 0,
                       (cudaStream_t)stream>>>(r, t, gostart, n, mrs, mgs,
                                               fwd != 0, out);
    return (int)cudaGetLastError();
}
