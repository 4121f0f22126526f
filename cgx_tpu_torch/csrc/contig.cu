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
// (extract_common.cuh).  The item body is in contig.cuh, which kernel B4
// (dist.cu) shares.
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
#include "contig.cuh"

namespace {

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
