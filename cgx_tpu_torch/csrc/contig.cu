// A6: contiguous-block rule extraction (extractConsistentPairs_Gappy,
// ExtractPair.cu:1055-1795): the base `ab` consistency check plus the
// 14-step left/right growth state machine emitting Xab, abX and XabX.
//
// Replaces cgx_tpu/extract/device.py:_contig_batch, a vmap over
// _extract_contig_item (device.py:177-378).  The warp body is in
// contig.cuh, which kernel B4 (dist.cu) shares: a warp takes 32 sampled
// occurrences, gathers each one's words and per-step tables on a half-warp
// into a record in shared memory, then runs every item's growth state
// machine on its own lane.  Every read of refstr/rlp/lr_tar goes through a
// view with the JAX bounds (extract_common.cuh).
//
// B3c (cgx_contig_pos) runs the same body on occurrences given by corpus
// position, on one shard's slices: it replaces
// cgx_tpu/extract/device.py:_contig_batch_pos (device.py:391-396).
//
// Bound on the H100: per item the SA word, the words the function needs
// (the block's span words, the sentence anchor, each side's token and RLP
// word of every growth step that runs, and the target window entries that
// its checks look up; chip_smoke.py counts them from the data with
// tools/reads.py: most items stop after a few steps) and the packed row.
// The body gathers more (~90 scattered words an item: every side step and
// three whole 2H + 1 = 29-word windows) because the gathers come before the
// state machine that decides which are needed.  The one-thread body it
// replaces read each window word by word (32 unrelated lines per warp load)
// and kept ~200 words of per-item arrays in local memory (254 registers and
// a 1,096-byte stack).  Here each window is one 64-byte request per
// half-warp and the per-item arrays live in the shared record (contig.cuh),
// so the growth loop reads shared memory only.
#include "contig.cuh"

namespace {

// lane i of a warp: item j = its global index; a warp wholly past n returns
__global__ void __launch_bounds__(kContigThreads, kContigBlocks)
contig_kernel(Arrays a, const int* __restrict__ sa, int sa_len,
              const int* __restrict__ sa_pos, const int* __restrict__ lms,
              int n, int mrs, int msym, int* __restrict__ out) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j - lane_id() >= n) return;
    const bool valid = j < n;
    const int cs = valid ? sa[clampi(sa_pos[j], sa_len)] : 0;
    contig_warp(a, cs, valid ? lms[j] : 1, valid, j, n, mrs, msym, out);
}

__global__ void __launch_bounds__(kContigThreads, kContigBlocks)
contig_pos_kernel(Arrays a, const int* __restrict__ cs,
                  const int* __restrict__ lms, int n, int mrs, int msym,
                  int* __restrict__ out) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j - lane_id() >= n) return;
    const bool valid = j < n;
    contig_warp(a, valid ? cs[j] : 0, valid ? lms[j] : 1, valid, j, n, mrs,
                msym, out);
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
    contig_kernel<<<cgx_grid(n, kContigThreads), kContigThreads, 0,
                    (cudaStream_t)stream>>>(a, sa, sa_len, sa_pos, lm, n, mrs,
                                            msym, out);
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
    contig_pos_kernel<<<cgx_grid(n, kContigThreads), kContigThreads, 0,
                        (cudaStream_t)stream>>>(a, cs, lm, n, mrs, msym, out);
    return (int)cudaGetLastError();
}
