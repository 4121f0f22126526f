// P1 (cgx_gather_sum) and P2 (cgx_gather_rows): the gather probe, 32-word
// corpus windows read at scattered positions.
//
// Replaces the two pl.pallas_call kernels of tools/pallas_probe.py:
// pallas_gather_fn (:51-94, the call at :89), which sums every item's
// window ref[p:p+32] into one int32 checksum, and pallas_pipelined_fn
// (:97-155, the call at :150), which copies every item's window into its
// output row.  Both are defined as the probe's xla_gather defines them
// (:40-43, what the probe asserts the Pallas checksums against): the
// window of the whole array, each read clamped into it as a JAX gather
// clamps.  The TPU kernels' edges (a 512-item grid that drops a tail, a
// 2-row block that runs past the last row) have no counterpart; the
// wrapper requires n % 512 == 0 as the probe's grid does.
//
// Design: one warp per item; lane l reads word l of the window, so a
// window is one or two 128-byte lines read coalesced.  P1 sums the warp's
// 32 words with __reduce_add_sync over unsigned values (they wrap as the
// JAX int32 sum does; signed overflow would be undefined), the block's
// warps through shared memory, and one thread adds the block's sum to the
// checksum atomically.  P2 stores each row with the same coalesced
// pattern.  The TPU probe's K copies in flight (pltpu.make_async_copy with
// rotating semaphores) would be cp.async or TMA here: later work.
//
// Bound on the H100: bytes.  Per item one position word and 32 gathered
// words (P2: and 32 written); the gathers land on random lines, so the
// card's rate for scattered 128-byte lines, not its streaming rate, is the
// real limit.
#include "common.cuh"

#define WIN 32     // window width per item (tools/pallas_probe.py: W)
#define WARPS 8    // items (warps) per block

namespace {

__global__ void gather_sum_kernel(const int* __restrict__ ref, int len,
                                  const int* __restrict__ pos, int n,
                                  unsigned* __restrict__ out) {
    __shared__ unsigned part[WARPS];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int item = blockIdx.x * WARPS + w;
    unsigned v = 0;
    if (item < n) v = (unsigned)ref[clampi(pos[item] + lane, len)];
    v = __reduce_add_sync(0xFFFFFFFFu, v);
    if (lane == 0) part[w] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned s = 0;
        for (int k = 0; k < WARPS; ++k) s += part[k];
        atomicAdd(out, s);
    }
}

__global__ void gather_rows_kernel(const int* __restrict__ ref, int len,
                                   const int* __restrict__ pos, int n,
                                   int* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int item = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (item >= n) return;
    out[(long long)item * WIN + lane] = ref[clampi(pos[item] + lane, len)];
}

}  // namespace

// P1.  ref int32 [len], pos int32 [n].  out: int32 [1], zero on entry, gets
// the wrapped sum over items of ref[pos + 0 .. pos + 31] (reads clamped).
CGX_EXPORT int cgx_gather_sum(const int* ref, int len, const int* pos, int n,
                              int* out, void* stream) {
    if (len < 1 || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    gather_sum_kernel<<<cgx_grid(n, WARPS), WARPS * 32, 0,
                        (cudaStream_t)stream>>>(ref, len, pos, n,
                                                (unsigned*)out);
    return (int)cudaGetLastError();
}

// P2.  out: int32 [n, 32], row i = ref[pos[i] + 0 .. pos[i] + 31] (reads
// clamped).
CGX_EXPORT int cgx_gather_rows(const int* ref, int len, const int* pos, int n,
                               int* out, void* stream) {
    if (len < 1 || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    gather_rows_kernel<<<cgx_grid(n, WARPS), WARPS * 32, 0,
                         (cudaStream_t)stream>>>(ref, len, pos, n, out);
    return (int)cudaGetLastError();
}
