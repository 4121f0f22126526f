// P1 (cgx_probe_sum) and P2 (cgx_probe_rows): the gather probe, 32-word
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
// 2-row block that runs past the last row) have no counterpart: the
// kernels take any n >= 1 (a ragged last chunk is masked; the wrapper
// launches nothing for n = 0), and the probe's functions require n % 512
// == 0 as its grid does.
//
// Bound on the H100: bytes.  Each position is read once and each output
// row written once (P2: 128 bytes an item); the windows overlap, so the
// corpus words they need are their union (tools/reads.py probe_reads),
// at most the corpus, which fits in the 50 MB L2.  A gather is a chain: a
// window's position must arrive before its load can issue; and the
// windows' reuse is served by the L2, not by the HBM the bound counts.
//
// Design: persistent blocks (the wrapper launches every SM's resident
// blocks, kBlocksPerSM, capped by the items), and each warp walks chunks
// of 32 items, the warps of the grid in turn.  One coalesced load brings a
// chunk's 32 positions (lane l holds item l's), and the next chunk's
// positions are loaded before this chunk's windows, so the chain
// position -> window is paid once a warp, not once an item.  The warp then
// takes the chunk's items kInFlight at a time: it broadcasts each position
// with __shfl_sync and issues all kInFlight window loads (lane l reads word
// l of each window, one or two 128-byte lines a window) before it consumes
// any, so a warp keeps kInFlight windows in flight.
//
// P1: each lane adds its words in a register over all of its warp's items;
// the warp's lanes meet in one __reduce_add_sync at the end, the block's
// warps in shared memory, and each block writes one partial and takes one
// ticket (atomicInc, one atomic a block); the block that takes the last
// ticket adds the partials and writes the checksum, and the ticket wraps
// back to 0 for the next launch.  The sums are unsigned, so they wrap mod
// 2^32 as the JAX int32 sum does (signed overflow would be undefined), and
// unsigned addition mod 2^32 is associative and commutative: the checksum
// equals the plain version's bit for bit whatever the grid, the walk's
// order or the order the blocks finish in.
//
// P2: each row is stored by the warp as one coalesced 128-byte line with
// __stcs (st.global.cs, evict-first), so that the rows stream past the L2
// and the corpus, which the windows read again, stays there.
#include "common.cuh"

constexpr int kWin = 32;          // window width, and items a warp's chunk
constexpr int kWarps = 8;         // warps a block
constexpr int kInFlight = 8;      // windows a warp loads before it uses one
constexpr int kBlocksPerSM = 8;   // resident blocks an SM: 64 warps, <= 32
                                  // registers a thread (the launch bound)

namespace {

// The ticket of P1's launch in flight: the blocks that have written their
// partial.  P1 launches run one at a time (one stream).
__device__ unsigned g_ticket;

// The warp's walk: chunks c = its warp index, + the grid's warps, ...; for
// every item, sink(item, in range, lane's word of the item's window).
template <class Sink>
__device__ __forceinline__ void walk(const int* __restrict__ ref, int len,
                                     const int* __restrict__ pos, int n,
                                     Sink&& sink) {
    const int lane = lane_id();
    const int chunks = n / kWin + (n % kWin != 0);
    const int step = gridDim.x * kWarps;
    // chunk c's position of the lane's item (0 past the items)
    auto load = [&](int c) {
        return c < chunks && lane < n - c * kWin ? __ldg(pos + c * kWin + lane)
                                                 : 0;
    };
    int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
    int next = load(c);
    for (; c < chunks; c += step) {
        const int base = c * kWin, cnt = min(kWin, n - base);
        const int p = next;
        next = load(c + step);
#pragma unroll
        for (int k0 = 0; k0 < kWin; k0 += kInFlight) {
            int v[kInFlight];
#pragma unroll
            for (int j = 0; j < kInFlight; ++j)
                v[j] = __ldg(ref + clampi(__shfl_sync(kFull, p, k0 + j) + lane,
                                          len));
#pragma unroll
            for (int j = 0; j < kInFlight; ++j)
                sink(base + k0 + j, k0 + j < cnt, v[j]);
        }
    }
}

__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSM)
gather_sum_kernel(const int* __restrict__ ref, int len,
                  const int* __restrict__ pos, int n,
                  unsigned* __restrict__ partial, unsigned* __restrict__ out) {
    __shared__ unsigned part[kWarps];
    __shared__ bool last;
    const int lane = lane_id(), w = threadIdx.x >> 5;
    unsigned acc = 0;
    walk(ref, len, pos, n, [&](int, bool in, int v) {
        acc += in ? (unsigned)v : 0u;
    });
    acc = __reduce_add_sync(kFull, acc);
    if (lane == 0) part[w] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned s = 0;
        for (int k = 0; k < kWarps; ++k) s += part[k];
        partial[blockIdx.x] = s;
        __threadfence();
        last = atomicInc(&g_ticket, gridDim.x - 1) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    unsigned s = 0;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x)
        s += __ldcg(partial + b);
    s = __reduce_add_sync(kFull, s);
    if (lane == 0) part[w] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned t = 0;
        for (int k = 0; k < kWarps; ++k) t += part[k];
        *out = t;
    }
}

__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSM)
gather_rows_kernel(const int* __restrict__ ref, int len,
                   const int* __restrict__ pos, int n, int* __restrict__ out) {
    const int lane = lane_id();
    walk(ref, len, pos, n, [&](int item, bool in, int v) {
        if (in) __stcs(out + (long long)item * kWin + lane, v);
    });
}

}  // namespace

// P1.  ref int32 [len], pos int32 [n], launched on `blocks` blocks (the
// wrapper's grid: 1 <= blocks).  scratch: int32 [blocks + 1], any contents;
// scratch[blocks] gets the wrapped sum over items of ref[pos + 0 .. pos +
// 31] (reads clamped), scratch[0 .. blocks - 1] the blocks' partials.
CGX_EXPORT int cgx_probe_sum(const int* ref, int len, const int* pos, int n,
                             int blocks, int* scratch, void* stream) {
    if (len < 1 || n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
    gather_sum_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        ref, len, pos, n, (unsigned*)scratch, (unsigned*)scratch + blocks);
    return (int)cudaGetLastError();
}

// P2.  out: int32 [n, 32], row i = ref[pos[i] + 0 .. pos[i] + 31] (reads
// clamped), launched on `blocks` blocks.
CGX_EXPORT int cgx_probe_rows(const int* ref, int len, const int* pos, int n,
                              int blocks, int* out, void* stream) {
    if (len < 1 || n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
    gather_rows_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        ref, len, pos, n, out);
    return (int)cudaGetLastError();
}
