// lookup1's rows on the device, A2s (cgx_sort_hist, cgx_sort_scatter,
// cgx_unpack_rows): the sort of the packed int64 row keys that A2m writes
// (and of the host-built rows' keys uploaded beside them), and the unpacking
// of the sorted keys into the int32 columns (pattern, start, length).
//
// Replaces no TPU kernel: the JAX package lexsorts its rows on the host
// (cgx_tpu/search/lookup.py one_gap_lookup_tpu).  Keys are non-negative and
// unique, so their order is the lexsort's.  A least-significant-digit radix
// sort over 8-bit digits, one pass per digit of the key's width only (a
// Europarl request's keys take 47 bits: 6 passes), between two buffers of
// 8 bytes a key, and nothing else the size of the keys: the route's peak is
// the sorted keys and their columns, 20 bytes a key, under A2's mask column
// of 4 bytes an item at the cells' yields (search/lookup.py scan_rows).  A
// pass is two kernels around an exclusive prefix taken on the
// device (torch.cumsum):
//   sort_hist_kernel: a block per tile of 4,096 keys counts the tile's keys
//     of each digit in shared memory and writes the counts digit-major
//     (hist[d * tiles + tile]), so that their exclusive prefix is each
//     (digit, tile)'s first output slot;
//   sort_scatter_kernel: the block reads its tile again row by row (16 rows
//     of 256 consecutive keys, in order), ranks each key among the row's
//     keys of its digit (__match_any_sync within a warp, the warps' counts
//     in shared memory before it) after the earlier rows' (a running count
//     per digit), and writes it to its slot: stable, as each LSD pass must
//     be.
// unpack_kernel: a thread per key writes its three fields.
// Bound on the H100: each pass reads the keys twice and writes them once,
// 24 bytes a key (the least a sort of the keys could move is 16: one read,
// one write); the scatter's writes land in 256 runs a tile.
#include "common.cuh"

namespace {

constexpr int kTile = 4096;          // keys a block (search/lookup.py)
constexpr int kSortThreads = 256;
constexpr int kSortRows = kTile / kSortThreads;
constexpr int kBins = 256;
constexpr int kWarps = kSortThreads / 32;

__global__ void __launch_bounds__(kSortThreads)
sort_hist_kernel(const unsigned long long* __restrict__ keys, int n,
                 int shift, int tiles, int* __restrict__ hist) {
    __shared__ int h[kBins];
    const int t = threadIdx.x;
    h[t] = 0;
    __syncthreads();
    const long long base = (long long)blockIdx.x * kTile;
#pragma unroll 4
    for (int r = 0; r < kSortRows; ++r) {
        const long long i = base + r * kSortThreads + t;
        if (i < n) atomicAdd(&h[(int)((keys[i] >> shift) & 0xFF)], 1);
    }
    __syncthreads();
    hist[t * tiles + blockIdx.x] = h[t];
}

__global__ void __launch_bounds__(kSortThreads)
sort_scatter_kernel(const unsigned long long* __restrict__ in, int n,
                    int shift, int tiles, const int* __restrict__ offs,
                    unsigned long long* __restrict__ out) {
    __shared__ int run[kBins];            // the next slot of each digit
    __shared__ int wcount[kWarps][kBins]; // the row's keys per warp, digit
    const int t = threadIdx.x, lane = lane_id(), warp = t >> 5;
    run[t] = offs[t * tiles + blockIdx.x];
    const long long base = (long long)blockIdx.x * kTile;
    for (int r = 0; r < kSortRows; ++r) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) wcount[w][t] = 0;
        __syncthreads();
        const long long i = base + r * kSortThreads + t;
        const bool valid = i < n;
        const unsigned long long k = valid ? in[i] : 0ull;
        // a lane past n takes a digit of its own, which no key has
        const int d = valid ? (int)((k >> shift) & 0xFF) : kBins;
        const unsigned peers = __match_any_sync(kFull, d);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        if (valid && rank == 0) wcount[warp][d] = __popc(peers);
        __syncthreads();
        if (valid) {
            int slot = run[d] + rank;
            for (int w = 0; w < warp; ++w) slot += wcount[w][d];
            out[slot] = k;
        }
        __syncthreads();
        int row = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) row += wcount[w][t];
        run[t] += row;
        __syncthreads();
    }
}

__global__ void __launch_bounds__(kSortThreads)
unpack_kernel(const long long* __restrict__ keys, int n, int sh_pat,
              int sh_len, int bias, int* __restrict__ cols) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long k = keys[i], ln = n;
    const long long smask = (1ll << (sh_pat - sh_len)) - 1;
    cols[i] = (int)(k >> sh_pat);
    cols[ln + i] = (int)(((k >> sh_len) & smask) - bias);
    cols[2 * ln + i] = (int)(k & ((1ll << sh_len) - 1));
}

}  // namespace

// One pass's histogram: keys int64 [n] (non-negative), digit (keys >> shift)
// & 255.  hist: int32 [256 * tiles], tiles = ceil(n / 4096), digit-major.
CGX_EXPORT int cgx_sort_hist(const long long* keys, int n, int shift,
                             int* hist, void* stream) {
    if (n < 1 || shift < 0 || shift > 63) return (int)cudaErrorInvalidValue;
    const int tiles = (n + kTile - 1) / kTile;
    sort_hist_kernel<<<tiles, kSortThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned long long*)keys, n, shift, tiles, hist);
    return (int)cudaGetLastError();
}

// One pass's scatter: offs int32 [256 * tiles], the exclusive prefix of the
// pass's histogram.  out: int64 [n], the keys stably ordered by the digit.
CGX_EXPORT int cgx_sort_scatter(const long long* in, int n, int shift,
                                const int* offs, long long* out,
                                void* stream) {
    if (n < 1 || shift < 0 || shift > 63) return (int)cudaErrorInvalidValue;
    const int tiles = (n + kTile - 1) / kTile;
    sort_scatter_kernel<<<tiles, kSortThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned long long*)in, n, shift, tiles, offs,
        (unsigned long long*)out);
    return (int)cudaGetLastError();
}

// The keys' fields: cols int32 [3, n] = (keys >> sh_pat, ((keys >> sh_len)
// & (2^(sh_pat - sh_len) - 1)) - bias, keys & (2^sh_len - 1)).
CGX_EXPORT int cgx_unpack_rows(const long long* keys, int n, int sh_pat,
                               int sh_len, int bias, int* cols,
                               void* stream) {
    if (n < 1 || sh_len < 1 || sh_pat <= sh_len || sh_pat > 63 || bias < 0)
        return (int)cudaErrorInvalidValue;
    unpack_kernel<<<cgx_grid(n, kSortThreads), kSortThreads, 0,
                    (cudaStream_t)stream>>>(keys, n, sh_pat, sh_len, bias,
                                            cols);
    return (int)cudaGetLastError();
}
