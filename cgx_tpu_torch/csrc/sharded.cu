// B2: the sharded index's distributed gathers and its pass-1/2 search.
//
// B2r (cgx_refine_sharded) replaces cgx_tpu/parallel/sharded.py:_refine_chunk
//   (sharded.py:261-320): the seeded interval refinement of A1 on A1's warp
//   body (refine.cuh: a warp per lane, 16-ary searches on its two
//   half-warps), each pivot's key read as g_ref(g_sa(M) + depth) from the
//   rank-sharded SA and the token-sharded corpus (`ShardKey`).
// B2g (cgx_gather_sa_sharded) replaces _gather_sa_chunk (sharded.py:324-333):
//   the SA value at each global rank, one thread per row, with B2r's owner
//   division.
//
// JAX runs each gather on every shard and sums with psum: a shard whose rank
// range [rank_start, rank_start + rank_count) (or owned token range
// [own_lo, own_hi)) holds the index gives its word, every other shard 0, so
// the sum is the owner's word, or 0 when no shard owns the index.  The shards
// are uniform chunks of BR ranks and B tokens, so the kernels read only the
// owner's word, with the owner computed as min(index / BR, S - 1) (or / B)
// and checked against its rmeta / smeta row; an index no shard owns reads 0.
// The kernels reach the shards through a device array of S slice pointers
// plus the int32 rmeta [S, 2] = (rank_start, rank_count) and smeta [S, 3] =
// (src_off, own_lo, own_hi) tables, so the slices may lie anywhere the
// kernel can read.
//
// Bound on the H100: B2r is A1's chain of dependent scattered reads (about
// log16(interval) rounds a depth), but each pivot read through the shards
// also needs its owner: a division, then the owner's slice pointer and meta
// row.  Read from device memory those are two more dependent loads before
// each of the two words (up to six a pivot).  So each block first copies
// the S rows (both slice pointers, rmeta's 2 words and smeta's 3: 36 bytes
// a shard) into dynamic shared memory, its lanes' own loads issued before
// the copy so that both rounds overlap; after one barrier a pivot costs
// A1's two dependent global loads, the SA word and then the token, each
// after a shared-memory round and the owner's division, done by a multiply
// and a shift (`DivMagic`).  The rows of over a thousand shards would not
// fit in 48 KiB: the entry point refuses them, and so does the wrapper
// (parallel/sharded.py B2R_SHARD_ROW_BYTES).  The search is exact through
// the shards because every row and position it reads lies inside the SA
// and the corpus, so exactly one shard owns it (refine.cuh).
#include "refine.cuh"

namespace {

struct Shards {
    const int* const* sa;    // [S] rank slices, sa_len words each
    const int* const* ref;   // [S] token slices, ref_len words each
    const int* rmeta;        // [S, 2] (rank_start, rank_count)
    const int* smeta;        // [S, 3] (src_off, own_lo, own_hi)
    int S, BR, sa_len, B, ref_len;
};

// The owner of an index is min(index / width, S - 1), the division done by
// a multiply and a shift (Granlund and Montgomery: m = floor(2^32 (2^l - d)
// / d) + 1 with l = ceil(log2 d), then (umulhi(m, x) + x) >> l, exact for
// 0 <= x < 2^31 and 1 <= d < 2^31, where t + x < 2^32), which spares the
// ~20 instructions of the emulated division on each read's dependent chain.
struct DivMagic {
    unsigned m;
    int l;

    __device__ __forceinline__ int operator()(int x) const {
        const unsigned t = __umulhi((unsigned)x, m);
        return (int)((t + (unsigned)x) >> l);
    }
};

static DivMagic div_magic(int d) {
    int l = 0;
    while ((1LL << l) < d) ++l;
    const unsigned long long m =
        ((1ULL << 32) * ((1ULL << l) - (unsigned long long)d)) / d + 1;
    return DivMagic{(unsigned)m, l};
}

// the SA value at global rank r, or 0 when no shard owns r (div: / BR)
__device__ __forceinline__ int g_sa(const Shards& x, DivMagic div, int r) {
    if (r < 0) return 0;
    const int s = min(div(r), x.S - 1);
    const int loc = r - x.rmeta[2 * s];
    if (loc < 0 || loc >= x.rmeta[2 * s + 1]) return 0;
    return x.sa[s][clampi(loc, x.sa_len)];
}

// the corpus token at global position p, or 0 when no shard owns p (div:
// / B)
__device__ __forceinline__ int g_ref(const Shards& x, DivMagic div, int p) {
    if (p < 0) return 0;
    const int s = min(div(p), x.S - 1);
    const int* m = x.smeta + 3 * s;
    if (p < m[1] || p >= m[2]) return 0;
    return x.ref[s][clampi(p - m[0], x.ref_len)];
}

// B2r's key reader: the token at position g_sa(M) + depth through the
// shards (the replicated key wherever one shard owns both reads)
struct ShardKey {
    Shards x;
    DivMagic by_br, by_b;

    __device__ __forceinline__ int operator()(int M, int depth) const {
        return g_ref(x, by_b, g_sa(x, by_br, M) + depth);
    }
};

// one shard's row in shared memory: two slice pointers, rmeta's 2 words and
// smeta's 3 (parallel/sharded.py B2R_SHARD_ROW_BYTES)
constexpr int kShardRowBytes = 36;
static_assert((size_t)kShardRowBytes == 2 * sizeof(void*) + 5 * sizeof(int),
              "a shard row: two pointers and five int32 words");
constexpr int kShardRowsLimit = 49152;   // 48 KiB, without an opt-in

__global__ void __launch_bounds__(kRefineThreads)
refine_sharded_kernel(Shards x, const int* __restrict__ qtok, int q_len,
                      const int* __restrict__ toks,
                      const int* __restrict__ sls, const int* __restrict__ lo,
                      const int* __restrict__ hi, int n, int d0, int depths,
                      int* __restrict__ ups, int* __restrict__ downs,
                      int* __restrict__ lo_out, int* __restrict__ hi_out,
                      DivMagic by_br, DivMagic by_b) {
    // the lane's scalars first, so that their loads overlap the rows' copy
    const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const bool live = i < n;
    RefineLane ln{0, 0, 0, 0, -1};
    if (live) ln = refine_lane(qtok, q_len, toks, sls, lo, hi, i, d0, depths);
    // the S shard rows into shared memory: [S] sa pointers, [S] ref
    // pointers, then rmeta [S, 2] and smeta [S, 3]
    extern __shared__ long long shard_rows[];
    const int** sa_s = reinterpret_cast<const int**>(shard_rows);
    const int** ref_s = sa_s + x.S;
    int* meta = reinterpret_cast<int*>(ref_s + x.S);
    for (int t = threadIdx.x; t < x.S; t += blockDim.x) {
        sa_s[t] = x.sa[t];
        ref_s[t] = x.ref[t];
    }
    for (int t = threadIdx.x; t < 2 * x.S; t += blockDim.x)
        meta[t] = x.rmeta[t];
    for (int t = threadIdx.x; t < 3 * x.S; t += blockDim.x)
        meta[2 * x.S + t] = x.smeta[t];
    __syncthreads();
    if (!live) return;                    // the whole warp
    const Shards local{sa_s, ref_s, meta, meta + 2 * x.S, x.S, x.BR,
                       x.sa_len, x.B, x.ref_len};
    refine_warp(ShardKey{local, by_br, by_b}, ln, qtok, q_len, i, d0, depths,
                ups, downs, lo_out, hi_out);
}

__global__ void gather_sa_sharded_kernel(Shards x,
                                         const int* __restrict__ rows, int n,
                                         int* __restrict__ out,
                                         DivMagic by_br) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    out[i] = g_sa(x, by_br, rows[i]);
}

bool valid(int S, int BR, int sa_len, int B, int ref_len) {
    return S >= 1 && BR >= 1 && sa_len >= 1 && B >= 1 && ref_len >= 1;
}

}  // namespace

// B2r.  sa_ptrs / ref_ptrs: device arrays of S pointers to each shard's rank
// slice (sa_len words) and token slice (ref_len words); rmeta int32 [S, 2],
// smeta int32 [S, 3]; BR ranks and B tokens owned per shard; the S rows
// (36 bytes each) must fit in 48 KiB.  Lanes: query token position toks,
// remaining length sls, interval [lo, hi).  out: ups, downs int32 [n,
// depths], lo_out, hi_out int32 [n].
CGX_EXPORT int cgx_refine_sharded(const int* const* sa_ptrs,
                                  const int* const* ref_ptrs,
                                  const int* rmeta, const int* smeta, int S,
                                  int BR, int sa_len, int B, int ref_len,
                                  const int* qtok, int q_len, const int* toks,
                                  const int* sls, const int* lo,
                                  const int* hi, int n, int d0, int depths,
                                  int* ups, int* downs, int* lo_out,
                                  int* hi_out, void* stream) {
    if (!valid(S, BR, sa_len, B, ref_len) || q_len < 1)
        return (int)cudaErrorInvalidValue;
    if ((long long)S * kShardRowBytes > kShardRowsLimit)
        return (int)cudaErrorInvalidValue;
    const Shards x{sa_ptrs, ref_ptrs, rmeta, smeta, S, BR, sa_len, B, ref_len};
    refine_sharded_kernel<<<cgx_grid(n, kRefineThreads / 32), kRefineThreads,
                            S * kShardRowBytes, (cudaStream_t)stream>>>(
        x, qtok, q_len, toks, sls, lo, hi, n, d0, depths, ups, downs, lo_out,
        hi_out, div_magic(BR), div_magic(B));
    return (int)cudaGetLastError();
}

// B2g.  out: int32 [n], the SA value at each global rank rows[i] (0 where no
// shard owns it).
CGX_EXPORT int cgx_gather_sa_sharded(const int* const* sa_ptrs,
                                     const int* rmeta, int S, int BR,
                                     int sa_len, const int* rows, int n,
                                     int* out, void* stream) {
    if (!valid(S, BR, sa_len, 1, 1)) return (int)cudaErrorInvalidValue;
    const Shards x{sa_ptrs, nullptr, rmeta, nullptr, S, BR, sa_len, 1, 1};
    const int threads = 256;
    gather_sa_sharded_kernel<<<cgx_grid(n, threads), threads, 0,
                               (cudaStream_t)stream>>>(x, rows, n, out,
                                                       div_magic(BR));
    return (int)cudaGetLastError();
}
