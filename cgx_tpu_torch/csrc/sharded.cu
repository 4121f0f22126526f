// B2: the sharded index's distributed gathers and its pass-1/2 search.
//
// B2r (cgx_refine_sharded) replaces cgx_tpu/parallel/sharded.py:_refine_chunk
//   (sharded.py:261-320): the seeded interval refinement of A1 (refine.cu),
//   one thread per lane, where every bisection probe reads g_sa(M) and then
//   g_ref(sa + depth) from the rank-sharded SA and the token-sharded corpus.
// B2g (cgx_gather_sa_sharded) replaces _gather_sa_chunk (sharded.py:324-333):
//   the SA value at each global rank, one thread per row.
//
// JAX runs each gather on every shard and sums with psum: a shard whose rank
// range [rank_start, rank_start + rank_count) (or owned token range
// [own_lo, own_hi)) holds the index gives its word, every other shard 0, so
// the sum is the owner's word, or 0 when no shard owns the index.  The shards
// are uniform chunks of BR ranks and B tokens, so the kernel reads only the
// owner's word, with the owner computed as index / BR (or / B) and checked
// against its rmeta / smeta row; an index no shard owns reads 0.  The
// kernels reach the shards through a device array of S slice pointers plus
// the int32 rmeta [S, 2] = (rank_start, rank_count) and smeta [S, 3] =
// (src_off, own_lo, own_hi) tables, so the slices may lie anywhere the
// kernel can read.
//
// Bound on the H100: two dependent scattered 4-byte reads per bisection step
// (plus the owner's meta row, which stays in L1), about 2 log2(interval)
// steps per depth -- latency, as in A1.  The design keeps one lane per thread
// with no shared memory; lanes that finish early idle.
#include "common.cuh"

namespace {

struct Shards {
    const int* const* sa;    // [S] rank slices, sa_len words each
    const int* const* ref;   // [S] token slices, ref_len words each
    const int* rmeta;        // [S, 2] (rank_start, rank_count)
    const int* smeta;        // [S, 3] (src_off, own_lo, own_hi)
    int S, BR, sa_len, B, ref_len;
};

// the SA value at global rank r, or 0 when no shard owns r
__device__ __forceinline__ int g_sa(const Shards& x, int r) {
    if (r < 0) return 0;
    const int s = min(r / x.BR, x.S - 1);
    const int loc = r - x.rmeta[2 * s];
    if (loc < 0 || loc >= x.rmeta[2 * s + 1]) return 0;
    return x.sa[s][clampi(loc, x.sa_len)];
}

// the corpus token at global position p, or 0 when no shard owns p
__device__ __forceinline__ int g_ref(const Shards& x, int p) {
    if (p < 0) return 0;
    const int s = min(p / x.B, x.S - 1);
    const int* m = x.smeta + 3 * s;
    if (p < m[1] || p >= m[2]) return 0;
    return x.ref[s][clampi(p - m[0], x.ref_len)];
}

__device__ __forceinline__ int lower_bound(const Shards& x, int l, int h,
                                           int key, int depth) {
    while (h > l) {
        const int M = (l + h) >> 1;
        const int t = g_ref(x, g_sa(x, M) + depth);
        if (t >= key) h = M; else l = M + 1;
    }
    return l;
}

__global__ void refine_sharded_kernel(Shards x, const int* __restrict__ qtok,
                                      int q_len, const int* __restrict__ toks,
                                      const int* __restrict__ sls,
                                      const int* __restrict__ lo,
                                      const int* __restrict__ hi, int n,
                                      int d0, int depths,
                                      int* __restrict__ ups,
                                      int* __restrict__ downs,
                                      int* __restrict__ lo_out,
                                      int* __restrict__ hi_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int tok = toks[i], sl = sls[i];
    int l = lo[i], h = hi[i];
    for (int c = 0; c < depths; ++c) {
        const int depth = d0 + c;
        // past the query's end the key is -1 and the interval collapses
        const int qt = depth < sl ? qtok[clampi(tok + depth, q_len)] : -1;
        const int nlo = lower_bound(x, l, h, qt, depth);
        const int nhi = lower_bound(x, nlo, h, qt + 1, depth);
        ups[(long long)i * depths + c] = nlo;
        downs[(long long)i * depths + c] = nhi - 1;
        l = nlo;
        h = nhi;
    }
    lo_out[i] = l;
    hi_out[i] = h;
}

__global__ void gather_sa_sharded_kernel(Shards x,
                                         const int* __restrict__ rows, int n,
                                         int* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    out[i] = g_sa(x, rows[i]);
}

bool valid(int S, int BR, int sa_len, int B, int ref_len) {
    return S >= 1 && BR >= 1 && sa_len >= 1 && B >= 1 && ref_len >= 1;
}

}  // namespace

// B2r.  sa_ptrs / ref_ptrs: device arrays of S pointers to each shard's rank
// slice (sa_len words) and token slice (ref_len words); rmeta int32 [S, 2],
// smeta int32 [S, 3]; BR ranks and B tokens owned per shard.  Lanes: query
// token position toks, remaining length sls, interval [lo, hi).  out: ups,
// downs int32 [n, depths], lo_out, hi_out int32 [n].
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
    const Shards x{sa_ptrs, ref_ptrs, rmeta, smeta, S, BR, sa_len, B, ref_len};
    const int threads = 256;
    refine_sharded_kernel<<<cgx_grid(n, threads), threads, 0,
                            (cudaStream_t)stream>>>(
        x, qtok, q_len, toks, sls, lo, hi, n, d0, depths, ups, downs, lo_out,
        hi_out);
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
                               (cudaStream_t)stream>>>(x, rows, n, out);
    return (int)cudaGetLastError();
}
