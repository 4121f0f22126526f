// B2: the sharded index's distributed gathers and its pass-1/2 search.
//
// B2r (cgx_refine_sharded) replaces cgx_tpu/parallel/sharded.py:_refine_chunk
//   (sharded.py:261-320): the seeded interval refinement of A1 on A1's warp
//   body (refine.cuh: a warp per lane, 16-ary searches on its two
//   half-warps), each pivot's key read as g_ref(g_sa(M) + depth) from the
//   rank-sharded SA and the token-sharded corpus (`ShardKey`).
// B2g (cgx_gather_sa_sharded) replaces _gather_sa_chunk (sharded.py:324-333):
//   the SA value at each global rank, one thread per row, with B2r's owner
//   division.  On an index placed on a device list it is launched once per
//   owning shard, on that shard's device over a one-shard table.
// B2s (cgx_refine_step) and B2t (cgx_token_partial) are B2r's round form
//   for an index placed on a device list: JAX's _refine_chunk as it runs
//   there, every shard's device stepping the same lockstep bisection over
//   its own copy of the lanes, with only the SA words and tokens each step
//   reads summed across the shards; a step reads five bisection levels
//   ahead (a tree step), or every depth of a dispatch of single-row
//   intervals at once (see below).
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

// ---- B2s and B2t: the round form ------------------------------------------
//
// A dispatch of `depths` levels from depth d0 runs 2 * depths lower bounds:
// bound b (0 <= b < 2 depths) searches depth d0 + b / 2 for the key qt +
// (b & 1), qt the query token there or -1 past the lane's suffix; the first
// bound of a level gives its new lo (ups), the second, started from the
// first's result, its new hi.  JAX's lb steps a bound one bisection level at
// a time, each level one read of the SA word at the midpoint and one of the
// token there, both summed over the shards.  The round form cuts the number
// of those summed steps (each a launch per shard, a sum on the home device
// and, across processes, a gloo round trip) two ways, both exact for any
// key column, sorted or not (the lanes off both ends of the SA read keys
// that are not):
//  * the tree step: the next kTreeLevels levels of a lane's bisection tree
//    have kTreeNodes nodes, and which of them lb visits depends only on the
//    keys read, so one step reads the keys of all of them (speculation) and
//    applies the kTreeLevels levels exactly as lb would.  Node 0 is the
//    lane's [l, h); node j's children are 2j + 1, [l, M) (key >= the
//    bound's), and 2j + 2, [M + 1, h), M = (l + h) >> 1.  A node whose
//    interval is empty reads nothing (lb's h > l stop), and the children of
//    an empty node are empty.  A dispatch takes R = ceil(K / kTreeLevels)
//    steps a bound (K: the bisection steps of its widest interval), T = 2
//    depths R in all (parallel/sharded.py round_plan);
//  * the single-row plan: where no interval of the dispatch is wider than a
//    row, every level reads the same row l, so step 0 reads SA[l], B2t the
//    tokens at SA[l] + d0 + c for every c < depths, and step 1 resolves the
//    levels in order (T = 1).
// Step g (0 <= g <= T) is one launch of B2s on each shard's device followed,
// for g < T, by one of B2t:
//  * B2s (a warp per lane on a tree step, a thread per lane on the
//    single-row plan) applies step g - 1's summed tokens, closes bound (g -
//    1) / R when g is a multiple of R (its l is ups[c], or downs[c] + 1 and
//    the level's new hi), opens bound g / R there, and writes the shard's
//    part of the SA word at each node's midpoint: sa[M] where the shard owns
//    rank M and the node is live, else 0;
//  * the home device sums the shards' parts; B2t (a thread per node and
//    token) writes each shard's part of the token at each live node's SA
//    word + depth (+ c), which the home device sums for the next B2s.
// Every part is the owner's word or 0, as JAX's psum takes it, so the int32
// sums are the words JAX reads; the lanes' state (lo, hi, l, h: int32 [4,
// n]) and ups, downs are the same on every shard's copy after every step.
// The plan is fixed per dispatch, so the host never waits on the card
// between steps.

// the levels a tree step reads ahead and their nodes (parallel/sharded.py
// TREE_LEVELS, TREE_NODES); a warp holds a lane's nodes, one a thread
constexpr int kTreeLevels = 5;
constexpr int kTreeNodes = 31;
static_assert(kTreeNodes == (1 << kTreeLevels) - 1 && kTreeNodes < 32,
              "a tree step's nodes fill a warp but one thread");
constexpr int kTreeLanes = 4;            // lanes (warps) a block
constexpr int kRowThreads = 256;

__device__ __forceinline__ int round_key(const int* qtok, int q_len, int tok,
                                         int sl, int depth, int plus) {
    return (depth < sl ? qtok[clampi(tok + depth, q_len)] : -1) + plus;
}

// node j's interval of the bisection tree over [l, h): the path from the
// root is the bits of j + 1 below its leading one, 0 the left child
__device__ __forceinline__ void tree_node(int j, int& l, int& h) {
    const int path = j + 1;
    for (int k = 30 - __clz(path); k >= 0; --k) {
        const int M = (l + h) >> 1;
        if ((path >> k) & 1)
            l = M + 1;
        else
            h = M;
    }
}

// the shard's part of the SA word at the midpoint of [l, h): sa[M] where
// the interval is live and the shard owns rank M, else 0
__device__ __forceinline__ int sa_part(const int* sa, int sa_len, int rstart,
                                       int rcount, int l, int h) {
    if (h <= l) return 0;
    const int loc = ((l + h) >> 1) - rstart;
    return loc >= 0 && loc < rcount ? sa[clampi(loc, sa_len)] : 0;
}

__global__ void __launch_bounds__(32 * kTreeLanes)
round_tree_kernel(const int* __restrict__ sa, int sa_len, int rstart,
                  int rcount, const int* __restrict__ qtok, int q_len,
                  const int* __restrict__ toks, const int* __restrict__ sls,
                  int* __restrict__ st, int* __restrict__ ups,
                  int* __restrict__ downs, const int* __restrict__ tok, int n,
                  int g, int R, int d0, int depths, int* __restrict__ out) {
    const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int j = threadIdx.x & 31;
    if (i >= n) return;                   // the whole warp
    int lo = st[i], hi = st[n + i], l = st[2 * n + i], h = st[3 * n + i];
    int* up = ups + (size_t)i * depths;
    int* down = downs + (size_t)i * depths;
    if (g > 0) {
        const int b = (g - 1) / R;
        if (h > l) {                      // the warp's lane is live
            const int key = round_key(qtok, q_len, toks[i], sls[i],
                                      d0 + (b >> 1), b & 1);
            // bit j: node j's summed token >= the key
            const unsigned ge = __ballot_sync(
                0xffffffffu,
                j < kTreeNodes && tok[(size_t)i * kTreeNodes + j] >= key);
            int node = 0;
            for (int lev = 0; lev < kTreeLevels && h > l; ++lev) {
                const int M = (l + h) >> 1;
                if ((ge >> node) & 1) {
                    h = M;
                    node = 2 * node + 1;
                } else {
                    l = M + 1;
                    node = 2 * node + 2;
                }
            }
        }
        if (g % R == 0) {                 // bound b closes
            if ((b & 1) == 0) {
                if (j == 0) up[b >> 1] = l;
            } else {
                if (j == 0) down[b >> 1] = l - 1;
                lo = up[b >> 1];          // written by an earlier launch
                hi = l;
            }
        }
    }
    if (g < 2 * depths * R) {
        // bound g / R opens: the first of a level at its lo, the second at
        // the first's result, the l this launch just closed it with
        if (g % R == 0) {
            if (((g / R) & 1) == 0) l = lo;
            h = hi;
        }
        if (j < kTreeNodes) {
            int nl = l, nh = h;
            tree_node(j, nl, nh);
            out[(size_t)i * kTreeNodes + j] =
                sa_part(sa, sa_len, rstart, rcount, nl, nh);
        }
    }
    if (j == 0) {
        st[i] = lo;
        st[n + i] = hi;
        st[2 * n + i] = l;
        st[3 * n + i] = h;
    }
}

// a lower bound over [l, h), at most one row wide, whose row's key is t
__device__ __forceinline__ int row_bound(int l, int h, int t, int key) {
    return h > l && t < key ? ((l + h) >> 1) + 1 : l;
}

__global__ void round_row_kernel(const int* __restrict__ sa, int sa_len,
                                 int rstart, int rcount,
                                 const int* __restrict__ qtok, int q_len,
                                 const int* __restrict__ toks,
                                 const int* __restrict__ sls,
                                 int* __restrict__ st, int* __restrict__ ups,
                                 int* __restrict__ downs,
                                 const int* __restrict__ tok, int n, int g,
                                 int d0, int depths, int* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int lo = st[i], hi = st[n + i];
    if (g == 0) {                         // the row's SA word
        st[2 * n + i] = lo;
        st[3 * n + i] = hi;
        out[i] = sa_part(sa, sa_len, rstart, rcount, lo, hi);
        return;
    }
    const int* t = tok + (size_t)i * depths;
    int* up = ups + (size_t)i * depths;
    int* down = downs + (size_t)i * depths;
    const int tk = toks[i], sl = sls[i];
    for (int c = 0; c < depths; ++c) {    // the levels in order, as lb
        const int key = round_key(qtok, q_len, tk, sl, d0 + c, 0);
        const int nlo = row_bound(lo, hi, t[c], key);
        const int nhi = row_bound(nlo, hi, t[c], key + 1);
        up[c] = nlo;
        down[c] = nhi - 1;
        lo = nlo;
        hi = nhi;
    }
    st[i] = lo;
    st[n + i] = hi;
}

__global__ void round_tokens_kernel(const int* __restrict__ ref, int ref_len,
                                    int soff, int olo, int ohi,
                                    const int* __restrict__ st,
                                    const int* __restrict__ sa_sum, int n,
                                    int nodes, int count, int depth,
                                    int* __restrict__ out) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int per = nodes * count;
    if (e >= (long long)n * per) return;
    const int i = (int)(e / per);
    const int r = (int)(e - (long long)i * per);
    const int j = r / count;
    int l = st[2 * n + i], h = st[3 * n + i];
    tree_node(j, l, h);
    int v = 0;
    if (h > l) {
        const int p = sa_sum[(size_t)i * nodes + j] + depth + (r - j * count);
        if (p >= olo && p < ohi) v = ref[clampi(p - soff, ref_len)];
    }
    out[e] = v;
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

// B2s.  One shard's rank slice sa (sa_len words, its global ranks [rstart,
// rstart + rcount)); the lanes' query token positions toks and remaining
// lengths sls; their state st int32 [4, n] (lo, hi, l, h: lo and hi given,
// l and h set at step 0) and ups, downs int32 [n, depths], updated in
// place; R: tree steps a lower bound (T = 2 depths R), or 0 for the
// single-row plan (T = 1); tok: the summed tokens of step g - 1, int32 [n,
// kTreeNodes] (R >= 1) or [n, depths] (unread at g = 0); out: the shard's
// parts of the SA words at the nodes' midpoints, int32 [n, kTreeNodes] or
// [n, 1] (unwritten at the last step, g = T).
CGX_EXPORT int cgx_refine_step(const int* sa, int sa_len, int rstart,
                               int rcount, const int* qtok, int q_len,
                               const int* toks, const int* sls, int* st,
                               int* ups, int* downs, const int* tok, int n,
                               int g, int R, int d0, int depths, int* out,
                               void* stream) {
    const long long T = R > 0 ? 2LL * depths * R : 1;
    if (sa_len < 1 || q_len < 1 || R < 0 || depths < 1 || g < 0 || g > T ||
        T >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    if (R > 0)
        round_tree_kernel<<<cgx_grid(n, kTreeLanes), 32 * kTreeLanes, 0,
                            (cudaStream_t)stream>>>(
            sa, sa_len, rstart, rcount, qtok, q_len, toks, sls, st, ups,
            downs, tok, n, g, R, d0, depths, out);
    else
        round_row_kernel<<<cgx_grid(n, kRowThreads), kRowThreads, 0,
                           (cudaStream_t)stream>>>(
            sa, sa_len, rstart, rcount, qtok, q_len, toks, sls, st, ups,
            downs, tok, n, g, d0, depths, out);
    return (int)cudaGetLastError();
}

// B2t.  One shard's token slice ref (ref_len words from global position
// soff; it owns [olo, ohi)); the lanes' state st as B2s left it; sa_sum
// the summed SA words of this step at the first `nodes` nodes of each
// lane's tree (1 or kTreeNodes); out int32 [n, nodes * count]: the shard's
// part of the token at sa_sum[i, j] + depth + c (c < count) of each live
// node j, else 0.
CGX_EXPORT int cgx_token_partial(const int* ref, int ref_len, int soff,
                                 int olo, int ohi, const int* st,
                                 const int* sa_sum, int n, int nodes,
                                 int count, int depth, int* out,
                                 void* stream) {
    if (ref_len < 1 || (nodes != 1 && nodes != kTreeNodes) || count < 1 ||
        (long long)n * nodes * count >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const int threads = 256;
    round_tokens_kernel<<<cgx_grid(n * nodes * count, threads), threads, 0,
                          (cudaStream_t)stream>>>(
        ref, ref_len, soff, olo, ohi, st, sa_sum, n, nodes, count, depth,
        out);
    return (int)cudaGetLastError();
}
