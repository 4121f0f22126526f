// A8: two-gap rule extraction (extractConsistentPairs_TwoGap,
// ExtractPair.cu:891-1053): per sampled aXbXc occurrence the aXbXc rule, its
// two gaps' target spans and a whole-span checkBoundary.
//
// Replaces cgx_tpu/extract/device.py:_twogap_batch (device.py:743-747), a
// vmap over _extract_twogap_item (:723-740).  One thread per occurrence:
// each gap's target span takes the sentence anchor of its own first token
// (the JAX gapspan), then checkBoundary over [cs, cs + second_end] gives the
// rule's validity and target span (extract_common.cuh, shared with A6 and
// A7).  The JAX item's unused anchor at cs + sl is not computed.
// The arrays come as views (common.cuh), so the sharded index runs the same
// kernel on each shard's slices, as JAX passes `offs` to _twogap_batch.
//
// Bound on the H100: per item 6 input words, ~50 scattered 4-byte reads
// (two 16-word RLP windows, checkBoundary's 16 RLP and up to 16 lr_tar
// words, three sentence anchors) and 2 output words, with a few hundred
// integer ops; one item per thread and no inter-thread traffic.
#include "extract_common.cuh"

namespace {

// target span of the source gap [start, ender] (at most CWID wide)
__device__ __forceinline__ void gap_span(const Arrays& a, int start, int ender,
                                         int& gs, int& ge) {
    int mn = 256, mx = -1;
    for (int k = 0; k < CWID; ++k) {
        int L, R;
        bool al;
        rlp_lr(a, start + k, L, R, al);
        if (start + k <= ender && al) { mn = min(mn, L); mx = max(mx, R); }
    }
    int sentstart, stb;
    sent_anchor(a, start, sentstart, stb);
    gs = mn + stb;
    ge = mx + stb;
}

__global__ void twogap_kernel(Arrays a, const int* __restrict__ css,
                              const int* __restrict__ first_ends,
                              const int* __restrict__ second_ends,
                              const int* __restrict__ sls,
                              const int* __restrict__ els,
                              const int* __restrict__ cls, int n, int mrs,
                              int* __restrict__ out) {
    const int item = blockIdx.x * blockDim.x + threadIdx.x;
    if (item >= n) return;
    const int cs = css[item], fe = first_ends[item], se = second_ends[item];
    Rule r;
    gap_span(a, cs + sls[item], cs + fe - els[item], r.g1s, r.g1e);
    gap_span(a, cs + fe + 1, cs + se - cls[item], r.g2s, r.g2e);
    r.v = check_boundary(a, cs, cs + se, mrs, r.ts, r.te) == 1;
    pack(r, true, out, 0, n, item);
}

}  // namespace

// Views: (words, local length, global offset, global length) of refstr,
// RLP and lr_tar: the whole arrays, or one shard's slices.
// out: int32 [2, n] = (ts, packed) of the aXbXc family, both gaps packed
CGX_EXPORT int cgx_twogap(const int* ref, int ref_len, int ref_off,
                          int ref_glen, const int* rlp, int rlp_len,
                          int rlp_off, int rlp_glen, const int* lr_tar,
                          int lr_len, int lr_off, int lr_glen,
                          const int* cs, const int* first_end,
                          const int* second_end, const int* sl, const int* el,
                          const int* cl, int n, int mrs, int* out,
                          void* stream) {
    if (mrs < 1 || mrs - 1 > HMAX) return (int)cudaErrorInvalidValue;
    const Arrays a = {View{ref, ref_len, ref_off, ref_glen},
                      View{rlp, rlp_len, rlp_off, rlp_glen},
                      View{lr_tar, lr_len, lr_off, lr_glen}};
    const int threads = 128;
    twogap_kernel<<<cgx_grid(n, threads), threads, 0, (cudaStream_t)stream>>>(
        a, cs, first_end, second_end, sl, el, cl, n, mrs, out);
    return (int)cudaGetLastError();
}
