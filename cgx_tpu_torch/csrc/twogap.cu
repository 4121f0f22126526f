// A8: two-gap rule extraction (extractConsistentPairs_TwoGap,
// ExtractPair.cu:891-1053): per sampled aXbXc occurrence the aXbXc rule, its
// two gaps' target spans and a whole-span checkBoundary.
//
// Replaces cgx_tpu/extract/device.py:_twogap_batch (device.py:743-747), a
// vmap over _extract_twogap_item (:723-740).  A half-warp per occurrence,
// lane k on word k of each span, on the half-warp helpers of
// extract_common.cuh.  Reads come in three dependent rounds: the three
// 16-word RLP spans (gap 1 at cs + sl, gap 2 at cs + first_end + 1, the
// whole span at cs); each span's sentence anchor word (a gap's target span
// takes its own first token's anchor, as the JAX gapspan); consistent()'s
// lr_tar words where checkBoundary calls it.  On views (common.cuh) the
// sharded index runs the same kernel on a shard's slices (JAX `offs`).
//
// Bound on the H100: per item 6 input and 2 output words and the words the
// function needs (tools/reads.py twogap_reads: the whole span and its
// anchor, the gaps' only where the rule is valid, consistent()'s where it
// is called).  The one-thread body it replaces walked its spans one read
// at a time, 119 blocks on 132 SMs at medium; here 16 lanes share an item
// in three rounds.  A tail half repeats the last item and writes nothing;
// a warp wholly past the end returns at once.
#include "extract_common.cuh"

namespace {

constexpr int kThreads = 128;   // 8 items a block
constexpr int kBlocks = 12;     // blocks an SM under __launch_bounds__

__global__ void __launch_bounds__(kThreads, kBlocks)
twogap_kernel(Arrays a, const int* __restrict__ css,
              const int* __restrict__ first_ends,
              const int* __restrict__ second_ends,
              const int* __restrict__ sls, const int* __restrict__ els,
              const int* __restrict__ cls, int n, int mrs,
              int* __restrict__ out) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if ((t >> 5) * 2 >= n) return;
    const int item = t >> 4;
    const bool valid = item < n;
    const int j = valid ? item : n - 1;
    const int k = lane_id() & 15;
    const int cs = css[j], fe = first_ends[j], se = second_ends[j];
    const int g1 = cs + sls[j], g2 = cs + fe + 1, ender = cs + se;

    // round 1: word k of each gap's span and of the whole span
    const unsigned t1 = (unsigned)a.rlp.atg(g1 + k);
    const unsigned t2 = (unsigned)a.rlp.atg(g2 + k);
    const unsigned tb = (unsigned)a.rlp.atg(cs + k);
    // round 2: their sentence anchors
    const int temp1 = sent_tempind(g1, t1), temp2 = sent_tempind(g2, t2);
    const int tempb = sent_tempind(cs, tb);
    const int stb1 = sent_stb(a.rlp, temp1), stb2 = sent_stb(a.rlp, temp2);
    const int stbb = sent_stb(a.rlp, tempb);
    const HalfSpan s1 = span_scan(g1, cs + fe - els[j], t1);
    const HalfSpan s2 = span_scan(g2, cs + se - cls[j], t2);
    const Boundary b = boundary(span_scan(cs, ender, tb), cs, ender, tempb,
                                stbb, mrs);
    // round 3: consistent()'s words
    const int code = boundary_code(b, consistent_word(a.lr_tar, b), cs,
                                   ender);
    if (!valid || k != 0) return;
    const Rule r = {code == 1, b.ts, b.te, s1.mn + stb1, s1.mx + stb1,
                    s2.mn + stb2, s2.mx + stb2};
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
    twogap_kernel<<<cgx_grid(16 * n, kThreads), kThreads, 0,
                    (cudaStream_t)stream>>>(a, cs, first_end, second_end, sl,
                                            el, cl, n, mrs, out);
    return (int)cudaGetLastError();
}
