// Shared helpers of the port's kernels.  Each csrc/<name>.cu is compiled
// alone into its own shared library with a plain C interface (see
// cgx_tpu_torch/kernels/build.py), so the definitions below exist once per
// library.
#pragma once

#include <cuda_runtime.h>

#define CGX_EXPORT extern "C" __attribute__((visibility("default")))

// JAX gathers clamp an out-of-range index into [0, n - 1]; every read of the
// port's padded index arrays clamps the same way, so a read past the logical
// end returns the same padding word on both sides.
__device__ __forceinline__ int clampi(int i, int n) {
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ int clip(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// the lanes of the caller's half-warp (blocks are whole warps, 1-D)
__device__ __forceinline__ unsigned half_mask() {
    return 0xFFFFu << (lane_id() & 16);
}

// A local slice of a global array, addressed by global indices: the CUDA form
// of cgx_tpu/utils/views.py:OffsetView.  `arr[0]` is global element `off`;
// the slice holds `len` words of a `glen`-word array.  `at(i)` clamps
// `i - off` into the slice, as the JAX view does for a read the kernel body
// leaves unbounded; `atg(i)` first clamps `i` into the global array, as the
// body's explicit `jnp.clip(i, 0, arr.shape[0] - 1)` does (shape[0] is the
// global length under a view), and then into the slice.  With off 0 and
// glen == len (the replicated index) both reduce to arr[clampi(i, len)].
struct View {
    const int* arr;
    int len, off, glen;

    __device__ __forceinline__ int at(int i) const {
        return arr[clampi(i - off, len)];
    }
    // at(clampi(i, glen)) as one clamp: clamping into [0, glen - 1] and
    // then, less off, into [0, len - 1] is clamping i - off into
    // [clampi(-off, len), clampi(glen - 1 - off, len)] (both lengths >= 1)
    __device__ __forceinline__ int atg(int i) const {
        return arr[min(max(i - off, clampi(-off, len)),
                       clampi(glen - 1 - off, len))];
    }
};

static inline View identity_view(const int* arr, int len) {
    return View{arr, len, 0, len};
}

static inline unsigned cgx_grid(int n, int threads) {
    return (unsigned)((n + threads - 1) / threads);
}

CGX_EXPORT const char* cgx_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
