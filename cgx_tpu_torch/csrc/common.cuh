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

static inline unsigned cgx_grid(int n, int threads) {
    return (unsigned)((n + threads - 1) / threads);
}

CGX_EXPORT const char* cgx_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
