// Device helpers shared by the settle-sweep kernels (K1-K4).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace repro_torch {

// Row-block height of the row-tiled kernels (K2, K4): one thread block
// covers ROW_BLOCK rows and writes one max partial, the (B, nz / 128)
// layout of the reference's per-block residual output.
constexpr int ROW_BLOCK = 128;

// max that propagates NaN like jnp.max / torch.amax (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Max over the block of non-negative values; the result is valid in
// thread 0.  blockDim.x must be a multiple of 32; `scratch` holds 32
// floats.  Every thread of the block must call it.
__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    v = lane < n_warps ? scratch[lane] : 0.0f;
    v = warp_max(v);
  }
  return v;
}

}  // namespace repro_torch
