// K1 and K2: matrix-free ELL forward-Euler settle sweeps for Hopper (sm_90a).
//
// Replace the TPU kernels of src/repro/kernels/ell_transient.py:
//   K1  ell_sweep_pallas  (_ell_sweep_kernel, _ell_residual)
//   K2  ell_step_pallas   (_ell_step_kernel)
//
// Both compute, per system b and row i,
//     dz[i] = sum_k w[k, i] * z[idx[k, i]] + c[i]          z' = z + dt * dz
// with dt already folded into w and c by the caller (dt = 1 in the sweep;
// dt = 0 evaluates the residual without moving the state).  The operator
// is passed SLOT-MAJOR, (B, K, nz): thread i reads slot k of its row at
// k * nz + i, so a warp's 32 rows are 32 consecutive words -- every slot
// load is coalesced.  (The reference's row-major (B, nz, K) would make a
// warp's loads K words apart.)  The wrapper lays the slots out once per
// settle, outside the chunk loop.
//
// What bounds them on an H100: bytes.  A step moves nz*K*(4 + 4|2) bytes
// of operator plus 3*nz*4 bytes of state and does 2*nz*K flops, about
// 0.25 flop per byte -- far below the card's ~20 flop/byte f32 balance.
//
// K1 (ell_sweep_kernel): one thread block per system, looping over the
//   n_steps inside the block, as the Pallas grid runs one program per
//   system with a fori_loop inside.  The state lives in shared memory,
//   double-buffered (each step reads the whole previous state through
//   the gather, so an in-place update would race), with one
//   __syncthreads() per step.  The operator streams from L2/HBM every
//   step; it is read-only, so B systems' operators that fit the 50 MB L2
//   stay there across steps.  What fits is the state: 2 * nz * 4 bytes
//   of the 227 KB a block may use (nz <= 28,928).  Only B of the 132 SMs
//   are busy, and one SM's load rate bounds each system.
// K2 (ell_step_kernel): one step, row-tiled.  Grid (nz / 128, B), one
//   thread per row, the gather reading the previous state from global
//   memory (L1/L2-resident) and writing a separate output buffer (the
//   wrapper ping-pongs), so blocks run in any order without racing.  Each
//   block writes the max |dz| of its 128 rows; the wrapper takes the max
//   over blocks.  No atomics.
//
// Precision contract (ell_transient.py:66-67).  float32 weights: product
// and slot sum in f32, the product rounded before the add (no FMA), as
// the reference forms `w * gathered` and then sums.  bfloat16 weights:
// the gathered state is rounded to bf16, the bf16 x bf16 product is
// rounded once to bf16 (round-to-nearest-even), and only then added into
// the f32 slot sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

__device__ __forceinline__ float slot_product(float w, float z) { return __fmul_rn(w, z); }

__device__ __forceinline__ float slot_product(__nv_bfloat16 w, float z) {
  return __bfloat162float(__hmul(w, __float2bfloat16_rn(z)));
}

// sum_k w[k, i] * z[idx[k, i]] in slot order, f32 accumulator
template <typename W>
__device__ __forceinline__ float ell_row(const int32_t* __restrict__ idx,
                                         const W* __restrict__ w, const float* z,
                                         int nz, int k_slots, int i) {
  float acc = 0.0f;
  for (int k = 0; k < k_slots; ++k) {
    const size_t at = static_cast<size_t>(k) * nz + i;
    acc = __fadd_rn(acc, slot_product(w[at], z[__ldg(idx + at)]));
  }
  return acc;
}

template <typename W>
__global__ void __launch_bounds__(1024)
ell_sweep_kernel(const int32_t* __restrict__ idx, const W* __restrict__ w,
                 const float* __restrict__ z0, const float* __restrict__ c,
                 float* __restrict__ z_out, float* __restrict__ res,
                 int nz, int k_slots, int n_steps, float dt) {
  extern __shared__ float state[];          // [2][nz]
  __shared__ float scratch[32];
  const size_t b = blockIdx.x;
  idx += b * k_slots * nz;
  w += b * k_slots * nz;
  z0 += b * nz;
  c += b * nz;
  z_out += b * nz;

  float* cur = state;
  float* nxt = state + nz;
  for (int i = threadIdx.x; i < nz; i += blockDim.x) cur[i] = z0[i];
  __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    for (int i = threadIdx.x; i < nz; i += blockDim.x) {
      const float dz = __fadd_rn(ell_row(idx, w, cur, nz, k_slots, i), __ldg(c + i));
      nxt[i] = __fadd_rn(cur[i], __fmul_rn(dt, dz));
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  // fused settling check at the final state: max_i |M z + c|
  float m = 0.0f;
  for (int i = threadIdx.x; i < nz; i += blockDim.x) {
    const float dz = __fadd_rn(ell_row(idx, w, cur, nz, k_slots, i), __ldg(c + i));
    m = nan_max(m, fabsf(dz));
    z_out[i] = cur[i];
  }
  m = block_max(m, scratch);
  if (threadIdx.x == 0) res[b] = m;
}

template <typename W>
__global__ void __launch_bounds__(ROW_BLOCK)
ell_step_kernel(const int32_t* __restrict__ idx, const W* __restrict__ w,
                const float* __restrict__ z, const float* __restrict__ c,
                float* __restrict__ z_out, float* __restrict__ res,
                int nz, int k_slots, float dt) {
  __shared__ float scratch[32];
  const size_t b = blockIdx.y;
  const int i = blockIdx.x * ROW_BLOCK + threadIdx.x;
  idx += b * k_slots * nz;
  w += b * k_slots * nz;
  z += b * nz;
  c += b * nz;
  z_out += b * nz;

  const float dz = __fadd_rn(ell_row(idx, w, z, nz, k_slots, i), __ldg(c + i));
  z_out[i] = __fadd_rn(z[i], __fmul_rn(dt, dz));
  const float m = block_max(fabsf(dz), scratch);
  if (threadIdx.x == 0) res[b * gridDim.x + blockIdx.x] = m;
}

template <typename W>
int launch_sweep(const void* idx, const void* w, const void* z, const void* c,
                 void* z_out, void* res, int batch, int nz, int k_slots,
                 int n_steps, float dt, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(nz) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ell_sweep_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = nz < 1024 ? nz : 1024;
  ell_sweep_kernel<W><<<batch, threads, smem, stream>>>(
      static_cast<const int32_t*>(idx), static_cast<const W*>(w),
      static_cast<const float*>(z), static_cast<const float*>(c),
      static_cast<float*>(z_out), static_cast<float*>(res), nz, k_slots,
      n_steps, dt);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int launch_step(const void* idx, const void* w, const void* z, const void* c,
                void* z_out, void* res, int batch, int nz, int k_slots, float dt,
                cudaStream_t stream) {
  const dim3 grid(nz / ROW_BLOCK, batch);
  ell_step_kernel<W><<<grid, ROW_BLOCK, 0, stream>>>(
      static_cast<const int32_t*>(idx), static_cast<const W*>(w),
      static_cast<const float*>(z), static_cast<const float*>(c),
      static_cast<float*>(z_out), static_cast<float*>(res), nz, k_slots, dt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// C interface (bound with ctypes).  Pointers are device pointers of
// contiguous tensors; nz is a multiple of 128.  Each returns the CUDA
// error code of its launch (0 = success).
extern "C" int repro_ell_sweep(const void* idx, const void* w, int w_is_bf16,
                               const void* z, const void* c, void* z_out, void* res,
                               int batch, int nz, int k_slots, int n_steps, float dt,
                               void* stream) {
  using namespace repro_torch;
  auto s = static_cast<cudaStream_t>(stream);
  return w_is_bf16 ? launch_sweep<__nv_bfloat16>(idx, w, z, c, z_out, res, batch, nz,
                                                 k_slots, n_steps, dt, s)
                   : launch_sweep<float>(idx, w, z, c, z_out, res, batch, nz, k_slots,
                                         n_steps, dt, s);
}

extern "C" int repro_ell_step(const void* idx, const void* w, int w_is_bf16,
                              const void* z, const void* c, void* z_out, void* res,
                              int batch, int nz, int k_slots, float dt, void* stream) {
  using namespace repro_torch;
  auto s = static_cast<cudaStream_t>(stream);
  return w_is_bf16 ? launch_step<__nv_bfloat16>(idx, w, z, c, z_out, res, batch, nz,
                                                k_slots, dt, s)
                   : launch_step<float>(idx, w, z, c, z_out, res, batch, nz, k_slots,
                                        dt, s);
}
