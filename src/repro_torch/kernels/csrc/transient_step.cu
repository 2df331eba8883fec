// K3, K4 and K5: dense forward-Euler steps for Hopper (sm_90a).
//
// Replace the TPU kernels of src/repro/kernels/transient_step.py:
//   K3  transient_sweep_pallas         (_sweep_kernel)
//   K4  transient_step_batched_pallas  (_step_batched_kernel)
//   K5  transient_step_pallas          (_step_kernel), at the end of this file
//
// K3 and K4, the settle sweeps of a batch of systems, compute per system b
//     dz = M z + c        z' = z + dt * dz        res = max_i |dz_i|
// in float32 with an f32 accumulator (dt folded into M and c by the
// caller: dt = 1 in the sweep, dt = 0 evaluates the residual only).
//
// What bounds them on an H100: bytes.  A step reads the nz*nz*4-byte
// operator once and does 2*nz*nz flops, 0.5 flop per byte, far below the
// card's ~20 flop/byte f32 balance; a matrix-vector product per system
// gives the tensor cores nothing to do.
//
// K3 (dense_sweep_kernel): one thread block per system, looping over the
//   n_steps inside the block, as the Pallas grid runs one program per
//   system with a fori_loop inside.  The operator comes PRE-TRANSPOSED,
//   mt[j][i] = M[i][j], as the reference passes it: a thread owns four
//   consecutive rows i and walks j, reading mt[j][4t .. 4t+3] as one
//   float4, so a warp reads 512 consecutive bytes per j.  The state lives
//   in shared memory, double-buffered with one __syncthreads() per step
//   (each step reads the whole previous state).  The operator streams
//   from L2/HBM every step: unlike the TPU's VMEM, a block's 227 KB hold
//   a float32 operator only up to nz ~ 235, but they hold the state up to
//   nz = 28,928, which is what the fit test checks.  Only B of the 132
//   SMs are busy, and one SM's load rate bounds each system.
// K4 (dense_step_kernel): one step, row-tiled.  Grid (nz / 128, B); a
//   block's 16 warps share its 128 rows, each warp reducing one row at a
//   time over all columns (float4 loads of M's row, coalesced across the
//   warp, then a shuffle reduction).  The loop over columns inside the
//   block replaces the Pallas grid's sequential column axis and its VMEM
//   accumulator.  The output goes to a separate buffer (the wrapper
//   ping-pongs); each block writes the max |dz| of its rows, and the
//   wrapper takes the max over blocks.  No atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int STEP_THREADS = 512;     // K4: 16 warps per 128-row block

__device__ __forceinline__ float4 dense_rows(const float4* __restrict__ mt4,
                                             const float* z, int n, int g) {
  // rows 4g .. 4g+3 of M z, from the transposed operator
  const int groups = n >> 2;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const float4 m = __ldg(mt4 + static_cast<size_t>(j) * groups + g);
    const float zj = z[j];
    acc.x = fmaf(m.x, zj, acc.x);
    acc.y = fmaf(m.y, zj, acc.y);
    acc.z = fmaf(m.z, zj, acc.z);
    acc.w = fmaf(m.w, zj, acc.w);
  }
  return acc;
}

__global__ void __launch_bounds__(1024)
dense_sweep_kernel(const float* __restrict__ mt, const float* __restrict__ z0,
                   const float* __restrict__ c, float* __restrict__ z_out,
                   float* __restrict__ res, int n, int n_steps, float dt) {
  extern __shared__ __align__(16) float state[];   // [2][n]
  __shared__ float scratch[32];
  const size_t b = blockIdx.x;
  const float4* mt4 = reinterpret_cast<const float4*>(mt + b * n * n);
  const float4* c4 = reinterpret_cast<const float4*>(c + b * n);
  z0 += b * n;
  z_out += b * n;
  const int groups = n >> 2;

  float* cur = state;
  float* nxt = state + n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) cur[i] = z0[i];
  __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      const float4 mz = dense_rows(mt4, cur, n, g);
      const float4 cc = __ldg(c4 + g);
      const float4 zz = reinterpret_cast<const float4*>(cur)[g];
      float4 out;
      out.x = zz.x + dt * (mz.x + cc.x);
      out.y = zz.y + dt * (mz.y + cc.y);
      out.z = zz.z + dt * (mz.z + cc.z);
      out.w = zz.w + dt * (mz.w + cc.w);
      reinterpret_cast<float4*>(nxt)[g] = out;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  // fused settling check at the final state: max_i |M z + c|
  float m = 0.0f;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const float4 mz = dense_rows(mt4, cur, n, g);
    const float4 cc = __ldg(c4 + g);
    m = nan_max(m, fabsf(mz.x + cc.x));
    m = nan_max(m, fabsf(mz.y + cc.y));
    m = nan_max(m, fabsf(mz.z + cc.z));
    m = nan_max(m, fabsf(mz.w + cc.w));
    reinterpret_cast<float4*>(z_out)[g] = reinterpret_cast<const float4*>(cur)[g];
  }
  m = block_max(m, scratch);
  if (threadIdx.x == 0) res[b] = m;
}

__global__ void __launch_bounds__(STEP_THREADS)
dense_step_kernel(const float* __restrict__ m, const float* __restrict__ z,
                  const float* __restrict__ c, float* __restrict__ z_out,
                  float* __restrict__ res, int n, float dt) {
  __shared__ float scratch[32];
  const size_t b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = n >> 2;
  m += b * n * n;
  z += b * n;
  c += b * n;
  z_out += b * n;
  const float4* z4 = reinterpret_cast<const float4*>(z);

  float row_max = 0.0f;
  for (int r = warp; r < ROW_BLOCK; r += STEP_THREADS / 32) {
    const int i = blockIdx.x * ROW_BLOCK + r;
    const float4* row = reinterpret_cast<const float4*>(m + static_cast<size_t>(i) * n);
    float acc = 0.0f;
#pragma unroll 4
    for (int g = lane; g < groups; g += 32) {
      const float4 mv = __ldg(row + g);
      const float4 zv = __ldg(z4 + g);
      acc = fmaf(mv.x, zv.x, acc);
      acc = fmaf(mv.y, zv.y, acc);
      acc = fmaf(mv.z, zv.z, acc);
      acc = fmaf(mv.w, zv.w, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const float dz = acc + __ldg(c + i);
      z_out[i] = z[i] + dt * dz;
      row_max = nan_max(row_max, fabsf(dz));
    }
  }
  const float mx = block_max(row_max, scratch);
  if (threadIdx.x == 0) res[b * gridDim.x + blockIdx.x] = mx;
}

// K5 (transient_step_kernel): one Euler step of ONE operator applied to
//   nb state columns, Z' = Z + dt (M Z + C), for M (n, n) and Z, C
//   (n, nb), float32 or bfloat16, a float32 accumulator, the output in
//   Z's dtype.  The body is K6's tiled product (common.cuh) with the step
//   as its epilogue: Z is read twice, as the contraction operand and in
//   the epilogue, and the result goes to a separate buffer, as the
//   Pallas kernel passes Z twice and writes a new array.  The epilogue
//   rounds z + dt * (acc + c) step by step, as the plain version does.
//   Ragged n and nb are masked, never padded.  Bound by bytes at small nb
//   (M once: 268 MB at n = 8192, 80 us), by float32 operations past
//   nb ~ 40.
template <typename C, typename T>
__global__ void __launch_bounds__(256)
transient_step_kernel(const T* __restrict__ m, const T* __restrict__ z,
                      const T* __restrict__ c, T* __restrict__ z_out, int n, int nb,
                      float dt) {
  const int row0 = blockIdx.x * C::BM;
  const int col0 = blockIdx.y * C::BN;
  float acc[C::TM][C::TN];
  int pr, pc;
  if (!tile_product<C>(m, z, n, n, nb, row0, col0, acc, pr, pc)) return;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int r = row0 + pr + i * C::ROWS;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int cj = col0 + pc + j * C::COLS;
      if (cj >= nb) continue;
      const size_t e = static_cast<size_t>(r) * nb + cj;
      const float dz = __fadd_rn(acc[i][j], to_f32(c[e]));
      store_as(z_out + e, __fadd_rn(to_f32(z[e]), __fmul_rn(dt, dz)));
    }
  }
}

template <typename C, typename T>
int launch_step(const void* m, const void* z, const void* c, void* z_out, int n, int nb,
                float dt, cudaStream_t stream) {
  const dim3 grid((n + C::BM - 1) / C::BM, (nb + C::BN - 1) / C::BN);
  transient_step_kernel<C, T><<<grid, C::THREADS, 0, stream>>>(
      static_cast<const T*>(m), static_cast<const T*>(z), static_cast<const T*>(c),
      static_cast<T*>(z_out), n, nb, dt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_step_for_width(const void* m, const void* z, const void* c, void* z_out, int n,
                          int nb, float dt, cudaStream_t stream) {
  if (nb == 1) return launch_step<ProdColumn, T>(m, z, c, z_out, n, nb, dt, stream);
  if (nb <= ProdNarrow::BN)
    return launch_step<ProdNarrow, T>(m, z, c, z_out, n, nb, dt, stream);
  return launch_step<ProdWide, T>(m, z, c, z_out, n, nb, dt, stream);
}

}  // namespace
}  // namespace repro_torch

// K5: m (n, n), z/c/z_out (n, nb), contiguous, one dtype (float32, or
// bfloat16 when is_bf16); any n and nb.  An empty state launches nothing.
extern "C" int repro_transient_step(const void* m, const void* z, const void* c,
                                    int is_bf16, void* z_out, int n, int nb, float dt,
                                    void* stream) {
  using namespace repro_torch;
  if (n == 0 || nb == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_step_for_width<__nv_bfloat16>(m, z, c, z_out, n, nb, dt, s)
                 : launch_step_for_width<float>(m, z, c, z_out, n, nb, dt, s);
}

// C interface of K3 and K4 (bound with ctypes).  Pointers are device pointers of
// contiguous float32 tensors; n is a multiple of 128.  Each returns the
// CUDA error code of its launch (0 = success).
extern "C" int repro_dense_sweep(const void* mt, const void* z, const void* c,
                                 void* z_out, void* res, int batch, int n,
                                 int n_steps, float dt, void* stream) {
  using namespace repro_torch;
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dense_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = n / 4;
  const int threads = groups < 1024 ? groups : 1024;
  dense_sweep_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mt), static_cast<const float*>(z),
      static_cast<const float*>(c), static_cast<float*>(z_out),
      static_cast<float*>(res), n, n_steps, dt);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_dense_step(const void* m, const void* z, const void* c,
                                void* z_out, void* res, int batch, int n, float dt,
                                void* stream) {
  using namespace repro_torch;
  const dim3 grid(n / ROW_BLOCK, batch);
  dense_step_kernel<<<grid, STEP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<const float*>(z),
      static_cast<const float*>(c), static_cast<float*>(z_out),
      static_cast<float*>(res), n, dt);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
