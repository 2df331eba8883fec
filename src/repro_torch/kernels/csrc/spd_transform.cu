// K7a and K7b: the fused Sec. IV transform (Eqs. 15-16, 22) for Hopper
// (sm_90a).
//
// Replace the TPU kernels of src/repro/kernels/spd_transform.py:
//   K7a  colabs_pallas    (_colabs_kernel)    out[j] = sum_i |A[i, j]|
//   K7b  assemble_pallas  (_assemble_kernel)  K_A, K_B from one read of A
//
// A is (rows, cols) row-major, float32 or bfloat16; the arithmetic is
// float32 and K_A, K_B are stored in A's dtype.
//
// What bounds them on an H100: bytes.  K7a reads A once (67.1 MB at
// n = 4096, 20.0 us at 3.35 TB/s) for one add per element; K7b reads A
// once and writes K_A and K_B once (201 MB, 60.1 us) for a handful of
// flops per element.
//
// K7a (colabs_kernel): one thread per column, looping over all rows
//   inside the thread, so a warp reads 32 consecutive words of a row per
//   step.  The Pallas kernel carries the column sum in a VMEM scratch
//   across its sequential row-block grid axis; on the card that carry is
//   this loop, not a reduction across blocks, and the sum runs in row
//   order.  Each thread keeps 32 row loads in flight before it adds them.
//   At n = 4096 that is only 4096 threads (one warp per block, 128
//   blocks), about 0.5 MB in flight over the card, too little to reach
//   the HBM rate: the kernel is latency-bound, several times its bound.
//   Splitting the rows over blocks needs a second pass; later work.
// K7b (assemble_kernel): an elementwise pass, one block per row, threads
//   striding over its columns (coalesced reads of A, coalesced writes of
//   K_A and K_B).  Each thread derives the diagonal from its global row
//   and column, as the Pallas kernel does with broadcasted_iota, and
//   reads D and K_s only on the diagonal.  The arithmetic is rounded
//   step by step (no FMA contraction), so it matches the plain version
//   bit for bit:
//     K_A = diag(D - K_s) + 0.5 (A - |A|)        (Eq. 15)
//     K_B = diag(D) - 0.5 (A + |A|)              (Eq. 16)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int COLABS_THREADS = 32;     // one warp per block: spread over the SMs
constexpr int COLABS_INFLIGHT = 32;    // row loads a thread issues before adding
constexpr int ASSEMBLE_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(COLABS_THREADS)
colabs_kernel(const T* __restrict__ a, float* __restrict__ out, int rows, int cols) {
  const int j = blockIdx.x * COLABS_THREADS + threadIdx.x;
  if (j >= cols) return;
  const T* col = a + j;
  float s = 0.0f;
  int i = 0;
  for (; i + COLABS_INFLIGHT <= rows; i += COLABS_INFLIGHT) {
    float v[COLABS_INFLIGHT];
#pragma unroll
    for (int u = 0; u < COLABS_INFLIGHT; ++u)
      v[u] = to_f32(col[static_cast<size_t>(i + u) * cols]);
#pragma unroll
    for (int u = 0; u < COLABS_INFLIGHT; ++u) s += fabsf(v[u]);
  }
  for (; i < rows; ++i) s += fabsf(to_f32(col[static_cast<size_t>(i) * cols]));
  out[j] = s;
}

template <typename T>
__global__ void __launch_bounds__(ASSEMBLE_THREADS)
assemble_kernel(const T* __restrict__ a, const float* __restrict__ d,
                const float* __restrict__ k_s, T* __restrict__ k_a, T* __restrict__ k_b,
                int n) {
  const int i = blockIdx.x;
  const size_t base = static_cast<size_t>(i) * n;
  for (int j = threadIdx.x; j < n; j += ASSEMBLE_THREADS) {
    const float x = to_f32(a[base + j]);
    const float ax = fabsf(x);
    const bool diag = (i == j);
    const float da = diag ? __fsub_rn(d[j], k_s[j]) : 0.0f;
    const float db = diag ? d[j] : 0.0f;
    store_as(k_a + base + j, __fadd_rn(da, __fmul_rn(0.5f, __fsub_rn(x, ax))));
    store_as(k_b + base + j, __fsub_rn(db, __fmul_rn(0.5f, __fadd_rn(x, ax))));
  }
}

template <typename T>
int launch_colabs(const void* a, void* out, int rows, int cols, cudaStream_t stream) {
  const int blocks = (cols + COLABS_THREADS - 1) / COLABS_THREADS;
  colabs_kernel<T><<<blocks, COLABS_THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<float*>(out), rows, cols);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_assemble(const void* a, const void* d, const void* k_s, void* k_a, void* k_b,
                    int n, cudaStream_t stream) {
  assemble_kernel<T><<<n, ASSEMBLE_THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const float*>(d),
      static_cast<const float*>(k_s), static_cast<T*>(k_a), static_cast<T*>(k_b), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// C interface (bound with ctypes).  a is a device pointer of a contiguous
// row-major matrix, float32 or bfloat16 (a_is_bf16); out, d and k_s are
// float32.  Each returns the CUDA error code of its launch (0 = success);
// an empty matrix launches nothing.
extern "C" int repro_colabs(const void* a, int a_is_bf16, void* out, int rows, int cols,
                            void* stream) {
  using namespace repro_torch;
  if (cols == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return a_is_bf16 ? launch_colabs<__nv_bfloat16>(a, out, rows, cols, s)
                   : launch_colabs<float>(a, out, rows, cols, s);
}

// a (n, n) -> k_a, k_b (n, n) in a's dtype; d, k_s (n,) float32.
extern "C" int repro_assemble(const void* a, int a_is_bf16, const void* d, const void* k_s,
                              void* k_a, void* k_b, int n, void* stream) {
  using namespace repro_torch;
  if (n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return a_is_bf16 ? launch_assemble<__nv_bfloat16>(a, d, k_s, k_a, k_b, n, s)
                   : launch_assemble<float>(a, d, k_s, k_a, k_b, n, s);
}
