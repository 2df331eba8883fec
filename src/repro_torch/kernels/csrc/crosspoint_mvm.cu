// K6: crosspoint-array MVM, I = G V, for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/crosspoint_mvm.py:
//   K6  crosspoint_mvm_pallas  (_mvm_kernel)
//
// G is (m, k), V is (k, nb), both float32 or both bfloat16; the product
// is accumulated in float32 and stored in V's dtype, as the Pallas kernel
// stores its VMEM float32 accumulator.
//
// What bounds it on an H100.  For the crossbar's own operation, nb = 1,
// bytes: G is read once (268 MB of float32 at m = k = 8192, 80 us at
// 3.35 TB/s) for 2 flops per element.  For a batch of nb voltage vectors
// the flops grow with nb and the bytes do not: past nb ~ 40 (float32,
// 67 TFLOP/s outside the tensor cores) it is bound by operations
// (nb = 64: 8.6 GFLOP, 128 us).
//
// Design: the tiled product of common.cuh (tile_product), one BM x BN
// output tile per block, shared-memory tiles of G and V over the
// contraction, float32 accumulators in registers.  The Pallas grid's
// sequential k axis and its VMEM accumulator become the loop over k
// inside the block.  The tile width follows nb: nb = 1 takes ProdColumn
// (32 x 1 tiles, the 128-deep step split over 8 thread chunks), so a
// block's 256 threads all read and add G; nb <= 16 takes ProdNarrow and
// wider batches ProdWide.  Ragged edges are masked in the loads and the
// stores: the wrapper passes G and V as they are, with no padded copy
// (at a ragged 8192-wide shape a padded copy of G alone would cost as
// much as the kernel's bound).  No tensor cores: a wgmma/TMA pipeline is
// later work, and this kernel is the simple, correct first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {
namespace {

template <typename C, typename T>
__global__ void __launch_bounds__(256)
crosspoint_mvm_kernel(const T* __restrict__ g, const T* __restrict__ v, T* __restrict__ out,
                      int m, int k, int nb) {
  const int row0 = blockIdx.x * C::BM;
  const int col0 = blockIdx.y * C::BN;
  float acc[C::TM][C::TN];
  int pr, pc;
  if (!tile_product<C>(g, v, m, k, nb, row0, col0, acc, pr, pc)) return;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int r = row0 + pr + i * C::ROWS;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int cj = col0 + pc + j * C::COLS;
      if (cj < nb) store_as(out + static_cast<size_t>(r) * nb + cj, acc[i][j]);
    }
  }
}

template <typename C, typename T>
int launch(const void* g, const void* v, void* out, int m, int k, int nb,
           cudaStream_t stream) {
  const dim3 grid((m + C::BM - 1) / C::BM, (nb + C::BN - 1) / C::BN);
  crosspoint_mvm_kernel<C, T><<<grid, C::THREADS, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(v), static_cast<T*>(out), m, k, nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for_width(const void* g, const void* v, void* out, int m, int k, int nb,
                     cudaStream_t stream) {
  if (nb == 1) return launch<ProdColumn, T>(g, v, out, m, k, nb, stream);
  if (nb <= ProdNarrow::BN) return launch<ProdNarrow, T>(g, v, out, m, k, nb, stream);
  return launch<ProdWide, T>(g, v, out, m, k, nb, stream);
}

}  // namespace
}  // namespace repro_torch

// C interface (bound with ctypes).  g (m, k) and v (k, nb) are device
// pointers of contiguous tensors of one dtype (float32, or bfloat16 when
// is_bf16), out (m, nb) of the same dtype.  Returns the CUDA error code
// of the launch (0 = success); an empty output launches nothing.
extern "C" int repro_crosspoint_mvm(const void* g, const void* v, int is_bf16, void* out,
                                    int m, int k, int nb, void* stream) {
  using namespace repro_torch;
  if (m == 0 || nb == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_for_width<__nv_bfloat16>(g, v, out, m, k, nb, s)
                 : launch_for_width<float>(g, v, out, m, k, nb, s);
}
