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
// K7a (colabs_kernel): the Pallas kernel carries the column sum in a VMEM
//   scratch across its sequential row-block grid axis.  On the card the
//   rows are split instead, over the warps of a block and over the blocks
//   of a thread-block cluster, and the partials are added in a fixed
//   order in one launch:
//   * a block of 8 warps owns a strip of 32 x VEC columns (VEC = 4 float32
//     or 8 bf16: one 16-byte load per lane, so a warp reads a 512-byte row
//     segment per load) and one cluster rank's share of the rows;
//   * warp w takes the groups of COLABS_UNROLL = 8 consecutive rows whose
//     index is w modulo 8; each lane issues the group's 8 loads before it
//     adds them, in row order, into its VEC column sums;
//   * the warps' partials are added in warp order through shared memory,
//     and the cluster's R blocks (R <= 8, ceil(rows / R) rows each) in
//     rank order through distributed shared memory (common.cuh:
//     cluster_sum_rank_order).  No float atomics and no workspace: two
//     launches give the same bits, and spd_transform.py:
//     colabs_in_kernel_order repeats the order in plain PyTorch.
//   At n = 4096 in float32 that is 32 strips x 8 ranks = 256 blocks, 32 KB
//   of loads in flight per block (up to 64 KB per SM), against the ~25 KB
//   per SM that 3.35 TB/s x ~1 us of latency asks.  The "scalar" variant
//   (cols not a multiple of VEC, or a base off the 16-byte grid) is the
//   same kernel with masked scalar loads, lane + 32 c taking column c of
//   its lane's share: the same per-column order, so the same bits.
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

constexpr int COLABS_THREADS = 256;
constexpr int COLABS_WARPS = COLABS_THREADS / 32;
constexpr int COLABS_UNROLL = 8;       // row loads a lane issues before adding
constexpr int COLABS_MAX_RANKS = 8;    // the portable cluster size
constexpr int ASSEMBLE_THREADS = 256;

// s[c] += |x_c| for the VEC values of one 16-byte load, in column order
__device__ __forceinline__ void add_abs(float (&s)[4], uint4 raw) {
  const float4 x = *reinterpret_cast<const float4*>(&raw);
  s[0] += fabsf(x.x);
  s[1] += fabsf(x.y);
  s[2] += fabsf(x.z);
  s[3] += fabsf(x.w);
}

__device__ __forceinline__ void add_abs(float (&s)[8], uint4 raw) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(x[q]);
    s[2 * q] += fabsf(f.x);
    s[2 * q + 1] += fabsf(f.y);
  }
}

// Grid: ranks x strips blocks along x, in clusters of `ranks`; block
// (strip, rank) adds rows [rank * chunk, (rank + 1) * chunk) of columns
// [strip * STRIP, (strip + 1) * STRIP).  VEC16: cols a multiple of VEC and
// `a` 16-byte aligned (colabs_route "vec16"); otherwise masked scalar
// loads ("scalar").
template <typename T, bool VEC16>
__global__ void __launch_bounds__(COLABS_THREADS)
colabs_kernel(const T* __restrict__ a, float* __restrict__ out, int rows, int cols) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int STRIP = 32 * VEC;
  __shared__ __align__(16) float wpart[COLABS_WARPS * STRIP];   // per warp, by column
  __shared__ float4 bpart[STRIP / 4];                           // the block's sums
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int col0 = (blockIdx.x / ranks) * STRIP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk = (rows + ranks - 1) / ranks;
  const int row0 = rank * chunk;
  const int len = min(chunk, rows - row0);   // <= 0: this rank adds nothing

  float s[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) s[c] = 0.0f;
  for (int g0 = warp * COLABS_UNROLL; g0 < len; g0 += COLABS_WARPS * COLABS_UNROLL) {
    const T* base = a + static_cast<size_t>(row0 + g0) * cols;
    if constexpr (VEC16) {
      const int col = col0 + lane * VEC;     // VEC columns, wholly inside or outside
      uint4 x[COLABS_UNROLL];
#pragma unroll
      for (int u = 0; u < COLABS_UNROLL; ++u)
        x[u] = (g0 + u < len && col < cols)
                   ? *reinterpret_cast<const uint4*>(base + static_cast<size_t>(u) * cols + col)
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int u = 0; u < COLABS_UNROLL; ++u) add_abs(s, x[u]);
    } else {
      float x[COLABS_UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < COLABS_UNROLL; ++u)
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          const int col = col0 + c * 32 + lane;
          x[u][c] = (g0 + u < len && col < cols)
                        ? to_f32(base[static_cast<size_t>(u) * cols + col]) : 0.0f;
        }
#pragma unroll
      for (int u = 0; u < COLABS_UNROLL; ++u)
#pragma unroll
        for (int c = 0; c < VEC; ++c) s[c] += fabsf(x[u][c]);
    }
  }

  // the warps' partials, in warp order
  float* mine = wpart + warp * STRIP;
#pragma unroll
  for (int c = 0; c < VEC; ++c) mine[VEC16 ? lane * VEC + c : c * 32 + lane] = s[c];
  __syncthreads();
  const float4* wp = reinterpret_cast<const float4*>(wpart);
  if (threadIdx.x < STRIP / 4) {
    float4 b = wp[threadIdx.x];
#pragma unroll
    for (int w = 1; w < COLABS_WARPS; ++w) {
      const float4 p = wp[w * (STRIP / 4) + threadIdx.x];
      b.x += p.x;
      b.y += p.y;
      b.z += p.z;
      b.w += p.w;
    }
    bpart[threadIdx.x] = b;
  }
  // ... and the cluster's blocks, in rank order
  if (!cluster_sum_rank_order(bpart, STRIP / 4) || threadIdx.x >= STRIP / 4) return;
  const float4 r = bpart[threadIdx.x];
  const int col = col0 + 4 * threadIdx.x;
  if constexpr (VEC16) {
    if (col < cols) *reinterpret_cast<float4*>(out + col) = r;
  } else {
    const float v[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < cols) out[col + e] = v[e];
  }
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

template <typename T, bool VEC16>
int launch_colabs(const void* a, void* out, int rows, int cols, int ranks,
                  cudaStream_t stream) {
  constexpr int STRIP = 32 * (16 / static_cast<int>(sizeof(T)));
  const int strips = (cols + STRIP - 1) / STRIP;
  return static_cast<int>(launch_clustered(colabs_kernel<T, VEC16>, dim3(ranks * strips),
                                           COLABS_THREADS, 0, ranks, stream,
                                           static_cast<const T*>(a), static_cast<float*>(out),
                                           rows, cols));
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
//
// colabs: `ranks` (1 <= ranks <= 8) blocks share each column strip's rows
// (spd_transform.py:colabs_ranks); vec16 != 0 takes the 16-byte loads,
// which need cols a multiple of 4 (float32) or 8 (bf16) and a 16-byte
// aligned base (spd_transform.py:colabs_route decides).
extern "C" int repro_colabs(const void* a, int a_is_bf16, void* out, int rows, int cols,
                            int ranks, int vec16, void* stream) {
  using namespace repro_torch;
  if (cols == 0) return 0;
  if (ranks < 1 || ranks > COLABS_MAX_RANKS) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (a_is_bf16)
    return vec16 ? launch_colabs<__nv_bfloat16, true>(a, out, rows, cols, ranks, s)
                 : launch_colabs<__nv_bfloat16, false>(a, out, rows, cols, ranks, s);
  return vec16 ? launch_colabs<float, true>(a, out, rows, cols, ranks, s)
               : launch_colabs<float, false>(a, out, rows, cols, ranks, s);
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
