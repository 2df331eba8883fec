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
// K1 (ell_sweep_kernel): one system per thread-block cluster, looping over
//   the n_steps inside the cluster, as the Pallas grid runs one program
//   per system with a fori_loop inside.  A block per system (the first
//   port) kept B of the 132 SMs busy, each streaming its whole operator
//   through one SM's load path every step (~100 GB/s an SM: 19.5 us a step
//   at (4, 32, 8192)).  Now system b runs on the R blocks of cluster b
//   (ell_transient.py:ell_sweep_ranks, a pure function of the shape):
//   * rank r owns the rows [r nz / R, (r + 1) nz / R) and computes them
//     with ell_row, each row's arithmetic unchanged, so n K1 steps give
//     the bits of n K2 launches;
//   * RESIDENT (the rank's slots fit beside the state): the rank copies
//     its slot-major slice of idx and w into shared memory once per launch
//     (16-byte cp.async) and reads it from there for all n_steps, so a
//     step reads no operator byte from L2 or HBM; R is the smallest power
//     of two that fits (16 at the matrix-free n = 1024 case, (4, 32, 8192):
//     131,072 bytes of f32 slots and 65,536 of state a rank);
//   * streamed (no R <= 16 fits): R = 16 and the slots stream from L2 as
//     before, now through 16 SMs a system;
//   * every rank keeps the whole state, double-buffered in shared memory;
//     a step writes each new row value into its own next buffer and every
//     peer's through distributed shared memory (common.cuh:
//     cluster_broadcast), then one cluster barrier per step publishes the
//     writes and keeps a fast rank from overwriting a buffer a peer still
//     reads;
//   * the residual max |M z + c| at the final state is taken per rank and
//     combined in rank 0 through DSMEM (common.cuh:cluster_max), whose
//     barrier is also the last: no block exits while a peer may still
//     touch its shared memory.
//   What bounds it now: shared memory and the cluster.  A resident step
//   reads each slot's index and weight and gathers the state (2-4-way bank
//   conflicts on a random gather), ~2,500 shared-memory wavefronts a rank
//   at the main shape, plus 32 KB of DSMEM stores out of and into each SM
//   and the barrier: 2.9 us a step on an H100 (19.5 before), 2.1 at R = 4
//   (n = 256), and 10 us a launch with no step (the slots' copy and the
//   launch).  The streamed variant takes 7.3 us a step at (4, 33, 16384),
//   the slots' L2 reads.
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

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

__device__ __forceinline__ float slot_product(float w, float z) { return __fmul_rn(w, z); }

__device__ __forceinline__ float slot_product(__nv_bfloat16 w, float z) {
  return __bfloat162float(__hmul(w, __float2bfloat16_rn(z)));
}

// sum_k w[k, i] * z[idx[k, i]] in slot order, f32 accumulator; slot k of
// row i at k * stride + i, idx and w in global memory, or in shared memory
// when SHARED (a resident K1 rank's slice)
template <typename W, bool SHARED = false>
__device__ __forceinline__ float ell_row(const int32_t* __restrict__ idx,
                                         const W* __restrict__ w, const float* z,
                                         int stride, int k_slots, int i) {
  using Index = typename std::conditional<SHARED, int, size_t>::type;  // 32-bit in shared
  float acc = 0.0f;
  for (int k = 0; k < k_slots; ++k) {
    const Index at = static_cast<Index>(k) * stride + i;
    const int32_t j = SHARED ? idx[at] : __ldg(idx + at);
    acc = __fadd_rn(acc, slot_product(w[at], z[j]));
  }
  return acc;
}

// Grid: B clusters of R blocks along x; dynamic shared memory: the state
// [2][nz] float32 and, when RESIDENT, the rank's slots idx [K][rows] int32
// then w [K][rows].
template <typename W, bool RESIDENT>
__global__ void __launch_bounds__(1024)
ell_sweep_kernel(const int32_t* __restrict__ idx, const W* __restrict__ w,
                 const float* __restrict__ z0, const float* __restrict__ c,
                 float* __restrict__ z_out, float* __restrict__ res,
                 int nz, int k_slots, int n_steps, float dt) {
  extern __shared__ __align__(16) float ell_smem[];
  __shared__ float scratch[32];
  __shared__ float rank_max[SWEEP_MAX_RANKS];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.x / ranks;
  const int rows = nz / ranks;
  const int row0 = rank * rows;
  idx += b * k_slots * nz;
  w += b * k_slots * nz;
  z0 += b * nz;
  c += b * nz;
  z_out += b * nz;

  float* cur = ell_smem;
  float* nxt = ell_smem + nz;
  int32_t* s_idx = reinterpret_cast<int32_t*>(ell_smem + 2 * nz);
  W* s_w = reinterpret_cast<W*>(s_idx + static_cast<size_t>(k_slots) * rows);
  for (int i = threadIdx.x; i < nz; i += blockDim.x) cur[i] = z0[i];
  if constexpr (RESIDENT) {
    stage_rows(s_idx, idx + row0, k_slots, rows * 4, static_cast<size_t>(nz) * 4);
    stage_rows(s_w, w + row0, k_slots, rows * static_cast<int>(sizeof(W)),
               static_cast<size_t>(nz) * sizeof(W));
    cp_async_commit();
    cp_async_wait<0>();
  }
  // every block of the cluster has started (its shared memory may now be
  // written by peers) and holds the initial state and its slots
  cluster.sync();

  // where row l of this rank (global row row0 + l) finds its slots
  const int32_t* r_idx = RESIDENT ? s_idx : idx;
  const W* r_w = RESIDENT ? s_w : w;
  const int stride = RESIDENT ? rows : nz;
  const int first = RESIDENT ? 0 : row0;
  for (int s = 0; s < n_steps; ++s) {
    for (int l = threadIdx.x; l < rows; l += blockDim.x) {
      const int i = row0 + l;
      const float dz = __fadd_rn(
          ell_row<W, RESIDENT>(r_idx, r_w, cur, stride, k_slots, first + l), __ldg(c + i));
      cluster_broadcast(cluster, nxt, i, __fadd_rn(cur[i], __fmul_rn(dt, dz)));
    }
    cluster_step_barrier(cluster);
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  // fused settling check at the final state: max_i |M z + c|
  float m = 0.0f;
  for (int l = threadIdx.x; l < rows; l += blockDim.x) {
    const int i = row0 + l;
    const float dz = __fadd_rn(
        ell_row<W, RESIDENT>(r_idx, r_w, cur, stride, k_slots, first + l), __ldg(c + i));
    m = nan_max(m, fabsf(dz));
    z_out[i] = cur[i];
  }
  m = cluster_max(cluster, m, scratch, rank_max);
  if (rank == 0 && threadIdx.x == 0) res[b] = m;
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

// Dynamic shared memory of a K1 block: the state, and a resident rank's slots
template <typename W>
size_t ell_sweep_smem(int nz, int k_slots, int ranks, bool resident) {
  const size_t state = 2 * static_cast<size_t>(nz) * sizeof(float);
  const size_t slots = static_cast<size_t>(nz / ranks) * k_slots * (4 + sizeof(W));
  return resident ? state + slots : state;
}

// Ready K1's kernel of this dtype and variant for clusters of `ranks`
// blocks (once per device); its threads and dynamic shared memory
template <typename W, bool RESIDENT>
cudaError_t sweep_setup(int nz, int k_slots, int ranks, int* threads, int* smem) {
  static std::atomic<bool> raised[MAX_DEVICES];
  *threads = sweep_threads(nz / ranks);
  *smem = static_cast<int>(ell_sweep_smem<W>(nz, k_slots, ranks, RESIDENT));
  return allow_sweep_clusters(ell_sweep_kernel<W, RESIDENT>, raised);
}

template <typename W, bool RESIDENT>
int launch_sweep(const void* idx, const void* w, const void* z, const void* c,
                 void* z_out, void* res, int batch, int nz, int k_slots,
                 int n_steps, float dt, int ranks, cudaStream_t stream) {
  int threads = 0, smem = 0;
  cudaError_t err = sweep_setup<W, RESIDENT>(nz, k_slots, ranks, &threads, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_sweep_clusters(
      ell_sweep_kernel<W, RESIDENT>, batch, threads, smem, ranks, stream,
      static_cast<const int32_t*>(idx), static_cast<const W*>(w),
      static_cast<const float*>(z), static_cast<const float*>(c),
      static_cast<float*>(z_out), static_cast<float*>(res), nz, k_slots, n_steps, dt));
}

template <typename W, bool RESIDENT>
int sweep_clusters(int nz, int k_slots, int ranks, int* clusters) {
  int threads = 0, smem = 0;
  cudaError_t err = sweep_setup<W, RESIDENT>(nz, k_slots, ranks, &threads, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      sweep_max_clusters(ell_sweep_kernel<W, RESIDENT>, threads, smem, ranks, clusters));
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
//
// K1 on `ranks` blocks a system (1, 2, 4, 8 or 16), its slots resident in
// shared memory when `resident` (ell_transient.py:ell_sweep_ranks and
// ell_sweep_variant decide); idx and w 16-byte aligned.  A cluster the
// device cannot place returns an error and launches nothing.
extern "C" int repro_ell_sweep(const void* idx, const void* w, int w_is_bf16,
                               const void* z, const void* c, void* z_out, void* res,
                               int batch, int nz, int k_slots, int n_steps, float dt,
                               int ranks, int resident, void* stream) {
  using namespace repro_torch;
  if (batch == 0) return 0;
  if (!sweep_ranks_valid(nz, ranks)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (w_is_bf16)
    return resident ? launch_sweep<__nv_bfloat16, true>(idx, w, z, c, z_out, res, batch, nz,
                                                        k_slots, n_steps, dt, ranks, s)
                    : launch_sweep<__nv_bfloat16, false>(idx, w, z, c, z_out, res, batch, nz,
                                                         k_slots, n_steps, dt, ranks, s);
  return resident ? launch_sweep<float, true>(idx, w, z, c, z_out, res, batch, nz, k_slots,
                                              n_steps, dt, ranks, s)
                  : launch_sweep<float, false>(idx, w, z, c, z_out, res, batch, nz, k_slots,
                                               n_steps, dt, ranks, s);
}

// How many K1 clusters of `ranks` blocks, for nz states and k_slots slots
// of this variant and dtype, the current device runs at once
// (cudaOccupancyMaxActiveClusters), into *clusters; 0 means the device
// cannot place one and repro_ell_sweep would refuse the launch.
extern "C" int repro_ell_sweep_clusters(int w_is_bf16, int nz, int k_slots, int ranks,
                                        int resident, int* clusters) {
  using namespace repro_torch;
  if (!sweep_ranks_valid(nz, ranks)) return static_cast<int>(cudaErrorInvalidValue);
  if (w_is_bf16)
    return resident ? sweep_clusters<__nv_bfloat16, true>(nz, k_slots, ranks, clusters)
                    : sweep_clusters<__nv_bfloat16, false>(nz, k_slots, ranks, clusters);
  return resident ? sweep_clusters<float, true>(nz, k_slots, ranks, clusters)
                  : sweep_clusters<float, false>(nz, k_slots, ranks, clusters);
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
