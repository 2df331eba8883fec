// K6: crosspoint-array MVM, I = G V, for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/crosspoint_mvm.py:
//   K6  crosspoint_mvm_pallas  (_mvm_kernel)
//
// G is (m, k), V is (k, nb), both float32 or both bfloat16; the product
// is accumulated in float32 and stored in V's dtype, as the Pallas kernel
// stores its VMEM float32 accumulator.  Ragged edges are masked in the
// loads and the stores: the wrapper passes G and V as they are, with no
// padded copy (at a ragged 8192-wide shape a padded copy of G alone would
// cost as much as the kernel's bound).
//
// Routes (kernels/crosspoint_mvm.py:crosspoint_mvm_route, a pure function
// of dtype, nb and alignment):
//
// * "mma_async": bf16, nb >= 2, k % 8 == 0, nb % 8 == 0 and both base
//   pointers 16-byte aligned -> crosspoint_mvm_mma_kernel<true>;
// * "mma_scalar": any other bf16 product with nb >= 2 ->
//   crosspoint_mvm_mma_kernel<false>, the same kernel staging its tiles
//   through masked scalar loads;
// * "f32_async": float32, nb >= 2, k % 4 == 0, nb % 4 == 0 and both bases
//   16-byte aligned -> crosspoint_mvm_f32_kernel<true>, split-k over a
//   thread-block cluster; TF32 stays off (the parity contract), so this
//   is an FFMA kernel;
// * "f32_scalar": any other float32 product with nb >= 2 ->
//   crosspoint_mvm_f32_kernel<false>, the same kernel staging its tiles
//   through masked scalar loads;
// * "fma": nb = 1 in both dtypes (the crossbar's own GEMV) ->
//   crosspoint_mvm_kernel<T, VEC16> on common.cuh's gemv_rows, in the
//   variant of kernels/gemv.py:gemv_variant: "vec16" (k a multiple of 4
//   in float32, of 8 in bf16, both bases 16-byte aligned) streams G in
//   16-byte loads, "scalar" reads the same chunks by masked scalar loads.
//
// What bounds it on an H100.  For the crossbar's own operation, nb = 1,
// bytes: G is read once (268 MB of float32 at m = k = 8192, 80 us at
// 3.35 TB/s) for 2 flops per element.  For a batch of nb voltage vectors
// the flops grow with nb and the bytes do not: in float32 past nb ~ 40
// (67 TFLOP/s outside the tensor cores) it is bound by operations (nb =
// 64: 8.6 GFLOP, 128 us).  In bf16 at nb = 64 it stays bound by bytes:
// 136 MB (G 134 MB, V and I 1 MB each) take 40.7 us at 3.35 TB/s, and
// the 8.6 GFLOP take 8.7 us at the bf16 tensor-core peak -- but 128 us
// at the float32 FMA rate, which is why the bf16 route needs the tensor
// cores even though it is bound by bytes.
//
// Design of the bf16 route.  A block of 8 warps owns BM = 64 rows and
// BN = 64 columns of I (m = 8192: 128 blocks on the 132 SMs) and walks k
// in BK = 128 steps through a ring of STAGES = 4 shared-memory stages,
// each a 64 x 128 tile of G (16 KB) and a 128 x 64 tile of V, filled by
// 16-byte cp.async: three stages (48 KB of G) are in flight while one is
// multiplied, above the ~25 KB that Little's law asks of each SM
// (3.35 TB/s x ~1 us over 132 SMs).  Warp w owns rows 16 (w % 4) and
// columns 32 (w / 4) of the tile: per 16-deep step one ldmatrix of G (the
// A fragment), two ldmatrix.trans of V (V is k-major, so the B fragments
// come transposed) and four m16n8k16 products into float32 registers.
// Tile rows are padded by 16 bytes, so the eight rows an ldmatrix reads
// fall in distinct banks.  The epilogue rounds to bf16 and masks rows
// past m and columns past nb.  Split-k is not used: the 128 row blocks
// already cover the card.  At b = 64 the kernel runs at about 60 % of
// the HBM rate: the per-step cost of the ring (its wait and barrier, the
// copies' issue, the fragments' shared-memory reads), not HBM, sets the
// pace, which is why the steps are 128 deep rather than 64.  Warpgroup
// products (wgmma), whose operands the tensor cores read from shared
// memory, fed by TMA with an mbarrier per stage instead of a block-wide
// barrier, are the next step; a first wgmma version fed by cp.async, one
// warpgroup per SM and a wait after every step, was slower than this one.
//
// Design of the float32 route (b >= 2).  At b = 64 it is bound by FP32
// operations (8.6 GFLOP, 128 us at 67 TFLOP/s) while it streams G from HBM
// at about 1.2 TB/s, so the kernel has to keep the FMA pipes fed and the
// copies in flight at once:
// * a block of 256 threads owns BM = 128 rows and BN = 64 columns of I;
//   thread (rg, cg) owns rows rg + 16 i (i < 8) and columns 4 cg .. 4 cg + 3,
//   an 8 x 4 register tile (F32_TM x F32_TN).  G's tile stays row-major in
//   shared memory (rows padded by 16 bytes): per 4-deep k group a thread
//   reads each of its 8 rows as one float4 and V's 4 rows as float4s, 12
//   LDS.128 per 128 FFMA.  A warp spans 8 row groups and 4 column groups,
//   so a quarter-warp reads 2 of G's rows and 4 of V's float4s per load;
// * G and V arrive by 16-byte cp.async through a ring of F32_STAGES = 4
//   stages of 32-deep k steps (26 KB each), one barrier per step, three
//   steps in flight while one is multiplied;
// * k is split over the R <= 4 blocks of a cluster (crosspoint_mvm.py:
//   crosspoint_mvm_split), as many as fit one wave: the card holds two of
//   these blocks per SM (registers) and 62 clusters of 4 at once, so
//   m = 8192, b = 64 takes R = 2 (64 row tiles x 2 = 128 blocks), not the
//   256 blocks of R = 4, which ran in two waves.  Each block leaves its
//   partial tile in its ring, and the leader adds them in rank order
//   through distributed shared memory (common.cuh:
//   cluster_sum_rank_order) and stores the tile: no workspace, no
//   atomics, the same bits from launch to launch.  Within a rank each
//   output's sum runs in k order.
// What holds it back on the card: its SMs retire FFMAs at little more
// than half the rate of a loop on registers alone, and the time stayed
// the same with one block per SM or two, with 8 x 8 register tiles (half
// the shared-memory loads per FFMA) and with 64- or 128-deep k steps;
// cuBLAS's float32 product of the same shape is somewhat faster (PERF.md).
// The fma route (b = 1), the crossbar's own operation: bound by bytes, G
// read once (268 MB of float32 at m = k = 8192: 80 us; bf16 half that).
// It used to be a tiled GEMM used as a GEMV (32 x 128 tiles of G staged
// through shared memory by scalar loads, two block barriers a step, at
// most one tile in flight a block: 84 % of the HBM rate).  Now it is
// common.cuh's gemv_rows, designed for the memory system: G streams from
// HBM into registers in 16-byte loads, 4 to 8 KB in flight per warp and no
// barrier, V through the read-only path, one wave of min(m, 132) blocks
// of balanced row ranges (gemv_plan), the order of every sum fixed
// (kernels/gemv.py:gemv_in_kernel_order gives its bits).  The epilogue
// rounds the float32 sum to the output's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace repro_torch {
namespace {

// the fma route's epilogue: the float32 sum rounded to the output's dtype
template <typename T>
struct StoreRow {
  T* out;
  __device__ void operator()(int r, float acc) const { store_as(out + r, acc); }
};

template <typename T, bool VEC16>
__global__ void __launch_bounds__(GEMV_THREADS)
crosspoint_mvm_kernel(const T* __restrict__ g, const T* __restrict__ v, T* __restrict__ out,
                      int m, int k) {
  gemv_rows<T, VEC16, GEMV_ROWS, GEMV_UNROLL, GEMV_PIPE>(g, v, m, k, StoreRow<T>{out});
}

template <typename T, bool VEC16>
int launch_gemv(const void* g, const void* v, void* out, int m, int k, cudaStream_t stream) {
  const GemvPlan plan = gemv_plan(m);
  crosspoint_mvm_kernel<T, VEC16><<<plan.blocks, 32 * plan.warps, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(v), static_cast<T*>(out), m, k);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores fed through a ring of shared-memory stages
// ---------------------------------------------------------------------------

constexpr int MMA_BM = 64, MMA_BN = 64, MMA_BK = 128, MMA_STAGES = 4, MMA_THREADS = 256;
constexpr int MMA_LDG = MMA_BK + 8;   // row strides of the G and V tiles, in bf16
constexpr int MMA_LDV = MMA_BN + 8;
constexpr int MMA_G_ELEMS = MMA_BM * MMA_LDG;
constexpr int MMA_STAGE_ELEMS = MMA_G_ELEMS + MMA_BK * MMA_LDV;   // G tile, then V tile
constexpr int MMA_SMEM_BYTES = MMA_STAGES * MMA_STAGE_ELEMS * 2;

// Stage the k-step at k0: G rows [row0, row0 + 64) x [k0, k0 + 64) and V
// rows [k0, k0 + 64) x [col0, col0 + 64), zero outside the matrices.
// VEC16: 16-byte asynchronous copies (k and nb multiples of 8, aligned
// bases, so every 8-element chunk lies wholly inside or outside);
// otherwise masked scalar loads and stores.
template <bool VEC16>
__device__ __forceinline__ void mvm_stage(const __nv_bfloat16* __restrict__ g,
                                          const __nv_bfloat16* __restrict__ v,
                                          __nv_bfloat16* gs, __nv_bfloat16* vs, int m, int k,
                                          int nb, int row0, int col0, int k0) {
  const int t = threadIdx.x;
  if constexpr (VEC16) {
#pragma unroll
    for (int i = 0; i < MMA_BM * MMA_BK / 8 / MMA_THREADS; ++i) {
      const int c = t + i * MMA_THREADS;
      const int r = c / (MMA_BK / 8), cc = (c % (MMA_BK / 8)) * 8;
      const bool ok = row0 + r < m && k0 + cc < k;
      cp_async16(gs + r * MMA_LDG + cc,
                 ok ? g + static_cast<size_t>(row0 + r) * k + k0 + cc : g, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < MMA_BK * MMA_BN / 8 / MMA_THREADS; ++i) {
      const int c = t + i * MMA_THREADS;
      const int r = c / (MMA_BN / 8), cc = (c % (MMA_BN / 8)) * 8;
      const bool ok = k0 + r < k && col0 + cc < nb;
      cp_async16(vs + r * MMA_LDV + cc,
                 ok ? v + static_cast<size_t>(k0 + r) * nb + col0 + cc : v, ok ? 16 : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
#pragma unroll 4
    for (int i = 0; i < MMA_BM * MMA_BK / MMA_THREADS; ++i) {
      const int e = t + i * MMA_THREADS;
      const int r = e / MMA_BK, c = e % MMA_BK;
      const bool ok = row0 + r < m && k0 + c < k;
      gs[r * MMA_LDG + c] = ok ? g[static_cast<size_t>(row0 + r) * k + k0 + c] : zero;
    }
#pragma unroll 4
    for (int i = 0; i < MMA_BK * MMA_BN / MMA_THREADS; ++i) {
      const int e = t + i * MMA_THREADS;
      const int r = e / MMA_BN, c = e % MMA_BN;
      const bool ok = k0 + r < k && col0 + c < nb;
      vs[r * MMA_LDV + c] = ok ? v[static_cast<size_t>(k0 + r) * nb + col0 + c] : zero;
    }
  }
}

template <bool VEC16>
__global__ void __launch_bounds__(MMA_THREADS)
crosspoint_mvm_mma_kernel(const __nv_bfloat16* __restrict__ g,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                          int m, int k, int nb) {
  extern __shared__ __align__(128) unsigned char mvm_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(mvm_smem);
  const int row0 = blockIdx.x * MMA_BM;
  const int col0 = blockIdx.y * MMA_BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = (warp & 3) * 16;          // the warp's rows and columns in the tile
  const int wc = (warp >> 2) * 32;
  const bool active = col0 + wc < nb;      // warp-uniform: columns left to compute
  const int n_steps = (k + MMA_BK - 1) / MMA_BK;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  // fill the ring: steps 0 .. STAGES - 2, one commit group each
#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < n_steps) {
      __nv_bfloat16* gs = ring + s * MMA_STAGE_ELEMS;
      mvm_stage<VEC16>(g, v, gs, gs + MMA_G_ELEMS, m, k, nb, row0, col0, s * MMA_BK);
    }
    cp_async_commit();
  }

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<MMA_STAGES - 2>();   // this thread's copies of `step` have landed
    __syncthreads();                   // ... everyone's, and step - 1's reads are done
    const int next = step + MMA_STAGES - 1;
    if (next < n_steps) {              // refill the slot that step - 1 used
      __nv_bfloat16* gs = ring + (next % MMA_STAGES) * MMA_STAGE_ELEMS;
      mvm_stage<VEC16>(g, v, gs, gs + MMA_G_ELEMS, m, k, nb, row0, col0, next * MMA_BK);
    }
    cp_async_commit();                 // an empty group past the end keeps the count
    if (!active) continue;
    const __nv_bfloat16* gs = ring + (step % MMA_STAGES) * MMA_STAGE_ELEMS;
    const __nv_bfloat16* vs = gs + MMA_G_ELEMS;
#pragma unroll
    for (int kk = 0; kk < MMA_BK; kk += 16) {
      uint32_t a[4], b[2][4];
      ldmatrix_x4(a, gs + (wr + (lane & 15)) * MMA_LDG + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(b[np], vs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * MMA_LDV + wc +
                                     np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        mma_bf16(acc[2 * np], a, b[np][0], b[np][1]);
        mma_bf16(acc[2 * np + 1], a, b[np][2], b[np][3]);
      }
    }
  }
  cp_async_wait<0>();

  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + wr + gid + (e >> 1) * 8;
      const int c = col0 + wc + j * 8 + tig * 2 + (e & 1);
      if (r < m && c < nb) out[static_cast<size_t>(r) * nb + c] = __float2bfloat16_rn(acc[j][e]);
    }
  }
}

template <bool VEC16>
int launch_mma(const void* g, const void* v, void* out, int m, int k, int nb,
               cudaStream_t stream) {
  static std::atomic<bool> raised[MAX_DEVICES];
  cudaError_t err = allow_dynamic_smem(crosspoint_mvm_mma_kernel<VEC16>, MMA_SMEM_BYTES, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + MMA_BM - 1) / MMA_BM, (nb + MMA_BN - 1) / MMA_BN);
  crosspoint_mvm_mma_kernel<VEC16><<<grid, MMA_THREADS, MMA_SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), m, k, nb);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32 route (b >= 2): FFMA tiles, split-k over a thread-block cluster
// ---------------------------------------------------------------------------

constexpr int F32_BM = 128, F32_BN = 64, F32_BK = 32, F32_STAGES = 4, F32_THREADS = 256;
constexpr int F32_TM = 8, F32_TN = 4;       // a thread's register tile
constexpr int F32_MAX_SPLIT = 4;            // blocks per cluster
constexpr int F32_LDG = F32_BK + 4;         // G tile row stride in floats (16-byte pad)
constexpr int F32_G_FLOATS = F32_BM * F32_LDG;
constexpr int F32_STAGE_FLOATS = F32_G_FLOATS + F32_BK * F32_BN;   // G tile, then V tile
constexpr int F32_SMEM_BYTES = F32_STAGES * F32_STAGE_FLOATS * 4;
static_assert(F32_THREADS * F32_TM * F32_TN <= F32_STAGES * F32_STAGE_FLOATS,
              "the partial tile must fit the ring");
static_assert(F32_BM == 16 * F32_TM && F32_BN == 16 * F32_TN, "16 x 16 thread grid");

// Stage the k step at k0 of this rank's range [.., k_end): G rows
// [row0, row0 + 128) x [k0, k0 + 32) and V rows [k0, k0 + 32) x
// [col0, col0 + 64), zero outside.  VEC16: 16-byte asynchronous copies (k
// and nb multiples of 4, aligned bases, k0 and k_end multiples of 4, so
// every 4-float chunk lies wholly inside or outside); otherwise masked
// scalar loads and stores.
template <bool VEC16>
__device__ __forceinline__ void f32_stage(const float* __restrict__ g,
                                          const float* __restrict__ v, float* gs, float* vs,
                                          int m, int k, int k_end, int nb, int row0, int col0,
                                          int k0) {
  const int t = threadIdx.x;
  if constexpr (VEC16) {
#pragma unroll
    for (int i = 0; i < F32_BM * F32_BK / 4 / F32_THREADS; ++i) {
      const int c = t + i * F32_THREADS;
      const int r = c / (F32_BK / 4), cc = (c % (F32_BK / 4)) * 4;
      const bool ok = row0 + r < m && k0 + cc < k_end;
      cp_async16(gs + r * F32_LDG + cc,
                 ok ? g + static_cast<size_t>(row0 + r) * k + k0 + cc : g, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < F32_BK * F32_BN / 4 / F32_THREADS; ++i) {
      const int c = t + i * F32_THREADS;
      const int r = c / (F32_BN / 4), cc = (c % (F32_BN / 4)) * 4;
      const bool ok = k0 + r < k_end && col0 + cc < nb;
      cp_async16(vs + r * F32_BN + cc,
                 ok ? v + static_cast<size_t>(k0 + r) * nb + col0 + cc : v, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < F32_BM * F32_BK / F32_THREADS; ++i) {
      const int e = t + i * F32_THREADS;
      const int r = e / F32_BK, c = e % F32_BK;
      gs[r * F32_LDG + c] = (row0 + r < m && k0 + c < k_end)
                                ? g[static_cast<size_t>(row0 + r) * k + k0 + c] : 0.0f;
    }
#pragma unroll 4
    for (int i = 0; i < F32_BK * F32_BN / F32_THREADS; ++i) {
      const int e = t + i * F32_THREADS;
      const int r = e / F32_BN, c = e % F32_BN;
      vs[r * F32_BN + c] = (k0 + r < k_end && col0 + c < nb)
                               ? v[static_cast<size_t>(k0 + r) * nb + col0 + c] : 0.0f;
    }
  }
}

__device__ __forceinline__ float lane_of(const float4& x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}

// Grid: (row tiles x R, column tiles), in clusters of R blocks along x;
// rank r of a cluster adds k in [r k_chunk, (r + 1) k_chunk).
template <bool VEC16>
__global__ void __launch_bounds__(F32_THREADS, 2)
crosspoint_mvm_f32_kernel(const float* __restrict__ g, const float* __restrict__ v,
                          float* __restrict__ out, int m, int k, int nb, int k_chunk) {
  extern __shared__ __align__(128) unsigned char f32_smem[];
  float* ring = reinterpret_cast<float*>(f32_smem);
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / ranks) * F32_BM;
  const int col0 = blockIdx.y * F32_BN;
  const int k_begin = rank * k_chunk;
  const int k_end = min(k, k_begin + k_chunk);
  const int n_steps = k_end > k_begin ? (k_end - k_begin + F32_BK - 1) / F32_BK : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // rows rg + 16 i, columns 4 cg .. 4 cg + 3; a warp spans 8 row groups
  // and 4 column groups
  const int rg = (warp & 1) * 8 + (lane >> 2);
  const int cg = (warp >> 1) * 4 + (lane & 3);

  float acc[F32_TM][F32_TN];
#pragma unroll
  for (int i = 0; i < F32_TM; ++i)
#pragma unroll
    for (int j = 0; j < F32_TN; ++j) acc[i][j] = 0.0f;

  // fill the ring: steps 0 .. STAGES - 2, one commit group each
#pragma unroll
  for (int s = 0; s < F32_STAGES - 1; ++s) {
    if (s < n_steps) {
      float* gs = ring + s * F32_STAGE_FLOATS;
      f32_stage<VEC16>(g, v, gs, gs + F32_G_FLOATS, m, k, k_end, nb, row0, col0,
                       k_begin + s * F32_BK);
    }
    cp_async_commit();
  }

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<F32_STAGES - 2>();   // this thread's copies of `step` have landed
    __syncthreads();                   // ... everyone's, and step - 1's reads are done
    const int next = step + F32_STAGES - 1;
    if (next < n_steps) {              // refill the slot that step - 1 used
      float* gs = ring + (next % F32_STAGES) * F32_STAGE_FLOATS;
      f32_stage<VEC16>(g, v, gs, gs + F32_G_FLOATS, m, k, k_end, nb, row0, col0,
                       k_begin + next * F32_BK);
    }
    cp_async_commit();                 // an empty group past the end keeps the count
    const float* gs = ring + (step % F32_STAGES) * F32_STAGE_FLOATS;
    const float* vs = gs + F32_G_FLOATS;
#pragma unroll
    for (int kk = 0; kk < F32_BK; kk += 4) {
      float4 a[F32_TM], b[4];
#pragma unroll
      for (int i = 0; i < F32_TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(gs + (rg + 16 * i) * F32_LDG + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(vs + (kk + j) * F32_BN + 4 * cg);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < F32_TM; ++i) {
          const float x = lane_of(a[i], j);
          acc[i][0] = fmaf(x, b[j].x, acc[i][0]);
          acc[i][1] = fmaf(x, b[j].y, acc[i][1]);
          acc[i][2] = fmaf(x, b[j].z, acc[i][2]);
          acc[i][3] = fmaf(x, b[j].w, acc[i][3]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // every warp is done with the ring

  // the cluster's partial tiles, added in rank order in the leader's ring
  float4* part = reinterpret_cast<float4*>(ring);
#pragma unroll
  for (int i = 0; i < F32_TM; ++i)
    part[i * F32_THREADS + threadIdx.x] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  if (!cluster_sum_rank_order(part, F32_TM * F32_THREADS)) return;
  const int c = col0 + 4 * cg;
#pragma unroll
  for (int i = 0; i < F32_TM; ++i) {
    const int r = row0 + rg + 16 * i;
    if (r >= m) continue;
    const float4 sum = part[i * F32_THREADS + threadIdx.x];
    float* dst = out + static_cast<size_t>(r) * nb + c;
    if constexpr (VEC16) {
      if (c < nb) *reinterpret_cast<float4*>(dst) = sum;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < nb) dst[e] = lane_of(sum, e);
    }
  }
}

template <bool VEC16>
int launch_f32(const float* g, const float* v, float* out, int m, int k, int nb, int ranks,
               cudaStream_t stream) {
  static std::atomic<bool> raised[MAX_DEVICES];
  cudaError_t err = allow_dynamic_smem(crosspoint_mvm_f32_kernel<VEC16>, F32_SMEM_BYTES, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  // each rank's range a whole number of k steps, so every rank but the
  // last starts and ends on the step grid (crosspoint_mvm.py:k_ranges)
  const int per_rank = (k + ranks - 1) / ranks;
  const int k_chunk = (per_rank + F32_BK - 1) / F32_BK * F32_BK;
  const dim3 grid(((m + F32_BM - 1) / F32_BM) * ranks, (nb + F32_BN - 1) / F32_BN);
  return static_cast<int>(launch_clustered(crosspoint_mvm_f32_kernel<VEC16>, grid, F32_THREADS,
                                           F32_SMEM_BYTES, ranks, stream, g, v, out, m, k,
                                           nb, k_chunk));
}

}  // namespace
}  // namespace repro_torch

// C interface (bound with ctypes).  g (m, k) and v (k, nb) are device
// pointers of contiguous tensors of one dtype (float32, or bfloat16 when
// is_bf16), out (m, nb) of the same dtype.  Each returns the CUDA error
// code of its launch (0 = success); an empty output launches nothing.
//
// The fma route, nb = 1 (the crossbar's GEMV): g (m, k), v (k), out (m).
// vec16 != 0 takes the 16-byte loads, which need k a multiple of 4
// (float32) or 8 (bf16) and g and v 16-byte aligned (gemv_variant decides).
extern "C" int repro_crosspoint_mvm(const void* g, const void* v, int is_bf16, void* out,
                                    int m, int k, int vec16, void* stream) {
  using namespace repro_torch;
  if (m == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vec16 ? launch_gemv<__nv_bfloat16, true>(g, v, out, m, k, s)
                 : launch_gemv<__nv_bfloat16, false>(g, v, out, m, k, s);
  return vec16 ? launch_gemv<float, true>(g, v, out, m, k, s)
               : launch_gemv<float, false>(g, v, out, m, k, s);
}

// The GEMV's split of m rows (common.cuh:gemv_plan, the plan of K6's fma
// route and K5's column route) into plan[0..3]: blocks, warps a block,
// rows of the largest block, rows of the busiest warp; and into plan[4]
// how many of its blocks the current device runs at once (float32, 16-byte
// variant: SMs x cudaOccupancyMaxActiveBlocksPerMultiprocessor).  len must
// be 5.  Returns the CUDA error code (0 = success).
extern "C" int repro_gemv_plan(int m, int* plan, int len) {
  using namespace repro_torch;
  if (m < 1 || len != 5) return static_cast<int>(cudaErrorInvalidValue);
  const GemvPlan p = gemv_plan(m);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crosspoint_mvm_kernel<float, true>,
                                                        32 * p.warps, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int out[5] = {p.blocks, p.warps, p.rows_per_block, p.rows_per_warp, sms * per_sm};
  for (int i = 0; i < 5; ++i) plan[i] = out[i];
  return 0;
}

// The float32 route, nb >= 2: k split over `ranks` blocks of a cluster (1
// <= ranks <= 4, crosspoint_mvm.py:crosspoint_mvm_split).  vec16 != 0
// takes the 16-byte asynchronous copies, which need k and nb multiples of
// 4 and g and v 16-byte aligned (crosspoint_mvm_route decides).
extern "C" int repro_crosspoint_mvm_f32(const void* g, const void* v, void* out, int m, int k,
                                        int nb, int ranks, int vec16, void* stream) {
  using namespace repro_torch;
  if (m == 0 || nb == 0) return 0;
  if (ranks < 1 || ranks > F32_MAX_SPLIT) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto gp = static_cast<const float*>(g);
  auto vp = static_cast<const float*>(v);
  auto op = static_cast<float*>(out);
  return vec16 ? launch_f32<true>(gp, vp, op, m, k, nb, ranks, s)
               : launch_f32<false>(gp, vp, op, m, k, nb, ranks, s);
}

// How many clusters of `ranks` blocks of the float32 route the current
// device runs at once (cudaOccupancyMaxActiveClusters), into *clusters;
// crosspoint_mvm.py:crosspoint_mvm_split keeps the grid within one such
// wave.  Returns the CUDA error code (0 = success).
extern "C" int repro_crosspoint_mvm_f32_clusters(int ranks, int* clusters) {
  using namespace repro_torch;
  static std::atomic<bool> raised[MAX_DEVICES];
  cudaError_t err = allow_dynamic_smem(crosspoint_mvm_f32_kernel<true>, F32_SMEM_BYTES, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(max_active_clusters(crosspoint_mvm_f32_kernel<true>, F32_THREADS,
                                              F32_SMEM_BYTES, ranks, clusters));
}

// The bf16 tensor-core route: g (m, k), v (k, nb), out (m, nb), device
// pointers of contiguous bfloat16 tensors, nb >= 2.  vec16 != 0 takes the
// 16-byte asynchronous copies, which need k and nb multiples of 8 and g
// and v 16-byte aligned (the wrapper's crosspoint_mvm_route decides).
// Returns the CUDA error code of the launch (0 = success); an empty
// output launches nothing.
extern "C" int repro_crosspoint_mvm_mma(const void* g, const void* v, void* out, int m, int k,
                                        int nb, int vec16, void* stream) {
  using namespace repro_torch;
  if (m == 0 || nb == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return vec16 ? launch_mma<true>(g, v, out, m, k, nb, s)
               : launch_mma<false>(g, v, out, m, k, nb, s);
}
