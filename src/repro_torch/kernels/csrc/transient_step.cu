// K3, K4 and K5: dense forward-Euler steps for Hopper (sm_90a).
//
// Replace the TPU kernels of src/repro/kernels/transient_step.py:
//   K3  transient_sweep_pallas         (_sweep_kernel)
//   K4  transient_step_batched_pallas  (_step_batched_kernel)
//   K5  transient_step_pallas          (_step_kernel), at the end of this file
//       (its column route, nb = 1, on common.cuh's GEMV)
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
// K3 (dense_sweep_kernel): one system per thread-block cluster, looping
//   over the n_steps inside the cluster, as the Pallas grid runs one
//   program per system with a fori_loop inside.  The operator comes
//   PRE-TRANSPOSED, mt[j][i] = M[i][j], as the reference passes it.  The
//   first port ran a block per system (B of 132 SMs busy), streamed the
//   whole operator through that SM every step, and walked all nz columns
//   in one dependent chain per thread over 4 rows (96 threads at nz =
//   384): 25.5 us a step.  Now system b runs on the R blocks of cluster b
//   (transient_step.py:dense_sweep_ranks, a pure function of nz), with
//   the skeleton of K1 (common.cuh: cluster_broadcast, cluster_step_barrier,
//   cluster_max):
//   * rank r owns the rows [r nz / R, (r + 1) nz / R) of M, the columns of
//     mt in that range for all j, one row a thread; each row is the
//     parent's chain, fmaf over j ascending and then z + dt (Mz + c), so
//     the bits are the first port's;
//   * RESIDENT (nz * nz / R floats fit beside the state): the rank copies
//     its rows of M into shared memory once per launch, four columns to a
//     float4 (stage_slab: 4-byte cp.async, by 16 warps so that enough
//     copies are in flight), and reads them from there every step, one
//     16-byte load per four columns; R is the smallest power of two that
//     fits (4 at the n = 48 case, nz = 384: 147,456 bytes of slab and
//     3,072 of state a rank; 8 at nz = 512 and 640);
//   * streamed (no R <= 16 fits, nz >= 1024): R = 16 and each row streams
//     its column of mt from L2/HBM every step, eight loads ahead of its
//     chain: latency-bound, which the routes never ask of it (K4 takes
//     nz >= 1024);
//   * every rank keeps the whole state, double-buffered; the new rows go
//     to every rank's next buffer through DSMEM, one cluster barrier a
//     step, the residual is combined in rank 0.
//   What bounds it now: the chain.  On an H100 a resident step takes 2.7
//   us at nz = 384, 3.1 at 512 and 3.7 at 640 (about 4 ns a column, past
//   the barrier and the broadcast), against 25.5 before; a launch with no
//   step, 15 us (the slab's copy and the launch); R = 8 or 16 instead of 4
//   take 4-8 % off, the shared-memory rate being no limit.  Splitting j
//   over threads would shorten the chain but change the order of the sum,
//   and with it the settle decisions, so the order stays the first port's.
// K4 (dense_step_kernel): one step of every system, a batched GEMV split
//   over k across a thread-block cluster.  At the settle sweep's shape,
//   (4, 2048, 2048), the operator is 67.1 MB, more than the 50 MB L2, so
//   every step reads it from HBM: 20.0 us at 3.35 TB/s.  Reaching that
//   rate takes two things a block per 128-row block (64 blocks) did not
//   give: enough blocks to fill 132 SMs and enough loads in flight on
//   each.  So
//   * each 128-row block's columns are split over the R ranks of a
//     cluster (transient_step.py:dense_step_ranks, a pure function of
//     (B, nz), capped to one wave: R = 2 at the main shape, 128 blocks,
//     since the card runs 62 clusters of 4 of these blocks at once and
//     R = 4 (64 clusters) took a second wave), rank r adding the column
//     chunks [r cpr, (r + 1) cpr) of 128 columns each;
//   * a block's 8 warps own 16 rows each; per column chunk a lane loads
//     z's float4 once into a register and then one float4 of each of its
//     warp's 16 rows, 16 independent 16-byte loads in flight per lane
//     (a warp reads 512 contiguous bytes of each row), and adds each row's
//     products in column order;
//   * the 16 rows' lane sums are reduced by shuffles into 128 row partials
//     in the block's shared memory, and the leader adds the ranks'
//     partials in rank order through distributed shared memory
//     (common.cuh:cluster_sum_rank_order): one launch, no workspace, no
//     atomics, the same bits from launch to launch.  The leader applies
//     z' = z + dt (acc + c), writes z' to a separate buffer (the wrapper
//     ping-pongs) and the block's max |dz| (NaN propagates, as jnp.max);
//     the wrapper takes the max over blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace repro_torch {
namespace {

// A resident K3 rank's slab holds its rows of M four columns to a float4,
// slab4[(j / 4) * rows + l] = M[row0 + l][j .. j + 3], so that a row reads
// four of its columns with one 16-byte load (the warp's lanes on
// consecutive rows: conflict-free).  Staged from the transposed operator
// by 4-byte asynchronous copies, each warp reading 128 contiguous bytes of
// one column of mt.
__device__ __forceinline__ void stage_slab(float* slab, const float* __restrict__ mt, int n,
                                           int rows, int row0) {
  for (int e = threadIdx.x; e < n * rows; e += blockDim.x) {
    const int j = e / rows, l = e - j * rows;
    cp_async4(slab + ((j >> 2) * rows + l) * 4 + (j & 3),
              mt + static_cast<size_t>(j) * n + row0 + l);
  }
}

// Row l of the rank's rows of M z, as one fmaf chain over j ascending (the
// first port's chain), from the resident slab, 32 columns at a time, the
// chunk's eight float4 of the row and of the state read ahead of its 32
// FMAs (of the loop shapes tried on an H100 -- 16 columns with the next
// 16 loaded ahead, 32 or 64 columns a chunk -- this one ran fastest).  n
// is a multiple of 128.
constexpr int DS_RES_CH = 8;   // float4 a chunk

__device__ __forceinline__ float dense_row_resident(const float4* slab4, const float* z, int n,
                                                    int rows, int l) {
  const float4* z4 = reinterpret_cast<const float4*>(z);
  const float4* p = slab4 + l;
  float acc = 0.0f;
  for (int j4 = 0; j4 < n / 4; j4 += DS_RES_CH) {
    float4 m[DS_RES_CH], zj[DS_RES_CH];
#pragma unroll
    for (int q = 0; q < DS_RES_CH; ++q) {
      m[q] = p[(j4 + q) * rows];
      zj[q] = z4[j4 + q];
    }
#pragma unroll
    for (int q = 0; q < DS_RES_CH; ++q) {
      acc = fmaf(m[q].x, zj[q].x, acc);
      acc = fmaf(m[q].y, zj[q].y, acc);
      acc = fmaf(m[q].z, zj[q].z, acc);
      acc = fmaf(m[q].w, zj[q].w, acc);
    }
  }
  return acc;
}

// Row i of M z from the transposed operator in global memory, mt[j * n + i]
// = M[i][j], the same chain; the next DS_CH values are loaded while the
// current ones are multiplied (n is a multiple of 128).
constexpr int DS_CH = 8;

__device__ __forceinline__ void dense_row_load(const float* __restrict__ col, int n, int j,
                                               float (&v)[DS_CH]) {
#pragma unroll
  for (int q = 0; q < DS_CH; ++q) v[q] = __ldg(col + static_cast<size_t>(j + q) * n);
}

__device__ __forceinline__ float dense_row_streamed(const float* __restrict__ mt,
                                                    const float* z, int n, int i) {
  const float* col = mt + i;
  float cur[DS_CH], nxt[DS_CH];
  dense_row_load(col, n, 0, cur);
  float acc = 0.0f;
  for (int j = 0; j < n; j += DS_CH) {
    if (j + DS_CH < n) dense_row_load(col, n, j + DS_CH, nxt);
    const float4 za = *reinterpret_cast<const float4*>(z + j);
    const float4 zb = *reinterpret_cast<const float4*>(z + j + 4);
    acc = fmaf(cur[0], za.x, acc);
    acc = fmaf(cur[1], za.y, acc);
    acc = fmaf(cur[2], za.z, acc);
    acc = fmaf(cur[3], za.w, acc);
    acc = fmaf(cur[4], zb.x, acc);
    acc = fmaf(cur[5], zb.y, acc);
    acc = fmaf(cur[6], zb.z, acc);
    acc = fmaf(cur[7], zb.w, acc);
#pragma unroll
    for (int q = 0; q < DS_CH; ++q) cur[q] = nxt[q];
  }
  return acc;
}

// Grid: B clusters of R blocks along x; dynamic shared memory: the state
// [2][n] float32 and, when RESIDENT, the rank's slab (n / 4 x rows float4).
template <bool RESIDENT>
__global__ void __launch_bounds__(RESIDENT ? 512 : 1024)
dense_sweep_kernel(const float* __restrict__ mt, const float* __restrict__ z0,
                   const float* __restrict__ c, float* __restrict__ z_out,
                   float* __restrict__ res, int n, int n_steps, float dt) {
  extern __shared__ __align__(16) float ds_smem[];
  __shared__ float scratch[32];
  __shared__ float rank_max[SWEEP_MAX_RANKS];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.x / ranks;
  const int rows = n / ranks;
  const int row0 = rank * rows;
  mt += b * n * n;
  z0 += b * n;
  c += b * n;
  z_out += b * n;

  float* cur = ds_smem;
  float* nxt = ds_smem + n;
  float* slab = ds_smem + 2 * n;
  const float4* slab4 = reinterpret_cast<const float4*>(slab);
  for (int i = threadIdx.x; i < n; i += blockDim.x) cur[i] = z0[i];
  if constexpr (RESIDENT) {
    stage_slab(slab, mt, n, rows, row0);
    cp_async_commit();
    cp_async_wait<0>();
  }
  // every block of the cluster has started and holds the state and its slab
  cluster.sync();

  for (int s = 0; s < n_steps; ++s) {
    for (int l = threadIdx.x; l < rows; l += blockDim.x) {
      const int i = row0 + l;
      float mz;
      if constexpr (RESIDENT)
        mz = dense_row_resident(slab4, cur, n, rows, l);
      else
        mz = dense_row_streamed(mt, cur, n, i);
      const float cc = __ldg(c + i);
      const float zz = cur[i];
      const float out = zz + dt * (mz + cc);
      cluster_broadcast(cluster, nxt, i, out);
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
    float mz;
    if constexpr (RESIDENT)
      mz = dense_row_resident(slab4, cur, n, rows, l);
    else
      mz = dense_row_streamed(mt, cur, n, i);
    m = nan_max(m, fabsf(mz + __ldg(c + i)));
    z_out[i] = cur[i];
  }
  m = cluster_max(cluster, m, scratch, rank_max);
  if (rank == 0 && threadIdx.x == 0) res[b] = m;
}

// Ready K3's kernel of this variant for clusters of `ranks` blocks (once
// per device); its threads and dynamic shared memory: the state, and a
// resident rank's slab
template <bool RESIDENT>
cudaError_t dense_sweep_setup(int n, int ranks, int* threads, int* smem) {
  static std::atomic<bool> raised[MAX_DEVICES];
  const size_t state = 2 * static_cast<size_t>(n) * sizeof(float);
  const size_t slab = static_cast<size_t>(n) * (n / ranks) * sizeof(float);
  // a resident rank owns at most 241 rows (n * n / R * 4 bytes fit a block),
  // too few warps to keep the slab's 4-byte copies in flight: 16 warps copy
  *threads = sweep_threads(n / ranks, RESIDENT ? 512 : 32);
  *smem = static_cast<int>(RESIDENT ? state + slab : state);
  return allow_sweep_clusters(dense_sweep_kernel<RESIDENT>, raised);
}

template <bool RESIDENT>
int launch_dense_sweep(const void* mt, const void* z, const void* c, void* z_out, void* res,
                       int batch, int n, int n_steps, float dt, int ranks,
                       cudaStream_t stream) {
  int threads = 0, smem = 0;
  cudaError_t err = dense_sweep_setup<RESIDENT>(n, ranks, &threads, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_sweep_clusters(
      dense_sweep_kernel<RESIDENT>, batch, threads, smem, ranks, stream,
      static_cast<const float*>(mt), static_cast<const float*>(z),
      static_cast<const float*>(c), static_cast<float*>(z_out), static_cast<float*>(res),
      n, n_steps, dt));
}

template <bool RESIDENT>
int dense_sweep_clusters(int n, int ranks, int* clusters) {
  int threads = 0, smem = 0;
  cudaError_t err = dense_sweep_setup<RESIDENT>(n, ranks, &threads, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      sweep_max_clusters(dense_sweep_kernel<RESIDENT>, threads, smem, ranks, clusters));
}

// ---------------------------------------------------------------------------
// K4: one dense step, columns split over a cluster
// ---------------------------------------------------------------------------

constexpr int DS_THREADS = 256;                               // 8 warps
constexpr int DS_ROWS = ROW_BLOCK / (DS_THREADS / 32);        // 16 rows a warp
constexpr int DS_CHUNK = 128;                                 // columns: a float4 a lane
constexpr int DS_MAX_SPLIT = 8;                               // blocks per cluster

// Grid: (nz / 128 x R, B), in clusters of R blocks along x; rank r adds
// the column chunks [r cpr, min((r + 1) cpr, nz / 128)).
__global__ void __launch_bounds__(DS_THREADS, 2)
dense_step_kernel(const float* __restrict__ m, const float* __restrict__ z,
                  const float* __restrict__ c, float* __restrict__ z_out,
                  float* __restrict__ res, int n, float dt, int cpr) {
  __shared__ float4 part4[ROW_BLOCK / 4];
  __shared__ float scratch[32];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int blk = blockIdx.x / ranks;
  const size_t b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = n / DS_CHUNK;
  const int c_begin = rank * cpr;
  const int c_end = min(chunks, c_begin + cpr);
  m += b * n * n;
  z += b * n;
  c += b * n;
  z_out += b * n;
  float* part = reinterpret_cast<float*>(part4);

  // this warp's 16 rows, each lane on its float4 of every chunk
  const size_t row_f4 = static_cast<size_t>(n) / 4;
  const float4* rows = reinterpret_cast<const float4*>(m) +
                       static_cast<size_t>(blk * ROW_BLOCK + warp * DS_ROWS) * row_f4 + lane;
  const float4* z4 = reinterpret_cast<const float4*>(z) + lane;
  float acc[DS_ROWS];
#pragma unroll
  for (int r = 0; r < DS_ROWS; ++r) acc[r] = 0.0f;
  for (int ch = c_begin; ch < c_end; ++ch) {
    const float4 zv = __ldg(z4 + ch * 32);
    float4 mv[DS_ROWS];
#pragma unroll
    for (int r = 0; r < DS_ROWS; ++r) mv[r] = __ldg(rows + r * row_f4 + ch * 32);
#pragma unroll
    for (int r = 0; r < DS_ROWS; ++r) {
      acc[r] = fmaf(mv[r].x, zv.x, acc[r]);
      acc[r] = fmaf(mv[r].y, zv.y, acc[r]);
      acc[r] = fmaf(mv[r].z, zv.z, acc[r]);
      acc[r] = fmaf(mv[r].w, zv.w, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < DS_ROWS; ++r) {
    const float s = warp_sum(acc[r]);
    if (lane == 0) part[warp * DS_ROWS + r] = s;
  }
  if (!cluster_sum_rank_order(part4, ROW_BLOCK / 4)) return;

  float row_max = 0.0f;
  if (threadIdx.x < ROW_BLOCK) {
    const int i = blk * ROW_BLOCK + threadIdx.x;
    const float dz = part[threadIdx.x] + __ldg(c + i);
    z_out[i] = z[i] + dt * dz;
    row_max = fabsf(dz);
  }
  const float mx = block_max(row_max, scratch);
  if (threadIdx.x == 0) res[b * chunks + blk] = mx;
}

// ---------------------------------------------------------------------------
// K5 on narrow state, 2 <= nb <= 16: split-k over a cluster
// ---------------------------------------------------------------------------
//
// Z' = Z + dt (M Z + C) for one operator M (n, n) and Z, C (n, nb), float32
// or bfloat16, a float32 accumulator, the output in Z's dtype; any n and
// nb, masked, never padded.  At the kernel API's shape (8192^2, nb = 16,
// float32) it is bound by bytes: M is 268 MB, 80.1 us at 3.35 TB/s, while
// its 2.15 GFLOP take 32 us at the 67 TFLOP/s FP32 rate.  The design:
// * a tile is NS_BM = 128 rows by all (up to 16) columns; k is split over
//   the R ranks of a cluster (transient_step.py:transient_step_split, a
//   pure function of the shape, capped to one wave: R = 2 at n = 8192, 128
//   blocks, one per SM, as the card runs 62 clusters of 4 of these blocks
//   at once), each rank's range a whole number of 64-deep steps
//   (narrow_k_ranges);
// * M's tile and Z's k-slab stream through a ring of NS_STAGES = 4
//   shared-memory stages (three 18 KB stages in flight), by 16-byte
//   cp.async copies (the VEC16 variant) or masked scalar loads (ragged n
//   or nb, unaligned bases); a stage holds
//   128 bytes of each of 128 rows of M (32 float32 or 64 bf16 k, rows
//   padded by 16 bytes) and the same k of Z (16 columns, zero past nb);
// * warp w adds the k slice [16 w, 16 w + 16) bytes of each stage, lane l
//   rows l + 32 i (i < 4) for all 16 columns: per k a lane reads one M
//   value of each of its 4 rows (a 16-byte read per row per stage, free of
//   bank conflicts at the 144-byte row stride) and Z's 16 values
//   (a broadcast: every lane of the warp reads the same row), then does 64
//   FMAs: each M value read serves all 16 columns and each Z value 4 rows;
// * the 8 warps' partial tiles are added in warp order in shared memory,
//   then the ranks' in rank order through distributed shared memory
//   (cluster_sum_rank_order), and the leader applies the step, rounding
//   z + dt (acc + c) step by step as the plain version does.
// The bf16 operands run the same schedule on FMA (converted to float32 as
// they are read from shared memory).  What holds it near three quarters
// of the HBM rate is the per-step work of one block's 8 warps on its SM
// (a barrier, 20 shared-memory reads and 256 FMAs a thread per step), not
// bytes in flight: a ring of 6-10 stages ran no faster, and 16 warps on
// 256-row tiles (one block per SM, R = 4) ran slower.  The masked-load
// variant stages element by element and runs several times slower; it
// serves only ragged or unaligned operands.

constexpr int NS_THREADS = 256;
constexpr int NS_WARPS = NS_THREADS / 32;
constexpr int NS_BM = 128, NS_BN = 16;
constexpr int NS_TM = NS_BM / 32;                 // rows a lane: l + 32 i
constexpr int NS_STAGES = 4;
constexpr int NS_ROW_BYTES = 128;                 // a stage's bytes of one M row
constexpr int NS_LDM = NS_ROW_BYTES + 16;         // M tile row stride in bytes
constexpr int NS_M_BYTES = NS_BM * NS_LDM;
constexpr int NS_Z_BYTES = NS_ROW_BYTES * NS_BN;  // BK rows of 16 columns
constexpr int NS_STAGE_BYTES = NS_M_BYTES + NS_Z_BYTES;
constexpr int NS_SMEM_BYTES = NS_STAGES * NS_STAGE_BYTES;
constexpr int NS_MAX_SPLIT = 8;
static_assert(NS_WARPS * NS_BM * NS_BN * 4 <= NS_SMEM_BYTES,
              "the warps' partial tiles must fit the ring");

// 16 bytes of T read from shared memory, and element j of them as float32
template <typename T> struct Chunk16;
template <> struct Chunk16<float> {
  using raw = float4;
  static constexpr int N = 4;
  __device__ static float get(const float4& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
};
template <> struct Chunk16<__nv_bfloat16> {
  using raw = uint4;
  static constexpr int N = 8;
  __device__ static float get(const uint4& v, int j) {
    const unsigned w = j < 2 ? v.x : j < 4 ? v.y : j < 6 ? v.z : v.w;
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

__device__ __forceinline__ void zero_as(float* p) { *p = 0.0f; }
__device__ __forceinline__ void zero_as(__nv_bfloat16* p) {
  *reinterpret_cast<unsigned short*>(p) = 0;
}

// Stage the k step at k0 of this rank's range [.., k_end): M rows [row0,
// row0 + 128) x [k0, k0 + BK) and Z rows [k0, k0 + BK) x [0, 16), zero
// outside.  VEC16: 16-byte asynchronous copies (n and nb multiples of 16
// bytes' worth of T, aligned bases, k0 on the step grid, so every chunk
// lies wholly inside or outside); otherwise masked scalar loads.
template <typename T, bool VEC16>
__device__ __forceinline__ void narrow_stage(const T* __restrict__ m, const T* __restrict__ z,
                                             unsigned char* stage, int n, int nb, int k_end,
                                             int row0, int k0) {
  constexpr int BK = NS_ROW_BYTES / sizeof(T);
  constexpr int EPC = 16 / sizeof(T);             // elements of a 16-byte chunk
  const int t = threadIdx.x;
  unsigned char* ms = stage;
  unsigned char* zs = stage + NS_M_BYTES;
  if constexpr (VEC16) {
#pragma unroll
    for (int i = 0; i < NS_BM * (NS_ROW_BYTES / 16) / NS_THREADS; ++i) {
      const int ch = t + i * NS_THREADS;
      const int r = ch / (NS_ROW_BYTES / 16), cc = ch % (NS_ROW_BYTES / 16);
      const int k = k0 + cc * EPC;
      const bool ok = row0 + r < n && k < k_end;
      cp_async16(ms + r * NS_LDM + cc * 16,
                 ok ? m + static_cast<size_t>(row0 + r) * n + k : m, ok ? 16 : 0);
    }
    constexpr int ZCH = NS_BN * sizeof(T) / 16;   // 16-byte chunks of a Z row
    if (t < BK * ZCH) {
      const int r = t / ZCH, q = t % ZCH;
      const bool ok = k0 + r < k_end && q * EPC < nb;
      cp_async16(zs + r * NS_BN * sizeof(T) + q * 16,
                 ok ? z + static_cast<size_t>(k0 + r) * nb + q * EPC : z, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < NS_BM * BK / NS_THREADS; ++i) {
      const int e = t + i * NS_THREADS;
      const int r = e / BK, kk = e % BK;
      T* dst = reinterpret_cast<T*>(ms + r * NS_LDM) + kk;
      if (row0 + r < n && k0 + kk < k_end)
        *dst = m[static_cast<size_t>(row0 + r) * n + k0 + kk];
      else
        zero_as(dst);
    }
#pragma unroll
    for (int i = 0; i < BK * NS_BN / NS_THREADS; ++i) {
      const int e = t + i * NS_THREADS;
      const int r = e / NS_BN, q = e % NS_BN;
      T* dst = reinterpret_cast<T*>(zs) + e;
      if (k0 + r < k_end && q < nb)
        *dst = z[static_cast<size_t>(k0 + r) * nb + q];
      else
        zero_as(dst);
    }
  }
}

// Grid: (row tiles x R), in clusters of R blocks along x; rank r adds k in
// [r k_chunk, min(n, (r + 1) k_chunk)).
template <typename T, bool VEC16>
__global__ void __launch_bounds__(NS_THREADS, 2)
narrow_step_kernel(const T* __restrict__ m, const T* __restrict__ z,
                   const T* __restrict__ c, T* __restrict__ z_out, int n, int nb, float dt,
                   int k_chunk) {
  using V = Chunk16<T>;
  constexpr int BK = NS_ROW_BYTES / sizeof(T);
  constexpr int KW = V::N;                        // k a warp adds per stage
  constexpr int ZV = NS_BN / V::N;                // 16-byte reads of a Z row
  extern __shared__ __align__(128) unsigned char ns_smem[];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / ranks) * NS_BM;
  const int k_begin = min(n, rank * k_chunk);
  const int k_end = min(n, k_begin + k_chunk);
  const int n_steps = (k_end - k_begin + BK - 1) / BK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float acc[NS_TM][NS_BN];
#pragma unroll
  for (int i = 0; i < NS_TM; ++i)
#pragma unroll
    for (int q = 0; q < NS_BN; ++q) acc[i][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < NS_STAGES - 1; ++s) {
    if (s < n_steps)
      narrow_stage<T, VEC16>(m, z, ns_smem + s * NS_STAGE_BYTES, n, nb, k_end, row0,
                             k_begin + s * BK);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<NS_STAGES - 2>();   // this thread's copies of `step` have landed
    __syncthreads();                  // ... everyone's, and step - 1's reads are done
    const int next = step + NS_STAGES - 1;
    if (next < n_steps)
      narrow_stage<T, VEC16>(m, z, ns_smem + (next % NS_STAGES) * NS_STAGE_BYTES, n, nb,
                             k_end, row0, k_begin + next * BK);
    cp_async_commit();
    const unsigned char* ms = ns_smem + (step % NS_STAGES) * NS_STAGE_BYTES;
    const typename V::raw* zs =
        reinterpret_cast<const typename V::raw*>(ms + NS_M_BYTES) + warp * KW * ZV;
    typename V::raw mv[NS_TM];
#pragma unroll
    for (int i = 0; i < NS_TM; ++i)
      mv[i] = *reinterpret_cast<const typename V::raw*>(ms + (lane + 32 * i) * NS_LDM +
                                                        warp * 16);
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      float zv[NS_BN];
#pragma unroll
      for (int u = 0; u < ZV; ++u) {
        const typename V::raw w = zs[j * ZV + u];
#pragma unroll
        for (int e = 0; e < V::N; ++e) zv[u * V::N + e] = V::get(w, e);
      }
#pragma unroll
      for (int i = 0; i < NS_TM; ++i) {
        const float x = V::get(mv[i], j);
#pragma unroll
        for (int q = 0; q < NS_BN; ++q) acc[i][q] = fmaf(x, zv[q], acc[i][q]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                    // every warp is done with the ring

  // the warps' partial tiles, added in warp order into warp 0's
  float4* part = reinterpret_cast<float4*>(ns_smem);
  constexpr int TILE4 = NS_BM * NS_BN / 4;
#pragma unroll
  for (int i = 0; i < NS_TM; ++i)
#pragma unroll
    for (int q = 0; q < NS_BN / 4; ++q)
      part[warp * TILE4 + (lane + 32 * i) * (NS_BN / 4) + q] =
          make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
  __syncthreads();
  for (int e = threadIdx.x; e < TILE4; e += NS_THREADS) {
    float4 s = part[e];
#pragma unroll
    for (int w = 1; w < NS_WARPS; ++w) {
      const float4 p = part[w * TILE4 + e];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    part[e] = s;
  }
  // ... then the ranks' in rank order, in the leader
  if (!cluster_sum_rank_order(part, TILE4)) return;
  const float* tile = reinterpret_cast<const float*>(part);
  for (int e = threadIdx.x; e < NS_BM * NS_BN; e += NS_THREADS) {
    const int r = row0 + e / NS_BN, q = e % NS_BN;
    if (r >= n || q >= nb) continue;
    const size_t o = static_cast<size_t>(r) * nb + q;
    const float dz = __fadd_rn(tile[e], to_f32(c[o]));
    store_as(z_out + o, __fadd_rn(to_f32(z[o]), __fmul_rn(dt, dz)));
  }
}

template <typename T, bool VEC16>
int launch_narrow(const void* m, const void* z, const void* c, void* z_out, int n, int nb,
                  int ranks, float dt, cudaStream_t stream) {
  static std::atomic<bool> raised[MAX_DEVICES];
  constexpr int GRID_K = 64;          // rank ranges start on this grid (both BKs divide it)
  cudaError_t err = allow_dynamic_smem(narrow_step_kernel<T, VEC16>, NS_SMEM_BYTES, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_rank = (n + ranks - 1) / ranks;
  const int k_chunk = (per_rank + GRID_K - 1) / GRID_K * GRID_K;
  const dim3 grid(((n + NS_BM - 1) / NS_BM) * ranks);
  return static_cast<int>(launch_clustered(
      narrow_step_kernel<T, VEC16>, grid, NS_THREADS, NS_SMEM_BYTES, ranks, stream,
      static_cast<const T*>(m), static_cast<const T*>(z), static_cast<const T*>(c),
      static_cast<T*>(z_out), n, nb, dt, k_chunk));
}

// K5 on more than 16 columns (ProdWide): K6's old tiled product of
// common.cuh with the step as its epilogue.  Z is read twice, as the
// contraction operand and in the epilogue, and the result goes to a
// separate buffer, as the Pallas kernel passes Z twice and writes a new
// array.  The epilogue rounds z + dt * (acc + c) step by step, as the
// plain version does.  Ragged n and nb are masked.  Bound by float32
// operations past nb ~ 40.
template <typename C, typename T>
__global__ void __launch_bounds__(256)
transient_step_kernel(const T* __restrict__ m, const T* __restrict__ z,
                      const T* __restrict__ c, T* __restrict__ z_out, int n, int nb,
                      float dt) {
  const int row0 = blockIdx.x * C::BM;
  const int col0 = blockIdx.y * C::BN;
  float acc[C::TM][C::TN];
  int pr, pc;
  tile_product<C>(m, z, n, n, nb, row0, col0, acc, pr, pc);
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

// K5 on one column (the "column" route): one Euler step of one circuit,
// bound by bytes (M read once: 268 MB of float32 at n = 8192, 80 us).
// It used to be the tiled product above with 32 x 1 tiles (84 % of the
// HBM rate: G staged through shared memory by scalar loads, two barriers
// a step).  Now it is common.cuh's gemv_rows, K6's fma route with this
// epilogue: M streams from HBM into registers in 16-byte loads with no
// barrier, z through the read-only path, one wave of balanced row ranges
// (gemv_plan), the sum in a fixed order (kernels/gemv.py:
// gemv_in_kernel_order).  The epilogue reads z and c at the row and writes
// z + dt * (acc + c), rounded step by step as the plain version rounds it,
// to a separate buffer.
template <typename T>
struct StepRow {
  const T* z;
  const T* c;
  T* z_out;
  float dt;
  __device__ void operator()(int r, float acc) const {
    const float dz = __fadd_rn(acc, to_f32(c[r]));
    store_as(z_out + r, __fadd_rn(to_f32(z[r]), __fmul_rn(dt, dz)));
  }
};

template <typename T, bool VEC16>
__global__ void __launch_bounds__(GEMV_THREADS)
transient_step_column_kernel(const T* __restrict__ m, const T* __restrict__ z,
                             const T* __restrict__ c, T* __restrict__ z_out, int n, float dt) {
  gemv_rows<T, VEC16, GEMV_ROWS, GEMV_UNROLL, GEMV_PIPE>(m, z, n, n,
                                                         StepRow<T>{z, c, z_out, dt});
}

template <typename T, bool VEC16>
int launch_column(const void* m, const void* z, const void* c, void* z_out, int n, float dt,
                  cudaStream_t stream) {
  const GemvPlan plan = gemv_plan(n);
  transient_step_column_kernel<T, VEC16><<<plan.blocks, 32 * plan.warps, 0, stream>>>(
      static_cast<const T*>(m), static_cast<const T*>(z), static_cast<const T*>(c),
      static_cast<T*>(z_out), n, dt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// C interface (bound with ctypes).  Pointers are device pointers of
// contiguous tensors; each entry returns the CUDA error code of its launch
// (0 = success).
//
// K5 on the column (nb = 1) and wide (nb > 16) routes: m (n, n),
// z/c/z_out (n, nb), one dtype (float32, or bfloat16 when is_bf16); any n.
// An empty state launches nothing; 2 <= nb <= 16 is the narrow route's.
// On the column route vec16 != 0 takes the GEMV's 16-byte loads, which
// need n a multiple of 4 (float32) or 8 (bf16) and m and z 16-byte aligned
// (kernels/gemv.py:gemv_variant decides); the wide route ignores it.
extern "C" int repro_transient_step(const void* m, const void* z, const void* c,
                                    int is_bf16, void* z_out, int n, int nb, int vec16,
                                    float dt, void* stream) {
  using namespace repro_torch;
  if (n == 0 || nb == 0) return 0;
  if (nb >= 2 && nb <= NS_BN) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (nb == 1) {
    if (is_bf16)
      return vec16 ? launch_column<__nv_bfloat16, true>(m, z, c, z_out, n, dt, s)
                   : launch_column<__nv_bfloat16, false>(m, z, c, z_out, n, dt, s);
    return vec16 ? launch_column<float, true>(m, z, c, z_out, n, dt, s)
                 : launch_column<float, false>(m, z, c, z_out, n, dt, s);
  }
  return is_bf16 ? launch_step<ProdWide, __nv_bfloat16>(m, z, c, z_out, n, nb, dt, s)
                 : launch_step<ProdWide, float>(m, z, c, z_out, n, nb, dt, s);
}

// K5 on the narrow route, 2 <= nb <= 16: k split over `ranks` blocks of a
// cluster (1 <= ranks <= 8, transient_step.py:transient_step_split).
// vec16 != 0 takes the 16-byte asynchronous copies, which need n and nb
// multiples of 4 (float32) or 8 (bf16) and m and z 16-byte aligned
// (transient_step_route decides).
extern "C" int repro_transient_step_narrow(const void* m, const void* z, const void* c,
                                           int is_bf16, void* z_out, int n, int nb,
                                           int ranks, int vec16, float dt, void* stream) {
  using namespace repro_torch;
  if (n == 0) return 0;
  if (nb < 2 || nb > NS_BN || ranks < 1 || ranks > NS_MAX_SPLIT)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vec16 ? launch_narrow<__nv_bfloat16, true>(m, z, c, z_out, n, nb, ranks, dt, s)
                 : launch_narrow<__nv_bfloat16, false>(m, z, c, z_out, n, nb, ranks, dt, s);
  return vec16 ? launch_narrow<float, true>(m, z, c, z_out, n, nb, ranks, dt, s)
               : launch_narrow<float, false>(m, z, c, z_out, n, nb, ranks, dt, s);
}

// How many clusters of `ranks` blocks of the narrow route (float32, 16-byte
// copies) the current device runs at once (cudaOccupancyMaxActiveClusters),
// into *clusters: transient_step_split keeps the grid within one wave.
extern "C" int repro_transient_step_narrow_clusters(int ranks, int* clusters) {
  using namespace repro_torch;
  static std::atomic<bool> raised[MAX_DEVICES];
  cudaError_t err = allow_dynamic_smem(narrow_step_kernel<float, true>, NS_SMEM_BYTES, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(max_active_clusters(narrow_step_kernel<float, true>, NS_THREADS,
                                              NS_SMEM_BYTES, ranks, clusters));
}

// C interface of K3 and K4 (bound with ctypes).  Pointers are device pointers of
// contiguous float32 tensors, 16-byte aligned; n is a multiple of 128.  Each returns the
// CUDA error code of its launch (0 = success).
//
// K3 on `ranks` blocks a system (1, 2, 4, 8 or 16), its slab resident in
// shared memory when `resident` (transient_step.py:dense_sweep_ranks and
// dense_sweep_variant decide).  A cluster the device cannot place returns
// an error and launches nothing.
extern "C" int repro_dense_sweep(const void* mt, const void* z, const void* c,
                                 void* z_out, void* res, int batch, int n,
                                 int n_steps, float dt, int ranks, int resident,
                                 void* stream) {
  using namespace repro_torch;
  if (batch == 0) return 0;
  if (!sweep_ranks_valid(n, ranks)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return resident ? launch_dense_sweep<true>(mt, z, c, z_out, res, batch, n, n_steps, dt,
                                             ranks, s)
                  : launch_dense_sweep<false>(mt, z, c, z_out, res, batch, n, n_steps, dt,
                                              ranks, s);
}

// How many K3 clusters of `ranks` blocks at n states of this variant the
// current device runs at once (cudaOccupancyMaxActiveClusters), into
// *clusters; 0 means the device cannot place one and repro_dense_sweep
// would refuse the launch.
extern "C" int repro_dense_sweep_clusters(int n, int ranks, int resident, int* clusters) {
  using namespace repro_torch;
  if (!sweep_ranks_valid(n, ranks)) return static_cast<int>(cudaErrorInvalidValue);
  return resident ? dense_sweep_clusters<true>(n, ranks, clusters)
                  : dense_sweep_clusters<false>(n, ranks, clusters);
}

// K4: the columns of each 128-row block split over `ranks` blocks of a
// cluster (1 <= ranks <= 8, transient_step.py:dense_step_ranks).
extern "C" int repro_dense_step(const void* m, const void* z, const void* c,
                                void* z_out, void* res, int batch, int n, int ranks,
                                float dt, void* stream) {
  using namespace repro_torch;
  if (batch == 0 || n == 0) return 0;
  if (ranks < 1 || ranks > DS_MAX_SPLIT) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = n / DS_CHUNK;
  const int cpr = (chunks + ranks - 1) / ranks;
  const dim3 grid((n / ROW_BLOCK) * ranks, batch);
  return static_cast<int>(launch_clustered(
      dense_step_kernel, grid, DS_THREADS, 0, ranks, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(m), static_cast<const float*>(z),
      static_cast<const float*>(c), static_cast<float*>(z_out), static_cast<float*>(res),
      n, dt, cpr));
}

// How many clusters of `ranks` K4 blocks the current device runs at once,
// into *clusters: dense_step_ranks keeps the grid within one wave.
extern "C" int repro_dense_step_clusters(int ranks, int* clusters) {
  using namespace repro_torch;
  return static_cast<int>(max_active_clusters(dense_step_kernel, DS_THREADS, 0, ranks,
                                              clusters));
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
