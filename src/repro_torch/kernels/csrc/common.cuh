// Device helpers shared by the Hopper kernels: the reductions of the
// settle sweeps (K1-K4), the tiled dense product of K5 (b > 16), the GEMV
// of K5 and K6 (b = 1), the
// rank-ordered sum over a thread-block cluster (K4, K5 on narrow state,
// K6 float32, K7a; spread over the ranks, K8's float32 dK/dV), and the
// state shared across a cluster by the persistent sweeps (K1, K3).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <atomic>

#include "mma_bf16.cuh"

namespace repro_torch {

// ---------------------------------------------------------------------------
// Split reductions across the blocks of a thread-block cluster
// ---------------------------------------------------------------------------
//
// A reduction split over R blocks (R <= 8, the portable cluster size) is
// summed in one launch, with no workspace and no atomics: each block of
// the cluster leaves its float32 partial tile in its own shared memory,
// and the leader (rank 0) reads its peers' tiles through distributed
// shared memory (DSMEM) and adds them in rank order,
//   ((p_0 + p_1) + p_2) + ... + p_{R-1},
// so two launches on the same input give the same bits.
//
// `part` holds n float4 at the same shared-memory offset in every block
// of the cluster, written by the calling block before the call.  On
// return the leader's `part` holds the rank-ordered sum, visible to all
// of its threads; the call returns true in the leader only.  Every thread
// of every block of the cluster must call it.  The first cluster barrier
// publishes the partials (it orders every thread's shared-memory writes
// before the peers' reads); the second keeps each block, and with it its
// shared memory, alive until the leader has read it.
__device__ __forceinline__ bool cluster_sum_rank_order(float4* part, int n) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  const bool leader = cluster.block_rank() == 0;
  if (leader) {
    const unsigned ranks = cluster.num_blocks();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float4 s = part[i];
      for (unsigned r = 1; r < ranks; ++r) {
        const float4 p = cluster.map_shared_rank(part, r)[i];
        s.x += p.x;
        s.y += p.y;
        s.z += p.z;
        s.w += p.w;
      }
      part[i] = s;
    }
  }
  cluster.sync();
  return leader;
}

// The same sum spread over the cluster: block r adds the float4s
// [r n / R, (r + 1) n / R) of every block's `part` in rank order,
// ((p_0 + p_1) + p_2) + ..., and hands each sum to store(i, sum), so that
// the R blocks add and store in parallel instead of the leader alone; each
// sum has the bits cluster_sum_rank_order gives it.  Every thread of every
// block of the cluster must call it; the second cluster barrier keeps each
// block, and with it its shared memory, alive until its peers have read it.
template <typename Store>
__device__ __forceinline__ void cluster_sum_rank_order_spread(float4* part, int n, Store store) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int i1 = static_cast<int>(static_cast<long long>(n) * (rank + 1) / ranks);
  for (int i = static_cast<int>(static_cast<long long>(n) * rank / ranks) + threadIdx.x; i < i1;
       i += blockDim.x) {
    float4 s = cluster.map_shared_rank(part, 0)[i];
    for (int r = 1; r < ranks; ++r) {
      const float4 p = cluster.map_shared_rank(part, r)[i];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    store(i, s);
  }
  cluster.sync();
}

// The launch configuration of `grid` x `threads` in clusters of `ranks`
// blocks along x; `attr` holds its one attribute and must outlive it.
inline cudaLaunchConfig_t cluster_config(dim3 grid, int threads, int smem_bytes, int ranks,
                                         cudaStream_t stream, cudaLaunchAttribute (&attr)[1]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch `kernel` on `grid` x `block` threads in clusters of `ranks`
// blocks along x (gridDim.x must be a multiple of ranks); returns the
// launch's error or cudaGetLastError().  A launch the card refuses (a
// cluster that does not fit) returns its error: there is no fallback.
template <typename... Params, typename... Args>
inline cudaError_t launch_clustered(void (*kernel)(Params...), dim3 grid, int threads,
                                    int smem_bytes, int ranks, cudaStream_t stream,
                                    Args... args) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(grid, threads, smem_bytes, ranks, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of `ranks` blocks of `kernel` (`threads` threads and
// `smem_bytes` of dynamic shared memory each) the current device runs at
// once, into *clusters (cudaOccupancyMaxActiveClusters): a grid of more
// clusters runs in more than one wave.  The kernel's dynamic shared-memory
// limit must already allow smem_bytes.
template <typename... Params>
inline cudaError_t max_active_clusters(void (*kernel)(Params...), int threads, int smem_bytes,
                                       int ranks, int* clusters) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(dim3(ranks), threads, smem_bytes, ranks,
                                                nullptr, attr);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// Row-block height of the row-tiled kernels (K2, K4): one thread block
// (K4: one cluster) covers ROW_BLOCK rows and writes one max partial, the (B, nz / 128)
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

// ---------------------------------------------------------------------------
// One system per cluster: the persistent sweeps (K1, K3)
// ---------------------------------------------------------------------------
//
// A persistent sweep runs n_steps Euler steps of one system on the R
// blocks of a cluster (R <= SWEEP_MAX_RANKS, a power of two): rank r owns
// the rows [r nz / R, (r + 1) nz / R), and every rank keeps the whole
// state in its shared memory, double-buffered, since each row reads all
// of it.  A step computes the rank's rows from `cur` and stores each new
// value into `nxt` of every rank (cluster_broadcast); one barrier
// (cluster_step_barrier) then publishes the stores and keeps a fast rank
// from writing a buffer that a slow peer still reads.
constexpr int SWEEP_MAX_RANKS = 16;   // past the portable 8: H100 allows 16

// Store v at element i of `buf` in every block of the cluster (`buf` at
// the same shared-memory offset in each), this block's own first and the
// peers from the next rank on, so that the ranks' stores spread over the
// cluster instead of all reaching rank 0 first.
__device__ __forceinline__ void cluster_broadcast(cooperative_groups::cluster_group& cluster,
                                                  float* buf, int i, float v) {
  const unsigned ranks = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  buf[i] = v;
  for (unsigned d = 1; d < ranks; ++d) {
    const unsigned r = rank + d < ranks ? rank + d : rank + d - ranks;
    cluster.map_shared_rank(buf, r)[i] = v;
  }
}

// The one barrier of a step: every thread of every block of the cluster
// arrives (release) and waits (acquire), so each rank's stores of the
// step, local and remote, are visible to all ranks after it.
__device__ __forceinline__ void cluster_step_barrier(cooperative_groups::cluster_group& cluster) {
  cluster.sync();
}

// Max over the cluster of each thread's non-negative `v` (NaN propagates,
// as jnp.max): block_max in every block, each block's max stored into the
// leader's `rank_max` (SWEEP_MAX_RANKS floats, same offset in every block)
// through DSMEM, one cluster barrier, and the leader combines them in rank
// order (max is order-free).  The result is valid in thread 0 of rank 0.
// No block touches a peer's shared memory after the barrier, so every
// block may exit after the call.  Every thread of the cluster must call it.
__device__ __forceinline__ float cluster_max(cooperative_groups::cluster_group& cluster, float v,
                                             float* scratch, float* rank_max) {
  const unsigned rank = cluster.block_rank();
  v = block_max(v, scratch);
  if (threadIdx.x == 0) cluster.map_shared_rank(rank_max, 0)[rank] = v;
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    const unsigned ranks = cluster.num_blocks();
    for (unsigned r = 0; r < ranks; ++r) v = nan_max(v, rank_max[r]);
  }
  return v;
}

// 4-byte copy global -> shared, asynchronous (cp.async.ca), for gathers
// that 16-byte copies cannot express; committed and awaited as cp_async16.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// Copy `n_rows` rows of `row_bytes` each, `src_stride` bytes apart in
// global memory, into contiguous shared memory at `dst`, by 16-byte
// asynchronous copies spread over the block's threads (row_bytes,
// src_stride and both bases multiples of 16).  The caller commits and
// waits (cp_async_commit, cp_async_wait<0>) and then synchronises.
__device__ __forceinline__ void stage_rows(void* dst, const void* src, int n_rows,
                                           int row_bytes, size_t src_stride) {
  const int chunks = row_bytes / 16;
  for (int e = threadIdx.x; e < n_rows * chunks; e += blockDim.x) {
    const int r = e / chunks, q = e - r * chunks;
    cp_async16(static_cast<unsigned char*>(dst) + static_cast<size_t>(r) * row_bytes + q * 16,
               static_cast<const unsigned char*>(src) + r * src_stride + q * 16, 16);
  }
}

// Whether `ranks` blocks can share a persistent sweep of n rows: a power
// of two up to SWEEP_MAX_RANKS whose ranks own whole rows, a multiple of 8
// each (16-byte copies of a float32, int32 or bf16 row slice)
inline bool sweep_ranks_valid(int n, int ranks) {
  return ranks >= 1 && ranks <= SWEEP_MAX_RANKS && (ranks & (ranks - 1)) == 0 &&
         n % (8 * ranks) == 0;
}

// Threads of a persistent-sweep block whose rank owns `rows` rows: a
// thread per row, whole warps, at least `least` (threads past the rows
// only help copy the operator in) and at most 1024.
inline int sweep_threads(int rows, int least = 32) {
  int t = (rows + 31) / 32 * 32;
  t = t > least ? t : least;
  return t < 1024 ? t : 1024;
}

// Let a persistent sweep take clusters of up to 16 blocks and as much
// dynamic shared memory as the device gives a block beside the kernel's
// static arrays, once per device (see allow_dynamic_smem).
template <typename Kernel>
inline cudaError_t allow_sweep_clusters(Kernel kernel, std::atomic<bool> (&raised)[MAX_DEVICES]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < MAX_DEVICES && raised[device].load()) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && device < MAX_DEVICES) raised[device].store(true);
  return err;
}

// How many clusters of `ranks` blocks of a persistent sweep the device
// runs at once (cudaOccupancyMaxActiveClusters), into *clusters.  An error
// (shared memory past the block's limit, say) is also cleared from the
// runtime's last error, so that the next launch's check does not report it.
template <typename... Params>
inline cudaError_t sweep_max_clusters(void (*kernel)(Params...), int threads, int smem_bytes,
                                      int ranks, int* clusters) {
  *clusters = 0;
  const cudaError_t err = max_active_clusters(kernel, threads, smem_bytes, ranks, clusters);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// Launch a persistent sweep: `batch` clusters of `ranks` blocks, after
// checking that the device can place one such cluster at all; a cluster
// it cannot place, or a launch it refuses, returns the error and nothing
// runs (there is no fallback).
template <typename... Params, typename... Args>
inline cudaError_t launch_sweep_clusters(void (*kernel)(Params...), int batch, int threads,
                                         int smem_bytes, int ranks, cudaStream_t stream,
                                         Args... args) {
  int clusters = 0;
  cudaError_t err = sweep_max_clusters(kernel, threads, smem_bytes, ranks, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  err = launch_clustered(kernel, dim3(batch * ranks), threads, smem_bytes, ranks, stream,
                         args...);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// float32 or bfloat16 operands, float32 arithmetic
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// Tiled dense product (K5 at b > 16)
// ---------------------------------------------------------------------------
//
// One thread block of 256 threads owns a BM x BN tile of C = A B, for A
// (m, k) and B (k, nb), both row-major and contiguous.  The contraction
// runs in BK-deep steps: each step the block copies a BM x BK tile of A
// and a BK x BN tile of B into shared memory (converted to float32,
// zero outside the matrix, so ragged edges need no padded copy), and
// every thread adds its TM x TN outputs' products into float32
// registers.  The next step's tiles are loaded into registers while the
// current ones are multiplied (one tile of prefetch).
//
// A thread owns rows pr + i * (BM / TM) and columns pc + j * (BN / TN):
// neighbouring lanes take neighbouring columns (and rows), which keeps
// the shared-memory reads free of bank conflicts (A's tile rows are
// padded by one word).
template <int BM_, int BK_, int BN_, int TM_, int TN_>
struct ProdConfig {
  static constexpr int BM = BM_, BK = BK_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int THREADS = 256;
  static constexpr int ROWS = BM / TM;        // thread positions along rows
  static constexpr int COLS = BN / TN;        // ... and along columns
  static constexpr int A_LOADS = BM * BK / THREADS;
  static constexpr int B_LOADS = (BK * BN + THREADS - 1) / THREADS;
  static_assert(BM % TM == 0 && BN % TN == 0, "tile must split into thread tiles");
  static_assert(ROWS * COLS == THREADS, "threads must cover the tile");
  static_assert((BM * BK) % THREADS == 0, "A tile must split evenly over the threads");
};

// b > 16 (K5 only: K6's products with b >= 2 and K5's with 2 <= b <= 16
// take the split-k kernels of crosspoint_mvm.cu and transient_step.cu, and
// both at b = 1 the GEMV below)
using ProdWide = ProdConfig<64, 64, 64, 4, 4>;

template <typename C, typename T>
__device__ __forceinline__ void prod_load(const T* __restrict__ a, const T* __restrict__ b,
                                          int m, int k, int nb, int row0, int col0, int k0,
                                          float (&ar)[C::A_LOADS], float (&br)[C::B_LOADS]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < C::A_LOADS; ++r) {
    const int e = t + r * C::THREADS;
    const int gi = row0 + e / C::BK;
    const int gk = k0 + e % C::BK;
    ar[r] = (gi < m && gk < k) ? to_f32(a[static_cast<size_t>(gi) * k + gk]) : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < C::B_LOADS; ++r) {
    const int e = t + r * C::THREADS;
    const int gk = k0 + e / C::BN;
    const int gj = col0 + e % C::BN;
    br[r] = (e < C::BK * C::BN && gk < k && gj < nb)
                ? to_f32(b[static_cast<size_t>(gk) * nb + gj]) : 0.0f;
  }
}

// acc[i][j] = sum_k A[row0 + pr + i*ROWS, k] * B[k, col0 + pc + j*COLS].
// Every thread of the block must call it.
template <typename C, typename T>
__device__ __forceinline__ void tile_product(const T* __restrict__ a, const T* __restrict__ b,
                                             int m, int k, int nb, int row0, int col0,
                                             float (&acc)[C::TM][C::TN], int& pr, int& pc) {
  __shared__ float as[C::BM][C::BK + 1];
  __shared__ float bs[C::BK][C::BN];
  const int t = threadIdx.x;
  pr = t / C::COLS;
  pc = t % C::COLS;
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.0f;

  float ar[C::A_LOADS], br[C::B_LOADS];
  prod_load<C>(a, b, m, k, nb, row0, col0, 0, ar, br);
  for (int k0 = 0; k0 < k; k0 += C::BK) {
    __syncthreads();                       // the previous step's reads are done
#pragma unroll
    for (int r = 0; r < C::A_LOADS; ++r) {
      const int e = t + r * C::THREADS;
      as[e / C::BK][e % C::BK] = ar[r];
    }
#pragma unroll
    for (int r = 0; r < C::B_LOADS; ++r) {
      const int e = t + r * C::THREADS;
      if (e < C::BK * C::BN) bs[e / C::BN][e % C::BN] = br[r];
    }
    __syncthreads();
    if (k0 + C::BK < k) prod_load<C>(a, b, m, k, nb, row0, col0, k0 + C::BK, ar, br);
#pragma unroll 8
    for (int kk = 0; kk < C::BK; ++kk) {
      float av[C::TM], bv[C::TN];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) av[i] = as[pr + i * C::ROWS][kk];
#pragma unroll
      for (int j = 0; j < C::TN; ++j) bv[j] = bs[kk][pc + j * C::COLS];
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// GEMV (K6 at b = 1, K5 at nb = 1): y = A x, A streamed once from HBM
// ---------------------------------------------------------------------------
//
// What bounds it: bytes.  Every element of A (m, k) is used once, for 2
// flops, so the kernel is the time to stream A: 268 MB of float32 at
// m = k = 8192, 80 us at 3.35 TB/s.  What that asks of the card: about 25
// KB in flight on each SM without a break (3.35 TB/s x ~1 us of latency
// over 132 SMs), and every SM busy to the end.  So:
// * A goes from HBM into registers, never through shared memory: each
//   element is used once, so staging buys nothing.  A lane loads 16 bytes
//   (4 float32 or 8 bf16) with a streaming hint (ld.global.nc with
//   L1::no_allocate, so A does not evict x from L1) in batches of
//   GEMV_UNROLL chunks of each of GEMV_ROWS rows, the next batch issued
//   before the current one is added (GEMV_PIPE): 4 to 8 KB in flight per
//   warp, 64 to 128 KB per SM, and no barrier anywhere in the kernel.  (A
//   ring of shared-memory stages per warp filled by 1-D TMA bulk copies,
//   the other design, ran at 78-80 % of the HBM rate on an H100 against
//   this one's 90-92 %, and other rows, depths and grids within 1 %:
//   scripts/gemv_times.py --sweep, PERF.md);
// * x (32 KB at k = 8192) comes through the read-only path, each chunk
//   once per GEMV_ROWS rows, from L1 after a block's first pass;
// * one wave, finishing together: the grid is min(m, GEMV_SMS) blocks of
//   GEMV_WARPS warps (gemv_plan), block b owning rows [b m / B, (b + 1) m /
//   B), so no block holds more than one row above the mean (63 against
//   62.06 at m = 8192); its warps walk groups of GEMV_ROWS rows, warp w
//   the groups w, w + warps, ...
// The order of every sum is fixed (kernels/gemv.py:gemv_in_kernel_order
// repeats it in plain PyTorch, bit for bit): lane l adds the chunks
// c = l + 32 j of a row, j ascending, one float32 accumulator per element
// of a chunk, each product rounded before its add (no FMA, so that plain
// PyTorch can repeat it); the chunk's accumulators are added pairwise
// ((a0 + a1) + (a2 + a3)), and the lanes by a shuffle tree, lane l + o
// into lane l for o = 16, 8, 4, 2, 1.  No atomics: two launches give the
// same bits.  A chunk past the row's end (ragged k, the scalar variant)
// adds 0 x 0.
//
// Variants: VEC16 (k a multiple of 4 in float32, of 8 in bf16, A and x
// 16-byte aligned: every chunk whole, every row on the 16-byte grid) and
// the masked scalar loads of the same chunks, in the same order.
constexpr int GEMV_SMS = 132;     // H100 SXM: the grid's blocks at most, one an SM
constexpr int GEMV_WARPS = 16;    // warps of a block, at most
constexpr int GEMV_ROWS = 2;      // rows a warp walks at once, sharing x's chunks
constexpr int GEMV_UNROLL = 4;    // chunks of each row in a lane's batch of loads
constexpr bool GEMV_PIPE = true;  // the next batch's loads issued before the current adds
constexpr int GEMV_THREADS = 32 * GEMV_WARPS;

// The split of m rows: blocks, warps a block, rows of the largest block,
// rows the busiest warp walks (kernels/gemv.py:gemv_plan, the same
// function in Python).
struct GemvPlan {
  int blocks, warps, rows_per_block, rows_per_warp;
};

inline GemvPlan gemv_plan(int m) {
  GemvPlan p;
  p.blocks = m < GEMV_SMS ? m : GEMV_SMS;
  p.rows_per_block = (m + p.blocks - 1) / p.blocks;
  const int groups = (p.rows_per_block + GEMV_ROWS - 1) / GEMV_ROWS;
  p.warps = groups < GEMV_WARPS ? groups : GEMV_WARPS;
  const int walked = (groups + p.warps - 1) / p.warps * GEMV_ROWS;
  p.rows_per_warp = walked < p.rows_per_block ? walked : p.rows_per_block;
  return p;
}

// A 16-byte chunk of A: streamed, not kept in L1
__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}

template <typename T>
struct Chunk;   // the elements of a 16-byte chunk, as float32

template <>
struct Chunk<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[E]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[E]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);           // the lower element
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Chunk c of `row` (k elements), zero past the end.  VEC16: one 16-byte
// load (streamed when STREAM); otherwise E masked scalar loads.
template <typename T, bool VEC16, bool STREAM>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ row, int c, int k, bool ok) {
  constexpr int E = Chunk<T>::E;
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (!ok) return u;
  if constexpr (VEC16) {
    const T* p = row + static_cast<size_t>(c) * E;
    if constexpr (STREAM) return ld_stream16(p);
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    uint32_t w[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = c * E + e;
      if constexpr (sizeof(T) == 4) {
        w[e] = i < k ? __float_as_uint(__ldg(reinterpret_cast<const float*>(row) + i)) : 0u;
      } else {
        w[e] = i < k ? static_cast<uint32_t>(
                           __ldg(reinterpret_cast<const unsigned short*>(row) + i)) : 0u;
      }
    }
    if constexpr (sizeof(T) == 4) return make_uint4(w[0], w[1], w[2], w[3]);
    return make_uint4(w[0] | w[1] << 16, w[2] | w[3] << 16, w[4] | w[5] << 16,
                      w[6] | w[7] << 16);
  }
}

// y[r] for the rows of this block, handed to epi(r, y[r]) by lane 0 of the
// warp that adds it.  ROWS and UNROLL as GEMV_ROWS and GEMV_UNROLL; PIPE
// issues the next batch of chunks before adding the current one (two
// batches of registers), so that a warp keeps loads in flight while it
// adds; the grid and block sizes are the launch's (gemv_plan).
template <typename T, bool VEC16, int ROWS, int UNROLL, bool PIPE, typename Epilogue>
__device__ __forceinline__ void gemv_rows(const T* __restrict__ a, const T* __restrict__ x,
                                          int m, int k, Epilogue epi) {
  constexpr int E = Chunk<T>::E;
  struct Batch {
    uint4 g[UNROLL][ROWS], x[UNROLL];
  };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int r0 = static_cast<int>(static_cast<long long>(blockIdx.x) * m / gridDim.x);
  const int r1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * m / gridDim.x);
  const int nc = (k + E - 1) / E;          // chunks of a row
  const int steps = (nc + 31) / 32;        // chunks a lane adds of each row
  for (int row = r0 + warp * ROWS; row < r1; row += warps * ROWS) {
    float acc[ROWS][E];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] = 0.0f;
    // the chunks lane + 32 (j0 + u), u < UNROLL, of x and of the group's rows
    auto load = [&](Batch& bt, int j0) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = lane + 32 * (j0 + u);
        bt.x[u] = load_chunk<T, VEC16, false>(x, c, k, c < nc);
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          bt.g[u][i] = load_chunk<T, VEC16, true>(a + static_cast<size_t>(row + i) * k, c, k,
                                                  c < nc && row + i < r1);
      }
    };
    auto add = [&](const Batch& bt, int j0) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (j0 + u >= steps) break;       // warp-uniform
        float xf[E];
        Chunk<T>::unpack(bt.x[u], xf);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          float gf[E];
          Chunk<T>::unpack(bt.g[u][i], gf);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[i][e] = __fadd_rn(acc[i][e], __fmul_rn(gf[e], xf[e]));
        }
      }
    };
    Batch b0;
    if constexpr (PIPE) {
      Batch b1;
      load(b0, 0);
      for (int j0 = 0; j0 < steps; j0 += 2 * UNROLL) {
        load(b1, j0 + UNROLL);            // past the end: no load
        add(b0, j0);
        load(b0, j0 + 2 * UNROLL);
        add(b1, j0 + UNROLL);
      }
    } else {
      for (int j0 = 0; j0 < steps; j0 += UNROLL) {
        load(b0, j0);
        add(b0, j0);
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
#pragma unroll
      for (int w = E / 2; w > 0; w >>= 1)
#pragma unroll
        for (int e = 0; e < w; ++e) acc[i][e] = __fadd_rn(acc[i][2 * e], acc[i][2 * e + 1]);
      float s = acc[i][0];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, o));
      if (lane == 0 && row + i < r1) epi(row + i, s);
    }
  }
}

}  // namespace repro_torch
