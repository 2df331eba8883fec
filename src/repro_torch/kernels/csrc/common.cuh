// Device helpers shared by the Hopper kernels: the reductions of the
// settle sweeps (K1-K4), the tiled dense product of K5 and K6's GEMV, the
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
// Tiled dense product (K5 at b = 1 and b > 16; K6 crosspoint_mvm at b = 1)
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
// padded by one word).  Where the tile has fewer outputs than threads
// (the single-column case, BN = 1) the threads split each BK step into
// KSPLIT contiguous chunks, and the chunks' partial sums are added in
// chunk order at the end, so every block stays fully busy.
template <int BM_, int BK_, int BN_, int TM_, int TN_>
struct ProdConfig {
  static constexpr int BM = BM_, BK = BK_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int THREADS = 256;
  static constexpr int ROWS = BM / TM;        // thread positions along rows
  static constexpr int COLS = BN / TN;        // ... and along columns
  static constexpr int SLOTS = ROWS * COLS;
  static constexpr int KSPLIT = THREADS / SLOTS;
  static constexpr int KCHUNK = BK / KSPLIT;
  static constexpr int A_LOADS = BM * BK / THREADS;
  static constexpr int B_LOADS = (BK * BN + THREADS - 1) / THREADS;
  static_assert(BM % TM == 0 && BN % TN == 0, "tile must split into thread tiles");
  static_assert(SLOTS * KSPLIT == THREADS && BK % KSPLIT == 0, "threads must cover the tile");
  static_assert((BM * BK) % THREADS == 0, "A tile must split evenly over the threads");
  static_assert(THREADS * TM * TN <= BM * (BK + 1), "chunk partials must fit A's tile");
};

// b = 1, the crossbar's own operation: 32-row tiles (256 blocks for
// m = 8192, two per SM), 128-deep steps split over 8 chunks.
using ProdColumn = ProdConfig<32, 128, 1, 1, 1>;
// b > 16 (K5 only: K6's products with b >= 2 and K5's with 2 <= b <= 16
// take the split-k kernels of crosspoint_mvm.cu and transient_step.cu)
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
// Every thread of the block must call it.  Returns false for the threads
// whose acc holds only a chunk's partial sum (KSPLIT > 1): they write
// nothing.
template <typename C, typename T>
__device__ __forceinline__ bool tile_product(const T* __restrict__ a, const T* __restrict__ b,
                                             int m, int k, int nb, int row0, int col0,
                                             float (&acc)[C::TM][C::TN], int& pr, int& pc) {
  __shared__ float as[C::BM][C::BK + 1];
  __shared__ float bs[C::BK][C::BN];
  const int t = threadIdx.x;
  const int slot = t % C::SLOTS;
  const int chunk = t / C::SLOTS;
  pr = slot / C::COLS;
  pc = slot % C::COLS;
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
    for (int s = 0; s < C::KCHUNK; ++s) {
      const int kk = chunk * C::KCHUNK + s;
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
  if constexpr (C::KSPLIT > 1) {
    // add the chunks' partials in chunk order, through A's tile
    float* part = &as[0][0];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j)
        part[((chunk * C::SLOTS + slot) * C::TM + i) * C::TN + j] = acc[i][j];
    __syncthreads();
    if (chunk != 0) return false;
    for (int g = 1; g < C::KSPLIT; ++g)
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j)
          acc[i][j] += part[((g * C::SLOTS + slot) * C::TM + i) * C::TN + j];
  }
  return true;
}

}  // namespace repro_torch
