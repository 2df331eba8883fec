// K8: flash attention (GQA, causal / sliding-window / ragged mask, online
// softmax) for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
//   K8  flash_attention_pallas  (_flash_kernel)
//
// q is (B, S, H, D), k and v are (B, T, KV, D), H = KV * G, all float32
// or all bfloat16, contiguous; o is (B, S, H, D) in q's dtype.  Query
// head h reads KV head h / G.  Scores, the running max m and sum l and
// the output accumulator are float32; masked scores are the finite
// -1e30 of the reference (a row fully masked in its first tile takes
// p = 1 there, and the next tile's alpha = exp(-1e30 - m) = 0 wipes it);
// the final division floors l at 1e-30.  p_bf16 rounds the probability
// tile to bf16 before the PV product (the row sum stays float32).
//
// Routes (kernels/flash_attention.py:flash_attention_route, a pure
// function of dtype, D and alignment):
//
// * "mma": bfloat16 with q, k and v 16-byte aligned (any fresh tensor) ->
//   flash_attention_mma_kernel, bf16 tensor cores with float32
//   accumulators;
// * "fma": float32 (TF32 would break its 1e-6 + 1e-5 |want| bar), and a
//   bf16 view whose base is not 16-byte aligned ->
//   flash_attention_kernel, float32 FMA.
//
// What bounds it on an H100.  At the serving path's prefill shape (B = 1,
// S = T = 2048, H = 32, KV = 8, D = 128, causal) the two products take
// 4 * H * D * S (S + 1) / 2 = 34.4 GFLOP against 42 MB of q, k, v and o:
// operations, 35 us at the bf16 tensor-core peak (989 TFLOP/s), 0.51 ms
// at the float32 FMA peak (67 TFLOP/s).  Only the tensor cores can get
// under the second.
//
// Shared by both routes.  The Pallas grid (batch * kv head, q tile, kv
// tile) with the kv axis sequential and a VMEM carry becomes one thread
// block per (batch * kv head, row tile) with the kv loop inside the
// block.  A row tile is consecutive rows of the flattened (q position,
// group member) index R = qpos * G + g of one KV head, so the block holds
// all G query heads that share its K/V tiles (K/V are never repeated) and
// any G works (G = 1 up to MQA's G = H, Granite's 48 included).  Keys come
// in tiles of 64 (KV_TILE of the plain version: with p rounded, p is
// rounded against the running max at these tile edges).  Tiles that the
// causal mask or the window make unreachable for every row of the block
// are skipped, and the element mask is applied only on tiles that
// straddle the diagonal, the window edge or T.  Row tiles are issued
// longest first (causal work grows with the q position).  Ragged S and T
// are masked in the loads and stores: nothing is padded, and the rows
// past S * G are never written.
//
// Design of the mma route (FlashAttention-2's layout on mma.sync; the
// wgmma/TMA form with a producer warp is the open step).  A block of 8
// warps owns 128 rows, warp w rows 16 w .. 16 w + 15, one block per SM
// (216 registers a thread at D = 128): the rows that share a K/V tile are
// twice those of 4-warp blocks, two per SM, which read every tile twice
// as often and ran slower.  Q is copied once per block with 16-byte
// cp.async (its rows are a (qpos, G, D) box) and kept in registers as A
// fragments (ldmatrix).  K
// and V tiles (64 keys x D) stream through two stages each by 16-byte
// cp.async, a warp copying whole key rows, zero filled past T: tile j+1
// is copied while tile j is computed, behind one barrier per tile.  S
// comes from m16n8k16 bf16 products with float32 accumulators (K's B
// fragments by ldmatrix, all 64 keys' before the products of a 16-deep
// step, so consecutive products never share an accumulator); the mask,
// the row max and sum (over the four lanes that share a row, by
// shuffles) and the rescale run on the accumulator fragments, with
// scores and the running max in the log2 domain (exp2 of x * scale *
// log2(e) - m, the same function as the reference's exp).  P never
// leaves registers: the accumulator of a 16-key block is the A fragment
// of the PV product, with V's B fragments by ldmatrix.trans.  With
// p_dtype = None p stays float32 in meaning: p = p_hi + p_lo, both bf16
// (p_hi = bf16(p), p_lo = bf16(p - p_hi)), and both go into the same
// float32 accumulator by two products; the residual p - p_hi - p_lo is
// under 2^-16 p, far below the output's bf16 rounding.  With p rounded
// (p_bf16) only p_hi is used.  Shared-memory rows are padded by 16
// bytes, so the eight rows an ldmatrix reads fall in distinct banks.
// Every head size is a multiple of 16: D = 112 (Zamba2-7B's shared
// attention) takes seven 16-column groups of V, four then three, and its
// 240-byte shared rows keep ldmatrix's eight rows in distinct banks.
// What holds it back: each warp reads the whole K and V tile through
// ldmatrix (eight reads of every byte per block), and the softmax between
// the two products runs with two warps per scheduler, so the tensor
// cores wait.  A first wgmma version (operands read by the tensor cores
// from shared memory once per warpgroup) was slower still: cp.async into
// wgmma's unswizzled core-matrix layout reads 64 bytes per key per warp
// request, and its copies cost more than the products.  The open step is
// TMA with the 128-byte swizzle, a producer warp, and one tile's softmax
// overlapped with the next tile's products.
//
// Design of the fma route (redesigned for Hopper; float32 FMA only, TF32
// stays off).  A block owns a row tile of the plan's size (ff_plan,
// kernels/flash_attention.py:fma_forward_plan: the largest multiple of a
// warp's rows whose grid keeps FF_FILL_BLOCKS blocks; 48 at train_lm's
// shape, 128 at the serving shape), a thread 4 of its rows by 1 / KG of
// each key tile (FfLayout).  Q is copied once; K and V stream through a
// ring of 64-key buffers by 16-byte cp.async (bf16 element by element, off
// the grid 4 bytes at a time), a key tile's K and V a tile ahead of their
// use behind one block barrier a tile (three buffers and two barriers at
// D >= 112, where a fourth does not fit beside 128 rows).  S comes from
// register tiles of 4 rows x 4 or 8 keys over 128-bit shared loads; the
// online softmax runs in the log2 domain (one multiply by scale log2(e),
// exp2f), with the mask on edge tiles only and each lane's share of the
// row sum added up once, at the end; P passes through shared memory to the
// same warp's PV product, 4 rows x D / KG columns from 128-bit (64-bit at
// D <= 32 and 112) loads.  What bounds it on an H100: at the serving shape
// the shared-memory pipe that feeds the FMA (1.0 ms against the 0.51 ms
// FMA bound); at train_lm's shape the latency of each block's chain of up
// to 3 key tiles (about 4 us a tile for one block alone: its products,
// softmax and barrier) and the launch, against a 3.4 us bound.
// Both routes can also write each row's log-sum-exp lse = m + log(l) of
// the scaled scores, float32 (B, H, S), for the backward; without it they
// compute and store exactly what they did before the output existed.
//
// Backward (no TPU counterpart: the reference differentiates the pure-JAX
// attention of src/repro/models/attention.py:42 with jax.grad; these
// kernels replace that gradient).  Three launches, FlashAttention-2's
// recomputation: Delta = rowsum(dO * O); then per (batch, KV head, 64-key
// tile) one block that loops over the G query heads of the group and every
// query tile that reaches its keys, recomputes P = exp(S scale - lse) under
// the forward's mask and adds dV += P~^T dO (P~ = bf16(P) when p_bf16, as
// the forward's PV product) and dK += dS^T Q with dS = P (dP - Delta), in
// float32 registers, each element written once (the GQA sum over heads is
// in a fixed order, with no atomics); then one block per rows of queries
// that adds dQ += dS K over the key tiles.  bf16 gradients are rounded
// once, at the store.  Two routes for dK/dV and dQ, by the forward's rule
// (kernels/flash_attention.py:flash_attention_bwd_route):
//
// * "fma" (float32, and bf16 off the 16-byte grid):
//   flash_attention_bwd_dkdv_kernel and _dq_kernel, every product float32
//   FMA from shared-memory tiles read by 128-bit loads into register tiles
//   (at least 4 FMA a load), fed two deep by cp.async (bf16 inputs read
//   element by element into the same ring); dK/dV's walk of a key tile's
//   (head, query tile) items split over the blocks of a thread-block
//   cluster and summed in rank order (design at the kernels);
// * "mma" (bf16 with q, k, v and dO 16-byte aligned):
//   flash_attention_bwd_dkdv_mma_kernel and _dq_mma_kernel, mma.sync on the
//   bf16 tensor cores with float32 accumulators, tiles copied by 16-byte
//   cp.async two deep, P and dS fed from the accumulators to the second
//   products as A fragments, split as the forward's P (hi + lo, both bf16)
//   so that they stay float32 in meaning.
//
// What bounds the backward at the training path's bf16 shape (Qwen3-8B:
// B = 1, S = T = 2048, 32 query heads over 8 KV heads, D = 128, causal):
// dK/dV's four products take 8 D flops a (query, key) pair (69 us at the
// bf16 tensor-core peak), dQ's three 6 D (52 us), against 34 MB of
// inputs and outputs: operations.  The split makes that 12 D and 8 D on
// the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace repro_torch {
namespace {

constexpr int FA_KB = 64;         // keys per tile
constexpr float FA_NEG_INF = -1e30f;
constexpr long long MAX_GRID_X = 0x7fffffffLL;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// float32 FMA helpers, shared by the fma route's forward and backward
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool fa_keep(int qpos, int kpos, int t_len, int causal, int window) {
  bool ok = kpos < t_len;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// c + a . b, the four terms in order
__device__ __forceinline__ float dot4(const float4 a, const float4 b, float c) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, c))));
}

// acc[0..3] += s * x
__device__ __forceinline__ void axpy4(float (&acc)[4], float s, const float4 x) {
  acc[0] = fmaf(s, x.x, acc[0]);
  acc[1] = fmaf(s, x.y, acc[1]);
  acc[2] = fmaf(s, x.z, acc[2]);
  acc[3] = fmaf(s, x.w, acc[3]);
}

// Rows [r0, r0 + n_rows) of D elements, `row_stride` elements apart from
// `src` on, -> dst [n_rows][DS] float32, zero from row `limit` on, by the
// `nt` threads tid = 0 .. nt - 1.  float32 by cp.async: 16-byte copies
// when vec16 (every base on the 16-byte grid), else 4-byte ones; bf16
// element by element (a load and a conversion).  The caller commits the
// copies.
template <typename T, int D, int DS>
__device__ __forceinline__ void fb_stage_rows_by(int tid, int nt, float* dst,
                                                 const T* __restrict__ src, size_t row_stride,
                                                 int r0, int n_rows, int limit, int vec16) {
  if constexpr (sizeof(T) == 4) {
    if (vec16) {
      constexpr int CH = D / 4;
      for (int e = tid; e < n_rows * CH; e += nt) {
        const int r = e / CH, c = (e % CH) * 4;
        const bool ok = r0 + r < limit;
        const T* p = ok ? src + static_cast<size_t>(r0 + r) * row_stride + c : src;
        cp_async16(dst + r * DS + c, p, ok ? 16 : 0);
      }
      return;
    }
    for (int e = tid; e < n_rows * D; e += nt) {
      const int r = e / D, c = e % D;
      const bool ok = r0 + r < limit;
      const T* p = ok ? src + static_cast<size_t>(r0 + r) * row_stride + c : src;
      cp_async4(dst + r * DS + c, p, ok ? 4 : 0);
    }
  } else {
    for (int e = tid; e < n_rows * D; e += nt) {
      const int r = e / D, c = e % D;
      dst[r * DS + c] =
          r0 + r < limit ? to_f32(src[static_cast<size_t>(r0 + r) * row_stride + c]) : 0.0f;
    }
  }
}

// fb_stage_rows_by over the block's THREADS threads
template <typename T, int D, int DS, int THREADS>
__device__ __forceinline__ void fb_stage_rows(float* dst, const T* __restrict__ src,
                                              size_t row_stride, int r0, int n_rows, int limit,
                                              int vec16) {
  fb_stage_rows_by<T, D, DS>(threadIdx.x, THREADS, dst, src, row_stride, r0, n_rows, limit,
                             vec16);
}

// ---------------------------------------------------------------------------
// fma route: float32 FMA from register tiles over shared-memory tiles
// ---------------------------------------------------------------------------

// The forward's layout at head size D.  A thread owns AR = 4 rows of the
// block (rows rg + RG i, RG = rows / 4 the block's row groups) and, with
// the KG lanes of its row group (KG consecutive lanes of one warp: the row
// max is a shuffle tree, and P passes between the products by a
// __syncwarp), forms S over AK = 64 / KG keys (keys kg + KG j) and
// then the same 4 rows' outputs over CPT = D / KG columns (chunks of VEC
// columns at VEC (kg + KG jj)).  KG = 16 at D = 32 and 64 (a 4 x 4 S tile,
// half the work a thread of an 8-lane group does: the longest block's
// critical path at train_lm's shape), 8 at D = 16, 112 and 128 (4 x 8,
// 10.7 FMA a 128-bit load).  Every tile keeps at least 4 FMA a shared
// load: S 8 or 10.7; PV 4 (D = 16, 32), 8 (64), 7 (112: float2 chunks, no
// padding), 12.8 (128).  Q, K and V rows are padded by 4 floats (TS), so
// that the 8 or 16 key rows a quarter or half warp reads by 128-bit loads
// fall in distinct banks; P rows by KG floats (PS), so that the 32 lanes'
// scalar stores of P do.
template <int D>
struct FfLayout {
  static constexpr int KG = (D == 32 || D == 64) ? 16 : 8;
  static constexpr int AR = 4;
  static constexpr int AK = FA_KB / KG;
  static constexpr int CPT = D / KG;
  static constexpr int VEC = CPT % 4 == 0 ? 4 : 2;
  static constexpr int NCH = CPT / VEC;
  static constexpr int TS = D + 4;
  static constexpr int PS = FA_KB + KG;
  static constexpr int MAX_THREADS = 256;
  static constexpr int MAX_ROWS = MAX_THREADS / KG * AR;    // 64 at KG = 16, 128 at KG = 8
  static constexpr int ROW_STEP = AR * 32 / KG;              // rows a warp holds: 8 or 16
  static constexpr int NB = D >= 112 ? 3 : 4;               // ring buffers of 64 keys
  static_assert(CPT % VEC == 0 && KG * AK == FA_KB, "threads must cover the tiles");
};

constexpr int FF_MIN_ROWS = 16;
// The plan takes the largest row tile whose grid has at least this many
// blocks, about 1.5 an SM (chosen by sweeping the row tile at train_lm's
// shape on the card, where 48 rows, 192 blocks, ran as fast as any and
// fit one wave: scripts/k8_fma_times.py --sweep)
constexpr int FF_FILL_BLOCKS = 192;

template <int D>
constexpr int ff_smem_bytes(int rows) {
  using L = FfLayout<D>;
  return (rows * L::TS + L::NB * FA_KB * L::TS + rows * L::PS) * 4;
}

// The forward's plan at a shape, a pure function of it
// (kernels/flash_attention.py:fma_forward_plan): rows per block, threads,
// shared memory, row tiles and blocks.  `rows` > 0 forces a row tile (a
// multiple of the layout's ROW_STEP from FF_MIN_ROWS to its MAX_ROWS).
struct FfPlan {
  int rows, threads, smem, row_tiles, blocks;
};

template <int D>
inline FfPlan ff_plan(int batch, int s, int h, int kv, int rows) {
  using L = FfLayout<D>;
  const long long n_rows = static_cast<long long>(s) * (h / kv);
  const long long n_bkv = static_cast<long long>(batch) * kv;
  auto tiles = [&](int r) { return (n_rows + r - 1) / r; };
  if (rows <= 0) {
    rows = L::MAX_ROWS;
    while (rows > FF_MIN_ROWS && tiles(rows) * n_bkv < FF_FILL_BLOCKS) rows -= L::ROW_STEP;
  }
  FfPlan p;
  p.rows = rows;
  p.threads = rows / L::AR * L::KG;
  p.smem = ff_smem_bytes<D>(rows);
  const long long t = tiles(rows);
  p.row_tiles = static_cast<int>(t);
  p.blocks = t * n_bkv > MAX_GRID_X ? -1 : static_cast<int>(t * n_bkv);
  return p;
}

// The key tiles [*kt0, *kt0 + *n_kt) of 64 keys that hold an unmasked key
// for some row of rows [r0, r0 + rows) of the (q position, group member)
// index: the mask's reach
__host__ __device__ inline void ff_key_tiles(int r0, int rows, int n_rows, int g, int t_len,
                                             int causal, int window, int* kt0, int* n_kt) {
  const int q_lo = r0 / g;
  const int q_hi = ((r0 + rows < n_rows ? r0 + rows : n_rows) - 1) / g;
  int k_hi = t_len - 1;
  if (causal && q_hi < k_hi) k_hi = q_hi;
  const int k_lo = window > 0 ? (q_lo - window + 1 > 0 ? q_lo - window + 1 : 0) : 0;
  *kt0 = k_lo / FA_KB;
  *n_kt = k_lo <= k_hi ? k_hi / FA_KB - *kt0 + 1 : 0;
}

// Rows [r0, r0 + rows) of the (q position, group member) index of KV head
// kvh (q position r / g, query head kvh g + r % g) -> qs [rows][TS]
// float32, zero past n_rows: 16-byte cp.async when vec16, 4-byte ones for
// float32 off the grid, bf16 element by element.  The caller commits.
template <typename T, int D>
__device__ __forceinline__ void ff_stage_q(float* qs, const T* __restrict__ q, int r0, int rows,
                                           int n_rows, int g, int h, int kvh, int vec16) {
  constexpr int TS = FfLayout<D>::TS;
  const int nt = blockDim.x;
  auto src = [&](int r) {
    const int row = r0 + r;
    return q + (static_cast<size_t>(row / g) * h + kvh * g + row % g) * D;
  };
  if constexpr (sizeof(T) == 4) {
    if (vec16) {
      constexpr int CH = D / 4;
      for (int e = threadIdx.x; e < rows * CH; e += nt) {
        const int r = e / CH, c = (e % CH) * 4;
        const bool ok = r0 + r < n_rows;
        cp_async16(qs + r * TS + c, ok ? src(r) + c : q, ok ? 16 : 0);
      }
      return;
    }
    for (int e = threadIdx.x; e < rows * D; e += nt) {
      const int r = e / D, c = e % D;
      const bool ok = r0 + r < n_rows;
      cp_async4(qs + r * TS + c, ok ? src(r) + c : q, ok ? 4 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * D; e += nt) {
      const int r = e / D, c = e % D;
      qs[r * TS + c] = r0 + r < n_rows ? to_f32(src(r)[c]) : 0.0f;
    }
  }
}

// the max / sum over the KG lanes of a row group
template <int KG>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = KG / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int KG>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = KG / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block per (row tile, batch * KV head), row tiles longest first
// (blockIdx.x / n_bkv counts down from the last tile).  Q is copied once;
// the block's key tiles stream through a ring of NB 64-key buffers by
// cp.async (16-byte copies on the grid), ring entry n (K of key tile
// kt0 + n / 2 when n is even, its V when odd) in buffer n % NB.  Per key
// tile: S = Q K^T, the mask (on tiles that straddle the diagonal, the
// window edge or T only), the online softmax in the log2 domain and P into
// shared memory, then O += P V.  P's rows are the row group's own (its KG
// lanes, one warp), so a __syncwarp passes them from one product to the
// other.  NB = 4 (D <= 64): a key tile's K and V are copied together a
// tile ahead, one block barrier a tile.  NB = 3 (D >= 112, where a fourth
// buffer does not fit beside 128 rows): each entry two entries ahead, a
// barrier before each product.
template <typename T, int D>
__global__ void __launch_bounds__(FfLayout<D>::MAX_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                       int n_bkv, int rows, int s_len, int t_len, int h, int kv, int causal,
                       int window, float scale, int p_bf16, int vec16) {
  using L = FfLayout<D>;
  extern __shared__ __align__(16) float ff_smem[];
  float* qs = ff_smem;                              // [rows][TS]
  float* ring = qs + rows * L::TS;                  // [NB][64][TS]
  float* ps = ring + L::NB * FA_KB * L::TS;         // [rows][PS]

  const int g = h / kv;
  const int n_rows = s_len * g;
  const int n_tiles = (n_rows + rows - 1) / rows;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / n_bkv;
  const int bkv = static_cast<int>(blockIdx.x) % n_bkv;
  const int b = bkv / kv, kvh = bkv % kv;
  const int r0 = tile * rows;
  const size_t q_base = static_cast<size_t>(b) * s_len * h * D;
  const size_t kv_off = static_cast<size_t>(b) * t_len * kv * D + static_cast<size_t>(kvh) * D;
  const size_t k_row = static_cast<size_t>(kv) * D;
  const int n_rg = rows / L::AR;
  const int rg = threadIdx.x / L::KG, kg = threadIdx.x % L::KG;
  const float scale2 = scale * LOG2E;     // exp(x scale - m) = exp2(x scale log2(e) - m')

  int kt0 = 0, n_kt = 0;
  ff_key_tiles(r0, rows, n_rows, g, t_len, causal, window, &kt0, &n_kt);
  const int q_lo = r0 / g;
  const int q_hi = (min(r0 + rows, n_rows) - 1) / g;

  // ring entry n, nothing past the last
  auto issue = [&](int n) {
    if (n < 2 * n_kt)
      fb_stage_rows_by<T, D, L::TS>(threadIdx.x, blockDim.x, ring + (n % L::NB) * FA_KB * L::TS,
                                    ((n & 1) ? v : k) + kv_off, k_row, (kt0 + n / 2) * FA_KB,
                                    FA_KB, t_len, vec16);
  };
  ff_stage_q<T, D>(qs, q + q_base, r0, rows, n_rows, g, h, kvh, vec16);
  issue(0);
  if constexpr (L::NB == 3) cp_async_commit();      // groups: Q + K(0), V(0)
  issue(1);
  cp_async_commit();                                // NB = 4: one group, Q + tile 0

  int lr[L::AR], qpos[L::AR];
  float m_i[L::AR], l_i[L::AR], acc[L::AR][L::CPT];
#pragma unroll
  for (int i = 0; i < L::AR; ++i) {
    lr[i] = rg + n_rg * i;
    const int row = r0 + lr[i];
    qpos[i] = row < n_rows ? row / g : 0;
    m_i[i] = FA_NEG_INF;
    l_i[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < L::CPT; ++c) acc[i][c] = 0.0f;
  }

  for (int jt = 0; jt < n_kt; ++jt) {
    const int k0 = (kt0 + jt) * FA_KB;
    if constexpr (L::NB == 4) {
      cp_async_wait<0>();             // K(jt), V(jt) have landed for this thread;
      __syncthreads();                // for all, and tile jt - 1's buffers are free
      issue(2 * jt + 2);
      issue(2 * jt + 3);
    } else {
      cp_async_wait<1>();             // K(jt) has landed for this thread;
      __syncthreads();                // for all, and V(jt - 1)'s buffer is free
      issue(2 * jt + 2);
    }
    cp_async_commit();
    const float* kt = ring + ((2 * jt) % L::NB) * FA_KB * L::TS;

    float sc[L::AR][L::AK];
#pragma unroll
    for (int i = 0; i < L::AR; ++i)
#pragma unroll
      for (int j = 0; j < L::AK; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[L::AR], bk[L::AK];
#pragma unroll
      for (int i = 0; i < L::AR; ++i) a[i] = ld4(qs + lr[i] * L::TS + d);
#pragma unroll
      for (int j = 0; j < L::AK; ++j) bk[j] = ld4(kt + (kg + L::KG * j) * L::TS + d);
#pragma unroll
      for (int i = 0; i < L::AR; ++i)
#pragma unroll
        for (int j = 0; j < L::AK; ++j) sc[i][j] = dot4(a[i], bk[j], sc[i][j]);
    }

    // scale, mask (edge tiles only), online softmax in the log2 domain,
    // P (rounded to bf16 when p_bf16) into shared memory, rescale
    const bool edge = k0 + FA_KB > t_len || (causal && k0 + FA_KB - 1 > q_lo) ||
                      (window > 0 && k0 <= q_hi - window);
#pragma unroll
    for (int i = 0; i < L::AR; ++i) {
      float mx = FA_NEG_INF;
#pragma unroll
      for (int j = 0; j < L::AK; ++j) {
        float x = sc[i][j] * scale2;
        if (edge && !fa_keep(qpos[i], k0 + kg + L::KG * j, t_len, causal, window))
          x = FA_NEG_INF;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m_i[i], group_max<L::KG>(mx));
      const float alpha = exp2f(m_i[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < L::AK; ++j) {
        const float p = exp2f(sc[i][j] - m_new);
        sum += p;
        ps[lr[i] * L::PS + kg + L::KG * j] =
            p_bf16 ? __bfloat162float(__float2bfloat16_rn(p)) : p;
      }
      l_i[i] = l_i[i] * alpha + sum;  // this lane's share; the group's sum once, at the end
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < L::CPT; ++c) acc[i][c] *= alpha;
    }
    if constexpr (L::NB == 4) {
      __syncwarp();                   // P is written
    } else {
      cp_async_wait<1>();             // V(jt) has landed for this thread;
      __syncthreads();                // for all, P is written, K(jt)'s buffer is free
      issue(2 * jt + 3);
      cp_async_commit();
    }
    const float* vt = ring + ((2 * jt + 1) % L::NB) * FA_KB * L::TS;
#pragma unroll 2
    for (int c = 0; c < FA_KB; c += 4) {
      float4 p4[L::AR];
#pragma unroll
      for (int i = 0; i < L::AR; ++i) p4[i] = ld4(ps + lr[i] * L::PS + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = vt + (c + e) * L::TS;
        float vv[L::CPT];
#pragma unroll
        for (int jj = 0; jj < L::NCH; ++jj) {
          const int col = L::VEC * (kg + L::KG * jj);
          if constexpr (L::VEC == 4) {
            const float4 x = ld4(vr + col);
            vv[4 * jj] = x.x, vv[4 * jj + 1] = x.y, vv[4 * jj + 2] = x.z, vv[4 * jj + 3] = x.w;
          } else {
            const float2 x = *reinterpret_cast<const float2*>(vr + col);
            vv[2 * jj] = x.x, vv[2 * jj + 1] = x.y;
          }
        }
#pragma unroll
        for (int i = 0; i < L::AR; ++i) {
          const float p = e == 0 ? p4[i].x : e == 1 ? p4[i].y : e == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int cc = 0; cc < L::CPT; ++cc) acc[i][cc] = fmaf(p, vv[cc], acc[i][cc]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < L::AR; ++i) l_i[i] = group_sum<L::KG>(l_i[i]);
#pragma unroll
  for (int i = 0; i < L::AR; ++i) {
    const int row = r0 + lr[i];
    if (row >= n_rows) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    const int head = kvh * g + row % g;
    T* dst = o + q_base + (static_cast<size_t>(qpos[i]) * h + head) * D;
#pragma unroll
    for (int jj = 0; jj < L::NCH; ++jj)
#pragma unroll
      for (int u = 0; u < L::VEC; ++u)
        store_as(dst + L::VEC * (kg + L::KG * jj) + u, acc[i][L::VEC * jj + u] / l);
    // the row log-sum-exp in natural units: m is in the log2 domain
    if (lse != nullptr && kg == 0)
      lse[(static_cast<size_t>(b) * h + head) * s_len + qpos[i]] = m_i[i] * LN2 + logf(l);
  }
}

// float32 operands all on the 16-byte grid (their rows then are too: D * 4
// bytes is a multiple of 16) take 16-byte copies
template <typename T>
int fb_vec16(const void* q, const void* k, const void* v, const void* dout) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  return sizeof(T) == 4 && bits % 16 == 0;
}

// the forward's dynamic shared-memory limit raised once per device, to its
// largest row tile's
template <typename T, int D>
cudaError_t ff_ready() {
  static std::atomic<bool> raised[MAX_DEVICES];
  return allow_dynamic_smem(flash_attention_kernel<T, D>,
                            ff_smem_bytes<D>(FfLayout<D>::MAX_ROWS), raised);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch, int s,
           int t, int h, int kv, int causal, int window, float scale, int p_bf16, int rows,
           cudaStream_t stream) {
  using L = FfLayout<D>;
  if (rows > 0 && (rows < FF_MIN_ROWS || rows > L::MAX_ROWS || rows % L::ROW_STEP != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = ff_ready<T, D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const FfPlan p = ff_plan<D>(batch, s, h, kv, rows);
  if (p.blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_kernel<T, D><<<p.blocks, p.threads, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, batch * kv, p.rows, s, t, h, kv, causal, window, scale, p_bf16,
      fb_vec16<T>(q, k, v, v));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for_dim(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                   int s, int t, int h, int kv, int d, int causal, int window, float scale,
                   int p_bf16, int rows, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, batch, s, t, h, kv, causal, window, scale, p_bf16, rows, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, batch, s, t, h, kv, causal, window, scale, p_bf16, rows, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, batch, s, t, h, kv, causal, window, scale, p_bf16, rows, stream);
    case 112: return launch<T, 112>(q, k, v, o, lse, batch, s, t, h, kv, causal, window, scale, p_bf16, rows, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, batch, s, t, h, kv, causal, window, scale, p_bf16, rows, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The forward's plan at a shape into plan[0 .. plan_len): rows, threads,
// shared-memory bytes, blocks, row tiles, blocks of it resident per SM on
// the current device; then per row tile in issue order (the last first)
// its first key tile and its key tiles.
template <int D>
int fma_plan(int batch, int s, int t, int h, int kv, int causal, int window, int* plan,
             int plan_len) {
  const FfPlan p = ff_plan<D>(batch, s, h, kv, 0);
  if (p.blocks < 0 || plan_len < 6 + 2 * static_cast<long long>(p.row_tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = ff_ready<float, D>();
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_attention_kernel<float, D>,
                                                        p.threads, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = p.rows;
  plan[1] = p.threads;
  plan[2] = p.smem;
  plan[3] = p.blocks;
  plan[4] = p.row_tiles;
  plan[5] = per_sm;
  const int g = h / kv;
  for (int i = 0; i < p.row_tiles; ++i) {
    const int tile = p.row_tiles - 1 - i;
    ff_key_tiles(tile * p.rows, p.rows, s * g, g, t, causal, window, &plan[6 + 2 * i],
                 &plan[7 + 2 * i]);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// mma route: bf16 tensor cores (mma.sync) in FlashAttention-2's layout
// ---------------------------------------------------------------------------

constexpr int FM_WARPS = 8;
constexpr int FM_THREADS = FM_WARPS * 32;
constexpr int FM_ROWS = FM_WARPS * 16;   // rows per block, 16 per warp

template <int D>
struct FmLayout {
  static constexpr int LD = D + 8;                // row stride in bf16: a 16-byte pad
  static constexpr int CHUNKS = D / 8;            // 16-byte chunks per row
  static constexpr int Q_ELEMS = FM_ROWS * LD;
  static constexpr int KV_ELEMS = FA_KB * LD;     // one stage of K or of V
  static constexpr int BYTES = (Q_ELEMS + 4 * KV_ELEMS) * 2;   // Q, K x 2, V x 2
  static constexpr int NG = D / 16;               // 16-column groups of V
  static constexpr int DG = NG < 4 ? NG : 4;        // groups held at once
};

// the max/sum over the four lanes of a quad (the threads of one row pair)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// keys [k0, k0 + 64) of one KV head's (T, KV, D) slab at `src` -> dst
// [64][LD] by 16-byte cp.async, zero past key t_len; a warp copies whole
// key rows (D * 2 contiguous bytes each)
template <int D>
__device__ __forceinline__ void fm_load_kv(const __nv_bfloat16* __restrict__ src,
                                           __nv_bfloat16* dst, int k0, int t_len, int kv) {
  using L = FmLayout<D>;
  for (int c = threadIdx.x; c < FA_KB * L::CHUNKS; c += FM_THREADS) {
    const int r = c / L::CHUNKS, cc = (c % L::CHUNKS) * 8;
    const bool ok = k0 + r < t_len;
    const __nv_bfloat16* p = ok ? src + static_cast<size_t>(k0 + r) * kv * D + cc : src;
    cp_async16(dst + r * L::LD + cc, p, ok ? 16 : 0);
  }
}

template <int D, bool P_BF16>
__global__ void __launch_bounds__(FM_THREADS, 1)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int s_len, int t_len, int h, int kv,
                           int causal, int window, float scale) {
  using L = FmLayout<D>;
  extern __shared__ __align__(128) unsigned char fm_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(fm_smem);   // [FM_ROWS][LD]
  __nv_bfloat16* ks = qs + L::Q_ELEMS;                               // [2][FA_KB][LD]
  __nv_bfloat16* vs = ks + 2 * L::KV_ELEMS;                          // [2][FA_KB][LD]

  const int g = h / kv;
  const int n_rows = s_len * g;
  const int tile = gridDim.x - 1 - blockIdx.x;     // longest (latest q) first
  const int r0 = tile * FM_ROWS;
  const int b = blockIdx.y / kv;
  const int kvh = blockIdx.y % kv;
  const size_t q_base = static_cast<size_t>(b) * s_len * h * D;
  const size_t kv_off = static_cast<size_t>(b) * t_len * kv * D + static_cast<size_t>(kvh) * D;
  const __nv_bfloat16* kh = k + kv_off;
  const __nv_bfloat16* vh = v + kv_off;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // scores in the log2 domain: exp(x * scale - m) = exp2(x * scale log2(e) - m log2(e))
  const float scale2 = scale * LOG2E;

  // key tiles that hold an unmasked key for some row of the block
  const int q_lo = r0 / g;
  const int q_hi = (min(r0 + FM_ROWS, n_rows) - 1) / g;
  int k_hi = t_len - 1;
  if (causal) k_hi = min(k_hi, q_hi);
  const int k_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int kt0 = k_lo / FA_KB;
  const int n_tiles = k_lo <= k_hi ? k_hi / FA_KB - kt0 + 1 : 0;

  // one copy group for Q, K(0) and V(0); then one for K(j+1), V(j+1) at tile j
  for (int c = threadIdx.x; c < FM_ROWS * L::CHUNKS; c += FM_THREADS) {
    const int r = c / L::CHUNKS, cc = (c % L::CHUNKS) * 8;
    const int row = r0 + r;
    const bool ok = row < n_rows;   // rows past S * G: zero, never written
    const __nv_bfloat16* p =
        ok ? q + q_base + (static_cast<size_t>(row / g) * h + kvh * g + row % g) * D + cc : q;
    cp_async16(qs + r * L::LD + cc, p, ok ? 16 : 0);
  }
  if (n_tiles > 0) {
    fm_load_kv<D>(kh, ks, kt0 * FA_KB, t_len, kv);
    fm_load_kv<D>(vh, vs, kt0 * FA_KB, t_len, kv);
  }
  cp_async_commit();

  // this thread's rows: gid and gid + 8 of the warp's 16
  const int ra = r0 + warp * 16 + gid, rb = ra + 8;
  const int qa = ra < n_rows ? ra / g : 0, qb = rb < n_rows ? rb / g : 0;
  float m_a = FA_NEG_INF, m_b = FA_NEG_INF, l_a = 0.0f, l_b = 0.0f;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  uint32_t qf[D / 16][4];           // the warp's Q rows as A fragments
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const int k0 = (kt0 + it) * FA_KB;
    cp_async_wait<0>();             // this thread's copies of K(it), V(it) have landed;
    __syncthreads();                // everyone's, and tile it - 1 is done with the stage
                                    // that tile it + 1 takes
    if (it == 0) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        ldmatrix_x4(qf[kd], qs + (warp * 16 + (lane & 15)) * L::LD + kd * 16 + (lane >> 4) * 8);
    }
    if (it + 1 < n_tiles) {         // K(it + 1), V(it + 1) load while tile it is computed
      fm_load_kv<D>(kh, ks + (st ^ 1) * L::KV_ELEMS, k0 + FA_KB, t_len, kv);
      fm_load_kv<D>(vh, vs + (st ^ 1) * L::KV_ELEMS, k0 + FA_KB, t_len, kv);
    }
    cp_async_commit();

    // S = Q K^T: 16 rows x 64 keys per warp, float32.  Per 16-deep step the
    // fragments of all 64 keys first, then eight independent products.
    float sc[FA_KB / 8][4];
#pragma unroll
    for (int j = 0; j < FA_KB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
    const __nv_bfloat16* kt = ks + st * L::KV_ELEMS;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t bk[FA_KB / 16][4];
#pragma unroll
      for (int np = 0; np < FA_KB / 16; ++np)
        ldmatrix_x4(bk[np], kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * L::LD +
                                kd * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < FA_KB / 16; ++np) {
        mma_bf16(sc[2 * np], qf[kd], bk[np][0], bk[np][1]);
        mma_bf16(sc[2 * np + 1], qf[kd], bk[np][2], bk[np][3]);
      }
    }

    // scale, mask (only on a tile that straddles the diagonal, the window
    // edge or T), online softmax, rescale the accumulator.  m is kept in
    // the log2 domain; the mask value stays the finite NEG_INF.
    const bool edge = k0 + FA_KB > t_len || (causal && k0 + FA_KB - 1 > q_lo) ||
                      (window > 0 && k0 <= q_hi - window);
    float mx_a = FA_NEG_INF, mx_b = FA_NEG_INF;
#pragma unroll
    for (int j = 0; j < FA_KB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float xa = sc[j][e] * scale2, xb = sc[j][e + 2] * scale2;
        if (edge) {
          const int kpos = k0 + j * 8 + tig * 2 + e;
          bool oka = kpos < t_len, okb = oka;
          if (causal) oka = oka && kpos <= qa, okb = okb && kpos <= qb;
          if (window > 0) oka = oka && kpos > qa - window, okb = okb && kpos > qb - window;
          xa = oka ? xa : FA_NEG_INF;
          xb = okb ? xb : FA_NEG_INF;
        }
        sc[j][e] = xa;
        sc[j][e + 2] = xb;
        mx_a = fmaxf(mx_a, xa);
        mx_b = fmaxf(mx_b, xb);
      }
    const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int j = 0; j < FA_KB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = exp2f(sc[j][e] - mn_a);
        sc[j][e + 2] = exp2f(sc[j][e + 2] - mn_b);
        sum_a += sc[j][e];
        sum_b += sc[j][e + 2];
      }
    l_a = l_a * al_a + quad_sum(sum_a);
    l_b = l_b * al_b + quad_sum(sum_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= al_a;
      acc[j][1] *= al_a;
      acc[j][2] *= al_b;
      acc[j][3] *= al_b;
    }

    // O += P V, P from registers: the accumulators of keys 16 kk .. +15 are
    // the A fragment (p_hi and, unless p is rounded, p_lo); V's fragments
    // for up to 64 output columns at a time, then their p_hi products, then
    // their p_lo products
    const __nv_bfloat16* vt = vs + st * L::KV_ELEMS;
#pragma unroll
    for (int kk = 0; kk < FA_KB / 16; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {   // (row gid | gid + 8) x (keys 16 kk | 16 kk + 8)
        const int j = 2 * kk + (r >> 1), e = (r & 1) * 2;
        ph[r] = pack_bf16(sc[j][e], sc[j][e + 1]);
        if constexpr (!P_BF16)
          pl[r] = pack_bf16(bf16_residual(sc[j][e]), bf16_residual(sc[j][e + 1]));
      }
#pragma unroll
      for (int d0 = 0; d0 < L::NG; d0 += L::DG) {
        // the last group is short when DG does not divide NG (D = 112: 4 + 3);
        // the bounds are compile-time constants once the loops unroll
        uint32_t bv[L::DG][4];
#pragma unroll
        for (int i = 0; i < L::DG; ++i)
          if (d0 + i < L::NG)
            ldmatrix_x4_trans(bv[i], vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L::LD +
                                         (d0 + i) * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < L::DG; ++i) {
          if (d0 + i >= L::NG) continue;
          mma_bf16(acc[2 * (d0 + i)], ph, bv[i][0], bv[i][1]);
          mma_bf16(acc[2 * (d0 + i) + 1], ph, bv[i][2], bv[i][3]);
        }
        if constexpr (!P_BF16) {
#pragma unroll
          for (int i = 0; i < L::DG; ++i) {
            if (d0 + i >= L::NG) continue;
            mma_bf16(acc[2 * (d0 + i)], pl, bv[i][0], bv[i][1]);
            mma_bf16(acc[2 * (d0 + i) + 1], pl, bv[i][2], bv[i][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
  if (ra < n_rows) {
    __nv_bfloat16* dst = o + q_base + (static_cast<size_t>(qa) * h + kvh * g + ra % g) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[j][0] / la, acc[j][1] / la);
  }
  if (rb < n_rows) {
    __nv_bfloat16* dst = o + q_base + (static_cast<size_t>(qb) * h + kvh * g + rb % g) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[j][2] / lb, acc[j][3] / lb);
  }
  // the row log-sum-exp in natural units: m is in the log2 domain
  if (lse != nullptr && tig == 0) {
    const size_t head_row = static_cast<size_t>(b) * h + kvh * g;
    if (ra < n_rows) lse[(head_row + ra % g) * s_len + qa] = m_a * LN2 + logf(la);
    if (rb < n_rows) lse[(head_row + rb % g) * s_len + qb] = m_b * LN2 + logf(lb);
  }
}

template <int D, bool P_BF16>
int launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
               int s, int t, int h, int kv, int causal, int window, float scale,
               cudaStream_t stream) {
  using L = FmLayout<D>;
  static std::atomic<bool> raised[MAX_DEVICES];
  const cudaError_t err =
      allow_dynamic_smem(flash_attention_mma_kernel<D, P_BF16>, L::BYTES, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_rows = s * (h / kv);
  const dim3 grid((n_rows + FM_ROWS - 1) / FM_ROWS, batch * kv);
  flash_attention_mma_kernel<D, P_BF16><<<grid, FM_THREADS, L::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, s, t, h, kv,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mma_for_p(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                     int s, int t, int h, int kv, int causal, int window, float scale,
                     int p_bf16, cudaStream_t stream) {
  return p_bf16
      ? launch_mma<D, true>(q, k, v, o, lse, batch, s, t, h, kv, causal, window, scale, stream)
      : launch_mma<D, false>(q, k, v, o, lse, batch, s, t, h, kv, causal, window, scale, stream);
}

// ---------------------------------------------------------------------------
// backward: Delta, then dK and dV, then dQ; the fma route (float32 FMA)
// ---------------------------------------------------------------------------

// The fma route's tiles.  A dK/dV block owns FB_KEYS keys and walks items
// of FB_QUERIES queries of one query head; a dQ block owns FB_QUERIES
// queries of one head and walks key tiles of FB_KEYS.
constexpr int FB_KEYS = 64;
constexpr int FB_QUERIES = 32;
constexpr int FB_MAX_RANKS = 8;        // dK/dV's cluster size: at most the portable 8
constexpr int FB_WAVE_BLOCKS = 240;    // build.ONE_WAVE_BLOCKS: two blocks an SM

// The query tiles [*qt0, *qt0 + *n_qt) of FB_QUERIES rows that hold a row
// keeping a key of key tile kt: causal from k0 on, a window up to the last
// key + window - 1.  The items of key tile kt are (head gi, query tile
// qt0 + j) in the order gi * n_qt + j, gi over the G heads of the group.
__host__ __device__ inline void fb_query_tiles(int kt, int s_len, int t_len, int causal,
                                               int window, int* qt0, int* n_qt) {
  const int k0 = kt * FB_KEYS;
  const int k_last = (k0 + FB_KEYS < t_len ? k0 + FB_KEYS : t_len) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? (s_len - 1 < k_last + window - 1 ? s_len - 1 : k_last + window - 1)
                              : s_len - 1;
  *qt0 = q_lo / FB_QUERIES;
  *n_qt = q_lo <= q_hi ? q_hi / FB_QUERIES - *qt0 + 1 : 0;
}

// The first item of rank r's share of n items over `ranks` ranks:
// contiguous shares in item order, sizes within one of each other
__host__ __device__ inline int fb_share(int n, int r, int ranks) {
  return static_cast<int>(static_cast<long long>(n) * r / ranks);
}

// dK/dV's cluster size, a pure function of the shape (as
// kernels/flash_attention.py:fma_dkdv_ranks, build.split_ranks): the
// largest power of two up to FB_MAX_RANKS that keeps the grid (batch * kv
// * key tiles * R blocks) within one wave and gives every rank of the
// busiest key tile an item.  At D >= 112 a block fills an SM's shared
// memory, so the wave is half as many blocks.
inline int fb_dkdv_ranks(int batch, int s, int t, int h, int kv, int d, int causal, int window) {
  const int g = h / kv;
  const int n_kt = (t + FB_KEYS - 1) / FB_KEYS;
  long long most = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    int qt0 = 0, n_qt = 0;
    fb_query_tiles(kt, s, t, causal, window, &qt0, &n_qt);
    most = std::max(most, static_cast<long long>(g) * n_qt);
  }
  const long long tiles = std::max(1LL, static_cast<long long>(batch) * kv * n_kt);
  const long long wave = d >= 112 ? FB_WAVE_BLOCKS / 2 : FB_WAVE_BLOCKS;
  const long long want = std::min(std::min(static_cast<long long>(FB_MAX_RANKS), wave / tiles), most);
  int ranks = 1;
  while (2 * ranks <= want) ranks *= 2;
  return ranks;
}

// lse and Delta of rows [q0, q0 + FB_QUERIES) of one head (float32 (B, H,
// S), `stat` the head's first row) -> lse_d, delta_d, zero past s_len
template <int THREADS>
__device__ __forceinline__ void fb_stage_stats(float* lse_d, float* delta_d,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta, size_t stat,
                                               int q0, int s_len) {
  for (int e = threadIdx.x; e < 2 * FB_QUERIES; e += THREADS) {
    const int r = e % FB_QUERIES;
    const float* src = e < FB_QUERIES ? lse : delta;
    const bool ok = q0 + r < s_len;
    cp_async4((e < FB_QUERIES ? lse_d : delta_d) + r, ok ? src + stat + q0 + r : src, ok ? 4 : 0);
  }
}

// Delta[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d] in float32, rows in
// (b, s, h) order.  What bounds it: bytes (both inputs read once), so the
// design keeps many 16-byte loads in flight.  A row's E-element chunks (4
// float32 or 8 bf16, 16 bytes) go one to a lane, LPR lanes a row (the
// chunks' count rounded up to a power of two; lanes past it add 0, D =
// 112 in float32 masks 4 of 32), 32 / LPR rows a warp at a time; each
// warp loads FD_GROUPS such groups of rows, both inputs, before it adds
// any, and walks its groups by grid stride.  The grid (fd_plan) is at
// most one wave, with about one block an SM on a small input (train_lm's
// 9216 rows: 128 blocks of 18 warps): a launch's fixed cost grows with its
// blocks, and an SM with one block more than the others sets the time.
// Fixed order (delta_in_kernel_order in kernels/flash_attention.py): a
// lane's E products, each rounded (no FMA), added pairwise ((p0 + p1) +
// (p2 + p3)), then the LPR lanes by a shuffle tree.  VEC16: 16-byte loads
// (o and dout on the 16-byte grid; D * itemsize is a multiple of 16 at
// every head size, so every row is); otherwise masked scalar loads of the
// same chunks, the same sums.
constexpr int FD_GROUPS = 2;        // groups a warp loads at once: 2 ran faster than 4 and 8
constexpr int FD_SMS = 132;          // H100 SXM
constexpr int FD_SM_WARPS = 64;      // resident warps an SM
constexpr int FD_MAX_WARPS = 32;     // warps a block

// the lanes a row takes at head size d: its chunks rounded up to a power of two
template <typename T>
__host__ __device__ inline int fd_lanes(int d) {
  const int chunks = d / (16 / static_cast<int>(sizeof(T)));
  int lanes = 1;
  while (lanes < chunks) lanes <<= 1;
  return lanes;
}

// Delta's launch over n_rows rows (kernels/flash_attention.py:delta_plan):
// the warps' passes (FD_GROUPS groups of rows each) spread over about one
// block an SM, up to FD_MAX_WARPS warps a block, at most one wave
struct FdPlan {
  int warps, blocks;
};

template <typename T>
inline FdPlan fd_plan(long long n_rows, int d) {
  const long long per_pass = static_cast<long long>(32 / fd_lanes<T>(d)) * FD_GROUPS;
  const long long passes = (n_rows + per_pass - 1) / per_pass;
  const long long warps = std::min<long long>(
      std::max<long long>((passes + FD_SMS - 1) / FD_SMS, 1), FD_MAX_WARPS);
  FdPlan p;
  p.warps = static_cast<int>(warps);
  p.blocks = static_cast<int>(std::min<long long>((passes + warps - 1) / warps,
                                                  FD_SMS * (FD_SM_WARPS / warps)));
  return p;
}

template <typename T, bool VEC16>
__global__ void __launch_bounds__(32 * FD_MAX_WARPS)
flash_attention_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                 float* __restrict__ delta, int n_rows, int s_len, int h,
                                 int d) {
  constexpr int E = Chunk<T>::E;
  const int chunks = d / E;
  const int lanes = fd_lanes<T>(d);
  const int rpw = 32 / lanes;                       // rows a warp adds at a time
  const int lane = threadIdx.x & 31;
  const int sub = lane / lanes, c = lane % lanes;   // the lane's row of the group, its chunk
  const int warp = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int warps = static_cast<int>((gridDim.x * blockDim.x) >> 5);
  const int step = rpw * FD_GROUPS;
  for (int base = warp * step; base < n_rows; base += warps * step) {   // warp-uniform
    uint4 uo[FD_GROUPS], ud[FD_GROUPS];
#pragma unroll
    for (int u = 0; u < FD_GROUPS; ++u) {
      const int row = base + u * rpw + sub;
      const bool ok = row < n_rows && c < chunks;
      const size_t off = ok ? static_cast<size_t>(row) * d : 0;
      uo[u] = load_chunk<T, VEC16, true>(o + off, c, d, ok);
      ud[u] = load_chunk<T, VEC16, true>(dout + off, c, d, ok);
    }
#pragma unroll
    for (int u = 0; u < FD_GROUPS; ++u) {
      float fo[E], fd[E];
      Chunk<T>::unpack(uo[u], fo);
      Chunk<T>::unpack(ud[u], fd);
#pragma unroll
      for (int e = 0; e < E; ++e) fo[e] = __fmul_rn(fd[e], fo[e]);
#pragma unroll
      for (int w = E / 2; w > 0; w >>= 1)
#pragma unroll
        for (int e = 0; e < w; ++e) fo[e] = __fadd_rn(fo[2 * e], fo[2 * e + 1]);
      float sum = fo[0];
      for (int off = lanes / 2; off > 0; off >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      const int row = base + u * rpw + sub;
      if (c == 0 && row < n_rows) {
        const int bs = row / h, head = row - bs * h;   // bs = b * s_len + s
        const int b = bs / s_len, s = bs - b * s_len;
        delta[(static_cast<size_t>(b) * h + head) * s_len + s] = sum;
      }
    }
  }
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, long long n_rows,
                 long long plan_rows, int s, int h, int d, int vec16, cudaStream_t stream) {
  if (n_rows > 0x7fffffffLL - 32 * FD_GROUPS || plan_rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const FdPlan p = fd_plan<T>(plan_rows, d);
  if (p.blocks <= 0) return 0;
  const int rows = static_cast<int>(n_rows);
  if (vec16)
    flash_attention_bwd_delta_kernel<T, true><<<p.blocks, 32 * p.warps, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, s, h, d);
  else
    flash_attention_bwd_delta_kernel<T, false><<<p.blocks, 32 * p.warps, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, s, h, d);
  return static_cast<int>(cudaGetLastError());
}

// dK/dV's layout.  The d side is padded to DP (D = 112 -> 128: columns
// past D are computed from whatever the pad holds and never stored), rows
// of DS = DP + 4 floats so that the eight rows a quarter warp reads by
// 128-bit loads fall in distinct banks.  S^T and dP^T: a thread forms AK
// keys x AQ queries (keys kg + 16 i, queries qg + QG j, qg the fast index,
// so a quarter warp shares its K and V loads); dV and dK: BK keys x 4
// columns (keys bkg + BKG i, columns 4 cg .. 4 cg + 3).
template <int D>
struct FbKv {
  static constexpr int DP = D == 112 ? 128 : D;
  static constexpr int DS = DP + 4;
  static constexpr int PS = FB_QUERIES + 8;       // P~^T, dS^T rows: 4 keys a warp, no conflict
  static constexpr int THREADS = DP == 128 ? 256 : 128;
  static constexpr int AK = 4;
  static constexpr int AQ = FB_KEYS * FB_QUERIES / THREADS / AK;   // 4, or 2 at DP = 128
  static constexpr int QG = FB_QUERIES / AQ;
  static constexpr int KG = FB_KEYS / AK;
  static constexpr int CG = DP / 4;
  static constexpr int BK = FB_KEYS * CG / THREADS;                  // 2, 4, 8, 8
  static constexpr int BKG = FB_KEYS / BK;
  static constexpr int TILE_K = FB_KEYS * DS;
  static constexpr int TILE_Q = FB_QUERIES * DS;
  // K, V; two stages of (Q, dO); P~^T, dS^T; two stages of (lse, Delta)
  static constexpr int BYTES =
      (2 * TILE_K + 4 * TILE_Q + 2 * FB_KEYS * PS + 4 * FB_QUERIES) * 4;
  static_assert(QG * KG == THREADS && BKG * CG == THREADS, "threads must cover the tiles");
  static_assert(2 * FB_KEYS * DP <= 4 * TILE_Q, "the partial sums must fit the Q, dO stages");
};

// dK and dV of one 64-key tile of one KV head, its walk split over the R
// blocks of a thread-block cluster.  The key tile's items, (head gi, query
// tile j) in the order gi * n_qt + j (fb_query_tiles), are cut into R
// contiguous shares (fb_share); rank r walks its share with K and V in
// shared memory, each item's Q, dO, lse and Delta copied two deep by
// cp.async (the next item's while this one is computed).  Per item: S^T =
// K Q^T and dP^T = V dO^T (AK x AQ a thread, 128-bit loads along d, 8 FMA
// a load at AQ = 4); P = exp(S^T scale - lse) under the forward's mask,
// P~ (bf16(P) when p_bf16, as the forward's PV product) and dS = P (dP -
// Delta) into shared memory; then dV += P~^T dO and dK += dS^T Q (BK x 4
// a thread, 128-bit loads along queries and along d, 10.7 FMA a load at
// BK = 8).  At the end each rank leaves its partial dK and dV in its
// stage buffers, and the ranks add them in rank order through distributed
// shared memory, each rank a share of the tile, and store them, dK scaled
// once (common.cuh: cluster_sum_rank_order_spread; the leader alone, as
// cluster_sum_rank_order, ran slower at train_lm's shape): the GQA sum in
// a fixed order, no atomics.  Blocks are issued key tile 0 first: under
// the causal mask it has the most items.  What bounds it on the H100: its
// FMA issue rate (15 % of its operation bound at train_lm's shape), not
// its shared-memory loads (a layout with twice the FMA a load ran
// slower), and there the busiest rank's 5 items.
template <typename T, int D>
__global__ void __launch_bounds__(FbKv<D>::THREADS)
flash_attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const T* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                T* __restrict__ dk, T* __restrict__ dv, int n_bkv, int ranks,
                                int s_len, int t_len, int h, int kv, int causal, int window,
                                float scale, int p_bf16, int vec16) {
  using L = FbKv<D>;
  extern __shared__ __align__(16) float fb_smem[];
  float* ks = fb_smem;                        // [64][DS] the key tile
  float* vs = ks + L::TILE_K;                 // [64][DS] its values
  float* qs = vs + L::TILE_K;                 // [2][32][DS] an item's queries
  float* dos = qs + 2 * L::TILE_Q;            // [2][32][DS] their dO
  float* ps = dos + 2 * L::TILE_Q;            // [64 keys][PS] P~^T
  float* dss = ps + FB_KEYS * L::PS;          // [64 keys][PS] dS^T
  float* lse_s = dss + FB_KEYS * L::PS;       // [2][32]
  float* delta_s = lse_s + 2 * FB_QUERIES;    // [2][32]

  const int g = h / kv;
  const int rank = static_cast<int>(blockIdx.x) % ranks;
  const int tile = static_cast<int>(blockIdx.x) / ranks;
  const int kt = tile / n_bkv;
  const int bkv = tile % n_bkv;
  const int b = bkv / kv, kvh = bkv % kv;
  const int k0 = kt * FB_KEYS;
  const size_t q_base = static_cast<size_t>(b) * s_len * h * D;
  const size_t kv_off = static_cast<size_t>(b) * t_len * kv * D + static_cast<size_t>(kvh) * D;
  const size_t q_row = static_cast<size_t>(h) * D;     // elements between a head's rows
  const size_t k_row = static_cast<size_t>(kv) * D;

  int qt0 = 0, n_qt = 0;
  fb_query_tiles(kt, s_len, t_len, causal, window, &qt0, &n_qt);
  const int n_items = g * n_qt;
  const int i0 = fb_share(n_items, rank, ranks), i1 = fb_share(n_items, rank + 1, ranks);

  // item i's Q, dO rows and their lse, Delta -> stage st
  auto load_item = [&](int i, int st) {
    const int head = kvh * g + i / n_qt;
    const int q0 = (qt0 + i % n_qt) * FB_QUERIES;
    const size_t off = q_base + static_cast<size_t>(head) * D;
    fb_stage_rows<T, D, L::DS, L::THREADS>(qs + st * L::TILE_Q, q + off, q_row, q0, FB_QUERIES,
                                           s_len, vec16);
    fb_stage_rows<T, D, L::DS, L::THREADS>(dos + st * L::TILE_Q, dout + off, q_row, q0,
                                           FB_QUERIES, s_len, vec16);
    fb_stage_stats<L::THREADS>(lse_s + st * FB_QUERIES, delta_s + st * FB_QUERIES, lse, delta,
                               (static_cast<size_t>(b) * h + head) * s_len, q0, s_len);
  };
  fb_stage_rows<T, D, L::DS, L::THREADS>(ks, k + kv_off, k_row, k0, FB_KEYS, t_len, vec16);
  fb_stage_rows<T, D, L::DS, L::THREADS>(vs, v + kv_off, k_row, k0, FB_KEYS, t_len, vec16);
  if (i0 < i1) load_item(i0, 0);
  cp_async_commit();

  const int qg = threadIdx.x % L::QG, kg = threadIdx.x / L::QG;     // S^T, dP^T
  const int cg = threadIdx.x % L::CG, bkg = threadIdx.x / L::CG;    // dV, dK
  float dk_acc[L::BK][4], dv_acc[L::BK][4];
#pragma unroll
  for (int i = 0; i < L::BK; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  for (int item = i0; item < i1; ++item) {
    const int st = (item - i0) & 1;
    cp_async_wait<0>();           // this thread's copies of the item have landed;
    __syncthreads();              // everyone's, and the last item is done with stage st ^ 1,
                                  // P~^T and dS^T
    if (item + 1 < i1) load_item(item + 1, st ^ 1);
    cp_async_commit();
    const float* qt = qs + st * L::TILE_Q;
    const float* dot = dos + st * L::TILE_Q;
    const float* lse_t = lse_s + st * FB_QUERIES;
    const float* delta_t = delta_s + st * FB_QUERIES;
    const int q0 = (qt0 + item % n_qt) * FB_QUERIES;

    float sT[L::AK][L::AQ], dpT[L::AK][L::AQ];
#pragma unroll
    for (int i = 0; i < L::AK; ++i)
#pragma unroll
      for (int j = 0; j < L::AQ; ++j) sT[i][j] = dpT[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[L::AK], bq[L::AQ];
#pragma unroll
      for (int i = 0; i < L::AK; ++i) a[i] = ld4(ks + (kg + L::KG * i) * L::DS + d);
#pragma unroll
      for (int j = 0; j < L::AQ; ++j) bq[j] = ld4(qt + (qg + L::QG * j) * L::DS + d);
#pragma unroll
      for (int i = 0; i < L::AK; ++i)
#pragma unroll
        for (int j = 0; j < L::AQ; ++j) sT[i][j] = dot4(a[i], bq[j], sT[i][j]);
#pragma unroll
      for (int i = 0; i < L::AK; ++i) a[i] = ld4(vs + (kg + L::KG * i) * L::DS + d);
#pragma unroll
      for (int j = 0; j < L::AQ; ++j) bq[j] = ld4(dot + (qg + L::QG * j) * L::DS + d);
#pragma unroll
      for (int i = 0; i < L::AK; ++i)
#pragma unroll
        for (int j = 0; j < L::AQ; ++j) dpT[i][j] = dot4(a[i], bq[j], dpT[i][j]);
    }
#pragma unroll
    for (int j = 0; j < L::AQ; ++j) {
      const int qq = qg + L::QG * j;
      const int qpos = q0 + qq;
      const float l = lse_t[qq], dl = delta_t[qq];
#pragma unroll
      for (int i = 0; i < L::AK; ++i) {
        const int key = kg + L::KG * i;
        const bool ok = qpos < s_len && fa_keep(qpos, k0 + key, t_len, causal, window);
        const float p = ok ? expf(sT[i][j] * scale - l) : 0.0f;
        ps[key * L::PS + qq] = p_bf16 ? __bfloat162float(__float2bfloat16_rn(p)) : p;
        dss[key * L::PS + qq] = p * (dpT[i][j] - dl);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int r = 0; r < FB_QUERIES; r += 4) {
      float4 pv[L::BK], ov[4];
#pragma unroll
      for (int i = 0; i < L::BK; ++i) pv[i] = ld4(ps + (bkg + L::BKG * i) * L::PS + r);
#pragma unroll
      for (int e = 0; e < 4; ++e) ov[e] = ld4(dot + (r + e) * L::DS + 4 * cg);
#pragma unroll
      for (int i = 0; i < L::BK; ++i) {
        axpy4(dv_acc[i], pv[i].x, ov[0]);
        axpy4(dv_acc[i], pv[i].y, ov[1]);
        axpy4(dv_acc[i], pv[i].z, ov[2]);
        axpy4(dv_acc[i], pv[i].w, ov[3]);
      }
#pragma unroll
      for (int i = 0; i < L::BK; ++i) pv[i] = ld4(dss + (bkg + L::BKG * i) * L::PS + r);
#pragma unroll
      for (int e = 0; e < 4; ++e) ov[e] = ld4(qt + (r + e) * L::DS + 4 * cg);
#pragma unroll
      for (int i = 0; i < L::BK; ++i) {
        axpy4(dk_acc[i], pv[i].x, ov[0]);
        axpy4(dk_acc[i], pv[i].y, ov[1]);
        axpy4(dk_acc[i], pv[i].z, ov[2]);
        axpy4(dk_acc[i], pv[i].w, ov[3]);
      }
    }
  }

  // the partial sums -> the stage buffers ([2][64][CG] float4: dK's, then
  // dV's), added over the cluster in rank order and stored
  cp_async_wait<0>();
  __syncthreads();                // every thread is done with the stages
  float4* part = reinterpret_cast<float4*>(qs);
#pragma unroll
  for (int i = 0; i < L::BK; ++i) {
    const int key = bkg + L::BKG * i;
    part[key * L::CG + cg] = make_float4(dk_acc[i][0], dk_acc[i][1], dk_acc[i][2], dk_acc[i][3]);
    part[(FB_KEYS + key) * L::CG + cg] =
        make_float4(dv_acc[i][0], dv_acc[i][1], dv_acc[i][2], dv_acc[i][3]);
  }
  cluster_sum_rank_order_spread(part, 2 * FB_KEYS * L::CG, [&](int e, float4 x) {
    const int row = e / L::CG, c = (e % L::CG) * 4;
    const int kpos = k0 + row % FB_KEYS;
    if (c >= D || kpos >= t_len) return;
    const bool is_dk = row < FB_KEYS;
    const float f = is_dk ? scale : 1.0f;
    T* dst = (is_dk ? dk : dv) + kv_off + static_cast<size_t>(kpos) * k_row + c;
    store_as(dst, x.x * f);
    store_as(dst + 1, x.y * f);
    store_as(dst + 2, x.z * f);
    store_as(dst + 3, x.w * f);
  });
}

// dQ's layout: the d side padded as dK/dV's.  S and dP: a thread forms AQ
// = 4 queries x AK keys (queries qg + 8 j, keys kg + KG i, kg the fast
// index, so a quarter warp shares its Q and dO loads); dQ: BQ queries x 4
// columns.  Threads from 64 at D <= 32 to 256 at D >= 112, so that both
// tiles keep at least 4 FMA a load.
template <int D>
struct FbQ {
  static constexpr int DP = D == 112 ? 128 : D;
  static constexpr int DS = DP + 4;
  static constexpr int SS = FB_KEYS + 16;          // dS rows: 2 queries a warp, no conflict
  static constexpr int THREADS = DP <= 32 ? 64 : (DP == 64 ? 128 : 256);
  static constexpr int AQ = 4;
  static constexpr int AK = FB_KEYS * FB_QUERIES / THREADS / AQ;   // 8, 4, 2
  static constexpr int KG = FB_KEYS / AK;
  static constexpr int QG = FB_QUERIES / AQ;
  static constexpr int CG = DP / 4;
  static constexpr int BQ = FB_QUERIES * CG / THREADS;              // 2 at D = 16, else 4
  static constexpr int BQG = FB_QUERIES / BQ;
  static constexpr int TILE_K = FB_KEYS * DS;
  static constexpr int TILE_Q = FB_QUERIES * DS;
  // Q, dO; two stages of (K, V); dS; lse, Delta
  static constexpr int BYTES = (2 * TILE_Q + 4 * TILE_K + FB_QUERIES * SS + 2 * FB_QUERIES) * 4;
  static_assert(QG * KG == THREADS && BQG * CG == THREADS, "threads must cover the tiles");
};

// dQ of 32 queries of one head: Q, dO, lse and Delta copied once, the key
// tiles of the forward's range (64 keys) two deep by cp.async.  Per key
// tile: S = Q K^T and dP = dO V^T (4 x AK a thread, 128-bit loads along
// d); dS = P (dP - Delta) under the mask into shared memory; dQ += dS K
// (BQ x 4 a thread, 128-bit loads along keys and d).  Scaled and stored
// once.  Blocks are issued latest queries first (causal work grows with
// the query position).  Each element sums over d, then over the keys in
// order, tile by tile.  What bounds it on
// the H100: its FMA issue rate (19 % of its operation bound at train_lm's
// shape), and there 288 blocks, a little over one wave of 264 (two an SM).
template <typename T, int D>
__global__ void __launch_bounds__(FbQ<D>::THREADS)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              T* __restrict__ dq, int n_bh, int s_len, int t_len, int h, int kv,
                              int causal, int window, float scale, int vec16) {
  using L = FbQ<D>;
  extern __shared__ __align__(16) float fb_smem[];
  float* qs = fb_smem;                        // [32][DS] the block's queries
  float* dos = qs + L::TILE_Q;                // [32][DS] their dO
  float* ks = dos + L::TILE_Q;                // [2][64][DS] a key tile
  float* vs = ks + 2 * L::TILE_K;             // [2][64][DS] its values
  float* dss = vs + 2 * L::TILE_K;            // [32][SS] dS
  float* lse_s = dss + FB_QUERIES * L::SS;    // [32]
  float* delta_s = lse_s + FB_QUERIES;        // [32]

  const int g = h / kv;
  const int n_tiles = (s_len + FB_QUERIES - 1) / FB_QUERIES;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / n_bh;
  const int bh = static_cast<int>(blockIdx.x) % n_bh;
  const int b = bh / h, head = bh % h, kvh = head / g;
  const int q0 = tile * FB_QUERIES;
  const size_t q_off = static_cast<size_t>(b) * s_len * h * D + static_cast<size_t>(head) * D;
  const size_t kv_off = static_cast<size_t>(b) * t_len * kv * D + static_cast<size_t>(kvh) * D;
  const size_t q_row = static_cast<size_t>(h) * D;
  const size_t k_row = static_cast<size_t>(kv) * D;

  // the forward's key range for these rows
  const int q_hi = min(q0 + FB_QUERIES, s_len) - 1;
  int k_hi = t_len - 1;
  if (causal) k_hi = min(k_hi, q_hi);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt0 = k_lo / FB_KEYS;
  const int n_kt = k_lo <= k_hi ? k_hi / FB_KEYS - kt0 + 1 : 0;

  fb_stage_rows<T, D, L::DS, L::THREADS>(qs, q + q_off, q_row, q0, FB_QUERIES, s_len, vec16);
  fb_stage_rows<T, D, L::DS, L::THREADS>(dos, dout + q_off, q_row, q0, FB_QUERIES, s_len, vec16);
  fb_stage_stats<L::THREADS>(lse_s, delta_s, lse, delta,
                             (static_cast<size_t>(b) * h + head) * s_len, q0, s_len);
  if (n_kt > 0) {
    fb_stage_rows<T, D, L::DS, L::THREADS>(ks, k + kv_off, k_row, kt0 * FB_KEYS, FB_KEYS, t_len,
                                           vec16);
    fb_stage_rows<T, D, L::DS, L::THREADS>(vs, v + kv_off, k_row, kt0 * FB_KEYS, FB_KEYS, t_len,
                                           vec16);
  }
  cp_async_commit();

  const int kg = threadIdx.x % L::KG, qg = threadIdx.x / L::KG;     // S, dP
  const int cg = threadIdx.x % L::CG, bqg = threadIdx.x / L::CG;    // dQ
  float acc[L::BQ][4];
#pragma unroll
  for (int i = 0; i < L::BQ; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    const int k0 = (kt0 + it) * FB_KEYS;
    cp_async_wait<0>();
    __syncthreads();              // the tile has landed; the last one is done with
                                  // stage st ^ 1 and dS
    if (it + 1 < n_kt) {          // the next key tile loads while this one is computed
      fb_stage_rows<T, D, L::DS, L::THREADS>(ks + (st ^ 1) * L::TILE_K, k + kv_off, k_row,
                                             k0 + FB_KEYS, FB_KEYS, t_len, vec16);
      fb_stage_rows<T, D, L::DS, L::THREADS>(vs + (st ^ 1) * L::TILE_K, v + kv_off, k_row,
                                             k0 + FB_KEYS, FB_KEYS, t_len, vec16);
    }
    cp_async_commit();
    const float* kt = ks + st * L::TILE_K;
    const float* vt = vs + st * L::TILE_K;

    float sc[L::AQ][L::AK], dp[L::AQ][L::AK];
#pragma unroll
    for (int j = 0; j < L::AQ; ++j)
#pragma unroll
      for (int i = 0; i < L::AK; ++i) sc[j][i] = dp[j][i] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[L::AQ], bk[L::AK];
#pragma unroll
      for (int j = 0; j < L::AQ; ++j) a[j] = ld4(qs + (qg + L::QG * j) * L::DS + d);
#pragma unroll
      for (int i = 0; i < L::AK; ++i) bk[i] = ld4(kt + (kg + L::KG * i) * L::DS + d);
#pragma unroll
      for (int j = 0; j < L::AQ; ++j)
#pragma unroll
        for (int i = 0; i < L::AK; ++i) sc[j][i] = dot4(a[j], bk[i], sc[j][i]);
#pragma unroll
      for (int j = 0; j < L::AQ; ++j) a[j] = ld4(dos + (qg + L::QG * j) * L::DS + d);
#pragma unroll
      for (int i = 0; i < L::AK; ++i) bk[i] = ld4(vt + (kg + L::KG * i) * L::DS + d);
#pragma unroll
      for (int j = 0; j < L::AQ; ++j)
#pragma unroll
        for (int i = 0; i < L::AK; ++i) dp[j][i] = dot4(a[j], bk[i], dp[j][i]);
    }
#pragma unroll
    for (int j = 0; j < L::AQ; ++j) {
      const int qq = qg + L::QG * j;
      const int qpos = q0 + qq;
      const float l = lse_s[qq], dl = delta_s[qq];
#pragma unroll
      for (int i = 0; i < L::AK; ++i) {
        const int key = kg + L::KG * i;
        const bool ok = qpos < s_len && fa_keep(qpos, k0 + key, t_len, causal, window);
        const float p = ok ? expf(sc[j][i] * scale - l) : 0.0f;
        dss[qq * L::SS + key] = p * (dp[j][i] - dl);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < FB_KEYS; r += 4) {
      float4 dsv[L::BQ], kr[4];
#pragma unroll
      for (int i = 0; i < L::BQ; ++i) dsv[i] = ld4(dss + (bqg + L::BQG * i) * L::SS + r);
#pragma unroll
      for (int e = 0; e < 4; ++e) kr[e] = ld4(kt + (r + e) * L::DS + 4 * cg);
#pragma unroll
      for (int i = 0; i < L::BQ; ++i) {
        axpy4(acc[i], dsv[i].x, kr[0]);
        axpy4(acc[i], dsv[i].y, kr[1]);
        axpy4(acc[i], dsv[i].z, kr[2]);
        axpy4(acc[i], dsv[i].w, kr[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < L::BQ; ++i) {
    const int qpos = q0 + bqg + L::BQG * i;
    if (qpos >= s_len || 4 * cg >= D) continue;
    T* dst = dq + q_off + static_cast<size_t>(qpos) * q_row + 4 * cg;
#pragma unroll
    for (int c = 0; c < 4; ++c) store_as(dst + c, acc[i][c] * scale);
  }
}

// dK/dV's dynamic shared-memory limit raised once per device (float32 and
// bf16 instantiations share the layout)
template <typename T, int D>
cudaError_t dkdv_ready() {
  static std::atomic<bool> raised[MAX_DEVICES];
  return allow_dynamic_smem(flash_attention_bwd_dkdv_kernel<T, D>, FbKv<D>::BYTES, raised);
}

template <typename T, int D>
int launch_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int batch,
                    int s, int t, int h, int kv, int causal, int window, float scale,
                    int p_bf16, cudaStream_t stream) {
  using L = FbKv<D>;
  const cudaError_t err = dkdv_ready<T, D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ranks = fb_dkdv_ranks(batch, s, t, h, kv, D, causal, window);
  const long long blocks =
      static_cast<long long>(batch) * kv * ((t + FB_KEYS - 1) / FB_KEYS) * ranks;
  if (blocks > MAX_GRID_X) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_clustered(
      flash_attention_bwd_dkdv_kernel<T, D>, dim3(static_cast<unsigned>(blocks)), L::THREADS,
      L::BYTES, ranks, stream, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), batch * kv, ranks, s, t, h, kv, causal, window, scale, p_bf16,
      fb_vec16<T>(q, k, v, dout)));
}

// The plan of the dK/dV launch, for a test to hold against the Python one:
// plan[0] = R, plan[1] = clusters of R blocks the device runs at once,
// plan[2] = key tiles; then per key tile its first query tile, its query
// tiles, and the R + 1 bounds of the ranks' shares.
template <int D>
int dkdv_plan(int batch, int s, int t, int h, int kv, int causal, int window, int* plan,
              int plan_len) {
  using L = FbKv<D>;
  const int ranks = fb_dkdv_ranks(batch, s, t, h, kv, D, causal, window);
  const int n_kt = (t + FB_KEYS - 1) / FB_KEYS;
  if (plan_len < 3 + static_cast<long long>(n_kt) * (ranks + 3))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = dkdv_ready<float, D>();
  int clusters = 0;
  if (err == cudaSuccess)
    err = max_active_clusters(flash_attention_bwd_dkdv_kernel<float, D>, L::THREADS, L::BYTES,
                              ranks, &clusters);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = ranks;
  plan[1] = clusters;
  plan[2] = n_kt;
  for (int kt = 0; kt < n_kt; ++kt) {
    int* p = plan + 3 + kt * (ranks + 3);
    fb_query_tiles(kt, s, t, causal, window, &p[0], &p[1]);
    for (int r = 0; r <= ranks; ++r) p[2 + r] = fb_share((h / kv) * p[1], r, ranks);
  }
  return 0;
}

template <typename T, int D>
int launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dq, int batch, int s, int t,
                  int h, int kv, int causal, int window, float scale, cudaStream_t stream) {
  using L = FbQ<D>;
  static std::atomic<bool> raised[MAX_DEVICES];
  const cudaError_t err =
      allow_dynamic_smem(flash_attention_bwd_dq_kernel<T, D>, L::BYTES, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(batch) * h * ((s + FB_QUERIES - 1) / FB_QUERIES);
  if (blocks > MAX_GRID_X) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_bwd_dq_kernel<T, D>
      <<<static_cast<unsigned>(blocks), L::THREADS, L::BYTES, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), batch * h, s, t, h, kv,
          causal, window, scale, fb_vec16<T>(q, k, v, dout));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_for_dim(int which, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta, void* dq,
                       void* dk, void* dv, int batch, int s, int t, int h, int kv, int d,
                       int causal, int window, float scale, int p_bf16, cudaStream_t stream) {
#define REPRO_FA_BWD_CASE(DIM)                                                              \
  case DIM:                                                                                 \
    return which == 0 ? launch_bwd_dkdv<T, DIM>(q, k, v, dout, lse, delta, dk, dv, batch, s, \
                                                t, h, kv, causal, window, scale, p_bf16,    \
                                                stream)                                     \
                      : launch_bwd_dq<T, DIM>(q, k, v, dout, lse, delta, dq, batch, s, t, h, \
                                              kv, causal, window, scale, stream);
  switch (d) {
    REPRO_FA_BWD_CASE(16)
    REPRO_FA_BWD_CASE(32)
    REPRO_FA_BWD_CASE(64)
    REPRO_FA_BWD_CASE(112)
    REPRO_FA_BWD_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FA_BWD_CASE
}

// ---------------------------------------------------------------------------
// backward, mma route: bf16 tensor cores (mma.sync), as the forward's
// ---------------------------------------------------------------------------

constexpr int BM_WARPS = 8;                   // dK/dV: two warps per 16 keys of a 64-key tile
constexpr int BM_THREADS = BM_WARPS * 32;
constexpr int BM_ROWS = 64;                   // rows of R per staged dK/dV tile
constexpr int BM_PASS = 32;                   // rows (dK/dV) or keys (dQ) per pass of the products

template <int D>
struct BmLayout {
  static constexpr int LD = D + 8;            // row stride in bf16: a 16-byte pad
  static constexpr int CHUNKS = D / 8;        // 16-byte chunks per row
  static constexpr int TILE = 64 * LD;        // 64 keys or rows of D
  static constexpr int NG = D / 16;           // 16-column groups of the D side
  static constexpr int DG = NG < 4 ? NG : 4;  // groups held at once
  // dK/dV: K, V, then two stages of (Q, dO, lse, Delta)
  // (the two Q and dO stages, 4 TILE bf16, then hold the second warp
  // group's float32 sums, 4 warps x 2 x 16 x D floats = 4 TILE bf16 at
  // most: 512 D <= 512 (D + 8) bytes)
  static constexpr int DKDV_BYTES = (2 * TILE + 2 * 2 * TILE) * 2 + 2 * 2 * BM_ROWS * 4;
  // dQ: Q, dO (FM_ROWS rows each), then two stages of (K, V)
  static constexpr int DQ_BYTES = (2 * FM_ROWS * LD + 2 * 2 * TILE) * 2;
};

// rows [r0, r0 + ROWS) of R = qpos G + g of KV head kvh from a (S, H, D)
// slab at `src` -> dst [ROWS][LD] by 16-byte cp.async, zero past n_rows
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void bm_load_rows(const __nv_bfloat16* __restrict__ src,
                                             __nv_bfloat16* dst, int r0, int n_rows, int g,
                                             int h, int kvh) {
  using L = BmLayout<D>;
  for (int c = threadIdx.x; c < ROWS * L::CHUNKS; c += THREADS) {
    const int r = c / L::CHUNKS, cc = (c % L::CHUNKS) * 8;
    const int row = r0 + r;
    const bool ok = row < n_rows;
    const __nv_bfloat16* p =
        ok ? src + (static_cast<size_t>(row / g) * h + kvh * g + row % g) * D + cc : src;
    cp_async16(dst + r * L::LD + cc, p, ok ? 16 : 0);
  }
}

// keys [k0, k0 + 64) of one KV head's (T, KV, D) slab -> dst [64][LD], zero
// past t_len (fm_load_kv for THREADS threads)
template <int D, int THREADS>
__device__ __forceinline__ void bm_load_keys(const __nv_bfloat16* __restrict__ src,
                                             __nv_bfloat16* dst, int k0, int t_len, int kv) {
  using L = BmLayout<D>;
  for (int c = threadIdx.x; c < FA_KB * L::CHUNKS; c += THREADS) {
    const int r = c / L::CHUNKS, cc = (c % L::CHUNKS) * 8;
    const bool ok = k0 + r < t_len;
    const __nv_bfloat16* p = ok ? src + static_cast<size_t>(k0 + r) * kv * D + cc : src;
    cp_async16(dst + r * L::LD + cc, p, ok ? 16 : 0);
  }
}

// lse and Delta of rows [r0, r0 + 64) of R (float32 (B, H, S); stat_base
// is the KV head's first query head's row) -> lse_d, delta_d [64], zero
// past n_rows
__device__ __forceinline__ void bm_load_stats(const float* __restrict__ lse,
                                              const float* __restrict__ delta, float* lse_d,
                                              float* delta_d, size_t stat_base, int r0,
                                              int n_rows, int g, int s_len) {
  for (int i = threadIdx.x; i < 2 * BM_ROWS; i += BM_THREADS) {
    const int r = i % BM_ROWS, row = r0 + r;
    const float* src = i < BM_ROWS ? lse : delta;
    const bool ok = row < n_rows;
    const float* p = ok ? src + stat_base + static_cast<size_t>(row % g) * s_len + row / g : src;
    cp_async4((i < BM_ROWS ? lse_d : delta_d) + r, p, ok ? 4 : 0);
  }
}

// dK and dV of one 64-key tile of one KV head, on the tensor cores.
// Warps w and w + 4 own keys 16 w .. 16 w + 15 and hold their dK and dV
// rows in float32 accumulators, warp w over the first 32 rows of every row tile and warp
// w + 4 over the last 32; at the end warp w + 4 hands its sums to warp w
// through shared memory, which adds them in that order and stores.  (A
// first version with four warps a block, each over both halves, ran
// slower: at D = 128 the accumulators take the 255 registers a thread
// that let an SM hold eight warps, and its short causal key tiles left
// SMs idle.)  The block walks the 64-row tiles of R = qpos G + g that
// reach its keys, in one fixed order, staged two deep by cp.async (Q, dO,
// and each row's lse and Delta).  Per 32-row pass, with keys as the M
// dimension: S^T = K Q^T and dP^T = V dO^T (K and V as A fragments, Q and
// dO as B fragments, by ldmatrix); P^T = exp2(S^T scale log2(e) - lse
// log2(e)), masked only where the warp's keys and the pass's rows straddle
// the diagonal, the window edge or T; dS^T = P^T (dP^T - Delta) on the
// accumulators, which then are the A fragments of dV += P^T dO and dK +=
// dS^T Q (dO and Q as B fragments by ldmatrix.trans).  P and dS enter
// those products split, x = bf16(x) + bf16(x - bf16(x)), two products into
// one accumulator; with P_BF16, dV takes bf16(P) alone.  Rows past S * G
// load as zero Q, dO, lse and Delta, so they add exactly zero (P = 1,
// dO = 0, dS = 0); a warp skips a pass that the causal mask or the window
// hides from all its keys.  Blocks are issued key tile 0 first: under the
// causal mask it reaches the most rows.  (Pairing key tile i with tile
// n - 1 - i in one block, to even out the causal triangle, ran slower on
// the H100: PERF.md.)
template <int D, bool P_BF16>
__global__ void __launch_bounds__(BM_THREADS, 1)
flash_attention_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                    const __nv_bfloat16* __restrict__ k,
                                    const __nv_bfloat16* __restrict__ v,
                                    const __nv_bfloat16* __restrict__ dout,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta,
                                    __nv_bfloat16* __restrict__ dk,
                                    __nv_bfloat16* __restrict__ dv, int n_bkv, int s_len,
                                    int t_len, int h, int kv, int causal, int window,
                                    float scale) {
  using L = BmLayout<D>;
  extern __shared__ __align__(128) unsigned char bm_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(bm_smem);   // [64][LD]
  __nv_bfloat16* vs = ks + L::TILE;                                  // [64][LD]
  __nv_bfloat16* qs = vs + L::TILE;                                  // [2][64][LD]
  __nv_bfloat16* dos = qs + 2 * L::TILE;                             // [2][64][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * L::TILE);        // [2][64]
  float* delta_s = lse_s + 2 * BM_ROWS;                              // [2][64]

  const int g = h / kv;
  const int n_rows = s_len * g;
  const int kt = static_cast<int>(blockIdx.x) / n_bkv;   // key tile 0 first
  const int bkv = static_cast<int>(blockIdx.x) % n_bkv;
  const int b = bkv / kv, kvh = bkv % kv;
  const size_t q_base = static_cast<size_t>(b) * s_len * h * D;
  const size_t kv_off = static_cast<size_t>(b) * t_len * kv * D + static_cast<size_t>(kvh) * D;
  const size_t stat_base = (static_cast<size_t>(b) * h + static_cast<size_t>(kvh) * g) * s_len;
  const __nv_bfloat16* qh = q + q_base;
  const __nv_bfloat16* doh = dout + q_base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const float scale2 = scale * LOG2E;

  const int k0 = kt * FA_KB;
  const int k_last = min(k0 + FA_KB, t_len) - 1;
  // rows of R that keep a key of the tile: causal from qpos k0 on, a
  // window up to qpos k_last + window - 1
  const int r_lo = causal ? k0 * g : 0;
  const int r_hi =
      window > 0 ? min(s_len - 1, k_last + min(window, s_len) - 1) * g + g - 1 : n_rows - 1;
  const int rt0 = r_lo / BM_ROWS;
  const int n_rt = r_lo <= r_hi ? r_hi / BM_ROWS - rt0 + 1 : 0;

  bm_load_keys<D, BM_THREADS>(k + kv_off, ks, k0, t_len, kv);
  bm_load_keys<D, BM_THREADS>(v + kv_off, vs, k0, t_len, kv);
  if (n_rt > 0) {
    bm_load_rows<D, BM_ROWS, BM_THREADS>(qh, qs, rt0 * BM_ROWS, n_rows, g, h, kvh);
    bm_load_rows<D, BM_ROWS, BM_THREADS>(doh, dos, rt0 * BM_ROWS, n_rows, g, h, kvh);
    bm_load_stats(lse, delta, lse_s, delta_s, stat_base, rt0 * BM_ROWS, n_rows, g, s_len);
  }
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;
  const int wk_lo = k0 + (warp & 3) * 16, wk_hi = wk_lo + 15;   // this warp's keys
  const int key_a = wk_lo + gid, key_b = key_a + 8;            // this thread's
  const int pass = warp >> 2;                                  // its half of a row tile

  for (int it = 0; it < n_rt; ++it) {
    const int st = it & 1;
    const int r0 = (rt0 + it) * BM_ROWS;
    cp_async_wait<0>();           // this thread's copies of tile it have landed;
    __syncthreads();              // everyone's, and tile it - 1 is done with stage st ^ 1
    if (it + 1 < n_rt) {          // tile it + 1 loads while tile it is computed
      const int r1 = r0 + BM_ROWS;
      bm_load_rows<D, BM_ROWS, BM_THREADS>(qh, qs + (st ^ 1) * L::TILE, r1, n_rows, g, h, kvh);
      bm_load_rows<D, BM_ROWS, BM_THREADS>(doh, dos + (st ^ 1) * L::TILE, r1, n_rows, g, h,
                                           kvh);
      bm_load_stats(lse, delta, lse_s + (st ^ 1) * BM_ROWS, delta_s + (st ^ 1) * BM_ROWS,
                    stat_base, r1, n_rows, g, s_len);
    }
    cp_async_commit();
    const __nv_bfloat16* qt = qs + st * L::TILE;
    const __nv_bfloat16* dot = dos + st * L::TILE;
    const float* lse_t = lse_s + st * BM_ROWS;
    const float* delta_t = delta_s + st * BM_ROWS;

    const int p0 = r0 + pass * BM_PASS;
    const int pq_lo = p0 / g, pq_hi = (min(p0 + BM_PASS, n_rows) - 1) / g;
    // rows past S * G, or no key of this warp kept for any row of the pass
    const bool idle = p0 >= n_rows || wk_lo >= t_len || (causal && wk_lo > pq_hi) ||
                      (window > 0 && wk_hi <= pq_lo - window);
    if (!idle) {
      const bool edge = wk_hi >= t_len || (causal && wk_hi > pq_lo) ||
                        (window > 0 && wk_lo <= pq_hi - window);
      const __nv_bfloat16* qp = qt + pass * BM_PASS * L::LD;
      const __nv_bfloat16* dop = dot + pass * BM_PASS * L::LD;

      // S^T, dP^T: 16 keys x 32 rows per warp, float32
      float sT[BM_PASS / 8][4], dpT[BM_PASS / 8][4];
#pragma unroll
      for (int j = 0; j < BM_PASS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.0f;
#pragma unroll
      for (int kd = 0; kd < L::NG; ++kd) {
        uint32_t ka[4], va[4], qb[BM_PASS / 16][4], ob[BM_PASS / 16][4];
        const int a_off = ((warp & 3) * 16 + (lane & 15)) * L::LD + kd * 16 + (lane >> 4) * 8;
        ldmatrix_x4(ka, ks + a_off);
        ldmatrix_x4(va, vs + a_off);
#pragma unroll
        for (int np = 0; np < BM_PASS / 16; ++np) {
          const int b_off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * L::LD + kd * 16 +
                            ((lane >> 3) & 1) * 8;
          ldmatrix_x4(qb[np], qp + b_off);
          ldmatrix_x4(ob[np], dop + b_off);
        }
#pragma unroll
        for (int np = 0; np < BM_PASS / 16; ++np) {
          mma_bf16(sT[2 * np], ka, qb[np][0], qb[np][1]);
          mma_bf16(sT[2 * np + 1], ka, qb[np][2], qb[np][3]);
          mma_bf16(dpT[2 * np], va, ob[np][0], ob[np][1]);
          mma_bf16(dpT[2 * np + 1], va, ob[np][2], ob[np][3]);
        }
      }

      // P^T and dS^T in place: accumulator rows are keys key_a (e = 0, 1)
      // and key_b (e = 2, 3), columns the pass's rows
#pragma unroll
      for (int j = 0; j < BM_PASS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = pass * BM_PASS + j * 8 + tig * 2 + e;   // row within the tile
          const float l2 = lse_t[c] * LOG2E, dl = delta_t[c];
          float pa = exp2f(fmaf(sT[j][e], scale2, -l2));
          float pb = exp2f(fmaf(sT[j][e + 2], scale2, -l2));
          if (edge) {
            const int qpos = (r0 + c) / g;
            if (!fa_keep(qpos, key_a, t_len, causal, window)) pa = 0.0f;
            if (!fa_keep(qpos, key_b, t_len, causal, window)) pb = 0.0f;
          }
          sT[j][e] = pa;
          sT[j][e + 2] = pb;
          dpT[j][e] = pa * (dpT[j][e] - dl);
          dpT[j][e + 2] = pb * (dpT[j][e + 2] - dl);
        }

      // dV += P^T dO and dK += dS^T Q, 16 rows of the pass at a time; per
      // group of up to 64 columns the hi products, then the lo products
#pragma unroll
      for (int kk = 0; kk < BM_PASS / 16; ++kk) {
        uint32_t ph[4], pl[4], dh[4], dlo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {   // (key gid | gid + 8) x (rows 16 kk | 16 kk + 8)
          const int j = 2 * kk + (r >> 1), e = (r & 1) * 2;
          ph[r] = pack_bf16(sT[j][e], sT[j][e + 1]);
          if constexpr (!P_BF16)
            pl[r] = pack_bf16(bf16_residual(sT[j][e]), bf16_residual(sT[j][e + 1]));
          dh[r] = pack_bf16(dpT[j][e], dpT[j][e + 1]);
          dlo[r] = pack_bf16(bf16_residual(dpT[j][e]), bf16_residual(dpT[j][e + 1]));
        }
        const int b_row = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L::LD;
#pragma unroll
        for (int d0 = 0; d0 < L::NG; d0 += L::DG) {
          // the last group is short when DG does not divide NG (D = 112: 4 + 3)
          uint32_t bf[L::DG][4];
#pragma unroll
          for (int i = 0; i < L::DG; ++i)
            if (d0 + i < L::NG)
              ldmatrix_x4_trans(bf[i], dop + b_row + (d0 + i) * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < L::DG; ++i) {
            if (d0 + i >= L::NG) continue;
            mma_bf16(dv_acc[2 * (d0 + i)], ph, bf[i][0], bf[i][1]);
            mma_bf16(dv_acc[2 * (d0 + i) + 1], ph, bf[i][2], bf[i][3]);
          }
          if constexpr (!P_BF16) {
#pragma unroll
            for (int i = 0; i < L::DG; ++i) {
              if (d0 + i >= L::NG) continue;
              mma_bf16(dv_acc[2 * (d0 + i)], pl, bf[i][0], bf[i][1]);
              mma_bf16(dv_acc[2 * (d0 + i) + 1], pl, bf[i][2], bf[i][3]);
            }
          }
#pragma unroll
          for (int i = 0; i < L::DG; ++i)
            if (d0 + i < L::NG)
              ldmatrix_x4_trans(bf[i], qp + b_row + (d0 + i) * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < L::DG; ++i) {
            if (d0 + i >= L::NG) continue;
            mma_bf16(dk_acc[2 * (d0 + i)], dh, bf[i][0], bf[i][1]);
            mma_bf16(dk_acc[2 * (d0 + i) + 1], dh, bf[i][2], bf[i][3]);
          }
#pragma unroll
          for (int i = 0; i < L::DG; ++i) {
            if (d0 + i >= L::NG) continue;
            mma_bf16(dk_acc[2 * (d0 + i)], dlo, bf[i][0], bf[i][1]);
            mma_bf16(dk_acc[2 * (d0 + i) + 1], dlo, bf[i][2], bf[i][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // warp w + 4's sums to warp w through the staging buffers, then added
  // in that order: dK scaled once, both rounded to bf16 once
  __syncthreads();                // every warp is done with the staged tiles
  float* part = reinterpret_cast<float*>(qs);   // [4][2][D / 8][4][32]
  const int kw = warp & 3;
  if (pass == 1) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part[(((kw * 2) * (D / 8) + j) * 4 + e) * 32 + lane] = dk_acc[j][e];
        part[(((kw * 2 + 1) * (D / 8) + j) * 4 + e) * 32 + lane] = dv_acc[j][e];
      }
  }
  __syncthreads();
  if (pass == 1) return;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[j][e] += part[(((kw * 2) * (D / 8) + j) * 4 + e) * 32 + lane];
      dv_acc[j][e] += part[(((kw * 2 + 1) * (D / 8) + j) * 4 + e) * 32 + lane];
    }
  if (key_a < t_len) {
    const size_t off = kv_off + static_cast<size_t>(key_a) * kv * D + tig * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + j * 8) =
          __floats2bfloat162_rn(dk_acc[j][0] * scale, dk_acc[j][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + j * 8) =
          __floats2bfloat162_rn(dv_acc[j][0], dv_acc[j][1]);
    }
  }
  if (key_b < t_len) {
    const size_t off = kv_off + static_cast<size_t>(key_b) * kv * D + tig * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + j * 8) =
          __floats2bfloat162_rn(dk_acc[j][2] * scale, dk_acc[j][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + j * 8) =
          __floats2bfloat162_rn(dv_acc[j][2], dv_acc[j][3]);
    }
  }
}

// dQ of 128 rows of R of one KV head on the tensor cores, in the forward's
// layout: warp w owns rows 16 w .. 16 w + 15, its Q and dO rows held as A
// fragments (ldmatrix, once), dQ in float32 accumulators.  K and V tiles
// (64 keys) stream through two stages by cp.async over the forward's key
// range.  Per 32-key pass: S = Q K^T and dP = dO V^T (K and V as B
// fragments by ldmatrix); P = exp2(S scale log2(e) - lse log2(e)), masked
// only on a pass that straddles the diagonal, the window edge or T;
// dS = P (dP - Delta) on the accumulators, which are the A fragments of
// dQ += dS K (K as B fragments by ldmatrix.trans), dS split in two bf16
// products.  Scaled and stored once.  A separate kernel from dK/dV: a
// fused dQ would add across blocks with atomics, in no fixed order.
template <int D>
__global__ void __launch_bounds__(FM_THREADS, 1)
flash_attention_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const __nv_bfloat16* __restrict__ dout,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  __nv_bfloat16* __restrict__ dq, int n_bkv, int s_len,
                                  int t_len, int h, int kv, int causal, int window, float scale) {
  using L = BmLayout<D>;
  extern __shared__ __align__(128) unsigned char bq_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(bq_smem);   // [FM_ROWS][LD]
  __nv_bfloat16* dos = qs + FM_ROWS * L::LD;                         // [FM_ROWS][LD]
  __nv_bfloat16* ks = dos + FM_ROWS * L::LD;                         // [2][64][LD]
  __nv_bfloat16* vs = ks + 2 * L::TILE;                              // [2][64][LD]

  const int g = h / kv;
  const int n_rows = s_len * g;
  const int n_row_tiles = (n_rows + FM_ROWS - 1) / FM_ROWS;
  // longest (latest q) first, across every (batch, KV head)
  const int tile = n_row_tiles - 1 - static_cast<int>(blockIdx.x) / n_bkv;
  const int bkv = static_cast<int>(blockIdx.x) % n_bkv;
  const int b = bkv / kv, kvh = bkv % kv;
  const int r0 = tile * FM_ROWS;
  const size_t q_base = static_cast<size_t>(b) * s_len * h * D;
  const size_t kv_off = static_cast<size_t>(b) * t_len * kv * D + static_cast<size_t>(kvh) * D;
  const size_t stat_base = (static_cast<size_t>(b) * h + static_cast<size_t>(kvh) * g) * s_len;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const float scale2 = scale * LOG2E;

  // the forward's key range for the block's rows
  const int q_lo = r0 / g;
  const int q_hi = (min(r0 + FM_ROWS, n_rows) - 1) / g;
  int k_hi = t_len - 1;
  if (causal) k_hi = min(k_hi, q_hi);
  const int k_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int kt0 = k_lo / FA_KB;
  const int n_kt = k_lo <= k_hi ? k_hi / FA_KB - kt0 + 1 : 0;

  // one copy group for Q, dO, K(0) and V(0); then one for K(j+1), V(j+1)
  bm_load_rows<D, FM_ROWS, FM_THREADS>(q + q_base, qs, r0, n_rows, g, h, kvh);
  bm_load_rows<D, FM_ROWS, FM_THREADS>(dout + q_base, dos, r0, n_rows, g, h, kvh);
  if (n_kt > 0) {
    bm_load_keys<D, FM_THREADS>(k + kv_off, ks, kt0 * FA_KB, t_len, kv);
    bm_load_keys<D, FM_THREADS>(v + kv_off, vs, kt0 * FA_KB, t_len, kv);
  }
  cp_async_commit();

  // this thread's rows gid and gid + 8 of the warp's 16, their lse (log2
  // domain) and Delta; rows past S * G take 0 and are never stored
  const int ra = r0 + warp * 16 + gid, rb = ra + 8;
  const int qa = ra < n_rows ? ra / g : 0, qb = rb < n_rows ? rb / g : 0;
  const size_t sa = stat_base + static_cast<size_t>(ra % g) * s_len + qa;
  const size_t sb = stat_base + static_cast<size_t>(rb % g) * s_len + qb;
  const float l2a = ra < n_rows ? lse[sa] * LOG2E : 0.0f;
  const float l2b = rb < n_rows ? lse[sb] * LOG2E : 0.0f;
  const float dla = ra < n_rows ? delta[sa] : 0.0f;
  const float dlb = rb < n_rows ? delta[sb] : 0.0f;
  // the warp's q positions, to skip passes the mask hides from all of them
  const int w_r0 = r0 + warp * 16;
  const bool w_live = w_r0 < n_rows;
  const int wq_lo = w_r0 / g, wq_hi = (min(w_r0 + 16, n_rows) - 1) / g;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  uint32_t qf[L::NG][4], of[L::NG][4];   // the warp's Q and dO rows as A fragments
  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    const int k0 = (kt0 + it) * FA_KB;
    cp_async_wait<0>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kd = 0; kd < L::NG; ++kd) {
        const int a_off = (warp * 16 + (lane & 15)) * L::LD + kd * 16 + (lane >> 4) * 8;
        ldmatrix_x4(qf[kd], qs + a_off);
        ldmatrix_x4(of[kd], dos + a_off);
      }
    }
    if (it + 1 < n_kt) {
      bm_load_keys<D, FM_THREADS>(k + kv_off, ks + (st ^ 1) * L::TILE, k0 + FA_KB, t_len, kv);
      bm_load_keys<D, FM_THREADS>(v + kv_off, vs + (st ^ 1) * L::TILE, k0 + FA_KB, t_len, kv);
    }
    cp_async_commit();
    const __nv_bfloat16* kt = ks + st * L::TILE;
    const __nv_bfloat16* vt = vs + st * L::TILE;

#pragma unroll 1
    for (int pass = 0; pass < FA_KB / BM_PASS; ++pass) {
      const int p0 = k0 + pass * BM_PASS;   // the pass's first key
      // no key of the pass is kept for any row of this warp
      if (!w_live || p0 >= t_len || (causal && p0 > wq_hi) ||
          (window > 0 && p0 + BM_PASS - 1 <= wq_lo - window))
        continue;
      const bool edge = p0 + BM_PASS > t_len || (causal && p0 + BM_PASS - 1 > wq_lo) ||
                        (window > 0 && p0 <= wq_hi - window);
      const __nv_bfloat16* kp = kt + pass * BM_PASS * L::LD;
      const __nv_bfloat16* vp = vt + pass * BM_PASS * L::LD;

      // S, dP: 16 rows x 32 keys per warp, float32
      float sc[BM_PASS / 8][4], dp[BM_PASS / 8][4];
#pragma unroll
      for (int j = 0; j < BM_PASS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.0f;
#pragma unroll
      for (int kd = 0; kd < L::NG; ++kd) {
        uint32_t bk[BM_PASS / 16][4], bv[BM_PASS / 16][4];
#pragma unroll
        for (int np = 0; np < BM_PASS / 16; ++np) {
          const int b_off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * L::LD + kd * 16 +
                            ((lane >> 3) & 1) * 8;
          ldmatrix_x4(bk[np], kp + b_off);
          ldmatrix_x4(bv[np], vp + b_off);
        }
#pragma unroll
        for (int np = 0; np < BM_PASS / 16; ++np) {
          mma_bf16(sc[2 * np], qf[kd], bk[np][0], bk[np][1]);
          mma_bf16(sc[2 * np + 1], qf[kd], bk[np][2], bk[np][3]);
          mma_bf16(dp[2 * np], of[kd], bv[np][0], bv[np][1]);
          mma_bf16(dp[2 * np + 1], of[kd], bv[np][2], bv[np][3]);
        }
      }

      // dS in place of S: rows ra (e = 0, 1) and rb (e = 2, 3)
#pragma unroll
      for (int j = 0; j < BM_PASS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float pa = exp2f(fmaf(sc[j][e], scale2, -l2a));
          float pb = exp2f(fmaf(sc[j][e + 2], scale2, -l2b));
          if (edge) {
            const int kpos = p0 + j * 8 + tig * 2 + e;
            if (!fa_keep(qa, kpos, t_len, causal, window)) pa = 0.0f;
            if (!fa_keep(qb, kpos, t_len, causal, window)) pb = 0.0f;
          }
          sc[j][e] = pa * (dp[j][e] - dla);
          sc[j][e + 2] = pb * (dp[j][e + 2] - dlb);
        }

      // dQ += dS K over the pass's keys, 16 at a time
#pragma unroll
      for (int kk = 0; kk < BM_PASS / 16; ++kk) {
        uint32_t dh[4], dlo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 2 * kk + (r >> 1), e = (r & 1) * 2;
          dh[r] = pack_bf16(sc[j][e], sc[j][e + 1]);
          dlo[r] = pack_bf16(bf16_residual(sc[j][e]), bf16_residual(sc[j][e + 1]));
        }
        const int b_row = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L::LD;
#pragma unroll
        for (int d0 = 0; d0 < L::NG; d0 += L::DG) {
          uint32_t bf[L::DG][4];
#pragma unroll
          for (int i = 0; i < L::DG; ++i)
            if (d0 + i < L::NG)
              ldmatrix_x4_trans(bf[i], kp + b_row + (d0 + i) * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < L::DG; ++i) {
            if (d0 + i >= L::NG) continue;
            mma_bf16(acc[2 * (d0 + i)], dh, bf[i][0], bf[i][1]);
            mma_bf16(acc[2 * (d0 + i) + 1], dh, bf[i][2], bf[i][3]);
          }
#pragma unroll
          for (int i = 0; i < L::DG; ++i) {
            if (d0 + i >= L::NG) continue;
            mma_bf16(acc[2 * (d0 + i)], dlo, bf[i][0], bf[i][1]);
            mma_bf16(acc[2 * (d0 + i) + 1], dlo, bf[i][2], bf[i][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if (ra < n_rows) {
    __nv_bfloat16* dst = dq + q_base + (static_cast<size_t>(qa) * h + kvh * g + ra % g) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[j][0] * scale, acc[j][1] * scale);
  }
  if (rb < n_rows) {
    __nv_bfloat16* dst = dq + q_base + (static_cast<size_t>(qb) * h + kvh * g + rb % g) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[j][2] * scale, acc[j][3] * scale);
  }
}

template <int D, bool P_BF16>
int launch_bwd_dkdv_mma(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv, int batch,
                        int s, int t, int h, int kv, int causal, int window, float scale,
                        cudaStream_t stream) {
  using L = BmLayout<D>;
  static std::atomic<bool> raised[MAX_DEVICES];
  const cudaError_t err =
      allow_dynamic_smem(flash_attention_bwd_dkdv_mma_kernel<D, P_BF16>, L::DKDV_BYTES, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kt = (t + FA_KB - 1) / FA_KB;
  const long long blocks = static_cast<long long>(batch) * kv * n_kt;
  if (blocks > MAX_GRID_X) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_bwd_dkdv_mma_kernel<D, P_BF16>
      <<<static_cast<unsigned>(blocks), BM_THREADS, L::DKDV_BYTES, stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse,
          delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), batch * kv,
          s, t, h, kv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int batch, int s, int t,
                      int h, int kv, int causal, int window, float scale, cudaStream_t stream) {
  using L = BmLayout<D>;
  static std::atomic<bool> raised[MAX_DEVICES];
  const cudaError_t err =
      allow_dynamic_smem(flash_attention_bwd_dq_mma_kernel<D>, L::DQ_BYTES, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_rows = static_cast<long long>(s) * (h / kv);
  const long long blocks = static_cast<long long>(batch) * kv * ((n_rows + FM_ROWS - 1) / FM_ROWS);
  if (blocks > MAX_GRID_X) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_bwd_dq_mma_kernel<D>
      <<<static_cast<unsigned>(blocks), FM_THREADS, L::DQ_BYTES, stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse,
          delta, static_cast<__nv_bfloat16*>(dq), batch * kv, s, t, h, kv, causal, window,
          scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_mma(int which, const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv, int batch,
                   int s, int t, int h, int kv, int d, int causal, int window, float scale,
                   int p_bf16, cudaStream_t stream) {
#define REPRO_FA_BWD_MMA_CASE(DIM)                                                           \
  case DIM:                                                                                  \
    if (which == 1)                                                                          \
      return launch_bwd_dq_mma<DIM>(q, k, v, dout, lse, delta, dq, batch, s, t, h, kv,       \
                                    causal, window, scale, stream);                          \
    return p_bf16 ? launch_bwd_dkdv_mma<DIM, true>(q, k, v, dout, lse, delta, dk, dv, batch, \
                                                   s, t, h, kv, causal, window, scale,       \
                                                   stream)                                   \
                  : launch_bwd_dkdv_mma<DIM, false>(q, k, v, dout, lse, delta, dk, dv,       \
                                                    batch, s, t, h, kv, causal, window,      \
                                                    scale, stream);
  switch (d) {
    REPRO_FA_BWD_MMA_CASE(16)
    REPRO_FA_BWD_MMA_CASE(32)
    REPRO_FA_BWD_MMA_CASE(64)
    REPRO_FA_BWD_MMA_CASE(112)
    REPRO_FA_BWD_MMA_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FA_BWD_MMA_CASE
}
}  // namespace
}  // namespace repro_torch

// C interface (bound with ctypes).  q (batch, s, h, d), k and v
// (batch, t, kv, d), o (batch, s, h, d): device pointers of contiguous
// tensors of one dtype (float32, or bfloat16 when is_bf16).  lse, when not
// null, is a float32 (batch, h, s) buffer that takes each row's log-sum-exp
// m + log(l) of the scaled scores (the backward's input); with lse null the
// kernel computes and writes exactly what it did without the output.  d is
// 16, 32, 64, 112 or 128 and kv divides h; window = 0 means no window.
// Returns the CUDA error code of the launch (0 = success); an empty output
// launches nothing.  The row tile is the plan's
// (repro_flash_attention_fma_plan).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, int is_bf16,
                                     void* o, float* lse, int batch, int s, int t, int h, int kv, int d,
                                     int causal, int window, float scale, int p_bf16,
                                     void* stream) {
  using namespace repro_torch;
  if (batch == 0 || s == 0 || h == 0) return 0;
  if (kv <= 0 || h % kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch_for_dim<__nv_bfloat16>(q, k, v, o, lse, batch, s, t, h, kv, d, causal, window, scale, p_bf16, 0, st)
      : launch_for_dim<float>(q, k, v, o, lse, batch, s, t, h, kv, d, causal, window, scale, p_bf16, 0, st);
}

// For a sweep of the row tile only (scripts/k8_fma_times.py --sweep): the
// float32 launch of repro_flash_attention with the row tile forced to
// `rows`, a multiple of 8 (d = 32, 64) or 16 from 16 to the head size's
// largest (64 at d = 32 and 64, else 128).  Nothing of the package calls it.
extern "C" int repro_flash_attention_fma_rows(const void* q, const void* k, const void* v,
                                              void* o, float* lse, int batch, int s, int t, int h,
                                              int kv, int d, int causal, int window, float scale,
                                              int p_bf16, int rows, void* stream) {
  using namespace repro_torch;
  if (batch == 0 || s == 0 || h == 0) return 0;
  if (rows <= 0 || kv <= 0 || h % kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_for_dim<float>(q, k, v, o, lse, batch, s, t, h, kv, d, causal, window, scale,
                               p_bf16, rows, static_cast<cudaStream_t>(stream));
}

// The plan of repro_flash_attention's launch at a shape (rows = 0; the
// arguments it shares with that entry point) into plan[0 .. plan_len):
// rows per block, threads, dynamic shared-memory bytes, blocks, row tiles,
// and how many of its blocks the current device holds on one SM; then per
// row tile in issue order (the last row tile first) two ints: its first
// key tile of 64 keys and its number of key tiles.  Returns
// cudaErrorInvalidValue when plan_len < 6 + 2 * row tiles, else the CUDA
// error of the occupancy query (0 = success).
extern "C" int repro_flash_attention_fma_plan(int batch, int s, int t, int h, int kv, int d,
                                              int causal, int window, int* plan, int plan_len) {
  using namespace repro_torch;
  if (batch <= 0 || s <= 0 || kv <= 0 || h % kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 16: return fma_plan<16>(batch, s, t, h, kv, causal, window, plan, plan_len);
    case 32: return fma_plan<32>(batch, s, t, h, kv, causal, window, plan, plan_len);
    case 64: return fma_plan<64>(batch, s, t, h, kv, causal, window, plan, plan_len);
    case 112: return fma_plan<112>(batch, s, t, h, kv, causal, window, plan, plan_len);
    case 128: return fma_plan<128>(batch, s, t, h, kv, causal, window, plan, plan_len);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 tensor-core route: the arguments of repro_flash_attention for
// bfloat16 tensors whose base pointers are 16-byte aligned (the wrapper's
// flash_attention_route decides).  Returns the CUDA error code of the
// launch (0 = success); an empty output launches nothing.
extern "C" int repro_flash_attention_mma(const void* q, const void* k, const void* v, void* o,
                                         float* lse, int batch, int s, int t, int h, int kv, int d,
                                         int causal, int window, float scale, int p_bf16,
                                         void* stream) {
  using namespace repro_torch;
  if (batch == 0 || s == 0 || h == 0) return 0;
  if (kv <= 0 || h % kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_mma_for_p<16>(q, k, v, o, lse, batch, s, t, h, kv, causal, window, scale, p_bf16, st);
    case 32: return launch_mma_for_p<32>(q, k, v, o, lse, batch, s, t, h, kv, causal, window, scale, p_bf16, st);
    case 64: return launch_mma_for_p<64>(q, k, v, o, lse, batch, s, t, h, kv, causal, window, scale, p_bf16, st);
    case 112: return launch_mma_for_p<112>(q, k, v, o, lse, batch, s, t, h, kv, causal, window, scale, p_bf16, st);
    case 128: return launch_mma_for_p<128>(q, k, v, o, lse, batch, s, t, h, kv, causal, window, scale, p_bf16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward (bound with ctypes), three launches in this order:
//
// repro_flash_attention_bwd_delta: delta (batch, h, s) float32 = the row
// sums of dout * o, both (batch, s, h, d) in one dtype; vec16 when both
// start on the 16-byte grid (16-byte loads), else the scalar variant (the
// same chunks and sums by element loads).
//
// repro_flash_attention_bwd_dkdv: dk, dv (batch, t, kv, d) in q's dtype from
// q, k, v, dout (the forward's operands and the output's gradient, one
// dtype), the forward's lse and delta (batch, h, s) float32; one cluster of
// R blocks per (batch * kv head, 64-key tile), R from the shape
// (repro_flash_attention_bwd_dkdv_clusters reports it), the G query heads'
// sum in a fixed order.
//
// repro_flash_attention_bwd_dq: dq (batch, s, h, d) in q's dtype from the
// same inputs; one block per (batch * head, 32 queries).
//
// causal, window, scale and p_bf16 are the forward's.  Each returns the
// CUDA error code of its launch (0 = success); an empty input launches
// nothing.
extern "C" int repro_flash_attention_bwd_delta(const void* o, const void* dout, int is_bf16,
                                               float* delta, int batch, int s, int h, int d,
                                               int vec16, void* stream) {
  using namespace repro_torch;
  const long long n_rows = static_cast<long long>(batch) * s * h;
  if (n_rows == 0) return 0;
  if (d <= 0 || d % 8 != 0 || d > 128) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_delta<__nv_bfloat16>(o, dout, delta, n_rows, n_rows, s, h, d, vec16, st)
                 : launch_delta<float>(o, dout, delta, n_rows, n_rows, s, h, d, vec16, st);
}

// Delta's launch for (batch, s, h, d) into plan[0 .. 3): lanes a row,
// warps a block, blocks (kernels/flash_attention.py:delta_plan computes the
// same).  Returns cudaErrorInvalidValue on a bad head size or plan_len < 3.
extern "C" int repro_flash_attention_bwd_delta_plan(int is_bf16, int batch, int s, int h, int d,
                                                    int* plan, int plan_len) {
  using namespace repro_torch;
  const long long n_rows = static_cast<long long>(batch) * s * h;
  if (d <= 0 || d % 8 != 0 || d > 128 || plan_len < 3 || n_rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const FdPlan p = is_bf16 ? fd_plan<__nv_bfloat16>(n_rows, d) : fd_plan<float>(n_rows, d);
  plan[0] = is_bf16 ? fd_lanes<__nv_bfloat16>(d) : fd_lanes<float>(d);
  plan[1] = p.warps;
  plan[2] = p.blocks;
  return 0;
}

// Delta's kernel launched on the grid it takes for (batch, s, h, d) but
// over zero rows (its fixed cost, for a timing beside a launch over the
// rows): reads and writes nothing.
extern "C" int repro_flash_attention_bwd_delta_empty(int is_bf16, int batch, int s, int h, int d,
                                                     void* stream) {
  using namespace repro_torch;
  const long long n_rows = static_cast<long long>(batch) * s * h;
  if (d <= 0 || d % 8 != 0 || d > 128) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_delta<__nv_bfloat16>(nullptr, nullptr, nullptr, 0, n_rows, 1, 1, d, 1, st)
                 : launch_delta<float>(nullptr, nullptr, nullptr, 0, n_rows, 1, 1, d, 1, st);
}

extern "C" int repro_flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                                              const void* dout, int is_bf16, const float* lse,
                                              const float* delta, void* dk, void* dv, int batch,
                                              int s, int t, int h, int kv, int d, int causal,
                                              int window, float scale, int p_bf16,
                                              void* stream) {
  using namespace repro_torch;
  if (batch == 0 || t == 0 || h == 0) return 0;
  if (kv <= 0 || h % kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch_bwd_for_dim<__nv_bfloat16>(0, q, k, v, dout, lse, delta, nullptr, dk, dv, batch,
                                          s, t, h, kv, d, causal, window, scale, p_bf16, st)
      : launch_bwd_for_dim<float>(0, q, k, v, dout, lse, delta, nullptr, dk, dv, batch, s, t, h,
                                  kv, d, causal, window, scale, p_bf16, st);
}

extern "C" int repro_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                            const void* dout, int is_bf16, const float* lse,
                                            const float* delta, void* dq, int batch, int s,
                                            int t, int h, int kv, int d, int causal, int window,
                                            float scale, void* stream) {
  using namespace repro_torch;
  if (batch == 0 || s == 0 || h == 0) return 0;
  if (kv <= 0 || h % kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch_bwd_for_dim<__nv_bfloat16>(1, q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                                          batch, s, t, h, kv, d, causal, window, scale, 0, st)
      : launch_bwd_for_dim<float>(1, q, k, v, dout, lse, delta, dq, nullptr, nullptr, batch, s,
                                  t, h, kv, d, causal, window, scale, 0, st);
}

// The plan of repro_flash_attention_bwd_dkdv's launch at a shape (the
// arguments it shares with that entry point) into plan[0 .. plan_len):
// plan[0] = R, the cluster size; plan[1] = how many clusters of R blocks
// the current device runs at once; plan[2] = the key tiles n_kt; then per
// key tile, R + 3 ints: its first query tile (of 32 queries), its number
// of query tiles, and the R + 1 bounds of the ranks' shares of its items
// (head gi, query tile j) in the order gi * n_qt + j.  Returns
// cudaErrorInvalidValue when plan_len < 3 + n_kt (R + 3), else the CUDA
// error of the occupancy query (0 = success).
extern "C" int repro_flash_attention_bwd_dkdv_clusters(int batch, int s, int t, int h, int kv,
                                                       int d, int causal, int window, int* plan,
                                                       int plan_len) {
  using namespace repro_torch;
  if (kv <= 0 || h % kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 16: return dkdv_plan<16>(batch, s, t, h, kv, causal, window, plan, plan_len);
    case 32: return dkdv_plan<32>(batch, s, t, h, kv, causal, window, plan, plan_len);
    case 64: return dkdv_plan<64>(batch, s, t, h, kv, causal, window, plan, plan_len);
    case 112: return dkdv_plan<112>(batch, s, t, h, kv, causal, window, plan, plan_len);
    case 128: return dkdv_plan<128>(batch, s, t, h, kv, causal, window, plan, plan_len);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward's bf16 tensor-core route (the wrapper's
// flash_attention_bwd_route decides: bfloat16 q, k, v and dout whose base
// pointers are 16-byte aligned).  The arguments of
// repro_flash_attention_bwd_dkdv / _dq without is_bf16.
//
// repro_flash_attention_bwd_dkdv_mma: one block of 8 warps per (batch * kv
// head, 64-key tile), key tile 0 first.
//
// repro_flash_attention_bwd_dq_mma: one block of 8 warps per (batch * kv
// head, 128 rows of the (q position, group member) index).
//
// Each returns the CUDA error code of its launch (0 = success); an empty
// input launches nothing.
extern "C" int repro_flash_attention_bwd_dkdv_mma(const void* q, const void* k, const void* v,
                                                  const void* dout, const float* lse,
                                                  const float* delta, void* dk, void* dv,
                                                  int batch, int s, int t, int h, int kv, int d,
                                                  int causal, int window, float scale,
                                                  int p_bf16, void* stream) {
  using namespace repro_torch;
  if (batch == 0 || t == 0 || h == 0) return 0;
  if (kv <= 0 || h % kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd_mma(0, q, k, v, dout, lse, delta, nullptr, dk, dv, batch, s, t, h, kv, d,
                        causal, window, scale, p_bf16, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_flash_attention_bwd_dq_mma(const void* q, const void* k, const void* v,
                                                const void* dout, const float* lse,
                                                const float* delta, void* dq, int batch, int s,
                                                int t, int h, int kv, int d, int causal,
                                                int window, float scale, void* stream) {
  using namespace repro_torch;
  if (batch == 0 || s == 0 || h == 0) return 0;
  if (kv <= 0 || h % kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd_mma(1, q, k, v, dout, lse, delta, dq, nullptr, nullptr, batch, s, t, h, kv,
                        d, causal, window, scale, 0, static_cast<cudaStream_t>(stream));
}
