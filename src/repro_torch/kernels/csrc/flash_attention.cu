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
// Design of the fma route (the first port).  A block of 256 threads owns
// 64 rows; per 64-key tile the K tile is staged in shared memory
// (converted to float32, zero past T), every thread forms a 4 x 4 block
// of scores with float32 FMA, the row max and sum are reduced over the
// 16 lanes that share a row, the probabilities go to shared memory, the
// V tile replaces the K tile, and every thread adds its 4 x D/16 outputs.
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
// in a fixed order, with no atomics); then per (batch, head, 64-row tile)
// one block that adds dQ += dS K over the key tiles.  Every product is
// float32 FMA on shared-memory tiles (4 x 4 (key, query) pairs per thread,
// as the forward's fma route); bf16 inputs are read element by element and
// converted, and bf16 gradients are rounded once, at the store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace repro_torch {
namespace {

constexpr int FA_THREADS = 256;
constexpr int FA_ROWS = 64;       // rows (q position, group member) per block
constexpr int FA_KB = 64;         // keys per tile
constexpr float FA_NEG_INF = -1e30f;

template <int D>
struct FaLayout {
  static constexpr int QS = D + 1;       // padded row strides, in floats: the
  static constexpr int KS = D + 1;       // 16 lanes of a row read 16 banks
  static constexpr int PS = FA_KB + 1;
  static constexpr int DC = D / 16;      // output columns per thread
  static constexpr size_t FLOATS = FA_ROWS * QS + FA_KB * KS + FA_ROWS * PS;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// the max/sum over the 16 lanes of a half warp (the threads of one row)
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [0, FA_KB) of a (T, KV, D) slab starting at key k0 -> dst, float32,
// zero past key T
template <typename T, int D>
__device__ __forceinline__ void load_kv_tile(const T* __restrict__ src, float* dst, int k0,
                                             int t_len, int kv, size_t head_off) {
  for (int e = threadIdx.x; e < FA_KB * D; e += FA_THREADS) {
    const int r = e / D;
    const int c = e % D;
    const int kpos = k0 + r;
    dst[r * FaLayout<D>::KS + c] =
        kpos < t_len ? to_f32(src[(static_cast<size_t>(kpos) * kv) * D + head_off + c]) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                       int s_len, int t_len, int h, int kv, int causal, int window,
                       float scale, int p_bf16) {
  using L = FaLayout<D>;
  extern __shared__ float smem[];
  float* qs = smem;                           // [FA_ROWS][QS]
  float* kvs = qs + FA_ROWS * L::QS;          // [FA_KB][KS], K then V
  float* ps = kvs + FA_KB * L::KS;            // [FA_ROWS][PS]

  const int g = h / kv;
  const int n_rows = s_len * g;
  const int tile = gridDim.x - 1 - blockIdx.x;     // longest (latest q) first
  const int r0 = tile * FA_ROWS;
  const int b = blockIdx.y / kv;
  const int kvh = blockIdx.y % kv;
  const size_t q_base = static_cast<size_t>(b) * s_len * h * D;
  const size_t kv_base = static_cast<size_t>(b) * t_len * kv * D;

  // the q tile, float32; rows past S * G are zero and never written
  for (int e = threadIdx.x; e < FA_ROWS * D; e += FA_THREADS) {
    const int r = e / D;
    const int c = e % D;
    const int row = r0 + r;
    float x = 0.0f;
    if (row < n_rows) {
      const int qpos = row / g;
      const int head = kvh * g + row % g;
      x = to_f32(q[q_base + (static_cast<size_t>(qpos) * h + head) * D + c]);
    }
    qs[r * L::QS + c] = x;
  }

  const int tc = threadIdx.x % 16;    // score columns tc + 16 j, output columns tc + 16 j
  const int tr = threadIdx.x / 16;    // rows tr + 16 i
  int qpos[4];
  float m_i[4], l_i[4], acc[4][L::DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + tr + 16 * i;
    qpos[i] = row < n_rows ? row / g : 0;
    m_i[i] = FA_NEG_INF;
    l_i[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < L::DC; ++j) acc[i][j] = 0.0f;
  }

  // key range that holds an unmasked key for some row of the block
  const int q_lo = r0 / g;
  const int q_hi = (min(r0 + FA_ROWS, n_rows) - 1) / g;
  int k_hi = t_len - 1;
  if (causal) k_hi = min(k_hi, q_hi);
  const int k_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const size_t head_off = static_cast<size_t>(kvh) * D;

  for (int kt = k_lo / FA_KB; k_lo <= k_hi && kt <= k_hi / FA_KB; ++kt) {
    const int k0 = kt * FA_KB;
    __syncthreads();                  // the previous tile's reads of kvs and ps are done
    load_kv_tile<T, D>(k + kv_base, kvs, k0, t_len, kv, head_off);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(tr + 16 * i) * L::QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = kvs[(tc + 16 * j) * L::KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }

    // mask, online softmax, rescale the accumulator
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = FA_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tc + 16 * j;
        bool ok = kpos < t_len;
        if (causal) ok = ok && kpos <= qpos[i];
        if (window > 0) ok = ok && kpos > qpos[i] - window;
        sc[i][j] = ok ? sc[i][j] * scale : FA_NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max16(mx));
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        sum += sc[i][j];
      }
      l_i[i] = l_i[i] * alpha + row_sum16(sum);
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < L::DC; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();                  // every thread is done reading the K tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = p_bf16 ? __bfloat162float(__float2bfloat16_rn(sc[i][j])) : sc[i][j];
        ps[(tr + 16 * i) * L::PS + tc + 16 * j] = p;
      }
    load_kv_tile<T, D>(v + kv_base, kvs, k0, t_len, kv, head_off);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < FA_KB; ++c) {
      float pv[4], vv[L::DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(tr + 16 * i) * L::PS + c];
#pragma unroll
      for (int j = 0; j < L::DC; ++j) vv[j] = kvs[c * L::KS + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < L::DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + tr + 16 * i;
    if (row >= n_rows) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    const int head = kvh * g + row % g;
    T* dst = o + q_base + (static_cast<size_t>(qpos[i]) * h + head) * D;
#pragma unroll
    for (int j = 0; j < L::DC; ++j) store_as(dst + tc + 16 * j, acc[i][j] / l);
    if (lse != nullptr && tc == 0)
      lse[(static_cast<size_t>(b) * h + head) * s_len + qpos[i]] = m_i[i] + logf(l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch, int s,
           int t, int h, int kv, int causal, int window, float scale, int p_bf16,
           cudaStream_t stream) {
  using L = FaLayout<D>;
  static std::atomic<bool> raised[MAX_DEVICES];   // past 48 KB of shared memory
  const cudaError_t err = allow_dynamic_smem(flash_attention_kernel<T, D>,
                                             static_cast<int>(L::BYTES), raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_rows = s * (h / kv);
  const dim3 grid((n_rows + FA_ROWS - 1) / FA_ROWS, batch * kv);
  flash_attention_kernel<T, D><<<grid, FA_THREADS, L::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, s, t, h, kv, causal, window, scale, p_bf16);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for_dim(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                   int s, int t, int h, int kv, int d, int causal, int window, float scale,
                   int p_bf16, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, batch, s, t, h, kv, causal, window, scale, p_bf16, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, batch, s, t, h, kv, causal, window, scale, p_bf16, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, batch, s, t, h, kv, causal, window, scale, p_bf16, stream);
    case 112: return launch<T, 112>(q, k, v, o, lse, batch, s, t, h, kv, causal, window, scale, p_bf16, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, batch, s, t, h, kv, causal, window, scale, p_bf16, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// mma route: bf16 tensor cores (mma.sync) in FlashAttention-2's layout
// ---------------------------------------------------------------------------

constexpr int FM_WARPS = 8;
constexpr int FM_THREADS = FM_WARPS * 32;
constexpr int FM_ROWS = FM_WARPS * 16;   // rows per block, 16 per warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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
// backward: Delta, then dK and dV, then dQ (float32 FMA)
// ---------------------------------------------------------------------------

constexpr int FB_TILE = 64;       // query rows and keys per tile

template <int D>
struct FbLayout {
  static constexpr int RS = D + 1;          // padded stride of a D-wide tile, in floats
  static constexpr int PS = FB_TILE + 1;    // padded stride of a 64 x 64 tile
  static constexpr int DC = D / 16;         // output columns per thread
  static constexpr int TILE = FB_TILE * RS;
  // dkdv: K, V, Q, dO tiles and P, dS ([key][query]); dq: Q, dO, K, V and dS
  static constexpr size_t DKDV_BYTES = (4 * TILE + 2 * FB_TILE * PS) * sizeof(float);
  static constexpr size_t DQ_BYTES = (4 * TILE + FB_TILE * PS) * sizeof(float);
};

__device__ __forceinline__ bool fa_keep(int qpos, int kpos, int t_len, int causal, int window) {
  bool ok = kpos < t_len;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// rows [q0, q0 + 64) of query head `head` of a (S, H, D) slab -> dst
// [64][D + 1], float32, zero past row s_len
template <typename T, int D>
__device__ __forceinline__ void load_q_tile(const T* __restrict__ src, float* dst, int q0,
                                            int s_len, int h, int head) {
  for (int e = threadIdx.x; e < FB_TILE * D; e += FA_THREADS) {
    const int r = e / D;
    const int c = e % D;
    const int qpos = q0 + r;
    dst[r * FbLayout<D>::RS + c] =
        qpos < s_len ? to_f32(src[(static_cast<size_t>(qpos) * h + head) * D + c]) : 0.0f;
  }
}

// Delta[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d] in float32: one warp
// per row, rows in (b, s, h) order
template <typename T>
__global__ void flash_attention_bwd_delta_kernel(const T* __restrict__ o,
                                                 const T* __restrict__ dout,
                                                 float* __restrict__ delta, long long n_rows,
                                                 int s_len, int h, int d) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const T* orow = o + row * d;
  const T* drow = dout + row * d;
  float sum = 0.0f;
  for (int c = lane; c < d; c += 32) sum = fmaf(to_f32(drow[c]), to_f32(orow[c]), sum);
  sum = warp_sum(sum);
  if (lane == 0) {
    const long long bs = row / h;           // b * s_len + s
    const int head = static_cast<int>(row % h);
    const long long b = bs / s_len;
    const int s = static_cast<int>(bs % s_len);
    delta[(b * h + head) * s_len + s] = sum;
  }
}

// dK and dV of one key tile of one KV head: the block loops over the G
// query heads of the group and every query tile that reaches the keys, in
// a fixed order, and writes each dK, dV element once (no atomics).  Per
// (head, query tile): S^T and dP^T by FMA (a 4 x 4 block of (key, query)
// pairs per thread), P = exp(S scale - lse) under the forward's mask,
// dS = P (dP - Delta); then dV += P~^T dO (P~ = bf16(P) when p_bf16, as
// the forward's PV product) and dK += dS^T Q, scaled once at the end.
template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const T* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                T* __restrict__ dk, T* __restrict__ dv, int s_len, int t_len,
                                int h, int kv, int causal, int window, float scale, int p_bf16) {
  using L = FbLayout<D>;
  extern __shared__ float smem[];
  float* ks = smem;                     // [64][RS] the key tile
  float* vs = ks + L::TILE;             // [64][RS] the value tile
  float* qs = vs + L::TILE;             // [64][RS] a query tile
  float* dos = qs + L::TILE;            // [64][RS] its dO tile
  float* ps = dos + L::TILE;            // [64 keys][PS] P~
  float* dss = ps + FB_TILE * L::PS;    // [64 keys][PS] dS
  __shared__ float lse_s[FB_TILE], delta_s[FB_TILE];

  const int g = h / kv;
  const int k0 = blockIdx.x * FB_TILE;
  const int b = blockIdx.y / kv;
  const int kvh = blockIdx.y % kv;
  const size_t q_base = static_cast<size_t>(b) * s_len * h * D;
  const size_t kv_base = static_cast<size_t>(b) * t_len * kv * D;
  const size_t head_off = static_cast<size_t>(kvh) * D;
  load_kv_tile<T, D>(k + kv_base, ks, k0, t_len, kv, head_off);
  load_kv_tile<T, D>(v + kv_base, vs, k0, t_len, kv, head_off);

  const int tc = threadIdx.x % 16;    // queries tc + 16 j; output columns tc + 16 j
  const int tr = threadIdx.x / 16;    // keys tr + 16 i
  float dk_acc[4][L::DC], dv_acc[4][L::DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < L::DC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  // query rows that keep a key of this tile: causal from k0 on, a window
  // up to the last key + window - 1
  const int k_last = min(k0 + FB_TILE, t_len) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(s_len - 1, k_last + window - 1) : s_len - 1;

  for (int gi = 0; gi < g; ++gi) {
    const int head = kvh * g + gi;
    const size_t stat_base = (static_cast<size_t>(b) * h + head) * s_len;
    for (int qt = q_lo / FB_TILE; q_lo <= q_hi && qt <= q_hi / FB_TILE; ++qt) {
      const int q0 = qt * FB_TILE;
      __syncthreads();                // the previous tile's reads of qs, dos, ps, dss are done
      load_q_tile<T, D>(q + q_base, qs, q0, s_len, h, head);
      load_q_tile<T, D>(dout + q_base, dos, q0, s_len, h, head);
      if (threadIdx.x < FB_TILE) {
        const int qpos = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qpos < s_len ? lse[stat_base + qpos] : 0.0f;
        delta_s[threadIdx.x] = qpos < s_len ? delta[stat_base + qpos] : 0.0f;
      }
      __syncthreads();

      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kk[4], vv[4], qq[4], oo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = ks[(tr + 16 * i) * L::RS + d];
          vv[i] = vs[(tr + 16 * i) * L::RS + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qq[j] = qs[(tc + 16 * j) * L::RS + d];
          oo[j] = dos[(tc + 16 * j) * L::RS + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(kk[i], qq[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], oo[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = k0 + tr + 16 * i;
          const int qpos = q0 + tc + 16 * j;
          const bool ok = qpos < s_len && fa_keep(qpos, kpos, t_len, causal, window);
          const float p = ok ? expf(st[i][j] * scale - lse_s[tc + 16 * j]) : 0.0f;
          ps[(tr + 16 * i) * L::PS + tc + 16 * j] =
              p_bf16 ? __bfloat162float(__float2bfloat16_rn(p)) : p;
          dss[(tr + 16 * i) * L::PS + tc + 16 * j] = p * (dpt[i][j] - delta_s[tc + 16 * j]);
        }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < FB_TILE; ++r) {
        float pv[4], dsv[4], oo[L::DC], qq[L::DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = ps[(tr + 16 * i) * L::PS + r];
          dsv[i] = dss[(tr + 16 * i) * L::PS + r];
        }
#pragma unroll
        for (int j = 0; j < L::DC; ++j) {
          oo[j] = dos[r * L::RS + tc + 16 * j];
          qq[j] = qs[r * L::RS + tc + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < L::DC; ++j) {
            dv_acc[i][j] = fmaf(pv[i], oo[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qq[j], dk_acc[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + tr + 16 * i;
    if (kpos >= t_len) continue;
    const size_t off = kv_base + static_cast<size_t>(kpos) * kv * D + head_off;
#pragma unroll
    for (int j = 0; j < L::DC; ++j) {
      store_as(dk + off + tc + 16 * j, dk_acc[i][j] * scale);
      store_as(dv + off + tc + 16 * j, dv_acc[i][j]);
    }
  }
}

// dQ of one query tile of one head: the block loops over the key tiles the
// forward reaches, S and dP by FMA (a 4 x 4 block of (query, key) pairs per
// thread), dS = P (dP - Delta) into shared memory, then dQ += dS K; scaled
// and written once at the end.
template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              T* __restrict__ dq, int s_len, int t_len, int h, int kv,
                              int causal, int window, float scale) {
  using L = FbLayout<D>;
  extern __shared__ float smem[];
  float* qs = smem;                     // [64][RS] the query tile
  float* dos = qs + L::TILE;            // [64][RS] its dO tile
  float* ks = dos + L::TILE;            // [64][RS] a key tile
  float* vs = ks + L::TILE;             // [64][RS] its value tile
  float* dss = vs + L::TILE;            // [64 queries][PS] dS
  __shared__ float lse_s[FB_TILE], delta_s[FB_TILE];

  const int g = h / kv;
  const int tile = gridDim.x - 1 - blockIdx.x;     // longest (latest q) first
  const int q0 = tile * FB_TILE;
  const int b = blockIdx.y / h;
  const int head = blockIdx.y % h;
  const int kvh = head / g;
  const size_t q_base = static_cast<size_t>(b) * s_len * h * D;
  const size_t kv_base = static_cast<size_t>(b) * t_len * kv * D;
  const size_t head_off = static_cast<size_t>(kvh) * D;
  const size_t stat_base = (static_cast<size_t>(b) * h + head) * s_len;
  load_q_tile<T, D>(q + q_base, qs, q0, s_len, h, head);
  load_q_tile<T, D>(dout + q_base, dos, q0, s_len, h, head);
  if (threadIdx.x < FB_TILE) {
    const int qpos = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qpos < s_len ? lse[stat_base + qpos] : 0.0f;
    delta_s[threadIdx.x] = qpos < s_len ? delta[stat_base + qpos] : 0.0f;
  }

  const int tc = threadIdx.x % 16;    // keys tc + 16 j; output columns tc + 16 j
  const int tr = threadIdx.x / 16;    // queries tr + 16 i
  float dq_acc[4][L::DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < L::DC; ++j) dq_acc[i][j] = 0.0f;

  // the forward's key range for these rows
  const int q_hi = min(q0 + FB_TILE, s_len) - 1;
  int k_hi = t_len - 1;
  if (causal) k_hi = min(k_hi, q_hi);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int kt = k_lo / FB_TILE; k_lo <= k_hi && kt <= k_hi / FB_TILE; ++kt) {
    const int k0 = kt * FB_TILE;
    __syncthreads();                  // the previous tile's reads of ks, vs, dss are done
    load_kv_tile<T, D>(k + kv_base, ks, k0, t_len, kv, head_off);
    load_kv_tile<T, D>(v + kv_base, vs, k0, t_len, kv, head_off);
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qq[4], oo[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qq[i] = qs[(tr + 16 * i) * L::RS + d];
        oo[i] = dos[(tr + 16 * i) * L::RS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = ks[(tc + 16 * j) * L::RS + d];
        vv[j] = vs[(tc + 16 * j) * L::RS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qq[i], kk[j], sc[i][j]);
          dp[i][j] = fmaf(oo[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qpos = q0 + tr + 16 * i;
        const int kpos = k0 + tc + 16 * j;
        const bool ok = qpos < s_len && fa_keep(qpos, kpos, t_len, causal, window);
        const float p = ok ? expf(sc[i][j] * scale - lse_s[tr + 16 * i]) : 0.0f;
        dss[(tr + 16 * i) * L::PS + tc + 16 * j] = p * (dp[i][j] - delta_s[tr + 16 * i]);
      }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < FB_TILE; ++c) {
      float dsv[4], kk[L::DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(tr + 16 * i) * L::PS + c];
#pragma unroll
      for (int j = 0; j < L::DC; ++j) kk[j] = ks[c * L::RS + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < L::DC; ++j) dq_acc[i][j] = fmaf(dsv[i], kk[j], dq_acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + tr + 16 * i;
    if (qpos >= s_len) continue;
    T* dst = dq + q_base + (static_cast<size_t>(qpos) * h + head) * D;
#pragma unroll
    for (int j = 0; j < L::DC; ++j) store_as(dst + tc + 16 * j, dq_acc[i][j] * scale);
  }
}

template <typename T, int D>
int launch_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int batch,
                    int s, int t, int h, int kv, int causal, int window, float scale,
                    int p_bf16, cudaStream_t stream) {
  using L = FbLayout<D>;
  static std::atomic<bool> raised[MAX_DEVICES];
  const cudaError_t err = allow_dynamic_smem(flash_attention_bwd_dkdv_kernel<T, D>,
                                             static_cast<int>(L::DKDV_BYTES), raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + FB_TILE - 1) / FB_TILE, batch * kv);
  flash_attention_bwd_dkdv_kernel<T, D><<<grid, FA_THREADS, L::DKDV_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), s, t,
      h, kv, causal, window, scale, p_bf16);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dq, int batch, int s, int t,
                  int h, int kv, int causal, int window, float scale, cudaStream_t stream) {
  using L = FbLayout<D>;
  static std::atomic<bool> raised[MAX_DEVICES];
  const cudaError_t err = allow_dynamic_smem(flash_attention_bwd_dq_kernel<T, D>,
                                             static_cast<int>(L::DQ_BYTES), raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + FB_TILE - 1) / FB_TILE, batch * h);
  flash_attention_bwd_dq_kernel<T, D><<<grid, FA_THREADS, L::DQ_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), s, t, h, kv, causal, window,
      scale);
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
// launches nothing.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, int is_bf16,
                                     void* o, float* lse, int batch, int s, int t, int h, int kv, int d,
                                     int causal, int window, float scale, int p_bf16,
                                     void* stream) {
  using namespace repro_torch;
  if (batch == 0 || s == 0 || h == 0) return 0;
  if (kv <= 0 || h % kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch_for_dim<__nv_bfloat16>(q, k, v, o, lse, batch, s, t, h, kv, d, causal, window, scale, p_bf16, st)
      : launch_for_dim<float>(q, k, v, o, lse, batch, s, t, h, kv, d, causal, window, scale, p_bf16, st);
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
// sums of dout * o, both (batch, s, h, d) in one dtype.
//
// repro_flash_attention_bwd_dkdv: dk, dv (batch, t, kv, d) in q's dtype from
// q, k, v, dout (the forward's operands and the output's gradient, one
// dtype), the forward's lse and delta (batch, h, s) float32; one block per
// (batch * kv head, 64-key tile), the G query heads' sum in a fixed order.
//
// repro_flash_attention_bwd_dq: dq (batch, s, h, d) in q's dtype from the
// same inputs; one block per (batch * head, 64-row tile).
//
// causal, window, scale and p_bf16 are the forward's.  Each returns the
// CUDA error code of its launch (0 = success); an empty input launches
// nothing.
extern "C" int repro_flash_attention_bwd_delta(const void* o, const void* dout, int is_bf16,
                                               float* delta, int batch, int s, int h, int d,
                                               void* stream) {
  using namespace repro_torch;
  const long long n_rows = static_cast<long long>(batch) * s * h;
  if (n_rows == 0) return 0;
  const int threads = 256;
  const long long blocks = (n_rows * 32 + threads - 1) / threads;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    flash_attention_bwd_delta_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), delta,
        n_rows, s, h, d);
  else
    flash_attention_bwd_delta_kernel<float><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), delta, n_rows, s, h, d);
  return static_cast<int>(cudaGetLastError());
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
