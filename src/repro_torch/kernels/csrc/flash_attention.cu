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
// What bounds it on an H100.  At the serving path's prefill shape (B = 1,
// S = T = 2048, H = 32, KV = 8, D = 128, causal) the two products take
// 4 * H * D * S (S + 1) / 2 = 34.4 GFLOP against 42 MB of q, k, v and o:
// operations, 35 us at the bf16 tensor-core peak (989 TFLOP/s), 0.51 ms
// at the float32 FMA peak (67 TFLOP/s) that this kernel's arithmetic
// runs at.
//
// Design (the simple, correct first version; no tensor cores, no TMA).
// The Pallas grid (batch * kv head, q tile, kv tile) with the kv axis
// sequential and a VMEM carry becomes one thread block per (batch * kv
// head, row tile) with the kv loop inside the block.  A row tile is 64
// consecutive rows of the flattened (q position, group member) index
// R = qpos * G + g of one KV head, so the block holds all G query heads
// that share its K/V tiles (K/V are never repeated) and any G works
// (G = 1 up to MQA's G = H).  Per 64-key tile: the K tile is staged in
// shared memory (converted to float32, zero past T), every thread forms
// a 4 x 4 block of scores with float32 FMA, the row max and sum are
// reduced over the 16 lanes that share a row (shuffles, no shared
// memory), the probabilities go to shared memory, the V tile replaces
// the K tile, and every thread adds its 4 x D/16 outputs.  Tiles that
// the causal mask or the window make unreachable for every row of the
// block are skipped; the element mask is the reference's.  Row tiles are
// issued longest first (causal work grows with the q position).  Ragged
// S and T are masked in the loads and stores: nothing is padded and the
// rows past S * G are never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int FA_THREADS = 256;
constexpr int FA_ROWS = 64;       // rows (q position, group member) per block
constexpr int FA_KB = 64;         // keys per tile
constexpr float FA_NEG_INF = -1e30f;
constexpr int FA_MAX_DEVICES = 64;  // devices whose shared-memory limit is cached

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
                       const T* __restrict__ v, T* __restrict__ o,
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
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int s, int t,
           int h, int kv, int causal, int window, float scale, int p_bf16,
           cudaStream_t stream) {
  using L = FaLayout<D>;
  // past 48 KB of dynamic shared memory.  The attribute belongs to one
  // device, so it is raised once for each device this instantiation
  // launches on (setting it twice is harmless; a warm-up call before a
  // CUDA graph capture keeps the call out of the captured launches)
  static std::atomic<bool> raised[FA_MAX_DEVICES];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= FA_MAX_DEVICES || !raised[device].load()) {
    err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < FA_MAX_DEVICES) raised[device].store(true);
  }
  const int n_rows = s * (h / kv);
  const dim3 grid((n_rows + FA_ROWS - 1) / FA_ROWS, batch * kv);
  flash_attention_kernel<T, D><<<grid, FA_THREADS, L::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, t, h, kv, causal, window, scale, p_bf16);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for_dim(const void* q, const void* k, const void* v, void* o, int batch, int s,
                   int t, int h, int kv, int d, int causal, int window, float scale,
                   int p_bf16, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, batch, s, t, h, kv, causal, window, scale, p_bf16, stream);
    case 32: return launch<T, 32>(q, k, v, o, batch, s, t, h, kv, causal, window, scale, p_bf16, stream);
    case 64: return launch<T, 64>(q, k, v, o, batch, s, t, h, kv, causal, window, scale, p_bf16, stream);
    case 128: return launch<T, 128>(q, k, v, o, batch, s, t, h, kv, causal, window, scale, p_bf16, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// C interface (bound with ctypes).  q (batch, s, h, d), k and v
// (batch, t, kv, d), o (batch, s, h, d): device pointers of contiguous
// tensors of one dtype (float32, or bfloat16 when is_bf16).  d is 16,
// 32, 64 or 128 and kv divides h; window = 0 means no window.  Returns
// the CUDA error code of the launch (0 = success); an empty output
// launches nothing.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, int is_bf16,
                                     void* o, int batch, int s, int t, int h, int kv, int d,
                                     int causal, int window, float scale, int p_bf16,
                                     void* stream) {
  using namespace repro_torch;
  if (batch == 0 || s == 0 || h == 0) return 0;
  if (kv <= 0 || h % kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch_for_dim<__nv_bfloat16>(q, k, v, o, batch, s, t, h, kv, d, causal, window, scale, p_bf16, st)
      : launch_for_dim<float>(q, k, v, o, batch, s, t, h, kv, d, causal, window, scale, p_bf16, st);
}
