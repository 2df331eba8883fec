// Design probe of the GEMV (K6 at b = 1, K5 at nb = 1) for
// scripts/gemv_times.py --sweep: common.cuh's gemv_rows at other rows per
// warp, unroll depths, warps and grids than the kernels' own constants,
// and the other design the kernel was chosen against: A copied by 1-D TMA
// bulk copies (cp.async.bulk ... mbarrier::complete_tx::bytes) into a ring
// of shared-memory stages per warp, one mbarrier a stage, and read from
// there.  Both add every row in the GEMV's order (lane l the 16-byte
// chunks l + 32 j, j ascending), so they give the kernels' bits.
//
// k a multiple of 4 (float32) or 8 (bf16; the TMA design float32 only),
// 16-byte aligned operands.  Built by the
// script with nvcc into the ignored build/ directory:
//   nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o build/gemv_probe.so scripts/gemv_probe.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include "../src/repro_torch/kernels/csrc/common.cuh"

namespace repro_torch {
namespace {

struct StoreF {
  float* out;
  __device__ void operator()(int r, float acc) const { out[r] = acc; }
};

template <typename T, int ROWS, int UNROLL, bool PIPE>
__global__ void __launch_bounds__(512) probe_loads(const T* __restrict__ a,
                                                    const T* __restrict__ x,
                                                    float* __restrict__ out, int m, int k) {
  gemv_rows<T, true, ROWS, UNROLL, PIPE>(a, x, m, k, StoreF{out});
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Warp w walks the rows r0 + w, r0 + w + warps, ... of its block's range,
// each in pieces of `piece` floats (a multiple of 128, so that a piece
// starts on lane 0's chunk); lane 0 keeps `stages` pieces in flight in the
// warp's own ring, every lane waits on the piece's mbarrier and adds its
// chunks from shared memory.  No block-wide barrier.
__global__ void __launch_bounds__(512) probe_tma(const float* __restrict__ a,
                                                  const float* __restrict__ x,
                                                  float* __restrict__ out, int m, int k,
                                                  int stages, int piece) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  float* ring = reinterpret_cast<float*>(smem) + static_cast<size_t>(warp) * stages * piece;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
                       smem + static_cast<size_t>(warps) * stages * piece * 4) + warp * stages;
  const int r0 = static_cast<int>(static_cast<long long>(blockIdx.x) * m / gridDim.x);
  const int r1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * m / gridDim.x);
  const int rows = r1 - r0 > warp ? (r1 - r0 - warp + warps - 1) / warps : 0;
  const int per_row = (k + piece - 1) / piece;
  const int total = rows * per_row;
  if (lane == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  auto issue = [&](int p) {
    const int row = r0 + warp + (p / per_row) * warps;
    const int off = (p % per_row) * piece;
    const int n = min(piece, k - off);
    const int s = p % stages;
    mbar_expect_tx(bars + s, n * 4);
    bulk_load(ring + s * piece, a + static_cast<size_t>(row) * k + off, n * 4, bars + s);
  };
  if (lane == 0)
    for (int p = 0; p < min(stages, total); ++p) issue(p);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int p = 0; p < total; ++p) {
    const int s = p % stages;
    mbar_wait(bars + s, (p / stages) & 1);
    const int off = (p % per_row) * piece;
    const int chunks = min(piece, k - off) / 4;
    const float4* st = reinterpret_cast<const float4*>(ring + s * piece);
    for (int lc = lane; lc < chunks; lc += 32) {
      const float4 g = st[lc];
      const float4 v = __ldg(x4 + off / 4 + lc);
      acc[0] = __fadd_rn(acc[0], __fmul_rn(g.x, v.x));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(g.y, v.y));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(g.z, v.z));
      acc[3] = __fadd_rn(acc[3], __fmul_rn(g.w, v.w));
    }
    // a lane with no chunk left in this piece adds 0 x 0 where the GEMV's
    // order has a padded chunk: only at the row's last piece, where the
    // values are unchanged but for the sign of a zero sum
    __syncwarp();
    if (lane == 0 && p + stages < total) issue(p + stages);
    if (p % per_row == per_row - 1) {
      float s0 = __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s0 = __fadd_rn(s0, __shfl_down_sync(0xffffffffu, s0, o));
      if (lane == 0) out[r0 + warp + (p / per_row) * warps] = s0;
      acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;
    }
  }
}

}  // namespace
}  // namespace repro_torch

// gemv_rows<T, VEC16> (T bf16 when is_bf16, else float32) with `rows` rows
// a warp, `unroll` chunks of each in a batch and the next batch's loads
// issued before the current adds when `pipe`, on `blocks` x 32 `warps`
// threads; the float32 sums go to out.
template <typename T>
int probe_loads_of(const void* a, const void* x, void* out, int m, int k, int key, int blocks,
                   int warps, cudaStream_t s) {
  using namespace repro_torch;
  auto ap = static_cast<const T*>(a);
  auto xp = static_cast<const T*>(x);
  auto op = static_cast<float*>(out);
#define PROBE_CASE(R, U, P)                                                         \
  case R * 100 + U * 10 + P:                                                        \
    probe_loads<T, R, U, (P != 0)><<<blocks, 32 * warps, 0, s>>>(ap, xp, op, m, k); break;
  switch (key) {
    PROBE_CASE(1, 8, 0)
    PROBE_CASE(1, 8, 1)
    PROBE_CASE(2, 2, 1)
    PROBE_CASE(2, 4, 0)
    PROBE_CASE(2, 4, 1)
    PROBE_CASE(2, 8, 0)
    PROBE_CASE(4, 2, 1)
    PROBE_CASE(4, 4, 0)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PROBE_CASE
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_gemv_loads(const void* a, const void* x, void* out, int m, int k,
                                int is_bf16, int rows, int unroll, int pipe, int blocks,
                                int warps, void* stream) {
  const int key = rows * 100 + unroll * 10 + (pipe ? 1 : 0);
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? probe_loads_of<__nv_bfloat16>(a, x, out, m, k, key, blocks, warps, s)
                 : probe_loads_of<float>(a, x, out, m, k, key, blocks, warps, s);
}

// The TMA design on `blocks` x 32 `warps` threads: each warp a ring of
// `stages` pieces of `piece` floats (a multiple of 128).
extern "C" int probe_gemv_tma(const void* a, const void* x, void* out, int m, int k, int stages,
                              int piece, int blocks, int warps, void* stream) {
  using namespace repro_torch;
  if (piece % 128 != 0 || k % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = warps * stages * (piece * 4 + 8);
  cudaError_t err = cudaFuncSetAttribute(probe_tma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_tma<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x), static_cast<float*>(out), m, k,
      stages, piece);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
