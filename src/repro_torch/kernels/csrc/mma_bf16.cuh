// Tensor-core building blocks shared by the bf16 routes of K6
// (crosspoint_mvm.cu) and K8 (flash_attention.cu): the warp-level bf16
// product with float32 accumulators, ldmatrix, 16-byte asynchronous
// copies into shared memory, and the launch helper for kernels past
// 48 KB of dynamic shared memory.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (PTX ISA, "Matrix
// fragments for mma.m16n8k16"), for lane = 4 * gid + tig:
//   A (16 x 16, row-major), 4 registers of two bf16:
//     a[0] = A[gid][2 tig .. +1],     a[1] = A[gid + 8][2 tig .. +1],
//     a[2] = A[gid][2 tig + 8 .. +9], a[3] = A[gid + 8][2 tig + 8 .. +9];
//   B (16 x 8, k by n), 2 registers:
//     b[0] = B[2 tig .. +1][gid],     b[1] = B[2 tig + 8 .. +9][gid];
//   C, D (16 x 8, float32), 4 registers:
//     c[0..1] = C[gid][2 tig .. +1],  c[2..3] = C[gid + 8][2 tig .. +1].
// The accumulator of a 16 x 16 product tile (two n8 blocks) is laid out
// as the A fragment of the next product, which is how K8 feeds its
// probabilities to the PV product from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace repro_torch {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared that bypasses L1 (cp.async.cg).  Only the
// first src_bytes (0 or 16) are read; the rest of the 16 bytes are zero
// filled, so a tile edge needs no separate store.  Both addresses must be
// 16-byte aligned, and src must be a valid address even when src_bytes is 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// 4-byte copy global -> shared (cp.async.ca), for per-row float32 stats;
// src_bytes is 0 or 4, the rest zero filled, as cp_async16.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i, and r[i] holds matrix i in the A/B fragment order
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// the same, each matrix transposed: for a B operand stored k-major
// (row k, column n), as V and the crossbar's voltages are
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// d += a b on the tensor cores: bf16 operands, float32 accumulators.  It
// touches registers only, so it is not volatile: the compiler may move it
// between independent products.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to nearest-even bf16, `lo` in the low half (the
// lower column index of a fragment register)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x - float(bf16(x)): the part of x that a bf16 rounding leaves out
__device__ __forceinline__ float bf16_residual(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

// Raise `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device, once per device: the attribute belongs to one device, and a
// launch past 48 KB without it is refused.  `raised` holds the flags of
// one kernel instantiation (setting the attribute twice is harmless; a
// warm-up call before a CUDA graph capture keeps the call out of the
// captured launches).
constexpr int MAX_DEVICES = 64;

template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, int bytes,
                                      std::atomic<bool> (&raised)[MAX_DEVICES]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < MAX_DEVICES && raised[device].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  // the largest shared-memory carveout, so that as many blocks fit on an
  // SM as their shared memory allows
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && device < MAX_DEVICES) raised[device].store(true);
  return err;
}

}  // namespace repro_torch
