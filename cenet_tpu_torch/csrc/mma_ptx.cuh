// The PTX that the tensor-core attention kernels (attention_tc.cuh) are built
// from, one inline-assembly wrapper each (sm_80 instructions, all present on
// sm_90a):
//   cp.async         16-byte (and 4-byte) copies from device to shared memory
//                    that do not hold the issuing thread, in commit groups;
//   ldmatrix         a warp loads four 8 x 8 tiles of 16-bit values from shared
//                    memory into the register fragments of mma.sync, plain or
//                    transposed;
//   mma.sync m16n8k16  D = A B + C for a 16 x 16 bf16 A (row-major), a 16 x 8
//                    bf16 B (column-major) and fp32 C, D;
//   ex2.approx.ftz   2^x, the exponential of the softmax.
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A: a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..2t+1), a[2] = (g, 2t+8..2t+9),
//      a[3] = (g+8, 2t+8..2t+9), two bf16 per register, lower column low;
//   B: b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8..2t+9, n g);
//   C, D: c[0], c[1] = (g, 2t), (g, 2t+1); c[2], c[3] = (g+8, 2t), (g+8, 2t+1).
// ldmatrix .x4: lanes 8j..8j+7 give the row addresses of tile j, and register
// j of lane l receives (row l/4, columns 2(l%4)..+1) of tile j, or with .trans
// (rows 2(l%4)..+1, column l/4).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cenet {
namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (ex2.approx.ftz: about 2 ulp; results
// below 2^-126 flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values rounded to bf16 (round to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace tc
}  // namespace cenet
