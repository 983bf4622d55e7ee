// Warp-level tensor-core pieces (ldmatrix, mma.sync bf16, movmatrix) for
// the attention kernels. Register layout of mma.sync.m16n8k16 (lane =
// 4 * gid + tq): an accumulator tile (16 x 8) holds rows gid (c[0], c[1])
// and gid + 8 (c[2], c[3]) at columns 2*tq, 2*tq + 1.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace rt {

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// Two 8x8 b16 matrices; lanes 0-15 give the addresses (row l % 8 of matrix l / 8).
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// cap * tanh(x / cap) as cap - 2 cap / (e^{x c2} + 1), c2 = 2 / cap: two
// MUFU operations where tanhf takes about 20 instructions, within about
// 1e-6 of it relative to cap (the tensor-core kernels' softcap).
__device__ __forceinline__ float soft_cap_fast(float x, float cap, float c2) {
  return cap - 2.f * cap * __fdividef(1.f, __expf(c2 * x) + 1.f);
}

// The transpose of an 8x8 b16 matrix held in the fragment layout (lane
// 4 * gid + tq holds row gid, columns 2*tq, 2*tq + 1), in the same layout.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

}  // namespace rt
