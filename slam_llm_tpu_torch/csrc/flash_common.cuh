// Device helpers shared by the flash-attention forward (K1) and backward
// (K4): bf16 mma.sync, fragment loads, and the fused RoPE rotation.
//
// RoPE (HF-llama rotate-half): for a head row x of width D, half = D/2,
//   out[c]        = x[c] * cos[c] - x[c + half] * sin[c]          (c < half)
//   out[c + half] = x[c + half] * cos[c] + x[c] * sin[c]
// computed in f32 with each product and the sum rounded separately (no FMA
// contraction), then rounded to bf16 once: the numerics of the plain
// apply_rope_tables, so the fused kernels see exactly the rotated q/k the
// plain path builds. The transpose R^T (for dq/dk) swaps the sign of sin.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace slam {

constexpr float kNeg = -1.0e30f;  // masked-score sentinel (log2 domain)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats -> one bf16x2 register, lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// one rotated element: x at column c (< half: lower, else upper), p its
// partner at c +- half, (cs, sn) the table entries at c mod half
__device__ __forceinline__ float rope1(float x, float p, float cs, float sn, bool upper) {
  const float a = __fmul_rn(x, cs), b = __fmul_rn(p, sn);
  return upper ? __fadd_rn(a, b) : __fsub_rn(a, b);
}

// the bf16 pair at columns (c, c+1) of one head row, rotated when cs_row is
// given (cs_row / sn_row: this position's (D/2,) f32 tables)
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* row, int c, const float* cs_row,
                                              const float* sn_row, int half) {
  if (cs_row == nullptr) return ld32(row + c);
  const bool upper = c >= half;
  const int j = upper ? c - half : c;
  const int pc = upper ? c - half : c + half;
  const float r0 = rope1(__bfloat162float(row[c]), __bfloat162float(row[pc]), cs_row[j], sn_row[j], upper);
  const float r1 =
      rope1(__bfloat162float(row[c + 1]), __bfloat162float(row[pc + 1]), cs_row[j + 1], sn_row[j + 1], upper);
  return pack_bf16(r0, r1);
}

// the 8 bf16 at columns col .. col+7 of one head row (16-byte aligned), rotated
// when cs_row is given
__device__ __forceinline__ uint4 load_chunk8(const __nv_bfloat16* row, int col, const float* cs_row,
                                             const float* sn_row, int half) {
  const uint4 own = *reinterpret_cast<const uint4*>(row + col);
  if (cs_row == nullptr) return own;
  const bool upper = col >= half;
  const int j = upper ? col - half : col;
  const uint4 par = *reinterpret_cast<const uint4*>(row + (upper ? col - half : col + half));
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&own);
  const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(&par);
  uint4 out;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    o[i] = __float2bfloat16_rn(
        rope1(__bfloat162float(e[i]), __bfloat162float(p[i]), cs_row[j + i], sn_row[j + i], upper));
  return out;
}

}  // namespace slam
