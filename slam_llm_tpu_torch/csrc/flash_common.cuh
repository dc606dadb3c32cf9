// Device code shared by the flash-attention forward (K1) and backward (K4):
// the bf16 wgmma products, the layout of a tile in shared memory, the
// per-tile key mask, and the fused RoPE rotation.
//
// Tiles. TMA writes every bf16 tile as panels of 64 columns (128 bytes, one
// 128-byte swizzle row), each panel `rows` x 128 bytes, the next panel
// rows x 128 bytes on; D = 64 is one panel, D = 128 two. Element (r, c) sits
// in panel c / 64 at byte r * 128 + (((c % 64) / 8) ^ (r % 8)) * 16 + (c % 8) * 2.
// One tile serves both operand majors: as a K-major operand (rows are M or
// N, columns the contraction) through desc_kmajor, and as an MN-major one
// (rows are the contraction, columns N) through desc_mnmajor with the panel
// stride as LBO: so V, Q, dO and K are never stored transposed.
//
// Fragments. The f32 accumulator of wgmma m64nNk16 holds, in warp w of the
// warpgroup and lane l (g = l / 4, t = l % 4), d[4 j + 2 h + e] = (row
// 16 w + g + 8 h, column 8 j + 2 t + e): the m16n8 layout of mma.sync per
// 8 columns. For 16-bit data, columns 16 kk .. 16 kk + 15 of it are exactly
// the register A fragment of one k16 step (p_fragment), so P and dS go from
// one product to the next without leaving registers.
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

#include "hopper.cuh"

namespace slam {

constexpr float kNeg = -1.0e30f;  // masked-score sentinel (log2 domain)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPanelBytes = 128;  // one 64-column bf16 panel row

// 2^x on the SFU (flush to zero below 2^-126: probabilities that small are 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one bf16x2 register, lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[64 x 64] (+)= A[64 x 16] * B[64 x 16]^T, A and B K-major bf16 in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64 x 64] (+)= A[64 x 16] * B[16 x 64], A in registers (the m16n8k16 row fragment of each
// warp's 16 rows), B MN-major bf16 in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d[64 x 128] (+)= A[64 x 16] * B[128 x 16]^T, A and B K-major bf16 in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128], A in registers (the m16n8k16 row fragment of each
// warp's 16 rows), B MN-major bf16 in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (+)= A * B^T with A (64 x 16) and B (N x 16) K-major tiles in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, desc_a, desc_b, scale_d);
  else wgmma_ss_n128(d, desc_a, desc_b, scale_d);
}

// d += A * B with A (64 x 16) in registers and B (16 x N) MN-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, desc_b, 1);
  else wgmma_rs_n128(d, a, desc_b, 1);
}

// the K-major descriptor of k16 step kk of rows [row0, row0 + 64) of a tile
// of `rows` rows (panels of rows x 128 bytes)
__device__ __forceinline__ uint64_t kmajor_step(const uint8_t* tile, int rows, int row0, int kk) {
  return desc_kmajor(tile + (kk >> 2) * rows * kPanelBytes + row0 * kPanelBytes + (kk & 3) * 32);
}

// the MN-major descriptor of k16 step kk (rows 16 kk .. 16 kk + 15) of a tile of `rows` rows
__device__ __forceinline__ uint64_t mnmajor_step(const uint8_t* tile, int rows, int kk) {
  return desc_mnmajor(tile + kk * 16 * kPanelBytes, static_cast<uint32_t>(rows * kPanelBytes));
}

// columns 16 kk .. 16 kk + 15 of an accumulator as the A fragment of a k16 step
template <int NACC>
__device__ __forceinline__ void p_fragment(uint32_t (&a)[4], const float (&d)[NACC], int kk) {
  const int j0 = 8 * kk, j1 = 8 * kk + 4;
  a[0] = pack_bf16(d[j0], d[j0 + 1]);
  a[1] = pack_bf16(d[j0 + 2], d[j0 + 3]);
  a[2] = pack_bf16(d[j1], d[j1 + 1]);
  a[3] = pack_bf16(d[j1 + 2], d[j1 + 3]);
}

// the producer warp's key mask of one tile: lane l loads the mask values of
// keys k0 + 32 w + l (0 past tk) ...
template <int NW>
__device__ __forceinline__ void load_key_mask(int (&mv)[NW], const int* mask_row, int k0, int tk, int lane) {
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int key = k0 + 32 * w + lane;
    mv[w] = key < tk ? __ldg(mask_row + key) : 0;
  }
}

// ... and lane 0 stores them as bits: bit i of word w is key k0 + 32 w + i
// valid
template <int NW>
__device__ __forceinline__ void tile_key_bits(uint32_t* words, const int (&mv)[NW], int lane) {
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const uint32_t bits = __ballot_sync(0xffffffffu, mv[w] != 0);
    if (lane == 0) words[w] = bits;
  }
}

// one rotated element: x at column c (< half: lower, else upper), p its
// partner at c +- half, (cs, sn) the table entries at c mod half
__device__ __forceinline__ float rope1(float x, float p, float cs, float sn, bool upper) {
  const float a = __fmul_rn(x, cs), b = __fmul_rn(p, sn);
  return upper ? __fadd_rn(a, b) : __fsub_rn(a, b);
}

// rotates the 8 lower (lo) and 8 upper (hi) bf16 of one row chunk with the
// table entries cs / sn [0, 8)
__device__ __forceinline__ void rope_chunk(uint4& lo, uint4& hi, const float (&cs)[8], const float (&sn)[8]) {
  __nv_bfloat16* l = reinterpret_cast<__nv_bfloat16*>(&lo);
  __nv_bfloat16* u = reinterpret_cast<__nv_bfloat16*>(&hi);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float x = __bfloat162float(l[i]), y = __bfloat162float(u[i]);
    l[i] = __float2bfloat16_rn(rope1(x, y, cs[i], sn[i], false));
    u[i] = __float2bfloat16_rn(rope1(y, x, cs[i], sn[i], true));
  }
}

// 8 f32 table entries (32-byte aligned) into registers
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p)), b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// The rotate pass: x (B, T, Hx, D) bf16 with strides (sb, st, sh, 1) ->
// out (B, T, Hx, D) contiguous, rotated with cos / sin (B, T, D/2) f32.
// One thread per 8-column chunk of the lower half (and its partner).
template <int D>
__device__ __forceinline__ void rope_pass(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                                          const float* __restrict__ cos_t, const float* __restrict__ sin_t, int b,
                                          int T, int hx, long long sb, long long st, long long sh) {
  constexpr int HALF = D / 2, CH = HALF / 8;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(b) * T * hx * CH) return;
  const int c = static_cast<int>(i % CH) * 8;
  const long long row = i / CH;  // (bb, t, head)
  const int head = static_cast<int>(row % hx);
  const long long bt = row / hx;  // bb * T + t
  const int t = static_cast<int>(bt % T), bb = static_cast<int>(bt / T);
  const __nv_bfloat16* src = x + bb * sb + t * st + head * sh;
  uint4 lo = *reinterpret_cast<const uint4*>(src + c), hi = *reinterpret_cast<const uint4*>(src + c + HALF);
  float cs[8], sn[8];
  load8(cs, cos_t + bt * HALF + c);
  load8(sn, sin_t + bt * HALF + c);
  rope_chunk(lo, hi, cs, sn);
  __nv_bfloat16* dst = out + row * D;
  *reinterpret_cast<uint4*>(dst + c) = lo;
  *reinterpret_cast<uint4*>(dst + c + HALF) = hi;
}

// counter-rotates an accumulator in place (d_pre = R^T d_post):
//   lower' = lower * cos + upper * sin,  upper' = upper * cos - lower * sin
// d[4 j + 2 h + e] holds column 8 j + 2 t + e of row h; column c + half sits
// at j + D / 16. cs[h] / sn[h]: row h's (D/2,) tables, or null (no row).
template <int D>
__device__ __forceinline__ void rope_transpose(float (&d)[D / 2], int t, const float* const (&cs)[2],
                                               const float* const (&sn)[2]) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (cs[h] == nullptr) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + t * 2 + e, lo = 4 * j + 2 * h + e, hi = lo + D / 4;
        const float a = d[lo], b = d[hi];
        d[lo] = a * cs[h][c] + b * sn[h][c];
        d[hi] = b * cs[h][c] - a * sn[h][c];
      }
    }
  }
}

}  // namespace slam
