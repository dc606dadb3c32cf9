// Device code shared by the f32 routes of the flash-attention forward (K1
// f32, csrc/flash_attention_f32.cu) and backward (K4 f32,
// csrc/flash_attention_bwd_f32.cu): f32 products on the tensor cores as
// 3-pass split TF32 (3xTF32), and the tiles they read.
//
// The split. Each f32 operand x becomes hi = tf32(x) and lo = tf32(x - hi)
// (round to nearest, ties away from zero; x - hi is exact in f32), and
//   a b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b,
// each term a TF32 wgmma with f32 accumulation. The dropped lo_a lo_b and
// the two roundings of lo leave ~3 x 2^-22 of |a b| per product, within
// f32's reach for these sums. The two small terms go into the accumulator
// first and the large one last, so the tensor core's own rounding of the
// running sum (truncation, no guard bits) acts on the small terms while
// the sum is still small. Long sums (over keys in P V, over queries in dk
// / dv) are taken one tile at a time into fresh registers and added to the
// running sum with ordinary f32 adds.
//
// Tiles. Every operand is read from shared memory K-major (TF32 wgmma has
// no transpose), in panels of 32 f32 (128 bytes, one 128-byte swizzle
// row): element (r, c) of a tile of `rows` rows sits in panel c / 32 at
// byte r * 128 + (((c % 32) / 4) ^ (r % 8)) * 16 + (c % 4) * 4, each panel
// rows x 128 bytes, the tile 1024-byte aligned. A k8 step is 32 bytes, so
// the descriptors are the bf16 tiles' (flash_common.cuh: kmajor_step, with
// kk counting k8 steps). hi and lo are two such tiles.
//
// Fragments. The accumulator of m64nNk8 holds d[4 j + 2 h + e] = (row
// 16 w + g + 8 h, column 8 j + 2 t + e) in warp w, lane l (g = l / 4,
// t = l % 4); the TF32 A fragment of a k8 step holds a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4). So a thread owns
// accumulator columns 2 t, 2 t + 1 where the fragment wants t, t + 4: the
// products that take an accumulator as their A operand (P V, dS K, P^T dO,
// dS^T Q) read its columns permuted within each group of 8 (A column c is
// accumulator column 2 (c % 4) + c / 4), and their B operands are staged
// with the same permutation of their k index (perm8), which leaves the sum
// over k unchanged and needs no shuffle.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace slam {
namespace f32 {

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero:
// cvt.rna.tf32.f32 for every finite x, in two integer operations (ptxas
// emulates the cvt with a NaN check around them)
__device__ __forceinline__ uint32_t to_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// the staged column of k index r: r's place within its group of 8 permuted
// as the A fragments read the accumulator (2 (c % 4) + c / 4 -> c)
__device__ __forceinline__ int perm8(int r) { return (r & ~7) | ((r & 1) << 2) | ((r >> 1) & 3); }

// byte offset of element (r, 4 c4) of a K-major tile of `rows` rows
__device__ __forceinline__ int kmajor_off(int rows, int r, int c4) {
  return (c4 >> 3) * rows * kPanelBytes + r * kPanelBytes + (((c4 & 7) ^ (r & 7)) << 4);
}

// row r, columns 4 c4 .. 4 c4 + 3 of an operand into K-major hi / lo tiles
// of `rows` rows (the k index is the column): one 16-byte store each
__device__ __forceinline__ void store_rows(uint8_t* hi, uint8_t* lo, int rows, int r, int c4, float4 v) {
  uint4 h, l;
  split(v.x, h.x, l.x);
  split(v.y, h.y, l.y);
  split(v.z, h.z, l.z);
  split(v.w, h.w, l.w);
  const int off = kmajor_off(rows, r, c4);
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(lo + off) = l;
}

// row r, columns 4 c4 .. 4 c4 + 3 of an operand whose rows are the k index
// into K-major hi / lo tiles of `rows` rows transposed: element (r, c)
// lands at (c, perm8(r)). Lanes on consecutive r write distinct banks.
__device__ __forceinline__ void store_cols(uint8_t* hi, uint8_t* lo, int rows, int r, int c4, float4 v) {
  const int col = perm8(r);
  const int base = (col >> 5) * rows * kPanelBytes + (col & 3) * 4, chunk = (col & 31) >> 2;
  const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = 4 * c4 + e, off = base + d * kPanelBytes + ((chunk ^ (d & 7)) << 4);
    uint32_t h, l;
    split(x[e], h, l);
    *reinterpret_cast<uint32_t*>(hi + off) = h;
    *reinterpret_cast<uint32_t*>(lo + off) = l;
  }
}

// the hi / lo A fragments of k8 step kk (accumulator columns 8 kk .. 8 kk + 7, permuted)
template <int NACC>
__device__ __forceinline__ void a_fragment(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&d)[NACC], int kk) {
  split(d[4 * kk], hi[0], lo[0]);
  split(d[4 * kk + 2], hi[1], lo[1]);
  split(d[4 * kk + 1], hi[2], lo[2]);
  split(d[4 * kk + 3], hi[3], lo[3]);
}

// d (+)= A[64 x 8] B[N x 8]^T, TF32, A and B K-major in shared memory
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int scale_d);
// d (+)= A[64 x 8] B[N x 8]^T, TF32, A in registers, B K-major in shared memory
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void mma_ss<16>(float (&d)[8], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void mma_ss<32>(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (=, or += with `acc`) A B^T over KS k8 steps, 3xTF32: A rows [a_row0,
// a_row0 + 64) of the hi / lo tiles of a_rows rows, B the N rows of its
// tiles; the small terms first. Issues the wgmmas; the caller fences,
// commits and waits.
template <int N, int KS>
__device__ __forceinline__ void mma3_ss(float (&d)[N / 2], const uint8_t* a_hi, const uint8_t* a_lo, int a_rows,
                                        int a_row0, const uint8_t* b_hi, const uint8_t* b_lo, bool acc) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    mma_ss<N>(d, kmajor_step(a_hi, a_rows, a_row0, kk), kmajor_step(b_lo, N, 0, kk), acc || kk > 0);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma_ss<N>(d, kmajor_step(a_lo, a_rows, a_row0, kk), kmajor_step(b_hi, N, 0, kk), 1);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma_ss<N>(d, kmajor_step(a_hi, a_rows, a_row0, kk), kmajor_step(b_hi, N, 0, kk), 1);
}

// d = A B^T over KS k8 steps, 3xTF32, A's hi / lo fragments in registers,
// B the N rows of its hi / lo tiles; the small terms first. Synchronous:
// fence, issue, commit, wait.
template <int N, int KS>
__device__ __forceinline__ void mma3_rs_sync(float (&d)[N / 2], const uint32_t (&a_hi)[KS][4],
                                             const uint32_t (&a_lo)[KS][4], const uint8_t* b_hi, const uint8_t* b_lo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma_rs<N>(d, a_hi[kk], kmajor_step(b_lo, N, 0, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma_rs<N>(d, a_lo[kk], kmajor_step(b_hi, N, 0, kk), 1);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma_rs<N>(d, a_hi[kk], kmajor_step(b_hi, N, 0, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
}

// a tile of R rows x D f32 from global memory (row r at src + r * stride,
// rows at or past `valid` read as 0), shared by TH threads in chunks of N
// float4 a thread, in the order the stores take it: item i of chunk i0 of
// thread pt is it = pt + TH (i0 + i), row it % R, columns 4 (it / R) ..
template <int R, int D, int N, int TH = 128>
__device__ __forceinline__ void load_tile(float4 (&v)[N], const float* src, long long stride, int valid, int pt,
                                          int i0 = 0) {
  static_assert(R * D / 4 % (N * TH) == 0, "a tile is whole chunks of N float4 a thread");
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int it = pt + TH * (i0 + i), r = it % R, c4 = it / R;
    v[i] = r < valid ? __ldg(reinterpret_cast<const float4*>(src + r * stride) + c4) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// load_tile's chunk into K-major hi / lo tiles of `rows` rows (R unless the
// R rows are a share of the tile), the R rows from row r0 on
template <int R, int N, int TH = 128>
__device__ __forceinline__ void store_tile_rows(uint8_t* hi, uint8_t* lo, const float4 (&v)[N], int pt, int i0 = 0,
                                                int rows = R, int r0 = 0) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int it = pt + TH * (i0 + i);
    store_rows(hi, lo, rows, r0 + it % R, it / R, v[i]);
  }
}

template <int R, int D, int N>
__device__ __forceinline__ void store_tile_cols(uint8_t* hi, uint8_t* lo, const float4 (&v)[N], int pt) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int it = pt + 128 * i;
    store_cols(hi, lo, D, it % R, it / R, v[i]);
  }
}

}  // namespace f32
}  // namespace slam
