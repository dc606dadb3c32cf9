// K3: s8 x s8 -> s32 GEMM with the W8A8 scale epilogue fused in.
//
// Replaces the s8 products of slam_llm_tpu/ops/quant.py (_s8_dot and
// _fwd_value; the dx products of _int8_dx and _int8_dx_rot) and of the int8
// CE head (ops/fused_ce.py chunk_logits and its int8_sr dx), which XLA
// computes on the TPU:
//   out[m, n] = (float)(sum_k xq[m, k] * wq[n, k]) * xs[m] * ws[n]
// written as bf16 (the denses) or f32 (the CE head's logits, and dx in f32
// compute) in the same pass. xq (M, K) and wq (N, K) are both K-contiguous
// ("TN"), the layout mma.sync's row.col int8 form reads directly and the
// layout later wgmma work wants; the dx products read a stored transpose of
// the weight for that reason.
//
// Bound on the H100: at prefill (M ~ 3.6k rows) the int8 tensor cores; at
// decode (M = 8..32 rows) the bytes of wq, read once per call. This first
// version is simple: 64x64 output tiles, four warps of 32x32, each running
// mma.sync.m16n8k32 on 64-byte K slices staged through padded shared memory
// (row pitch 80 bytes: fragment reads are bank-conflict free), with an exact
// s32 accumulator (K <= 32000 keeps |acc| <= 5.2e8 < 2^31). Occupancy, not a software
// pipeline, hides the global loads. The epilogue converts acc to f32 with
// round-to-nearest and multiplies row scale then column scale, the order
// _fwd_value uses, so the result is bit-exact against a float64 reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 64;
constexpr int LDS = BK + 16;  // shared-memory row pitch in bytes
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                       const float* __restrict__ xs, const float* __restrict__ ws,
                       OutT* __restrict__ out, int m, int n, int k) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // stage one 64x64-byte tile of each operand in 16-byte chunks; rows past
    // M or N and columns past K (K is a multiple of 16) read as zero
    for (int c = tid; c < BM * BK / 16; c += kThreads) {
      const int r = c >> 2, col = (c & 3) * 16, gk = k0 + col;
      uint4 va = make_uint4(0, 0, 0, 0), vb = make_uint4(0, 0, 0, 0);
      if (m0 + r < m && gk < k)
        va = *reinterpret_cast<const uint4*>(xq + static_cast<long long>(m0 + r) * k + gk);
      if (n0 + r < n && gk < k)
        vb = *reinterpret_cast<const uint4*>(wq + static_cast<long long>(n0 + r) * k + gk);
      *reinterpret_cast<uint4*>(As + r * LDS + col) = va;
      *reinterpret_cast<uint4*>(Bs + r * LDS + col) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = As + (wm + i * 16 + g) * LDS + kk + t * 4;
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * LDS);
        a[i][2] = ld32(p + 16);
        a[i][3] = ld32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = Bs + (wn + j * 8 + g) * LDS + kk + t * 4;
        b[j][0] = ld32(p);
        b[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int hrow = 0; hrow < 2; ++hrow) {
      const int row = m0 + wm + i * 16 + g + hrow * 8;
      if (row >= m) continue;
      const float sx = xs[row];
      OutT* orow = out + static_cast<long long>(row) * n;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + j * 8 + t * 2 + e;
          if (col < n)
            store(orow + col, static_cast<float>(acc[i][j][hrow * 2 + e]) * sx * ws[col]);
        }
      }
    }
  }
}

}  // namespace

extern "C" int slam_int8_matmul(const void* xq, const void* wq, const void* xs, const void* ws,
                                void* out, int m, int n, int k, int out_f32, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(wq);
  const float* sa = static_cast<const float*>(xs);
  const float* sb = static_cast<const float*>(ws);
  if (out_f32)
    int8_matmul_kernel<float><<<grid, kThreads, 0, st>>>(a, b, sa, sb, static_cast<float*>(out), m, n, k);
  else
    int8_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a, b, sa, sb,
                                                                 static_cast<__nv_bfloat16*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}
