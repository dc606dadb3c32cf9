// K1: flash-attention forward, bf16 in, f32 online softmax, GQA, optional
// fused RoPE.
//
// Replaces the Pallas forward of slam_llm_tpu/ops/kernels/flash_attention.py
// (_flash_fwd: _fwd_wide_kernel and _fwd_kernel):
//   out = softmax(q k^T * scale + mask) v,  lse = log2-sum-exp2 of the scores
// with the same conventions: scores in the exp2 domain, key padding from an
// int32 mask, causal start-aligned (key j visible to query i iff j <= i, so
// the caller only asks for it when Tq == Tk), and all-masked query rows
// written as exactly 0 (their lse is meaningless, as in the TPU kernel).
// With (cos, sin) tables (B, T, D/2) f32 the kernel takes PRE-rotation q/k
// and rotates each q row fragment in registers and each k tile once as it
// is loaded (flash_common.cuh: f32 rotation, one bf16 rounding -- the
// numerics of the plain apply_rope_tables, not the TPU kernel's bf16 chain).
//
// Bound on the H100: at the slice's shapes (T = 448..1500, D = 64) the
// tensor cores and the softmax's exp2 per score; the (Tq, Tk) scores never
// reach device memory. One block owns (batch, query head, 64 query rows);
// each of its four warps holds 16 rows' Q fragments, scores and output
// accumulator in registers and runs mma.sync.m16n8k16 (bf16 in, f32
// accumulate) for q k^T and p v. Key tiles of 64 are staged in shared memory,
// K row-major and V transposed so both feed mma's column operand with 32-bit
// reads; both have padded rows so those reads are bank-conflict free. A
// query head reads kv head h / (H / Hkv) (GQA) straight from the model's
// (B, T, H, D) layout through explicit strides. Ragged T is masked in the
// kernel. Causal blocks stop at the diagonal tile.

#include "flash_common.cuh"

namespace {

using slam::kNeg;
using slam::ld32;
using slam::load_chunk8;
using slam::load_pair;
using slam::mma_bf16;
using slam::pack_bf16;

constexpr int BQ = 64;   // query rows per block (4 warps x 16)
constexpr int BKV = 64;  // keys per tile
constexpr int kThreads = 128;

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, int tq, int tk, int h, int hkv, long long qsb, long long qst,
    long long qsh, long long ksb, long long kst, long long ksh, long long vsb, long long vst,
    long long vsh, float scale2, int causal) {
  constexpr int LDK = D + 8;    // K tile row pitch (elements)
  constexpr int LDV = BKV + 8;  // transposed V tile row pitch (elements)
  constexpr int ND = D / 8;     // n8 tiles across D
  constexpr int NK = BKV / 8;   // n8 tiles across a key tile
  constexpr int HALF = D / 2;
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * LDK];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * LDV];
  __shared__ int kvalid[BKV];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (h / hkv);
  const __nv_bfloat16* qb = q + b * qsb + hq * qsh;
  const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh;
  const int* mb = mask + static_cast<long long>(b) * tk;
  // RoPE tables of this batch row (self-attention: one table for q and k)
  const float* cb = cos_t ? cos_t + static_cast<long long>(b) * tq * HALF : nullptr;
  const float* sb = sin_t ? sin_t + static_cast<long long>(b) * tq * HALF : nullptr;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two query rows

  // Q as mma row operand, read once from device memory (rows past tq are 0)
  uint32_t qf[D / 16][4];
  {
    const float* c0 = cb && r0 < tq ? cb + r0 * HALF : nullptr;
    const float* s0 = cb && r0 < tq ? sb + r0 * HALF : nullptr;
    const float* c1 = cb && r1 < tq ? cb + r1 * HALF : nullptr;
    const float* s1 = cb && r1 < tq ? sb + r1 * HALF : nullptr;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + t * 2;
      qf[kk][0] = r0 < tq ? load_pair(qb + r0 * qst, c, c0, s0, HALF) : 0u;
      qf[kk][1] = r1 < tq ? load_pair(qb + r1 * qst, c, c1, s1, HALF) : 0u;
      qf[kk][2] = r0 < tq ? load_pair(qb + r0 * qst, c + 8, c0, s0, HALF) : 0u;
      qf[kk][3] = r1 < tq ? load_pair(qb + r1 * qst, c + 8, c1, s1, HALF) : 0u;
    }
  }

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {kNeg, kNeg};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  int nkt = (tk + BKV - 1) / BKV;
  if (causal) nkt = min(nkt, (q0 + BQ + BKV - 1) / BKV);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the previous tile is fully consumed
    for (int c = tid; c < BKV * D / 8; c += kThreads) {
      const int r = c / (D / 8), col = (c % (D / 8)) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (k0 + r < tk) {
        const int key = k0 + r;
        kv4 = load_chunk8(kb + key * kst, col, cb ? cb + key * HALF : nullptr,
                          sb ? sb + key * HALF : nullptr, HALF);
        vv4 = *reinterpret_cast<const uint4*>(vb + key * vst + col);
      }
      *reinterpret_cast<uint4*>(Ks + r * LDK + col) = kv4;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(col + i) * LDV + r] = ve[i];
    }
    if (tid < BKV) kvalid[tid] = (k0 + tid < tk) && mb[k0 + tid] != 0;
    __syncthreads();

    // s = q k^T for this thread's rows and keys j*8 + 2t + {0, 1}
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const __nv_bfloat16* kp = Ks + (j * 8 + g) * LDK + kk * 16 + t * 2;
        const uint32_t bf[2] = {ld32(kp), ld32(kp + 8)};
        mma_bf16(s[j], qf[kk], bf);
      }
    }

    // mask, scale into the log2 domain, online-softmax update
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + t * 2 + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool ok = kvalid[key] && (!causal || k0 + key <= row);
        const float val = ok ? s[j][e] * scale2 : kNeg;
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float corr[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_run[e >> 1]);
        s[j][e] = p;
        lsum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + lsum[r];
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // o += p v: the score accumulators of key tiles (2kk, 2kk+1) are exactly
    // the row-operand fragment of one k16 step
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const __nv_bfloat16* vp = Vt + (j * 8 + g) * LDV + kk * 16 + t * 2;
        const uint32_t bf[2] = {ld32(vp), ld32(vp + 8)};
        mma_bf16(o[j], pa, bf);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? r0 : r1;
    if (row >= tq) continue;
    const float l_safe = fmaxf(l_run[r], 1e-30f);
    // a row that saw no valid key keeps the sentinel max: its output is 0
    const float live = m_run[r] > 0.5f * kNeg ? 1.f : 0.f;
    const float inv = live / l_safe;
    const long long orow = (static_cast<long long>(b) * tq + row) * h + hq;
    __nv_bfloat16* op = out + orow * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<uint32_t*>(op + j * 8 + t * 2) =
          pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    }
    if (t == 0) lse[orow] = m_run[r] + log2f(l_safe);
  }
}

}  // namespace

extern "C" int slam_flash_fwd(const void* q, const void* k, const void* v, const void* mask,
                              void* out, void* lse, const void* cos_t, const void* sin_t, int b,
                              int tq, int tk, int h, int hkv, int d, long long qsb, long long qst,
                              long long qsh, long long ksb, long long kst, long long ksh,
                              long long vsb, long long vst, long long vsh, float scale, int causal,
                              void* stream) {
  if ((cos_t != nullptr || sin_t != nullptr) && tq != tk) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((tq + BQ - 1) / BQ, h, b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* mp = static_cast<const int*>(mask);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* lp = static_cast<float*>(lse);
  const auto* cp = static_cast<const float*>(cos_t);
  const auto* sp = static_cast<const float*>(sin_t);
  const float scale2 = scale * slam::kLog2e;
  if (d == 64) {
    flash_fwd_kernel<64><<<grid, kThreads, 0, st>>>(qp, kp, vp, mp, op, lp, cp, sp, tq, tk, h, hkv,
                                                    qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh,
                                                    scale2, causal);
  } else if (d == 128) {
    flash_fwd_kernel<128><<<grid, kThreads, 0, st>>>(qp, kp, vp, mp, op, lp, cp, sp, tq, tk, h, hkv,
                                                     qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh,
                                                     scale2, causal);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
