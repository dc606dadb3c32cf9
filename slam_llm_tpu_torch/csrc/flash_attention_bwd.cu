// K4: flash-attention backward, bf16 in and out, f32 accumulation, GQA,
// optional fused RoPE.
//
// Replaces the Pallas backward of slam_llm_tpu/ops/kernels/flash_attention.py
// (_flash_bwd: _bwd_fused_wide_kernel, _bwd_dq_kernel, _bwd_dkv_kernel; the
// rule _bwd_rule). Given q, k, v, the key mask, the forward's out and log2
// lse (K1) and dout:
//   P = exp2(s * scale * log2e - lse) on valid (key, query) pairs, else 0
//   delta = rowsum(dout * out)
//   dV = P^T dout            dP = dout V^T         dS = P * (dP - delta)
//   dQ = scale * dS K        dK = scale * dS^T Q
// dk and dv sum over the G = H / Hkv query heads of a kv head. Invalid keys,
// causal-hidden pairs and dead query rows (no valid key: left padding under
// the causal mask) give P = 0, so dead rows get dq = 0 exactly and add
// nothing to dk / dv. With (cos, sin) tables the kernels read PRE-rotation
// q / k, rotate them as K1 does, and counter-rotate dq / dk with R^T before
// the store.
//
// Three launches, no atomics (every output element has one writer, so the
// result is deterministic):
//   1. delta: one warp per (b, t, h) row.
//   2. dk/dv: one block per (b, kv head, 64 keys); its four warps own 16
//      keys each, keep dK and dV in registers and loop over the G heads and
//      the query tiles from the causal diagonal on. Per tile: S^T = K Q^T and
//      dP^T = V dout^T (mma, A = K or V rows from shared memory), then
//      dV += P^T dout and dK += dS^T Q with the score accumulators reused as
//      the A fragments (as K1 does for p v); q and dout are staged in shared
//      memory both row-major and transposed, for the two B operand shapes.
//   3. dq: one block per (b, query head, 64 queries), the forward's shape:
//      Q and dout fragments in registers, key tiles up to the diagonal,
//      S = Q K^T, dP = dout V^T, dQ += dS K.
//
// Bound on the H100: the tensor cores (four products per tile in the dk/dv
// pass, three in the dq pass, plus the recomputed exp2). This first version
// uses mma.sync m16n8k16 without a load pipeline; shared memory per block is
// dynamic (56 KB at D = 64 for dk/dv).

#include "flash_common.cuh"

namespace {

using slam::ld32;
using slam::load_chunk8;
using slam::load_pair;
using slam::mma_bf16;
using slam::pack_bf16;

constexpr int BQ = 64;   // query rows per tile
constexpr int BKV = 64;  // keys per tile
constexpr int kThreads = 128;
constexpr int kDeltaWarps = 8;

// delta[row] = sum_d dout[row, d] * out[row, d], rows = B * T * H (contiguous)
__global__ void flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ out,
                                       const __nv_bfloat16* __restrict__ dout,
                                       float* __restrict__ delta, long long rows, int d) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kDeltaWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const __nv_bfloat16* o = out + row * d;
  const __nv_bfloat16* g = dout + row * d;
  float acc = 0.f;
  for (int c = lane * 2; c < d; c += 64) {
    acc += __bfloat162float(o[c]) * __bfloat162float(g[c]);
    acc += __bfloat162float(o[c + 1]) * __bfloat162float(g[c + 1]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// counter-rotate one accumulator fragment in place: acc[j] holds columns
// j*8 + 2t + {0, 1} of rows (e < 2 ? ra : rb); column c + half sits in
// acc[j + ND/2] of the same thread. d_pre = R^T d_post:
//   lower' = lower * cos + upper * sin,  upper' = upper * cos - lower * sin
template <int D>
__device__ __forceinline__ void rope_transpose(float (&acc)[D / 8][4], int t, const float* ca,
                                               const float* sa, const float* cb, const float* sb) {
  constexpr int ND = D / 8;
#pragma unroll
  for (int j = 0; j < ND / 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* cs = e < 2 ? ca : cb;
      const float* sn = e < 2 ? sa : sb;
      if (cs == nullptr) continue;
      const int c = j * 8 + t * 2 + (e & 1);
      const float lo = acc[j][e], hi = acc[j + ND / 2][e];
      acc[j][e] = lo * cs[c] + hi * sn[c];
      acc[j + ND / 2][e] = hi * cs[c] - lo * sn[c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int T, int h, int hkv, float scale2, float scale, int causal) {
  constexpr int LDK = D + 8;   // row-major tile pitch
  constexpr int LDT = BQ + 8;  // transposed tile pitch
  constexpr int ND = D / 8;
  constexpr int NQ = BQ / 8;
  constexpr int HALF = D / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [BKV][LDK]
  __nv_bfloat16* Vs = Ks + BKV * LDK;                          // [BKV][LDK]
  __nv_bfloat16* Qs = Vs + BKV * LDK;                          // [BQ][LDK]
  __nv_bfloat16* Gs = Qs + BQ * LDK;                           // [BQ][LDK] dout
  __nv_bfloat16* Qt = Gs + BQ * LDK;                           // [D][LDT]
  __nv_bfloat16* Gt = Qt + D * LDT;                            // [D][LDT]
  float* lse_s = reinterpret_cast<float*>(Gt + D * LDT);       // [BQ]
  float* delta_s = lse_s + BQ;                                 // [BQ]
  int* kvalid = reinterpret_cast<int*>(delta_s + BQ);          // [BKV]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int G = h / hkv;
  const long long bT = static_cast<long long>(b) * T;
  const float* cb = cos_t ? cos_t + bT * HALF : nullptr;
  const float* sb = sin_t ? sin_t + bT * HALF : nullptr;

  // this block's keys (rotated) and values, once
  for (int c = tid; c < BKV * D / 8; c += kThreads) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    const int key = k0 + r;
    uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
    if (key < T) {
      const long long off = ((bT + key) * hkv + hk) * D;
      kv4 = load_chunk8(k + off, col, cb ? cb + key * HALF : nullptr, sb ? sb + key * HALF : nullptr, HALF);
      vv4 = *reinterpret_cast<const uint4*>(v + off + col);
    }
    *reinterpret_cast<uint4*>(Ks + r * LDK + col) = kv4;
    *reinterpret_cast<uint4*>(Vs + r * LDK + col) = vv4;
  }
  if (tid < BKV) kvalid[tid] = (k0 + tid < T) && mask[bT + k0 + tid] != 0;

  const int kr0 = warp * 16 + g, kr1 = kr0 + 8;  // this thread's two keys, block-relative
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  const int nqt = (T + BQ - 1) / BQ;
  const int qt_lo = causal ? k0 / BQ : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int hq = hk * G + gi;
    for (int qt = qt_lo; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile is fully consumed (and K/V staged)
      for (int c = tid; c < BQ * D / 8; c += kThreads) {
        const int r = c / (D / 8), col = (c % (D / 8)) * 8;
        const int row = q0 + r;
        uint4 q4 = make_uint4(0, 0, 0, 0), g4 = make_uint4(0, 0, 0, 0);
        if (row < T) {
          const long long off = ((bT + row) * h + hq) * D;
          q4 = load_chunk8(q + off, col, cb ? cb + row * HALF : nullptr, sb ? sb + row * HALF : nullptr, HALF);
          g4 = *reinterpret_cast<const uint4*>(dout + off + col);
        }
        *reinterpret_cast<uint4*>(Qs + r * LDK + col) = q4;
        *reinterpret_cast<uint4*>(Gs + r * LDK + col) = g4;
        const __nv_bfloat16* qe = reinterpret_cast<const __nv_bfloat16*>(&q4);
        const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&g4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          Qt[(col + i) * LDT + r] = qe[i];
          Gt[(col + i) * LDT + r] = ge[i];
        }
      }
      if (tid < BQ) {
        const int row = q0 + tid;
        const long long li = (bT + row) * h + hq;
        lse_s[tid] = row < T ? lse[li] : 0.f;
        delta_s[tid] = row < T ? delta[li] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dout^T: 16 keys x 64 queries per warp
      float sT[NQ][4], dpT[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + t * 2;
        const uint32_t ka[4] = {ld32(Ks + kr0 * LDK + c), ld32(Ks + kr1 * LDK + c),
                                ld32(Ks + kr0 * LDK + c + 8), ld32(Ks + kr1 * LDK + c + 8)};
        const uint32_t va[4] = {ld32(Vs + kr0 * LDK + c), ld32(Vs + kr1 * LDK + c),
                                ld32(Vs + kr0 * LDK + c + 8), ld32(Vs + kr1 * LDK + c + 8)};
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const __nv_bfloat16* qp = Qs + (j * 8 + g) * LDK + c;
          const __nv_bfloat16* gp = Gs + (j * 8 + g) * LDK + c;
          const uint32_t qb2[2] = {ld32(qp), ld32(qp + 8)};
          const uint32_t gb2[2] = {ld32(gp), ld32(gp + 8)};
          mma_bf16(sT[j], ka, qb2);
          mma_bf16(dpT[j], va, gb2);
        }
      }

      // P^T (in sT) and dS^T (in dpT)
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + t * 2 + (e & 1);
          const int kr = e < 2 ? kr0 : kr1;
          const bool ok = kvalid[kr] && q0 + qi < T && (!causal || k0 + kr <= q0 + qi);
          const float p = ok ? exp2f(sT[j][e] * scale2 - lse_s[qi]) : 0.f;
          sT[j][e] = p;
          dpT[j][e] = p * (dpT[j][e] - delta_s[qi]);
        }
      }

      // dV += P^T dout and dK += dS^T Q, contracting over the 64 queries
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(sT[2 * kk][0], sT[2 * kk][1]), pack_bf16(sT[2 * kk][2], sT[2 * kk][3]),
            pack_bf16(sT[2 * kk + 1][0], sT[2 * kk + 1][1]),
            pack_bf16(sT[2 * kk + 1][2], sT[2 * kk + 1][3])};
        const uint32_t da[4] = {
            pack_bf16(dpT[2 * kk][0], dpT[2 * kk][1]), pack_bf16(dpT[2 * kk][2], dpT[2 * kk][3]),
            pack_bf16(dpT[2 * kk + 1][0], dpT[2 * kk + 1][1]),
            pack_bf16(dpT[2 * kk + 1][2], dpT[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const __nv_bfloat16* gp = Gt + (j * 8 + g) * LDT + kk * 16 + t * 2;
          const __nv_bfloat16* qp = Qt + (j * 8 + g) * LDT + kk * 16 + t * 2;
          const uint32_t gb2[2] = {ld32(gp), ld32(gp + 8)};
          const uint32_t qb2[2] = {ld32(qp), ld32(qp + 8)};
          mma_bf16(dv_acc[j], pa, gb2);
          mma_bf16(dk_acc[j], da, qb2);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] *= scale;
  const int key0 = k0 + kr0, key1 = k0 + kr1;
  if (cb != nullptr) {
    rope_transpose<D>(dk_acc, t, key0 < T ? cb + key0 * HALF : nullptr, key0 < T ? sb + key0 * HALF : nullptr,
                      key1 < T ? cb + key1 * HALF : nullptr, key1 < T ? sb + key1 * HALF : nullptr);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r == 0 ? key0 : key1;
    if (key >= T) continue;
    const long long off = ((bT + key) * hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = j * 8 + t * 2;
      *reinterpret_cast<uint32_t*>(dk + off + c) = pack_bf16(dk_acc[j][2 * r], dk_acc[j][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + c) = pack_bf16(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ dq, int T, int h, int hkv,
    float scale2, float scale, int causal) {
  constexpr int LDK = D + 8;
  constexpr int LDT = BKV + 8;
  constexpr int ND = D / 8;
  constexpr int NK = BKV / 8;
  constexpr int HALF = D / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [BKV][LDK]
  __nv_bfloat16* Vs = Ks + BKV * LDK;                          // [BKV][LDK]
  __nv_bfloat16* Kt = Vs + BKV * LDK;                          // [D][LDT]
  int* kvalid = reinterpret_cast<int*>(Kt + D * LDT);          // [BKV]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (h / hkv);
  const long long bT = static_cast<long long>(b) * T;
  const float* cb = cos_t ? cos_t + bT * HALF : nullptr;
  const float* sb = sin_t ? sin_t + bT * HALF : nullptr;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float* c0 = cb && r0 < T ? cb + r0 * HALF : nullptr;
  const float* s0 = cb && r0 < T ? sb + r0 * HALF : nullptr;
  const float* c1 = cb && r1 < T ? cb + r1 * HALF : nullptr;
  const float* s1 = cb && r1 < T ? sb + r1 * HALF : nullptr;

  const __nv_bfloat16* q_r0 = q + ((bT + r0) * h + hq) * D;
  const __nv_bfloat16* q_r1 = q + ((bT + r1) * h + hq) * D;
  const __nv_bfloat16* g_r0 = dout + ((bT + r0) * h + hq) * D;
  const __nv_bfloat16* g_r1 = dout + ((bT + r1) * h + hq) * D;
  uint32_t qf[D / 16][4], gf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    qf[kk][0] = r0 < T ? load_pair(q_r0, c, c0, s0, HALF) : 0u;
    qf[kk][1] = r1 < T ? load_pair(q_r1, c, c1, s1, HALF) : 0u;
    qf[kk][2] = r0 < T ? load_pair(q_r0, c + 8, c0, s0, HALF) : 0u;
    qf[kk][3] = r1 < T ? load_pair(q_r1, c + 8, c1, s1, HALF) : 0u;
    gf[kk][0] = r0 < T ? ld32(g_r0 + c) : 0u;
    gf[kk][1] = r1 < T ? ld32(g_r1 + c) : 0u;
    gf[kk][2] = r0 < T ? ld32(g_r0 + c + 8) : 0u;
    gf[kk][3] = r1 < T ? ld32(g_r1 + c + 8) : 0u;
  }
  const float lse_r[2] = {r0 < T ? lse[(bT + r0) * h + hq] : 0.f, r1 < T ? lse[(bT + r1) * h + hq] : 0.f};
  const float delta_r[2] = {r0 < T ? delta[(bT + r0) * h + hq] : 0.f,
                            r1 < T ? delta[(bT + r1) * h + hq] : 0.f};

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int nkt = (T + BKV - 1) / BKV;
  if (causal) nkt = min(nkt, (q0 + BQ + BKV - 1) / BKV);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();
    for (int c = tid; c < BKV * D / 8; c += kThreads) {
      const int r = c / (D / 8), col = (c % (D / 8)) * 8;
      const int key = k0 + r;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (key < T) {
        const long long off = ((bT + key) * hkv + hk) * D;
        kv4 = load_chunk8(k + off, col, cb ? cb + key * HALF : nullptr, sb ? sb + key * HALF : nullptr, HALF);
        vv4 = *reinterpret_cast<const uint4*>(v + off + col);
      }
      *reinterpret_cast<uint4*>(Ks + r * LDK + col) = kv4;
      *reinterpret_cast<uint4*>(Vs + r * LDK + col) = vv4;
      const __nv_bfloat16* ke = reinterpret_cast<const __nv_bfloat16*>(&kv4);
#pragma unroll
      for (int i = 0; i < 8; ++i) Kt[(col + i) * LDT + r] = ke[i];
    }
    if (tid < BKV) kvalid[tid] = (k0 + tid < T) && mask[bT + k0 + tid] != 0;
    __syncthreads();

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const __nv_bfloat16* kp = Ks + (j * 8 + g) * LDK + kk * 16 + t * 2;
        const __nv_bfloat16* vp = Vs + (j * 8 + g) * LDK + kk * 16 + t * 2;
        const uint32_t kb2[2] = {ld32(kp), ld32(kp + 8)};
        const uint32_t vb2[2] = {ld32(vp), ld32(vp + 8)};
        mma_bf16(s[j], qf[kk], kb2);
        mma_bf16(dp[j], gf[kk], vb2);
      }
    }
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + t * 2 + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool ok = kvalid[key] && row < T && (!causal || k0 + key <= row);
        const float p = ok ? exp2f(s[j][e] * scale2 - lse_r[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[e >> 1]);  // dS
      }
    }
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t da[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const __nv_bfloat16* kp = Kt + (j * 8 + g) * LDT + kk * 16 + t * 2;
        const uint32_t kb2[2] = {ld32(kp), ld32(kp + 8)};
        mma_bf16(acc[j], da, kb2);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= scale;
  if (cb != nullptr) rope_transpose<D>(acc, t, c0, s0, c1, s1);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? r0 : r1;
    if (row >= T) continue;
    __nv_bfloat16* op = dq + ((bT + row) * h + hq) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(op + j * 8 + t * 2) = pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

template <int D>
int launch_bwd(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
               const int* mask, const __nv_bfloat16* out, const __nv_bfloat16* dout,
               const float* lse, const float* cos_t, const float* sin_t, float* delta,
               __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, int b, int T, int h, int hkv,
               float scale, int causal, cudaStream_t st) {
  const float scale2 = scale * slam::kLog2e;
  const long long rows = static_cast<long long>(b) * T * h;
  flash_bwd_delta_kernel<<<static_cast<unsigned>((rows + kDeltaWarps - 1) / kDeltaWarps), 32 * kDeltaWarps, 0,
                           st>>>(out, dout, delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // above 48 KB dynamic shared memory needs an opt-in, set once per kernel
  // (outside any later stream capture)
  static bool configured = false;
  const size_t smem_dkv = (4 * 64 * (D + 8) + 2 * D * (BQ + 8)) * sizeof(__nv_bfloat16) +
                          2 * BQ * sizeof(float) + BKV * sizeof(int);
  const size_t smem_dq = (2 * BKV * (D + 8) + D * (BKV + 8)) * sizeof(__nv_bfloat16) + BKV * sizeof(int);
  if (!configured) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_dkv));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem_dq));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  flash_bwd_dkv_kernel<D><<<dim3((T + BKV - 1) / BKV, hkv, b), kThreads, smem_dkv, st>>>(
      q, k, v, mask, dout, lse, delta, cos_t, sin_t, dk, dv, T, h, hkv, scale2, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  flash_bwd_dq_kernel<D><<<dim3((T + BQ - 1) / BQ, h, b), kThreads, smem_dq, st>>>(
      q, k, v, mask, dout, lse, delta, cos_t, sin_t, dq, T, h, hkv, scale2, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors contiguous: q / out / dout / dq (B, T, H, D) bf16, k / v / dk /
// dv (B, T, Hkv, D) bf16, mask (B, T) int32, lse / delta (B, T, H) f32,
// cos / sin (B, T, D/2) f32 or null. delta is scratch the caller allocates.
extern "C" int slam_flash_bwd(const void* q, const void* k, const void* v, const void* mask,
                              const void* out, const void* dout, const void* lse, const void* cos_t,
                              const void* sin_t, void* delta, void* dq, void* dk, void* dv, int b,
                              int T, int h, int hkv, int d, float scale, int causal, void* stream) {
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* mp = static_cast<const int*>(mask);
  const auto* op = static_cast<const __nv_bfloat16*>(out);
  const auto* gp = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* cp = static_cast<const float*>(cos_t);
  const auto* sp = static_cast<const float*>(sin_t);
  auto* dp = static_cast<float*>(delta);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64)
    return launch_bwd<64>(qp, kp, vp, mp, op, gp, lp, cp, sp, dp, dqp, dkp, dvp, b, T, h, hkv, scale, causal, st);
  if (d == 128)
    return launch_bwd<128>(qp, kp, vp, mp, op, gp, lp, cp, sp, dp, dqp, dkp, dvp, b, T, h, hkv, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
