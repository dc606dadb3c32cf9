// K4's f32 route: flash-attention backward over f32 q / k / v / out / dout,
// exact f32 scores, probabilities, dS and products, on the CUDA cores.
//
// Replaces the f32 operands of the Pallas backward in
// slam_llm_tpu/ops/kernels/flash_attention.py (_flash_bwd with f32 inputs:
// Precision.HIGHEST products and the f32 exp / dS chain, _dot_precision and
// the exp_dtype branches of _bwd_fused_wide_kernel / _bwd_dq_kernel /
// _bwd_dkv_kernel). It computes what that backward computes, with nothing
// rounded below f32:
//
//   P     = exp2(q k^T * scale * log2 e - lse)   (lse: K1 f32's log2 value)
//   delta = rowsum(dout o out)                  (from the saved output)
//   dS    = P o (dout v^T - delta)
//   dq    = dS k * scale,  dk = dS^T q * scale,  dv = P^T dout.
//
// The conventions are K1 f32's (csrc/flash_attention_f32.cu): key padding
// from an int32 mask, GQA (query head h reads kv head h / (H / Hkv); dk and
// dv sum over the G query heads of their kv head inside the kernel), causal
// start-aligned (self-attention only: Tq == Tk), D in {64, 128}, and query
// rows that see no valid key give P = 0 and so dq = 0. Fused RoPE is not
// taken here: the wrapper raises for it.
//
// Bound on the H100: the operations. At Spatial-AST's (16, 515, 12/12, 64)
// a call is five products of 2 B H T^2 D = 6.52 GFLOP, 32.6 GFLOP against
// 202 MB of q / k / v / out / dout / dq / dk / dv: 0.49 ms at the 67 TFLOP/s
// of f32 FMA, 0.06 ms at 3.35 TB/s. Single-pass TF32 on the tensor cores
// keeps about three digits, which the f32 route exists to avoid, so the
// products run as f32 FMA.
//
// The design, simple first, deterministic (no atomics; every sum has one
// owner and a fixed order), two launches on the caller's stream:
//
// 1. dq: one block of 256 threads per (64-query tile, query head, batch
//    row). It stages Q and dout transposed (Qt[d][row], rows padded to 68
//    floats so a thread reads its 4 rows as one 16-byte load), takes delta of
//    its rows from out and dout (one warp per 8 rows) and writes it to the
//    delta scratch for pass 2, then walks the key tiles: K and V row-major
//    with rows padded to D + 1 floats (16 lanes read 16 key rows without bank
//    conflicts). Thread (ty, tx) owns query rows 4 ty .. 4 ty + 3 and key
//    columns tx + 16 j of S and dP (one loop over d computes both), then
//    writes dS transposed (dSt[key][row]) and accumulates dq's columns
//    tx + 16 c of its rows from dS K.
// 2. dk / dv: one block per (64-key tile, kv head, batch row), run after
//    pass 1 (delta). It stages K and V transposed once, then walks the G
//    query heads and their query tiles (causal: from the tile of its first
//    key): Q and dout row-major padded to D + 1, lse and delta of the tile.
//    Thread (ty, tx) owns keys 4 ty .. 4 ty + 3 and queries tx + 16 j of
//    S^T and dP^T, writes P and dS as [query][key] rows and accumulates dv
//    from P^T dout and dk from dS^T q, columns tx + 16 c of its keys.
//
// Shared memory: dq 84 KB at D = 64, 150 KB at D = 128; dk / dv 101 KB and
// 167 KB.

#include <cuda_runtime.h>

namespace {

constexpr int kB = 64;         // query rows of a dq block, keys of a dk / dv block, and the tile of the walk
constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kRowPad = kB + 4;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct DqLayout {
  static constexpr int kKs = D + 1;
  static constexpr int kQt = 0;
  static constexpr int kDOt = kQt + D * kRowPad;
  static constexpr int kK = kDOt + D * kRowPad;
  static constexpr int kV = kK + kB * kKs;
  static constexpr int kDSt = kV + kB * kKs;
  static constexpr int kLse = kDSt + kB * kRowPad;
  static constexpr int kDelta = kLse + kB;
  static constexpr int kBytes = (kDelta + kB) * 4;
};

template <int D>
struct DkvLayout {
  static constexpr int kQs = D + 1;
  static constexpr int kKt = 0;
  static constexpr int kVt = kKt + D * kRowPad;
  static constexpr int kQ = kVt + D * kRowPad;
  static constexpr int kDO = kQ + kB * kQs;
  static constexpr int kP = kDO + kB * kQs;
  static constexpr int kDS = kP + kB * kRowPad;
  static constexpr int kLse = kDS + kB * kRowPad;
  static constexpr int kDelta = kLse + kB;
  static constexpr int kBytes = (kDelta + kB) * 4;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* mask;
  const float* out;
  const float* dout;
  const float* lse;  // (B, T, H)
  float* delta;      // (B, H, T) scratch: written by pass 1, read by pass 2
  float* dq;         // (B, T, H, D)
  float* dk;         // (B, T, Hkv, D)
  float* dv;
  int t, h, hkv;
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh, gsb, gst, gsh;
  float scale;
  float scale2;  // scale * log2(e)
  int causal;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_f32_dq_kernel(const Params p) {
  using L = DqLayout<D>;
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem + L::kQt;
  float* dot = smem + L::kDOt;
  float* ks = smem + L::kK;
  float* vs = smem + L::kV;
  float* dst = smem + L::kDSt;
  float* lse_s = smem + L::kLse;
  float* dlt_s = smem + L::kDelta;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kB, head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (p.h / p.hkv);
  const float* qb = p.q + b * p.qsb + head * p.qsh;
  const float* gb = p.dout + b * p.gsb + head * p.gsh;
  const float* ob = p.out + b * p.osb + head * p.osh;
  const float* kb = p.k + b * p.ksb + kvh * p.ksh;
  const float* vb = p.v + b * p.vsb + kvh * p.vsh;
  const int* mb = p.mask + static_cast<long long>(b) * p.t;

  for (int i = tid; i < kB * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const bool in = q0 + r < p.t;
    qt[d * kRowPad + r] = in ? qb[(q0 + r) * p.qst + d] : 0.0f;
    dot[d * kRowPad + r] = in ? gb[(q0 + r) * p.gst + d] : 0.0f;
  }
  // delta = rowsum(dout o out): warp w owns rows 8 w .. 8 w + 7
  for (int rr = 0; rr < kB / 8; ++rr) {
    const int r = warp * (kB / 8) + rr;
    float sum = 0.0f;
    if (q0 + r < p.t)
      for (int d = lane; d < D; d += 32) sum = fmaf(gb[(q0 + r) * p.gst + d], ob[(q0 + r) * p.ost + d], sum);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      dlt_s[r] = sum;
      if (q0 + r < p.t) p.delta[(static_cast<long long>(b) * p.h + head) * p.t + q0 + r] = sum;
    }
  }
  if (tid < kB) lse_s[tid] = q0 + tid < p.t ? p.lse[(static_cast<long long>(b) * p.t + q0 + tid) * p.h + head] : 0.0f;
  __syncthreads();

  const int row0 = q0 + ty * 4;  // the thread's first query row
  float lse_r[4], dlt_r[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = lse_s[ty * 4 + i];
    dlt_r[i] = dlt_s[ty * 4 + i];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  int n_tiles = (p.t + kB - 1) / kB;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + kB, p.t) + kB - 1) / kB);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kB;
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    for (int i = tid; i < kB * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const bool in = k0 + c < p.t;
      ks[c * L::kKs + d] = in ? kb[(k0 + c) * p.kst + d] : 0.0f;
      vs[c * L::kKs + d] = in ? vb[(k0 + c) * p.vst + d] : 0.0f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + d * kRowPad + ty * 4);
      const float4 gv = *reinterpret_cast<const float4*>(dot + d * kRowPad + ty * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
      float kv[4], vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * L::kKs + d];
        vv[j] = vs[(tx + 16 * j) * L::kKs + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ga[i], vv[j], dp[i][j]);
        }
    }

    bool key_ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + tx + 16 * j;
      key_ok[j] = c < p.t && mb[c] != 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + i;
        const bool ok = key_ok[j] && r < p.t && (!p.causal || k0 + tx + 16 * j <= r);
        const float pij = ok ? exp2f(s[i][j] * p.scale2 - lse_r[i]) : 0.0f;
        ds[i] = pij * (dp[i][j] - dlt_r[i]);
      }
      *reinterpret_cast<float4*>(dst + (tx + 16 * j) * kRowPad + ty * 4) = make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      const float4 sv = *reinterpret_cast<const float4*>(dst + c * kRowPad + ty * 4);
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const float kv = ks[c * L::kKs + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(sa[i], kv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + i;
    if (r >= p.t) continue;
    float* o = p.dq + ((static_cast<long long>(b) * p.t + r) * p.h + head) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[tx + 16 * c] = acc[i][c] * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_f32_dkv_kernel(const Params p) {
  using L = DkvLayout<D>;
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem + L::kKt;
  float* vt = smem + L::kVt;
  float* qs = smem + L::kQ;
  float* gs = smem + L::kDO;
  float* ps = smem + L::kP;
  float* dss = smem + L::kDS;
  float* lse_s = smem + L::kLse;
  float* dlt_s = smem + L::kDelta;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kB, kvh = blockIdx.y, b = blockIdx.z;
  const int g = p.h / p.hkv;
  const float* kb = p.k + b * p.ksb + kvh * p.ksh;
  const float* vb = p.v + b * p.vsb + kvh * p.vsh;
  const int* mb = p.mask + static_cast<long long>(b) * p.t;

  for (int i = tid; i < kB * D; i += kThreads) {
    const int c = i / D, d = i % D;
    const bool in = k0 + c < p.t;
    kt[d * kRowPad + c] = in ? kb[(k0 + c) * p.kst + d] : 0.0f;
    vt[d * kRowPad + c] = in ? vb[(k0 + c) * p.vst + d] : 0.0f;
  }
  const int key0 = k0 + ty * 4;  // the thread's first key
  bool key_ok[4];
  float dk[4][kCols], dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    key_ok[i] = key0 + i < p.t && mb[key0 + i] != 0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.0f;
  }

  const int n_qt = (p.t + kB - 1) / kB;
  const int first_qt = p.causal ? k0 / kB : 0;  // causal: no query before the block's first key sees it
  for (int hh = 0; hh < g; ++hh) {
    const int head = kvh * g + hh;
    const float* qb = p.q + b * p.qsb + head * p.qsh;
    const float* gb = p.dout + b * p.gsb + head * p.gsh;
    for (int qtile = first_qt; qtile < n_qt; ++qtile) {
      const int q0 = qtile * kB;
      __syncthreads();  // the previous tile's Q, dout, P and dS are no longer read (and K / V are staged)
      for (int i = tid; i < kB * D; i += kThreads) {
        const int r = i / D, d = i % D;
        const bool in = q0 + r < p.t;
        qs[r * L::kQs + d] = in ? qb[(q0 + r) * p.qst + d] : 0.0f;
        gs[r * L::kQs + d] = in ? gb[(q0 + r) * p.gst + d] : 0.0f;
      }
      if (tid < kB) {
        const bool in = q0 + tid < p.t;
        lse_s[tid] = in ? p.lse[(static_cast<long long>(b) * p.t + q0 + tid) * p.h + head] : 0.0f;
        dlt_s[tid] = in ? p.delta[(static_cast<long long>(b) * p.h + head) * p.t + q0 + tid] : 0.0f;
      }
      __syncthreads();

      // S^T and dP^T: keys 4 ty + i, queries tx + 16 j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 kv4 = *reinterpret_cast<const float4*>(kt + d * kRowPad + ty * 4);
        const float4 vv4 = *reinterpret_cast<const float4*>(vt + d * kRowPad + ty * 4);
        const float ka[4] = {kv4.x, kv4.y, kv4.z, kv4.w};
        const float va[4] = {vv4.x, vv4.y, vv4.z, vv4.w};
        float qv[4], gv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = qs[(tx + 16 * j) * L::kQs + d];
          gv[j] = gs[(tx + 16 * j) * L::kQs + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(ka[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(va[i], gv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cq = tx + 16 * j, r = q0 + cq;
        const float l = lse_s[cq], dl = dlt_s[cq];
        float pj[4], dsj[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = key_ok[i] && r < p.t && (!p.causal || key0 + i <= r);
          pj[i] = ok ? exp2f(s[i][j] * p.scale2 - l) : 0.0f;
          dsj[i] = pj[i] * (dp[i][j] - dl);
        }
        *reinterpret_cast<float4*>(ps + cq * kRowPad + ty * 4) = make_float4(pj[0], pj[1], pj[2], pj[3]);
        *reinterpret_cast<float4*>(dss + cq * kRowPad + ty * 4) = make_float4(dsj[0], dsj[1], dsj[2], dsj[3]);
      }
      __syncthreads();

      // dv += P^T dout, dk += dS^T q over the tile's queries
#pragma unroll 2
      for (int c = 0; c < kB; ++c) {
        const float4 pv = *reinterpret_cast<const float4*>(ps + c * kRowPad + ty * 4);
        const float4 sv = *reinterpret_cast<const float4*>(dss + c * kRowPad + ty * 4);
        const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
        const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          const float gq = gs[c * L::kQs + tx + 16 * cc];
          const float qq = qs[c * L::kQs + tx + 16 * cc];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][cc] = fmaf(pa[i], gq, dv[i][cc]);
            dk[i][cc] = fmaf(sa[i], qq, dk[i][cc]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = key0 + i;
    if (c >= p.t) continue;
    const long long at = ((static_cast<long long>(b) * p.t + c) * p.hkv + kvh) * D;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      p.dk[at + tx + 16 * cc] = dk[i][cc] * p.scale;
      p.dv[at + tx + 16 * cc] = dv[i][cc];
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, int b, cudaStream_t st) {
  const int dq_bytes = DqLayout<D>::kBytes, dkv_bytes = DkvLayout<D>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_f32_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_f32_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (p.t + kB - 1) / kB;
  flash_bwd_f32_dq_kernel<D><<<dim3(tiles, p.h, b), kThreads, dq_bytes, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_f32_dkv_kernel<D><<<dim3(tiles, p.hkv, b), kThreads, dkv_bytes, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q / dq / out / dout (B, T, H, D), k / v / dk / dv (B, T, Hkv, D) f32; q, k,
// v, out and dout with the given element strides (last dim contiguous), dq /
// dk / dv contiguous; mask (B, T) int32; lse (B, T, H) f32 contiguous; delta
// (B, H, T) f32 scratch.
extern "C" int slam_flash_bwd_f32(const void* q, const void* k, const void* v, const void* mask, const void* out,
                                  const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv, int b,
                                  int t, int h, int hkv, int d, long long qsb, long long qst, long long qsh,
                                  long long ksb, long long kst, long long ksh, long long vsb, long long vst,
                                  long long vsh, long long osb, long long ost, long long osh, long long gsb,
                                  long long gst, long long gsh, float scale, int causal, void* stream) {
  if (b < 1 || b > 65535 || t < 1 || hkv < 1 || h % hkv != 0 || h > 65535 || (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                 static_cast<const int*>(mask), static_cast<const float*>(out), static_cast<const float*>(dout),
                 static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<float*>(dq),
                 static_cast<float*>(dk), static_cast<float*>(dv), t, h, hkv, qsb, qst, qsh, ksb, kst, ksh, vsb, vst,
                 vsh, osb, ost, osh, gsb, gst, gsh, scale, scale * kLog2e, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(d == 64 ? launch<64>(p, b, st) : launch<128>(p, b, st));
}
