// K1's f32 route: flash-attention forward over f32 q / k / v, exact f32
// scores, online softmax and accumulation, on the CUDA cores.
//
// Replaces the f32 operands of the Pallas forward in
// slam_llm_tpu/ops/kernels/flash_attention.py (_flash_fwd with f32 inputs:
// Precision.HIGHEST products and the f32 exp2 chain, _dot_precision and the
// exp_dtype branches of _fwd_wide_kernel / _fwd_kernel). The conventions are
// the bf16 kernel's (csrc/flash_attention.cu): scores in the exp2 domain
// (q scaled by scale * log2 e as it is staged), key padding from an int32
// mask, GQA (query head h reads kv head h / (H / Hkv)), causal start-aligned
// (key j visible to query i iff j <= i; the caller asks for it only when
// Tq == Tk), lse (B, Tq, H) as log2-sum-exp2, and query rows that see no
// valid key written as exactly 0. Fused RoPE is not taken here: the wrapper
// raises for it.
//
// Bound on the H100: the operations. At SpatialAST's (16, 515, 12/12, 64)
// a layer is 13.0 GFLOP against 101 MB of q / k / v / out, 0.19 ms at the
// 67 TFLOP/s of f32 FMA and 0.03 ms at 3.35 TB/s. Single-pass TF32 on the
// tensor cores keeps about three digits, which the f32 route exists to
// avoid (the JAX route forces Precision.HIGHEST for the same reason), so
// the products run as f32 FMA.
//
// The design, simple first: one block of 256 threads per (64-query tile,
// query head, batch row). The block stages its Q tile once, transposed and
// pre-scaled (Qt[d][row], rows padded to 68 floats so a thread reads its 4
// rows as one 16-byte load), then walks the keys in tiles of 64: K row-major
// with rows padded to D + 1 floats (the 16 threads of a row group read 16
// consecutive key rows without bank conflicts), V row-major. Thread (ty, tx)
// owns query rows 4 ty .. 4 ty + 3 and key columns tx + 16 j (j < 4) of the
// 64 x 64 score tile; a row's max and sum reduce over the 16 lanes of its
// half-warp with shuffles. P goes to shared memory transposed (Pt[key][row])
// and O += P V leaves thread (ty, tx) the output columns tx + 16 j of its
// four rows. Causal blocks stop at their last row's tile; keys past Tk are
// masked like padding. Shared memory: 68 KB at D = 64, 114 KB at D = 128.

#include <cuda_runtime.h>

namespace {

constexpr int kBq = 64;        // query rows of a block
constexpr int kBk = 64;        // keys of a tile
constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kRowPad = kBq + 4;
constexpr float kNeg = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int kKs = D + 1;  // K row length in shared memory
  static constexpr int kQt = 0;
  static constexpr int kK = kQt + D * kRowPad;
  static constexpr int kV = kK + kBk * kKs;
  static constexpr int kPt = kV + kBk * D;
  static constexpr int kFloats = kPt + kBk * kRowPad;
  static constexpr int kBytes = kFloats * 4;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* mask;
  float* out;
  float* lse;
  int tq, tk, h, hkv;
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh;
  float scale2;  // scale * log2(e)
  int causal;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(const Params p) {
  using L = Layout<D>;
  constexpr int kCols = D / 16;  // output columns a thread owns
  extern __shared__ __align__(16) float smem[];
  float* qt = smem + L::kQt;
  float* ks = smem + L::kK;
  float* vs = smem + L::kV;
  float* pt = smem + L::kPt;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBq, head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (p.h / p.hkv);
  const float* qb = p.q + b * p.qsb + head * p.qsh;
  const float* kb = p.k + b * p.ksb + kvh * p.ksh;
  const float* vb = p.v + b * p.vsb + kvh * p.vsh;
  const int* mb = p.mask + static_cast<long long>(b) * p.tk;

  for (int i = tid; i < kBq * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qt[d * kRowPad + r] = q0 + r < p.tq ? qb[(q0 + r) * p.qst + d] * p.scale2 : 0.0f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int row0 = q0 + ty * 4;  // the thread's first query row
  int n_tiles = (p.tk + kBk - 1) / kBk;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + kBq, p.tq) + kBk - 1) / kBk);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBk;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < kBk * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const bool in = k0 + c < p.tk;
      ks[c * L::kKs + d] = in ? kb[(k0 + c) * p.kst + d] : 0.0f;
      vs[c * D + d] = in ? vb[(k0 + c) * p.vst + d] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + d * kRowPad + ty * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * L::kKs + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kv[j], s[i][j]);
    }

    bool key_ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + tx + 16 * j;
      key_ok[j] = c < p.tk && mb[c] != 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = key_ok[j] && (!p.causal || k0 + tx + 16 * j <= row0 + i);
        s[i][j] = ok ? s[i][j] : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] > 0.5f * kNeg ? exp2f(s[i][j] - m_new) : 0.0f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx + 16 * j) * kRowPad + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBk; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + c * kRowPad + ty * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const float vv = vs[c * D + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pa[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + i;
    if (r >= p.tq) continue;
    const bool live = l[i] > 0.0f;
    const float inv = live ? 1.0f / l[i] : 0.0f;
    float* o = p.out + ((static_cast<long long>(b) * p.tq + r) * p.h + head) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[tx + 16 * c] = acc[i][c] * inv;
    if (tx == 0) p.lse[(static_cast<long long>(b) * p.tq + r) * p.h + head] = m[i] + log2f(fmaxf(l[i], 1e-30f));
  }
}

template <int D>
cudaError_t launch(const Params& p, int b, cudaStream_t st) {
  const int bytes = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.tq + kBq - 1) / kBq, p.h, b);
  flash_fwd_f32_kernel<D><<<grid, kThreads, bytes, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q (B, Tq, H, D), k / v (B, Tk, Hkv, D) f32 with the given element strides
// (last dim contiguous); mask (B, Tk) int32; out (B, Tq, H, D) and lse
// (B, Tq, H) f32, contiguous.
extern "C" int slam_flash_fwd_f32(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
                                  int b, int tq, int tk, int h, int hkv, int d, long long qsb, long long qst,
                                  long long qsh, long long ksb, long long kst, long long ksh, long long vsb,
                                  long long vst, long long vsh, float scale, int causal, void* stream) {
  if (b < 1 || b > 65535 || tq < 1 || tk < 1 || hkv < 1 || h % hkv != 0 || h > 65535 || (d != 64 && d != 128) ||
      (causal && tq != tk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                 static_cast<const int*>(mask), static_cast<float*>(out), static_cast<float*>(lse), tq, tk, h, hkv,
                 qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, scale * kLog2e, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(d == 64 ? launch<64>(p, b, st) : launch<128>(p, b, st));
}
