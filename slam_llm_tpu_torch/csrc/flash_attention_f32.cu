// K1's f32 route: flash-attention forward over f32 q / k / v, f32-accurate
// products on the tensor cores (3-pass split TF32), online softmax and
// accumulation in f32.
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
// valid key written as exactly 0. Fused RoPE (cos / sin (B, T, D/2), Tq ==
// Tk): a pass rotates q and k into the caller's f32 scratch first
// (flash_common.cuh: rope_kernel, apply_rope_tables' f32 numerics), then the
// products run on the rotated copies.
//
// Bound on the H100: the operations. At Spatial-AST's (16, 515, 12/12, 64)
// a call is 13.0 GFLOP against 101 MB of q / k / v / out: 0.079 ms at the
// 165 TFLOP/s of 3xTF32 (a third of TF32's dense 495), 0.19 ms at the
// 67 TFLOP/s of f32 FMA, 0.03 ms at 3.35 TB/s. Single-pass TF32 keeps about
// three digits, which the f32 route exists to avoid (the JAX route forces
// Precision.HIGHEST for the same reason); flash_f32.cuh has the split, the
// tiles and the fragment permutation.
//
// The design: one block per (ROWS query rows, query head, batch row),
// causal blocks longest first. Warpgroup NC is the producer: it streams key
// tiles through a ring of 2 stages under mbarriers, K stored K-major and V
// transposed (Vt[d][key], keys permuted within 8), each split into hi / lo,
// with the tile's key-validity bits from a ballot over the int32 mask. Its
// loads and its split and stores are the kernel's critical path (on the
// card, dropping either saved more time than dropping a whole product), so
// the next tile's rows load into registers as soon as this tile is out,
// overlapping the wait for a free stage, and the split rounds with two
// integer operations. Consumer warpgroups 0 .. NC - 1
// own 64 rows each and stage their own Q rows (scaled, split, K-major)
// while the producer starts: S = Q K^T (3 x D / 8 TF32 wgmma from shared
// memory), the mask, the online softmax in registers (exp2f, as the f32
// twin), P split into hi / lo A fragments straight from the accumulator,
// and the tile's P V (3 x BN / 8 wgmma with P from registers) into fresh
// registers, added to the running output with f32 FMAs as it is rescaled.
// setmaxnreg gives the producer 152 registers and the consumers 176 (the
// block's 3 x 168): a producer held to fewer spills its tile registers,
// which cost more on the card than the consumers gain.
// D = 64: NC = 2 (128 rows), 64-key tiles; D = 128: NC = 1, 32-key tiles.
// Shared memory: Q hi + lo 64 KB, 2 stages of K + Vt hi + lo 64 KB: 193 KB.
//
// D = 192 / 256 take a CUDA-core kernel instead (namespace fma, PR 12's
// design for D 64 / 128): a 64-row Q tile's hi / lo alone would fill 96 /
// 128 KB and the accumulator with its fresh tile 2 x D / 2 registers a
// thread, so the 3xTF32 layout does not fit. One block of 256 threads per
// (64 query rows, query head, batch row), causal blocks longest first:
// Q staged transposed and pre-scaled (Qt[d][row], rows padded to 68
// floats), keys in tiles of 32 (K rows padded to D + 1 floats, V), thread
// (ty, tx) owns rows 4 ty .. 4 ty + 3 and keys tx, tx + 16 of the score
// tile and output columns tx + 16 c; f32 FMA throughout. Bound: the 67
// TFLOP/s of f32 FMA. Shared memory 108 / 141 KB.

#include "flash_f32.cuh"

namespace {

using slam::fence_async_shared;
using slam::fence_regs;
using slam::kNeg;
using slam::mbar_arrive;
using slam::mbar_init;
using slam::mbar_wait;
using slam::smem_u32;
using slam::wgmma_commit;
using slam::wgmma_fence;
using slam::wgmma_wait;
namespace f32 = slam::f32;

template <int D>
struct Fwd {
  static constexpr int NC = D == 64 ? 2 : 1;  // consumer warpgroups
  static constexpr int ROWS = 64 * NC;        // query rows of a block
  static constexpr int BN = D == 64 ? 64 : 32;  // keys of a tile
  static constexpr int S = 2;                 // ring stages
  static constexpr int W = BN / 32;           // key-bit words of a tile
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int q_tile = ROWS * D * 4;
  static constexpr int kv_tile = BN * D * 4;
  // byte offsets after aligning to 1024: Q hi, Q lo, then per stage K hi,
  // K lo, Vt hi, Vt lo
  static constexpr int stage0 = 2 * q_tile;
  static constexpr int bits = stage0 + S * 4 * kv_tile;
  static constexpr int bars = bits + S * W * 4;
  static constexpr int total = bars + 2 * S * 8 + 1024;
  static constexpr int PER = BN * D / 4 / 128;  // float4 of K (and of V) a producer thread loads per tile
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
__global__ void __launch_bounds__(Fwd<D>::THREADS, 1) flash_fwd_f32_kernel(const Params p) {
  using L = Fwd<D>;
  constexpr int NC = L::NC, ROWS = L::ROWS, BN = L::BN, S = L::S, W = L::W;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_hi = smem;
  uint8_t* q_lo = smem + L::q_tile;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + L::bits);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + S;

  const int n_qt = (p.tq + ROWS - 1) / ROWS;
  const int q0 = (p.causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x)) * ROWS;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (p.h / p.hkv);
  int nkt = (p.tk + BN - 1) / BN;
  if (p.causal) nkt = min(nkt, (min(q0 + ROWS, p.tq) + BN - 1) / BN);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 4 * NC);  // lane 0 of each consumer warp
    }
    slam::mbar_init_fence();
  }
  __syncthreads();

  if (wg == NC) {  // the producer warpgroup
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 152;\n");
    const int pt = threadIdx.x - 128 * NC, lane = pt & 31, warp = pt >> 5;
    const float* kb = p.k + b * p.ksb + kvh * p.ksh;
    const float* vb = p.v + b * p.vsb + kvh * p.vsh;
    const int* mb = p.mask + static_cast<long long>(b) * p.tk;
    // a tile's K and V rows load into registers once the last tile is
    // out, so the loads overlap the wait for a free stage
    float4 kr[L::PER], vr[L::PER];
    int mv[W];
    f32::load_tile<BN, D>(kr, kb, p.kst, p.tk, pt);
    f32::load_tile<BN, D>(vr, vb, p.vst, p.tk, pt);
    if (warp == 0) slam::load_key_mask(mv, mb, 0, p.tk, lane);
    for (int kt = 0; kt < nkt; ++kt) {
      const int k1 = (kt + 1) * BN, stage = kt % S;
      const bool more = kt + 1 < nkt;
      mbar_wait(&empty[stage], ((kt / S) & 1) ^ 1);
      uint8_t* st = smem + L::stage0 + stage * 4 * L::kv_tile;
      f32::store_tile_rows<BN>(st, st + L::kv_tile, kr, pt);
      f32::store_tile_cols<BN, D>(st + 2 * L::kv_tile, st + 3 * L::kv_tile, vr, pt);
      if (warp == 0) slam::tile_key_bits(bits + stage * W, mv, lane);
      fence_async_shared();
      mbar_arrive(&full[stage]);
      if (more) {
        f32::load_tile<BN, D>(kr, kb + k1 * p.kst, p.kst, p.tk - k1, pt);
        f32::load_tile<BN, D>(vr, vb + k1 * p.vst, p.vst, p.tk - k1, pt);
        if (warp == 0) slam::load_key_mask(mv, mb, k1, p.tk, lane);
      }
    }
  } else {
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 176;\n");
    const int t = threadIdx.x & 127, lane = t & 31, warp = t >> 5, tq4 = lane & 3;
    {  // the warpgroup stages its own 64 Q rows, pre-scaled into the exp2 domain
      const float* qb = p.q + b * p.qsb + head * p.qsh + (q0 + 64 * wg) * p.qst;
      float4 v[D / 8];
      f32::load_tile<64, D>(v, qb, p.qst, p.tq - q0 - 64 * wg, t);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) v[i].x *= p.scale2, v[i].y *= p.scale2, v[i].z *= p.scale2, v[i].w *= p.scale2;
      f32::store_tile_rows<64>(q_hi, q_lo, v, t, 0, ROWS, 64 * wg);
      fence_async_shared();
      slam::named_sync(1 + wg, 128);
    }
    int pos[2];  // the thread's two query rows
#pragma unroll
    for (int h = 0; h < 2; ++h) pos[h] = q0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * h;
    const int wg_pos0 = q0 + 64 * wg;  // the warpgroup's first query row

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_run[2] = {kNeg, kNeg};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * BN, stage = kt % S;
      mbar_wait(&full[stage], (kt / S) & 1);
      const uint8_t* st = smem + L::stage0 + stage * 4 * L::kv_tile;
      float s[BN / 2];
      wgmma_fence();
      f32::mma3_ss<BN, D / 8>(s, q_hi, q_lo, ROWS, 64 * wg, st, st + L::kv_tile, false);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // mask the tiles with padding (by the key bits) and past the
      // warpgroup's first row (causal)
      uint32_t w[W];
      bool full_tile = true;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        w[i] = bits[stage * W + i];
        full_tile = full_tile && w[i] == 0xffffffffu;
      }
      if (!full_tile) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int key = 8 * (i >> 2) + 2 * tq4 + (i & 1);
          if (!((w[key >> 5] >> (key & 31)) & 1u)) s[i] = kNeg;
        }
      }
      if (p.causal && k0 + BN - 1 > wg_pos0) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          if (k0 + 8 * (i >> 2) + 2 * tq4 + (i & 1) > pos[(i >> 1) & 1]) s[i] = kNeg;
      }
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float corr[2], lsum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2f(m_run[h] - mx[h]);
        m_run[h] = mx[h];
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int h = (i >> 1) & 1;
        s[i] = s[i] > 0.5f * kNeg ? exp2f(s[i] - m_run[h]) : 0.f;
        lsum[h] += s[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + lsum[h];

      // this tile's P V into fresh registers
      uint32_t p_hi[BN / 8][4], p_lo[BN / 8][4];
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) f32::a_fragment(p_hi[kk], p_lo[kk], s, kk);
      float ot[D / 2];
      f32::mma3_rs_sync<D, BN / 8>(ot, p_hi, p_lo, st + 2 * L::kv_tile, st + 3 * L::kv_tile);
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        fence_regs(p_hi[kk]);
        fence_regs(p_lo[kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = fmaf(o[i], corr[(i >> 1) & 1], ot[i]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
      if (pos[h] >= p.tq) continue;
      // a row that saw no valid key keeps the sentinel max: its output is 0
      const float inv = m_run[h] > 0.5f * kNeg ? 1.f / l_run[h] : 0.f;
      const long long row = (static_cast<long long>(b) * p.tq + pos[h]) * p.h + head;
      float* orow = p.out + row * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * tq4) = make_float2(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      if (tq4 == 0) p.lse[row] = m_run[h] + log2f(fmaxf(l_run[h], 1e-30f));
    }
  }
}

namespace fma {

constexpr int kBq = 64;        // query rows of a block
constexpr int kBk = 32;        // keys of a tile
constexpr int kKJ = kBk / 16;  // key columns a thread owns
constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kRowPad = kBq + 4;

template <int D>
struct Layout {  // float offsets
  static constexpr int kKs = D + 1;  // K row length in shared memory
  static constexpr int kQt = 0;
  static constexpr int kK = kQt + D * kRowPad;
  static constexpr int kV = kK + kBk * kKs;
  static constexpr int kPt = kV + kBk * D;
  static constexpr int kBytes = (kPt + kBk * kRowPad) * 4;
  static_assert(kBytes <= 232448, "the FMA forward's shared memory passes the H100's 227 KB");
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_fma_kernel(const Params p) {
  using L = Layout<D>;
  constexpr int kCols = D / 16;  // output columns a thread owns
  extern __shared__ __align__(16) float fsm[];
  float* qt = fsm + L::kQt;
  float* ks = fsm + L::kK;
  float* vs = fsm + L::kV;
  float* pt = fsm + L::kPt;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_qt = (p.tq + kBq - 1) / kBq;
  const int q0 = (p.causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x)) * kBq;
  const int head = blockIdx.y, b = blockIdx.z;
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
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBk;
    __syncthreads();  // the previous tile's K, V and P are no longer read (and Q is staged)
    for (int i = tid; i < kBk * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const bool in = k0 + c < p.tk;
      ks[c * L::kKs + d] = in ? kb[(k0 + c) * p.kst + d] : 0.0f;
      vs[c * D + d] = in ? vb[(k0 + c) * p.vst + d] : 0.0f;
    }
    __syncthreads();

    float s[4][kKJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kKJ; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + d * kRowPad + ty * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      float kv[kKJ];
#pragma unroll
      for (int j = 0; j < kKJ; ++j) kv[j] = ks[(tx + 16 * j) * L::kKs + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kKJ; ++j) s[i][j] = fmaf(qa[i], kv[j], s[i][j]);
    }

    bool key_ok[kKJ];
#pragma unroll
    for (int j = 0; j < kKJ; ++j) {
      const int c = k0 + tx + 16 * j;
      key_ok[j] = c < p.tk && mb[c] != 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kKJ; ++j) {
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
      for (int j = 0; j < kKJ; ++j) {
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
    for (int j = 0; j < kKJ; ++j)
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
    // a row that saw no valid key keeps the sentinel max: its output is 0
    const float inv = m[i] > 0.5f * kNeg ? 1.0f / l[i] : 0.0f;
    const long long row = (static_cast<long long>(b) * p.tq + r) * p.h + head;
    float* o = p.out + row * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[tx + 16 * c] = acc[i][c] * inv;
    if (tx == 0) p.lse[row] = m[i] + log2f(fmaxf(l[i], 1e-30f));
  }
}

template <int D>
cudaError_t launch(const Params& p, int b, cudaStream_t st) {
  constexpr int bytes = Layout<D>::kBytes;
  static unsigned long long configured = 0;
  cudaError_t err = slam::configure_smem(flash_fwd_f32_fma_kernel<D>, bytes, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.tq + kBq - 1) / kBq, p.h, b);
  flash_fwd_f32_fma_kernel<D><<<grid, kThreads, bytes, st>>>(p);
  return cudaGetLastError();
}

}  // namespace fma

// q and k rotated into q_rot / k_rot (contiguous), p pointed at them
cudaError_t rotate_qk(Params& p, int b, int d, const float* cos_t, const float* sin_t, float* q_rot, float* k_rot,
                      cudaStream_t st) {
  cudaError_t err = slam::launch_rope(p.q, q_rot, cos_t, sin_t, b, p.tq, p.h, d, p.qsb, p.qst, p.qsh, st);
  if (err != cudaSuccess) return err;
  err = slam::launch_rope(p.k, k_rot, cos_t, sin_t, b, p.tk, p.hkv, d, p.ksb, p.kst, p.ksh, st);
  if (err != cudaSuccess) return err;
  p.q = q_rot;
  p.qsb = static_cast<long long>(p.tq) * p.h * d, p.qst = static_cast<long long>(p.h) * d, p.qsh = d;
  p.k = k_rot;
  p.ksb = static_cast<long long>(p.tk) * p.hkv * d, p.kst = static_cast<long long>(p.hkv) * d, p.ksh = d;
  return cudaSuccess;
}

template <int D>
cudaError_t launch(const Params& p, int b, cudaStream_t st) {
  using L = Fwd<D>;
  static unsigned long long configured = 0;
  cudaError_t err = slam::configure_smem(flash_fwd_f32_kernel<D>, L::total, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.tq + L::ROWS - 1) / L::ROWS, p.h, b);
  flash_fwd_f32_kernel<D><<<grid, L::THREADS, L::total, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q (B, Tq, H, D), k / v (B, Tk, Hkv, D) f32 with the given element strides
// (last dim contiguous, rows 16-byte aligned); mask (B, Tk) int32; out
// (B, Tq, H, D) and lse (B, Tq, H) f32, contiguous; cos / sin (B, T, D/2)
// f32 or null, and then q_rot / k_rot, (B, T, H | Hkv, D) f32 scratch (Tq ==
// Tk). D in {64, 128} runs 3xTF32 on the tensor cores, {192, 256} f32 FMA.
extern "C" int slam_flash_fwd_f32(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
                                  const void* cos_t, const void* sin_t, void* q_rot, void* k_rot, int b, int tq,
                                  int tk, int h, int hkv, int d, long long qsb, long long qst, long long qsh,
                                  long long ksb, long long kst, long long ksh, long long vsb, long long vst,
                                  long long vsh, float scale, int causal, void* stream) {
  const bool rope = cos_t != nullptr;
  if (b < 1 || b > 65535 || tq < 1 || tk < 1 || hkv < 1 || h % hkv != 0 || h > 65535 ||
      (d != 64 && d != 128 && d != 192 && d != 256) || (causal && tq != tk) ||
      (rope && (sin_t == nullptr || q_rot == nullptr || k_rot == nullptr || tq != tk)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
           static_cast<const int*>(mask), static_cast<float*>(out), static_cast<float*>(lse), tq, tk, h, hkv,
           qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, scale * slam::kLog2e, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* cs = static_cast<const float*>(cos_t);
  const auto* sn = static_cast<const float*>(sin_t);
  auto* qr = static_cast<float*>(q_rot);
  auto* kr = static_cast<float*>(k_rot);
  cudaError_t err = cudaSuccess;
  if (rope) {
    if ((err = rotate_qk(p, b, d, cs, sn, qr, kr, st)) != cudaSuccess) return static_cast<int>(err);
  }
  if (d == 64) err = launch<64>(p, b, st);
  if (d == 128) err = launch<128>(p, b, st);
  if (d == 192) err = fma::launch<192>(p, b, st);
  if (d == 256) err = fma::launch<256>(p, b, st);
  return static_cast<int>(err);
}
