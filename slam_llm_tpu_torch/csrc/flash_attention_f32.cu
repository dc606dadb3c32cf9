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
// valid key written as exactly 0. Fused RoPE is not taken here: the wrapper
// raises for it.
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
// (B, Tq, H, D) and lse (B, Tq, H) f32, contiguous.
extern "C" int slam_flash_fwd_f32(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
                                  int b, int tq, int tk, int h, int hkv, int d, long long qsb, long long qst,
                                  long long qsh, long long ksb, long long kst, long long ksh, long long vsb,
                                  long long vst, long long vsh, float scale, int causal, void* stream) {
  if (b < 1 || b > 65535 || tq < 1 || tk < 1 || hkv < 1 || h % hkv != 0 || h > 65535 || (d != 64 && d != 128) ||
      (causal && tq != tk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                 static_cast<const int*>(mask), static_cast<float*>(out), static_cast<float*>(lse), tq, tk, h, hkv,
                 qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, scale * slam::kLog2e, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(d == 64 ? launch<64>(p, b, st) : launch<128>(p, b, st));
}
