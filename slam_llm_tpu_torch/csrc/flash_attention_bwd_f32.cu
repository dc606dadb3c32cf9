// K4's f32 route: flash-attention backward over f32 q / k / v / out / dout,
// f32-accurate products on the tensor cores (3-pass split TF32), f32
// probabilities and dS.
//
// Replaces the f32 operands of the Pallas backward in
// slam_llm_tpu/ops/kernels/flash_attention.py (_flash_bwd with f32 inputs:
// Precision.HIGHEST products and the f32 exp / dS chain, _dot_precision and
// the exp_dtype branches of _bwd_fused_wide_kernel / _bwd_dq_kernel /
// _bwd_dkv_kernel). It computes what that backward computes:
//
//   P     = exp2(q k^T * scale * log2 e - lse)   (lse: K1 f32's log2 value)
//   delta = rowsum(dout o out)                  (from the saved output)
//   dS    = P o (dout v^T - delta)
//   dq    = dS k * scale,  dk = dS^T q * scale,  dv = P^T dout.
//
// The conventions are K1 f32's (csrc/flash_attention_f32.cu): key padding
// from an int32 mask, GQA (query head h reads kv head h / (H / Hkv); dk and
// dv sum over the G query heads of their kv head inside the kernel), causal
// start-aligned (then Tq == Tk; without it any Tq, Tk: dq over the Tq
// queries, dk / dv over the Tk keys), and query rows that see no valid key
// give P = 0 and so dq = 0. Fused RoPE (cos / sin (B, T, D/2), Tq == Tk):
// q and k are rotated into the caller's f32 scratch first (K1 f32's pass),
// and dq / dk are counter-rotated with R^T in registers before the store.
//
// Bound on the H100: the operations. At Spatial-AST's (16, 515, 12/12, 64)
// a call is five products of 2 B H T^2 D = 6.52 GFLOP, 32.6 GFLOP against
// 202 MB of q / k / v / out / dout / dq / dk / dv: 0.198 ms at the
// 165 TFLOP/s of 3xTF32, 0.49 ms at the 67 TFLOP/s of f32 FMA, 0.06 ms at
// 3.35 TB/s. The products are K1 f32's: 3xTF32 wgmma on its tiles
// (flash_f32.cuh), each long sum taken a tile at a time into fresh
// registers and added in f32.
//
// Deterministic (no atomics; every sum has one owner and a fixed order),
// two launches on the caller's stream, each a producer warpgroup that
// loads, splits and stages the tiles through mbarriers ahead of the
// consumer warpgroups, as in K1 f32:
//
// 1. dq: one block per (ROWS query rows, query head, batch row). The
//    producer streams 32-key tiles: K K-major and transposed (Kt[d][key],
//    keys permuted within 8), V K-major, the next tile's rows loading while
//    this one waits for its stage. Consumer warpgroups of 64 rows stage
//    their own Q and dout (K-major), the rows' lse and delta (from out and
//    dout; delta also goes to the (B, H, T) scratch for pass 2), then: S =
//    Q K^T and dP = dout V^T by wgmma from shared memory, P and dS in
//    registers, dS split into A fragments, the tile's dS K (B = Kt) into
//    fresh registers added to dq. S and dP are computed here and again in
//    pass 2: removing that needs a reduction of dq across key blocks.
// 2. dk / dv: one block per (64 keys, kv head, batch row), after pass 1.
//    The consumer warpgroups stage K and V once (K-major: they are the A
//    operands); the producer walks the G query heads' query tiles (causal:
//    from the tile of the block's first key): Q and dout K-major and
//    transposed (Qt, dOt, queries permuted within 8), lse and delta, the
//    next tile loading while this one waits for its stage. The consumer
//    warpgroups take the tiles in turn, one stage each: S^T = K Q^T and
//    dP^T = V dout^T land in the accumulator layout, so P^T and dS^T feed
//    dv += P^T dout (B = dOt) and dk += dS^T q (B = Qt) as register A
//    fragments, each into fresh registers added in f32. At the end
//    warpgroup 1 hands its dk / dv to warpgroup 0 through shared memory,
//    which adds them in a fixed order.
// D = 64: two consumer warpgroups (dq: 128 rows, 2 stages of 32 keys; dk /
// dv: 32-query tiles) and setmaxnreg's 152 / 176 registers as K1 f32's;
// D = 128: one (64 rows, 1 stage; 16-query tiles). Tried on the card and
// slower than this: 64-key dq tiles in one stage, and two tiles in flight
// in the producers (both spill), and dk / dv accumulated in the tensor
// core across tiles (barely faster, and without the guard on long sums).
// Shared memory: dq 226 KB; dk / dv 194 KB (225 KB at D = 128).
//
// D = 192 / 256 take CUDA-core kernels instead (namespace fma, PR 13's
// design for D 64 / 128; the 3xTF32 tiles and accumulators do not fit, as
// in K1 f32), the same two launches: dq, one block of 256 threads per (64
// query rows, query head, batch row) over key tiles of 32 (Qt and dOt
// transposed, K and V rows padded to D + 1, dS^T); dk / dv, one block per
// (64 keys, kv head, batch row) over the G heads' query tiles of 32 (Kt and
// Vt transposed, Q and dout rows padded, P and dS). f32 FMA throughout,
// deterministic. Shared memory 159 / 209 KB (dq) and 167 / 218 KB.

#include "flash_f32.cuh"

namespace {

using slam::fence_async_shared;
using slam::fence_regs;
using slam::mbar_arrive;
using slam::mbar_init;
using slam::mbar_wait;
using slam::smem_u32;
using slam::wgmma_commit;
using slam::wgmma_fence;
using slam::wgmma_wait;
namespace f32 = slam::f32;

template <int D>
struct DqL {
  static constexpr int NC = D == 64 ? 2 : 1;
  static constexpr int ROWS = 64 * NC;
  static constexpr int BN = 32;
  static constexpr int S = D == 64 ? 2 : 1;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int q_tile = ROWS * D * 4;
  static constexpr int kv_tile = BN * D * 4;
  // after aligning to 1024: Q hi / lo, dout hi / lo, then per stage K hi /
  // lo, V hi / lo, Kt hi / lo
  static constexpr int stage0 = 4 * q_tile;
  static constexpr int lse = stage0 + S * 6 * kv_tile;
  static constexpr int delta = lse + ROWS * 4;
  static constexpr int bits = delta + ROWS * 4;
  static constexpr int bars = bits + 8 * S;
  static constexpr int total = bars + 2 * S * 8 + 1024;
  static constexpr int PER = BN * D / 4 / 128;
};

template <int D>
struct DkvL {
  static constexpr int NC = D == 64 ? 2 : 1;
  static constexpr int S = NC;  // one stage per consumer warpgroup: tile i goes to stage i % NC
  static constexpr int KEYS = 64;
  static constexpr int BQ = D == 64 ? 32 : 16;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int kv_tile = KEYS * D * 4;
  static constexpr int q_tile = BQ * D * 4;
  static constexpr int t_tile = D * (BQ < 32 ? 32 : BQ) * 4;  // Qt / dOt: whole 128-byte swizzle rows
  static constexpr int stage_bytes = 4 * q_tile + 4 * t_tile;
  // K hi / lo, V hi / lo, then per stage Q hi / lo, dout hi / lo, Qt hi /
  // lo, dOt hi / lo
  static constexpr int stage0 = 4 * kv_tile;
  static constexpr int lse = stage0 + S * stage_bytes;
  static constexpr int delta = lse + S * BQ * 4;
  static constexpr int bars = delta + S * BQ * 4;
  static constexpr int total = bars + 2 * S * 8 + 1024;
  static constexpr int PER_KV = KEYS * D / 4 / 128 / NC;  // a consumer thread's share of K (or V)
  static constexpr int PER_Q = BQ * D / 4 / 128;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* mask;
  const float* out;
  const float* dout;
  const float* lse;  // (B, Tq, H)
  float* delta;      // (B, H, Tq) scratch: written by pass 1, read by pass 2
  float* dq;         // (B, Tq, H, D)
  float* dk;         // (B, Tk, Hkv, D)
  float* dv;
  const float* cos_t;  // (B, T, D/2) or null: dq / dk counter-rotated
  const float* sin_t;
  int tq, tk, h, hkv;
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh, gsb, gst, gsh;
  float scale;
  float scale2;  // scale * log2(e)
  int causal;
};

template <int D>
__global__ void __launch_bounds__(DqL<D>::THREADS, 1) flash_bwd_f32_dq_kernel(const Params p) {
  using L = DqL<D>;
  constexpr int NC = L::NC, ROWS = L::ROWS, BN = L::BN, S = L::S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_hi = smem;
  uint8_t* q_lo = smem + L::q_tile;
  uint8_t* do_hi = smem + 2 * L::q_tile;
  uint8_t* do_lo = smem + 3 * L::q_tile;
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* dlt_s = reinterpret_cast<float*>(smem + L::delta);
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
      mbar_init(&empty[s], 4 * NC);
    }
    slam::mbar_init_fence();
  }
  __syncthreads();

  if (wg == NC) {
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 152;\n");
    const int pt = threadIdx.x - 128 * NC, lane = pt & 31, warp = pt >> 5;
    const float* kb = p.k + b * p.ksb + kvh * p.ksh;
    const float* vb = p.v + b * p.vsb + kvh * p.vsh;
    const int* mb = p.mask + static_cast<long long>(b) * p.tk;
    // the next tile's rows load once this tile is out (K1 f32's producer)
    float4 kr[L::PER], vr[L::PER];
    int mv[1];
    f32::load_tile<BN, D>(kr, kb, p.kst, p.tk, pt);
    f32::load_tile<BN, D>(vr, vb, p.vst, p.tk, pt);
    if (warp == 0) slam::load_key_mask(mv, mb, 0, p.tk, lane);
    for (int kt = 0; kt < nkt; ++kt) {
      const int k1 = (kt + 1) * BN, stage = kt % S;
      const bool more = kt + 1 < nkt;
      mbar_wait(&empty[stage], ((kt / S) & 1) ^ 1);
      uint8_t* st = smem + L::stage0 + stage * 6 * L::kv_tile;
      f32::store_tile_rows<BN>(st, st + L::kv_tile, kr, pt);
      f32::store_tile_rows<BN>(st + 2 * L::kv_tile, st + 3 * L::kv_tile, vr, pt);
      f32::store_tile_cols<BN, D>(st + 4 * L::kv_tile, st + 5 * L::kv_tile, kr, pt);
      if (warp == 0) slam::tile_key_bits(bits + stage, mv, lane);
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
    {  // the warpgroup stages its own 64 rows of Q and dout, their lse and delta
      const int r0 = q0 + 64 * wg;
      const float* qb = p.q + b * p.qsb + head * p.qsh + r0 * p.qst;
      const float* gb = p.dout + b * p.gsb + head * p.gsh + r0 * p.gst;
      for (int i0 = 0; i0 < D / 8; i0 += 8) {
        float4 qv[8], gv[8];
        f32::load_tile<64, D>(qv, qb, p.qst, p.tq - r0, t, i0);
        f32::load_tile<64, D>(gv, gb, p.gst, p.tq - r0, t, i0);
        f32::store_tile_rows<64>(q_hi, q_lo, qv, t, i0, ROWS, 64 * wg);
        f32::store_tile_rows<64>(do_hi, do_lo, gv, t, i0, ROWS, 64 * wg);
      }
      if (t < 64) {  // delta = rowsum(dout o out) and lse of row r0 + t
        float sum = 0.f, l = 0.f;
        if (r0 + t < p.tq) {
          const float4* g4 = reinterpret_cast<const float4*>(gb + t * p.gst);
          const float4* o4 = reinterpret_cast<const float4*>(p.out + b * p.osb + head * p.osh + (r0 + t) * p.ost);
#pragma unroll 4
          for (int c = 0; c < D / 4; ++c) {
            const float4 g = __ldg(g4 + c), o = __ldg(o4 + c);
            sum = fmaf(g.x, o.x, sum);
            sum = fmaf(g.y, o.y, sum);
            sum = fmaf(g.z, o.z, sum);
            sum = fmaf(g.w, o.w, sum);
          }
          l = p.lse[(static_cast<long long>(b) * p.tq + r0 + t) * p.h + head];
          p.delta[(static_cast<long long>(b) * p.h + head) * p.tq + r0 + t] = sum;
        }
        lse_s[64 * wg + t] = l;
        dlt_s[64 * wg + t] = sum;
      }
      fence_async_shared();
      slam::named_sync(1 + wg, 128);
    }
    int pos[2];
    float lse_r[2], dlt_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + 16 * warp + (lane >> 2) + 8 * h;
      pos[h] = q0 + r;
      lse_r[h] = lse_s[r];
      dlt_r[h] = dlt_s[r];
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * BN, stage = kt % S;
      mbar_wait(&full[stage], (kt / S) & 1);
      const uint8_t* st = smem + L::stage0 + stage * 6 * L::kv_tile;
      float s[BN / 2], dp[BN / 2];
      wgmma_fence();
      f32::mma3_ss<BN, D / 8>(s, q_hi, q_lo, ROWS, 64 * wg, st, st + L::kv_tile, false);
      f32::mma3_ss<BN, D / 8>(dp, do_hi, do_lo, ROWS, 64 * wg, st + 2 * L::kv_tile, st + 3 * L::kv_tile, false);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      const uint32_t w = bits[stage];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int h = (i >> 1) & 1, c = 8 * (i >> 2) + 2 * tq4 + (i & 1);
        const bool ok = ((w >> c) & 1u) && pos[h] < p.tq && (!p.causal || k0 + c <= pos[h]);
        const float pij = ok ? exp2f(s[i] * p.scale2 - lse_r[h]) : 0.f;
        s[i] = pij * (dp[i] - dlt_r[h]);  // dS
      }
      uint32_t a_hi[BN / 8][4], a_lo[BN / 8][4];
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) f32::a_fragment(a_hi[kk], a_lo[kk], s, kk);
      float fresh[D / 2];
      f32::mma3_rs_sync<D, BN / 8>(fresh, a_hi, a_lo, st + 4 * L::kv_tile, st + 5 * L::kv_tile);
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        fence_regs(a_hi[kk]);
        fence_regs(a_lo[kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] += fresh[i];
    }

    if (p.cos_t != nullptr) {
      const float* cs[2];
      const float* sn[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long tab = (static_cast<long long>(b) * p.tq + pos[h]) * (D / 2);
        cs[h] = pos[h] < p.tq ? p.cos_t + tab : nullptr;
        sn[h] = pos[h] < p.tq ? p.sin_t + tab : nullptr;
      }
      slam::rope_transpose<D>(dq, tq4, cs, sn);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (pos[h] >= p.tq) continue;
      float* row = p.dq + ((static_cast<long long>(b) * p.tq + pos[h]) * p.h + head) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(row + 8 * j + 2 * tq4) =
            make_float2(dq[4 * j + 2 * h] * p.scale, dq[4 * j + 2 * h + 1] * p.scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(DkvL<D>::THREADS, 1) flash_bwd_f32_dkv_kernel(const Params p) {
  using L = DkvL<D>;
  constexpr int NC = L::NC, S = L::S, KEYS = L::KEYS, BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_hi = smem;
  uint8_t* k_lo = smem + L::kv_tile;
  uint8_t* v_hi = smem + 2 * L::kv_tile;
  uint8_t* v_lo = smem + 3 * L::kv_tile;
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* dlt_s = reinterpret_cast<float*>(smem + L::delta);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + S;

  const int k0 = blockIdx.x * KEYS, kvh = blockIdx.y, b = blockIdx.z;
  const int g = p.h / p.hkv;
  const int n_qt = (p.tq + BQ - 1) / BQ;
  const int first_qt = p.causal ? k0 / BQ : 0;  // causal: no query before the block's first key sees it
  const int per = n_qt - first_qt, n_tiles = g * per;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 4);  // lane 0 of each warp of the stage's warpgroup
    }
    slam::mbar_init_fence();
  }
  __syncthreads();

  if (wg == NC) {
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 152;\n");
    const int pt = threadIdx.x - 128 * NC;
    // tile i's rows load once tile i - 1 is out (K1 f32's producer)
    float4 qr[L::PER_Q], gr[L::PER_Q];
    float l = 0.f, dl = 0.f;
    auto load = [&](int i) {
      const int head = kvh * g + i / per, q0 = (first_qt + i % per) * BQ;
      f32::load_tile<BQ, D>(qr, p.q + b * p.qsb + head * p.qsh + q0 * p.qst, p.qst, p.tq - q0, pt);
      f32::load_tile<BQ, D>(gr, p.dout + b * p.gsb + head * p.gsh + q0 * p.gst, p.gst, p.tq - q0, pt);
      const bool in = pt < BQ && q0 + pt < p.tq;
      l = in ? p.lse[(static_cast<long long>(b) * p.tq + q0 + pt) * p.h + head] : 0.f;
      dl = in ? p.delta[(static_cast<long long>(b) * p.h + head) * p.tq + q0 + pt] : 0.f;
    };
    load(0);
    for (int i = 0; i < n_tiles; ++i) {
      const int stage = i % NC;
      mbar_wait(&empty[stage], ((i / NC) & 1) ^ 1);
      uint8_t* st = smem + L::stage0 + stage * L::stage_bytes;
      uint8_t* tt = st + 4 * L::q_tile;
      if (pt < BQ) {
        lse_s[stage * BQ + pt] = l;
        dlt_s[stage * BQ + pt] = dl;
      }
      f32::store_tile_rows<BQ>(st, st + L::q_tile, qr, pt);
      f32::store_tile_rows<BQ>(st + 2 * L::q_tile, st + 3 * L::q_tile, gr, pt);
      f32::store_tile_cols<BQ, D>(tt, tt + L::t_tile, qr, pt);
      f32::store_tile_cols<BQ, D>(tt + 2 * L::t_tile, tt + 3 * L::t_tile, gr, pt);
      fence_async_shared();
      mbar_arrive(&full[stage]);
      if (i + 1 < n_tiles) load(i + 1);
    }
  } else {
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 176;\n");
    const int t = threadIdx.x & 127, lane = t & 31, warp = t >> 5, tq4 = lane & 3;
    {  // the consumer warpgroups stage the block's K and V rows (K-major: the A operands), a share each
      constexpr int N = L::PER_KV, CH = N < 8 ? N : 8, TH = 128 * NC;
      const int tt = t + 128 * wg;
      const float* kb = p.k + b * p.ksb + kvh * p.ksh + k0 * p.kst;
      const float* vb = p.v + b * p.vsb + kvh * p.vsh + k0 * p.vst;
      for (int i0 = 0; i0 < N; i0 += CH) {
        float4 kv[CH], vv[CH];
        f32::load_tile<KEYS, D, CH, TH>(kv, kb, p.kst, p.tk - k0, tt, i0);
        f32::load_tile<KEYS, D, CH, TH>(vv, vb, p.vst, p.tk - k0, tt, i0);
        f32::store_tile_rows<KEYS, CH, TH>(k_hi, k_lo, kv, tt, i0);
        f32::store_tile_rows<KEYS, CH, TH>(v_hi, v_lo, vv, tt, i0);
      }
      fence_async_shared();
      slam::named_sync(1, 128 * NC);
    }
    int key[2];
    bool key_ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      key[h] = k0 + 16 * warp + (lane >> 2) + 8 * h;
      key_ok[h] = key[h] < p.tk && p.mask[static_cast<long long>(b) * p.tk + key[h]] != 0;
    }
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    for (int i = wg; i < n_tiles; i += NC) {
      const int stage = wg, q0 = (first_qt + i % per) * BQ;
      mbar_wait(&full[stage], (i / NC) & 1);
      const uint8_t* st = smem + L::stage0 + stage * L::stage_bytes;
      const uint8_t* tt = st + 4 * L::q_tile;
      // S^T and dP^T: rows are the block's keys, columns the tile's queries
      float s[BQ / 2], dp[BQ / 2];
      wgmma_fence();
      f32::mma3_ss<BQ, D / 8>(s, k_hi, k_lo, KEYS, 0, st, st + L::q_tile, false);
      f32::mma3_ss<BQ, D / 8>(dp, v_hi, v_lo, KEYS, 0, st + 2 * L::q_tile, st + 3 * L::q_tile, false);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        const int h = (j >> 1) & 1, c = 8 * (j >> 2) + 2 * tq4 + (j & 1), qpos = q0 + c;
        const bool ok = key_ok[h] && qpos < p.tq && (!p.causal || key[h] <= qpos);
        const float pij = ok ? exp2f(s[j] * p.scale2 - lse_s[stage * BQ + c]) : 0.f;
        s[j] = pij;
        dp[j] = pij * (dp[j] - dlt_s[stage * BQ + c]);  // dS^T
      }
      uint32_t p_hi[BQ / 8][4], p_lo[BQ / 8][4], d_hi[BQ / 8][4], d_lo[BQ / 8][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 8; ++kk) {
        f32::a_fragment(p_hi[kk], p_lo[kk], s, kk);
        f32::a_fragment(d_hi[kk], d_lo[kk], dp, kk);
      }
      float fresh[D / 2];
      f32::mma3_rs_sync<D, BQ / 8>(fresh, p_hi, p_lo, tt + 2 * L::t_tile, tt + 3 * L::t_tile);
#pragma unroll
      for (int c = 0; c < D / 2; ++c) dv[c] += fresh[c];
      f32::mma3_rs_sync<D, BQ / 8>(fresh, d_hi, d_lo, tt, tt + L::t_tile);
#pragma unroll
      for (int kk = 0; kk < BQ / 8; ++kk) {
        fence_regs(p_hi[kk]);
        fence_regs(p_lo[kk]);
        fence_regs(d_hi[kk]);
        fence_regs(d_lo[kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
#pragma unroll
      for (int c = 0; c < D / 2; ++c) dk[c] += fresh[c];
    }

    if constexpr (NC == 2) {
      // warpgroup 1's sums reach warpgroup 0 through its own stage (its
      // last tile is consumed: the producer writes there no more)
      float* xfer = reinterpret_cast<float*>(smem + L::stage0 + L::stage_bytes);
      const int r0 = 16 * warp + (lane >> 2);
      if (wg == 1) {
#pragma unroll
        for (int c = 0; c < D / 2; ++c) {
          const int at = (r0 + 8 * ((c >> 1) & 1)) * D + 8 * (c >> 2) + 2 * tq4 + (c & 1);
          xfer[at] = dk[c];
          xfer[KEYS * D + at] = dv[c];
        }
      }
      slam::named_sync(1, 256);
      if (wg == 1) return;
#pragma unroll
      for (int c = 0; c < D / 2; ++c) {
        const int at = (r0 + 8 * ((c >> 1) & 1)) * D + 8 * (c >> 2) + 2 * tq4 + (c & 1);
        dk[c] += xfer[at];
        dv[c] += xfer[KEYS * D + at];
      }
    }
    if (p.cos_t != nullptr) {
      const float* cs[2];
      const float* sn[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long tab = (static_cast<long long>(b) * p.tk + key[h]) * (D / 2);
        cs[h] = key[h] < p.tk ? p.cos_t + tab : nullptr;
        sn[h] = key[h] < p.tk ? p.sin_t + tab : nullptr;
      }
      slam::rope_transpose<D>(dk, tq4, cs, sn);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (key[h] >= p.tk) continue;
      const long long at = ((static_cast<long long>(b) * p.tk + key[h]) * p.hkv + kvh) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(p.dk + at + 8 * j + 2 * tq4) =
            make_float2(dk[4 * j + 2 * h] * p.scale, dk[4 * j + 2 * h + 1] * p.scale);
        *reinterpret_cast<float2*>(p.dv + at + 8 * j + 2 * tq4) =
            make_float2(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
      }
    }
  }
}

namespace fma {

constexpr int kB = 64;         // query rows of a dq block, keys of a dk / dv block
constexpr int kT = 32;         // keys (dq) or queries (dk / dv) of a tile of the walk
constexpr int kJ = kT / 16;    // tile columns a thread owns
constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kRowPad = kB + 4;

template <int D>
struct DqLayout {  // float offsets
  static constexpr int kKs = D + 1;
  static constexpr int kQt = 0;
  static constexpr int kDOt = kQt + D * kRowPad;
  static constexpr int kK = kDOt + D * kRowPad;
  static constexpr int kV = kK + kT * kKs;
  static constexpr int kDSt = kV + kT * kKs;
  static constexpr int kLse = kDSt + kT * kRowPad;
  static constexpr int kDelta = kLse + kB;
  static constexpr int kBytes = (kDelta + kB) * 4;
  static_assert(kBytes <= 232448, "the FMA dq pass's shared memory passes the H100's 227 KB");
};

template <int D>
struct DkvLayout {  // float offsets
  static constexpr int kQs = D + 1;
  static constexpr int kKt = 0;
  static constexpr int kVt = kKt + D * kRowPad;
  static constexpr int kQ = kVt + D * kRowPad;
  static constexpr int kDO = kQ + kT * kQs;
  static constexpr int kP = kDO + kT * kQs;
  static constexpr int kDS = kP + kT * kRowPad;
  static constexpr int kLse = kDS + kT * kRowPad;
  static constexpr int kDelta = kLse + kT;
  static constexpr int kBytes = (kDelta + kT) * 4;
  static_assert(kBytes <= 232448, "the FMA dk / dv pass's shared memory passes the H100's 227 KB");
};

// R^T on a thread's columns tx + 16 c of one row (tab: the row's (D/2,)
// tables): column c < D/2 and its partner c + D/2 sit D/32 apart in acc
template <int D>
__device__ __forceinline__ void rope_transpose_cols(float (&acc)[D / 16], int tx, const float* cs, const float* sn) {
#pragma unroll
  for (int c = 0; c < D / 32; ++c) {
    const int col = tx + 16 * c;
    const float a = acc[c], b = acc[c + D / 32];
    acc[c] = a * cs[col] + b * sn[col];
    acc[c + D / 32] = b * cs[col] - a * sn[col];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_f32_fma_dq_kernel(const Params p) {
  using L = DqLayout<D>;
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) float fsm[];
  float* qt = fsm + L::kQt;
  float* dot = fsm + L::kDOt;
  float* ks = fsm + L::kK;
  float* vs = fsm + L::kV;
  float* dst = fsm + L::kDSt;
  float* lse_s = fsm + L::kLse;
  float* dlt_s = fsm + L::kDelta;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, lane = tid & 31, warp = tid >> 5;
  const int n_qt = (p.tq + kB - 1) / kB;
  const int q0 = (p.causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x)) * kB;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (p.h / p.hkv);
  const float* qb = p.q + b * p.qsb + head * p.qsh;
  const float* gb = p.dout + b * p.gsb + head * p.gsh;
  const float* ob = p.out + b * p.osb + head * p.osh;
  const float* kb = p.k + b * p.ksb + kvh * p.ksh;
  const float* vb = p.v + b * p.vsb + kvh * p.vsh;
  const int* mb = p.mask + static_cast<long long>(b) * p.tk;

  for (int i = tid; i < kB * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const bool in = q0 + r < p.tq;
    qt[d * kRowPad + r] = in ? qb[(q0 + r) * p.qst + d] : 0.0f;
    dot[d * kRowPad + r] = in ? gb[(q0 + r) * p.gst + d] : 0.0f;
  }
  // delta = rowsum(dout o out): warp w owns rows 8 w .. 8 w + 7
  for (int rr = 0; rr < kB / 8; ++rr) {
    const int r = warp * (kB / 8) + rr;
    float sum = 0.0f;
    if (q0 + r < p.tq)
      for (int d = lane; d < D; d += 32) sum = fmaf(gb[(q0 + r) * p.gst + d], ob[(q0 + r) * p.ost + d], sum);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      dlt_s[r] = sum;
      if (q0 + r < p.tq) p.delta[(static_cast<long long>(b) * p.h + head) * p.tq + q0 + r] = sum;
    }
  }
  if (tid < kB) lse_s[tid] = q0 + tid < p.tq ? p.lse[(static_cast<long long>(b) * p.tq + q0 + tid) * p.h + head] : 0.0f;
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

  int n_tiles = (p.tk + kT - 1) / kT;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + kB, p.tq) + kT - 1) / kT);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kT;
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    for (int i = tid; i < kT * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const bool in = k0 + c < p.tk;
      ks[c * L::kKs + d] = in ? kb[(k0 + c) * p.kst + d] : 0.0f;
      vs[c * L::kKs + d] = in ? vb[(k0 + c) * p.vst + d] : 0.0f;
    }
    __syncthreads();

    float s[4][kJ], dp[4][kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + d * kRowPad + ty * 4);
      const float4 gv = *reinterpret_cast<const float4*>(dot + d * kRowPad + ty * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
      float kv[kJ], vv[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        kv[j] = ks[(tx + 16 * j) * L::kKs + d];
        vv[j] = vs[(tx + 16 * j) * L::kKs + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          s[i][j] = fmaf(qa[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ga[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int c = k0 + tx + 16 * j;
      const bool key_ok = c < p.tk && mb[c] != 0;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + i;
        const bool ok = key_ok && r < p.tq && (!p.causal || c <= r);
        const float pij = ok ? exp2f(s[i][j] * p.scale2 - lse_r[i]) : 0.0f;
        ds[i] = pij * (dp[i][j] - dlt_r[i]);
      }
      *reinterpret_cast<float4*>(dst + (tx + 16 * j) * kRowPad + ty * 4) = make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kT; ++c) {
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
    if (r >= p.tq) continue;
    if (p.cos_t != nullptr) {
      const long long tab = (static_cast<long long>(b) * p.tq + r) * (D / 2);
      rope_transpose_cols<D>(acc[i], tx, p.cos_t + tab, p.sin_t + tab);
    }
    float* o = p.dq + ((static_cast<long long>(b) * p.tq + r) * p.h + head) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[tx + 16 * c] = acc[i][c] * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_f32_fma_dkv_kernel(const Params p) {
  using L = DkvLayout<D>;
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) float fsm[];
  float* kt = fsm + L::kKt;
  float* vt = fsm + L::kVt;
  float* qs = fsm + L::kQ;
  float* gs = fsm + L::kDO;
  float* ps = fsm + L::kP;
  float* dss = fsm + L::kDS;
  float* lse_s = fsm + L::kLse;
  float* dlt_s = fsm + L::kDelta;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kB, kvh = blockIdx.y, b = blockIdx.z;
  const int g = p.h / p.hkv;
  const float* kb = p.k + b * p.ksb + kvh * p.ksh;
  const float* vb = p.v + b * p.vsb + kvh * p.vsh;
  const int* mb = p.mask + static_cast<long long>(b) * p.tk;

  for (int i = tid; i < kB * D; i += kThreads) {
    const int c = i / D, d = i % D;
    const bool in = k0 + c < p.tk;
    kt[d * kRowPad + c] = in ? kb[(k0 + c) * p.kst + d] : 0.0f;
    vt[d * kRowPad + c] = in ? vb[(k0 + c) * p.vst + d] : 0.0f;
  }
  const int key0 = k0 + ty * 4;  // the thread's first key
  bool key_ok[4];
  float dk[4][kCols], dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    key_ok[i] = key0 + i < p.tk && mb[key0 + i] != 0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.0f;
  }

  const int n_qt = (p.tq + kT - 1) / kT;
  const int first_qt = p.causal ? k0 / kT : 0;  // causal: no query before the block's first key sees it
  for (int hh = 0; hh < g; ++hh) {
    const int head = kvh * g + hh;
    const float* qb = p.q + b * p.qsb + head * p.qsh;
    const float* gb = p.dout + b * p.gsb + head * p.gsh;
    for (int qtile = first_qt; qtile < n_qt; ++qtile) {
      const int q0 = qtile * kT;
      __syncthreads();  // the previous tile's Q, dout, P and dS are no longer read (and K / V are staged)
      for (int i = tid; i < kT * D; i += kThreads) {
        const int r = i / D, d = i % D;
        const bool in = q0 + r < p.tq;
        qs[r * L::kQs + d] = in ? qb[(q0 + r) * p.qst + d] : 0.0f;
        gs[r * L::kQs + d] = in ? gb[(q0 + r) * p.gst + d] : 0.0f;
      }
      if (tid < kT) {
        const bool in = q0 + tid < p.tq;
        lse_s[tid] = in ? p.lse[(static_cast<long long>(b) * p.tq + q0 + tid) * p.h + head] : 0.0f;
        dlt_s[tid] = in ? p.delta[(static_cast<long long>(b) * p.h + head) * p.tq + q0 + tid] : 0.0f;
      }
      __syncthreads();

      // S^T and dP^T: keys 4 ty + i, queries tx + 16 j
      float s[4][kJ], dp[4][kJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 kv4 = *reinterpret_cast<const float4*>(kt + d * kRowPad + ty * 4);
        const float4 vv4 = *reinterpret_cast<const float4*>(vt + d * kRowPad + ty * 4);
        const float ka[4] = {kv4.x, kv4.y, kv4.z, kv4.w};
        const float va[4] = {vv4.x, vv4.y, vv4.z, vv4.w};
        float qv[kJ], gv[kJ];
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          qv[j] = qs[(tx + 16 * j) * L::kQs + d];
          gv[j] = gs[(tx + 16 * j) * L::kQs + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            s[i][j] = fmaf(ka[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(va[i], gv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int cq = tx + 16 * j, r = q0 + cq;
        const float l = lse_s[cq], dl = dlt_s[cq];
        float pj[4], dsj[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = key_ok[i] && r < p.tq && (!p.causal || key0 + i <= r);
          pj[i] = ok ? exp2f(s[i][j] * p.scale2 - l) : 0.0f;
          dsj[i] = pj[i] * (dp[i][j] - dl);
        }
        *reinterpret_cast<float4*>(ps + cq * kRowPad + ty * 4) = make_float4(pj[0], pj[1], pj[2], pj[3]);
        *reinterpret_cast<float4*>(dss + cq * kRowPad + ty * 4) = make_float4(dsj[0], dsj[1], dsj[2], dsj[3]);
      }
      __syncthreads();

      // dv += P^T dout, dk += dS^T q over the tile's queries
#pragma unroll 2
      for (int c = 0; c < kT; ++c) {
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
    if (c >= p.tk) continue;
    if (p.cos_t != nullptr) {
      const long long tab = (static_cast<long long>(b) * p.tk + c) * (D / 2);
      rope_transpose_cols<D>(dk[i], tx, p.cos_t + tab, p.sin_t + tab);
    }
    const long long at = ((static_cast<long long>(b) * p.tk + c) * p.hkv + kvh) * D;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      p.dk[at + tx + 16 * cc] = dk[i][cc] * p.scale;
      p.dv[at + tx + 16 * cc] = dv[i][cc];
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, int b, cudaStream_t st) {
  constexpr int dq_bytes = DqLayout<D>::kBytes, dkv_bytes = DkvLayout<D>::kBytes;
  static unsigned long long dq_done = 0, dkv_done = 0;
  cudaError_t err = slam::configure_smem(flash_bwd_f32_fma_dq_kernel<D>, dq_bytes, dq_done);
  if (err != cudaSuccess) return err;
  err = slam::configure_smem(flash_bwd_f32_fma_dkv_kernel<D>, dkv_bytes, dkv_done);
  if (err != cudaSuccess) return err;
  flash_bwd_f32_fma_dq_kernel<D><<<dim3((p.tq + kB - 1) / kB, p.h, b), kThreads, dq_bytes, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_f32_fma_dkv_kernel<D><<<dim3((p.tk + kB - 1) / kB, p.hkv, b), kThreads, dkv_bytes, st>>>(p);
  return cudaGetLastError();
}

}  // namespace fma

// q and k rotated into q_rot / k_rot (contiguous), p pointed at them
cudaError_t rotate_qk(Params& p, int b, int d, float* q_rot, float* k_rot, cudaStream_t st) {
  cudaError_t err = slam::launch_rope(p.q, q_rot, p.cos_t, p.sin_t, b, p.tq, p.h, d, p.qsb, p.qst, p.qsh, st);
  if (err != cudaSuccess) return err;
  err = slam::launch_rope(p.k, k_rot, p.cos_t, p.sin_t, b, p.tk, p.hkv, d, p.ksb, p.kst, p.ksh, st);
  if (err != cudaSuccess) return err;
  p.q = q_rot;
  p.qsb = static_cast<long long>(p.tq) * p.h * d, p.qst = static_cast<long long>(p.h) * d, p.qsh = d;
  p.k = k_rot;
  p.ksb = static_cast<long long>(p.tk) * p.hkv * d, p.kst = static_cast<long long>(p.hkv) * d, p.ksh = d;
  return cudaSuccess;
}

template <int D>
cudaError_t launch(const Params& p, int b, cudaStream_t st) {
  static unsigned long long dq_done = 0, dkv_done = 0;
  cudaError_t err = slam::configure_smem(flash_bwd_f32_dq_kernel<D>, DqL<D>::total, dq_done);
  if (err != cudaSuccess) return err;
  err = slam::configure_smem(flash_bwd_f32_dkv_kernel<D>, DkvL<D>::total, dkv_done);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid((p.tq + DqL<D>::ROWS - 1) / DqL<D>::ROWS, p.h, b);
  flash_bwd_f32_dq_kernel<D><<<dq_grid, DqL<D>::THREADS, DqL<D>::total, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 dkv_grid((p.tk + DkvL<D>::KEYS - 1) / DkvL<D>::KEYS, p.hkv, b);
  flash_bwd_f32_dkv_kernel<D><<<dkv_grid, DkvL<D>::THREADS, DkvL<D>::total, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q / dq / out / dout (B, Tq, H, D), k / v / dk / dv (B, Tk, Hkv, D) f32; q,
// k, v, out and dout with the given element strides (last dim contiguous,
// rows 16-byte aligned), dq / dk / dv contiguous; mask (B, Tk) int32; lse
// (B, Tq, H) f32 contiguous; delta (B, H, Tq) f32 scratch; cos / sin (B, T,
// D/2) f32 or null, and then q_rot / k_rot, (B, T, H | Hkv, D) f32 scratch
// (Tq == Tk). Causal needs Tq == Tk. D in {64, 128} runs 3xTF32 on the
// tensor cores, {192, 256} f32 FMA.
extern "C" int slam_flash_bwd_f32(const void* q, const void* k, const void* v, const void* mask, const void* out,
                                  const void* dout, const void* lse, const void* cos_t, const void* sin_t,
                                  void* q_rot, void* k_rot, void* delta, void* dq, void* dk, void* dv, int b, int tq,
                                  int tk, int h, int hkv, int d, long long qsb, long long qst, long long qsh,
                                  long long ksb, long long kst, long long ksh, long long vsb, long long vst,
                                  long long vsh, long long osb, long long ost, long long osh, long long gsb,
                                  long long gst, long long gsh, float scale, int causal, void* stream) {
  const bool rope = cos_t != nullptr;
  if (b < 1 || b > 65535 || tq < 1 || tk < 1 || hkv < 1 || h % hkv != 0 || h > 65535 ||
      (d != 64 && d != 128 && d != 192 && d != 256) || ((causal || rope) && tq != tk) ||
      (rope && (sin_t == nullptr || q_rot == nullptr || k_rot == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
           static_cast<const int*>(mask), static_cast<const float*>(out), static_cast<const float*>(dout),
           static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<float*>(dq),
           static_cast<float*>(dk), static_cast<float*>(dv), static_cast<const float*>(cos_t),
           static_cast<const float*>(sin_t), tq, tk, h, hkv, qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost,
           osh, gsb, gst, gsh, scale, scale * slam::kLog2e, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* qr = static_cast<float*>(q_rot);
  auto* kr = static_cast<float*>(k_rot);
  cudaError_t err = cudaSuccess;
  if (rope) {
    if ((err = rotate_qk(p, b, d, qr, kr, st)) != cudaSuccess) return static_cast<int>(err);
  }
  if (d == 64) err = launch<64>(p, b, st);
  if (d == 128) err = launch<128>(p, b, st);
  if (d == 192) err = fma::launch<192>(p, b, st);
  if (d == 256) err = fma::launch<256>(p, b, st);
  return static_cast<int>(err);
}
