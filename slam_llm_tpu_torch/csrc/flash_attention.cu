// K1: flash-attention forward for Hopper: TMA-fed wgmma, bf16 in, f32
// online softmax, GQA, optional fused RoPE.
//
// Replaces the Pallas forward of slam_llm_tpu/ops/kernels/flash_attention.py
// (_flash_fwd: _fwd_wide_kernel and _fwd_kernel):
//   out = softmax(q k^T * scale + mask) v,  lse = log2-sum-exp2 of the scores
// with the same conventions: scores in the exp2 domain, key padding from an
// int32 mask, causal start-aligned (key j visible to query i iff j <= i, so
// the caller only asks for it when Tq == Tk), and all-masked query rows
// written as exactly 0 (their lse is meaningless, as in the TPU kernel).
// With (cos, sin) tables (B, T, D/2) f32 the kernel takes PRE-rotation q/k:
// k goes through a rotate pass into a scratch tensor the wrapper allocates
// (TMA copies raw bytes, so the rotation cannot ride the copy), and each
// block rotates its Q tile in shared memory once it lands (flash_common.cuh:
// f32 rotation, one bf16 rounding -- the numerics of apply_rope_tables).
//
// Bound on the H100: the tensor cores and the softmax's exp2 per score at
// the slices' shapes (T = 448..1500, D = 64); the (Tq, Tk) scores never
// reach device memory. The design:
// * One unit of work is (batch, a group of hb query heads of one kv head,
//   bt query positions), 128 rows = bt positions x hb heads (row = position
//   * hb + head), as the JAX kernel's native layout packs the G heads of a kv
//   head: each K / V tile is loaded once for all of them. hb is the planner's
//   (ops/kernels/flash_attention.py::plan_flash): G itself up to 128, so
//   16 positions x 8 heads at TinyLlama's G = 8, 128 positions at whisper's
//   G = 1.
// * A persistent grid (one block per SM) walks the units, causal ones
//   longest first. Warpgroup 2 is the producer: one warp loads each unit's Q
//   (a 5-D tensor map over (D, head, head group, T, B) with the model's
//   strides) and streams K and V tiles through a ring under mbarriers, all
//   with the 128-byte swizzle: tiles of 128 keys in 3 stages at D = 64
//   without the causal mask, else of 64 keys in 4 stages (3 at D = 128),
//   where less of the causal diagonal tile is wasted;
//   the same warp computes each key tile's validity bits (a ballot over the
//   int32 mask, a tile ahead). Warpgroups 0 and 1 own 64 rows each: S = Q K^T by wgmma
//   from shared memory (both K-major), the online softmax in registers, and
//   O += P V with P from registers and V read MN-major through the transpose
//   bit, so V is never stored transposed. setmaxnreg moves registers from
//   the producer (24) to the consumers (240). Each warpgroup runs its
//   products and its softmax in turn (ptxas waits for a wgmma that reads
//   registers before the next is issued); the other warpgroup's work fills
//   the tensor cores meanwhile. A tile's stage is released after the next
//   tile's Q K^T is issued (2-4 % faster on the card than releasing it at
//   once; K4's loops measured faster without this).
// * Masks by tile: a tile whose keys are all valid and all at or below the
//   warpgroup's first query position skips the per-element mask; only tiles
//   with padding and the causal diagonal take it. Causal units stop at the
//   diagonal; TMA's zero fill is the ragged edge of T.
// * Q is double-buffered: the next unit's Q loads while this unit runs.
//   The output leaves through shared memory, 16 bytes a thread.
// Shared memory per block: 2 x Q 16 KB + 3 x (K + V) 32 KB + 18 KB of
// staging = 147 KB at D = 64 (115 KB with 64-key tiles); 2 x 32 KB + 3 x
// 32 KB + 34 KB = 195 KB at D = 128 (plus barriers and the key bits).
// D = 192 / 256 keep one Q buffer (48 / 64 KB; the next unit's Q loads
// once this unit's last tile has read it), 3 / 2 stages of 64-key K + V
// tiles (48 / 64 KB each) and write the output from registers: 192 KB. A
// warpgroup's P V runs as 128- and 64-column wgmma (wgmma_rs).

#include "flash_common.cuh"

namespace {

using slam::fence_async_shared;
using slam::fence_regs;
using slam::kmajor_step;
using slam::kNeg;
using slam::kPanelBytes;
using slam::mbar_arrive;
using slam::mbar_expect_tx;
using slam::mbar_init;
using slam::mbar_wait;
using slam::mnmajor_step;
using slam::p_fragment;
using slam::pack_bf16;
using slam::smem_u32;
using slam::wgmma_commit;
using slam::wgmma_fence;
using slam::wgmma_wait;

constexpr int kRows = 128;     // query rows per unit: two consumer warpgroups of 64
constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, then the producer warpgroup

// byte offsets in the block's shared memory (after aligning it to 1024);
// BN, keys per tile: 128 at D = 64 without the causal mask, else 64 (less of
// the causal diagonal is wasted, and D >= 128 fits). D = 192 / 256 (a Q
// tile of 48 / 64 KB) keep one Q buffer and write the output from
// registers: two buffers and the staging rows would pass the 227 KB.
template <int D, int BN>
struct FwdSmem {
  static constexpr bool WIDE = D > 128;
  static constexpr int S = BN == 128 ? 3 : (D == 64 ? 4 : (D == 256 ? 2 : 3));  // ring stages
  static constexpr int QB = WIDE ? 1 : 2;  // Q buffers: with two, the next unit's loads while this one runs
  static constexpr int words = BN / 32;
  static constexpr int kv_tile = BN * D * 2;
  static constexpr int q_tile = kRows * D * 2;
  static constexpr int pitch = D * 2 + 16;  // staging row: 16 bytes of pad keep the fragment writes conflict-free
  static constexpr int q = 0;
  static constexpr int k = QB * q_tile;
  static constexpr int v = k + S * kv_tile;
  static constexpr int stage = v + S * kv_tile;  // the output rows on their way out (D <= 128)
  static constexpr int bits = stage + (WIDE ? 0 : kRows * pitch);
  static constexpr int bars = bits + S * words * 4;
  static constexpr int total = bars + (4 + 2 * S) * 8 + 1024;  // + the alignment slack
  static_assert(total <= 232448, "K1's shared memory passes the H100's 227 KB");
};

struct FwdParams {
  const int* mask;
  __nv_bfloat16* out;
  float* lse;
  const float* cos_t;
  const float* sin_t;
  int b, tq, tk, h, hkv, hb, bt, n_qt, groups, units, causal;
  float scale2;
};

// unit u -> (batch, head group, first query position, key tiles); causal
// units run longest first
template <int BN>
__device__ __forceinline__ void fwd_unit(const FwdParams& p, int u, int& b, int& hg, int& q0, int& nkt) {
  const int per = p.groups * p.b;
  const int rank = u / per, rem = u - rank * per;
  hg = rem % p.groups;
  b = rem / p.groups;
  q0 = (p.causal ? p.n_qt - 1 - rank : rank) * p.bt;
  const int kend = p.causal ? min(p.tk, q0 + p.bt) : p.tk;
  nkt = (kend + BN - 1) / BN;
}

// The fused RoPE of a warpgroup's 64 Q rows: each thread owns D / 32 chunks
// of 8 lower-half columns (and their upper partners); at D <= 128 their
// table entries are loaded before the Q tile lands (at D = 192 / 256 they
// would hold 96 / 128 registers: each chunk's are loaded as it is rotated),
// the rotation runs in shared memory.
template <int D>
struct QRope {
  static constexpr int N = D / 32, CH = D / 16, HELD = D <= 128 ? N : 1;
  float cs[HELD][8], sn[HELD][8];

  __device__ __forceinline__ void load_one(float (&c8)[8], float (&s8)[8], const FwdParams& p, int b, int q0, int row0,
                                           int t, int m) {
    const int i = t + 128 * m, r = row0 + i / CH, c = (i % CH) * 8, pos = q0 + r / p.hb;
    if (r < p.hb * p.bt && pos < p.tq) {
      const long long tab = (static_cast<long long>(b) * p.tq + pos) * (D / 2) + c;
      slam::load8(c8, p.cos_t + tab);
      slam::load8(s8, p.sin_t + tab);
    }
  }

  __device__ __forceinline__ void load(const FwdParams& p, int b, int q0, int row0, int t) {
    if constexpr (D <= 128) {
#pragma unroll
      for (int m = 0; m < N; ++m) load_one(cs[m], sn[m], p, b, q0, row0, t, m);
    }
  }

  __device__ __forceinline__ void apply(uint8_t* qt, const FwdParams& p, int b, int q0, int row0, int t) {
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const int i = t + 128 * m, r = row0 + i / CH, c = (i % CH) * 8, cu = c + D / 2;
      if (r >= p.hb * p.bt || q0 + r / p.hb >= p.tq) continue;
      const int slot = D <= 128 ? m : 0;
      if constexpr (D > 128) load_one(cs[0], sn[0], p, b, q0, row0, t, m);
      uint4* lo = reinterpret_cast<uint4*>(qt + (c / 64) * kRows * kPanelBytes + r * kPanelBytes +
                                           ((((c % 64) / 8) ^ (r & 7)) << 4));
      uint4* hi = reinterpret_cast<uint4*>(qt + (cu / 64) * kRows * kPanelBytes + r * kPanelBytes +
                                           ((((cu % 64) / 8) ^ (r & 7)) << 4));
      uint4 x = *lo, y = *hi;
      slam::rope_chunk(x, y, cs[slot], sn[slot]);
      *lo = x;
      *hi = y;
    }
  }
};

template <int D, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tma_q, const __grid_constant__ CUtensorMap tma_k,
                     const __grid_constant__ CUtensorMap tma_v, const FwdParams p) {
  using L = FwdSmem<D, BN>;
  constexpr int S = L::S, QB = L::QB, PANELS = D / 64, W = L::words;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem + L::q;
  uint8_t* ks = smem + L::k;
  uint8_t* vs = smem + L::v;
  uint8_t* stg = smem + L::stage;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + L::bits);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bars);  // [2]
  uint64_t* q_empty = q_full + 2;                                    // [2]
  uint64_t* full = q_full + 4;
  uint64_t* empty = full + S;
  const int wg = threadIdx.x / 128;
  const int rows_used = p.hb * p.bt;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    slam::mbar_init_fence();
  }
  if (wg < 2) {  // rows past hb * bt are never loaded: zero them once, in every buffer
    const int n = (kRows - rows_used) * 8;  // 16-byte chunks per panel
    for (int i = threadIdx.x; i < QB * n * PANELS; i += 256)
      *reinterpret_cast<uint4*>(qs + (i / n) * kRows * kPanelBytes + rows_used * kPanelBytes + (i % n) * 16) =
          make_uint4(0, 0, 0, 0);
    fence_async_shared();
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x < 256 + 32) {  // one producer warp
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        slam::prefetch_tensormap(&tma_q);
        slam::prefetch_tensormap(&tma_k);
        slam::prefetch_tensormap(&tma_v);
      }
      const int G = p.h / p.hkv;
      int stage = 0, j = 0;
      uint32_t phase = 0;
      int mv[W];  // this lane's mask values of the next tile, loaded a tile ahead
      if (blockIdx.x < p.units) {
        int b, hg, q0, nkt;
        fwd_unit<BN>(p, blockIdx.x, b, hg, q0, nkt);
        slam::load_key_mask(mv, p.mask + static_cast<long long>(b) * p.tk, 0, p.tk, lane);
      }
      for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++j) {
        int b, hg, q0, nkt;
        fwd_unit<BN>(p, u, b, hg, q0, nkt);
        const int hk = hg * p.hb / G, qb = j % QB;
        if (lane == 0) {
          mbar_wait(&q_empty[qb], ((j / QB) & 1) ^ 1);
          mbar_expect_tx(&q_full[qb], PANELS * rows_used * kPanelBytes);
          for (int pn = 0; pn < PANELS; ++pn)
            slam::tma_load_5d(qs + qb * L::q_tile + pn * kRows * kPanelBytes, &tma_q, &q_full[qb], 64 * pn, 0, hg,
                              q0, b);
        }
        for (int kt = 0; kt < nkt; ++kt) {
          const int k0 = kt * BN;
          mbar_wait(&empty[stage], phase ^ 1);
          slam::tile_key_bits(bits + stage * W, mv, lane);
          // the next tile's mask (this unit's or the next unit's first), in flight while this one waits
          if (kt + 1 < nkt) {
            slam::load_key_mask(mv, p.mask + static_cast<long long>(b) * p.tk, k0 + BN, p.tk, lane);
          } else if (u + gridDim.x < p.units) {
            int b2, hg2, q02, nkt2;
            fwd_unit<BN>(p, u + gridDim.x, b2, hg2, q02, nkt2);
            slam::load_key_mask(mv, p.mask + static_cast<long long>(b2) * p.tk, 0, p.tk, lane);
          }
          if (lane == 0) {
            mbar_expect_tx(&full[stage], 2 * L::kv_tile);
            for (int pn = 0; pn < PANELS; ++pn) {
              slam::tma_load_4d(ks + stage * L::kv_tile + pn * BN * kPanelBytes, &tma_k, &full[stage], 64 * pn, hk,
                                k0, b);
              slam::tma_load_4d(vs + stage * L::kv_tile + pn * BN * kPanelBytes, &tma_v, &full[stage], 64 * pn, hk,
                                k0, b);
            }
          }
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = threadIdx.x & 127, lane = t & 31, warp = t >> 5, tq4 = lane & 3;
    int stage = 0, j = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++j) {
      int b, hg, q0, nkt;
      fwd_unit<BN>(p, u, b, hg, q0, nkt);
      const int qb = j % QB;
      const uint32_t qpar = (j / QB) & 1;
      uint8_t* qt = qs + qb * L::q_tile;
      int rr[2], pos[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rr[h] = 64 * wg + 16 * warp + (lane >> 2) + 8 * h;
        pos[h] = q0 + rr[h] / p.hb;
      }
      const int wg_pos0 = q0 + (64 * wg) / p.hb;  // the warpgroup's first query position
      if (p.cos_t != nullptr) {
        QRope<D> rope;
        rope.load(p, b, q0, 64 * wg, t);
        mbar_wait(&q_full[qb], qpar);
        rope.apply(qt, p, b, q0, 64 * wg, t);
        fence_async_shared();
        slam::named_sync(2 + wg, 128);
      } else {
        mbar_wait(&q_full[qb], qpar);
      }

      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m_run[2] = {kNeg, kNeg};
      float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

      uint32_t pa[BN / 16][4];
      int prev = -1;  // the stage whose P V product may be in flight
      for (int kt = 0; kt < nkt; ++kt) {
        const int k0 = kt * BN;
        mbar_wait(&full[stage], phase);
        const uint8_t* kts = ks + stage * L::kv_tile;
        float s[BN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          slam::wgmma_ss<BN>(s, kmajor_step(qt, kRows, 64 * wg, kk), kmajor_step(kts, BN, 0, kk), kk > 0);
        wgmma_commit();
        if (prev >= 0) {  // the last tile's P V is done (the products finish in order): release its stage
          wgmma_wait<1>();
          fence_regs(o);
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) fence_regs(pa[kk]);
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        wgmma_wait<0>();
        fence_regs(s);
        if (kt == nkt - 1) {  // Q is read for the last time: a later unit's may load
          __syncwarp();
          if (lane == 0) mbar_arrive(&q_empty[qb]);
        }

        // scale into the log2 domain; mask only tiles with padding (by the
        // key bits) and tiles past the warpgroup's first position (causal)
        uint32_t w[W];
        bool full_tile = true;
#pragma unroll
        for (int i = 0; i < W; ++i) {
          w[i] = bits[stage * W + i];
          full_tile = full_tile && w[i] == 0xffffffffu;
        }
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) s[i] *= p.scale2;
        if (!full_tile) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) {
            const int key = 8 * (i >> 2) + 2 * tq4 + (i & 1);
            if (!((w[i >> 4] >> (key & 31)) & 1u)) s[i] = kNeg;
          }
        }
        if (p.causal && k0 + BN - 1 > wg_pos0) {
          const int lim[2] = {pos[0] - k0 - 2 * tq4, pos[1] - k0 - 2 * tq4};
#pragma unroll
          for (int i = 0; i < BN / 2; ++i)
            if (8 * (i >> 2) + (i & 1) > lim[(i >> 1) & 1]) s[i] = kNeg;
        }
        float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        float corr[2], lsum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          corr[h] = slam::ex2(m_run[h] - mx[h]);
          m_run[h] = mx[h];
        }
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int h = (i >> 1) & 1;
          const float pv = slam::ex2(s[i] - m_run[h]);
          s[i] = pv;
          lsum[h] += pv;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + lsum[h];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) p_fragment(pa[kk], s, kk);
        const uint8_t* vts = vs + stage * L::kv_tile;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) slam::wgmma_rs<D>(o, pa[kk], vts, BN, kk);
        wgmma_commit();
        prev = stage;
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) fence_regs(pa[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
        l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
      }
      // D <= 128: the warpgroup's rows go out through its staging rows, 16
      // bytes a thread; D = 192 / 256: from the registers, 4 bytes a thread
      if constexpr (!L::WIDE) slam::named_sync(2 + wg, 128);  // the last unit's rows are out
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float l_safe = fmaxf(l_run[h], 1e-30f);
        // a row that saw no valid key keeps the sentinel max: its output is 0
        const float inv = (m_run[h] > 0.5f * kNeg ? 1.f : 0.f) / l_safe;
        const bool row_ok = rr[h] < rows_used && pos[h] < p.tq;
        const long long orow = (static_cast<long long>(b) * p.tq + pos[h]) * p.h + hg * p.hb + rr[h] % p.hb;
        if constexpr (L::WIDE) {
          if (row_ok) {
#pragma unroll
            for (int jj = 0; jj < D / 8; ++jj)
              *reinterpret_cast<uint32_t*>(p.out + orow * D + 8 * jj + 2 * tq4) =
                  pack_bf16(o[4 * jj + 2 * h] * inv, o[4 * jj + 2 * h + 1] * inv);
          }
        } else {
          uint8_t* row = stg + rr[h] * L::pitch;
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj)
            *reinterpret_cast<uint32_t*>(row + (8 * jj + 2 * tq4) * 2) =
                pack_bf16(o[4 * jj + 2 * h] * inv, o[4 * jj + 2 * h + 1] * inv);
        }
        if (tq4 == 0 && row_ok) p.lse[orow] = m_run[h] + log2f(l_safe);
      }
      if constexpr (L::WIDE) continue;
      slam::named_sync(2 + wg, 128);
#pragma unroll
      for (int c = t; c < 64 * (D / 8); c += 128) {
        const int r = 64 * wg + c / (D / 8), pr = q0 + r / p.hb, col = (c % (D / 8)) * 8;
        if (r >= rows_used || pr >= p.tq) continue;
        const long long orow = (static_cast<long long>(b) * p.tq + pr) * p.h + hg * p.hb + r % p.hb;
        *reinterpret_cast<uint4*>(p.out + orow * D + col) =
            *reinterpret_cast<const uint4*>(stg + r * L::pitch + col * 2);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the layout probe: one S = Q K^T (both K-major) and one O = bf16(S) V (S
// from the accumulator registers, V MN-major) on a single tile
// ---------------------------------------------------------------------------

template <int D, int N>
__global__ void __launch_bounds__(128) wgmma_probe_kernel(const __grid_constant__ CUtensorMap tma_q,
                                                          const __grid_constant__ CUtensorMap tma_k,
                                                          const __grid_constant__ CUtensorMap tma_v, float* s_out,
                                                          float* o_out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* ks = qs + 64 * D * 2;
  uint8_t* vs = ks + N * D * 2;
  uint64_t* bar = reinterpret_cast<uint64_t*>(vs + N * D * 2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    slam::mbar_init_fence();
    mbar_expect_tx(bar, (64 + 2 * N) * D * 2);
    for (int pn = 0; pn < D / 64; ++pn) {
      slam::tma_load_2d(qs + pn * 64 * kPanelBytes, &tma_q, bar, 64 * pn, 0);
      slam::tma_load_2d(ks + pn * N * kPanelBytes, &tma_k, bar, 64 * pn, 0);
      slam::tma_load_2d(vs + pn * N * kPanelBytes, &tma_v, bar, 64 * pn, 0);
    }
  }
  __syncthreads();
  mbar_wait(bar, 0);
  float s[N / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) slam::wgmma_ss<N>(s, kmajor_step(qs, 64, 0, kk), kmajor_step(ks, N, 0, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    s_out[(16 * warp + g + 8 * ((i >> 1) & 1)) * N + 8 * (i >> 2) + 2 * t + (i & 1)] = s[i];
  uint32_t pa[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) p_fragment(pa[kk], s, kk);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) slam::wgmma_rs<D>(o, pa[kk], vs, N, kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
#pragma unroll
  for (int i = 0; i < D / 2; ++i)
    o_out[(16 * warp + g + 8 * ((i >> 1) & 1)) * D + 8 * (i >> 2) + 2 * t + (i & 1)] = o[i];
}

bool encode_bf16(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims, const long long* strides,
                 const cuuint32_t* box) {
  cuuint64_t sb[4];
  for (int i = 0; i < rank - 1; ++i) sb[i] = static_cast<cuuint64_t>(strides[i]) * 2;  // bytes
  return slam::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, base, dims, sb, box);
}

template <int D, int BN>
cudaError_t launch_fwd(const void* q, const void* kk, const void* v, const FwdParams& p, const long long* qs,
                       const long long* ks, const long long* vs, int sms, cudaStream_t st) {
  static unsigned long long configured = 0;
  cudaError_t err = slam::configure_smem(flash_fwd_kernel<D, BN>, FwdSmem<D, BN>::total, configured);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv;
  const cuuint64_t qdims[5] = {D, static_cast<cuuint64_t>(p.hb), static_cast<cuuint64_t>(p.groups),
                               static_cast<cuuint64_t>(p.tq), static_cast<cuuint64_t>(p.b)};
  const long long qstr[4] = {qs[2], qs[2] * p.hb, qs[1], qs[0]};  // head, head group, position, batch
  const cuuint32_t qbox[5] = {64, static_cast<cuuint32_t>(p.hb), 1, static_cast<cuuint32_t>(p.bt), 1};
  const cuuint64_t kdims[4] = {D, static_cast<cuuint64_t>(p.hkv), static_cast<cuuint64_t>(p.tk),
                               static_cast<cuuint64_t>(p.b)};
  const long long kstr[3] = {ks[2], ks[1], ks[0]}, vstr[3] = {vs[2], vs[1], vs[0]};
  const cuuint32_t kbox[4] = {64, 1, BN, 1};
  if (!encode_bf16(&mq, q, 5, qdims, qstr, qbox) || !encode_bf16(&mk, kk, 4, kdims, kstr, kbox) ||
      !encode_bf16(&mv, v, 4, kdims, vstr, kbox))
    return cudaErrorInvalidValue;
  const int grid = p.units < sms ? p.units : sms;
  flash_fwd_kernel<D, BN><<<grid, kThreads, FwdSmem<D, BN>::total, st>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

template <int D, int N>
cudaError_t launch_probe(const void* q, const void* k, const void* v, float* s_out, float* o_out, cudaStream_t st) {
  constexpr int smem = (64 + 2 * N) * D * 2 + 8 + 1024;
  static unsigned long long configured = 0;
  cudaError_t err = slam::configure_smem(wgmma_probe_kernel<D, N>, smem, configured);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv;
  const cuuint64_t qd[2] = {D, 64}, kd[2] = {D, N};
  const long long str[1] = {D};
  const cuuint32_t qb[2] = {64, 64}, kb[2] = {64, N};
  if (!encode_bf16(&mq, q, 2, qd, str, qb) || !encode_bf16(&mk, k, 2, kd, str, kb) ||
      !encode_bf16(&mv, v, 2, kd, str, kb))
    return cudaErrorInvalidValue;
  wgmma_probe_kernel<D, N><<<1, 128, smem, st>>>(mq, mk, mv, s_out, o_out);
  return cudaGetLastError();
}

}  // namespace

// q (B, Tq, H, D), k / v (B, Tk, Hkv, D) bf16 with strides (batch, position,
// head) in elements (multiples of 8, last dim contiguous), mask (B, Tk)
// int32, out (B, Tq, H, D) bf16 and lse (B, Tq, H) f32 contiguous; cos / sin
// (B, T, D/2) f32 or null, and then k_rot, (B, Tk, Hkv, D) bf16 scratch.
// hb: query heads per unit (a divisor of H / Hkv, at most 128) and bn: keys
// per tile (128 at D = 64, else 64), from the planner; sms: the card's SM
// count (the persistent grid).
extern "C" int slam_flash_fwd(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
                              const void* cos_t, const void* sin_t, void* k_rot, int b, int tq, int tk, int h, int hkv,
                              int d, long long qsb, long long qst, long long qsh, long long ksb, long long kst,
                              long long ksh, long long vsb, long long vst, long long vsh, float scale, int causal,
                              int hb, int bn, int sms, void* stream) {
  const bool rope = cos_t != nullptr;
  if (b < 1 || tq < 1 || tk < 1 || hkv < 1 || h % hkv != 0 || hb < 1 || hb > kRows || (h / hkv) % hb != 0 ||
      sms < 1 || (d != 64 && d != 128 && d != 192 && d != 256) || (causal && tq != tk) ||
      (rope && (sin_t == nullptr || k_rot == nullptr || tq != tk)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FwdParams p{static_cast<const int*>(mask), static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
              static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), b, tq, tk, h, hkv, hb, kRows / hb,
              0, h / hb, 0, causal, scale * slam::kLog2e};
  p.n_qt = (tq + p.bt - 1) / p.bt;
  p.units = p.n_qt * p.groups * b;
  const long long qs[3] = {qsb, qst, qsh}, vs[3] = {vsb, vst, vsh};
  long long ks[3] = {ksb, kst, ksh};
  const void* kk = k;
  if (rope) {
    const cudaError_t err = slam::launch_rope(static_cast<const __nv_bfloat16*>(k), static_cast<__nv_bfloat16*>(k_rot),
                                              p.cos_t, p.sin_t, b, tk, hkv, d, ks[0], ks[1], ks[2], st);
    if (err != cudaSuccess) return static_cast<int>(err);
    kk = k_rot;
    ks[0] = static_cast<long long>(tk) * hkv * d;
    ks[1] = static_cast<long long>(hkv) * d;
    ks[2] = d;
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (d == 64 && bn == 128) err = launch_fwd<64, 128>(q, kk, v, p, qs, ks, vs, sms, st);
  if (d == 64 && bn == 64) err = launch_fwd<64, 64>(q, kk, v, p, qs, ks, vs, sms, st);
  if (d == 128 && bn == 64) err = launch_fwd<128, 64>(q, kk, v, p, qs, ks, vs, sms, st);
  if (d == 192 && bn == 64) err = launch_fwd<192, 64>(q, kk, v, p, qs, ks, vs, sms, st);
  if (d == 256 && bn == 64) err = launch_fwd<256, 64>(q, kk, v, p, qs, ks, vs, sms, st);
  return static_cast<int>(err);
}

// One wgmma layout probe: q (64, d), k and v (n, d) bf16 contiguous; writes
// s = q k^T (64, n) and o = bf16(s) v (64, d), both f32. d, n in {64, 128}.
extern "C" int slam_wgmma_probe(const void* q, const void* k, const void* v, void* s_out, void* o_out, int d, int n,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* so = static_cast<float*>(s_out);
  float* oo = static_cast<float*>(o_out);
  cudaError_t err = cudaErrorInvalidValue;
  if (d == 64 && n == 64) err = launch_probe<64, 64>(q, k, v, so, oo, st);
  if (d == 64 && n == 128) err = launch_probe<64, 128>(q, k, v, so, oo, st);
  if (d == 128 && n == 64) err = launch_probe<128, 64>(q, k, v, so, oo, st);
  if (d == 128 && n == 128) err = launch_probe<128, 128>(q, k, v, so, oo, st);
  return static_cast<int>(err);
}
