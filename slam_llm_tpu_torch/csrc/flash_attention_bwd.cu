// K4: flash-attention backward for Hopper: TMA-fed wgmma, bf16 in and out,
// f32 accumulation, GQA, optional fused RoPE.
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
// nothing to dk / dv. With (cos, sin) tables, q and k go through a rotate
// pass into scratch tensors first (f32 rotation, one bf16 rounding, as K1),
// and dq / dk are counter-rotated with R^T in registers before the store.
//
// Bound on the H100: the tensor cores (five products per (key, query) tile
// over the two passes, plus the recomputed exp2). No atomics: every output
// element has one writer, so the result is deterministic. Launches:
//   0. (with RoPE) the rotate pass over q and over k;
//   1. delta, and lse copied into a (B, H, Tpad) layout (Tpad a multiple of
//      64, zero past T) so that each query tile's lse and delta arrive as one
//      256-byte bulk copy;
//   2. dk/dv and dq in one persistent launch: each block runs its dk/dv
//      units, then its dq units (the combined order puts every dk/dv unit
//      first), so the dq work fills the dk/dv pass's last wave; the two
//      passes share one shared-memory region, turned over behind a barrier.
//      dk/dv units are (batch, kv head, 128 keys), the most query tiles
//      first. Warpgroup 2's producer thread loads the unit's K and V once
//      (TMA), then streams the items (each of the G heads x each query tile
//      of 64 from the causal diagonal on): Q, dout, lse and delta through a
//      ring of 3 stages (2 at D = 128). Warpgroups 0 and 1 own 64 keys each
//      and keep dK and dV in registers: S^T = K Q^T and dP^T = V dout^T by
//      wgmma from shared memory (all K-major), then dV += P^T dout and
//      dK += dS^T Q with P^T / dS^T from the accumulator registers and dout /
//      Q read MN-major (the transpose bit): one copy of each tile serves both
//      of its products.
//      dq units are packed like K1 (128 rows = query positions x hb heads of
//      one kv head), Q and dout loaded once per unit (double-buffered: the
//      next unit's load while this one runs), K and V tiles of 64 keys
//      through a ring of 3 stages with the producer warp's key-validity bits:
//      S = Q K^T, dP = dout V^T, then dQ += dS K with K read MN-major.
// Masks by tile, as K1: only ragged, padded and diagonal tiles take the
// per-element mask. Shared memory per block: the larger of dk/dv's (K, V
// 32 KB + 3 x 16.5 KB at D = 64; 64 KB + 2 x 32.5 KB at D = 128) and dq's
// (2 x (Q, dout) 64 KB + 3 x 16 KB at D = 64; 128 KB + 3 x 32 KB at
// D = 128): 112 KB at D = 64, 224 KB at D = 128.

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

constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, then the producer warpgroup
constexpr int kKeys = 128;     // dk/dv: keys per unit
constexpr int kBQ = 64;        // dk/dv: queries per item
constexpr int kRows = 128;     // dq: query rows per unit
constexpr int kBN = 64;        // dq: keys per tile
constexpr int kWords = kBN / 32;

struct BwdParams {
  const int* mask;
  const float* lse_t;  // (B, H, tpad)
  const float* dlt_t;  // (B, H, tpad)
  const float* cos_t;
  const float* sin_t;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int b, T, h, hkv, hb, bt, n_qt, groups, tpad, causal, n_kb, units_dq, units_dkv;
  float scale2, scale;
};

// delta[b, h, t] = sum_d dout * out, and lse copied to the same (B, H, tpad)
// layout; both 0 past T. out / dout / lse contiguous. D / 8 threads per (b,
// t, h) row, one 16-byte chunk each, rows in memory order; the threads past
// the B T H rows write the pad.
template <int D>
__global__ void flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
                                       const float* __restrict__ lse, float* __restrict__ lse_t,
                                       float* __restrict__ dlt_t, int b, int T, int h, int tpad) {
  constexpr int L = D / 8;  // threads per row
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = i / L, rows = static_cast<long long>(b) * T * h;
  const int c = static_cast<int>(i % L) * 8;
  float acc = 0.f;
  if (row < rows) {
    const uint4 o4 = *reinterpret_cast<const uint4*>(out + row * D + c);
    const uint4 g4 = *reinterpret_cast<const uint4*>(dout + row * D + c);
    const __nv_bfloat16* o = reinterpret_cast<const __nv_bfloat16*>(&o4);
    const __nv_bfloat16* g = reinterpret_cast<const __nv_bfloat16*>(&g4);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc += __bfloat162float(o[e]) * __bfloat162float(g[e]);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);  // every thread takes part
  if (c != 0) return;
  if (row < rows) {
    const int hq = static_cast<int>(row % h);
    const long long bt = row / h;  // bb * T + t
    const long long r = ((bt / T) * h + hq) * tpad + bt % T;
    dlt_t[r] = acc;
    lse_t[r] = lse[row];
  } else if (row - rows < static_cast<long long>(b) * h * (tpad - T)) {  // the pad: T <= t < tpad
    const long long pr = row - rows, pad = tpad - T;
    const long long r = (pr / pad) * tpad + T + pr % pad;
    lse_t[r] = 0.f;
    dlt_t[r] = 0.f;
  }
}

// The backward's shared memory: the dk/dv pass's tiles and the dq pass's
// share one region (a block runs its dk/dv units, then its dq units, with a
// barrier between); barriers and the dq key bits sit after it.
template <int D>
struct BwdSmem {
  // dk/dv: K and V of the unit's 128 keys, then a ring of (Q, dout, lse, delta) items
  static constexpr int S_KV = D == 64 ? 3 : 2;
  static constexpr int kv = kKeys * D * 2;
  static constexpr int item = kBQ * D * 2;
  static constexpr int dkv_k = 0, dkv_v = kv, dkv_q = 2 * kv, dkv_g = dkv_q + S_KV * item;
  static constexpr int dkv_lse = dkv_g + S_KV * item, dkv_dlt = dkv_lse + S_KV * kBQ * 4;
  static constexpr int dkv_end = dkv_dlt + S_KV * kBQ * 4;
  // dq: two buffers each of the unit's Q and dout (the next unit's load while
  // this one runs), then a ring of (K, V) tiles of 64 keys
  static constexpr int S_Q = 3;
  static constexpr int q_tile = kRows * D * 2;
  static constexpr int kvt = kBN * D * 2;
  static constexpr int dq_q = 0, dq_g = 2 * q_tile, dq_k = 4 * q_tile, dq_v = dq_k + S_Q * kvt;
  static constexpr int dq_end = dq_v + S_Q * kvt;
  static constexpr int bits = dkv_end > dq_end ? dkv_end : dq_end;
  static constexpr int bars = bits + S_Q * kWords * 4;
  static constexpr int total = bars + (2 + 2 * S_KV + 4 + 2 * S_Q) * 8 + 1024;  // + the alignment slack
};

struct BwdMaps {  // the dk/dv pass's K, V (128-key boxes), Q, dout (64-query boxes); the dq pass's
  CUtensorMap k, v, q, g, dq_q, dq_g, dq_k, dq_v;  // Q, dout (a unit's rows), K, V (64-key boxes)
};

// ---------------------------------------------------------------------------
// dk / dv
// ---------------------------------------------------------------------------

// unit u -> (batch, kv head, first key): the first keys (the most query
// tiles under the causal mask) first
__device__ __forceinline__ void dkv_unit(const BwdParams& p, int u, int& b, int& hk, int& k0) {
  const int per = p.hkv * p.b;
  const int rank = u / per, rem = u - rank * per;
  hk = rem % p.hkv;
  b = rem / p.hkv;
  k0 = rank * kKeys;
}

template <int D>
struct DkvPipe {
  using L = BwdSmem<D>;
  uint8_t* base;
  uint64_t *kv_full, *kv_empty, *full, *empty;
  int stage = 0;
  uint32_t phase = 0, kvphase = 0;

  __device__ __forceinline__ uint8_t* k() const { return base + L::dkv_k; }
  __device__ __forceinline__ uint8_t* v() const { return base + L::dkv_v; }
  __device__ __forceinline__ uint8_t* q(int st) const { return base + L::dkv_q + st * L::item; }
  __device__ __forceinline__ uint8_t* g(int st) const { return base + L::dkv_g + st * L::item; }
  __device__ __forceinline__ float* lse(int st) const { return reinterpret_cast<float*>(base + L::dkv_lse) + st * kBQ; }
  __device__ __forceinline__ float* dlt(int st) const { return reinterpret_cast<float*>(base + L::dkv_dlt) + st * kBQ; }
  __device__ __forceinline__ void advance() {
    if (++stage == L::S_KV) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// the producer thread's loads of one dk/dv unit: K and V once, then the items
template <int D>
__device__ __forceinline__ void dkv_produce(const BwdParams& p, const BwdMaps& m, DkvPipe<D>& s, int u) {
  using L = BwdSmem<D>;
  constexpr int PANELS = D / 64;
  const int G = p.h / p.hkv, n_q64 = (p.T + kBQ - 1) / kBQ;
  int b, hk, k0;
  dkv_unit(p, u, b, hk, k0);
  mbar_wait(s.kv_empty, s.kvphase ^ 1);
  s.kvphase ^= 1;
  mbar_expect_tx(s.kv_full, 2 * L::kv);
  for (int pn = 0; pn < PANELS; ++pn) {
    slam::tma_load_4d(s.k() + pn * kKeys * kPanelBytes, &m.k, s.kv_full, 64 * pn, hk, k0, b);
    slam::tma_load_4d(s.v() + pn * kKeys * kPanelBytes, &m.v, s.kv_full, 64 * pn, hk, k0, b);
  }
  const int qt_lo = p.causal ? k0 / kBQ : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int hq = hk * G + gi;
    const long long lrow = (static_cast<long long>(b) * p.h + hq) * p.tpad;
    for (int qt = qt_lo; qt < n_q64; ++qt) {
      const int q0 = qt * kBQ, st = s.stage;
      mbar_wait(&s.empty[st], s.phase ^ 1);
      mbar_expect_tx(&s.full[st], 2 * L::item + 2 * kBQ * 4);
      for (int pn = 0; pn < PANELS; ++pn) {
        slam::tma_load_4d(s.q(st) + pn * kBQ * kPanelBytes, &m.q, &s.full[st], 64 * pn, hq, q0, b);
        slam::tma_load_4d(s.g(st) + pn * kBQ * kPanelBytes, &m.g, &s.full[st], 64 * pn, hq, q0, b);
      }
      slam::bulk_load(s.lse(st), p.lse_t + lrow + q0, kBQ * 4, &s.full[st]);
      slam::bulk_load(s.dlt(st), p.dlt_t + lrow + q0, kBQ * 4, &s.full[st]);
      s.advance();
    }
  }
}

// one consumer warpgroup's share of a dk/dv unit: its 64 keys' dK and dV
template <int D>
__device__ __forceinline__ void dkv_consume(const BwdParams& p, DkvPipe<D>& s, int u, int wg, int t) {
  const int lane = t & 31, warp = t >> 5, tq4 = lane & 3;
  const int G = p.h / p.hkv, n_q64 = (p.T + kBQ - 1) / kBQ;
  int b, hk, k0;
  dkv_unit(p, u, b, hk, k0);
  int kr[2];
  bool kval[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    kr[h] = k0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * h;
    kval[h] = kr[h] < p.T && p.mask[static_cast<long long>(b) * p.T + kr[h]] != 0;
  }
  const int wg_key_last = k0 + 64 * wg + 63;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(s.kv_full, s.kvphase);
  s.kvphase ^= 1;
  const int qt_lo = p.causal ? k0 / kBQ : 0;
  const int items = G * (n_q64 - qt_lo);
  for (int it = 0; it < items; ++it) {
    const int q0 = (qt_lo + it % (n_q64 - qt_lo)) * kBQ, st = s.stage;
    mbar_wait(&s.full[st], s.phase);
    const uint8_t* qts = s.q(st);
    const uint8_t* gts = s.g(st);
    float sT[kBQ / 2], dpt[kBQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      slam::wgmma_ss<kBQ>(sT, kmajor_step(s.k(), kKeys, 64 * wg, kk), kmajor_step(qts, kBQ, 0, kk), kk > 0);
      slam::wgmma_ss<kBQ>(dpt, kmajor_step(s.v(), kKeys, 64 * wg, kk), kmajor_step(gts, kBQ, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sT);
    fence_regs(dpt);
    if (it == items - 1) {  // K and V are read for the last time: the next unit's may load
      __syncwarp();
      if (lane == 0) mbar_arrive(s.kv_empty);
    }

    const bool need = q0 + kBQ > p.T || (p.causal && wg_key_last > q0);
    const float* ls = s.lse(st);
    const float* ds = s.dlt(st);
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = 8 * j + 2 * tq4 + e;
        const float lv = ls[qi], dl = ds[qi];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          const bool ok = kval[h] && (!need || (q0 + qi < p.T && (!p.causal || kr[h] <= q0 + qi)));
          const float pv = ok ? slam::ex2(sT[i] * p.scale2 - lv) : 0.f;
          sT[i] = pv;
          dpt[i] = pv * (dpt[i] - dl);
        }
      }
    uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      p_fragment(pa[kk], sT, kk);
      p_fragment(da[kk], dpt, kk);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      slam::wgmma_rs<D>(dv, pa[kk], mnmajor_step(gts, kBQ, kk));
      slam::wgmma_rs<D>(dk, da[kk], mnmajor_step(qts, kBQ, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(da[kk]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[st]);
    s.advance();
  }

#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] *= p.scale;
  if (p.cos_t != nullptr) {
    const float* cs[2];
    const float* sn[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long tab = (static_cast<long long>(b) * p.T + kr[h]) * (D / 2);
      cs[h] = kr[h] < p.T ? p.cos_t + tab : nullptr;
      sn[h] = kr[h] < p.T ? p.sin_t + tab : nullptr;
    }
    slam::rope_transpose<D>(dk, tq4, cs, sn);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kr[h] >= p.T) continue;
    const long long off = ((static_cast<long long>(b) * p.T + kr[h]) * p.hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * tq4;
      *reinterpret_cast<uint32_t*>(p.dk + off + c) = pack_bf16(dk[4 * j + 2 * h], dk[4 * j + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(p.dv + off + c) = pack_bf16(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

// unit u -> (batch, head group, first query position, key tiles), as K1
__device__ __forceinline__ void dq_unit(const BwdParams& p, int u, int& b, int& hg, int& q0, int& nkt) {
  const int per = p.groups * p.b;
  const int rank = u / per, rem = u - rank * per;
  hg = rem % p.groups;
  b = rem / p.groups;
  q0 = (p.causal ? p.n_qt - 1 - rank : rank) * p.bt;
  const int kend = p.causal ? min(p.T, q0 + p.bt) : p.T;
  nkt = (kend + kBN - 1) / kBN;
}

template <int D>
struct DqPipe {
  using L = BwdSmem<D>;
  uint8_t* base;
  uint32_t* bits;
  uint64_t *q_full, *q_empty, *full, *empty;  // q_full / q_empty: [2]
  int stage = 0, j = 0;  // j: the dq units this block has run (Q buffer j & 1)
  uint32_t phase = 0;

  __device__ __forceinline__ uint8_t* q(int qb) const { return base + L::dq_q + qb * L::q_tile; }
  __device__ __forceinline__ uint8_t* g(int qb) const { return base + L::dq_g + qb * L::q_tile; }
  __device__ __forceinline__ uint8_t* k(int st) const { return base + L::dq_k + st * L::kvt; }
  __device__ __forceinline__ uint8_t* v(int st) const { return base + L::dq_v + st * L::kvt; }
  __device__ __forceinline__ void advance() {
    if (++stage == L::S_Q) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// the producer warp's loads of one dq unit (lane 0 issues; the lanes ballot
// the key mask). mv holds this lane's mask values of the unit's first tile;
// on return, those of the unit next (or nothing past the last)
template <int D>
__device__ __forceinline__ void dq_produce(const BwdParams& p, const BwdMaps& m, DqPipe<D>& s, int u, int u_next,
                                           int (&mv)[kWords], int lane) {
  using L = BwdSmem<D>;
  constexpr int PANELS = D / 64;
  const int G = p.h / p.hkv, rows_used = p.hb * p.bt;
  int b, hg, q0, nkt;
  dq_unit(p, u, b, hg, q0, nkt);
  const int hk = hg * p.hb / G, qb = s.j & 1;
  if (lane == 0) {
    mbar_wait(&s.q_empty[qb], ((s.j >> 1) & 1) ^ 1);
    mbar_expect_tx(&s.q_full[qb], 2 * PANELS * rows_used * kPanelBytes);
    for (int pn = 0; pn < PANELS; ++pn) {
      slam::tma_load_5d(s.q(qb) + pn * kRows * kPanelBytes, &m.dq_q, &s.q_full[qb], 64 * pn, 0, hg, q0, b);
      slam::tma_load_5d(s.g(qb) + pn * kRows * kPanelBytes, &m.dq_g, &s.q_full[qb], 64 * pn, 0, hg, q0, b);
    }
  }
  ++s.j;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kBN, st = s.stage;
    mbar_wait(&s.empty[st], s.phase ^ 1);
    slam::tile_key_bits(s.bits + st * kWords, mv, lane);
    if (kt + 1 < nkt) {  // the next tile's mask, in flight while this one waits
      slam::load_key_mask(mv, p.mask + static_cast<long long>(b) * p.T, k0 + kBN, p.T, lane);
    } else if (u_next < p.units_dq) {
      int b2, hg2, q02, nkt2;
      dq_unit(p, u_next, b2, hg2, q02, nkt2);
      slam::load_key_mask(mv, p.mask + static_cast<long long>(b2) * p.T, 0, p.T, lane);
    }
    if (lane == 0) {
      mbar_expect_tx(&s.full[st], 2 * L::kvt);
      for (int pn = 0; pn < PANELS; ++pn) {
        slam::tma_load_4d(s.k(st) + pn * kBN * kPanelBytes, &m.dq_k, &s.full[st], 64 * pn, hk, k0, b);
        slam::tma_load_4d(s.v(st) + pn * kBN * kPanelBytes, &m.dq_v, &s.full[st], 64 * pn, hk, k0, b);
      }
    }
    s.advance();
  }
}

// one consumer warpgroup's 64 rows of a dq unit
template <int D>
__device__ __forceinline__ void dq_consume(const BwdParams& p, DqPipe<D>& s, int u, int wg, int t) {
  const int lane = t & 31, warp = t >> 5, tq4 = lane & 3;
  const int rows_used = p.hb * p.bt;
  int b, hg, q0, nkt;
  dq_unit(p, u, b, hg, q0, nkt);
  const int qb = s.j & 1;
  const uint8_t* qt = s.q(qb);
  const uint8_t* gt = s.g(qb);
  int rr[2], pos[2], head[2];
  bool row_ok[2];
  float lse_r[2], dlt_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rr[h] = 64 * wg + 16 * warp + (lane >> 2) + 8 * h;
    pos[h] = q0 + rr[h] / p.hb;
    head[h] = hg * p.hb + rr[h] % p.hb;
    row_ok[h] = rr[h] < rows_used && pos[h] < p.T;
    const long long li = (static_cast<long long>(b) * p.h + head[h]) * p.tpad + pos[h];
    lse_r[h] = row_ok[h] ? p.lse_t[li] : 0.f;
    dlt_r[h] = row_ok[h] ? p.dlt_t[li] : 0.f;
  }
  const int wg_pos0 = q0 + (64 * wg) / p.hb;
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  mbar_wait(&s.q_full[qb], (s.j >> 1) & 1);
  ++s.j;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kBN, st = s.stage;
    mbar_wait(&s.full[st], s.phase);
    const uint8_t* kts = s.k(st);
    const uint8_t* vts = s.v(st);
    float sc[kBN / 2], dp[kBN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      slam::wgmma_ss<kBN>(sc, kmajor_step(qt, kRows, 64 * wg, kk), kmajor_step(kts, kBN, 0, kk), kk > 0);
      slam::wgmma_ss<kBN>(dp, kmajor_step(gt, kRows, 64 * wg, kk), kmajor_step(vts, kBN, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    if (kt == nkt - 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.q_empty[qb]);
    }

    uint32_t w[kWords];
    bool full_tile = true;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      w[i] = s.bits[st * kWords + i];
      full_tile = full_tile && w[i] == 0xffffffffu;
    }
    const bool need = !full_tile || (p.causal && k0 + kBN - 1 > wg_pos0);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          bool ok = true;
          if (need) {
            const int key = 8 * j + 2 * tq4 + e;
            ok = ((w[j >> 2] >> (key & 31)) & 1u) && (!p.causal || k0 + key <= pos[h]);
          }
          const float pv = ok ? slam::ex2(sc[i] * p.scale2 - lse_r[h]) : 0.f;
          sc[i] = pv * (dp[i] - dlt_r[h]);  // dS
        }
    uint32_t da[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) p_fragment(da[kk], sc, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) slam::wgmma_rs<D>(dqa, da[kk], mnmajor_step(kts, kBN, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) fence_regs(da[kk]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[st]);
    s.advance();
  }

#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] *= p.scale;
  if (p.cos_t != nullptr) {
    const float* cs[2];
    const float* sn[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long tab = (static_cast<long long>(b) * p.T + pos[h]) * (D / 2);
      cs[h] = row_ok[h] ? p.cos_t + tab : nullptr;
      sn[h] = row_ok[h] ? p.sin_t + tab : nullptr;
    }
    slam::rope_transpose<D>(dqa, tq4, cs, sn);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    __nv_bfloat16* op = p.dq + ((static_cast<long long>(b) * p.T + pos[h]) * p.h + head[h]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(op + 8 * j + 2 * tq4) = pack_bf16(dqa[4 * j + 2 * h], dqa[4 * j + 2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// the two passes as one persistent launch: each block runs its dk/dv units
// (the combined order puts all of them first), then its dq units, so the dq
// work fills the dk/dv pass's last wave
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_kernel(const __grid_constant__ BwdMaps m, const BwdParams p) {
  using L = BwdSmem<D>;
  constexpr int PANELS = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars);
  DkvPipe<D> kv;
  kv.base = smem;
  kv.kv_full = bars;
  kv.kv_empty = bars + 1;
  kv.full = bars + 2;
  kv.empty = kv.full + L::S_KV;
  DqPipe<D> dq;
  dq.base = smem;
  dq.bits = reinterpret_cast<uint32_t*>(smem + L::bits);
  dq.q_full = kv.empty + L::S_KV;
  dq.q_empty = dq.q_full + 2;
  dq.full = dq.q_empty + 2;
  dq.empty = dq.full + L::S_Q;
  const int wg = threadIdx.x / 128, grid = static_cast<int>(gridDim.x);
  const int units = p.units_dkv + p.units_dq;

  if (threadIdx.x == 0) {
    mbar_init(kv.kv_full, 1);
    mbar_init(kv.kv_empty, 8);  // lane 0 of each consumer warp
    for (int s = 0; s < L::S_KV; ++s) {
      mbar_init(&kv.full[s], 1);
      mbar_init(&kv.empty[s], 8);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&dq.q_full[i], 1);
      mbar_init(&dq.q_empty[i], 8);
    }
    for (int s = 0; s < L::S_Q; ++s) {
      mbar_init(&dq.full[s], 1);
      mbar_init(&dq.empty[s], 8);
    }
    slam::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x < 256 + 32) {  // one producer warp
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        const CUtensorMap* maps[8] = {&m.k, &m.v, &m.q, &m.g, &m.dq_q, &m.dq_g, &m.dq_k, &m.dq_v};
        for (const CUtensorMap* x : maps) slam::prefetch_tensormap(x);
      }
      int mv[kWords];
      for (int u = blockIdx.x; u < units; u += grid) {
        if (u < p.units_dkv) {
          if (lane == 0) dkv_produce<D>(p, m, kv, u);
          continue;
        }
        if (u - grid < p.units_dkv) {  // this block's first dq unit: the dk/dv tiles are consumed
          slam::named_sync(1, 256 + 32);
          int b, hg, q0, nkt;
          dq_unit(p, u - p.units_dkv, b, hg, q0, nkt);
          slam::load_key_mask(mv, p.mask + static_cast<long long>(b) * p.T, 0, p.T, lane);
        }
        dq_produce<D>(p, m, dq, u - p.units_dkv, u + grid - p.units_dkv, mv, lane);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = threadIdx.x & 127;
    for (int u = blockIdx.x; u < units; u += grid) {
      if (u < p.units_dkv) {
        dkv_consume<D>(p, kv, u, wg, t);
        continue;
      }
      if (u - grid < p.units_dkv) {
        // this block's first dq unit: its dk/dv work is done, so the region
        // turns over to dq; the Q / dout rows past hb * bt are never loaded,
        // so each warpgroup zeroes its own in all four buffers
        slam::named_sync(1, 256 + 32);
        const int r0 = max(p.hb * p.bt, 64 * wg), n = max(64 * wg + 64 - r0, 0) * 8;  // 16-byte chunks per panel
        for (int i = t; i < 4 * PANELS * n; i += 128)
          *reinterpret_cast<uint4*>(smem + (i / n) * kRows * kPanelBytes + r0 * kPanelBytes + (i % n) * 16) =
              make_uint4(0, 0, 0, 0);
        fence_async_shared();
        slam::named_sync(2 + wg, 128);
      }
      dq_consume<D>(p, dq, u - p.units_dkv, wg, t);
    }
  }
}

template <int D>
__global__ void flash_bwd_rope_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                                      const float* __restrict__ cos_t, const float* __restrict__ sin_t, int b, int T,
                                      int hx) {
  const long long row = static_cast<long long>(hx) * D;
  slam::rope_pass<D>(x, out, cos_t, sin_t, b, T, hx, T * row, row, D);
}

// a contiguous (B, T, heads, D) bf16 tensor as a 4-D map (D, heads, T, B), boxes of 64 x 1 x rows x 1
bool encode_bthd(CUtensorMap* map, const void* base, int D, int heads, int T, int b, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(heads) * D * 2,
                                 static_cast<cuuint64_t>(T) * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return slam::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box);
}

// q / dout (B, T, H, D) contiguous as a 5-D map (D, head, head group, T, B),
// boxes of 64 x hb x 1 x bt x 1: one unit's rows of the dq pass
bool encode_grouped(CUtensorMap* map, const void* base, int D, const BwdParams& p) {
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(p.hb),
                              static_cast<cuuint64_t>(p.groups), static_cast<cuuint64_t>(p.T),
                              static_cast<cuuint64_t>(p.b)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(p.hb) * D * 2,
                                 static_cast<cuuint64_t>(p.h) * D * 2, static_cast<cuuint64_t>(p.T) * p.h * D * 2};
  const cuuint32_t box[5] = {64, static_cast<cuuint32_t>(p.hb), 1, static_cast<cuuint32_t>(p.bt), 1};
  return slam::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, base, dims, strides, box);
}

template <int D>
cudaError_t launch_bwd(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                       const __nv_bfloat16* out, const __nv_bfloat16* dout, const float* lse, float* lse_t,
                       float* dlt_t, __nv_bfloat16* q_rot, __nv_bfloat16* k_rot, const BwdParams& p, int sms,
                       cudaStream_t st) {
  static unsigned long long configured = 0;
  cudaError_t err = slam::configure_smem(flash_bwd_kernel<D>, BwdSmem<D>::total, configured);
  if (err != cudaSuccess) return err;
  if (p.cos_t != nullptr) {  // q and k rotated once, into the caller's scratch
    const long long nq = static_cast<long long>(p.b) * p.T * p.h * (D / 16);
    const long long nk = static_cast<long long>(p.b) * p.T * p.hkv * (D / 16);
    flash_bwd_rope_kernel<D><<<static_cast<unsigned>((nq + 255) / 256), 256, 0, st>>>(q, q_rot, p.cos_t, p.sin_t, p.b,
                                                                                     p.T, p.h);
    flash_bwd_rope_kernel<D><<<static_cast<unsigned>((nk + 255) / 256), 256, 0, st>>>(k, k_rot, p.cos_t, p.sin_t, p.b,
                                                                                     p.T, p.hkv);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    q = q_rot;
    k = k_rot;
  }
  const long long threads = static_cast<long long>(p.b) * p.h * p.tpad * (D / 8);  // rows and pad
  flash_bwd_delta_kernel<D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(out, dout, lse, lse_t,
                                                                                          dlt_t, p.b, p.T, p.h, p.tpad);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  BwdMaps m;
  if (!encode_bthd(&m.k, k, D, p.hkv, p.T, p.b, kKeys) || !encode_bthd(&m.v, v, D, p.hkv, p.T, p.b, kKeys) ||
      !encode_bthd(&m.q, q, D, p.h, p.T, p.b, kBQ) || !encode_bthd(&m.g, dout, D, p.h, p.T, p.b, kBQ) ||
      !encode_grouped(&m.dq_q, q, D, p) || !encode_grouped(&m.dq_g, dout, D, p) ||
      !encode_bthd(&m.dq_k, k, D, p.hkv, p.T, p.b, kBN) || !encode_bthd(&m.dq_v, v, D, p.hkv, p.T, p.b, kBN))
    return cudaErrorInvalidValue;
  const int units = p.units_dkv + p.units_dq, grid = units < sms ? units : sms;
  flash_bwd_kernel<D><<<grid, kThreads, BwdSmem<D>::total, st>>>(m, p);
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous: q / out / dout / dq (B, T, H, D) bf16, k / v / dk /
// dv (B, T, Hkv, D) bf16, mask (B, T) int32, lse (B, T, H) f32, cos / sin
// (B, T, D/2) f32 or null. Scratch the caller allocates: lse_t and dlt_t
// (B, H, tpad) f32 (tpad: T rounded up to 64), and with RoPE q_rot / k_rot
// shaped as q / k. hb: query heads per dq unit (a divisor of H / Hkv, at
// most 128), from the planner; sms: the card's SM count.
extern "C" int slam_flash_bwd(const void* q, const void* k, const void* v, const void* mask, const void* out,
                              const void* dout, const void* lse, const void* cos_t, const void* sin_t, void* lse_t,
                              void* dlt_t, void* q_rot, void* k_rot, void* dq, void* dk, void* dv, int b, int T, int h,
                              int hkv, int d, float scale, int causal, int hb, int tpad, int sms, void* stream) {
  const bool rope = cos_t != nullptr;
  if (b < 1 || T < 1 || hkv < 1 || h % hkv != 0 || hb < 1 || hb > kRows || (h / hkv) % hb != 0 || sms < 1 ||
      (d != 64 && d != 128) || tpad < T || tpad % kBQ != 0 ||
      (rope && (sin_t == nullptr || q_rot == nullptr || k_rot == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{static_cast<const int*>(mask), static_cast<const float*>(lse_t), static_cast<const float*>(dlt_t),
              static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), static_cast<__nv_bfloat16*>(dq),
              static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), b, T, h, hkv, hb, kRows / hb, 0,
              h / hb, tpad, causal, 0, 0, 0, scale * slam::kLog2e, scale};
  p.n_qt = (T + p.bt - 1) / p.bt;
  p.units_dq = p.n_qt * p.groups * b;
  p.n_kb = (T + kKeys - 1) / kKeys;
  p.units_dkv = p.n_kb * hkv * b;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* op = static_cast<const __nv_bfloat16*>(out);
  const auto* gp = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  auto* lt = static_cast<float*>(lse_t);
  auto* dt = static_cast<float*>(dlt_t);
  auto* qr = static_cast<__nv_bfloat16*>(q_rot);
  auto* kr = static_cast<__nv_bfloat16*>(k_rot);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = d == 64 ? launch_bwd<64>(qp, kp, vp, op, gp, lp, lt, dt, qr, kr, p, sms, st)
                                  : launch_bwd<128>(qp, kp, vp, op, gp, lp, lt, dt, qr, kr, p, sms, st);
  return static_cast<int>(err);
}
