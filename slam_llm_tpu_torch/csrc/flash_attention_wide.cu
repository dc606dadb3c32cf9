// The flash-attention kernels above head_dim 256: K1 (forward) and K4
// (backward), bf16 and f32, at any D % 64 == 0 taken at run time.
//
// Replaces the Pallas kernels of slam_llm_tpu/ops/kernels/flash_attention.py
// at the widths the TMA / wgmma kernels (flash_attention*.cu, D <= 256) do
// not take: _flash_fwd (and its f32 operands) and _flash_bwd, which the JAX
// package runs at every D % 64 == 0 (models/layers.py::_should_use_pallas).
// The conventions are K1's / K4's: scores in the exp2 domain, key padding
// from an int32 mask, GQA (query head h reads kv head h / (H / Hkv)), causal
// start-aligned (key j visible to query i iff j <= i, asked for only at Tq
// == Tk), lse (B, Tq, H) as log2-sum-exp2, query rows that see no valid key
// written as exactly 0 (dq 0). Fused RoPE (cos / sin (B, T, D/2) f32, Tq ==
// Tk): a pass rotates q and k into the caller's scratch in their own dtype
// (f32 rotation, one rounding: apply_rope_tables), and the backward
// counter-rotates dq / dk (R^T) as it writes them: both flash_common.cuh's
// rope_kernel, the RoPE pass of every flash route.
//
// Why a layout of its own. Above D 256 no whole-D tile or accumulator stays
// resident: a 64-row bf16 Q tile is 64 KB at D 512 and a warpgroup's O D/2
// f32 registers a thread. So D is split into panels:
// * every score product (S = Q K^T, dP = dO V^T) contracts over D in
//   64-column panels streamed through shared memory, so no whole-D row
//   sits there;
// * each output is held at most 256 columns at a time, by recomputing per
//   panel: the forward walks the keys once for the rows' max and sum (lse),
//   then once for each 256-column panel of O, with P = exp2(S - lse) and no
//   rescale; the backward's dq blocks own 256 columns of dq and its dk / dv
//   blocks 128 columns of dK and of dV, each recomputing S and dP over the
//   whole D. At D 512 the forward computes S three times, the backward S
//   and dP twice (dq) and four times (dk / dv).
// A block is 256 threads; the softmax and masks run with thread (ty, tx)
// owning rows ty + 16 i and columns tx + 16 j of each 64 x 64 tile. f32 runs
// its products in f32 on the CUDA cores (the *_fma kernels; panels padded
// to 65 floats a row, conflict-free column reads); bf16 runs them on the
// tensor cores (mma.sync m16n8k16, f32 accumulation, P and dS rounded to
// bf16 first as K1 / K4 and the twin round them; "bf16 on the tensor
// cores" below). Simple kernels, right first: no TMA, no pipelining, a sync
// per panel. Bound on the H100: the operations (which the recomputation
// multiplies), at 67 TFLOP/s of f32 FMA for f32 and 989 TFLOP/s of the
// bf16 tensor cores for bf16.
//
// Shared memory, f32: the forward 2 contraction panels (33 KB), P (17 KB)
// and a 64 x 256 V panel (66 KB): 113 KB; dq 2 panels, dS and a 64 x 256 K
// panel: 113 KB; dk / dv 2 panels, P^T, dS^T and 64 x 128 panels of Q and
// dO: 130 KB. bf16: 77 / 77 / 87 KB.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using slam::kNeg;

constexpr int kTile = 64;      // rows (queries or keys) of a block, keys or queries of a tile
constexpr int kPanel = 64;     // columns of a contraction panel
constexpr int kLd = kPanel + 1;  // a panel row in shared memory, floats
constexpr int kThreads = 256;  // 16 x 16
constexpr int kFwdCols = 256;  // O columns of a forward pass
constexpr int kDqCols = 256;   // dq columns of a dq block
constexpr int kDkvCols = 128;  // dK and dV columns of a dk / dv block

// a (b, head) slice of a (B, T, H, D) tensor: row t at base + t * st
template <typename T>
struct Rows {
  const T* base;
  long long st;
  int n;  // rows; past them the panels read 0
};

template <typename T>
__device__ __forceinline__ Rows<T> rows_of(const T* x, long long sb, long long st, long long sh, int b, int head,
                                           int n) {
  return Rows<T>{x + b * sb + head * sh, st, n};
}

// rows [r0, r0 + 64) and columns [c0, c0 + w) of x into sm (pitch floats a
// row), as f32; w % 4 == 0
__device__ __forceinline__ void load_panel(float* sm, int pitch, const Rows<float>& x, int r0, int c0, int w) {
  const int per_row = w / 4;
  for (int i = threadIdx.x; i < kTile * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < x.n) v = slam::load4(x.base + static_cast<long long>(r0 + r) * x.st + c0 + c);
    float* d = sm + r * pitch + c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// s[i][j] = sum over d of a[a0 + ty + 16 i] * b[b0 + tx + 16 j]: the 64 x 64
// product of rows of a and rows of b, over D in panels (sa / sb: two panel
// buffers). Every thread of the block calls it.
__device__ __forceinline__ void scores(float (&s)[4][4], float* sa, float* sb, const Rows<float>& a, int a0,
                                       const Rows<float>& b, int b0, int d) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int c0 = 0; c0 < d; c0 += kPanel) {
    __syncthreads();  // the last panel (or the caller's reads of sa / sb) done
    load_panel(sa, kLd, a, a0, c0, kPanel);
    load_panel(sb, kLd, b, b0, c0, kPanel);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kPanel; ++k) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = sa[(ty + 16 * i) * kLd + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = sb[(tx + 16 * j) * kLd + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
    }
  }
}

// acc[i][j] += sum over k < 64 of l[(ty + 16 i) * kLd + k] * r[k * pitch +
// tx + 16 j], for the thread's columns below w (NJ = the most columns / 16)
template <int NJ>
__device__ __forceinline__ void accumulate(float (&acc)[4][NJ], const float* l, const float* r, int pitch, int w) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = l[(ty + 16 * i) * kLd + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (16 * j >= w) break;
      const float y = r[k * pitch + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(x[i], y, acc[i][j]);
    }
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Geometry {
  int b, tq, tk, h, hkv, d, causal;
  float scale, scale2;  // scale, and scale * log2 e
};

// delta (B, Tq, H) = the rows' sums of dout * out, in f32: one warp a row
template <typename T>
__global__ void delta_wide_kernel(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta,
                                  int b, int tq, int h, int d, long long osb, long long ost, long long osh,
                                  long long gsb, long long gst, long long gsh) {
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(b) * tq * h) return;
  const int head = static_cast<int>(row % h);
  const long long bt = row / h;
  const int pos = static_cast<int>(bt % tq), bb = static_cast<int>(bt / tq);
  const T* o = out + bb * osb + pos * ost + head * osh;
  const T* g = dout + bb * gsb + pos * gst + head * gsh;
  float acc = 0.f;
  for (int c = 4 * lane; c < d; c += 128) {
    const float4 x = slam::load4(o + c), y = slam::load4(g + c);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// K1: the forward
// ---------------------------------------------------------------------------

template <typename T>
struct FwdArgs {
  const T *q, *k, *v;
  const int* mask;
  T* out;
  float* lse;
  long long qs[3], ks[3], vs[3];
  Geometry g;
};

constexpr int kFwdSmem = (2 * kTile * kLd + kTile * kLd + kTile * (kFwdCols + 1)) * 4 + kTile * 4;

// one block per (64 query rows, query head, batch row); causal blocks
// longest first
__global__ void __launch_bounds__(kThreads) fwd_fma_kernel(const FwdArgs<float> p) {
  extern __shared__ float smem[];
  float* sa = smem;
  float* sb = sa + kTile * kLd;
  float* ps = sb + kTile * kLd;
  float* vs = ps + kTile * kLd;
  int* valid = reinterpret_cast<int*>(vs + kTile * (kFwdCols + 1));
  const Geometry& g = p.g;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int n_qt = gridDim.x, head = blockIdx.y, b = blockIdx.z;
  const int q0 = (g.causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x)) * kTile;
  const int hk = head / (g.h / g.hkv);
  const Rows<float> q = rows_of(p.q, p.qs[0], p.qs[1], p.qs[2], b, head, g.tq);
  const Rows<float> k = rows_of(p.k, p.ks[0], p.ks[1], p.ks[2], b, hk, g.tk);
  const Rows<float> v = rows_of(p.v, p.vs[0], p.vs[1], p.vs[2], b, hk, g.tk);
  const int kend = g.causal ? min(g.tk, q0 + kTile) : g.tk;
  const int* mrow = p.mask + static_cast<long long>(b) * g.tk;

  // whether key k0 + tx + 16 j counts for row q0 + ty + 16 i (valid[] holds the tile's key mask)
  auto visible = [&](int k0, int i, int j) {
    const int key = k0 + tx + 16 * j;
    return valid[tx + 16 * j] != 0 && (!g.causal || key <= q0 + ty + 16 * i);
  };
  auto load_valid = [&](int k0) {
    __syncthreads();  // the last tile's reads of valid[] done
    if (threadIdx.x < kTile) valid[threadIdx.x] = k0 + threadIdx.x < g.tk ? mrow[k0 + threadIdx.x] : 0;
  };

  // pass 1: each row's max and sum (lse)
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNeg, l[i] = 0.f;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    load_valid(k0);
    float s[4][4];
    scores(s, sa, sb, q, q0, k, k0, g.d);  // its syncs publish valid[]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(k0, i, j) ? s[i][j] * g.scale2 : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += s[i][j] > 0.5f * kNeg ? exp2f(s[i][j] - mx) : 0.f;
      l[i] = l[i] * exp2f(m[i] - mx) + sum;
      m[i] = mx;
    }
  }
  float lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lt = row_sum16(l[i]);
    lse[i] = m[i] + log2f(fmaxf(lt, 1e-30f));
    const int pos = q0 + ty + 16 * i;
    if (tx == 0 && pos < g.tq) p.lse[(static_cast<long long>(b) * g.tq + pos) * g.h + head] = lse[i];
  }

  // then each panel of O: P = exp2(S - lse) (0 where not visible), O += P V
  for (int c0 = 0; c0 < g.d; c0 += kFwdCols) {
    const int w = min(kFwdCols, g.d - c0);
    float o[4][kFwdCols / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kFwdCols / 16; ++j) o[i][j] = 0.f;
    for (int k0 = 0; k0 < kend; k0 += kTile) {
      load_valid(k0);
      float s[4][4];
      scores(s, sa, sb, q, q0, k, k0, g.d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ps[(ty + 16 * i) * kLd + tx + 16 * j] = visible(k0, i, j) ? exp2f(s[i][j] * g.scale2 - lse[i]) : 0.f;
      load_panel(vs, kFwdCols + 1, v, k0, c0, w);
      __syncthreads();
      accumulate(o, ps, vs, kFwdCols + 1, w);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = q0 + ty + 16 * i;
      if (pos >= g.tq) continue;
      float* orow = p.out + ((static_cast<long long>(b) * g.tq + pos) * g.h + head) * g.d + c0;
#pragma unroll
      for (int j = 0; j < kFwdCols / 16; ++j)
        if (16 * j < w) orow[tx + 16 * j] = o[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// K4: the backward
// ---------------------------------------------------------------------------

template <typename T>
struct BwdArgs {
  const T *q, *k, *v, *out, *dout;
  const int* mask;
  const float *lse, *delta;
  float *dq, *dk, *dv;  // f32, (B, T, H, D) contiguous
  long long qs[3], ks[3], vs[3], gs[3];  // gs: dout's
  Geometry g;
};

constexpr int kDqSmem = (2 * kTile * kLd + kTile * kLd + kTile * (kDqCols + 1)) * 4 + 3 * kTile * 4;
constexpr int kDkvSmem = (2 * kTile * kLd + 2 * kTile * kLd + 2 * kTile * (kDkvCols + 1)) * 4 + 3 * kTile * 4;

// one block per (64 query rows, query head, batch row, 256 dq columns)
__global__ void __launch_bounds__(kThreads) dq_fma_kernel(const BwdArgs<float> p) {
  extern __shared__ float smem[];
  float* sa = smem;
  float* sb = sa + kTile * kLd;
  float* ds = sb + kTile * kLd;
  float* ks_ = ds + kTile * kLd;
  int* valid = reinterpret_cast<int*>(ks_ + kTile * (kDqCols + 1));
  const Geometry& g = p.g;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int panels = (g.d + kDqCols - 1) / kDqCols;
  const int n_qt = gridDim.x, head = blockIdx.y / panels, b = blockIdx.z;
  const int c0 = (blockIdx.y % panels) * kDqCols, w = min(kDqCols, g.d - c0);
  const int q0 = (g.causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x)) * kTile;
  const int hk = head / (g.h / g.hkv);
  const Rows<float> q = rows_of(p.q, p.qs[0], p.qs[1], p.qs[2], b, head, g.tq);
  const Rows<float> dout = rows_of(p.dout, p.gs[0], p.gs[1], p.gs[2], b, head, g.tq);
  const Rows<float> k = rows_of(p.k, p.ks[0], p.ks[1], p.ks[2], b, hk, g.tk);
  const Rows<float> v = rows_of(p.v, p.vs[0], p.vs[1], p.vs[2], b, hk, g.tk);
  const int kend = g.causal ? min(g.tk, q0 + kTile) : g.tk;
  const int* mrow = p.mask + static_cast<long long>(b) * g.tk;
  float lse[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pos = min(q0 + ty + 16 * i, g.tq - 1);
    const long long at = (static_cast<long long>(b) * g.tq + pos) * g.h + head;
    lse[i] = p.lse[at];
    dl[i] = p.delta[at];
  }
  float acc[4][kDqCols / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDqCols / 16; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();
    if (threadIdx.x < kTile) valid[threadIdx.x] = k0 + threadIdx.x < g.tk ? mrow[k0 + threadIdx.x] : 0;
    float s[4][4], dp[4][4];
    scores(s, sa, sb, q, q0, k, k0, g.d);
    scores(dp, sa, sb, dout, q0, v, k0, g.d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pos = q0 + ty + 16 * i, key = k0 + tx + 16 * j;
        const bool vis = pos < g.tq && valid[tx + 16 * j] != 0 && (!g.causal || key <= pos);
        const float pr = vis ? exp2f(s[i][j] * g.scale2 - lse[i]) : 0.f;
        ds[(ty + 16 * i) * kLd + tx + 16 * j] = pr * (dp[i][j] - dl[i]);
      }
    load_panel(ks_, kDqCols + 1, k, k0, c0, w);
    __syncthreads();
    accumulate(acc, ds, ks_, kDqCols + 1, w);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pos = q0 + ty + 16 * i;
    if (pos >= g.tq) continue;
    float* row = p.dq + ((static_cast<long long>(b) * g.tq + pos) * g.h + head) * g.d + c0;
#pragma unroll
    for (int j = 0; j < kDqCols / 16; ++j)
      if (16 * j < w) row[tx + 16 * j] = acc[i][j] * g.scale;
  }
}

// one block per (64 keys, kv head, batch row, 128 dK / dV columns); it
// walks the G query heads of the kv head and their query tiles
__global__ void __launch_bounds__(kThreads) dkv_fma_kernel(const BwdArgs<float> p) {
  extern __shared__ float smem[];
  float* sa = smem;
  float* sb = sa + kTile * kLd;
  float* pt = sb + kTile * kLd;
  float* dst = pt + kTile * kLd;
  float* qp = dst + kTile * kLd;
  float* gp = qp + kTile * (kDkvCols + 1);
  float* lse_s = gp + kTile * (kDkvCols + 1);
  float* dl_s = lse_s + kTile;
  int* valid = reinterpret_cast<int*>(dl_s + kTile);
  const Geometry& g = p.g;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int panels = (g.d + kDkvCols - 1) / kDkvCols;
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y / panels, b = blockIdx.z;
  const int c0 = (blockIdx.y % panels) * kDkvCols, w = min(kDkvCols, g.d - c0);
  const int group = g.h / g.hkv;
  const Rows<float> k = rows_of(p.k, p.ks[0], p.ks[1], p.ks[2], b, hk, g.tk);
  const Rows<float> v = rows_of(p.v, p.vs[0], p.vs[1], p.vs[2], b, hk, g.tk);
  if (threadIdx.x < kTile) {
    const int key = k0 + threadIdx.x;
    valid[threadIdx.x] = key < g.tk ? p.mask[static_cast<long long>(b) * g.tk + key] : 0;
  }
  float dk[4][kDkvCols / 16], dv[4][kDkvCols / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDkvCols / 16; ++j) dk[i][j] = dv[i][j] = 0.f;
  const int first_q = g.causal ? k0 : 0;  // causal: queries before the block's first key see none of its keys
  for (int gi = 0; gi < group; ++gi) {
    const int head = hk * group + gi;
    const Rows<float> q = rows_of(p.q, p.qs[0], p.qs[1], p.qs[2], b, head, g.tq);
    const Rows<float> dout = rows_of(p.dout, p.gs[0], p.gs[1], p.gs[2], b, head, g.tq);
    for (int q0 = first_q / kTile * kTile; q0 < g.tq; q0 += kTile) {
      __syncthreads();  // the last tile's reads of lse_s / dl_s done
      if (threadIdx.x < kTile) {
        const int pos = min(q0 + static_cast<int>(threadIdx.x), g.tq - 1);
        const long long at = (static_cast<long long>(b) * g.tq + pos) * g.h + head;
        lse_s[threadIdx.x] = p.lse[at];
        dl_s[threadIdx.x] = p.delta[at];
      }
      // S^T and dP^T: rows the block's keys, columns the tile's queries
      float s[4][4], dp[4][4];
      scores(s, sa, sb, k, k0, q, q0, g.d);
      scores(dp, sa, sb, v, k0, dout, q0, g.d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + ty + 16 * i, pos = q0 + tx + 16 * j;
          const bool vis = pos < g.tq && valid[ty + 16 * i] != 0 && (!g.causal || key <= pos);
          const float pr = vis ? exp2f(s[i][j] * g.scale2 - lse_s[tx + 16 * j]) : 0.f;
          pt[(ty + 16 * i) * kLd + tx + 16 * j] = pr;
          dst[(ty + 16 * i) * kLd + tx + 16 * j] = pr * (dp[i][j] - dl_s[tx + 16 * j]);
        }
      load_panel(qp, kDkvCols + 1, q, q0, c0, w);
      load_panel(gp, kDkvCols + 1, dout, q0, c0, w);
      __syncthreads();
      accumulate(dv, pt, gp, kDkvCols + 1, w);
      accumulate(dk, dst, qp, kDkvCols + 1, w);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= g.tk) continue;
    const long long at = ((static_cast<long long>(b) * g.tk + key) * g.hkv + hk) * g.d + c0;
#pragma unroll
    for (int j = 0; j < kDkvCols / 16; ++j)
      if (16 * j < w) {
        p.dk[at + tx + 16 * j] = dk[i][j] * g.scale;
        p.dv[at + tx + 16 * j] = dv[i][j];
      }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: the same blocks, walks and softmax, with every
// product an mma.sync m16n8k16 (bf16 in, f32 out). Panels stay bf16 in
// shared memory; a score tile leaves the fragments through a 64 x 65 f32
// tile, so the softmax keeps the layout above; P and dS go back as bf16
// (the rounding K1 / K4 and the twin apply) and are the A operand of the
// output products, whose B panels (V, K, Q, dout: rows the contraction)
// are read transposed by ldmatrix. Warp w owns rows 16 (w % 4) .. + 15 and
// half w / 4 of an output panel's columns.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kLdh = kPanel + 8;          // a bf16 panel row, halves (conflict-free fragment loads)
constexpr int kLdFwd = kFwdCols + 8;      // a 256-column B panel row (ldmatrix rows 16 bytes off a bank cycle)
constexpr int kLdDkv = kDkvCols + 8;      // a 128-column one
constexpr int kHalfPanel = kTile * kLdh;  // halves

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the B fragment of a k16 x n8 block of a row-major [k][n] panel: lanes 0-15
// address its 16 rows, each 8 halves from n0
__device__ __forceinline__ void ldmatrix_b(uint32_t (&b)[2], const bf16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(slam::smem_u32(row)));
}

// rows [r0, r0 + 64) and columns [c0, c0 + w) of x into sm (pitch halves a
// row) as they are, 4 halves a load; w % 4 == 0
__device__ __forceinline__ void load_rows_h(bf16* sm, int pitch, const Rows<bf16>& x, int r0, int c0, int w) {
  const int per_row = w / 4;
  for (int i = threadIdx.x; i < kTile * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * 4;
    uint2 v = make_uint2(0u, 0u);
    if (r0 + r < x.n) v = *reinterpret_cast<const uint2*>(x.base + static_cast<long long>(r0 + r) * x.st + c0 + c);
    *reinterpret_cast<uint2*>(sm + r * pitch + c) = v;
  }
}

// scores' product on the tensor cores: s as there (thread (ty, tx), rows
// ty + 16 i, columns tx + 16 j), through the f32 tile st
__device__ __forceinline__ void scores_tc(float (&s)[4][4], bf16* ha, bf16* hb, float* st, const Rows<bf16>& a,
                                          int a0, const Rows<bf16>& b, int b0, int d) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int mi = warp % 4, ni = warp / 4;
  float c[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
  for (int c0 = 0; c0 < d; c0 += kPanel) {
    __syncthreads();  // the last panel's (or the last tile's) reads done
    load_rows_h(ha, kLdh, a, a0, c0, kPanel);
    load_rows_h(hb, kLdh, b, b0, c0, kPanel);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kPanel / 16; ++kk) {
      const bf16* ar = ha + (16 * mi + g) * kLdh + 16 * kk + 2 * t;
      const uint32_t af[4] = {ld32(ar), ld32(ar + 8 * kLdh), ld32(ar + 8), ld32(ar + 8 * kLdh + 8)};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const bf16* br = hb + (32 * ni + 8 * n + g) * kLdh + 16 * kk + 2 * t;
        const uint32_t bf[2] = {ld32(br), ld32(br + 8)};
        mma16816(c[n], af, bf);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[(16 * mi + g + 8 * (e / 2)) * kLd + 32 * ni + 8 * n + 2 * t + e % 2] = c[n][e];
  __syncthreads();
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = st[(ty + 16 * i) * kLd + tx + 16 * j];
}

// acc += l (64 x 64, row-major, pitch kLdh) times r (64 rows x w columns,
// pitch halves): warp w's rows and half of the w columns, NT n8 blocks at most
template <int NT>
__device__ __forceinline__ void accumulate_tc(float (&acc)[NT][4], const bf16* l, const bf16* r, int pitch, int w) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int mi = warp % 4, n0 = (warp / 4) * (w / 2);
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const bf16* ar = l + (16 * mi + g) * kLdh + 16 * kk + 2 * t;
    const uint32_t af[4] = {ld32(ar), ld32(ar + 8 * kLdh), ld32(ar + 8), ld32(ar + 8 * kLdh + 8)};
    const bf16* rows = r + (16 * kk + lane % 16) * pitch + n0;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (8 * n >= w / 2) break;
      uint32_t bf[2];
      ldmatrix_b(bf, rows + 8 * n);
      mma16816(acc[n], af, bf);
    }
  }
}

// element e of block n of an accumulate_tc accumulator: (row, column of the panel)
__device__ __forceinline__ void tc_coords(int n, int e, int w, int& row, int& col) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  row = 16 * (warp % 4) + lane / 4 + 8 * (e / 2);
  col = (warp / 4) * (w / 2) + 8 * n + 2 * (lane % 4) + e % 2;
}

constexpr int kFwdTcSmem = 2 * kHalfPanel * 2 + kTile * kLd * 4 + kHalfPanel * 2 + kTile * kLdFwd * 2 + kTile * 4;
constexpr int kDqTcSmem = kFwdTcSmem;
constexpr int kDkvTcSmem = 2 * kHalfPanel * 2 + kTile * kLd * 4 + 2 * kHalfPanel * 2 + 2 * kTile * kLdDkv * 2 +
                           3 * kTile * 4;

__global__ void __launch_bounds__(kThreads) fwd_tc_kernel(const FwdArgs<bf16> p) {
  extern __shared__ float4 smem_tc[];
  bf16* ha = reinterpret_cast<bf16*>(smem_tc);
  bf16* hb = ha + kHalfPanel;
  float* st = reinterpret_cast<float*>(hb + kHalfPanel);
  bf16* pl = reinterpret_cast<bf16*>(st + kTile * kLd);
  bf16* vr = pl + kHalfPanel;
  int* valid = reinterpret_cast<int*>(vr + kTile * kLdFwd);
  const Geometry& g = p.g;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int n_qt = gridDim.x, head = blockIdx.y, b = blockIdx.z;
  const int q0 = (g.causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x)) * kTile;
  const int hk = head / (g.h / g.hkv);
  const Rows<bf16> q = rows_of(p.q, p.qs[0], p.qs[1], p.qs[2], b, head, g.tq);
  const Rows<bf16> k = rows_of(p.k, p.ks[0], p.ks[1], p.ks[2], b, hk, g.tk);
  const Rows<bf16> v = rows_of(p.v, p.vs[0], p.vs[1], p.vs[2], b, hk, g.tk);
  const int kend = g.causal ? min(g.tk, q0 + kTile) : g.tk;
  const int* mrow = p.mask + static_cast<long long>(b) * g.tk;
  auto visible = [&](int k0, int i, int j) {
    const int key = k0 + tx + 16 * j;
    return valid[tx + 16 * j] != 0 && (!g.causal || key <= q0 + ty + 16 * i);
  };
  auto load_valid = [&](int k0) {
    __syncthreads();
    if (threadIdx.x < kTile) valid[threadIdx.x] = k0 + threadIdx.x < g.tk ? mrow[k0 + threadIdx.x] : 0;
  };

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNeg, l[i] = 0.f;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    load_valid(k0);
    float s[4][4];
    scores_tc(s, ha, hb, st, q, q0, k, k0, g.d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(k0, i, j) ? s[i][j] * g.scale2 : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += s[i][j] > 0.5f * kNeg ? exp2f(s[i][j] - mx) : 0.f;
      l[i] = l[i] * exp2f(m[i] - mx) + sum;
      m[i] = mx;
    }
  }
  float lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse[i] = m[i] + log2f(fmaxf(row_sum16(l[i]), 1e-30f));
    const int pos = q0 + ty + 16 * i;
    if (tx == 0 && pos < g.tq) p.lse[(static_cast<long long>(b) * g.tq + pos) * g.h + head] = lse[i];
  }

  for (int c0 = 0; c0 < g.d; c0 += kFwdCols) {
    const int w = min(kFwdCols, g.d - c0);
    float o[kFwdCols / 16][4];
#pragma unroll
    for (int n = 0; n < kFwdCols / 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    for (int k0 = 0; k0 < kend; k0 += kTile) {
      load_valid(k0);
      float s[4][4];
      scores_tc(s, ha, hb, st, q, q0, k, k0, g.d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pl[(ty + 16 * i) * kLdh + tx + 16 * j] =
              __float2bfloat16_rn(visible(k0, i, j) ? exp2f(s[i][j] * g.scale2 - lse[i]) : 0.f);
      load_rows_h(vr, kLdFwd, v, k0, c0, w);
      __syncthreads();
      accumulate_tc(o, pl, vr, kLdFwd, w);
    }
#pragma unroll
    for (int n = 0; n < kFwdCols / 16; ++n) {
      if (8 * n >= w / 2) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int row, col;
        tc_coords(n, 2 * h, w, row, col);
        const int pos = q0 + row;
        if (pos < g.tq)
          *reinterpret_cast<uint32_t*>(p.out + ((static_cast<long long>(b) * g.tq + pos) * g.h + head) * g.d + c0 +
                                       col) = slam::pack_bf16(o[n][2 * h], o[n][2 * h + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) dq_tc_kernel(const BwdArgs<bf16> p) {
  extern __shared__ float4 smem_tc[];
  bf16* ha = reinterpret_cast<bf16*>(smem_tc);
  bf16* hb = ha + kHalfPanel;
  float* st = reinterpret_cast<float*>(hb + kHalfPanel);
  bf16* ds = reinterpret_cast<bf16*>(st + kTile * kLd);
  bf16* kr = ds + kHalfPanel;
  int* valid = reinterpret_cast<int*>(kr + kTile * kLdFwd);
  const Geometry& g = p.g;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int panels = (g.d + kDqCols - 1) / kDqCols;
  const int n_qt = gridDim.x, head = blockIdx.y / panels, b = blockIdx.z;
  const int c0 = (blockIdx.y % panels) * kDqCols, w = min(kDqCols, g.d - c0);
  const int q0 = (g.causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x)) * kTile;
  const int hk = head / (g.h / g.hkv);
  const Rows<bf16> q = rows_of(p.q, p.qs[0], p.qs[1], p.qs[2], b, head, g.tq);
  const Rows<bf16> dout = rows_of(p.dout, p.gs[0], p.gs[1], p.gs[2], b, head, g.tq);
  const Rows<bf16> k = rows_of(p.k, p.ks[0], p.ks[1], p.ks[2], b, hk, g.tk);
  const Rows<bf16> v = rows_of(p.v, p.vs[0], p.vs[1], p.vs[2], b, hk, g.tk);
  const int kend = g.causal ? min(g.tk, q0 + kTile) : g.tk;
  const int* mrow = p.mask + static_cast<long long>(b) * g.tk;
  float lse[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pos = min(q0 + ty + 16 * i, g.tq - 1);
    const long long at = (static_cast<long long>(b) * g.tq + pos) * g.h + head;
    lse[i] = p.lse[at];
    dl[i] = p.delta[at];
  }
  float acc[kDqCols / 16][4];
#pragma unroll
  for (int n = 0; n < kDqCols / 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();
    if (threadIdx.x < kTile) valid[threadIdx.x] = k0 + threadIdx.x < g.tk ? mrow[k0 + threadIdx.x] : 0;
    float s[4][4], dp[4][4];
    scores_tc(s, ha, hb, st, q, q0, k, k0, g.d);
    scores_tc(dp, ha, hb, st, dout, q0, v, k0, g.d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pos = q0 + ty + 16 * i, key = k0 + tx + 16 * j;
        const bool vis = pos < g.tq && valid[tx + 16 * j] != 0 && (!g.causal || key <= pos);
        const float pr = vis ? exp2f(s[i][j] * g.scale2 - lse[i]) : 0.f;
        ds[(ty + 16 * i) * kLdh + tx + 16 * j] = __float2bfloat16_rn(pr * (dp[i][j] - dl[i]));
      }
    load_rows_h(kr, kLdFwd, k, k0, c0, w);
    __syncthreads();
    accumulate_tc(acc, ds, kr, kLdFwd, w);
  }
#pragma unroll
  for (int n = 0; n < kDqCols / 16; ++n) {
    if (8 * n >= w / 2) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int row, col;
      tc_coords(n, 2 * h, w, row, col);
      const int pos = q0 + row;
      if (pos < g.tq)
        *reinterpret_cast<float2*>(p.dq + ((static_cast<long long>(b) * g.tq + pos) * g.h + head) * g.d + c0 + col) =
            make_float2(acc[n][2 * h] * g.scale, acc[n][2 * h + 1] * g.scale);
    }
  }
}

__global__ void __launch_bounds__(kThreads) dkv_tc_kernel(const BwdArgs<bf16> p) {
  extern __shared__ float4 smem_tc[];
  bf16* ha = reinterpret_cast<bf16*>(smem_tc);
  bf16* hb = ha + kHalfPanel;
  float* st = reinterpret_cast<float*>(hb + kHalfPanel);
  bf16* pt = reinterpret_cast<bf16*>(st + kTile * kLd);
  bf16* dst = pt + kHalfPanel;
  bf16* qr = dst + kHalfPanel;
  bf16* gr = qr + kTile * kLdDkv;
  float* lse_s = reinterpret_cast<float*>(gr + kTile * kLdDkv);
  float* dl_s = lse_s + kTile;
  int* valid = reinterpret_cast<int*>(dl_s + kTile);
  const Geometry& g = p.g;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int panels = (g.d + kDkvCols - 1) / kDkvCols;
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y / panels, b = blockIdx.z;
  const int c0 = (blockIdx.y % panels) * kDkvCols, w = min(kDkvCols, g.d - c0);
  const int group = g.h / g.hkv;
  const Rows<bf16> k = rows_of(p.k, p.ks[0], p.ks[1], p.ks[2], b, hk, g.tk);
  const Rows<bf16> v = rows_of(p.v, p.vs[0], p.vs[1], p.vs[2], b, hk, g.tk);
  if (threadIdx.x < kTile) {
    const int key = k0 + threadIdx.x;
    valid[threadIdx.x] = key < g.tk ? p.mask[static_cast<long long>(b) * g.tk + key] : 0;
  }
  float dk[kDkvCols / 16][4], dv[kDkvCols / 16][4];
#pragma unroll
  for (int n = 0; n < kDkvCols / 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int first_q = g.causal ? k0 : 0;
  for (int gi = 0; gi < group; ++gi) {
    const int head = hk * group + gi;
    const Rows<bf16> q = rows_of(p.q, p.qs[0], p.qs[1], p.qs[2], b, head, g.tq);
    const Rows<bf16> dout = rows_of(p.dout, p.gs[0], p.gs[1], p.gs[2], b, head, g.tq);
    for (int q0 = first_q / kTile * kTile; q0 < g.tq; q0 += kTile) {
      __syncthreads();
      if (threadIdx.x < kTile) {
        const int pos = min(q0 + static_cast<int>(threadIdx.x), g.tq - 1);
        const long long at = (static_cast<long long>(b) * g.tq + pos) * g.h + head;
        lse_s[threadIdx.x] = p.lse[at];
        dl_s[threadIdx.x] = p.delta[at];
      }
      float s[4][4], dp[4][4];
      scores_tc(s, ha, hb, st, k, k0, q, q0, g.d);
      scores_tc(dp, ha, hb, st, v, k0, dout, q0, g.d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + ty + 16 * i, pos = q0 + tx + 16 * j;
          const bool vis = pos < g.tq && valid[ty + 16 * i] != 0 && (!g.causal || key <= pos);
          const float pr = vis ? exp2f(s[i][j] * g.scale2 - lse_s[tx + 16 * j]) : 0.f;
          pt[(ty + 16 * i) * kLdh + tx + 16 * j] = __float2bfloat16_rn(pr);
          dst[(ty + 16 * i) * kLdh + tx + 16 * j] = __float2bfloat16_rn(pr * (dp[i][j] - dl_s[tx + 16 * j]));
        }
      load_rows_h(qr, kLdDkv, q, q0, c0, w);
      load_rows_h(gr, kLdDkv, dout, q0, c0, w);
      __syncthreads();
      accumulate_tc(dv, pt, gr, kLdDkv, w);
      accumulate_tc(dk, dst, qr, kLdDkv, w);
    }
  }
#pragma unroll
  for (int n = 0; n < kDkvCols / 16; ++n) {
    if (8 * n >= w / 2) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int row, col;
      tc_coords(n, 2 * h, w, row, col);
      const int key = k0 + row;
      if (key >= g.tk) continue;
      const long long at = ((static_cast<long long>(b) * g.tk + key) * g.hkv + hk) * g.d + c0 + col;
      *reinterpret_cast<float2*>(p.dk + at) = make_float2(dk[n][2 * h] * g.scale, dk[n][2 * h + 1] * g.scale);
      *reinterpret_cast<float2*>(p.dv + at) = make_float2(dv[n][2 * h], dv[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

unsigned blocks_for(long long n, int threads) { return static_cast<unsigned>((n + threads - 1) / threads); }

Geometry geometry(int b, int tq, int tk, int h, int hkv, int d, float scale, int causal) {
  return Geometry{b, tq, tk, h, hkv, d, causal, scale, scale * slam::kLog2e};
}

bool valid_call(int b, int tq, int tk, int h, int hkv, int d, int causal, bool rope) {
  return b >= 1 && tq >= 1 && tk >= 1 && hkv >= 1 && h % hkv == 0 && d >= 64 && d % 64 == 0 &&
         !(causal && tq != tk) && !(rope && tq != tk) && tq <= 65535 * kTile && h <= 65535 && b <= 65535;
}

void contiguous_strides(long long (&s)[3], int t, int heads, int d) {
  s[0] = static_cast<long long>(t) * heads * d;
  s[1] = static_cast<long long>(heads) * d;
  s[2] = d;
}

template <typename T>
cudaError_t fwd_wide(const void* q, const void* k, const void* v, const int* mask, void* out, float* lse,
                     const float* cos_t, const float* sin_t, void* q_rot, void* k_rot, const Geometry& g,
                     const long long* qs, const long long* ks, const long long* vs, cudaStream_t st) {
  // bf16 on the tensor cores, f32 on the CUDA cores
  constexpr bool tc = std::is_same<T, bf16>::value;
  static unsigned long long configured = 0;
  cudaError_t err;
  if constexpr (tc)
    err = slam::configure_smem(fwd_tc_kernel, kFwdTcSmem, configured);
  else
    err = slam::configure_smem(fwd_fma_kernel, kFwdSmem, configured);
  if (err != cudaSuccess) return err;
  FwdArgs<T> p{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
               static_cast<T*>(out), lse, {qs[0], qs[1], qs[2]}, {ks[0], ks[1], ks[2]}, {vs[0], vs[1], vs[2]}, g};
  if (cos_t != nullptr) {
    if ((err = slam::launch_rope(p.q, static_cast<T*>(q_rot), cos_t, sin_t, g.b, g.tq, g.h, g.d, qs[0], qs[1], qs[2],
                                 st)) != cudaSuccess ||
        (err = slam::launch_rope(p.k, static_cast<T*>(k_rot), cos_t, sin_t, g.b, g.tk, g.hkv, g.d, ks[0], ks[1], ks[2],
                                 st)) != cudaSuccess)
      return err;
    p.q = static_cast<const T*>(q_rot);
    p.k = static_cast<const T*>(k_rot);
    contiguous_strides(p.qs, g.tq, g.h, g.d);
    contiguous_strides(p.ks, g.tk, g.hkv, g.d);
  }
  const dim3 grid((g.tq + kTile - 1) / kTile, g.h, g.b);
  if constexpr (tc)
    fwd_tc_kernel<<<grid, kThreads, kFwdTcSmem, st>>>(p);
  else
    fwd_fma_kernel<<<grid, kThreads, kFwdSmem, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_wide(const void* q, const void* k, const void* v, const int* mask, const void* out, const void* dout,
                     const float* lse, const float* cos_t, const float* sin_t, void* q_rot, void* k_rot,
                     float* delta, float* dq32, float* dk32, float* dv32, void* dq, void* dk, void* dv,
                     const Geometry& g, const long long* qs, const long long* ks, const long long* vs,
                     const long long* os, const long long* gs, cudaStream_t st) {
  constexpr bool tc = std::is_same<T, bf16>::value;
  static unsigned long long done_dq = 0, done_dkv = 0;
  cudaError_t err;
  if constexpr (tc) {
    err = slam::configure_smem(dq_tc_kernel, kDqTcSmem, done_dq);
    if (err == cudaSuccess) err = slam::configure_smem(dkv_tc_kernel, kDkvTcSmem, done_dkv);
  } else {
    err = slam::configure_smem(dq_fma_kernel, kDqSmem, done_dq);
    if (err == cudaSuccess) err = slam::configure_smem(dkv_fma_kernel, kDkvSmem, done_dkv);
  }
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(g.b) * g.tq * g.h;
  delta_wide_kernel<T><<<blocks_for(rows, 8), 256, 0, st>>>(static_cast<const T*>(out), static_cast<const T*>(dout),
                                                            delta, g.b, g.tq, g.h, g.d, os[0], os[1], os[2], gs[0],
                                                            gs[1], gs[2]);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  BwdArgs<T> p{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
               static_cast<const T*>(out), static_cast<const T*>(dout), mask, lse, delta, dq32, dk32, dv32,
               {qs[0], qs[1], qs[2]}, {ks[0], ks[1], ks[2]}, {vs[0], vs[1], vs[2]}, {gs[0], gs[1], gs[2]}, g};
  if (cos_t != nullptr) {
    if ((err = slam::launch_rope(p.q, static_cast<T*>(q_rot), cos_t, sin_t, g.b, g.tq, g.h, g.d, qs[0], qs[1], qs[2],
                                 st)) != cudaSuccess ||
        (err = slam::launch_rope(p.k, static_cast<T*>(k_rot), cos_t, sin_t, g.b, g.tk, g.hkv, g.d, ks[0], ks[1], ks[2],
                                 st)) != cudaSuccess)
      return err;
    p.q = static_cast<const T*>(q_rot);
    p.k = static_cast<const T*>(k_rot);
    contiguous_strides(p.qs, g.tq, g.h, g.d);
    contiguous_strides(p.ks, g.tk, g.hkv, g.d);
  }
  const dim3 dq_grid((g.tq + kTile - 1) / kTile, g.h * ((g.d + kDqCols - 1) / kDqCols), g.b);
  if constexpr (tc)
    dq_tc_kernel<<<dq_grid, kThreads, kDqTcSmem, st>>>(p);
  else
    dq_fma_kernel<<<dq_grid, kThreads, kDqSmem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 dkv_grid((g.tk + kTile - 1) / kTile, g.hkv * ((g.d + kDkvCols - 1) / kDkvCols), g.b);
  if constexpr (tc)
    dkv_tc_kernel<<<dkv_grid, kThreads, kDkvTcSmem, st>>>(p);
  else
    dkv_fma_kernel<<<dkv_grid, kThreads, kDkvSmem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // to the outputs' dtype, dq / dk through R^T with fused RoPE (skipped
  // where the f32 accumulators are the outputs)
  const float* fins[3] = {dq32, dk32, dv32};
  void* outs[3] = {dq, dk, dv};
  const int ts[3] = {g.tq, g.tk, g.tk}, hs[3] = {g.h, g.hkv, g.hkv};
  for (int i = 0; i < 3; ++i) {
    if (static_cast<const void*>(fins[i]) == outs[i]) continue;
    const long long row = static_cast<long long>(hs[i]) * g.d;
    err = slam::launch_rope(fins[i], static_cast<T*>(outs[i]), i < 2 ? cos_t : nullptr, sin_t, g.b, ts[i], hs[i], g.d,
                            ts[i] * row, row, g.d, st, /*inverse=*/true);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// q (B, Tq, H, D), k / v (B, Tk, Hkv, D) of one dtype (f32 = 1: float, else
// bf16) with strides (batch, position, head) in elements (multiples of 4,
// last dim contiguous, bases 4-element aligned), mask (B, Tk) int32, out
// (B, Tq, H, D) and lse (B, Tq, H) f32 contiguous; cos / sin (B, T, D/2)
// f32 or null, and then q_rot / k_rot contiguous scratch in q's dtype. Any
// D % 64 == 0.
extern "C" int slam_flash_fwd_wide(const void* q, const void* k, const void* v, const void* mask, void* out,
                                   void* lse, const void* cos_t, const void* sin_t, void* q_rot, void* k_rot, int b,
                                   int tq, int tk, int h, int hkv, int d, long long qsb, long long qst, long long qsh,
                                   long long ksb, long long kst, long long ksh, long long vsb, long long vst,
                                   long long vsh, float scale, int causal, int f32, void* stream) {
  const bool rope = cos_t != nullptr;
  if (!valid_call(b, tq, tk, h, hkv, d, causal, rope) ||
      (rope && (sin_t == nullptr || q_rot == nullptr || k_rot == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(b, tq, tk, h, hkv, d, scale, causal);
  const long long qs[3] = {qsb, qst, qsh}, ks[3] = {ksb, kst, ksh}, vs[3] = {vsb, vst, vsh};
  const int* m = static_cast<const int*>(mask);
  const float *cs = static_cast<const float*>(cos_t), *sn = static_cast<const float*>(sin_t);
  float* l = static_cast<float*>(lse);
  const cudaError_t err =
      f32 ? fwd_wide<float>(q, k, v, m, out, l, cs, sn, q_rot, k_rot, g, qs, ks, vs, st)
          : fwd_wide<__nv_bfloat16>(q, k, v, m, out, l, cs, sn, q_rot, k_rot, g, qs, ks, vs, st);
  return static_cast<int>(err);
}

// The backward: q / k / v / out / dout as the forward's q (strides of
// each), lse (B, Tq, H) f32, delta (B, Tq, H) f32 scratch, dq32 / dk32 /
// dv32 f32 (B, T, H, D) contiguous accumulators, dq / dk / dv (B, T, H, D)
// contiguous in the inputs' dtype (an f32 output may be its accumulator:
// then no finishing pass); cos / sin and q_rot / k_rot as the forward's.
extern "C" int slam_flash_bwd_wide(const void* q, const void* k, const void* v, const void* mask, const void* out,
                                   const void* dout, const void* lse, const void* cos_t, const void* sin_t,
                                   void* q_rot, void* k_rot, void* delta, void* dq32, void* dk32, void* dv32,
                                   void* dq, void* dk, void* dv, int b, int tq, int tk, int h, int hkv, int d,
                                   long long qsb, long long qst, long long qsh, long long ksb, long long kst,
                                   long long ksh, long long vsb, long long vst, long long vsh, long long osb,
                                   long long ost, long long osh, long long gsb, long long gst, long long gsh,
                                   float scale, int causal, int f32, void* stream) {
  const bool rope = cos_t != nullptr;
  if (!valid_call(b, tq, tk, h, hkv, d, causal, rope) ||
      (rope && (sin_t == nullptr || q_rot == nullptr || k_rot == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(b, tq, tk, h, hkv, d, scale, causal);
  const long long qs[3] = {qsb, qst, qsh}, ks[3] = {ksb, kst, ksh}, vs[3] = {vsb, vst, vsh};
  const long long os[3] = {osb, ost, osh}, gs[3] = {gsb, gst, gsh};
  const int* m = static_cast<const int*>(mask);
  const float *cs = static_cast<const float*>(cos_t), *sn = static_cast<const float*>(sin_t);
  const float* l = static_cast<const float*>(lse);
  float *dl = static_cast<float*>(delta), *a = static_cast<float*>(dq32), *bk = static_cast<float*>(dk32),
        *bv = static_cast<float*>(dv32);
  const cudaError_t err =
      f32 ? bwd_wide<float>(q, k, v, m, out, dout, l, cs, sn, q_rot, k_rot, dl, a, bk, bv, dq, dk, dv, g, qs, ks, vs,
                            os, gs, st)
          : bwd_wide<__nv_bfloat16>(q, k, v, m, out, dout, l, cs, sn, q_rot, k_rot, dl, a, bk, bv, dq, dk, dv, g, qs,
                                    ks, vs, os, gs, st);
  return static_cast<int>(err);
}
