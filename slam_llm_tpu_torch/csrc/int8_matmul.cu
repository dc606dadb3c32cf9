// K3: s8 x s8 -> s32 GEMM with the W8A8 scale epilogue fused in.
//
// Replaces the s8 products that XLA computes on the TPU in
// slam_llm_tpu/ops/quant.py (_s8_dot and _fwd_value, :103-119; the dx
// products of _int8_dx_rot and _int8_dx, :141-166) and in the int8 CE head
// (ops/fused_ce.py, the logits :115-121 and their dx :187-195):
//   out[m, n] = (float)(sum_k xq[m, k] * wq[n, k]) * xs[m] * ws[n]
// written as bf16 or f32. xq (M, K) and wq (N, K) are both K-contiguous
// ("TN"), the only layout wgmma takes for 8-bit operands; the dx products
// read a stored transpose of the weight for that reason.
//
// Bound on the H100 (1,979 TOP/s int8, 3.35 TB/s): at training and prefill
// M (3584-8192 rows) the int8 tensor cores, e.g. 0.096 ms for the dx
// (8192, 5632 -> 2048) and 0.048 ms for the forward (4096, 2048 -> 5632); at
// decode M (8 or 32 rows) the bytes of wq, read once: 3.4 us for (32, 2048 ->
// 5632). Two code paths behind one entry point, chosen by the caller's
// planner (ops/quant.py::plan_int8_matmul):
//
// * wgmma (M >= 128): a persistent kernel, one block per SM, walks output
//   tiles of 128 x 256 in groups of 8 M-tiles (the A rows and B columns of a
//   group stay in L2). Warpgroup 2 is the producer: one thread keeps TMA
//   loads of the A (128 x 128 B) and B (256 x 128 B) K-slices in flight in a
//   ring of 3 stages under mbarriers, with the 128-byte swizzle; TMA's zero
//   fill is the edge mask for ragged M, N and K. Warpgroups 0 and 1 each own
//   64 rows of the tile and run wgmma.m64n256k32.s32.s8.s8 from shared memory,
//   one commit group in flight, with setmaxnreg moving registers from the
//   producer (40) to them (232: 128 accumulators each). The epilogue stages
//   each warpgroup's scaled rows in shared memory and stores them as whole
//   512-byte row segments (stores straight from the accumulator layout, 16
//   bytes per row per instruction, cost ~6 us per tile). Where the tiles do
//   not fill the card and K is long (the CE head's dx, N = 2048, K = 32000)
//   the planner splits K as well.
// * split-K (M < 128): the card is filled along K instead. Blocks of
//   BM (16, 32 or 64) x 64 outputs each take a contiguous share of the K
//   slices and run mma.sync.m16n8k32; the bound is the bytes of wq, which
//   the grid streams once. One thread loads the A and B slices with TMA
//   (the 128-byte swizzle; the fragment reads undo it) into a ring of up to
//   6 stages (4 at 64-row tiles); the planner cuts K so that a block's share
//   fits the ring, loaded all at once (one round trip to memory), and the
//   ring is sized to the share, so an SM holds more blocks. (16-byte
//   cp.async loads streamed the weight at about 1 TB/s, with or without the
//   products.)
//
// A split product stays one launch. On the wgmma path each split stores its
// s32 partial sums, and the split that finishes a tile last (a counter per
// tile) adds the others' to its own, in split order, and writes the output;
// the planner splits only long K there (the CE head's dx). On the split-K
// path the splits of a tile are one thread-block cluster: each block owns a
// share of the tile's rows, every split stores its sums for them into the
// owner's shared memory (distributed shared memory), and after one cluster
// barrier each owner adds them in split order. (Pulling the sums across
// instead cost 2.5-4 us a call: one remote-read latency per split.)
// Integer addition is exact and order-free, so every tiling and every split
// reaches the epilogue with the same integer (K <= 32000 keeps |acc| <=
// 5.2e8 < 2^31), and two runs are bit-identical. The epilogue converts acc to
// f32 with round-to-nearest and multiplies the row scale, then the column
// scale, the order _fwd_value uses: f32 output is bit-exact against a float64
// reference, bf16 within its one rounding. Both kernels load the scales
// before their main loop, so no output store waits on a load.
//
// The TMA descriptors are encoded per call (hopper.cuh: cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint(ByVersion), so the library links no
// libcuda).

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using slam::desc_kmajor;
using slam::mbar_arrive;
using slam::mbar_expect_tx;
using slam::mbar_init;
using slam::mbar_wait;
using slam::smem_u32;
using slam::tma_load_2d;
using slam::wgmma_commit;
using slam::wgmma_fence;
using slam::wgmma_wait;

// Every thread of both kernels holds its results as pairs of neighbouring
// columns (col even). These move one pair, masked by N, as one vector access
// where N is even (the pair is then aligned) and element by element otherwise.
__device__ __forceinline__ void put_pair(int* p, int n, int col, int v0, int v1) {
  if ((n & 1) == 0 && col + 1 < n) {
    *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
  } else {
    if (col < n) p[0] = v0;
    if (col + 1 < n) p[1] = v1;
  }
}

// adds a pair written by other blocks of this launch (read through L2)
__device__ __forceinline__ void add_pair(const int* p, int n, int col, int& v0, int& v1) {
  if ((n & 1) == 0 && col + 1 < n) {
    const int2 v = __ldcg(reinterpret_cast<const int2*>(p));
    v0 += v.x;
    v1 += v.y;
  } else {
    if (col < n) v0 += __ldcg(p);
    if (col + 1 < n) v1 += __ldcg(p + 1);
  }
}

__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }

__device__ __forceinline__ void out_pair(__nv_bfloat16* p, int n, int col, float v0, float v1) {
  if ((n & 1) == 0 && col + 1 < n) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < n) p[0] = __float2bfloat16_rn(v0);
    if (col + 1 < n) p[1] = __float2bfloat16_rn(v1);
  }
}

__device__ __forceinline__ void out_pair(float* p, int n, int col, float v0, float v1) {
  if ((n & 1) == 0 && col + 1 < n) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (col < n) p[0] = v0;
    if (col + 1 < n) p[1] = v1;
  }
}

// ---------------------------------------------------------------------------
// wgmma path
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128, WG_BN = 256, WG_BK = 128;  // BK in bytes = int8 elements
constexpr int WG_STAGES = 3;
constexpr int WG_GROUP_M = 8;
constexpr int WG_THREADS = 384;  // two consumer warpgroups, then the producer warpgroup
constexpr int WG_A_BYTES = WG_BM * WG_BK;
constexpr int WG_B_BYTES = WG_BN * WG_BK;
// each consumer warpgroup stages 64 output rows of 512 bytes (256 bf16 or 128
// f32 columns per pass); the 16-byte pad per row keeps the fragment writes
// free of bank conflicts
constexpr int WG_STG_PITCH = 512 + 16;
constexpr int WG_STG_BYTES = 64 * WG_STG_PITCH;
constexpr int WG_SMEM = WG_STAGES * (WG_A_BYTES + WG_B_BYTES) + 2 * WG_STG_BYTES + 2 * WG_STAGES * 8 + 1024;

struct WgParams {
  const float* xs;
  const float* ws;
  void* out;
  int* partials;  // (splits, M, N) s32 partial sums, when splits > 1
  int* counters;  // one per output tile, 0 at rest, when splits > 1
  int m, n;
  int m_tiles, n_tiles, k_tiles_per_split, splits, units;
};

// d[64 x 256] (+)= A[64 x 32] * B[256 x 32]^T, both K-major int8 in shared memory
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// unit -> (M tile, N tile, split): consecutive units take the splits of one
// tile, then the tiles of a group of WG_GROUP_M M-tiles, M fastest
__device__ __forceinline__ void wg_unit(const WgParams& p, int unit, int& mt, int& nt, int& split) {
  const int tile = unit / p.splits;
  split = unit - tile * p.splits;
  const int per_group = WG_GROUP_M * p.n_tiles;
  const int first_m = (tile / per_group) * WG_GROUP_M;
  const int gsize = min(p.m_tiles - first_m, WG_GROUP_M);
  const int local = tile % per_group;
  mt = first_m + local % gsize;
  nt = local / gsize;
}

// the two consumer warpgroups only (named barrier 1; the producer never joins)
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }
// one consumer warpgroup (named barriers 2 and 3)
__device__ __forceinline__ void warpgroup_sync(int wg) { asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory"); }

__device__ __forceinline__ void stage_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void stage_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

template <typename OutT>
__global__ void __launch_bounds__(WG_THREADS, 1)
    int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
                             const WgParams p) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to that
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;
  uint8_t* sb = smem + WG_STAGES * WG_A_BYTES;
  uint8_t* staging = sb + WG_STAGES * WG_B_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * WG_STG_BYTES);
  uint64_t* empty = full + WG_STAGES;
  __shared__ int last;  // this block finishes the tile's split sum
  __shared__ float s_ws[WG_BN], s_xs[WG_BM];  // the unit's column and row scales
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tma_a)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tma_b)) : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int unit = blockIdx.x; unit < p.units; unit += gridDim.x) {
        int mt, nt, split;
        wg_unit(p, unit, mt, nt, split);
        const int kt0 = split * p.k_tiles_per_split;
        for (int kt = 0; kt < p.k_tiles_per_split; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], WG_A_BYTES + WG_B_BYTES);
          tma_load_2d(sa + stage * WG_A_BYTES, &tma_a, &full[stage], (kt0 + kt) * WG_BK, mt * WG_BM);
          tma_load_2d(sb + stage * WG_B_BYTES, &tma_b, &full[stage], (kt0 + kt) * WG_BK, nt * WG_BN);
          if (++stage == WG_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x & 127, lane = t & 31, warp = t >> 5;
    int stage = 0;
    uint32_t phase = 0;
    int d[128];
    for (int unit = blockIdx.x; unit < p.units; unit += gridDim.x) {
      int mt, nt, split;
      wg_unit(p, unit, mt, nt, split);
      // the unit's scales, loaded now and held until the epilogue: their
      // latency hides behind the main loop
      const int cw = nt * WG_BN + threadIdx.x, rx = mt * WG_BM + threadIdx.x;
      const float wv = cw < p.n ? __ldg(p.ws + cw) : 0.f;
      const float xv = threadIdx.x < WG_BM && rx < p.m ? __ldg(p.xs + rx) : 0.f;
      int prev = 0;
      for (int kt = 0; kt < p.k_tiles_per_split; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint64_t da = desc_kmajor(sa + stage * WG_A_BYTES + wg * 64 * WG_BK);
        const uint64_t db = desc_kmajor(sb + stage * WG_B_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 32; ++kk)  // +32 bytes along K = +2 in 16-byte units
          wgmma_m64n256k32(d, da + 2 * kk, db + 2 * kk, (kt > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        if (kt > 0) {
          wgmma_wait<1>();  // the previous stage's products are done: release it
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == WG_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);

      // d[4 j + 2 h + e] is (row 16 warp + lane / 4 + 8 h, col 8 j + 2 (lane % 4) + e) of the warpgroup's rows
      const int row0 = mt * WG_BM + wg * 64 + warp * 16 + (lane >> 2);
      const int col0 = nt * WG_BN + 2 * (lane & 3);
      if (p.splits > 1) {
        // every split stores its partial sums; the last to finish adds the
        // others' to its own, in split order, and writes the output
        const long long mn = static_cast<long long>(p.m) * p.n;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row >= p.m) continue;
          int* dst = p.partials + split * mn + static_cast<long long>(row) * p.n + col0;
#pragma unroll
          for (int j = 0; j < 32; ++j) put_pair(dst + 8 * j, p.n, col0 + 8 * j, d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        }
        __threadfence();
        consumer_sync();
        const int tile = unit / p.splits;
        if (threadIdx.x == 0) last = atomicAdd(p.counters + tile, 1) == p.splits - 1;
        consumer_sync();
        if (!last) continue;
        __threadfence();
#pragma unroll 1
        for (int s = 0; s < p.splits; ++s) {
          if (s == split) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + 8 * h;
            if (row >= p.m) continue;
            const int* src = p.partials + s * mn + static_cast<long long>(row) * p.n + col0;
#pragma unroll
            for (int j = 0; j < 32; ++j) add_pair(src + 8 * j, p.n, col0 + 8 * j, d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
          }
        }
        if (threadIdx.x == 0) p.counters[tile] = 0;
      }
      consumer_sync();  // every thread is done with the last unit's scales
      s_ws[threadIdx.x] = wv;
      if (threadIdx.x < WG_BM) s_xs[threadIdx.x] = xv;
      consumer_sync();
      const int lr = wg * 64 + warp * 16 + (lane >> 2), lc = 2 * (lane & 3);  // within the tile
      const float sx[2] = {s_xs[lr], s_xs[lr + 8]};
      // scaled results go through the warpgroup's staging rows, then out in
      // whole 512-byte row segments, 16 bytes a thread
      constexpr int kPassCols = 512 / static_cast<int>(sizeof(OutT));
      constexpr int kChunk = 16 / static_cast<int>(sizeof(OutT));  // columns per 16-byte store
      uint8_t* stg = staging + wg * WG_STG_BYTES;
      OutT* out = static_cast<OutT*>(p.out);
      const bool vec = (static_cast<long long>(p.n) * sizeof(OutT)) % 16 == 0;
#pragma unroll
      for (int pass = 0; pass < WG_BN / kPassCols; ++pass) {
        warpgroup_sync(wg);  // the last pass's (or unit's) rows are out
#pragma unroll
        for (int jj = 0; jj < kPassCols / 8; ++jj) {
          const int j = pass * (kPassCols / 8) + jj;
          const float w0 = s_ws[lc + 8 * j], w1 = s_ws[lc + 8 * j + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            stage_pair(reinterpret_cast<OutT*>(stg + (lr - wg * 64 + 8 * h) * WG_STG_PITCH) + 8 * jj + lc,
                       static_cast<float>(d[4 * j + 2 * h]) * sx[h] * w0,
                       static_cast<float>(d[4 * j + 2 * h + 1]) * sx[h] * w1);
        }
        warpgroup_sync(wg);
#pragma unroll 4
        for (int c = t; c < 64 * 32; c += 128) {  // (row, 16-byte chunk) of the staged rows
          const int row = mt * WG_BM + wg * 64 + (c >> 5);
          const int col = nt * WG_BN + pass * kPassCols + (c & 31) * kChunk;
          if (row >= p.m || col >= p.n) continue;
          const uint8_t* src = stg + (c >> 5) * WG_STG_PITCH + (c & 31) * 16;
          OutT* dst = out + static_cast<long long>(row) * p.n + col;
          if (vec && col + kChunk <= p.n) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          } else {
            for (int e = 0; e < kChunk && col + e < p.n; ++e) dst[e] = reinterpret_cast<const OutT*>(src)[e];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// split-K path (small M)
// ---------------------------------------------------------------------------

constexpr int SK_BN = 64, SK_BK = 128;
constexpr int SK_NJ = SK_BN / 32;  // n8 fragments per warp: warp w owns SK_BN / 4 columns
// ring stages: 6, or 4 for 64-row tiles, whose 6-stage ring (with a split's
// receive buffer) would leave room for one block an SM
__host__ __device__ constexpr int sk_stages(int bm) { return bm == 64 ? 4 : 6; }
constexpr int SK_MAX_SPLITS = 16;  // a split product is one cluster (above 8: a non-portable size)
constexpr int SK_THREADS = 128;

// rows of the tile whose split sums one block of the cluster adds up
__host__ __device__ constexpr int sk_rows_per_owner(int bm, int splits) { return (bm + splits - 1) / splits; }

// shared memory of a split-K block with a ring of `stages` slices: the A and
// B tiles (128-byte rows under the 128-byte swizzle), a split product's
// receive buffer (each split's sums for the rows this block owns), one
// mbarrier a stage, and room to align the ring to the swizzle's 1024 bytes
constexpr int sk_smem_bytes(int bm, int stages, int splits) {
  return stages * (bm + SK_BN) * SK_BK + (splits > 1 ? splits * sk_rows_per_owner(bm, splits) * SK_BN * 4 : 0) +
         stages * 8 + 1024;
}
// the most any split count asks for: splits x ceil(bm / splits) < bm + splits
constexpr int sk_smem_limit(int bm) {
  return sk_stages(bm) * (bm + SK_BN) * SK_BK + (bm + SK_MAX_SPLITS) * SK_BN * 4 + sk_stages(bm) * 8 + 1024;
}

struct SkParams {
  const float* xs;
  const float* ws;
  void* out;
  int m, n, k, k_tiles_per_split, splits;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8 x 16-byte matrices from shared memory, lane l giving the row
// address of matrix l / 8: for 8-bit operands these are the m16n8k32
// fragments (row l / 4, bytes 4 (l % 4) .. +3 of each)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// blockIdx.x: SK_BN output columns, .y: BM rows, .z: the split's share of
// K; the splits of a tile are one cluster. Thread 0 loads the block's K
// slices with TMA, all at once when they fit the ring of sk_stages (else
// through it). Warp w owns columns [w SK_BN / 4, (w + 1) SK_BN / 4) of the
// tile and all BM rows.
template <int BM, typename OutT>
__global__ void __launch_bounds__(SK_THREADS)
    int8_matmul_splitk_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
                              const SkParams p) {
  extern __shared__ uint8_t sk_raw[];
  uint8_t* sk_smem = sk_raw + ((1024 - (smem_u32(sk_raw) & 1023)) & 1023);
  const int kt0 = blockIdx.z * p.k_tiles_per_split, nk = p.k_tiles_per_split;
  const int ring = nk < sk_stages(BM) ? nk : sk_stages(BM);  // stages the launch sized shared memory for
  const int rows_per = sk_rows_per_owner(BM, p.splits);
  int8_t* As = reinterpret_cast<int8_t*>(sk_smem);
  int8_t* Bs = As + ring * BM * SK_BK;
  int* recv = reinterpret_cast<int*>(Bs + ring * SK_BN * SK_BK);  // [split][owned row][SK_BN], splits > 1
  uint64_t* bars = reinterpret_cast<uint64_t*>(recv + (p.splits > 1 ? p.splits * rows_per * SK_BN : 0));
  constexpr int MI = BM / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * SK_BN;

  auto load = [&](int stage, int kt) {  // thread 0 only
    mbar_expect_tx(&bars[stage], (BM + SK_BN) * SK_BK);
    tma_load_2d(As + stage * BM * SK_BK, &tma_a, &bars[stage], kt * SK_BK, m0);
    tma_load_2d(Bs + stage * SK_BN * SK_BK, &tma_b, &bars[stage], kt * SK_BK, n0);
  };
  if (tid == 0) {
    for (int s = 0; s < ring; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < ring; ++s) load(s, kt0 + s);
  }
  // a split product writes into other blocks' shared memory at the end; this
  // arrival (waited on there) shows that every block of the cluster runs
  if (p.splits > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // the block's scales, loaded while the slices are in flight: into
  // registers for the fragment epilogue, into shared memory for a split's
  __shared__ float s_xs[BM], s_ws[SK_BN];
  if (tid < BM) s_xs[tid] = m0 + tid < p.m ? __ldg(p.xs + m0 + tid) : 0.f;
  if (tid < SK_BN) s_ws[tid] = n0 + tid < p.n ? __ldg(p.ws + n0 + tid) : 0.f;
  const int col0 = n0 + warp * (SK_BN / 4) + 2 * t;
  float w[SK_NJ][2], sx[MI][2];
#pragma unroll
  for (int j = 0; j < SK_NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) w[j][e] = col0 + 8 * j + e < p.n ? __ldg(p.ws + col0 + 8 * j + e) : 0.f;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + mi * 16 + g + 8 * h;
      sx[mi][h] = row < p.m ? __ldg(p.xs + row) : 0.f;
    }

  int acc[MI][SK_NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < SK_NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  __syncthreads();  // the barriers and the shared scales are set

  for (int i = 0; i < nk; ++i) {
    const int stage = i % ring;
    mbar_wait(&bars[stage], (i / ring) & 1);
    const int8_t* as = As + stage * BM * SK_BK;
    const int8_t* bs = Bs + stage * SK_BN * SK_BK;
#pragma unroll
    for (int kk = 0; kk < SK_BK / 32; ++kk) {
      // TMA's 128-byte swizzle XORs a row's 16-byte chunk index with row % 8,
      // which is lane % 8 for every row a lane addresses here
      const int swz_a = ((2 * kk + (lane >> 4)) ^ (lane & 7)) << 4;
      const int swz_b = ((2 * kk + ((lane >> 3) & 1)) ^ (lane & 7)) << 4;
      uint32_t a[MI][4], b[SK_NJ / 2][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)  // matrices: rows 0-7 / 8-15, K bytes 0-15 / 16-31
        ldmatrix_x4(a[mi], as + (mi * 16 + (lane & 15)) * SK_BK + swz_a);
#pragma unroll
      for (int jj = 0; jj < SK_NJ / 2; ++jj)  // matrices: (n8 fragment 2 jj, then 2 jj + 1) x K halves
        ldmatrix_x4(b[jj], bs + (warp * (SK_BN / 4) + jj * 16 + ((lane >> 4) << 3) + (lane & 7)) * SK_BK + swz_b);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int j = 0; j < SK_NJ; ++j) {
          const uint32_t bj[2] = {b[j / 2][2 * (j % 2)], b[j / 2][2 * (j % 2) + 1]};
          mma_s8(acc[mi][j], a[mi], bj);
        }
    }
    if (i + ring < nk) {  // refill this stage once every warp is done with it
      __syncthreads();
      if (tid == 0) load(stage, kt0 + i + ring);
    }
  }

  // acc[mi][j][2 h + e] is (row m0 + 16 mi + g + 8 h, col n0 + (SK_BN / 4) warp + 8 j + 2 t + e)
  if (p.splits > 1) {
    // block r of the cluster owns rows [r rows_per, (r + 1) rows_per) of the
    // tile: every split stores its sums for those rows into the owner's
    // receive buffer (distributed shared memory, no waiting on the stores),
    // one cluster barrier, then each owner adds its rows over the splits in
    // split order and writes them out
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const int split = static_cast<int>(cluster.block_rank());
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mi * 16 + g + 8 * h, owner = r / rows_per;
        int* dst = cluster.map_shared_rank(recv, owner) + (split * rows_per + r - owner * rows_per) * SK_BN;
#pragma unroll
        for (int j = 0; j < SK_NJ; ++j)
          *reinterpret_cast<int2*>(dst + warp * (SK_BN / 4) + 8 * j + 2 * t) =
              make_int2(acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
      }
    cluster.sync();
    OutT* out = static_cast<OutT*>(p.out);
    const int r0 = split * rows_per;
    for (int i = tid; i < rows_per * SK_BN; i += SK_THREADS) {
      const int lr = i / SK_BN, c = i % SK_BN, row = m0 + r0 + lr, col = n0 + c;
      if (r0 + lr >= BM || row >= p.m || col >= p.n) continue;
      int sum = 0;
      for (int b = 0; b < p.splits; ++b) sum += recv[(b * rows_per + lr) * SK_BN + c];
      store_one(out + static_cast<long long>(row) * p.n + col,
                static_cast<float>(sum) * s_xs[r0 + lr] * s_ws[c]);
    }
    return;
  }
  OutT* out = static_cast<OutT*>(p.out);
#pragma unroll
  for (int j = 0; j < SK_NJ; ++j)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + mi * 16 + g + 8 * h;
        if (row >= p.m) continue;
        out_pair(out + static_cast<long long>(row) * p.n + col0 + 8 * j, p.n, col0 + 8 * j,
                 static_cast<float>(acc[mi][j][2 * h]) * sx[mi][h] * w[j][0],
                 static_cast<float>(acc[mi][j][2 * h + 1]) * sx[mi][h] * w[j][1]);
      }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// a (rows, k) int8 row-major operand, loaded as boxes of box_rows x 128 bytes
bool encode_operand(CUtensorMap* map, const void* base, int rows, int k, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};  // bytes between rows
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(WG_BK), static_cast<cuuint32_t>(box_rows)};
  return slam::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims, strides, box);
}

// a kernel's launch attributes, set once per device (one bit each in `done`)
template <typename Kernel>
cudaError_t configure(Kernel kernel, int smem_bytes, bool large_clusters, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done >> dev & 1ull)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess && large_clusters)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done |= 1ull << dev;
  return err;
}

template <typename OutT>
cudaError_t launch_wgmma(const void* xq, const void* wq, const WgParams& p, int k, int sms, cudaStream_t st) {
  static unsigned long long configured = 0;
  const cudaError_t err = configure(int8_matmul_wgmma_kernel<OutT>, WG_SMEM, false, configured);
  if (err != cudaSuccess) return err;
  CUtensorMap ta, tb;
  if (!encode_operand(&ta, xq, p.m, k, WG_BM) || !encode_operand(&tb, wq, p.n, k, WG_BN))
    return cudaErrorInvalidValue;
  const int grid = p.units < sms ? p.units : sms;
  int8_matmul_wgmma_kernel<OutT><<<grid, WG_THREADS, WG_SMEM, st>>>(ta, tb, p);
  return cudaGetLastError();
}

template <int BM, typename OutT>
cudaError_t launch_splitk(const void* xq, const void* wq, const SkParams& p, cudaStream_t st) {
  // the ring holds the block's share of K, or sk_stages slices of it: the
  // less shared memory, the more blocks an SM takes at once
  const int stages = p.k_tiles_per_split < sk_stages(BM) ? p.k_tiles_per_split : sk_stages(BM);
  static unsigned long long configured = 0;
  const cudaError_t err =
      configure(int8_matmul_splitk_kernel<BM, OutT>, sk_smem_limit(BM), true, configured);
  if (err != cudaSuccess) return err;
  CUtensorMap ta, tb;
  if (!encode_operand(&ta, xq, p.m, p.k, BM) || !encode_operand(&tb, wq, p.n, p.k, SK_BN))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.n + SK_BN - 1) / SK_BN, (p.m + BM - 1) / BM, p.splits);
  cfg.blockDim = dim3(SK_THREADS);
  cfg.dynamicSmemBytes = sk_smem_bytes(BM, stages, p.splits);
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = p.splits;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int8_matmul_splitk_kernel<BM, OutT>, ta, tb, p);
}

template <typename OutT>
cudaError_t run(const void* xq, const void* wq, const float* xs, const float* ws, void* out, int* scratch,
                int* counters, int m, int n, int k, int path, int bm, int splits, int sms, cudaStream_t st) {
  const int k_tiles = (k + 127) / 128;
  if (path == 0) {
    WgParams p{xs, ws, out, scratch, counters, m, n, (m + WG_BM - 1) / WG_BM, (n + WG_BN - 1) / WG_BN,
               k_tiles / splits, splits, 0};
    p.units = p.m_tiles * p.n_tiles * splits;
    return launch_wgmma<OutT>(xq, wq, p, k, sms, st);
  }
  const SkParams p{xs, ws, out, m, n, k, k_tiles / splits, splits};
  if (bm == 16) return launch_splitk<16, OutT>(xq, wq, p, st);
  if (bm == 32) return launch_splitk<32, OutT>(xq, wq, p, st);
  return launch_splitk<64, OutT>(xq, wq, p, st);
}

}  // namespace

// One K3 call, one launch. path 0: wgmma, bm must be 128 (tile 128 x 256 x
// 128 bytes); path 1: split-K, bm 16, 32 or 64 (tile bm x 64 x 128 bytes).
// splits must divide the number of 128-byte K slices, and be at most 16 on
// path 1. Path 0 with splits > 1 needs scratch, (splits, m, n) s32 of any
// content, and counters, one s32 per output tile that is 0 before the call
// and 0 again after it (calls that share them must not run concurrently).
// sms: the card's SM count (the persistent grid). Returns a cudaError_t.
extern "C" int slam_int8_matmul(const void* xq, const void* wq, const void* xs, const void* ws, void* out,
                                void* scratch, void* counters, int m, int n, int k, int out_f32, int path, int bm,
                                int splits, int sms, void* stream) {
  const int k_tiles = (k + 127) / 128;
  const bool ok = m > 0 && n > 0 && k > 0 && k % 16 == 0 && splits >= 1 && k_tiles % splits == 0 && sms > 0 &&
                  ((path == 0 && bm == WG_BM && (splits == 1 || (scratch != nullptr && counters != nullptr))) ||
                   (path == 1 && (bm == 16 || bm == 32 || bm == 64) && splits <= SK_MAX_SPLITS));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sa = static_cast<const float*>(xs);
  const float* sb = static_cast<const float*>(ws);
  int* scr = static_cast<int*>(scratch);
  int* count = static_cast<int*>(counters);
  const cudaError_t err =
      out_f32 ? run<float>(xq, wq, sa, sb, out, scr, count, m, n, k, path, bm, splits, sms, st)
              : run<__nv_bfloat16>(xq, wq, sa, sb, out, scr, count, m, n, k, path, bm, splits, sms, st);
  return static_cast<int>(err);
}
