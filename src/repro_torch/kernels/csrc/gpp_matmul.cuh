// The FMA route of gpp_matmul and gpp_matmul_grouped for sm_90a: split-K
// f32 FMA on the CUDA cores over E experts (E = 1: one product),
//   y[e] = act((x[e] @ W[e]) * w_scale[e] + bias[e]), f32 accumulation,
// for f32 x, or f32 / int8 W (bf16 x where the caller asks).  Both
// libraries include this header and name the kernel (GPP_KERNEL) so the two
// launches show apart in a profiler trace: gpp_matmul.cu instantiates it as
// gpp_matmul_kernel (E = 1: deepseek's f32 router, the f32 logits heads of
// both models, every projection of the f32 runs), gpp_matmul_grouped.cu as
// gpp_matmul_grouped_kernel (deepseek's routed experts in f32: E = 64, 32
// rows an expert at decode and verify, 128 at prefill, 2048 x 1408 and
// 1408 x 2048).  The plan is core.schedule.plan_matmul_fma_sm90.
//
// What holds it back, and what the design does about it:
//  1. One CTA a tile walks its k rows in series on one SM while the others
//     idle (the router is one 64-column tile), and a kernel whose CTAs each
//     own a tile position runs its grid in uneven waves.  So: split-K over
//     persistent CTAs.  A tile is block_m (4-64) x 64 outputs of one expert,
//     a unit one (tile, k-step) of block_k (32-256) W rows.  Units are
//     numbered (m-tile, expert, n-tile, k-step), the k-step innermost; CTA
//     i walks units [i*U/P, (i+1)*U/P) as one run of steps on one GPP ring
//     (ring.cuh: G = 1 in situ, 2 naive ping-pong, >= 3 generalized), across
//     k-split, tile and expert boundaries alike, so the next tile's or the
//     next expert's first W chunks are in flight while this one's last
//     k-steps compute, and runs differ by at most one unit.  At one m-tile
//     (the experts' 32 rows at decode and verify) this is the reference's
//     expert-major step order (repro/kernels/gpp_matmul.py:433).  The m-tile
//     is outside the expert because block_k and the P0 CTAs that cut one
//     m-tile come from E, K and N alone and P = m_tiles x P0: every m-tile
//     is then cut alike, and a row's k-cuts, segments and sums do not depend
//     on how many rows ride with it (with the expert outside, the cuts of
//     an m-tile would move with M).
//  2. A deterministic fix-up at 64 columns: a CTA that covers a whole tile
//     stores it; otherwise it writes its partial (rows < M) to its own
//     workspace slot (2 per CTA: the tile its run starts in, the one it
//     ends in), and the tile's last CTA to arrive (per-tile arrival
//     counters) sums the segments' slots in segment order, runs the
//     epilogue and resets the tile's counter.  No float atomics.  The
//     fix-up is L2 round trips of one SM reading every segment's partial,
//     so each thread reads one vector of 1, 2 or 4 floats a slot (all 256
//     threads busy from block_m 4 up) with up to 32 floats in flight.
//  3. f32 FMA, not TF32 mma: TF32's 10-bit mantissa would not hold f32 to
//     2e-4, nor the f32 greedy streams to the plain run's.  W is copied raw
//     (f32, bf16 or int8; cp.async) and widened in registers, which is
//     exact.  x is staged through registers, 4 columns a load (its loads in
//     flight during the ring's wait), into one f32 (block_m, block_k) tile
//     whose float4 chunks are XOR-swizzled by the row, and read as float4
//     along k.  block_k is a compile-time count: with a run-time block_k
//     the staging's divisions cost more than the step's FMAs (PERF.md).
//     Below block_m 16 a thread owns one column (one W value a k row, one
//     float4 of x a row per 4 k rows); from block_m 16 a register tile of
//     4 columns (a float4 of W along n) by block_m / 16 rows, 4 x 8 lanes
//     of a warp on 4 distinct x rows and 8 distinct W float4s: ~0.19
//     shared loads an FMA at 32 rows, ~0.13 at 64, against ~0.4 for one
//     column.  Either way each output is one fmaf chain over its k rows in
//     order, so the layout does not change a bit.
// A row's sums do not depend on M or on W's dtype: its FMA chain runs the k
// rows of each step in order, and its m-tile's k-cuts and segment order
// come from E, K and N alone, so decode, verify and prefill rows round alike
// and a bf16 W gives the bits of its f32 copy.
//
// When `rec` is non-null, CTA 0 writes one (step, chunk, issue_step) triple
// per W chunk it issues, over its whole run of steps.
#pragma once

#ifndef GPP_KERNEL
#error "define GPP_KERNEL (the kernel's name) before including gpp_matmul.cuh"
#endif

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ring.cuh"

// Internal linkage: each library that includes this header keeps its own
// instantiations, including the per-instantiation `smem_set` statics of
// prepare() — with external linkage two loaded libraries would share one
// (a unique global symbol) and the second would skip raising its own
// kernel's shared-memory limit.
namespace gpp_fma {
namespace {

constexpr int kThreads = 256;
constexpr int kBlockN = 64;                      // output columns of a tile
constexpr int kRowGroups = 4;                    // block_m = 4 x ROWS
constexpr int kFixupFloats = 32;                 // in flight a thread (sweep)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 4 neighbouring W values of a ring row, widened to f32 (p 4-aligned)
__device__ __forceinline__ float4 load_w4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_w4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load_w4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
}

// 4 neighbouring x values of a row, widened to f32 (p 4-element aligned)
__device__ __forceinline__ float4 load_x4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_x4(const __nv_bfloat16* p) {
  return load_w4(p);
}

// activation ids: repro_torch/kernels/ref.py ACTIVATION_IDS
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case 1:
      return fmaxf(x, 0.0f);
    case 2: {  // tanh-form gelu (jax.nn.gelu's default)
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case 3:
      return x / (1.0f + expf(-x));
    case 4:
      return tanhf(x);
    case 5:
      return 1.0f / (1.0f + expf(-x));
    default:
      return x;
  }
}

// the CTA whose run holds unit u: the largest i with floor(i U / P) <= u
__device__ __forceinline__ int owner(long long u, long long U, long long P) {
  return (int)(((u + 1) * P + U - 1) / U - 1);
}

// the fix-up's load of V neighbouring floats of a slot
template <int V>
struct FixupVec;
template <>
struct FixupVec<1> {
  typedef float T;
};
template <>
struct FixupVec<2> {
  typedef float2 T;
};
template <>
struct FixupVec<4> {
  typedef float4 T;
};

struct FmaArgs {
  const void* x;       // (E, M, K) row-major, f32 or bf16
  const void* w;       // (E, K, N) row-major, f32, bf16 or int8
  const float* scale;  // (E, N) f32 or null
  const float* bias;   // (E, N) f32 or null
  void* y;             // (E, M, N) row-major, x's dtype
  float* ws;           // f32 partials, 2 (block_m, 64) slots a CTA; or null
  int* cnt;            // per-tile arrival counters, 0 between launches
  int E, M, K, N;
  int bk;              // W rows a step: 32, 64, 128 or 256
  int G, C;            // ring depth, chunks per W tile
  int act;
  int vec;             // cp.async width of W rows: 16, 8, 4 or 1
  int xvec;            // 1: x rows load 4 elements at once (K % 4 == 0,
                       // aligned), 0: one at a time
  int max_segs;        // the most CTAs sharing a tile (1: ws unused)
  int* rec;            // issue-order record or null
};

__host__ __device__ constexpr size_t smem_bytes(int bm, int bk, int G,
                                                int w_size) {
  return (size_t)G * bk * kBlockN * w_size + (size_t)bm * bk * 4;
}

// float index of x tile element (row r, column k) at BK columns a row: the
// row's float4 chunks XOR-swizzled by r & 7 (BK >= 32 keeps them inside
// the row), so the register tile's 4 consecutive rows hit 4 bank groups
template <int BK>
__device__ __forceinline__ int xs_at(int r, int k) {
  return r * BK + ((((k >> 2) ^ (r & 7))) << 2) + (k & 3);
}

// Where a thread's outputs are.  From block_k 64 the CTA is two k-groups
// of 128 threads (KG = 2): group g multiplies k rows [g BK / 2, (g+1) BK /
// 2) of every step into a whole (BM, 64) tile of its own, and at a
// segment's end group 1's tile is added to group 0's through shared
// memory, so each thread holds twice the outputs (more independent FMA
// chains, fewer shared loads an FMA).  In a group, below block_m 16 (TN ==
// 1) a thread owns column c0 of rows r0 + kStep i (64 columns x kStep row
// groups; a warp's lanes share their rows); from block_m 16 (TN == 4)
// columns c0 .. c0 + 3 of rows r0 + 4 i, the group's warps 2 along N and
// the rest along M, each warp's lanes 4 along M x 8 along N.
template <int BM, int BK>
struct Layout {
  static constexpr int KG = BK >= 64 ? 2 : 1;     // k-groups
  static constexpr int kGroupThreads = kThreads / KG;
  static constexpr int TN = BM >= 16 ? 4 : 1;     // columns a thread
  static constexpr int kWarpsM = kGroupThreads / 64;   // TN == 4
  static constexpr int kStep = TN == 1 ? kGroupThreads / kBlockN : 4;
  static constexpr int kRows =                    // rows a thread
      TN == 1 ? BM / kStep : BM / (4 * kWarpsM);
  int kg, r0, c0;
  __device__ __forceinline__ Layout() {
    kg = threadIdx.x / kGroupThreads;
    const int t = threadIdx.x % kGroupThreads;
    if constexpr (TN == 1) {
      r0 = t / kBlockN;
      c0 = t % kBlockN;
    } else {
      const int warp = t / 32, lane = t % 32;
      r0 = (warp >> 1) * (BM / kWarpsM) + (lane >> 3);
      c0 = (warp & 1) * 32 + (lane & 7) * 4;
    }
  }
};

template <typename XT, typename WT, int ROWS, int BK>
__global__ void __launch_bounds__(kThreads, 2) GPP_KERNEL(FmaArgs a) {
  constexpr int BM = kRowGroups * ROWS;
  using L = Layout<BM, BK>;
  constexpr int TN = L::TN;
  constexpr int RT = L::kRows;                    // rows a thread
  constexpr int kGroupK = BK / L::KG;             // k rows a group a step
  constexpr int kSlot = BM * kBlockN;             // floats a partial
  constexpr int kChunks = BM * BK / 4;            // x tile: float4 chunks
  constexpr int kRowChunks = BK / 4;
  constexpr int kXPer = (kChunks + kThreads - 1) / kThreads;  // a thread
  extern __shared__ __align__(16) unsigned char smem[];
  WT* ring = reinterpret_cast<WT*>(smem);
  float* xs = reinterpret_cast<float*>(
      smem + (size_t)a.G * BK * kBlockN * sizeof(WT));
  const XT* x = static_cast<const XT*>(a.x);
  const WT* w = static_cast<const WT*>(a.w);

  const int n_tiles = (a.N + kBlockN - 1) / kBlockN;
  const int et = a.E * n_tiles;                   // tiles an m-tile
  const int num_k = (a.K + BK - 1) / BK;
  const long long units = (long long)((a.M + BM - 1) / BM) * et * num_k;
  const long long P = gridDim.x;
  const long long u0 = blockIdx.x * units / P;
  const int num_s = (int)((blockIdx.x + 1) * units / P - u0);  // its steps
  const bool recorder = a.rec != nullptr && blockIdx.x == 0 &&
                        threadIdx.x == 0;
  int rec_n = 0;
  int cur = 0;                                    // the step now issuing
  int at_t = (int)(u0 / num_k), at_ks = (int)(u0 % num_k);  // its unit
  const int row_bytes = kBlockN * (int)sizeof(WT);

  auto issue = [&](int step, int c) {
    int t = at_t, ks = at_ks + (step - cur);
    while (ks >= num_k) {
      ks -= num_k;
      ++t;
    }
    const int r = t % et;                         // (expert, n-tile)
    const int e = r / n_tiles, n0 = (r % n_tiles) * kBlockN, k0 = ks * BK;
    const WT* we = w + (size_t)e * a.K * a.N;
    int lo, hi;
    gpp::chunk_bounds(BK, a.C, c, &lo, &hi);
    auto src_row = [&](int rr) -> const char* {
      const int k = k0 + rr;
      return k < a.K ? reinterpret_cast<const char*>(we + (size_t)k * a.N + n0)
                     : nullptr;
    };
    gpp::copy_rows_vec(
        a.vec, reinterpret_cast<char*>(ring + (size_t)(step % a.G) * BK *
                                                  kBlockN),
        row_bytes, lo, hi, row_bytes,
        min(kBlockN, a.N - n0) * (int)sizeof(WT), src_row,
        reinterpret_cast<const char*>(w));
    if (recorder) {
      a.rec[3 * rec_n + 0] = step;
      a.rec[3 * rec_n + 1] = c;
      a.rec[3 * rec_n + 2] = cur;
      ++rec_n;
    }
  };

  const L lay;
  float acc[RT][TN];
  int seg_k0 = at_ks;                             // the segment's first k-step

  for (int s = 0; s < num_s; ++s) {
    cur = s;
    const int mt = at_t / et, r = at_t % et;
    const int e = r / n_tiles;
    const int m0 = mt * BM, n0 = (r % n_tiles) * kBlockN;
    const int k0 = at_ks * BK;
    if (s == 0 || at_ks == 0) {                   // a segment of tile at_t
      seg_k0 = at_ks;
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    }
    // this step's x tile (BM x BK) into registers, 4 columns at a time:
    // the loads are in flight while the ring waits for the W tile; zeros
    // past M and K
    const XT* xe = x + (size_t)e * a.M * a.K;
    float4 xr[kXPer];
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int c = threadIdx.x + j * kThreads;
      const int rr = c / kRowChunks, k = k0 + (c % kRowChunks) * 4;
      const int m = m0 + rr;
      xr[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if ((kChunks % kThreads == 0 || c < kChunks) && m < a.M) {
        const XT* xp = xe + (size_t)m * a.K + k;
        if (a.xvec && k < a.K) {
          xr[j] = load_x4(xp);
        } else {
          if (k < a.K) xr[j].x = to_f32(xp[0]);
          if (k + 1 < a.K) xr[j].y = to_f32(xp[1]);
          if (k + 2 < a.K) xr[j].z = to_f32(xp[2]);
          if (k + 3 < a.K) xr[j].w = to_f32(xp[3]);
        }
      }
    }
    gpp::run_chunk_schedule(s, num_s, a.G, a.C, issue);
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int c = threadIdx.x + j * kThreads;
      if (kChunks % kThreads == 0 || c < kChunks) {
        const int rr = c / kRowChunks;
        *reinterpret_cast<float4*>(
            xs + xs_at<BK>(rr, (c % kRowChunks) * 4)) = xr[j];
      }
    }
    __syncthreads();
    // W rows past K are zero-filled, x columns past K are zero: every step
    // runs its BK rows
    const WT* wt = ring + (size_t)(s % a.G) * BK * kBlockN + lay.c0;
#pragma unroll 4
    for (int kk = lay.kg * kGroupK; kk < (lay.kg + 1) * kGroupK; kk += 4) {
      float wv[4][TN];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (TN == 1) {
          wv[q][0] = to_f32(wt[(kk + q) * kBlockN]);
        } else {
          const float4 v = load_w4(wt + (kk + q) * kBlockN);
          wv[q][0] = v.x;
          wv[q][1] = v.y;
          wv[q][2] = v.z;
          wv[q][3] = v.w;
        }
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float4 xv = *reinterpret_cast<const float4*>(
            xs + xs_at<BK>(lay.r0 + i * L::kStep, kk));
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(xv.x, wv[0][j], acc[i][j]);
          acc[i][j] = fmaf(xv.y, wv[1][j], acc[i][j]);
          acc[i][j] = fmaf(xv.z, wv[2][j], acc[i][j]);
          acc[i][j] = fmaf(xv.w, wv[3][j], acc[i][j]);
        }
      }
    }

    if (at_ks == num_k - 1 || s == num_s - 1) {   // the segment ends
      const size_t en = (size_t)e * a.N;          // expert e's columns
      if constexpr (L::KG == 2) {
        // group 0's tile += group 1's, through the x tile's shared memory
        // (BM x BK >= BM x 64 floats), row-major (BM, 64)
        __syncthreads();                          // the x tile is read
        if (lay.kg == 1) {
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              xs[(lay.r0 + i * L::kStep) * kBlockN + lay.c0 + j] = acc[i][j];
        }
        __syncthreads();
        if (lay.kg == 0) {
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] += xs[(lay.r0 + i * L::kStep) * kBlockN + lay.c0 + j];
        }
      }
      if (seg_k0 == 0 && at_ks == num_k - 1) {    // the whole tile: store
        XT* y = static_cast<XT*>(a.y) + (size_t)e * a.M * a.N;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = n0 + lay.c0 + j;
          if (n >= a.N || lay.kg != 0) break;
          const float sc = a.scale != nullptr ? a.scale[en + n] : 1.0f;
          const float b = a.bias != nullptr ? a.bias[en + n] : 0.0f;
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const int m = m0 + lay.r0 + i * L::kStep;
            if (m < a.M) {
              float v = acc[i][j];
              if (a.scale != nullptr) v *= sc;
              if (a.bias != nullptr) v += b;
              y[(size_t)m * a.N + n] = from_f32<XT>(activate(v, a.act));
            }
          }
        }
      } else {
        const long long tu = (long long)at_t * num_k;
        const int first = owner(tu, units, P);
        const int nseg = owner(tu + num_k - 1, units, P) - first + 1;
        // this CTA's slot: 2 i for the tile its run starts in, 2 i + 1 for
        // the one it ends in; a slot is row-major (BM, 64), and rows past
        // M are neither written nor read
        float* mine = a.ws + (size_t)(2 * blockIdx.x + (u0 < tu)) * kSlot;
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const int rr = lay.r0 + i * L::kStep;
          if (lay.kg == 0 && m0 + rr < a.M) {
            if constexpr (TN == 1) {
              mine[rr * kBlockN + lay.c0] = acc[i][0];
            } else {
              *reinterpret_cast<float4*>(mine + rr * kBlockN + lay.c0) =
                  make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            }
          }
        }
        // the next segment starts from zero: the partial's registers are
        // free for the fix-up's loads in flight
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
        __threadfence();  // the partial is visible before the count
        __syncthreads();
        bool last = false;
        if (threadIdx.x == 0) {
          last = atomicAdd(a.cnt + at_t, 1) == nseg - 1;
          if (last) atomicExch(a.cnt + at_t, 0);  // ready for the next launch
        }
        if (__syncthreads_or(last)) {  // every segment is in: sum in order
          __threadfence();
          // vector c of a slot holds elements kV c .. kV c + kV-1 of the
          // row-major slot: kV neighbouring columns of one output row
          constexpr int kV = kSlot >= 4 * kThreads ? 4 : kSlot / kThreads;
          typedef typename FixupVec<kV>::T VT;
          constexpr int kVecs = kSlot / kV;
          constexpr int kQ = (kVecs + kThreads - 1) / kThreads;
          constexpr int kBatch = kFixupFloats / (kV * kQ);
          const VT* sv = reinterpret_cast<const VT*>(a.ws);
          // segment g's slot: the first segment's tile may be where its
          // run ends, every later one's run starts in the tile
          const int slot0 =
              2 * first + (first * units / P < tu ? 1 : 0);
          int qm[kQ], qn[kQ];
          float sum[kQ][kV] = {};
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const int c = threadIdx.x + q * kThreads;
            qm[q] = m0 + kV * c / kBlockN;
            qn[q] = n0 + kV * c % kBlockN;
            if (c >= kVecs || qm[q] >= a.M) qm[q] = -1;  // not live
          }
          for (int g0 = 0; g0 < nseg; g0 += kBatch) {
            VT u[kBatch][kQ];
#pragma unroll
            for (int b = 0; b < kBatch; ++b) {
              const int slot = b + g0 == 0 ? slot0 : 2 * (first + g0 + b);
#pragma unroll
              for (int q = 0; q < kQ; ++q)
                u[b][q] = g0 + b < nseg && qm[q] >= 0
                              ? __ldcg(sv + (size_t)slot * kVecs +
                                       threadIdx.x + q * kThreads)
                              : VT{};
            }
#pragma unroll
            for (int b = 0; b < kBatch; ++b)
              if (g0 + b < nseg)
#pragma unroll
                for (int q = 0; q < kQ; ++q) {
                  const float* f = reinterpret_cast<const float*>(&u[b][q]);
#pragma unroll
                  for (int j = 0; j < kV; ++j)
                    sum[q][j] = g0 + b == 0 ? f[j] : sum[q][j] + f[j];
                }
          }
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            if (qm[q] < 0) continue;
            XT* yr = static_cast<XT*>(a.y) +
                     ((size_t)e * a.M + qm[q]) * a.N;
#pragma unroll
            for (int j = 0; j < kV; ++j) {
              const int n = qn[q] + j;
              if (n >= a.N) break;
              float v = sum[q][j];
              if (a.scale != nullptr) v *= a.scale[en + n];
              if (a.bias != nullptr) v += a.bias[en + n];
              yr[n] = from_f32<XT>(activate(v, a.act));
            }
          }
        }
      }
    }
    if (++at_ks == num_k) {
      at_ks = 0;
      ++at_t;
    }
    __syncthreads();  // the ring slot and the x tile are free again
  }
}

// raise the kernel's dynamic shared memory limit and ask for the largest
// shared-memory carveout (two CTAs an SM), once per instantiation
template <typename XT, typename WT, int ROWS, int BK>
cudaError_t prepare(size_t smem) {
  static size_t smem_set = 0;
  auto* k = GPP_KERNEL<XT, WT, ROWS, BK>;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  return cudaSuccess;
}

// launch `grid` CTAs or, with `ctas` non-null, ask how many CTAs an SM
// holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
template <typename XT, typename WT, int ROWS, int BK>
cudaError_t run(const FmaArgs& a, int grid, cudaStream_t stream, int* ctas) {
  const size_t smem = smem_bytes(kRowGroups * ROWS, BK, a.G, (int)sizeof(WT));
  const cudaError_t e = prepare<XT, WT, ROWS, BK>(smem);
  if (e != cudaSuccess) return e;
  if (ctas != nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, GPP_KERNEL<XT, WT, ROWS, BK>, kThreads, smem);
  }
  GPP_KERNEL<XT, WT, ROWS, BK><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// rows per thread group and k rows a step are compile-time counts:
// block_m = 4 * ROWS, block_k = BK
template <typename XT, typename WT, int BK>
cudaError_t run_rows(const FmaArgs& a, int bm, int grid, cudaStream_t stream,
                     int* ctas) {
  switch (bm) {
    case 4:
      return run<XT, WT, 1, BK>(a, grid, stream, ctas);
    case 8:
      return run<XT, WT, 2, BK>(a, grid, stream, ctas);
    case 16:
      return run<XT, WT, 4, BK>(a, grid, stream, ctas);
    case 32:
      return run<XT, WT, 8, BK>(a, grid, stream, ctas);
    default:
      return run<XT, WT, 16, BK>(a, grid, stream, ctas);
  }
}

template <typename XT, typename WT>
cudaError_t run_bk(const FmaArgs& a, int bm, int grid, cudaStream_t stream,
                   int* ctas) {
  switch (a.bk) {
    case 32:
      return run_rows<XT, WT, 32>(a, bm, grid, stream, ctas);
    case 64:
      return run_rows<XT, WT, 64>(a, bm, grid, stream, ctas);
    case 128:
      return run_rows<XT, WT, 128>(a, bm, grid, stream, ctas);
    default:
      return run_rows<XT, WT, 256>(a, bm, grid, stream, ctas);
  }
}

template <typename XT>
cudaError_t run_w(const FmaArgs& a, int w_dtype, int bm, int grid,
                  cudaStream_t stream, int* ctas) {
  switch (w_dtype) {
    case 0:
      return run_bk<XT, float>(a, bm, grid, stream, ctas);
    case 1:
      return run_bk<XT, __nv_bfloat16>(a, bm, grid, stream, ctas);
    default:
      return run_bk<XT, int8_t>(a, bm, grid, stream, ctas);
  }
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (weights only).  With
// `ctas` non-null nothing launches: the CTAs an SM holds at this tile,
// ring and dtypes go there.
cudaError_t run_any(const FmaArgs& a, int x_dtype, int w_dtype, int bm,
                    int grid, cudaStream_t stream, int* ctas) {
  if (!(bm == 4 || bm == 8 || bm == 16 || bm == 32 || bm == 64) ||
      !(a.bk == 32 || a.bk == 64 || a.bk == 128 || a.bk == 256) ||
      a.G < 1 || a.C < 1 || a.C > a.bk || x_dtype < 0 || x_dtype > 1 ||
      w_dtype < 0 || w_dtype > 2) {
    return cudaErrorInvalidValue;
  }
  if (ctas == nullptr) {
    // a non-empty run a CTA, and room for the partials of every split tile
    const long long units = (long long)((a.M + bm - 1) / bm) * a.E *
                            ((a.N + kBlockN - 1) / kBlockN) *
                            ((a.K + a.bk - 1) / a.bk);
    if (a.E < 1 || a.M < 1 || a.K < 1 || a.N < 1 || grid < 1 ||
        grid > units || a.max_segs < 1 ||
        (a.max_segs > 1 && (a.ws == nullptr || a.cnt == nullptr))) {
      return cudaErrorInvalidValue;
    }
  }
  if (x_dtype == 0) return run_w<float>(a, w_dtype, bm, grid, stream, ctas);
  return run_w<__nv_bfloat16>(a, w_dtype, bm, grid, stream, ctas);
}

}  // namespace
}  // namespace gpp_fma
