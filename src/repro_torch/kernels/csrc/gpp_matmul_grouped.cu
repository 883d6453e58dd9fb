// gpp_matmul_grouped for sm_90a: per expert e,
//   y[e] = act((x[e] @ W[e]) * w_scale[e] + bias[e]), f32 accumulation.
//
// Replaces repro/kernels/gpp_matmul.py::gpp_matmul_grouped (the Pallas TPU
// kernel, pallas_call at :606, body _gpp_grouped_kernel at :433): the MoE
// layer's routed-expert FFN, (E, M, K) @ (E, K, N) with M the rows each
// expert's capacity gives it.  Every expert streams its weights on every
// call, rows or none (the reference's dense_grouped does the same);
// skipping empty experts is later work.
//
// Two kernels, one entry (`route`):
//
// * route 1, gpp_matmul_grouped_tc_kernel (bf16 x and bf16 W, the
//   deepseek serving path), below.
// * route 0, gpp_matmul_grouped_kernel (f32 x, or f32 / int8 W; the f32
//   runs): gpp_matmul.cuh's split-K FMA body over the expert axis, the one
//   gpp_matmul.cu launches at E = 1 — persistent CTAs each walking a
//   balanced run of (m-tile, expert, n-tile, k-step) units on one GPP ring,
//   across expert boundaries, split tiles summed in segment order
//   (core.schedule.plan_matmul_fma_sm90 with E).
//
// What bounds the tensor-core route on the H100: the expert weight bytes at
// every shape of the path.  A decode or verify launch (32 rows an expert)
// reads all 64 experts' (2048 x 1408) bf16 matrices, 369 MB, for 11.8 GFLOP:
// 32 operations a byte; a prefill launch (128 rows) does 128 a byte.  Both
// are under the 295 FLOP/byte ridge, so 0.11-0.13 ms at 3.35 TB/s is the
// floor.  What the design does about it:
//  1. Tensor cores: mma.sync m16n8k16 bf16 with f32 accumulators in
//     registers; A (x) through ldmatrix, B (W, row-major (K, N) in the
//     ring) through ldmatrix.trans.  Shared-memory rows are XOR-swizzled in
//     16-byte chunks (chunk j of row r at j ^ (r & 7)), so the 8 rows of an
//     ldmatrix phase hit 8 distinct bank groups with no padding bytes
//     (the helpers are mma.cuh's, shared with paged_attention.cu).
//  2. One W read per call: block_m covers all of an expert's rows up to 128
//     (decode and verify 32, prefill 128), so each W tile streams once.
//  3. Persistent, balanced CTAs: grid = min(units, ctas_per_sm * 132), a
//     unit being one (expert, n-tile, m-tile), m-tile innermost.  CTA i
//     walks the contiguous units [i*U/P, (i+1)*U/P) expert-major — the
//     TPU's "one core walks the grid in order" — and the GPP chunk schedule
//     (ring.cuh) runs over its whole run of k-steps, across n-tile and
//     expert boundaries, so the next unit's first W chunks are in flight
//     while the current one's last k-steps compute.  Runs differ by at most
//     one unit.
//  4. x beside the ring: the bf16 x tile of step t is issued by the issue
//     callback together with step t's last W chunk (c = C-1), into slot
//     t % 2 of a two-slot x buffer outside the ring; it lands in that
//     chunk's commit group, so the ring's own wait covers it and costs no
//     extra round trip.  The issue-order record holds W chunks only.
//  5. Sizes from bytes in flight: each step issues one (block_k x 128) W
//     tile.  The ring's wait forces a tile's last chunk one step after its
//     issue and every other chunk two steps after (ring.cuh), so a ring of
//     G >= 3 keeps up to two steps' issue in flight.  The planner
//     (core.schedule.plan_grouped_tc_sm90) takes two CTAs an SM, which also
//     overlap each other's waits, and the largest block_k that fits: 32 KB
//     W tiles on a G = 3 ring at decode, 32 KB W + 32 KB x tiles in situ
//     at prefill (the 128-row x tiles take half the room).
// The tensor-core route has no split-K: each output element is one f32
// chain over k in a fixed order, whatever the batch holds.
//
// C interface (ctypes): gpp_matmul_grouped_launch returns the launch's
// cudaError_t; with `rec` non-null, the first CTA (block 0 on either route)
// writes one (step, chunk, issue_step) triple per W chunk it issues across
// its run of steps.
#define GPP_KERNEL gpp_matmul_grouped_kernel
#include "gpp_matmul.cuh"
#include "mma.cuh"

namespace gpp_tc {
namespace {

using gpp_mma::copy_rows_vec;
using gpp_mma::ldmatrix_x4;
using gpp_mma::ldmatrix_x4_trans;
using gpp_mma::mma_bf16;
using gpp_mma::swizzle;

constexpr int kThreads = 256;                 // 8 warps
constexpr int kBlockN = 128;                  // output columns of a unit
constexpr int kRowBytesW = kBlockN * 2;       // one bf16 W tile row

typedef __nv_bfloat16 bf16;

struct TcArgs {
  const bf16* x;       // (E, M, K) row-major
  const bf16* w;       // (E, K, N) row-major
  const float* scale;  // (E, N) f32 or null
  const float* bias;   // (E, N) f32 or null
  bf16* y;             // (E, M, N) row-major
  int E, M, K, N;
  int G, C;            // ring depth, chunks per W tile
  int act;
  int wvec, xvec;      // cp.async widths for W and x rows: 16, 8, 4 or 1
  int* rec;            // issue-order record or null
};

// warps along M x along N; each warp owns (BM / kM) x (128 / kN) outputs
template <int BM>
struct Warps {
  static constexpr int kM = BM >= 64 ? 2 : 1;
  static constexpr int kN = 8 / kM;
  static constexpr int kMI = BM / kM / 16;        // m16 tiles a warp
  static constexpr int kNI = kBlockN / kN / 8;    // n8 tiles a warp (even)
};

__host__ __device__ constexpr size_t smem_bytes(int bm, int bk, int G) {
  return (size_t)G * bk * kRowBytesW + 2 * (size_t)bm * bk * 2;
}

// where a step of the CTA's run is: unit (expert e, n-tile nt, m-tile mt,
// m-tile innermost) and k-step ks; advanced with carries, not divisions
struct Cursor {
  int e, nt, mt, ks;
};

__device__ __forceinline__ void advance(Cursor& c, int d, int num_k,
                                        int m_tiles, int n_tiles) {
  c.ks += d;
  while (c.ks >= num_k) {
    c.ks -= num_k;
    if (++c.mt == m_tiles) {
      c.mt = 0;
      if (++c.nt == n_tiles) {
        c.nt = 0;
        ++c.e;
      }
    }
  }
}

template <int BM, int BK>
__global__ void __launch_bounds__(kThreads, 2)
    gpp_matmul_grouped_tc_kernel(TcArgs a) {
  using Wp = Warps<BM>;
  constexpr int kWM = BM / Wp::kM, kWN = kBlockN / Wp::kN;
  constexpr int kWSlot = BK * kRowBytesW;
  constexpr int kXRow = BK * 2;
  constexpr int kXSlot = BM * kXRow;
  extern __shared__ __align__(128) unsigned char smem[];
  char* ring = reinterpret_cast<char*>(smem);
  char* xs = ring + (size_t)a.G * kWSlot;

  const int n_tiles = (a.N + kBlockN - 1) / kBlockN;
  const int m_tiles = (a.M + BM - 1) / BM;
  const int num_k = (a.K + BK - 1) / BK;
  const long long units = (long long)a.E * n_tiles * m_tiles;
  const int u0 = (int)(blockIdx.x * units / gridDim.x);
  const int u1 = (int)((blockIdx.x + 1) * units / gridDim.x);
  const int num_s = (u1 - u0) * num_k;      // this CTA's run of steps
  const bool recorder = a.rec != nullptr && blockIdx.x == 0 &&
                        threadIdx.x == 0;
  int rec_n = 0;
  int cur = 0;                              // the step now issuing
  Cursor at{u0 / (n_tiles * m_tiles), (u0 / m_tiles) % n_tiles,
            u0 % m_tiles, 0};               // and where it is

  auto issue = [&](int step, int c) {
    Cursor t = at;
    advance(t, step - cur, num_k, m_tiles, n_tiles);
    const int n0 = t.nt * kBlockN, m0 = t.mt * BM, k0 = t.ks * BK;
    int lo, hi;
    gpp::chunk_bounds(BK, a.C, c, &lo, &hi);
    copy_rows_vec<kRowBytesW>(
        a.wvec, ring + (size_t)(step % a.G) * kWSlot,
        reinterpret_cast<const char*>(a.w + ((size_t)t.e * a.K + k0) * a.N +
                                      n0),
        (size_t)a.N * 2, lo, hi, a.K - k0, min(kBlockN, a.N - n0) * 2);
    if (c == a.C - 1) {  // the step's x tile, in the same commit group
      copy_rows_vec<kXRow>(
          a.xvec, xs + (size_t)(step & 1) * kXSlot,
          reinterpret_cast<const char*>(a.x + ((size_t)t.e * a.M + m0) * a.K +
                                        k0),
          (size_t)a.K * 2, 0, BM, a.M - m0, min(BK, a.K - k0) * 2);
    }
    if (recorder) {
      a.rec[3 * rec_n + 0] = step;
      a.rec[3 * rec_n + 1] = c;
      a.rec[3 * rec_n + 2] = cur;
      ++rec_n;
    }
  };

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm0 = (warp / Wp::kN) * kWM;    // warp's first row in the tile
  const int wn0 = (warp % Wp::kN) * kWN;    // and first column
  float acc[Wp::kMI][Wp::kNI][4];

  for (int s = 0; s < num_s; ++s) {
    cur = s;
    gpp::run_chunk_schedule(s, num_s, a.G, a.C, issue);
    if (at.ks == 0) {
#pragma unroll
      for (int i = 0; i < Wp::kMI; ++i)
#pragma unroll
        for (int j = 0; j < Wp::kNI; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
    }
    const unsigned wb = gpp::smem_u32(ring + (size_t)(s % a.G) * kWSlot);
    const unsigned xb = gpp::smem_u32(xs + (size_t)(s & 1) * kXSlot);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[Wp::kMI][4];
#pragma unroll
      for (int i = 0; i < Wp::kMI; ++i) {
        // lanes 0-15 rows 0-15 at k 0-7, lanes 16-31 the same rows at k 8-15
        const int r = wm0 + i * 16 + (lane & 15);
        ldmatrix_x4(af[i], xb + r * kXRow +
                               swizzle(r, (kk + (lane >> 4) * 8) * 2));
      }
      unsigned bfr[Wp::kNI][2];
#pragma unroll
      for (int j = 0; j < Wp::kNI; j += 2) {
        // matrices (k 0-7 | 8-15) x (n 0-7 | 8-15): lane l addresses row
        // k = l & 7 (+8 for odd l >> 3) of n-block l >> 4
        const int k = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int n = wn0 + j * 8 + (lane >> 4) * 8;
        unsigned t[4];
        ldmatrix_x4_trans(t, wb + k * kRowBytesW + swizzle(k, n * 2));
        bfr[j][0] = t[0];
        bfr[j][1] = t[1];
        bfr[j + 1][0] = t[2];
        bfr[j + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < Wp::kMI; ++i)
#pragma unroll
        for (int j = 0; j < Wp::kNI; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }

    if (at.ks == num_k - 1) {  // the unit's epilogue, in f32
      const int e = at.e, m0 = at.mt * BM, n0 = at.nt * kBlockN;
      bf16* ye = a.y + (size_t)e * a.M * a.N;
#pragma unroll
      for (int j = 0; j < Wp::kNI; ++j) {
        const int n = n0 + wn0 + j * 8 + 2 * (lane & 3);
        float sc[2], bi[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const bool in = n + q < a.N;
          const size_t en = (size_t)e * a.N + n + q;
          sc[q] = a.scale != nullptr && in ? a.scale[en] : 1.0f;
          bi[q] = a.bias != nullptr && in ? a.bias[en] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < Wp::kMI; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + wm0 + i * 16 + (lane >> 2) + h * 8;
            if (m >= a.M) continue;
            float v[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              float t = acc[i][j][2 * h + q];
              if (a.scale != nullptr) t *= sc[q];
              if (a.bias != nullptr) t += bi[q];
              v[q] = gpp_fma::activate(t, a.act);
            }
            bf16* yr = ye + (size_t)m * a.N;
            if ((a.N & 1) == 0 && n < a.N) {  // aligned pair
              *reinterpret_cast<__nv_bfloat162*>(yr + n) =
                  __floats2bfloat162_rn(v[0], v[1]);
            } else {
#pragma unroll
              for (int q = 0; q < 2; ++q)
                if (n + q < a.N) yr[n + q] = __float2bfloat16(v[q]);
            }
          }
        }
      }
    }
    advance(at, 1, num_k, m_tiles, n_tiles);
    __syncthreads();  // the ring slot and the x slot are free again
  }
}

// raise the kernel's dynamic shared memory limit (and ask for the largest
// shared-memory carveout, so two CTAs fit an SM) once per instantiation
template <int BM, int BK>
cudaError_t prepare(size_t smem) {
  static size_t smem_set = 0;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gpp_matmul_grouped_tc_kernel<BM, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(gpp_matmul_grouped_tc_kernel<BM, BK>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  return cudaSuccess;
}

// launch (grid > 0) or, with `ctas` non-null, ask how many CTAs an SM holds
template <int BM, int BK>
cudaError_t run(const TcArgs& a, int grid, cudaStream_t stream, int* ctas) {
  const size_t smem = smem_bytes(BM, BK, a.G);
  const cudaError_t e = prepare<BM, BK>(smem);
  if (e != cudaSuccess) return e;
  if (ctas != nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, gpp_matmul_grouped_tc_kernel<BM, BK>, kThreads, smem);
  }
  gpp_matmul_grouped_tc_kernel<BM, BK><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int BM>
cudaError_t run_bk(const TcArgs& a, int bk, int grid, cudaStream_t stream,
                   int* ctas) {
  return bk == 64 ? run<BM, 64>(a, grid, stream, ctas)
                  : run<BM, 128>(a, grid, stream, ctas);
}

cudaError_t run_any(const TcArgs& a, int bm, int bk, int grid,
                    cudaStream_t stream, int* ctas) {
  if (!(bm == 16 || bm == 32 || bm == 64 || bm == 128) ||
      !(bk == 64 || bk == 128) || a.G < 1 || a.C < 1 || a.C > bk ||
      (ctas == nullptr && (grid < 1 || a.E < 1 || a.M < 1 || a.K < 1 ||
                           a.N < 1))) {
    return cudaErrorInvalidValue;
  }
  switch (bm) {
    case 16:
      return run_bk<16>(a, bk, grid, stream, ctas);
    case 32:
      return run_bk<32>(a, bk, grid, stream, ctas);
    case 64:
      return run_bk<64>(a, bk, grid, stream, ctas);
    default:
      return run_bk<128>(a, bk, grid, stream, ctas);
  }
}

}  // namespace
}  // namespace gpp_tc

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (weights only).
// scale and bias are (E, N) f32 or null; `grid` persistent CTAs.  route 0
// is the FMA kernel (ws the f32 workspace of 2 (block_m x 64) slots a CTA
// and cnt one int a tile, zero at the launch and after it, both unused when
// max_segs == 1; `xvec` the width in bytes that x rows allow, the kernel
// loading 4 elements at once from 4 elements' bytes), route 1 the
// tensor-core kernel (bf16 x and W only; `xvec` the cp.async width of x
// rows; ws, cnt and max_segs unused).
extern "C" int gpp_matmul_grouped_launch(
    const void* x, const void* w, const float* scale, const float* bias,
    void* y, float* ws, int* cnt, int E, int M, int K, int N, int x_dtype,
    int w_dtype, int bm, int bk, int G, int C, int act, int vec, int route,
    int grid, int xvec, int max_segs, int* rec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    const int x4 = xvec >= (x_dtype == 0 ? 16 : 8);  // 4 elements' bytes
    gpp_fma::FmaArgs a{x,  w, scale, bias, y,   ws, cnt, E,        M,  K,
                       N,  bk, G,    C,   act, vec, x4, max_segs, rec};
    return (int)gpp_fma::run_any(a, x_dtype, w_dtype, bm, grid, st,
                                 nullptr);
  }
  if (route != 1 || x_dtype != 1 || w_dtype != 1) {
    return (int)cudaErrorInvalidValue;
  }
  gpp_tc::TcArgs a{static_cast<const __nv_bfloat16*>(x),
                   static_cast<const __nv_bfloat16*>(w),
                   scale, bias, static_cast<__nv_bfloat16*>(y),
                   E, M, K, N, G, C, act, vec, xvec, rec};
  return (int)gpp_tc::run_any(a, bm, bk, grid, st, nullptr);
}

// CTAs of the FMA kernel one SM holds at this tile, ring and dtypes (the
// card's answer, after the launch's own attribute settings); < 0 is minus
// a cudaError_t.
extern "C" int gpp_matmul_grouped_fma_ctas_per_sm(int x_dtype, int w_dtype,
                                                  int bm, int bk, int G) {
  gpp_fma::FmaArgs a{};
  a.bk = bk;
  a.G = G;
  a.C = 1;
  int ctas = 0;
  const cudaError_t e = gpp_fma::run_any(a, x_dtype, w_dtype, bm, 0,
                                         nullptr, &ctas);
  return e == cudaSuccess ? ctas : -(int)e;
}

// CTAs of the tensor-core kernel one SM holds at this tile and ring (the
// card's answer, after the launch's own attribute settings); < 0 is minus
// a cudaError_t.
extern "C" int gpp_matmul_grouped_tc_ctas_per_sm(int bm, int bk, int G) {
  gpp_tc::TcArgs a{};
  a.G = G;
  a.C = 1;
  int ctas = 0;
  const cudaError_t e = gpp_tc::run_any(a, bm, bk, 0, nullptr, &ctas);
  return e == cudaSuccess ? ctas : -(int)e;
}

extern "C" const char* gpp_matmul_grouped_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
