// gpp_matmul for sm_90a: y = act((x @ W) * w_scale + bias), f32 accumulation.
//
// Replaces repro/kernels/gpp_matmul.py::gpp_matmul (the Pallas TPU kernel,
// pallas_call at :408, body _gpp_kernel at :247): every projection of the
// serving paths, x (M, K) with M = 4 / 32 / 20 rows at decode / prefill /
// verify, W (K, N) with K, N in 64 .. 10944.
//
// Two kernels, one entry (`route`), both split-K / stream-K over
// persistent CTAs with a deterministic fix-up:
//
// * route 1, gpp_matmul_tc_kernel (bf16 x and bf16 W: every projection of
//   both serving paths but deepseek's f32 router), below.
// * route 0, gpp_matmul_kernel (f32 x, or f32 / int8 W; bf16 x where the
//   caller pins the route): f32 FMA on the CUDA cores over 64-column tiles
//   (core.schedule.plan_matmul_fma_sm90), after the tensor-core kernel.
//
// What bounds both on the H100: the W bytes, at every shape of the path.
// 2 M FLOPs a W element over its 2 bytes is M operations a byte — 4 to 32
// — against the 295 FLOP/byte ridge (f32 W on the CUDA cores: 2 M / 4
// against 20), so a launch can at best stream W at 3.35 TB/s (0.6 us for
// 1024 x 1024 bf16, 13.4 us for layer 0's 10944 x 2048).  These W are
// 0.5-90 MB, which one wave of CTAs holds in flight a few times over at
// most, so what a launch costs is how many CTAs stream and how many
// dependent round trips each waits.
// What the tensor-core design does about it:
//  1. Tensor cores: mma.sync m16n8k16 bf16 with f32 accumulators in
//     registers; x through ldmatrix, W (row-major (K, N) in the ring)
//     through ldmatrix.trans, on rows XOR-swizzled in 16-byte chunks (chunk
//     j of row r at j ^ (r & 7); mma.cuh's helpers, as the grouped kernel).
//     block_m is M rounded up to 16 (at most 128), so each W tile streams
//     once a launch at every path shape; block_n is 128.
//  2. Stream-K persistent CTAs: a unit is one (tile, k-step), numbered
//     tile-major with the k-step inner (a tile is one (n-tile, m-tile),
//     m-tile innermost).  grid = min(units, 132) and CTA i walks the
//     contiguous units [i*U/P, (i+1)*U/P) as one run of steps on one GPP
//     ring (ring.cuh), across tile boundaries, so runs differ by at most
//     one unit and every SM streams whatever N and K are.  Steps are 64 KB
//     of W (block_k 256): at these sizes a launch is a few dependent round
//     trips, and the sweep found fewer, larger steps and fewer segments a
//     tile faster than two CTAs an SM of 16 KB steps
//     (core.schedule.plan_matmul_tc_sm90; PERF.md).
//  3. Deterministic fix-up: a CTA whose run covers all of a tile's k-steps
//     applies the epilogue (per-column scale, bias, one of six activations,
//     gelu in its tanh form) and stores.  Otherwise it writes its f32
//     partial of the tile (its rows < M) to workspace slot (tile, segment)
//     — segment = its index among the CTAs that share the tile — and
//     counts itself in the tile's arrival counter; the last to arrive sums
//     the tile's segments in segment order, whatever order they arrived in,
//     runs the epilogue, stores, and resets the counter to 0 for the next
//     launch on the stream (the wrapper keeps one counter buffer a stream,
//     and a captured launch its own, so launches that may overlap never
//     share one).
//     No float atomics: a bf16 stream repeats run to run.
//  4. x beside the ring: step t's x tile (block_m x block_k bf16) is issued
//     with W chunk C-1 of step t into slot t % 2 of a two-slot x buffer, so
//     it lands in that chunk's commit group (group B of ring.cuh) and the
//     ring's own wait covers it.
// The FMA kernel (route 0) keeps 2 and 3 at block_n 64 and f32 on the
// CUDA cores; see its own note below.
//
// C interface (ctypes): gpp_matmul_launch returns the launch's cudaError_t;
// with `rec` non-null, CTA 0 writes one (step, chunk, issue_step) triple
// per W chunk it issues across its run of steps.
//
// gpp_matmul.cuh's tile kernel serves gpp_matmul_grouped.cu; here only its
// helpers (dtype widening, the activations) are used, and its kernel
// template, named below, is never instantiated.
#define GPP_KERNEL gpp_matmul_tile_kernel
#include "gpp_matmul.cuh"
#include "mma.cuh"

namespace gpp_mm_tc {
namespace {

using gpp_mma::copy_rows_vec;
using gpp_mma::ldmatrix_x4;
using gpp_mma::ldmatrix_x4_trans;
using gpp_mma::mma_bf16;
using gpp_mma::swizzle;

constexpr int kThreads = gpp_mma::kCopyThreads;  // 8 warps
constexpr int kBlockN = 128;                      // output columns of a tile
constexpr int kRowBytesW = kBlockN * 2;           // one bf16 W tile row

typedef __nv_bfloat16 bf16;

struct TcArgs {
  const bf16* x;       // (M, K) row-major
  const bf16* w;       // (K, N) row-major
  const float* scale;  // (N,) f32 or null
  const float* bias;   // (N,) f32 or null
  bf16* y;             // (M, N) row-major
  float* ws;           // f32 partials, (tile, segment) slots; null: none
  int* cnt;            // per-tile arrival counters, 0 between launches
  int M, K, N;
  int G, C;            // ring depth, chunks per W tile
  int act;
  int wvec, xvec;      // cp.async widths for W and x rows: 16, 8, 4 or 1
  int max_segs;        // workspace slots a tile
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

// the CTA whose run holds unit u: the largest i with floor(i U / P) <= u
__device__ __forceinline__ int owner(long long u, long long U, long long P) {
  return (int)(((u + 1) * P + U - 1) / U - 1);
}

// the epilogue, in f32, and the store of this thread's outputs of the tile
// at (m0, n0)
template <int BM>
__device__ __forceinline__ void store_tile(
    const TcArgs& a, const float (&acc)[Warps<BM>::kMI][Warps<BM>::kNI][4],
    int m0, int n0, int wm0, int wn0, int lane) {
  using Wp = Warps<BM>;
#pragma unroll
  for (int j = 0; j < Wp::kNI; ++j) {
    const int n = n0 + wn0 + j * 8 + 2 * (lane & 3);
    float sc[2], bi[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const bool in = n + q < a.N;
      sc[q] = a.scale != nullptr && in ? a.scale[n + q] : 1.0f;
      bi[q] = a.bias != nullptr && in ? a.bias[n + q] : 0.0f;
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
          v[q] = gpp_tile::activate(t, a.act);
        }
        bf16* yr = a.y + (size_t)m * a.N;
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

template <int BM, int BK>
__global__ void __launch_bounds__(kThreads, 2)
    gpp_matmul_tc_kernel(TcArgs a) {
  using Wp = Warps<BM>;
  constexpr int kWM = BM / Wp::kM, kWN = kBlockN / Wp::kN;
  constexpr int kWSlot = BK * kRowBytesW;
  constexpr int kXRow = BK * 2;
  constexpr int kXSlot = BM * kXRow;
  constexpr int kSlot2 = BM * kBlockN / 2;        // float2s a partial
  extern __shared__ __align__(128) unsigned char smem[];
  char* ring = reinterpret_cast<char*>(smem);
  char* xs = ring + (size_t)a.G * kWSlot;

  const int m_tiles = (a.M + BM - 1) / BM;
  const int num_k = (a.K + BK - 1) / BK;
  const long long units =
      (long long)m_tiles * ((a.N + kBlockN - 1) / kBlockN) * num_k;
  const long long P = gridDim.x;
  const int u0 = (int)(blockIdx.x * units / P);
  const int u1 = (int)((blockIdx.x + 1) * units / P);
  const int num_s = u1 - u0;                // this CTA's run of steps
  const bool recorder = a.rec != nullptr && blockIdx.x == 0 &&
                        threadIdx.x == 0;
  int rec_n = 0;
  int cur = 0;                              // the step now issuing
  int at_t = u0 / num_k, at_ks = u0 % num_k;  // and its (tile, k-step)

  auto issue = [&](int step, int c) {
    int t = at_t, ks = at_ks + (step - cur);
    while (ks >= num_k) {
      ks -= num_k;
      ++t;
    }
    const int nt = t / m_tiles;
    const int n0 = nt * kBlockN, m0 = (t - nt * m_tiles) * BM, k0 = ks * BK;
    int lo, hi;
    gpp::chunk_bounds(BK, a.C, c, &lo, &hi);
    copy_rows_vec<kRowBytesW>(
        a.wvec, ring + (size_t)(step % a.G) * kWSlot,
        reinterpret_cast<const char*>(a.w + (size_t)k0 * a.N + n0),
        (size_t)a.N * 2, lo, hi, a.K - k0, min(kBlockN, a.N - n0) * 2);
    if (c == a.C - 1) {  // the step's x tile, in the same commit group
      copy_rows_vec<kXRow>(
          a.xvec, xs + (size_t)(step & 1) * kXSlot,
          reinterpret_cast<const char*>(a.x + (size_t)m0 * a.K + k0),
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
  int seg_k0 = at_ks;                       // first k-step of the segment

  for (int s = 0; s < num_s; ++s) {
    cur = s;
    gpp::run_chunk_schedule(s, num_s, a.G, a.C, issue);
    if (s == 0 || at_ks == 0) {             // a segment of tile at_t starts
      seg_k0 = at_ks;
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

    if (at_ks == num_k - 1 || s == num_s - 1) {  // the segment ends
      const int nt = at_t / m_tiles;
      const int m0 = (at_t - nt * m_tiles) * BM, n0 = nt * kBlockN;
      if (seg_k0 == 0 && at_ks == num_k - 1) {   // the whole tile
        store_tile<BM>(a, acc, m0, n0, wm0, wn0, lane);
      } else {
        const long long tu = (long long)at_t * num_k;
        const int first = owner(tu, units, P);
        const int nseg = owner(tu + num_k - 1, units, P) - first + 1;
        // this thread's pair (i, j, h) of a slot — rows i*16 + 8h + lane / 4
        // of the warp's, columns 2 (lane % 4) + {0, 1} of its n8 tile j —
        // sits at float2 index ((i * kNI + j) * 2 + h) * kThreads + tid;
        // pairs of rows past M are neither written nor read
        float2* slots = reinterpret_cast<float2*>(a.ws) +
                        (size_t)at_t * a.max_segs * kSlot2 + threadIdx.x;
        float2* mine = slots + (size_t)(blockIdx.x - first) * kSlot2;
        const int rows = a.M - m0 - wm0 - (lane >> 2);  // rows i*16 + 8h
#pragma unroll
        for (int i = 0; i < Wp::kMI; ++i)
#pragma unroll
          for (int j = 0; j < Wp::kNI; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (i * 16 + h * 8 < rows)
                mine[((i * Wp::kNI + j) * 2 + h) * kThreads] =
                    make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        __threadfence();  // the partial is visible before the count
        __syncthreads();
        bool last = false;
        if (threadIdx.x == 0) {
          last = atomicAdd(a.cnt + at_t, 1) == nseg - 1;
          if (last) atomicExch(a.cnt + at_t, 0);  // ready for the next launch
        }
        if (__syncthreads_or(last)) {  // every segment is in: sum in order
          __threadfence();
#pragma unroll
          for (int i = 0; i < Wp::kMI; ++i)
#pragma unroll
            for (int j = 0; j < Wp::kNI; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if (i * 16 + h * 8 >= rows) continue;
                const float2* p = slots + ((i * Wp::kNI + j) * 2 + h) *
                                              kThreads;
                float2 v = __ldcg(p);
#pragma unroll 4
                for (int g = 1; g < nseg; ++g) {
                  const float2 u = __ldcg(p + (size_t)g * kSlot2);
                  v.x += u.x;
                  v.y += u.y;
                }
                acc[i][j][2 * h] = v.x;
                acc[i][j][2 * h + 1] = v.y;
              }
          store_tile<BM>(a, acc, m0, n0, wm0, wn0, lane);
        }
      }
    }
    if (++at_ks == num_k) {
      at_ks = 0;
      ++at_t;
    }
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
        gpp_matmul_tc_kernel<BM, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(gpp_matmul_tc_kernel<BM, BK>,
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
        ctas, gpp_matmul_tc_kernel<BM, BK>, kThreads, smem);
  }
  gpp_matmul_tc_kernel<BM, BK><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int BM>
cudaError_t run_bk(const TcArgs& a, int bk, int grid, cudaStream_t stream,
                   int* ctas) {
  if (bk == 128) return run<BM, 128>(a, grid, stream, ctas);
  return run<BM, 256>(a, grid, stream, ctas);
}

cudaError_t run_any(const TcArgs& a, int bm, int bk, int grid,
                    cudaStream_t stream, int* ctas) {
  if (!(bm == 16 || bm == 32 || bm == 64 || bm == 128) ||
      !(bk == 128 || bk == 256) || a.G < 1 || a.C < 1 ||
      a.C > bk) {
    return cudaErrorInvalidValue;
  }
  if (ctas == nullptr) {  // a launch: a non-empty run a CTA, and room for
                          // the partials of every split tile
    const long long units = (long long)((a.M + bm - 1) / bm) *
                            ((a.N + kBlockN - 1) / kBlockN) *
                            ((a.K + bk - 1) / bk);
    if (a.M < 1 || a.K < 1 || a.N < 1 || grid < 1 || grid > units ||
        a.max_segs < 1 ||
        (a.max_segs > 1 && (a.ws == nullptr || a.cnt == nullptr))) {
      return cudaErrorInvalidValue;
    }
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
}  // namespace gpp_mm_tc

// ---------------------------------------------------------------------------
// route 0: gpp_matmul_kernel, split-K f32 FMA (f32 x, or f32 / int8 W)
// ---------------------------------------------------------------------------
//
// Its users: deepseek's router (x (M, 2048) f32 against the bf16 router
// weight widened in registers, N = 64 experts) in every MoE layer of the
// bf16 path, and every projection of the f32 runs.  At the router the
// whole product is one 64-column tile; a kernel that gives a tile to one
// CTA walks its 2048 k rows in series on one SM while 131 idle, each step
// waiting a memory round trip.  So, as the tensor-core kernel:
//  1. Split-K over persistent CTAs: a tile is block_m (4-64) x 64 outputs,
//     a unit one (tile, k-step) of block_k (32-256) W rows, numbered
//     tile-major with the k-step inner, the tiles m-major (m-tile
//     outermost); CTA i walks units [i*U/P, (i+1)*U/P) as one run of steps
//     on one GPP ring, across tile boundaries.  block_k and the P0 CTAs
//     that cut one m-tile come from K and N alone, and P = m_tiles x P0
//     (plan_matmul_fma_sm90): every m-tile is cut alike.  At the router
//     P0 = 32 CTAs of one 64-row step, and the rows of prefill and verify
//     go to 3-4 m-tiles of 8 on otherwise idle SMs.
//  2. The same deterministic fix-up at 64 columns: a CTA that covers a
//     whole tile stores it; otherwise it writes its partial (rows < M) to
//     slot (tile, segment), and the tile's last CTA to arrive sums the
//     slots in segment order, runs the epilogue and resets the tile's
//     counter.  No float atomics.  What a fix-up costs is the L2 round
//     trips of one SM reading every segment's partial, so each thread
//     reads one vector of 1, 2 or 4 floats a slot (all 256 threads busy
//     from block_m 4 up) and keeps up to 64 floats of loads in flight: the
//     router's 32 partials come in one round trip.
//  3. f32 FMA on the CUDA cores, not TF32 mma: TF32's 10-bit mantissa
//     would not hold f32 to 2e-4, nor the f32 kernel's greedy streams to
//     the plain run's.  W is copied raw (f32, bf16 or int8; cp.async) and
//     widened in registers, which is exact; each thread owns one column of
//     block_m / 4 rows (rows rg, rg + 4, ...), reads four W rows a pass and
//     each of its rows' x as one float4 (a broadcast: a warp's lanes share
//     the rows).  x is staged through registers into one f32 (block_m,
//     block_k) tile, its loads in flight during the ring's wait.
// A row's sums do not depend on M: its thread's FMA chain runs the k rows
// of each step in order, and its m-tile's k-cuts and segment order come
// from K and N alone, so decode, verify and prefill rows round alike.
namespace gpp_mm_fma {
namespace {

using gpp_tile::activate;
using gpp_tile::from_f32;
using gpp_tile::to_f32;

constexpr int kThreads = 256;
constexpr int kBlockN = 64;                      // one column a thread
constexpr int kRowGroups = kThreads / kBlockN;   // 4
constexpr int kMaxBlockK = 256;
constexpr int kFixupFloats = 64;                 // in flight a thread

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
  const void* x;       // (M, K) row-major, f32 or bf16
  const void* w;       // (K, N) row-major, f32, bf16 or int8
  const float* scale;  // (N,) f32 or null
  const float* bias;   // (N,) f32 or null
  void* y;             // (M, N) row-major, x's dtype
  float* ws;           // f32 partials, (tile, segment) slots; null: none
  int* cnt;            // per-tile arrival counters, 0 between launches
  int M, K, N;
  int bk;              // W rows a step: 32, 64, 128 or 256
  int G, C;            // ring depth, chunks per W tile
  int act;
  int vec;             // cp.async width of W rows: 16, 8, 4 or 1
  int max_segs;        // workspace slots a tile
  int* rec;            // issue-order record or null
};

__host__ __device__ constexpr size_t smem_bytes(int bm, int bk, int G,
                                                int w_size) {
  return (size_t)G * bk * kBlockN * w_size + (size_t)bm * bk * 4;
}

// the epilogue, in f32, and the store of this thread's rows of column n
template <typename XT, int ROWS>
__device__ __forceinline__ void store_rows(const FmaArgs& a,
                                           const float (&acc)[ROWS], int m0,
                                           int n, int rg) {
  if (n >= a.N) return;
  const float sc = a.scale != nullptr ? a.scale[n] : 1.0f;
  const float b = a.bias != nullptr ? a.bias[n] : 0.0f;
  XT* y = static_cast<XT*>(a.y);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int m = m0 + rg + i * kRowGroups;
    if (m < a.M) {
      float v = acc[i];
      if (a.scale != nullptr) v *= sc;
      if (a.bias != nullptr) v += b;
      y[(size_t)m * a.N + n] = from_f32<XT>(activate(v, a.act));
    }
  }
}

// the epilogue and store of V neighbouring columns n.. of row m
template <typename XT, int V>
__device__ __forceinline__ void store_vec(const FmaArgs& a,
                                          const float (&v)[V], int m, int n) {
  XT* y = static_cast<XT*>(a.y) + (size_t)m * a.N;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (n + j >= a.N) return;
    float t = v[j];
    if (a.scale != nullptr) t *= a.scale[n + j];
    if (a.bias != nullptr) t += a.bias[n + j];
    y[n + j] = from_f32<XT>(activate(t, a.act));
  }
}

template <typename XT, typename WT, int ROWS>
__global__ void __launch_bounds__(kThreads) gpp_matmul_kernel(FmaArgs a) {
  constexpr int BM = kRowGroups * ROWS;
  constexpr int kSlot = BM * kBlockN;             // floats a partial
  constexpr int kXPerThread = BM * kMaxBlockK / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  WT* ring = reinterpret_cast<WT*>(smem);
  const int bk = a.bk;
  float* xs = reinterpret_cast<float*>(
      smem + (size_t)a.G * bk * kBlockN * sizeof(WT));
  const XT* x = static_cast<const XT*>(a.x);
  const WT* w = static_cast<const WT*>(a.w);

  const int n_tiles = (a.N + kBlockN - 1) / kBlockN;
  const int num_k = (a.K + bk - 1) / bk;
  const long long units =
      (long long)((a.M + BM - 1) / BM) * n_tiles * num_k;
  const long long P = gridDim.x;
  const int u0 = (int)(blockIdx.x * units / P);
  const int u1 = (int)((blockIdx.x + 1) * units / P);
  const int num_s = u1 - u0;                // this CTA's run of steps
  const bool recorder = a.rec != nullptr && blockIdx.x == 0 &&
                        threadIdx.x == 0;
  int rec_n = 0;
  int cur = 0;                              // the step now issuing
  int at_t = u0 / num_k, at_ks = u0 % num_k;  // and its (tile, k-step)
  const int row_bytes = kBlockN * (int)sizeof(WT);

  auto issue = [&](int step, int c) {
    int t = at_t, ks = at_ks + (step - cur);
    while (ks >= num_k) {
      ks -= num_k;
      ++t;
    }
    const int n0 = (t % n_tiles) * kBlockN, k0 = ks * bk;
    int lo, hi;
    gpp::chunk_bounds(bk, a.C, c, &lo, &hi);
    auto src_row = [&](int r) -> const char* {
      const int k = k0 + r;
      return k < a.K ? reinterpret_cast<const char*>(w + (size_t)k * a.N + n0)
                     : nullptr;
    };
    gpp::copy_rows_vec(
        a.vec, reinterpret_cast<char*>(ring + (size_t)(step % a.G) * bk *
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

  // thread (rg, col) owns output column n0 + col of rows rg, rg + 4, ...
  const int col = threadIdx.x % kBlockN;
  const int rg = threadIdx.x / kBlockN;
  float acc[ROWS];
  int seg_k0 = at_ks;                       // first k-step of the segment

  for (int s = 0; s < num_s; ++s) {
    cur = s;
    const int mt = at_t / n_tiles;          // tiles m-major
    const int m0 = mt * BM, n0 = (at_t - mt * n_tiles) * kBlockN;
    const int k0 = at_ks * bk;
    if (s == 0 || at_ks == 0) {             // a segment of tile at_t starts
      seg_k0 = at_ks;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) acc[i] = 0.0f;
    }
    // this step's x tile (BM x bk) into registers: the loads are in flight
    // while the ring waits for the W tile; zeros past M and K
    float xr[kXPerThread];
#pragma unroll
    for (int j = 0; j < kXPerThread; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / bk, kk = i % bk;
      const int m = m0 + r, k = k0 + kk;
      xr[j] = (r < BM && m < a.M && k < a.K)
                  ? to_f32(x[(size_t)m * a.K + k]) : 0.0f;
    }
    gpp::run_chunk_schedule(s, num_s, a.G, a.C, issue);
#pragma unroll
    for (int j = 0; j < kXPerThread; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < BM * bk) xs[i] = xr[j];
    }
    __syncthreads();
    // W rows past K are zero-filled, x columns past K are zero: every step
    // runs its bk rows
    const WT* wt = ring + (size_t)(s % a.G) * bk * kBlockN + col;
#pragma unroll 2
    for (int kk = 0; kk < bk; kk += 4) {
      float wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) wv[q] = to_f32(wt[(kk + q) * kBlockN]);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 xv = *reinterpret_cast<const float4*>(
            xs + (rg + i * kRowGroups) * bk + kk);
        acc[i] = fmaf(xv.x, wv[0], acc[i]);
        acc[i] = fmaf(xv.y, wv[1], acc[i]);
        acc[i] = fmaf(xv.z, wv[2], acc[i]);
        acc[i] = fmaf(xv.w, wv[3], acc[i]);
      }
    }

    if (at_ks == num_k - 1 || s == num_s - 1) {  // the segment ends
      const int n = n0 + col;
      if (seg_k0 == 0 && at_ks == num_k - 1) {   // the whole tile
        store_rows<XT, ROWS>(a, acc, m0, n, rg);
      } else {
        const long long tu = (long long)at_t * num_k;
        const int first = gpp_mm_tc::owner(tu, units, P);
        const int nseg = gpp_mm_tc::owner(tu + num_k - 1, units, P) - first +
                         1;
        // this thread's row i of a slot sits at float i * kThreads + tid;
        // rows past M are neither written nor read
        float* mine = a.ws + ((size_t)at_t * a.max_segs + blockIdx.x - first)
                                 * kSlot + threadIdx.x;
        const int rows = a.M - m0 - rg;          // live rows: i * 4 < rows
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          if (i * kRowGroups < rows) mine[i * kThreads] = acc[i];
        __threadfence();  // the partial is visible before the count
        __syncthreads();
        bool last = false;
        if (threadIdx.x == 0) {
          last = atomicAdd(a.cnt + at_t, 1) == nseg - 1;
          if (last) atomicExch(a.cnt + at_t, 0);  // ready for the next launch
        }
        if (__syncthreads_or(last)) {  // every segment is in: sum in order
          __threadfence();
          // vector c of a slot holds elements kV c .. kV c + kV-1: slot
          // row i = kV c / kThreads of threads kV c % kThreads .., i.e. kV
          // neighbouring columns of one output row
          constexpr int kV = kSlot >= 4 * kThreads ? 4 : kSlot / kThreads;
          typedef typename FixupVec<kV>::T VT;
          constexpr int kVecs = kSlot / kV;
          constexpr int kQ = (kVecs + kThreads - 1) / kThreads;
          constexpr int kBatch = kFixupFloats / (kV * kQ);
          const VT* sv = reinterpret_cast<const VT*>(
              a.ws + (size_t)at_t * a.max_segs * kSlot);
          int qm[kQ], qn[kQ];
          float sum[kQ][kV] = {};
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const int c = threadIdx.x + q * kThreads;
            const int e = kV * c % kThreads;
            qm[q] = m0 + e / kBlockN + kV * c / kThreads * kRowGroups;
            qn[q] = n0 + e % kBlockN;
            if (c >= kVecs || qm[q] >= a.M) qm[q] = -1;  // not live
          }
          for (int g0 = 0; g0 < nseg; g0 += kBatch) {
            VT u[kBatch][kQ];
#pragma unroll
            for (int b = 0; b < kBatch; ++b)
#pragma unroll
              for (int q = 0; q < kQ; ++q)
                u[b][q] = g0 + b < nseg && qm[q] >= 0
                              ? __ldcg(sv + (size_t)(g0 + b) * kVecs +
                                       threadIdx.x + q * kThreads)
                              : VT{};
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
          for (int q = 0; q < kQ; ++q)
            if (qm[q] >= 0) store_vec<XT, kV>(a, sum[q], qm[q], qn[q]);
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

template <typename XT, typename WT, int ROWS>
cudaError_t launch(const FmaArgs& a, int grid, cudaStream_t stream) {
  const size_t smem =
      smem_bytes(kRowGroups * ROWS, a.bk, a.G, (int)sizeof(WT));
  static size_t smem_set = 0;  // per instantiation: raise the limit once
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        gpp_matmul_kernel<XT, WT, ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  gpp_matmul_kernel<XT, WT, ROWS><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// rows per thread is a compile-time count: block_m = 4 * ROWS
template <typename XT, typename WT>
cudaError_t launch_rows(const FmaArgs& a, int bm, int grid,
                        cudaStream_t stream) {
  switch (bm / kRowGroups) {
    case 1:
      return launch<XT, WT, 1>(a, grid, stream);
    case 2:
      return launch<XT, WT, 2>(a, grid, stream);
    case 4:
      return launch<XT, WT, 4>(a, grid, stream);
    case 8:
      return launch<XT, WT, 8>(a, grid, stream);
    default:
      return launch<XT, WT, 16>(a, grid, stream);
  }
}

template <typename XT>
cudaError_t launch_w(const FmaArgs& a, int w_dtype, int bm, int grid,
                     cudaStream_t stream) {
  switch (w_dtype) {
    case 0:
      return launch_rows<XT, float>(a, bm, grid, stream);
    case 1:
      return launch_rows<XT, __nv_bfloat16>(a, bm, grid, stream);
    default:
      return launch_rows<XT, int8_t>(a, bm, grid, stream);
  }
}

cudaError_t launch_any(const FmaArgs& a, int x_dtype, int w_dtype, int bm,
                       int grid, cudaStream_t stream) {
  if (!(bm == 4 || bm == 8 || bm == 16 || bm == 32 || bm == 64) ||
      !(a.bk == 32 || a.bk == 64 || a.bk == 128 || a.bk == 256) ||
      a.G < 1 || a.C < 1 || a.C > a.bk || x_dtype < 0 || x_dtype > 1 ||
      w_dtype < 0 || w_dtype > 2 || a.M < 1 || a.K < 1 || a.N < 1) {
    return cudaErrorInvalidValue;
  }
  // a non-empty run a CTA, and room for the partials of every split tile
  const long long units = (long long)((a.M + bm - 1) / bm) *
                          ((a.N + kBlockN - 1) / kBlockN) *
                          ((a.K + a.bk - 1) / a.bk);
  if (grid < 1 || grid > units || a.max_segs < 1 ||
      (a.max_segs > 1 && (a.ws == nullptr || a.cnt == nullptr))) {
    return cudaErrorInvalidValue;
  }
  if (x_dtype == 0) return launch_w<float>(a, w_dtype, bm, grid, stream);
  return launch_w<__nv_bfloat16>(a, w_dtype, bm, grid, stream);
}

}  // namespace
}  // namespace gpp_mm_fma

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (weights only).
// scale and bias are (N,) f32 or null.  `grid` persistent CTAs, `vec` the
// cp.async width of W rows, ws the f32 workspace of max_segs (block_m x
// block_n) slots a tile and cnt one int a tile, zero at the launch and zero
// again after it (both unused when max_segs == 1).  route 0 is the FMA
// kernel (block_n 64; xvec unused), route 1 the tensor-core kernel (bf16 x
// and W only; block_n 128, `xvec` the cp.async width of x rows).
extern "C" int gpp_matmul_launch(const void* x, const void* w,
                                 const float* scale, const float* bias,
                                 void* y, float* ws, int* cnt, int M, int K,
                                 int N, int x_dtype, int w_dtype, int bm,
                                 int bk, int G, int C, int act, int vec,
                                 int route, int grid, int xvec, int max_segs,
                                 int* rec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    gpp_mm_fma::FmaArgs a{x,  w, scale, bias, y,   ws,  cnt,      M,  K,
                          N,  bk, G,     C,    act, vec, max_segs, rec};
    return (int)gpp_mm_fma::launch_any(a, x_dtype, w_dtype, bm, grid, st);
  }
  if (route != 1 || x_dtype != 1 || w_dtype != 1) {
    return (int)cudaErrorInvalidValue;
  }
  gpp_mm_tc::TcArgs a{static_cast<const __nv_bfloat16*>(x),
                      static_cast<const __nv_bfloat16*>(w),
                      scale, bias, static_cast<__nv_bfloat16*>(y), ws, cnt,
                      M, K, N, G, C, act, vec, xvec, max_segs, rec};
  return (int)gpp_mm_tc::run_any(a, bm, bk, grid, st, nullptr);
}

// CTAs of the tensor-core kernel one SM holds at this tile and ring (the
// card's answer, after the launch's own attribute settings); < 0 is minus
// a cudaError_t.
extern "C" int gpp_matmul_tc_ctas_per_sm(int bm, int bk, int G) {
  gpp_mm_tc::TcArgs a{};
  a.G = G;
  a.C = 1;
  int ctas = 0;
  const cudaError_t e = gpp_mm_tc::run_any(a, bm, bk, 0, nullptr, &ctas);
  return e == cudaSuccess ? ctas : -(int)e;
}

extern "C" const char* gpp_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
