// gpp_matmul for sm_90a: y = act((x @ W) * w_scale + bias), f32 accumulation.
//
// Replaces repro/kernels/gpp_matmul.py::gpp_matmul (the Pallas TPU kernel,
// pallas_call at :408, body _gpp_kernel at :247): every projection of the
// serving paths, x (M, K) with M = 4 / 32 / 20 rows at decode / prefill /
// verify, W (K, N) with K, N in 64 .. 10944.
//
// Two kernels, routed by dtype in kernels/gpp_matmul.py:
//
// * gpp_matmul_tc_kernel (bf16 x and bf16 W: every projection of both
//   serving paths but deepseek's f32 router), cluster split-K, below;
//   entry gpp_matmul_tc_launch.
// * gpp_matmul_kernel (f32 x, or f32 / int8 W; bf16 x where the caller pins
//   the route): split-K f32 FMA on the CUDA cores over 64-column tiles with
//   a workspace fix-up (core.schedule.plan_matmul_fma_sm90), the body of
//   gpp_matmul.cuh at E = 1 (gpp_matmul_grouped.cu runs it over experts);
//   entry gpp_matmul_launch.
//
// What bounds both on the H100: the W bytes, at every shape of the path.
// 2 M FLOPs a W element over its 2 bytes is M operations a byte — 4 to 32
// — against the 295 FLOP/byte ridge (f32 W on the CUDA cores: 2 M / 4
// against 20), so a launch can at best stream W at 3.35 TB/s (0.6 us for
// 1024 x 1024 bf16, 13.4 us for layer 0's 10944 x 2048).  These W are
// 0.5-90 MB: a launch is a few dependent memory round trips, so what it
// costs is how many SMs stream at once, how many round trips each waits,
// and what it takes to sum a tile that several SMs computed.
//
// The tensor-core design, cluster split-K (core.schedule.plan_matmul_tc_sm90):
//  1. The work is cut from K and N alone.  An output tile is block_m x
//     block_n (block_n 64 or 128; block_m is M rounded up to 16, at most
//     128), and each tile is one thread-block cluster of S CTAs (S in 1, 2,
//     4, 8; 16 with the non-portable attribute).  CTA rank r walks k-slice
//     r, k-steps [r*num_k/S, (r+1)*num_k/S) of block_k (128 or 256) W
//     rows, as one run of steps on one GPP ring (ring.cuh).  grid = (S,
//     n_tiles, m_tiles), cluster (S, 1, 1): the planner puts up to 96 CTAs
//     on a launch (64-96 at every path shape, against 8-24 tiles), so the
//     SMs a narrow projection left idle under one CTA a tile each stream a
//     slice of K in a few 64 KB steps, and every cluster is resident.
//  2. Tensor cores: mma.sync m16n8k16 bf16 with f32 accumulators in
//     registers; x through ldmatrix, W (row-major (K, N) in the ring)
//     through ldmatrix.trans, on rows XOR-swizzled in 16-byte chunks (chunk
//     j of row r at j ^ (r & 7); mma.cuh's helpers).  A warp owns 16
//     columns of every row of the tile; at block_n 64 the 8 warps are 4
//     along N by 2 along each step's k rows (k-groups, each the contiguous
//     half of every step).  Step t's x tile (block_m x block_k) is issued
//     with W chunk C-1 of step t into slot t % 2 of a two-slot x buffer, so
//     it lands in that chunk's commit group (group B of ring.cuh) and the
//     ring's own wait covers it; rows of x at or past M are zero-filled,
//     never read.
//  3. The partials are summed through distributed shared memory, in rank
//     order.  After its last step each CTA writes its f32 accumulators for
//     the live rows (< M) into its own shared memory, over the ring's slots
//     (the planner sizes the shared memory to the larger of the two), one
//     (block_m, block_n + 8) partial a k-group.  The cluster syncs
//     (barrier.cluster arrive.release / wait.acquire); rank r then sums its
//     block_n / S columns of every live row from ranks 0, 1, .., S-1 in
//     that order, k-group by k-group (mapa + ld.shared::cluster, float4),
//     runs the epilogue (per-column scale, bias, one of six activations,
//     gelu in its tanh form) and stores bf16 pairs; the cluster syncs again
//     before exit, so no CTA's shared memory goes while a peer reads it.
//     At S = 1 a __syncthreads takes the barriers' place.  No global
//     workspace, no arrival counters, no __threadfence, no float atomics:
//     a bf16 result repeats bit for bit, and launches on any streams (or in
//     CUDA graphs) share nothing.
//  4. A row's value is fixed by the k-slices and k-groups (from K and N
//     alone), the in-CTA mma order and the rank order of the sum; none
//     depends on M, so a row has the same bits at 4 (decode), 20 (verify)
//     and 32 (prefill) rows.
//
// C interface (ctypes): each launch entry returns the launch's cudaError_t;
// with `rec` non-null, the first CTA writes one (step, chunk, issue_step)
// triple per W chunk it issues across its run of steps.
//
// The FMA route's kernel is gpp_matmul.cuh's split-K body at E = 1, named
// below; the tensor-core kernel shares its activations.
#define GPP_KERNEL gpp_matmul_kernel
#include "gpp_matmul.cuh"
#include "mma.cuh"

namespace gpp_mm_tc {
namespace {

using gpp_mma::copy_rows;
using gpp_mma::copy_rows_vec;
using gpp_mma::ldmatrix_x4;
using gpp_mma::ldmatrix_x4_trans;
using gpp_mma::mma_bf16;
using gpp_mma::swizzle;

constexpr int kThreads = gpp_mma::kCopyThreads;  // 8 warps
constexpr int kPartPad = 8;    // floats after each partial row: the 8 rows
                               // of an mma fragment's stores hit 8 bank
                               // groups

typedef __nv_bfloat16 bf16;

struct TcArgs {
  const bf16* x;       // (M, K) row-major
  const bf16* w;       // (K, N) row-major
  const float* scale;  // (N,) f32 or null
  const float* bias;   // (N,) f32 or null
  bf16* y;             // (M, N) row-major
  int M, K, N;
  int S;               // cluster size: the CTAs that split a tile's k-steps
  int G, C;            // ring depth, chunks per W tile
  int act;
  int wvec, xvec;      // cp.async widths for W and x rows: 16, 8, 4 or 1
  int* rec;            // issue-order record or null
};

// warps: 16 columns each along N, the rest along a step's k rows
template <int BN>
struct Warps {
  static constexpr int kN = BN / 16;
  static constexpr int kK = 8 / kN;   // k-groups: 2 at block_n 64, 1 at 128
};

__host__ __device__ constexpr size_t ring_bytes(int bm, int bk, int bn,
                                                int G) {
  return (size_t)G * bk * bn * 2 + 2 * (size_t)bm * bk * 2;
}

__host__ __device__ constexpr size_t partial_bytes(int bm, int bn) {
  return (size_t)(128 / bn) * bm * (bn + kPartPad) * 4;
}

__host__ __device__ constexpr size_t smem_bytes(int bm, int bk, int bn,
                                                int G) {
  return ring_bytes(bm, bk, bn, G) > partial_bytes(bm, bn)
             ? ring_bytes(bm, bk, bn, G)
             : partial_bytes(bm, bn);
}

// every thread of every CTA of the cluster arrives (release) and waits
// (acquire): shared-memory writes before it are visible to the peers' reads
// after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// float4 at shared address `addr` (this CTA's layout) of cluster rank `rank`
__device__ __forceinline__ float4 ld_rank(unsigned addr, unsigned rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a) : "memory");
  return v;
}

// rows [lo, hi) of a tile into shared memory (mma.cuh's copy_rows): V16 is
// the 16-byte copy alone, the rest picks the width `vec` at run time (its
// four inlined copies cost the kernel ~40 registers, and at two CTAs an SM
// its spills)
template <int ROW_BYTES, bool V16>
__device__ __forceinline__ void copy_tile(int vec, char* dst, const char* src,
                                          size_t src_stride, int lo, int hi,
                                          int rows_valid, int valid_bytes) {
  if constexpr (V16) {
    copy_rows<ROW_BYTES, 16>(dst, src, src_stride, lo, hi, rows_valid,
                             valid_bytes);
  } else {
    copy_rows_vec<ROW_BYTES>(vec, dst, src, src_stride, lo, hi, rows_valid,
                             valid_bytes);
  }
}

// the epilogue, in f32, and the store of columns n .. n+3 of row m
__device__ __forceinline__ void store4(const TcArgs& a, float4 s, int m,
                                       int n) {
  float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (n + q >= a.N) break;
    if (a.scale != nullptr) v[q] *= a.scale[n + q];
    if (a.bias != nullptr) v[q] += a.bias[n + q];
    v[q] = gpp_fma::activate(v[q], a.act);
  }
  bf16* yr = a.y + (size_t)m * a.N;
  if ((a.N & 1) == 0) {  // aligned pairs
#pragma unroll
    for (int q = 0; q < 4; q += 2)
      if (n + q < a.N)
        *reinterpret_cast<__nv_bfloat162*>(yr + n + q) =
            __floats2bfloat162_rn(v[q], v[q + 1]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (n + q < a.N) yr[n + q] = __float2bfloat16(v[q]);
  }
}

template <int BM, int BK, int BN, bool V16>
__global__ void __launch_bounds__(kThreads, 2)
    gpp_matmul_tc_kernel(TcArgs a) {
  using Wp = Warps<BN>;
  constexpr int kMI = BM / 16;              // m16 tiles a warp
  constexpr int kRowW = BN * 2;             // bytes of a W tile row
  constexpr int kWSlot = BK * kRowW;
  constexpr int kXRow = BK * 2;
  constexpr int kXSlot = BM * kXRow;
  constexpr int kKW = BK / Wp::kK;          // k rows of a step a warp takes
  constexpr int kPRow = BN + kPartPad;      // floats a partial row
  constexpr int kPart = BM * kPRow;         // floats a k-group's partial
  extern __shared__ __align__(128) unsigned char smem[];
  char* ring = reinterpret_cast<char*>(smem);
  char* xs = ring + (size_t)a.G * kWSlot;
  float* part = reinterpret_cast<float*>(smem);  // after the last step

  const int rank = blockIdx.x;              // the cluster spans grid x
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
  const int num_k = (a.K + BK - 1) / BK;
  const int ks0 = rank * num_k / a.S;       // this CTA's k-slice
  const int num_s = (rank + 1) * num_k / a.S - ks0;
  const int live = min(BM, a.M - m0);       // rows of the tile below M
  const bool recorder = a.rec != nullptr && rank == 0 && blockIdx.y == 0 &&
                        blockIdx.z == 0 && threadIdx.x == 0;
  int rec_n = 0;
  int cur = 0;                              // the step now issuing

  auto issue = [&](int step, int c) {
    const int k0 = (ks0 + step) * BK;
    int lo, hi;
    gpp::chunk_bounds(BK, a.C, c, &lo, &hi);
    copy_tile<kRowW, V16>(
        a.wvec, ring + (size_t)(step % a.G) * kWSlot,
        reinterpret_cast<const char*>(a.w + (size_t)k0 * a.N + n0),
        (size_t)a.N * 2, lo, hi, a.K - k0, min(BN, a.N - n0) * 2);
    if (c == a.C - 1) {  // the step's x tile, in the same commit group
      copy_tile<kXRow, V16>(
          a.xvec, xs + (size_t)(step & 1) * kXSlot,
          reinterpret_cast<const char*>(a.x + (size_t)m0 * a.K + k0),
          (size_t)a.K * 2, 0, BM, live, min(BK, a.K - k0) * 2);
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
  const int kg = warp / Wp::kN;             // the warp's k-group
  const int wn0 = (warp % Wp::kN) * 16;     // and first column
  float acc[kMI][2][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  for (int s = 0; s < num_s; ++s) {
    cur = s;
    gpp::run_chunk_schedule(s, num_s, a.G, a.C, issue);
    const unsigned wb = gpp::smem_u32(ring + (size_t)(s % a.G) * kWSlot);
    const unsigned xb = gpp::smem_u32(xs + (size_t)(s & 1) * kXSlot);
#pragma unroll
    for (int t = 0; t < kKW; t += 16) {
      const int kk = kg * kKW + t;
      // matrices (k 0-7 | 8-15) x (n 0-7 | 8-15): lane l addresses row
      // k = l & 7 (+8 for odd l >> 3) of n-block l >> 4
      unsigned b[4];
      {
        const int k = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int n = wn0 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b, wb + k * kRowW + swizzle(k, n * 2));
      }
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        // lanes 0-15 rows 0-15 at k 0-7, lanes 16-31 the same rows at k 8-15
        unsigned af[4];
        const int r = i * 16 + (lane & 15);
        ldmatrix_x4(af, xb + r * kXRow + swizzle(r, (kk + (lane >> 4) * 8) * 2));
        mma_bf16(acc[i][0], af, b[0], b[1]);
        mma_bf16(acc[i][1], af, b[2], b[3]);
      }
    }
    __syncthreads();  // the ring slot and the x slot are free again
  }

  // this thread's outputs (rows i*16 + 8h + lane/4, columns wn0 + 8j +
  // 2 (lane % 4) + {0, 1}) into its k-group's partial, over the ring: every
  // copy has landed (the last steps issue none) and every warp is past its
  // last step's reads
  float* mine = part + kg * kPart;
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i * 16 + h * 8 + (lane >> 2);
      if (r >= live) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<float2*>(mine + r * kPRow + wn0 + j * 8 +
                                   2 * (lane & 3)) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
  if (a.S > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }

  // rank r sums columns [r cw, (r+1) cw) of the live rows: ranks 0 .. S-1
  // in order, each rank's k-groups in order, float4 by float4
  const int cw = BN / a.S;
  const int vrow = cw / 4;                  // float4s of a row
  const unsigned pbase = gpp::smem_u32(part);
  for (int v = threadIdx.x; v < live * vrow; v += kThreads) {
    const int r = v / vrow;
    const int c = rank * cw + (v - r * vrow) * 4;
    const unsigned off = pbase + (unsigned)(r * kPRow + c) * 4;
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int q0 = 0; q0 < a.S; q0 += 4) {
      float4 u[4][Wp::kK];
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int g = 0; g < Wp::kK; ++g)
          if (q0 + b < a.S) u[b][g] = ld_rank(off + g * kPart * 4, q0 + b);
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int g = 0; g < Wp::kK; ++g)
          if (q0 + b < a.S) {
            sum.x += u[b][g].x;
            sum.y += u[b][g].y;
            sum.z += u[b][g].z;
            sum.w += u[b][g].w;
          }
    }
    store4(a, sum, m0 + r, n0 + c);
  }
  if (a.S > 1) cluster_sync();  // the peers are done with this partial
}

// raise the kernel's dynamic shared memory limit (and ask for the largest
// shared-memory carveout), and allow clusters of 16, once per instantiation
template <int BM, int BK, int BN, bool V16>
cudaError_t prepare(size_t smem, int S) {
  static size_t smem_set = 0;
  static bool wide = false;
  auto* k = gpp_matmul_tc_kernel<BM, BK, BN, V16>;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  if (S > 8 && !wide) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    wide = true;
  }
  return cudaSuccess;
}

// launch or, with `clusters` non-null, ask how many clusters of the plan
// the card holds at once (cudaOccupancyMaxActiveClusters)
template <int BM, int BK, int BN, bool V16>
cudaError_t run(const TcArgs& a, cudaStream_t stream, int* clusters) {
  const size_t smem = smem_bytes(BM, BK, BN, a.G);
  cudaError_t e = prepare<BM, BK, BN, V16>(smem, a.S);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.S, clusters != nullptr ? 1 : (a.N + BN - 1) / BN,
                     clusters != nullptr ? 1 : (a.M + BM - 1) / BM);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr) {
    return cudaOccupancyMaxActiveClusters(
        clusters, gpp_matmul_tc_kernel<BM, BK, BN, V16>, &cfg);
  }
  e = cudaLaunchKernelEx(&cfg, gpp_matmul_tc_kernel<BM, BK, BN, V16>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int BM, int BN, bool V16>
cudaError_t run_bk(const TcArgs& a, int bk, cudaStream_t stream,
                   int* clusters) {
  if (bk == 128) return run<BM, 128, BN, V16>(a, stream, clusters);
  return run<BM, 256, BN, V16>(a, stream, clusters);
}

template <int BM, int BN>
cudaError_t run_vec(const TcArgs& a, int bk, cudaStream_t stream,
                    int* clusters) {
  if (a.wvec == 16 && a.xvec == 16) {
    return run_bk<BM, BN, true>(a, bk, stream, clusters);
  }
  return run_bk<BM, BN, false>(a, bk, stream, clusters);
}

template <int BM>
cudaError_t run_bn(const TcArgs& a, int bk, int bn, cudaStream_t stream,
                   int* clusters) {
  if (bn == 64) return run_vec<BM, 64>(a, bk, stream, clusters);
  return run_vec<BM, 128>(a, bk, stream, clusters);
}

cudaError_t run_any(const TcArgs& a, int bm, int bk, int bn,
                    cudaStream_t stream, int* clusters) {
  if (!(bm == 16 || bm == 32 || bm == 64 || bm == 128) ||
      !(bk == 128 || bk == 256) || !(bn == 64 || bn == 128) ||
      !(a.S == 1 || a.S == 2 || a.S == 4 || a.S == 8 || a.S == 16) ||
      a.G < 1 || a.C < 1 || a.C > bk) {
    return cudaErrorInvalidValue;
  }
  // a launch: every rank's k-slice holds a step
  if (clusters == nullptr &&
      (a.M < 1 || a.K < 1 || a.N < 1 || a.S > (a.K + bk - 1) / bk)) {
    return cudaErrorInvalidValue;
  }
  switch (bm) {
    case 16:
      return run_bn<16>(a, bk, bn, stream, clusters);
    case 32:
      return run_bn<32>(a, bk, bn, stream, clusters);
    case 64:
      return run_bn<64>(a, bk, bn, stream, clusters);
    default:
      return run_bn<128>(a, bk, bn, stream, clusters);
  }
}

}  // namespace
}  // namespace gpp_mm_tc

// The FMA route (gpp_matmul_kernel, gpp_matmul.cuh at E = 1).  dtype codes:
// 0 = float32, 1 = bfloat16, 2 = int8 (weights only).  scale and bias are
// (N,) f32 or null.  `grid` persistent CTAs, `vec` the cp.async width of W
// rows, `xvec` the width in bytes that x rows allow (the kernel loads 4
// elements at once from 4 elements' bytes), ws the f32 workspace of 2 (block_m x 64) slots a CTA and cnt
// one int a tile, zero at the launch and zero again after it (both unused
// when max_segs == 1).
extern "C" int gpp_matmul_launch(const void* x, const void* w,
                                 const float* scale, const float* bias,
                                 void* y, float* ws, int* cnt, int M, int K,
                                 int N, int x_dtype, int w_dtype, int bm,
                                 int bk, int G, int C, int act, int vec,
                                 int grid, int max_segs, int xvec, int* rec,
                                 void* stream) {
  const int x4 = xvec >= (x_dtype == 0 ? 16 : 8);  // 4 elements' bytes
  gpp_fma::FmaArgs a{x,  w, scale, bias, y,   ws, cnt, 1,        M,  K,
                     N,  bk, G,    C,   act, vec, x4, max_segs, rec};
  return (int)gpp_fma::run_any(a, x_dtype, w_dtype, bm, grid,
                               static_cast<cudaStream_t>(stream), nullptr);
}

// The tensor-core route (gpp_matmul_tc_kernel): bf16 x (M, K), W (K, N) and
// y (M, N); scale and bias (N,) f32 or null; a tile block_m x block_n, k
// rows a step block_k, S CTAs a cluster (grid (S, n_tiles, m_tiles));
// wvec / xvec the cp.async widths of W and x rows.
extern "C" int gpp_matmul_tc_launch(const void* x, const void* w,
                                    const float* scale, const float* bias,
                                    void* y, int M, int K, int N, int bm,
                                    int bn, int bk, int G, int C, int S,
                                    int act, int wvec, int xvec, int* rec,
                                    void* stream) {
  gpp_mm_tc::TcArgs a{static_cast<const __nv_bfloat16*>(x),
                      static_cast<const __nv_bfloat16*>(w),
                      scale, bias, static_cast<__nv_bfloat16*>(y),
                      M, K, N, S, G, C, act, wvec, xvec, rec};
  return (int)gpp_mm_tc::run_any(a, bm, bk, bn,
                                 static_cast<cudaStream_t>(stream), nullptr);
}

// Clusters of the tensor-core kernel the card holds at once at this tile,
// ring, cluster size and copy width (16: the 16-byte copies' instance;
// cudaOccupancyMaxActiveClusters, after the launch's own attribute
// settings); < 0 is minus a cudaError_t.
extern "C" int gpp_matmul_tc_max_clusters(int bm, int bn, int bk, int G,
                                          int S, int vec) {
  gpp_mm_tc::TcArgs a{};
  a.S = S;
  a.G = G;
  a.C = 1;
  a.wvec = a.xvec = vec;
  int n = 0;
  const cudaError_t e = gpp_mm_tc::run_any(a, bm, bk, bn, nullptr, &n);
  return e == cudaSuccess ? n : -(int)e;
}

extern "C" const char* gpp_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
