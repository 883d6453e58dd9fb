// gpp_matmul for sm_90a: y = act((x @ W) * w_scale + bias), f32 accumulation.
//
// Replaces repro/kernels/gpp_matmul.py::gpp_matmul (the Pallas TPU kernel,
// pallas_call at :408, body _gpp_kernel at :247).
//
// Each CTA owns one (block_m, 64) output tile and walks its k-steps; the
// (block_k, 64) W tile of each step (block_k <= 256) streams into a G-slot
// shared-memory ring on the generalized ping-pong chunk schedule
// (ring.cuh): G == 1 in-situ, G == 2 naive ping-pong, G >= 3 generalized
// ping-pong with C = G-1 chunks of the block_k rows.  bf16 and int8 weights
// are copied raw and widened to f32 in registers; the epilogue (per-column
// dequant scale, bias, one of six activations — gelu in its tanh form) runs
// in f32 before the store.  Ragged M/N/K edges are zero-filled in shared
// memory.  Each thread owns one output column of ROWS rows (block_m =
// 4 * ROWS, a compile-time count).
//
// What bounds it on the H100: at decode (M = 4 lanes) the W bytes — the
// matmul does about 4 FLOPs per weight byte, far below the 295 FLOP/byte
// ridge.  On the GPP schedule every step issues one tile's worth of chunks
// spread over the next C tiles, and the last chunk of a tile is issued one
// step before it is used, so each k-step waits about one memory round trip;
// 256-row k-steps spread that wait over 32 KB of bf16 W, and the x tile's
// loads are in flight during it.  At large M the FLOPs bound it, which this
// plain-FMA first version runs on the CUDA cores, not the tensor cores
// (wgmma is later work).
//
// C interface (ctypes): gpp_matmul_launch returns the cudaError_t of the
// launch; when `rec` is non-null, CTA (0, 0) writes one (step, chunk,
// issue_step) triple per chunk it issues.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockN = 64;                       // one column per thread
constexpr int kRowGroups = kThreads / kBlockN;    // 4
constexpr int kMaxRowsPerThread = 16;             // block_m <= 64
constexpr int kBlockK = 256;                      // block_k <= 256

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

struct GppArgs {
  const void* x;       // (M, K) row-major
  const void* w;       // (K, N) row-major
  const float* scale;  // (N,) f32 or null
  const float* bias;   // (N,) f32 or null
  void* y;             // (M, N) row-major, x's dtype
  int M, K, N;
  int bm, bk;          // tile rows of x / W per step (bn = 64)
  int G, C;            // ring depth, chunks per tile
  int act;
  int vec;             // cp.async width for W rows: 16, 8, 4 or 1
  int* rec;            // issue-order record or null
};

template <typename XT, typename WT, int ROWS>
__global__ void __launch_bounds__(kThreads) gpp_matmul_kernel(GppArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  WT* ring = reinterpret_cast<WT*>(smem);
  float* xs = reinterpret_cast<float*>(
      smem + (size_t)a.G * a.bk * kBlockN * sizeof(WT));
  const XT* x = static_cast<const XT*>(a.x);
  const WT* w = static_cast<const WT*>(a.w);
  const int bm = kRowGroups * ROWS;
  const int n0 = blockIdx.x * kBlockN;
  const int m0 = blockIdx.y * bm;
  const int num_k = (a.K + a.bk - 1) / a.bk;
  const int row_bytes = kBlockN * (int)sizeof(WT);
  const int valid_bytes = min(kBlockN, a.N - n0) * (int)sizeof(WT);
  const bool recorder = a.rec != nullptr && blockIdx.x == 0 &&
                        blockIdx.y == 0 && threadIdx.x == 0;
  int rec_n = 0;
  int cur = 0;  // the step now issuing

  auto issue = [&](int step, int c) {
    int lo, hi;
    gpp::chunk_bounds(a.bk, a.C, c, &lo, &hi);
    const int k0 = step * a.bk;
    char* dst = reinterpret_cast<char*>(ring + (size_t)(step % a.G) * a.bk *
                                                   kBlockN);
    auto src_row = [&](int r) -> const char* {
      const int k = k0 + r;
      return k < a.K ? reinterpret_cast<const char*>(w + (size_t)k * a.N + n0)
                     : nullptr;
    };
    gpp::copy_rows_vec(a.vec, dst, row_bytes, lo, hi, row_bytes, valid_bytes,
                       src_row, reinterpret_cast<const char*>(w));
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
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = 0.0f;

  for (int s = 0; s < num_k; ++s) {
    cur = s;
    const int k0 = s * a.bk;
    // this step's x tile (bm x bk, at most 4 * ROWS elements a thread) into
    // registers: the loads are in flight while the ring waits for the W tile
    constexpr int kXPerThread = ROWS * kRowGroups * kBlockK / kThreads;
    float xr[kXPerThread];
#pragma unroll
    for (int j = 0; j < kXPerThread; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / a.bk, kk = i % a.bk;
      const int m = m0 + r, k = k0 + kk;
      xr[j] = (r < bm && m < a.M && k < a.K)
                  ? to_f32(x[(size_t)m * a.K + k]) : 0.0f;
    }
    gpp::run_chunk_schedule(s, num_k, a.G, a.C, issue);
#pragma unroll
    for (int j = 0; j < kXPerThread; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < bm * a.bk) xs[i] = xr[j];
    }
    __syncthreads();
    const WT* wt = ring + (size_t)(s % a.G) * a.bk * kBlockN;
    const int kt = min(a.bk, a.K - k0);
#pragma unroll 4
    for (int kk = 0; kk < kt; ++kk) {
      const float wv = to_f32(wt[kk * kBlockN + col]);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        acc[i] = fmaf(xs[(rg + i * kRowGroups) * a.bk + kk], wv, acc[i]);
      }
    }
    __syncthreads();  // the slot and the x tile are free for the next step
  }

  const int n = n0 + col;
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

template <typename XT, typename WT, int ROWS>
cudaError_t launch(const GppArgs& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.G * a.bk * kBlockN * sizeof(WT) +
                      (size_t)a.bm * a.bk * sizeof(float);
  static size_t smem_set = 0;  // per instantiation: raise the limit once
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        gpp_matmul_kernel<XT, WT, ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const dim3 grid((a.N + kBlockN - 1) / kBlockN, (a.M + a.bm - 1) / a.bm);
  gpp_matmul_kernel<XT, WT, ROWS><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// rows per thread is a compile-time count: block_m = 4 * ROWS
template <typename XT, typename WT>
cudaError_t launch_rows(const GppArgs& a, cudaStream_t stream) {
  switch (a.bm / kRowGroups) {
    case 1:
      return launch<XT, WT, 1>(a, stream);
    case 2:
      return launch<XT, WT, 2>(a, stream);
    case 4:
      return launch<XT, WT, 4>(a, stream);
    case 8:
      return launch<XT, WT, 8>(a, stream);
    case 16:
      return launch<XT, WT, 16>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t launch_w(const GppArgs& a, int w_dtype, cudaStream_t stream) {
  switch (w_dtype) {
    case 0:
      return launch_rows<XT, float>(a, stream);
    case 1:
      return launch_rows<XT, __nv_bfloat16>(a, stream);
    case 2:
      return launch_rows<XT, int8_t>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (weights only).
extern "C" int gpp_matmul_launch(const void* x, const void* w,
                                 const float* scale, const float* bias,
                                 void* y, int M, int K, int N, int x_dtype,
                                 int w_dtype, int bm, int bk, int G, int C,
                                 int act, int vec, int* rec, void* stream) {
  if (bm < kRowGroups || bm % kRowGroups ||
      bm > kRowGroups * kMaxRowsPerThread || G < 1 || C < 1 || bk < 1 ||
      bk > kBlockK) {
    return (int)cudaErrorInvalidValue;
  }
  GppArgs a{x, w, scale, bias, y, M, K, N, bm, bk, G, C, act, vec, rec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0:
      return (int)launch_w<float>(a, w_dtype, st);
    case 1:
      return (int)launch_w<__nv_bfloat16>(a, w_dtype, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* gpp_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
