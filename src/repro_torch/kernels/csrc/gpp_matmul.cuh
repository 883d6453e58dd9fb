// The gpp_matmul tile kernel for sm_90a: the FMA route of
// gpp_matmul_grouped.cu (one product per expert),
//   y[e] = act((x[e] @ W[e]) * w_scale[e] + bias[e]), f32 accumulation.
// gpp_matmul.cu's FMA route is its own split-K kernel and uses only the
// helpers here (dtype widening, the activations); including the header
// still compiles this kernel into that library, where nothing launches it.
//
// Each CTA owns one (block_m, 64) output tile position and walks the
// k-steps of `epc` consecutive experts e0 .. e0+epc-1 (blockIdx.z = e0 /
// epc) as ONE run of steps s = (e - e0) * num_k + k — the reference's
// grouped kernel orders its global steps expert-major the same way
// (repro/kernels/gpp_matmul.py:433).  The (block_k, 64) W tile of each step
// (block_k <= 256) streams into a G-slot shared-memory ring on the
// generalized ping-pong chunk schedule (ring.cuh): G == 1 in-situ, G == 2
// naive ping-pong, G >= 3 generalized ping-pong with C = G-1 chunks of the
// block_k rows.  Because the schedule runs over the CTA's whole run, the
// first W chunks of expert e+1 are in flight while expert e's last k-steps
// compute.  A single product is the case E = epc = 1 (gpp_matmul_grouped
// at E = 1 is how the split-K kernel's yardstick runs it).
//
// bf16 and int8 weights are copied raw and widened to f32 in registers; the
// epilogue (per-column dequant scale, bias, one of six activations — gelu in
// its tanh form) runs in f32 before the store, once per expert.  Ragged
// M/N/K edges are zero-filled in shared memory.  Each thread owns one output
// column of ROWS rows (block_m = 4 * ROWS, a compile-time count).
//
// What bounds it on the H100: at decode (M = 4 lanes, or the MoE path's 32
// rows per expert) the W bytes — a few FLOPs per weight byte, far below the
// 295 FLOP/byte ridge.  On the GPP schedule every step issues one tile's
// worth of chunks spread over the next C tiles, and the last chunk of a tile
// is issued one step before it is used, so each k-step waits about one
// memory round trip; 256-row k-steps spread that wait over 32 KB of bf16 W,
// and the x tile's loads are in flight during it.  At large M the FLOPs
// bound it, which this plain-FMA first version runs on the CUDA cores, not
// the tensor cores (wgmma is later work).
//
// When `rec` is non-null, CTA (0, 0, 0) writes one (step, chunk, issue_step)
// triple per chunk it issues, over its whole run of steps.
//
// The including source names the __global__ kernel (GPP_KERNEL), so the
// one-product and grouped launches show apart in a profiler trace.
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
// launch() — with external linkage two loaded libraries would share one
// (a unique global symbol) and the second would skip raising its own
// kernel's shared-memory limit.
namespace gpp_tile {
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
  const void* x;       // (E, M, K) row-major
  const void* w;       // (E, K, N) row-major
  const float* scale;  // (E, N) f32 or null
  const float* bias;   // (E, N) f32 or null
  void* y;             // (E, M, N) row-major, x's dtype
  int E, M, K, N;
  int epc;             // experts per CTA (consecutive), grid.z = ceil(E/epc)
  int bm, bk;          // tile rows of x / W per step (bn = 64)
  int G, C;            // ring depth, chunks per tile
  int act;
  int vec;             // cp.async width for W rows: 16, 8, 4 or 1
  int* rec;            // issue-order record or null
};

template <typename XT, typename WT, int ROWS>
__global__ void __launch_bounds__(kThreads) GPP_KERNEL(GppArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  WT* ring = reinterpret_cast<WT*>(smem);
  float* xs = reinterpret_cast<float*>(
      smem + (size_t)a.G * a.bk * kBlockN * sizeof(WT));
  const XT* x = static_cast<const XT*>(a.x);
  const WT* w = static_cast<const WT*>(a.w);
  const int bm = kRowGroups * ROWS;
  const int n0 = blockIdx.x * kBlockN;
  const int m0 = blockIdx.y * bm;
  const int e0 = blockIdx.z * a.epc;
  const int num_e = min(a.epc, a.E - e0);
  const int num_k = (a.K + a.bk - 1) / a.bk;
  const int num_s = num_e * num_k;   // this CTA's run of steps
  const int row_bytes = kBlockN * (int)sizeof(WT);
  const int valid_bytes = min(kBlockN, a.N - n0) * (int)sizeof(WT);
  const bool recorder = a.rec != nullptr && blockIdx.x == 0 &&
                        blockIdx.y == 0 && blockIdx.z == 0 &&
                        threadIdx.x == 0;
  int rec_n = 0;
  int cur = 0;  // the step now issuing

  auto issue = [&](int step, int c) {
    int lo, hi;
    gpp::chunk_bounds(a.bk, a.C, c, &lo, &hi);
    const int e = e0 + step / num_k;
    const int k0 = (step % num_k) * a.bk;
    const WT* we = w + (size_t)e * a.K * a.N;
    char* dst = reinterpret_cast<char*>(ring + (size_t)(step % a.G) * a.bk *
                                                   kBlockN);
    auto src_row = [&](int r) -> const char* {
      const int k = k0 + r;
      return k < a.K ? reinterpret_cast<const char*>(we + (size_t)k * a.N + n0)
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

  for (int s = 0; s < num_s; ++s) {
    cur = s;
    const int e = e0 + s / num_k;
    const int ks = s % num_k;
    const int k0 = ks * a.bk;
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) acc[i] = 0.0f;
    }
    const XT* xe = x + (size_t)e * a.M * a.K;
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
                  ? to_f32(xe[(size_t)m * a.K + k]) : 0.0f;
    }
    gpp::run_chunk_schedule(s, num_s, a.G, a.C, issue);
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

    const int n = n0 + col;
    if (ks == num_k - 1 && n < a.N) {  // expert e's epilogue
      const size_t en = (size_t)e * a.N + n;
      const float sc = a.scale != nullptr ? a.scale[en] : 1.0f;
      const float b = a.bias != nullptr ? a.bias[en] : 0.0f;
      XT* y = static_cast<XT*>(a.y) + (size_t)e * a.M * a.N;
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
  }
}

template <typename XT, typename WT, int ROWS>
cudaError_t launch(const GppArgs& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.G * a.bk * kBlockN * sizeof(WT) +
                      (size_t)a.bm * a.bk * sizeof(float);
  static size_t smem_set = 0;  // per instantiation: raise the limit once
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        GPP_KERNEL<XT, WT, ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const dim3 grid((a.N + kBlockN - 1) / kBlockN, (a.M + a.bm - 1) / a.bm,
                  (a.E + a.epc - 1) / a.epc);
  GPP_KERNEL<XT, WT, ROWS><<<grid, kThreads, smem, stream>>>(a);
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

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (weights only).
inline cudaError_t launch_any(const GppArgs& a, int x_dtype, int w_dtype,
                              cudaStream_t stream) {
  if (a.bm < kRowGroups || a.bm % kRowGroups ||
      a.bm > kRowGroups * kMaxRowsPerThread || a.G < 1 || a.C < 1 ||
      a.bk < 1 || a.bk > kBlockK || a.E < 1 || a.epc < 1) {
    return cudaErrorInvalidValue;
  }
  switch (x_dtype) {
    case 0:
      return launch_w<float>(a, w_dtype, stream);
    case 1:
      return launch_w<__nv_bfloat16>(a, w_dtype, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace gpp_tile
