// RMSNorm for sm_90a, row-invariant: y = x * rsqrt(mean(x^2) + eps) * scale
// over the last dim, whose output bits depend on the row alone.
//
// Not the port of a TPU kernel: the JAX package leaves RMSNorm
// (repro/models/layers.py rmsnorm) to XLA.  The port ran it as plain
// PyTorch, whose torch.mean picks a reduction order from the tensor's
// shape, so a lane's row got a different f32 mean at decode (one row a
// lane) than at verify (draft_len + 1 rows) and bf16 greedy streams with
// speculation on and off could part, where the reference guarantees they
// do not.  This kernel fixes the order of the sum:
//  * one CTA owns one row;
//  * its thread count comes from the width and dtype alone (one 16-byte
//    vector of the row a thread, rounded up to whole warps, at most 256),
//    never from the row count;
//  * thread t sums the squares of vectors t, t + T, t + 2T, ... in that
//    order, each vector's elements in order;
//  * the warp adds its lanes' sums by a fixed xor butterfly (every lane
//    ends with the same bits, since f32 addition commutes), and every
//    thread adds the warps' sums in warp order through shared memory.
// Then, in the plain version's steps (kernels.ref.rmsnorm_ref):
// r = rsqrt(sum / d + eps), y = (x * r) * scale in f32, cast to x's dtype.
//
// What bounds it on the H100: the bytes (the row read twice, the second
// time from L1, and written once); at the serving path's 1-32 rows a
// launch, the launch and one memory round trip.
//
// C interface (ctypes): rmsnorm_launch returns the launch's cudaError_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxThreads = 256;

// the 16-byte vector at p as floats
__device__ __forceinline__ void load_vec(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ void load_vec(const bf16* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store_vec(bf16* p, const float (&f)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 t =
        __float22bfloat162_rn(make_float2(f[2 * i], f[2 * i + 1]));
    w[i] = *reinterpret_cast<const unsigned*>(&t);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// threads of a row's CTA: from the width and dtype alone
__host__ __device__ constexpr int threads_for(int d, int elem_bytes) {
  const int nv = d * elem_bytes / 16;
  const int t = (nv + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const T* x, long long x_stride, const T* scale, T* y,
                   int d, float eps) {
  constexpr int E = 16 / sizeof(T);    // elements of a 16-byte vector
  __shared__ float part[kMaxThreads / 32];
  const T* xr = x + (size_t)blockIdx.x * x_stride;
  T* yr = y + (size_t)blockIdx.x * d;
  const int nv = d / E;
  float ss = 0.0f;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    float f[E];
    load_vec(xr + i * E, f);
#pragma unroll
    for (int e = 0; e < E; ++e) ss = __fadd_rn(ss, __fmul_rn(f[e], f[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float tot = 0.0f;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) tot = __fadd_rn(tot, part[w]);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(tot, (float)d), eps));
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    float f[E], s[E];
    load_vec(xr + i * E, f);
    load_vec(scale + i * E, s);
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = __fmul_rn(__fmul_rn(f[e], r), s[e]);
    store_vec(yr + i * E, f);
  }
}

template <typename T>
cudaError_t launch(const void* x, long long x_stride, const void* scale,
                   void* y, int rows, int d, float eps, cudaStream_t st) {
  const int threads = threads_for(d, (int)sizeof(T));
  rmsnorm_kernel<T><<<rows, threads, 0, st>>>(
      static_cast<const T*>(x), x_stride, static_cast<const T*>(scale),
      static_cast<T*>(y), d, eps);
  return cudaGetLastError();
}

}  // namespace

// x: `rows` rows of d elements, row r at x + r * x_stride (elements; the
// row's elements contiguous, 16-byte aligned); scale: (d,), 16-byte
// aligned; y: (rows, d) contiguous.  One dtype for all three: 0 = float32,
// 1 = bfloat16.  d must be a multiple of 8.
extern "C" int rmsnorm_launch(const void* x, long long x_stride,
                              const void* scale, void* y, int rows, int d,
                              float eps, int dtype, void* stream) {
  if (rows < 1 || d < 8 || d % 8 != 0 || x_stride < d) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, x_stride, scale, y, rows, d, eps, st);
    case 1:
      return (int)launch<bf16>(x, x_stride, scale, y, rows, d, eps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
