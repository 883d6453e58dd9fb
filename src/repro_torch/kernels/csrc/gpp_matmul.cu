// gpp_matmul for sm_90a: y = act((x @ W) * w_scale + bias), f32 accumulation.
//
// Replaces repro/kernels/gpp_matmul.py::gpp_matmul (the Pallas TPU kernel,
// pallas_call at :408, body _gpp_kernel at :247).  The tile kernel, its
// ring and what bounds it are in gpp_matmul.cuh; this is its one-product
// entry (E = 1, one expert per CTA).
//
// C interface (ctypes): gpp_matmul_launch returns the cudaError_t of the
// launch; when `rec` is non-null, CTA (0, 0) writes one (step, chunk,
// issue_step) triple per chunk it issues.
#define GPP_KERNEL gpp_matmul_kernel
#include "gpp_matmul.cuh"

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (weights only).
extern "C" int gpp_matmul_launch(const void* x, const void* w,
                                 const float* scale, const float* bias,
                                 void* y, int M, int K, int N, int x_dtype,
                                 int w_dtype, int bm, int bk, int G, int C,
                                 int act, int vec, int* rec, void* stream) {
  gpp_tile::GppArgs a{x, w, scale, bias, y, 1, M, K, N, 1,
                      bm, bk, G, C, act, vec, rec};
  return (int)gpp_tile::launch_any(a, x_dtype, w_dtype,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* gpp_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
