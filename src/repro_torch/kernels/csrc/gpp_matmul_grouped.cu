// gpp_matmul_grouped for sm_90a: per expert e,
//   y[e] = act((x[e] @ W[e]) * w_scale[e] + bias[e]), f32 accumulation.
//
// Replaces repro/kernels/gpp_matmul.py::gpp_matmul_grouped (the Pallas TPU
// kernel, pallas_call at :606, body _gpp_grouped_kernel at :433): the MoE
// layer's routed-expert FFN, (E, M, K) @ (E, K, N) with M the rows each
// expert's capacity gives it.
//
// The tile kernel is gpp_matmul.cuh's, with the expert axis in the grid:
// CTA (n, m, z) owns output tile (m, n) of experts z*epc .. z*epc+epc-1 and
// walks their k-steps expert-major on one G-slot ring, so the W chunks of
// the next expert stream while the current one finishes — the TPU kernel's
// "expert axis is the outermost ring dimension".  Every expert streams its
// weights on every call, rows or none (the reference's dense_grouped does
// the same); skipping empty experts is later work.
//
// What bounds it on the H100: the expert weight bytes.  A decode step's
// launch reads all 64 experts' (2048 x 1408) bf16 matrices, 369 MB, against
// 2 * 32 * 2048 * 1408 * 64 = 11.8 GFLOP — 32 operations a byte, below the
// 295 FLOP/byte ridge, so 0.11 ms at 3.35 TB/s is the floor; at prefill
// (128 rows an expert) the plain-FMA CUDA-core loop, not the bytes, sets
// the time.  `experts_per_cta` (planned by core.schedule.plan_grouped_sm90)
// trades ring fills against CTAs in flight.
//
// C interface (ctypes): gpp_matmul_grouped_launch returns the launch's
// cudaError_t; with `rec` non-null, CTA (0, 0, 0) writes one (step, chunk,
// issue_step) triple per chunk it issues across its experts' steps.
#define GPP_KERNEL gpp_matmul_grouped_kernel
#include "gpp_matmul.cuh"

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (weights only).
// scale and bias are (E, N) f32 or null.
extern "C" int gpp_matmul_grouped_launch(
    const void* x, const void* w, const float* scale, const float* bias,
    void* y, int E, int M, int K, int N, int epc, int x_dtype, int w_dtype,
    int bm, int bk, int G, int C, int act, int vec, int* rec, void* stream) {
  gpp_tile::GppArgs a{x, w, scale, bias, y, E, M, K, N, epc,
                      bm, bk, G, C, act, vec, rec};
  return (int)gpp_tile::launch_any(a, x_dtype, w_dtype,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* gpp_matmul_grouped_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
