// Tensor-core building blocks for sm_90a, shared by the bf16 kernels
// (gpp_matmul_grouped.cu's tensor-core route, paged_attention.cu's MLA
// tensor-core route): ldmatrix from shared memory, mma.sync m16n8k16 bf16
// with f32 accumulators, and the XOR swizzle that keeps ldmatrix free of
// bank conflicts without padding bytes.
//
// Shared-memory rows are whole multiples of 128 bytes; 16-byte chunk j of
// row r sits at chunk (j & ~7) | ((j ^ r) & 7), so the 8 rows an ldmatrix
// phase reads fall in 8 distinct bank groups.
#pragma once

#include <cuda_runtime.h>

// Internal linkage, as gpp_matmul.cuh: each kernel library keeps its own
// copy.
namespace gpp_mma {
namespace {

// byte offset of byte `off` of row r: 16-byte chunk j sits at j ^ (r & 7)
__device__ __forceinline__ int swizzle(int r, int off) {
  const int j = off >> 4;
  return ((j & ~7) | ((j ^ r) & 7)) << 4 | (off & 15);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
}  // namespace gpp_mma
