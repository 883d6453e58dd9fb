// Tensor-core building blocks for sm_90a, shared by the bf16 kernels
// (the tensor-core routes of gpp_matmul.cu and gpp_matmul_grouped.cu,
// paged_attention.cu's MLA tensor-core route): ldmatrix from shared memory,
// mma.sync m16n8k16 bf16 with f32 accumulators, the XOR swizzle that keeps
// ldmatrix free of bank conflicts without padding bytes, and the cp.async
// tile copy that lays rows out in it.
//
// Shared-memory rows are whole multiples of 128 bytes; 16-byte chunk j of
// row r sits at chunk (j & ~7) | ((j ^ r) & 7), so the 8 rows an ldmatrix
// phase reads fall in 8 distinct bank groups.
#pragma once

#include <cuda_runtime.h>

#include "ring.cuh"

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

constexpr int kCopyThreads = 256;  // the matmul kernels' CTA size

// Copy rows [lo, hi) of a tile (ROW_BYTES a row in shared memory, swizzled)
// from src + r * src_stride bytes.  Row r exists for r < rows_valid, with
// its first valid_bytes bytes; the rest is zero-filled.  With 16-byte
// copies each thread owns one column chunk and strides rows by a multiple
// of 8, so its swizzled column and its pointer steps are fixed; VEC == 1
// is a synchronous byte copy for rows with no cp.async width.
template <int ROW_BYTES, int VEC>
__device__ __forceinline__ void copy_rows(char* dst, const char* src,
                                          size_t src_stride, int lo, int hi,
                                          int rows_valid, int valid_bytes) {
  constexpr int kPerRow = ROW_BYTES / VEC;
  if constexpr (VEC == 16) {
    constexpr int kRowStep = kCopyThreads / kPerRow;
    static_assert(kRowStep % 8 == 0, "the swizzle repeats every 8 rows");
    const int j = threadIdx.x % kPerRow;
    const bool col_ok = j * 16 < valid_bytes;
    int r = lo + threadIdx.x / kPerRow;
    char* d = dst + r * ROW_BYTES + swizzle(r, j * 16);
    const char* s = src + r * src_stride + j * 16;
    for (; r < hi; r += kRowStep) {
      const bool ok = col_ok && r < rows_valid;
      gpp::cp_async<16>(d, ok ? s : src, ok);
      d += kRowStep * ROW_BYTES;
      s += kRowStep * src_stride;
    }
  } else {
    for (int i = threadIdx.x; i < (hi - lo) * kPerRow; i += kCopyThreads) {
      const int r = lo + i / kPerRow;
      const int off = (i % kPerRow) * VEC;
      const bool ok = r < rows_valid && off < valid_bytes;
      const char* s = src + r * src_stride + off;
      char* d = dst + r * ROW_BYTES + swizzle(r, off);
      if constexpr (VEC == 1) {
        *d = ok ? *s : 0;
      } else {
        gpp::cp_async<VEC>(d, ok ? s : src, ok);
      }
    }
  }
}

template <int ROW_BYTES>
__device__ __forceinline__ void copy_rows_vec(int vec, char* dst,
                                              const char* src,
                                              size_t src_stride, int lo,
                                              int hi, int rows_valid,
                                              int valid_bytes) {
  switch (vec) {
    case 16:
      copy_rows<ROW_BYTES, 16>(dst, src, src_stride, lo, hi, rows_valid,
                               valid_bytes);
      break;
    case 8:
      copy_rows<ROW_BYTES, 8>(dst, src, src_stride, lo, hi, rows_valid,
                              valid_bytes);
      break;
    case 4:
      copy_rows<ROW_BYTES, 4>(dst, src, src_stride, lo, hi, rows_valid,
                              valid_bytes);
      break;
    default:
      copy_rows<ROW_BYTES, 1>(dst, src, src_stride, lo, hi, rows_valid,
                              valid_bytes);
  }
}

}  // namespace
}  // namespace gpp_mma
