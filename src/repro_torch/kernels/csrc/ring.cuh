// Generalized ping-pong (GPP) shared-memory ring, shared by gpp_matmul.cu,
// gpp_matmul_grouped.cu and paged_attention.cu — the CUDA counterpart of
// the reference's `_make_chunk_ops` / `_run_chunk_schedule`
// (repro/kernels/gpp_matmul.py:192, :210).
//
// A CTA walks its own sequence of steps s = 0..S-1; the tile consumed at step
// s lives in ring slot s % G.  The tile's rows are split into C = G-1 chunks
// (chunk_bounds), and chunk c of step s's tile is issued at step s-C+c (steps
// < 0 fold into the step-0 prologue), so every step issues one tile's worth
// of bytes and the copies of C later tiles are in flight while step s
// computes.  G == 1 is in-situ, G == 2 naive ping-pong.  The order is
// exactly `chunk_issue_schedule` in repro_torch/kernels/ref.py.
//
// Copies are cp.async (16/8/4 bytes, zero-filled at ragged edges).  cp.async
// commit groups complete in order, so what a wait forces is set by how the
// chunks are grouped.  For G >= 2, step s commits, in issue order:
//   A  (step 0 only) tile 0's chunks, with any copy issued before the loop
//      (the MLA kernel's q tile);
//   P  (step 0 only) the prologue's folded chunks of steps 1..C-1;
//   B  chunk C-1 of tile s+1 alone (the grouped and one-product tensor-core
//      kernels' x tile of step s+1 rides with it);
//   R  chunk C-d of tile s+d for d = 2..G-1;
// B and R even when empty, and then waits with `cp.async.wait_group 3`.  At
// step 0 the three groups after A are P, B(0), R(0); at step s >= 1 they are
// R(s-1), B(s), R(s).  So the wait forces every chunk of tile s — chunk C-1
// is in B(s-1), chunks c < C-1 in R(<= s-2) or P — and nothing that step s-1
// issued for a later tile (at step 1, P's chunks of tiles 2..C-1 land with
// tile 1's: the issue order puts them ahead of B(0)).  A steady-state chunk c
// gets min(C-c, 2) steps to land: at G = 3 exactly the reference's per-slot
// wait (`sems.at[slot]`, C-c steps), at G >= 4 two steps for every chunk
// but a tile's last.  That is the limit of in-order cp.async groups; the
// exact per-slot ring needs TMA bulk copies on per-slot mbarriers
// (complete_tx), later work.  A host-side replay of this grouping
// (tests/_torch_parity.py::ring_replay, tests/test_torch_ring.py) checks
// these claims over G = 1..6 and S = 1..9.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gpp {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One asynchronous global->shared copy of BYTES bytes; `valid == false`
// copies nothing and zero-fills the destination (src is then not read).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = smem_u32(dst);
  const int src_size = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_size) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(BYTES), "r"(src_size) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [lo, hi) of chunk c when `rows` tile rows split into `chunks`
// (the remainder goes to the last chunk, as in the reference).
__device__ __forceinline__ void chunk_bounds(int rows, int chunks, int c,
                                             int* lo, int* hi) {
  const int base = rows / chunks;
  *lo = c * base;
  *hi = (c == chunks - 1) ? rows : *lo + base;
}

// Copy tile rows [lo, hi) into shared memory, all threads of the CTA
// cooperating.  Row r goes to dst + r * dst_stride; its source is
// src_row(r) (nullptr for a row past the tensor's edge), of which the first
// `valid_bytes` of `copy_bytes` exist — the rest is zero-filled.  VEC is the
// copy width; VEC == 1 is a synchronous byte copy for rows whose size or
// alignment admits no cp.async width.
template <int VEC, typename SrcRow>
__device__ __forceinline__ void copy_rows(char* dst, int dst_stride, int lo,
                                          int hi, int copy_bytes,
                                          int valid_bytes, SrcRow src_row,
                                          const char* any_src) {
  const int per_row = copy_bytes / VEC;
  const int total = (hi - lo) * per_row;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = lo + i / per_row;
    const int off = (i % per_row) * VEC;
    const char* src = src_row(r);
    const bool ok = src != nullptr && off < valid_bytes;
    char* d = dst + (size_t)r * dst_stride + off;
    if constexpr (VEC == 1) {
      *d = ok ? src[off] : 0;
    } else {
      cp_async<VEC>(d, ok ? src + off : any_src, ok);
    }
  }
}

template <typename SrcRow>
__device__ __forceinline__ void copy_rows_vec(int vec, char* dst,
                                              int dst_stride, int lo, int hi,
                                              int copy_bytes, int valid_bytes,
                                              SrcRow src_row,
                                              const char* any_src) {
  switch (vec) {
    case 16:
      copy_rows<16>(dst, dst_stride, lo, hi, copy_bytes, valid_bytes, src_row,
                    any_src);
      break;
    case 8:
      copy_rows<8>(dst, dst_stride, lo, hi, copy_bytes, valid_bytes, src_row,
                   any_src);
      break;
    case 4:
      copy_rows<4>(dst, dst_stride, lo, hi, copy_bytes, valid_bytes, src_row,
                   any_src);
      break;
    default:
      copy_rows<1>(dst, dst_stride, lo, hi, copy_bytes, valid_bytes, src_row,
                   any_src);
  }
}

// Step s of S on the GPP chunk schedule: issue this step's chunks through
// issue(step, chunk), in the commit groups of the header, then wait until
// every chunk of step s's own tile has landed and make it visible to the
// whole CTA.  `issue` may decline a chunk (a dead tile): it must then
// decline it at every step, which a predicate pure in (step) guarantees —
// the wait needs no predicate because an empty copy completes at once.
template <typename Issue>
__device__ __forceinline__ void run_chunk_schedule(int s, int S, int G, int C,
                                                   Issue issue) {
  if (G == 1) {                        // in-situ: fetch, wait, compute
    issue(s, 0);
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    if (s == 0) {
      for (int c = 0; c < C; ++c) issue(0, c);
      cp_async_commit();               // A: tile 0 (step 0 computes at once)
      for (int d = 1; d < C && d < S; ++d) {
        for (int c = 0; c < C - d; ++c) issue(d, c);
      }
      cp_async_commit();               // P: folded chunks of steps 1..C-1
    }
    if (s + 1 < S) issue(s + 1, C - 1);
    cp_async_commit();                 // B: the next tile's last chunk
    for (int d = 2; d < G; ++d) {      // R: chunk C-d of step s+d
      const int c = C - d;
      if (c >= 0 && s + d < S) issue(s + d, c);
    }
    cp_async_commit();
    cp_async_wait<3>();                // all but R(s-1), B(s), R(s)
  }
  __syncthreads();
}

}  // namespace gpp
