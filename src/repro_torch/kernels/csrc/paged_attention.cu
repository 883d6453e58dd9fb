// Paged attention (GQA, optional sliding window, and MLA) for sm_90a.
//
// Replaces repro/kernels/paged_attention.py::paged_attention (the Pallas TPU
// kernel, pallas_call at :341, body _paged_attn_kernel :111), both its
// GQA/window path and its `mla=True` path (:173-177).  Five kernels, five
// C entries (and two queries of a launch's shape):
//
// * paged_attention_kernel / paged_attention_mla_kernel (entry
//   paged_attention_launch): CUDA-core FMA kernels, split-KV over fixed
//   runs of pieces of the lane's keys.  GQA in f32, and in bf16 at shapes
//   the GQA tensor-core kernel does not take; MLA in f32, and in bf16 at
//   block sizes the MLA tensor-core kernel does not take.
// * paged_attention_mla_tc_kernel (entry paged_attention_mla_tc_launch)
//   and paged_attention_tc_kernel (paged_attention_tc_launch): bf16 MLA and
//   bf16 GQA / window on the tensor cores with the KV walk split across
//   CTAs.
// * paged_attention_merge_kernel (paged_attention_merge_launch, f32 or
//   bf16 out) merges any of the four split kernels' partials.
// Each after its own notes further down.
//
// Two pools, a and b.  GQA: a = K, b = V, one head_dim for both.  MLA
// (weight-absorbed, the TPU kernel's form): a = c_kv (the 512-wide latent),
// b = k_rope (64), one shared KV head; the key row is concat(a, b) (576)
// and the VALUE is the a row itself — read from the same shared-memory row
// as the key, as on the TPU.  The output is then the latent (rows x 512),
// which the caller up-projects.
//
// C interface (ctypes): the launch entries return the launch's
// cudaError_t.  The kernels only read the pools.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "ring.cuh"

// ---------------------------------------------------------------------------
// paged_attention_kernel / paged_attention_mla_kernel: the FMA route.
//
// The same function as _paged_attn_kernel: logits = q . k in f32 (q
// pre-scaled in f32 and cast to the KV dtype by the wrapper; MLA: the key
// is concat(c_kv, k_rope)), -inf where kpos > qpos (qpos = pos + row % S)
// or the key is behind the window, online softmax with f32 m / l / acc, p
// rounded through the KV dtype before p . v (MLA: v = the c_kv row), out =
// acc / max(l, 1e-30) in the KV dtype.  No TF32 and no tensor cores: the
// f32 route is held to 2e-4 and to the plain run's greedy streams.
//
// What bounds it on the H100: latency and shared-memory bandwidth, not HBM
// bytes.  A decode call reads ~0.4 MB of f32 latent rows (0.1 us at 3.35
// TB/s); the whole-block design before this one spent 240 us on it (MLA
// f32) with 4 CTAs for 132 SMs, each walking every block of its lane with
// one scalar (row, key) dot a thread, and could not hold a 128-token f32
// block (or any 256-token one) in shared memory at all.  The design:
//  1. Pieces and runs.  A lane's keys [0, MB * bs) are cut into pieces of
//     P tokens (P a power of two dividing bs, at most 32: the planner,
//     core.schedule.plan_paged_attn_fma_sm90, takes the largest <= 16, MLA
//     <= 8, whose ring fits), and the pieces into kv_splits fixed runs
//     (kv_runs; at most 32), from the table width, bs and the widths
//     alone — never from B, S or the positions — so a lane's row sums in
//     the same order at decode, verify and prefill.  A ring slot holds
//     one piece, so any block size the reference serves fits, and a live
//     block's dead tokens beyond the last live piece are not copied.
//  2. Grid: one CTA per (lane, KV head, 16-row tile of the rep x S
//     head-major rows, run).  Each CTA finds its run's live pieces on the
//     device (the live predicate at piece granularity, an interval) and
//     walks only those: a dead piece costs no copy, no compute and no step;
//     a run with none leaves an empty partial (m = -inf, l = 0).  A partly
//     live piece is copied whole, so a masked key's p = 0 multiplies a row
//     that was written, never a stale slot.
//  3. The GPP ring inside a run: the live pieces are the steps of ring.cuh's
//     chunk schedule (G slots, C = G - 1 chunks of a piece's rows), G in
//     {1, 2, >= 3} pinnable.  The q tile (KV dtype, the key rows' layout)
//     joins step 0's first commit group.
//  4. Register-tiled FMA.  Warp w owns rows 4w..4w+3 of the tile through
//     the whole step (q . k, softmax, p . v), so the only CTA barriers are
//     the ring's.  q . k: lane = (key group, k-slice); it holds a 4 row x
//     KQ key tile of logits (KQ = min(4, P), keys kg + KG i) over its
//     k-slice (16-byte chunks ks, ks + NKS, ... of the row; a bf16 chunk
//     widens to f32 in registers), then the k-slices sum by a fixed xor
//     butterfly.  Softmax: max and sum over the key groups by xor shuffles;
//     m and l stay in registers.  p . v: p (rounded through the KV dtype)
//     goes to the warp's own 16 x P floats of shared memory; each lane owns
//     4 rows x (VW x NV) value columns of acc in registers for the whole
//     run (MLA 512: 64 floats), reading 16- or 8-byte vectors of the value
//     rows.  Warps whose 4 rows are all past rS skip the compute.
//  5. One merged output.  With kv_splits == 1 the CTA writes out; otherwise
//     its partial (f32 acc of its live rows, then (m, l)) goes to a
//     workspace and paged_attention_merge_kernel merges each (lane, KV
//     head, tile)'s runs.
// Every choice (P, the runs, the layout of a row's sums) follows the
// widths, bs and MB alone, so a row's bits depend on the row, its lane's
// cache and its position only: a piece live for a later row of the tile
// but not for this one is an exact no-op for it (corr = 1, p = 0).
//
// With `rec` non-null, CTA `rec_cta` (linear index ((lane * KVH + head) *
// row_tiles + tile) * kv_splits + split) writes one (step, chunk,
// issue_step) triple per chunk it issues over its run's live pieces.
namespace fma_attn {
namespace {

constexpr int kRows = 16;            // query rows of a tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRW = kRows / kWarps;  // rows a warp owns
constexpr int kKQ = 4;               // keys a lane holds in q . k, at most
constexpr int kMaxPiece = 32;        // NKS = 128 / P >= 4 k-slices a key

struct FmaArgs {
  const void* q;         // (B, KVH, rS, dk): pre-scaled, KV dtype
  const void* pool_a;    // (nb, bs, KVH, da): k, or c_kv (MLA)
  const void* pool_b;    // (nb, bs, KVH, db): v, or k_rope (MLA)
  const int* tables;     // (B, MB); 0 = the null block
  const int* positions;  // (B,): first query position of each lane
  void* out;             // (B, KVH, rS, dv), KV dtype
  float* ws;             // partials (kv_splits > 1): acc, then (m, l)
  int* rec;              // issue-order record or null
  int rec_cta;
  int MB, bs, kvh, da, db, S, rS;
  int row_tiles, kv_splits, P, G, C, window;
  int vec;               // cp.async width of every row copy
  int row_bytes;         // shared-memory bytes of a q / key / value row
  int da_p, db_p;        // the parts' widths, padded to 16-byte chunks
};

// q tile + G-slot ring (a slot: P key rows; GQA then P value rows) + the
// warps' p rows (f32, kRows x P)
__host__ __device__ constexpr size_t smem_bytes(int P, int row_bytes, int G,
                                               bool mla) {
  return (size_t)kRows * row_bytes +
         (size_t)G * P * row_bytes * (mla ? 1 : 2) + (size_t)kRows * P * 4;
}

// round an f32 value through the KV dtype (the p cast before p . v)
template <typename KT>
__device__ __forceinline__ float through(float v);
template <>
__device__ __forceinline__ float through<float>(float v) { return v; }
template <>
__device__ __forceinline__ float through<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename KT>
__device__ __forceinline__ KT from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// the two bf16 of a 32-bit word as f32 (exactly __bfloat162float)
__device__ __forceinline__ void widen2(unsigned w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

// one 16-byte chunk of a shared-memory row as f32: 4 floats or 8 bf16
template <typename KT>
__device__ __forceinline__ void load_chunk(const char* p, float* f);
template <>
__device__ __forceinline__ void load_chunk<float>(const char* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
template <>
__device__ __forceinline__ void load_chunk<__nv_bfloat16>(const char* p,
                                                          float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  widen2(v.x, f);
  widen2(v.y, f + 2);
  widen2(v.z, f + 4);
  widen2(v.w, f + 6);
}

// VW consecutive values of a shared-memory row as f32
template <typename KT, int VW>
__device__ __forceinline__ void load_vec(const char* p, float* f) {
  if constexpr (sizeof(KT) == 4) {
    if constexpr (VW == 4) {
      load_chunk<float>(p, f);
    } else if constexpr (VW == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      f[0] = v.x;
      f[1] = v.y;
    } else {
      f[0] = *reinterpret_cast<const float*>(p);
    }
  } else {
    if constexpr (VW == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      widen2(v.x, f);
      widen2(v.y, f + 2);
    } else if constexpr (VW == 2) {
      widen2(*reinterpret_cast<const unsigned*>(p), f);
    } else {
      f[0] = __uint_as_float(
          (unsigned)*reinterpret_cast<const unsigned short*>(p) << 16);
    }
  }
}

// VW floats to global memory in one store (dv is a multiple of 8 and c of
// VW, so a vector that starts below dv ends below it)
template <int VW>
__device__ __forceinline__ void store_vec(float* dst, const float* v) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    dst[0] = v[0];
  }
}

// MLA == false: key a, value b (da == db).  MLA == true: key a|b, value a.
// Lane l owns value columns VW * l + 32 * VW * n + e (n < NV, e < VW).
template <typename KT, bool MLA, int VW, int NV>
__device__ __forceinline__ void fma_body(const FmaArgs& a) {
  constexpr int ES = (int)sizeof(KT);
  constexpr int CH = 16 / ES;            // elements of a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int RB = a.row_bytes;
  char* qs = reinterpret_cast<char*>(smem);
  char* ring = qs + kRows * RB;
  const size_t slot = (size_t)a.P * RB * (MLA ? 1 : 2);
  float* pbuf = reinterpret_cast<float*>(ring + a.G * slot);

  const int split = blockIdx.x, tile = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.kvh, g = bh % a.kvh;
  const int r0 = tile * kRows;
  const int nr = min(kRows, a.rS - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ppb = a.bs / a.P;              // pieces a block
  const int npieces = a.MB * ppb;
  const int i_lo = (int)((long long)split * npieces / a.kv_splits);
  const int i_hi = (int)((long long)(split + 1) * npieces / a.kv_splits);
  const int* trow = a.tables + (size_t)b * a.MB;
  const KT* pa = static_cast<const KT*>(a.pool_a);
  const KT* pb = static_cast<const KT*>(a.pool_b);
  const int dk = MLA ? a.da + a.db : a.da;
  const int dv = a.da;

  // the q tile and the run's table entries are wanted whatever the
  // position says: start both before the position arrives.  The q copies
  // join step 0's first commit group (the ring's first wait covers them).
  {
    const KT* qg = static_cast<const KT*>(a.q) +
                   ((size_t)bh * a.rS + r0) * dk;
    auto qa = [&](int r) -> const char* {
      return r < nr ? reinterpret_cast<const char*>(qg + (size_t)r * dk)
                    : nullptr;
    };
    gpp::copy_rows_vec(a.vec, qs, RB, 0, kRows, a.da_p * ES, a.da * ES, qa,
                       static_cast<const char*>(a.q));
    if (MLA) {
      auto qb = [&](int r) -> const char* {
        return r < nr ? reinterpret_cast<const char*>(qg + (size_t)r * dk +
                                                      a.da)
                      : nullptr;
      };
      gpp::copy_rows_vec(a.vec, qs + a.da_p * ES, RB, 0, kRows, a.db_p * ES,
                         a.db * ES, qb, static_cast<const char*>(a.q));
    }
    const int j_lo = i_lo / ppb;
    if (i_hi > i_lo && threadIdx.x <= (i_hi - 1) / ppb - j_lo) {
      asm volatile("prefetch.global.L1 [%0];\n" ::"l"(trow + j_lo +
                                                       threadIdx.x));
    }
  }
  const int pos = a.positions[b];

  // piece i overlaps the lane's visible keys (pos - window, pos + S - 1]:
  // the one predicate of the issue and compute sites.  It holds on an
  // interval of i, so the run's live pieces are [i0, i0 + n).
  auto live = [&](int i) {
    bool ok = i * a.P <= pos + (a.S - 1);
    if (a.window > 0) ok = ok && (i + 1) * a.P - 1 > pos - a.window;
    return ok;
  };
  int i0 = i_lo, n = 0;
  for (int i = i_lo; i < i_hi; ++i) {
    if (live(i)) {
      if (n == 0) i0 = i;
      ++n;
    }
  }

  const int cta = (bh * a.row_tiles + tile) * a.kv_splits + split;
  const bool recorder = a.rec != nullptr && cta == a.rec_cta &&
                        threadIdx.x == 0;
  int rec_n = 0;
  int cur = 0;                           // the step now issuing

  // rows [lo, hi) of chunk c of step `step`'s piece: MLA its c_kv | k_rope
  // rows; GQA its K rows of this head, then its V rows
  auto issue = [&](int step, int c) {
    int lo, hi;
    gpp::chunk_bounds(a.P, a.C, c, &lo, &hi);
    const int i = i0 + step;
    const size_t row0 = (size_t)trow[i / ppb] * a.bs + (size_t)(i % ppb) * a.P;
    char* kd = ring + (size_t)(step % a.G) * slot;
    auto arow = [&](int t) -> const char* {
      return reinterpret_cast<const char*>(
          pa + ((row0 + t) * a.kvh + g) * a.da);
    };
    auto brow = [&](int t) -> const char* {
      return reinterpret_cast<const char*>(
          pb + ((row0 + t) * a.kvh + g) * a.db);
    };
    gpp::copy_rows_vec(a.vec, kd, RB, lo, hi, a.da_p * ES, a.da * ES, arow,
                       reinterpret_cast<const char*>(pa));
    gpp::copy_rows_vec(a.vec, MLA ? kd + a.da_p * ES : kd + (size_t)a.P * RB,
                       RB, lo, hi, a.db_p * ES, a.db * ES, brow,
                       reinterpret_cast<const char*>(pb));
    if (recorder) {
      a.rec[3 * rec_n + 0] = step;
      a.rec[3 * rec_n + 1] = c;
      a.rec[3 * rec_n + 2] = cur;
      ++rec_n;
    }
  };

  // q . k layout: lane = kg * NKS + ks; keys kg + KG i (i < KQ)
  const int KQ = min(kKQ, a.P);
  const int KG = a.P / KQ;
  const int NKS = 32 / KG;
  const int kg = lane / NKS, ks = lane % NKS;
  const int nch = ((MLA ? a.da_p + a.db_p : a.da_p) * ES) / 16;
  const bool warp_live = warp * kRW < nr;  // uniform across the warp
  int qpos[kRW];
#pragma unroll
  for (int r = 0; r < kRW; ++r) qpos[r] = pos + (r0 + warp * kRW + r) % a.S;
  float m_r[kRW], l_r[kRW], acc[kRW][NV * VW];
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    m_r[r] = -INFINITY;
    l_r[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < NV * VW; ++j) acc[r][j] = 0.0f;
  }
  float* pw = pbuf + warp * kRW * a.P;     // this warp's p: [t][4 rows]

  if (n == 0) {  // no piece to walk: let the q copies land, leave
    gpp::cp_async_commit();
    gpp::cp_async_wait<0>();
  }
  for (int s = 0; s < n; ++s) {
    cur = s;
    gpp::run_chunk_schedule(s, n, a.G, a.C, issue);
    const char* kb = ring + (size_t)(s % a.G) * slot;
    if (warp_live) {
      // q . k over this lane's k-slice
      float lg[kRW][kKQ];
#pragma unroll
      for (int r = 0; r < kRW; ++r)
#pragma unroll
        for (int i = 0; i < kKQ; ++i) lg[r][i] = 0.0f;
      const char* qw = qs + warp * kRW * RB;
#pragma unroll 2
      for (int ch = ks; ch < nch; ch += NKS) {
        float kf[kKQ][CH];
#pragma unroll
        for (int i = 0; i < kKQ; ++i) {
          if (i < KQ) {
            load_chunk<KT>(kb + (kg + KG * i) * RB + ch * 16, kf[i]);
          } else {
#pragma unroll
            for (int e = 0; e < CH; ++e) kf[i][e] = 0.0f;
          }
        }
#pragma unroll
        for (int r = 0; r < kRW; ++r) {
          float qf[CH];
          load_chunk<KT>(qw + r * RB + ch * 16, qf);
#pragma unroll
          for (int i = 0; i < kKQ; ++i)
#pragma unroll
            for (int e = 0; e < CH; ++e) lg[r][i] = fmaf(qf[e], kf[i][e],
                                                         lg[r][i]);
        }
      }
      for (int off = 1; off < NKS; off <<= 1) {
#pragma unroll
        for (int r = 0; r < kRW; ++r)
#pragma unroll
          for (int i = 0; i < kKQ; ++i)
            lg[r][i] += __shfl_xor_sync(0xffffffffu, lg[r][i], off);
      }

      // softmax step over the piece; every lane holds its rows' m and l
      const int kbase = (i0 + s) * a.P;
      float corr[kRW];
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < kKQ; ++i) {
          const int kpos = kbase + kg + KG * i;
          bool valid = i < KQ && kpos <= qpos[r];
          if (a.window > 0) valid = valid && kpos > qpos[r] - a.window;
          lg[r][i] = valid ? lg[r][i] : -INFINITY;
          mx = fmaxf(mx, lg[r][i]);
        }
        for (int off = NKS; off < 32; off <<= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        }
        const float m_new = fmaxf(m_r[r], mx);
        const float m_safe = isinf(m_new) ? 0.0f : m_new;
        corr[r] = isinf(m_r[r]) ? 0.0f : expf(m_r[r] - m_safe);
        m_r[r] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < kKQ; ++i) {
          lg[r][i] = expf(lg[r][i] - m_safe);
          sum += lg[r][i];
        }
        for (int off = NKS; off < 32; off <<= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        }
        l_r[r] = l_r[r] * corr[r] + sum;
      }
      if (ks == 0) {
#pragma unroll
        for (int i = 0; i < kKQ; ++i) {
          if (i < KQ) {
            *reinterpret_cast<float4*>(pw + (kg + KG * i) * kRW) =
                make_float4(through<KT>(lg[0][i]), through<KT>(lg[1][i]),
                            through<KT>(lg[2][i]), through<KT>(lg[3][i]));
          }
        }
      }
      __syncwarp();

      // acc = acc * corr + p . v over this lane's columns
#pragma unroll
      for (int r = 0; r < kRW; ++r)
#pragma unroll
        for (int j = 0; j < NV * VW; ++j) acc[r][j] *= corr[r];
      const char* vb = MLA ? kb : kb + (size_t)a.P * RB;
      for (int t = 0; t < a.P; ++t) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + t * kRW);
        const float pr[kRW] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int nn = 0; nn < NV; ++nn) {
          const int c = VW * lane + 32 * VW * nn;
          if (c < dv) {
            float vf[VW];
            load_vec<KT, VW>(vb + t * RB + c * ES, vf);
#pragma unroll
            for (int r = 0; r < kRW; ++r)
#pragma unroll
              for (int e = 0; e < VW; ++e)
                acc[r][nn * VW + e] = fmaf(pr[r], vf[e], acc[r][nn * VW + e]);
          }
        }
      }
    }
    __syncthreads();  // the ring slot and the p rows are free
  }

  if (a.kv_splits == 1) {  // the CTA's run is the whole lane
    if (!warp_live) return;
    KT* out = static_cast<KT*>(a.out) + ((size_t)bh * a.rS + r0) * dv;
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      const int row = warp * kRW + r;
      if (row >= nr) continue;
      const float l = fmaxf(l_r[r], 1e-30f);
#pragma unroll
      for (int nn = 0; nn < NV; ++nn)
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const int c = VW * lane + 32 * VW * nn + e;
          if (c < dv) out[(size_t)row * dv + c] =
              from_f32<KT>(acc[r][nn * VW + e] / l);
        }
    }
    return;
  }

  // the partial: acc rows of the (lane, head, tile) unit's split, then
  // (m, l); an empty run leaves m = -inf, l = 0 and no acc (the merge
  // skips it), and rows past rS no acc (the merge does not read them)
  const size_t prow = (((size_t)bh * a.row_tiles + tile) * a.kv_splits +
                       split) * kRows;
  if (n > 0 && warp_live) {
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      const int row = warp * kRW + r;
      if (row >= nr) continue;
      float* dst = a.ws + (prow + row) * dv;
#pragma unroll
      for (int nn = 0; nn < NV; ++nn) {
        const int c = VW * lane + 32 * VW * nn;
        if (c < dv) store_vec<VW>(dst + c, &acc[r][nn * VW]);
      }
    }
  }
  if (lane == 0) {
    float2* ml = reinterpret_cast<float2*>(
        a.ws + (size_t)gridDim.z * a.row_tiles * a.kv_splits * kRows * dv);
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      ml[prow + warp * kRW + r] = make_float2(m_r[r], l_r[r]);
    }
  }
}

// two entry points, so the GQA and MLA launches show apart in a trace
template <typename KT, int VW, int NV>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(FmaArgs a) {
  fma_body<KT, false, VW, NV>(a);
}

template <typename KT>
__global__ void __launch_bounds__(kThreads)
    paged_attention_mla_kernel(FmaArgs a) {
  fma_body<KT, true, 4, 4>(a);
}

template <typename KT, bool MLA, int VW, int NV>
cudaError_t run(const FmaArgs& a, int B, cudaStream_t stream) {
  void (*kernel)(FmaArgs);
  if constexpr (MLA) {
    kernel = paged_attention_mla_kernel<KT>;
  } else {
    kernel = paged_attention_kernel<KT, VW, NV>;
  }
  const size_t smem = smem_bytes(a.P, a.row_bytes, a.G, MLA);
  static size_t smem_set = 0;  // per instantiation: raise the limit once
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const dim3 grid(a.kv_splits, a.row_tiles, B * a.kvh);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// the value width picks the lane's columns: MLA 512 (4 x 4 a lane); GQA
// <= 64 (2 x 1), <= 128 (4 x 1), <= 256 (4 x 2)
template <typename KT>
cudaError_t run_any(const FmaArgs& a, bool mla, int B, cudaStream_t stream) {
  if (mla) return run<KT, true, 4, 4>(a, B, stream);
  if (a.da <= 64) return run<KT, false, 2, 1>(a, B, stream);
  if (a.da <= 128) return run<KT, false, 4, 1>(a, B, stream);
  return run<KT, false, 4, 2>(a, B, stream);
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

}  // namespace
}  // namespace fma_attn

// dtype codes: 0 = float32, 1 = bfloat16 (q, pools and output alike).
// GQA: mla = 0, da = db = head_dim.  MLA: mla = 1, kvh = 1, da = kv_lora,
// db = rope_dim.  q: (B, KVH, rS, dk) pre-scaled; out (B, KVH, rS, da),
// written here only with kv_splits == 1.  With kv_splits > 1, ws receives
// B * KVH * row_tiles * kv_splits * 16 * (da + 2) floats of partials for
// paged_attention_merge_launch.  piece: P; row_bytes: the planner's
// (core.schedule.paged_attn_fma_row_bytes).  rec / rec_cta: the issue-order
// record (rec may be null).
extern "C" int paged_attention_launch(
    const void* q, const void* pool_a, const void* pool_b, const int* tables,
    const int* positions, void* out, float* ws, int* rec, int B, int MB,
    int bs, int kvh, int da, int db, int mla, int S, int rS, int row_tiles,
    int kv_splits, int piece, int G, int C, int window, int vec,
    int row_bytes, int rec_cta, int dtype, void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  const int ch = 16 / es;
  fma_attn::FmaArgs a{};
  a.da_p = fma_attn::round_up(da, ch);
  a.db_p = fma_attn::round_up(db, ch);
  const int kw = (mla ? a.da_p + a.db_p : a.da_p) * es;
  using fma_attn::kMaxPiece;
  using fma_attn::kRows;
  if (B < 1 || MB < 1 || bs < 1 || kvh < 1 || da < 8 || da % 8 != 0 ||
      db < 0 || S < 1 || rS < 1 || piece < 1 || piece > kMaxPiece ||
      (piece & (piece - 1)) != 0 || bs % piece != 0 || G < 1 || C < 1 ||
      C > piece || (G == 1 && C != 1) || kv_splits < 1 ||
      kv_splits > MB * (bs / piece) || row_tiles * kRows < rS ||
      row_bytes < kw || row_bytes % 64 != 0 ||
      !(vec == 1 || vec == 4 || vec == 8 || vec == 16) ||
      (kv_splits > 1 && ws == nullptr) || (dtype != 0 && dtype != 1) ||
      (mla ? (kvh != 1 || da > 512) : (da != db || da > 256))) {
    return (int)cudaErrorInvalidValue;
  }
  a.q = q;
  a.pool_a = pool_a;
  a.pool_b = pool_b;
  a.tables = tables;
  a.positions = positions;
  a.out = out;
  a.ws = ws;
  a.rec = rec;
  a.rec_cta = rec_cta;
  a.MB = MB;
  a.bs = bs;
  a.kvh = kvh;
  a.da = da;
  a.db = db;
  a.S = S;
  a.rS = rS;
  a.row_tiles = row_tiles;
  a.kv_splits = kv_splits;
  a.P = piece;
  a.G = G;
  a.C = C;
  a.window = window;
  a.vec = vec;
  a.row_bytes = row_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0
                   ? fma_attn::run_any<float>(a, mla != 0, B, st)
                   : fma_attn::run_any<__nv_bfloat16>(a, mla != 0, B, st));
}

// The dynamic shared memory a paged_attention_launch with these arguments
// asks for (held against core.schedule.paged_attn_fma_smem_bytes).
extern "C" long long paged_attention_smem_bytes(int piece, int row_bytes,
                                                int G, int mla) {
  return (long long)fma_attn::smem_bytes(piece, row_bytes, G, mla != 0);
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ---------------------------------------------------------------------------
// paged_attention_mla_tc_kernel: bf16 MLA on the tensor cores, split-KV.
//
// The same function as the MLA path above and as _paged_attn_kernel with
// mla=True: logits = q . concat(c_kv, k_rope) in f32 (q pre-scaled in f32 and
// cast to bf16 by the wrapper), -inf where kpos > qpos (qpos = pos + row % S)
// or behind the window, online softmax with f32 m / l / acc, p cast to bf16
// before p . c_kv, out = acc / max(l, 1e-30) in bf16.
//
// What bounds it on the H100: not the bytes (a decode call reads ~0.33 MB of
// latent rows, 0.1 us at 3.35 TB/s) but latency: few blocks a lane, each a
// short chain of dependent steps.  What the design does about it:
//  1. Split-KV (flash-decoding over the paged blocks).  A CTA owns one
//     (lane, 16-row query tile, run of logical blocks); rows are head-major
//     (row = h * S + s), so at decode a tile is one query's 16 heads.  The
//     planner (core.schedule.plan_paged_attn_mla_tc_sm90) cuts [0, MB) into
//     kv_splits runs, [s * MB / ks, (s + 1) * MB / ks), toward two CTAs
//     an SM; the host cannot see positions without a sync, so each
//     CTA finds its run's live blocks on the device with the one live
//     predicate of the kernels above (an interval of blocks, since the
//     predicate is), and walks only those: dead blocks cost no copy, no
//     compute and no step.  A run with no live block leaves an empty partial
//     (m = -inf, l = 0).
//  2. The GPP ring inside a run: the run's live blocks are the steps of
//     ring.cuh's chunk schedule (G slots, C = G - 1 chunks of a block's
//     rows), G in {1, 2, >= 3} pinnable.  One ring holds whole key rows,
//     c_kv then k_rope (1152 bytes at 512 + 64), so the value is the same
//     slot's first 1024 bytes.
//  3. mma.sync m16n8k16 bf16 -> f32 (mma.cuh).  q . k^T: A = the 16 x 576 q
//     tile (loaded once, beside the ring), B = the block's key rows, which
//     are the .col operand as stored (ldmatrix); the 36 k-steps are split
//     over the warps and the warps' partial logits summed through shared
//     memory.  Softmax: every warp recomputes it for all 16 rows straight
//     into the A fragment of p . v, keeping m and l in registers (no
//     barrier between the two products).  p . v: B = the c_kv rows
//     (ldmatrix.trans); each warp owns 512 / warps latent columns (4 warps:
//     16 n-tiles, 64 f32 accumulators a thread).  Rows are XOR-swizzled in
//     16-byte chunks with no padding (row widths are multiples of 128 bytes;
//     a latent width that is not is zero-padded to one).
//  4. One merged output.  With kv_splits == 1 the CTA writes the output.
//     Otherwise each CTA writes its partial (f32 acc, m and l per row) to a
//     workspace from the caching allocator, and a second kernel,
//     paged_attention_merge_kernel (at the end of this file), merges each
//     (lane, tile)'s partials over (64-column slice, unit) CTAs.
// Numerics: a split rounds p to bf16 relative to its run's running max, not
// the lane's, so the result differs from the TPU kernel's single walk at
// bf16 rounding only (within the 2e-2 that every bf16 path shape meets
// against kernels.ref.paged_attn_ref).
//
// With `rec` non-null, CTA `rec_cta` (linear index (lane * row_tiles + tile)
// * kv_splits + split) writes one (step, chunk, issue_step) triple per chunk
// it issues over its run's live blocks.
namespace mla_tc {
namespace {

using gpp_mma::ldmatrix_x4;
using gpp_mma::ldmatrix_x4_trans;
using gpp_mma::mma_bf16;
using gpp_mma::swizzle;

typedef __nv_bfloat16 bf16;

constexpr int kRows = 16;          // query rows of a tile: one m16 tile
constexpr int kMaxLatent = 512;    // latent columns (padded) the warps own
constexpr int kMaxBlock = 64;      // tokens of a KV block

struct MlaTcArgs {
  const bf16* q;         // (B, rS, da + db), pre-scaled
  const bf16* ckv;       // (nb, bs, da)
  const bf16* krope;     // (nb, bs, db)
  const int* tables;     // (B, MB); 0 = the null block
  const int* positions;  // (B,): first query position of each lane
  bf16* out;             // (B, rS, da)
  float* ws;             // partials (kv_splits > 1): acc, then (m, l)
  int* rec;              // issue-order record or null
  int rec_cta;
  int MB, bs, da, db, S, rS;
  int row_tiles, kv_splits, G, C, window;
  int dap;               // latent width padded to a multiple of 128
  int row_bytes;         // shared-memory bytes of one key / q row
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ constexpr int row_bytes_of(int da, int db) {
  return (round_up(da, 128) + round_up(db, 64)) * 2;
}

// q tile + G-slot key ring + the warps' partial logits
__host__ __device__ constexpr size_t smem_bytes(int bs, int row_bytes, int G,
                                               int warps) {
  return (size_t)kRows * row_bytes + (size_t)G * bs * row_bytes +
         (size_t)warps * kRows * bs * 4;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

template <int W>
__global__ void __launch_bounds__(W * 32)
    paged_attention_mla_tc_kernel(MlaTcArgs a) {
  constexpr int kThreads = W * 32;
  constexpr int kMaxNI = kMaxLatent / W / 8;   // latent n8 tiles a warp owns
  constexpr int kMaxKT = kMaxBlock / 8;        // key n8 tiles of a block
  extern __shared__ __align__(128) unsigned char smem[];
  const int RB = a.row_bytes;
  char* qs = reinterpret_cast<char*>(smem);
  char* ring = qs + kRows * RB;
  const size_t slot = (size_t)a.bs * RB;
  float* lg = reinterpret_cast<float*>(ring + a.G * slot);

  const int split = blockIdx.x, tile = blockIdx.y, b = blockIdx.z;
  const int r0 = tile * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int* trow = a.tables + (size_t)b * a.MB;
  const int j_lo = (int)((long long)split * a.MB / a.kv_splits);
  const int j_hi = (int)((long long)(split + 1) * a.MB / a.kv_splits);
  const int nch = RB >> 4;         // 16-byte chunks of a row
  const int ach = a.dap >> 3;       // of which the (padded) latent's

  // the q tile and the run's table entries are wanted whatever the
  // position says: start both before the position arrives.  The q copies
  // join step 0's commit group (the ring's first wait covers them).
  {
    const int dk = a.da + a.db;
    for (int i = threadIdx.x; i < kRows * nch; i += kThreads) {
      const int r = i / nch, j = i % nch;
      const int off = j < ach ? j * 8 : a.da + (j - ach) * 8;
      const bool ok = r0 + r < a.rS &&
                      (j < ach ? off < a.da : off < dk);
      const bf16* src = a.q + ((size_t)b * a.rS + r0 + r) * dk + off;
      gpp::cp_async<16>(qs + r * RB + swizzle(r, j * 16), ok ? src : a.q,
                        ok);
    }
    if (threadIdx.x < j_hi - j_lo) {
      asm volatile("prefetch.global.L1 [%0];\n" ::"l"(trow + j_lo +
                                                       threadIdx.x));
    }
  }
  const int pos = a.positions[b];

  // logical block j overlaps the lane's visible keys (pos - window,
  // pos + S - 1]: the live predicate of the kernels above.  It holds on an
  // interval of j, so the run's live blocks are [j0, j0 + n).
  auto live = [&](int j) {
    bool ok = j * a.bs <= pos + (a.S - 1);
    if (a.window > 0) ok = ok && (j + 1) * a.bs - 1 > pos - a.window;
    return ok;
  };
  int j0 = j_lo, n = 0;
  for (int j = j_lo; j < j_hi; ++j) {
    if (live(j)) {
      if (n == 0) j0 = j;
      ++n;
    }
  }

  const int cta = (b * a.row_tiles + tile) * a.kv_splits + split;
  const bool recorder = a.rec != nullptr && cta == a.rec_cta &&
                        threadIdx.x == 0;
  int rec_n = 0;
  int cur = 0;                      // the step now issuing

  // chunk j of a key / q row: the latent's, then the rope's; zero-filled
  // past each part's width (src == nullptr)
  auto issue = [&](int step, int c) {
    int lo, hi;
    gpp::chunk_bounds(a.bs, a.C, c, &lo, &hi);
    char* dst = ring + (size_t)(step % a.G) * slot;
    const size_t row0 = (size_t)trow[j0 + step] * a.bs;
    for (int i = threadIdx.x; i < (hi - lo) * nch; i += kThreads) {
      const int t = lo + i / nch, j = i % nch;
      const bf16* src = nullptr;
      if (j < ach) {
        if (j * 8 < a.da) src = a.ckv + (row0 + t) * a.da + j * 8;
      } else if ((j - ach) * 8 < a.db) {
        src = a.krope + (row0 + t) * a.db + (j - ach) * 8;
      }
      gpp::cp_async<16>(dst + t * RB + swizzle(t, j * 16),
                        src != nullptr ? src : a.ckv, src != nullptr);
    }
    if (recorder) {
      a.rec[3 * rec_n + 0] = step;
      a.rec[3 * rec_n + 1] = c;
      a.rec[3 * rec_n + 2] = cur;
      ++rec_n;
    }
  };

  const int ni = a.dap / W / 8;           // latent n8 tiles of this warp
  const int wn0 = warp * (a.dap / W);     // its first latent column
  const int nt = a.bs / 8;                // key n8 tiles of a block
  const int ksteps = RB / 32;             // k16 steps over a key row
  int qpos[2];                            // rows g and g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) qpos[h] = pos + (r0 + g + 8 * h) % a.S;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.0f, 0.0f};
  float acc[kMaxNI][4];
#pragma unroll
  for (int i = 0; i < kMaxNI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  if (n == 0) {  // no block to walk: let the q copies land, leave
    gpp::cp_async_commit();
    gpp::cp_async_wait<0>();
  } else {
    const unsigned qb = gpp::smem_u32(qs);
    for (int s = 0; s < n; ++s) {
      cur = s;
      gpp::run_chunk_schedule(s, n, a.G, a.C, issue);
      const unsigned kb = gpp::smem_u32(ring + (size_t)(s % a.G) * slot);

      // q . k^T over this warp's k-steps
      float lgf[kMaxKT][4];
#pragma unroll
      for (int i = 0; i < kMaxKT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) lgf[i][e] = 0.0f;
      for (int kk = warp; kk < ksteps; kk += W) {
        unsigned af[4];
        {  // lanes 0-15 rows 0-15 at k 0-7, lanes 16-31 the same at k 8-15
          const int r = lane & 15;
          ldmatrix_x4(af, qb + r * RB + swizzle(r, (kk * 16 + (lane >> 4) * 8)
                                                       * 2));
        }
#pragma unroll
        for (int jt = 0; jt < kMaxKT; jt += 2) {
          if (jt < nt) {
            // matrices (keys 0-7 | 8-15 of the pair) x (k 0-7 | 8-15):
            // lane l addresses key (l & 7) + 8 (l >> 4) at k 8 ((l >> 3) & 1)
            const int t = jt * 8 + (lane & 7) + ((lane >> 4) << 3);
            const int k = kk * 16 + ((lane >> 3) & 1) * 8;
            unsigned bfr[4];
            ldmatrix_x4(bfr, kb + t * RB + swizzle(t, k * 2));
            mma_bf16(lgf[jt], af, bfr[0], bfr[1]);
            mma_bf16(lgf[jt + 1], af, bfr[2], bfr[3]);
          }
        }
      }
      {
        float* lw = lg + warp * kRows * a.bs;
#pragma unroll
        for (int jt = 0; jt < kMaxKT; ++jt) {
          if (jt < nt) {
            const int col = jt * 8 + 2 * q4;
            *reinterpret_cast<float2*>(lw + g * a.bs + col) =
                make_float2(lgf[jt][0], lgf[jt][1]);
            *reinterpret_cast<float2*>(lw + (g + 8) * a.bs + col) =
                make_float2(lgf[jt][2], lgf[jt][3]);
          }
        }
      }
      __syncthreads();

      // softmax step, every warp for all 16 rows, in the C-fragment layout
      // (rows g / g + 8, keys jt * 8 + 2 q4 + {0, 1}); the quad of lanes
      // 4g..4g+3 holds a whole row
      const int kbase = (j0 + s) * a.bs;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jt = 0; jt < kMaxKT; ++jt) {
        if (jt < nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, col = jt * 8 + 2 * q4 + (e & 1);
            float v = 0.0f;
#pragma unroll
            for (int w = 0; w < W; ++w) {
              v += lg[(w * kRows + g + 8 * h) * a.bs + col];
            }
            const int kpos = kbase + col;
            bool valid = kpos <= qpos[h];
            if (a.window > 0) valid = valid && kpos > qpos[h] - a.window;
            lgf[jt][e] = valid ? v : -INFINITY;
            mx[h] = fmaxf(mx[h], lgf[jt][e]);
          }
        }
      }
      float corr[2], sum[2] = {0.0f, 0.0f}, m_safe[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_r[h], mx[h]);
        m_safe[h] = isinf(m_new) ? 0.0f : m_new;
        corr[h] = isinf(m_r[h]) ? 0.0f : expf(m_r[h] - m_safe[h]);
        m_r[h] = m_new;
      }
#pragma unroll
      for (int jt = 0; jt < kMaxKT; ++jt) {
        if (jt < nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            lgf[jt][e] = expf(lgf[jt][e] - m_safe[e >> 1]);
            sum[e >> 1] += lgf[jt][e];
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l_r[h] = l_r[h] * corr[h] + sum[h];
      }

      // acc = acc * corr + bf16(p) . c_kv over this warp's latent columns
#pragma unroll
      for (int i = 0; i < kMaxNI; ++i) {
        if (i < ni) {
          acc[i][0] *= corr[0];
          acc[i][1] *= corr[0];
          acc[i][2] *= corr[1];
          acc[i][3] *= corr[1];
        }
      }
#pragma unroll
      for (int kt = 0; kt < kMaxKT / 2; ++kt) {
        if (2 * kt < nt) {
          // A fragment of keys 16 kt .. 16 kt + 15 from the C fragments of
          // key tiles 2 kt and 2 kt + 1
          const unsigned pa[4] = {
              pack_bf16(lgf[2 * kt][0], lgf[2 * kt][1]),
              pack_bf16(lgf[2 * kt][2], lgf[2 * kt][3]),
              pack_bf16(lgf[2 * kt + 1][0], lgf[2 * kt + 1][1]),
              pack_bf16(lgf[2 * kt + 1][2], lgf[2 * kt + 1][3])};
          const int k = kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int i = 0; i < kMaxNI; i += 2) {
            if (i < ni) {
              // matrices (keys 0-7 | 8-15) x (columns 0-7 | 8-15 of the pair)
              const int col = wn0 + i * 8 + (lane >> 4) * 8;
              unsigned t4[4];
              ldmatrix_x4_trans(t4, kb + k * RB + swizzle(k, col * 2));
              mma_bf16(acc[i], pa, t4[0], t4[1]);
              mma_bf16(acc[i + 1], pa, t4[2], t4[3]);
            }
          }
        }
      }
      __syncthreads();  // the ring slot and the partial logits are free
    }
  }

  if (a.kv_splits == 1) {  // the CTA's run is the whole lane
#pragma unroll
    for (int i = 0; i < kMaxNI; ++i) {
      const int col = wn0 + i * 8 + 2 * q4;
      if (i >= ni || col >= a.da) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + g + 8 * h;
        if (row >= a.rS) continue;
        const float l = fmaxf(l_r[h], 1e-30f);
        *reinterpret_cast<__nv_bfloat162*>(
            a.out + ((size_t)b * a.rS + row) * a.da + col) =
            __floats2bfloat162_rn(acc[i][2 * h] / l, acc[i][2 * h + 1] / l);
      }
    }
    return;
  }

  // the partial: acc rows of the (lane, tile) unit's split, then (m, l);
  // an empty run leaves m = -inf, l = 0 and no acc (the merge skips it)
  const size_t prow = (((size_t)b * a.row_tiles + tile) * a.kv_splits +
                       split) * kRows;
  if (n > 0) {
#pragma unroll
    for (int i = 0; i < kMaxNI; ++i) {
      const int col = wn0 + i * 8 + 2 * q4;
      if (i >= ni || col >= a.da) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(a.ws + (prow + g + 8 * h) * a.da + col) =
            make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
      }
    }
  }
  if (warp == 0 && q4 == 0) {
    float2* ml = reinterpret_cast<float2*>(
        a.ws + (size_t)gridDim.z * a.row_tiles * a.kv_splits * kRows * a.da);
#pragma unroll
    for (int h = 0; h < 2; ++h) ml[prow + g + 8 * h] = make_float2(m_r[h],
                                                                   l_r[h]);
  }
}

// launch (grid from the args) or, with `ctas` non-null, ask how many CTAs
// an SM holds; raises the shared-memory limit and asks for the largest
// carveout once per instantiation
template <int W>
cudaError_t run(const MlaTcArgs& a, int B, cudaStream_t stream, int* ctas) {
  const size_t smem = smem_bytes(a.bs, a.row_bytes, a.G, W);
  static size_t smem_set = 0;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_mla_tc_kernel<W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(paged_attention_mla_tc_kernel<W>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  if (ctas != nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, paged_attention_mla_tc_kernel<W>, W * 32, smem);
  }
  const dim3 grid(a.kv_splits, a.row_tiles, B);
  paged_attention_mla_tc_kernel<W><<<grid, W * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t run_any(const MlaTcArgs& a, int B, int warps,
                    cudaStream_t stream, int* ctas) {
  if (a.bs < 16 || a.bs > kMaxBlock || a.bs % 16 != 0 || a.da < 8 ||
      a.da > kMaxLatent || a.da % 8 != 0 || a.db < 0 || a.db % 8 != 0 ||
      a.G < 1 || a.C < 1 || a.C > a.bs || a.MB < 1 || a.kv_splits < 1 ||
      a.kv_splits > a.MB || !(warps == 4 || warps == 8) ||
      (ctas == nullptr &&
       (B < 1 || a.S < 1 || a.rS < 1 || a.row_tiles * kRows < a.rS ||
        (a.kv_splits > 1 && a.ws == nullptr)))) {
    return cudaErrorInvalidValue;
  }
  return warps == 4 ? run<4>(a, B, stream, ctas)
                    : run<8>(a, B, stream, ctas);
}

MlaTcArgs args_of(int bs, int da, int db, int G) {
  MlaTcArgs a{};
  a.bs = bs;
  a.da = da;
  a.db = db;
  a.G = G;
  a.C = 1;
  a.MB = 1;
  a.kv_splits = 1;
  a.dap = round_up(da, 128);
  a.row_bytes = row_bytes_of(da, db);
  return a;
}

}  // namespace
}  // namespace mla_tc

// bf16 MLA on the tensor cores (the kernel's notes above).  q: (B, rS,
// da + db) pre-scaled bf16; c_kv (nb, bs, da) and k_rope (nb, bs, db) bf16;
// out (B, rS, da) bf16, written here only with kv_splits == 1.  With
// kv_splits > 1, ws receives B * row_tiles * kv_splits * 16 * (da + 2)
// floats of partials for paged_attention_merge_launch.  rec / rec_cta:
// the issue-order record (rec may be null).
extern "C" int paged_attention_mla_tc_launch(
    const void* q, const void* c_kv, const void* k_rope, const int* tables,
    const int* positions, void* out, float* ws, int* rec, int B, int MB,
    int bs, int da, int db, int S, int rS, int row_tiles, int kv_splits,
    int G, int C, int window, int warps, int rec_cta, void* stream) {
  mla_tc::MlaTcArgs a = mla_tc::args_of(bs, da, db, G);
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.ckv = static_cast<const __nv_bfloat16*>(c_kv);
  a.krope = static_cast<const __nv_bfloat16*>(k_rope);
  a.tables = tables;
  a.positions = positions;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ws = ws;
  a.rec = rec;
  a.rec_cta = rec_cta;
  a.MB = MB;
  a.kv_splits = kv_splits;
  a.S = S;
  a.rS = rS;
  a.row_tiles = row_tiles;
  a.C = C;
  a.window = window;
  return (int)mla_tc::run_any(a, B, warps,
                              static_cast<cudaStream_t>(stream), nullptr);
}

// CTAs of the tensor-core MLA kernel one SM holds at this block size,
// widths, ring and warps (the card's answer, after the launch's own
// attribute settings); < 0 is minus a cudaError_t.
extern "C" int paged_attention_mla_tc_ctas_per_sm(int bs, int da, int db,
                                                  int G, int warps) {
  const mla_tc::MlaTcArgs a = mla_tc::args_of(bs, da, db, G);
  int ctas = 0;
  const cudaError_t e = mla_tc::run_any(a, 0, warps, nullptr, &ctas);
  return e == cudaSuccess ? ctas : -(int)e;
}

// ---------------------------------------------------------------------------
// paged_attention_tc_kernel: bf16 GQA / sliding window on the tensor cores,
// split-KV.
//
// Replaces, for bf16 q and pools at head_dim 64, 128 or 256 and blocks of
// 16-64 tokens, the TPU kernel repro/kernels/paged_attention.py::
// paged_attention (pallas_call :341, body _paged_attn_kernel :111) on its
// GQA / window path, which paged_attention_kernel above also ports (f32,
// and the bf16 shapes this one does not take).  The same function:
// logits = q . k in f32 (q pre-scaled in f32 and cast to bf16 by the
// wrapper), -inf where kpos > qpos (qpos = pos + row % S) or the key is
// behind the window, online softmax with f32 m / l / acc, p cast to bf16
// before p . v, out = acc / max(l, 1e-30) in bf16.
//
// What bounds it on the H100: latency, not bytes.  A decode call reads
// ~0.13 MB of K and V at qwen1.5-0.5b's widths (0.04 us at 3.35 TB/s); the
// whole-block FMA design it replaced spent 40+ us on one CTA per (lane,
// KV head), 64 CTAs for 132 SMs, each walking the lane's blocks in order
// with three barriers a block and a handful of threads in 16- to 64-long
// serial FMA chains.
// What the design does about it:
//  1. Split-KV over fixed runs.  A CTA owns (lane, KV head, 16-row tile of
//     the rep x S rows, run of logical blocks); rows are head-major (row =
//     r * S + s), as the wrapper lays q out, so at qwen's decode (rep 1) a
//     tile holds one live row; rows past rS are neither read nor written.
//     The runs cut [0, MB) at fixed block boundaries,
//     [s * MB / ks, (s + 1) * MB / ks) with ks = min(MB, 8)
//     (core.schedule.gqa_tc_splits): the cut reads neither B nor S, so a
//     row meets the same runs at decode and at verify and its output is
//     the same bits (a block visible to a later row of the lane but not to
//     this one is a -inf step for it: corr = 1, p = 0, exactly nothing).
//     Each CTA finds its run's live blocks on the device with the live
//     predicate of the kernels above (an interval of blocks, window expiry
//     included) and walks only those; a run with no live block leaves an
//     empty partial (m = -inf, l = 0).
//  2. The GPP ring inside a run: the run's live blocks are the steps of
//     ring.cuh's chunk schedule (G slots, C = G - 1 chunks of a block's
//     rows), G in {1, 2, >= 3} pinnable.  A slot holds the block's K rows
//     of this head, then its V rows; they come in by 16-byte cp.async from
//     rows strided KVH x head_dim in the pool.
//  3. mma.sync m16n8k16 bf16 -> f32 (mma.cuh).  q . k^T: A = the 16-row q
//     tile (loaded once, beside the ring), B = the block's K rows, which
//     are the .col operand as stored (ldmatrix); the head_dim / 16 k-steps
//     are split over the four warps and their partial logits summed in
//     warp order through shared memory.  Softmax: every warp recomputes it
//     for the 16 rows straight into the A fragment of p . v (m and l in
//     registers).  p . v: B = the V rows (ldmatrix.trans); each warp owns
//     head_dim / 4 output columns.  Rows are XOR-swizzled in 16-byte
//     chunks (head_dim x 2 bytes: whole 128-byte groups, no padding).
//  4. One merged output.  With one run (ks == 1) the CTA writes the
//     output.  Otherwise each CTA writes its partial (f32 acc of its live
//     rows, m and l) to a workspace from the caching allocator and
//     paged_attention_merge_kernel (below, shared with the MLA kernel)
//     merges the runs of each (lane, KV head, tile) unit.
// Every choice is fixed by head_dim and MB alone (warps, k-step split,
// runs), never by B or S: a row's bits depend on the row, its lane's
// cache and its position only.  Numerics: a run rounds p to bf16 relative
// to its own running max, not the lane's, so the result differs from the
// TPU kernel's single walk at bf16 rounding only (within the 2e-2 every
// bf16 path shape meets against kernels.ref.paged_attn_ref).
//
// With `rec` non-null, CTA `rec_cta` (linear index ((lane * KVH + head) *
// row_tiles + tile) * kv_splits + split) writes one (step, chunk,
// issue_step) triple per chunk it issues over its run's live blocks.
namespace gqa_tc {
namespace {

using gpp_mma::ldmatrix_x4;
using gpp_mma::ldmatrix_x4_trans;
using gpp_mma::mma_bf16;
using gpp_mma::swizzle;
using mla_tc::pack_bf16;

typedef __nv_bfloat16 bf16;

constexpr int kRows = 16;          // query rows of a tile: one m16 tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBlock = 64;      // tokens of a KV block

struct GqaTcArgs {
  const bf16* q;         // (B, KVH, rS, hd), pre-scaled
  const bf16* k;         // (nb, bs, KVH, hd)
  const bf16* v;         // (nb, bs, KVH, hd)
  const int* tables;     // (B, MB); 0 = the null block
  const int* positions;  // (B,): first query position of each lane
  bf16* out;             // (B, KVH, rS, hd)
  float* ws;             // partials (kv_splits > 1): acc, then (m, l)
  int* rec;              // issue-order record or null
  int rec_cta;
  int MB, bs, kvh, hd, S, rS;
  int row_tiles, kv_splits, G, C, window;
};

// q tile + G-slot ring (K rows, then V rows) + the warps' partial logits
__host__ __device__ constexpr size_t smem_bytes(int bs, int hd, int G) {
  return (size_t)kRows * hd * 2 + (size_t)G * 2 * bs * hd * 2 +
         (size_t)kWarps * kRows * bs * 4;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    paged_attention_tc_kernel(GqaTcArgs a) {
  constexpr int RB = HD * 2;           // bytes of a q / K / V row
  constexpr int NCH = RB / 16;         // its 16-byte chunks
  constexpr int KSTEPS = HD / 16;      // k16 steps of q . k^T
  constexpr int NI = HD / kWarps / 8;  // output n8 tiles a warp owns
  constexpr int kMaxKT = kMaxBlock / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  char* qs = reinterpret_cast<char*>(smem);
  char* ring = qs + kRows * RB;
  const size_t slot = (size_t)2 * a.bs * RB;
  float* lg = reinterpret_cast<float*>(ring + a.G * slot);

  const int split = blockIdx.x, tile = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.kvh, head = bh % a.kvh;
  const int r0 = tile * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int* trow = a.tables + (size_t)b * a.MB;
  const int j_lo = (int)((long long)split * a.MB / a.kv_splits);
  const int j_hi = (int)((long long)(split + 1) * a.MB / a.kv_splits);

  // the q tile and the run's table entries are wanted whatever the
  // position says: start both before the position arrives.  The q copies
  // join step 0's commit group (the ring's first wait covers them).
  for (int i = threadIdx.x; i < kRows * NCH; i += kThreads) {
    const int r = i / NCH, j = i % NCH;
    const bool ok = r0 + r < a.rS;
    const bf16* src = a.q + ((size_t)bh * a.rS + r0 + r) * HD + j * 8;
    gpp::cp_async<16>(qs + r * RB + swizzle(r, j * 16), ok ? src : a.q, ok);
  }
  if (threadIdx.x < j_hi - j_lo) {
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(trow + j_lo +
                                                     threadIdx.x));
  }
  const int pos = a.positions[b];

  // logical block j overlaps the lane's visible keys (pos - window,
  // pos + S - 1]: the live predicate of the kernels above.  It holds on an
  // interval of j, so the run's live blocks are [j0, j0 + n).
  auto live = [&](int j) {
    bool ok = j * a.bs <= pos + (a.S - 1);
    if (a.window > 0) ok = ok && (j + 1) * a.bs - 1 > pos - a.window;
    return ok;
  };
  int j0 = j_lo, n = 0;
  for (int j = j_lo; j < j_hi; ++j) {
    if (live(j)) {
      if (n == 0) j0 = j;
      ++n;
    }
  }

  const int cta = (bh * a.row_tiles + tile) * a.kv_splits + split;
  const bool recorder = a.rec != nullptr && cta == a.rec_cta &&
                        threadIdx.x == 0;
  int rec_n = 0;
  int cur = 0;                      // the step now issuing

  // rows [lo, hi) of chunk c of step `step`'s block: its K rows and its V
  // rows of this head
  auto issue = [&](int step, int c) {
    int lo, hi;
    gpp::chunk_bounds(a.bs, a.C, c, &lo, &hi);
    char* kd = ring + (size_t)(step % a.G) * slot;
    char* vd = kd + (size_t)a.bs * RB;
    const size_t row0 = (size_t)trow[j0 + step] * a.bs;
    for (int i = threadIdx.x; i < (hi - lo) * NCH; i += kThreads) {
      const int t = lo + i / NCH, j = i % NCH;
      const size_t src = ((row0 + t) * a.kvh + head) * HD + j * 8;
      const int dst = t * RB + swizzle(t, j * 16);
      gpp::cp_async<16>(kd + dst, a.k + src, true);
      gpp::cp_async<16>(vd + dst, a.v + src, true);
    }
    if (recorder) {
      a.rec[3 * rec_n + 0] = step;
      a.rec[3 * rec_n + 1] = c;
      a.rec[3 * rec_n + 2] = cur;
      ++rec_n;
    }
  };

  const int wn0 = warp * (HD / kWarps);  // this warp's first output column
  const int nt = a.bs / 8;               // key n8 tiles of a block
  int qpos[2];                           // rows g and g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) qpos[h] = pos + (r0 + g + 8 * h) % a.S;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.0f, 0.0f};
  float acc[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  if (n == 0) {  // no block to walk: let the q copies land, leave
    gpp::cp_async_commit();
    gpp::cp_async_wait<0>();
  } else {
    const unsigned qb = gpp::smem_u32(qs);
    for (int s = 0; s < n; ++s) {
      cur = s;
      gpp::run_chunk_schedule(s, n, a.G, a.C, issue);
      const unsigned kb = gpp::smem_u32(ring + (size_t)(s % a.G) * slot);
      const unsigned vb = kb + a.bs * RB;

      // q . k^T over this warp's k-steps
      float lgf[kMaxKT][4];
#pragma unroll
      for (int i = 0; i < kMaxKT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) lgf[i][e] = 0.0f;
#pragma unroll
      for (int kk = warp; kk < KSTEPS; kk += kWarps) {
        unsigned af[4];
        {  // lanes 0-15 rows 0-15 at k 0-7, lanes 16-31 the same at k 8-15
          const int r = lane & 15;
          ldmatrix_x4(af, qb + r * RB + swizzle(r, (kk * 16 + (lane >> 4) * 8)
                                                       * 2));
        }
#pragma unroll
        for (int jt = 0; jt < kMaxKT; jt += 2) {
          if (jt < nt) {
            // matrices (keys 0-7 | 8-15 of the pair) x (k 0-7 | 8-15):
            // lane l addresses key (l & 7) + 8 (l >> 4) at k 8 ((l >> 3) & 1)
            const int t = jt * 8 + (lane & 7) + ((lane >> 4) << 3);
            const int k = kk * 16 + ((lane >> 3) & 1) * 8;
            unsigned bfr[4];
            ldmatrix_x4(bfr, kb + t * RB + swizzle(t, k * 2));
            mma_bf16(lgf[jt], af, bfr[0], bfr[1]);
            mma_bf16(lgf[jt + 1], af, bfr[2], bfr[3]);
          }
        }
      }
      {
        float* lw = lg + warp * kRows * a.bs;
#pragma unroll
        for (int jt = 0; jt < kMaxKT; ++jt) {
          if (jt < nt) {
            const int col = jt * 8 + 2 * q4;
            *reinterpret_cast<float2*>(lw + g * a.bs + col) =
                make_float2(lgf[jt][0], lgf[jt][1]);
            *reinterpret_cast<float2*>(lw + (g + 8) * a.bs + col) =
                make_float2(lgf[jt][2], lgf[jt][3]);
          }
        }
      }
      __syncthreads();

      // softmax step, every warp for all 16 rows, in the C-fragment layout
      // (rows g / g + 8, keys jt * 8 + 2 q4 + {0, 1}); the quad of lanes
      // 4g..4g+3 holds a whole row
      const int kbase = (j0 + s) * a.bs;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jt = 0; jt < kMaxKT; ++jt) {
        if (jt < nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, col = jt * 8 + 2 * q4 + (e & 1);
            float v = 0.0f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
              v += lg[(w * kRows + g + 8 * h) * a.bs + col];
            }
            const int kpos = kbase + col;
            bool valid = kpos <= qpos[h];
            if (a.window > 0) valid = valid && kpos > qpos[h] - a.window;
            lgf[jt][e] = valid ? v : -INFINITY;
            mx[h] = fmaxf(mx[h], lgf[jt][e]);
          }
        }
      }
      float corr[2], sum[2] = {0.0f, 0.0f}, m_safe[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_r[h], mx[h]);
        m_safe[h] = isinf(m_new) ? 0.0f : m_new;
        corr[h] = isinf(m_r[h]) ? 0.0f : expf(m_r[h] - m_safe[h]);
        m_r[h] = m_new;
      }
#pragma unroll
      for (int jt = 0; jt < kMaxKT; ++jt) {
        if (jt < nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            lgf[jt][e] = expf(lgf[jt][e] - m_safe[e >> 1]);
            sum[e >> 1] += lgf[jt][e];
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l_r[h] = l_r[h] * corr[h] + sum[h];
      }

      // acc = acc * corr + bf16(p) . v over this warp's output columns
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        acc[i][0] *= corr[0];
        acc[i][1] *= corr[0];
        acc[i][2] *= corr[1];
        acc[i][3] *= corr[1];
      }
#pragma unroll
      for (int kt = 0; kt < kMaxKT / 2; ++kt) {
        if (2 * kt < nt) {
          // A fragment of keys 16 kt .. 16 kt + 15 from the C fragments of
          // key tiles 2 kt and 2 kt + 1
          const unsigned pa[4] = {
              pack_bf16(lgf[2 * kt][0], lgf[2 * kt][1]),
              pack_bf16(lgf[2 * kt][2], lgf[2 * kt][3]),
              pack_bf16(lgf[2 * kt + 1][0], lgf[2 * kt + 1][1]),
              pack_bf16(lgf[2 * kt + 1][2], lgf[2 * kt + 1][3])};
          const int k = kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int i = 0; i < NI; i += 2) {
            // matrices (keys 0-7 | 8-15) x (columns 0-7 | 8-15 of the pair)
            const int col = wn0 + i * 8 + (lane >> 4) * 8;
            unsigned t4[4];
            ldmatrix_x4_trans(t4, vb + k * RB + swizzle(k, col * 2));
            mma_bf16(acc[i], pa, t4[0], t4[1]);
            mma_bf16(acc[i + 1], pa, t4[2], t4[3]);
          }
        }
      }
      __syncthreads();  // the ring slot and the partial logits are free
    }
  }

  if (a.kv_splits == 1) {  // the CTA's run is the whole lane
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int col = wn0 + i * 8 + 2 * q4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + g + 8 * h;
        if (row >= a.rS) continue;
        const float l = fmaxf(l_r[h], 1e-30f);
        *reinterpret_cast<__nv_bfloat162*>(
            a.out + ((size_t)bh * a.rS + row) * HD + col) =
            __floats2bfloat162_rn(acc[i][2 * h] / l, acc[i][2 * h + 1] / l);
      }
    }
    return;
  }

  // the partial: acc rows of the (lane, head, tile) unit's split, then
  // (m, l); an empty run leaves m = -inf, l = 0 and no acc (the merge
  // skips it), and rows past rS no acc (the merge does not read them)
  const size_t prow = (((size_t)bh * a.row_tiles + tile) * a.kv_splits +
                       split) * kRows;
  if (n > 0) {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int col = wn0 + i * 8 + 2 * q4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r0 + g + 8 * h >= a.rS) continue;
        *reinterpret_cast<float2*>(a.ws + (prow + g + 8 * h) * HD + col) =
            make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
      }
    }
  }
  if (warp == 0 && q4 == 0) {
    float2* ml = reinterpret_cast<float2*>(
        a.ws + (size_t)gridDim.z * a.row_tiles * a.kv_splits * kRows * HD);
#pragma unroll
    for (int h = 0; h < 2; ++h) ml[prow + g + 8 * h] = make_float2(m_r[h],
                                                                   l_r[h]);
  }
}

// launch (grid from the args) or, with `ctas` non-null, ask how many CTAs
// an SM holds; raises the shared-memory limit and asks for the largest
// carveout once per instantiation
template <int HD>
cudaError_t run(const GqaTcArgs& a, int B, cudaStream_t stream, int* ctas) {
  const size_t smem = smem_bytes(a.bs, HD, a.G);
  static size_t smem_set = 0;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_tc_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(paged_attention_tc_kernel<HD>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  if (ctas != nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, paged_attention_tc_kernel<HD>, kThreads, smem);
  }
  const dim3 grid(a.kv_splits, a.row_tiles, B * a.kvh);
  paged_attention_tc_kernel<HD><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t run_any(const GqaTcArgs& a, int B, cudaStream_t stream,
                    int* ctas) {
  if (a.bs < 16 || a.bs > kMaxBlock || a.bs % 16 != 0 || a.G < 1 ||
      a.C < 1 || a.C > a.bs || a.MB < 1 || a.kv_splits < 1 ||
      a.kv_splits > a.MB || a.kvh < 1 ||
      (ctas == nullptr &&
       (B < 1 || a.S < 1 || a.rS < 1 || a.row_tiles * kRows < a.rS ||
        (a.kv_splits > 1 && a.ws == nullptr)))) {
    return cudaErrorInvalidValue;
  }
  switch (a.hd) {
    case 64:
      return run<64>(a, B, stream, ctas);
    case 128:
      return run<128>(a, B, stream, ctas);
    case 256:
      return run<256>(a, B, stream, ctas);
    default:
      return cudaErrorInvalidValue;
  }
}

GqaTcArgs args_of(int bs, int kvh, int hd, int G) {
  GqaTcArgs a{};
  a.bs = bs;
  a.kvh = kvh;
  a.hd = hd;
  a.G = G;
  a.C = 1;
  a.MB = 1;
  a.kv_splits = 1;
  return a;
}

}  // namespace
}  // namespace gqa_tc

// ---------------------------------------------------------------------------
// paged_attention_merge_kernel: the merge of split-KV partials, shared by
// the four split kernels above (MLA: a unit is (lane, row tile), da the
// latent width; GQA: a unit is (lane, KV head, row tile), da the
// head_dim); its output is bf16 (the tensor-core kernels, the FMA kernels'
// bf16 instances) or f32 (the FMA kernels in f32).  The workspace holds,
// per unit and split, 16 rows of f32 acc (da wide), then every (unit,
// split)'s 16 (m, l) pairs.
//   m = max m_i, w_i = exp(m_i - m) (0 for m_i = -inf),
//   l = sum w_i l_i, out = sum w_i acc_i / max(l, 1e-30), in split order.
// (A merge in the unit's last CTA, found through a device counter, was the
// MLA kernel's first design: one SM then read all of a lane's partials, up
// to 7 x 32 KB at decode, and took half the call; PERF.md has the sweep.)
namespace merge {
namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 16;
constexpr int kMergeThreads = 128;
constexpr int kMergeCols = 64;       // columns a merge CTA owns
constexpr int kMergeMaxSplits = 8;   // partials a thread loads at once

// (m, l) pairs, weights and sums of ks partials' 16 rows
__host__ __device__ constexpr size_t merge_smem_bytes(int kv_splits) {
  return (size_t)kRows * (3 * kv_splits + 1) * 4;
}

// CTA (c, u) merges columns [64 c, 64 c + 64) of unit u: its ks partials'
// 16 rows, of which rows past rS are neither read nor written.  Thread t
// owns float4 column t % 16 of the slice at rows t / 16 and t / 16 + 8.
// Its acc loads (8 partials at a time) go out before the (m, l) pairs
// arrive, unpredicated by the weights, so the whole merge waits about one
// memory round trip; an empty run's acc was never written, so a weight of
// 0 selects 0 instead of multiplying (w * NaN is NaN).
__device__ __forceinline__ void store4(float* dst, float4 o, float l) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(o.x / l, o.y / l, o.z / l, o.w / l);
}
__device__ __forceinline__ void store4(bf16* dst, float4 o, float l) {
  *reinterpret_cast<__nv_bfloat162*>(dst) =
      __floats2bfloat162_rn(o.x / l, o.y / l);
  *reinterpret_cast<__nv_bfloat162*>(dst + 2) =
      __floats2bfloat162_rn(o.z / l, o.w / l);
}

template <typename OT>
__global__ void __launch_bounds__(kMergeThreads)
    paged_attention_merge_kernel(const float* ws, OT* out, int units,
                                 int row_tiles, int ks, int da, int rS) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* ml = reinterpret_cast<float2*>(smem);         // [ks][16]
  float* wt = reinterpret_cast<float*>(ml + ks * kRows);  // [ks][16]
  float* lsum = wt + ks * kRows;                          // [16]
  const int u = blockIdx.y;
  const float* wacc = ws + (size_t)u * ks * kRows * da;
  const float2* wml = reinterpret_cast<const float2*>(
                          ws + (size_t)units * ks * kRows * da) +
                      (size_t)u * ks * kRows;
  const int col = blockIdx.x * kMergeCols + (threadIdx.x % 16) * 4;
  const int rt = threadIdx.x / 16;      // rows rt and rt + 8
  const int b = u / row_tiles, r0 = (u % row_tiles) * kRows;
  float4 v[2][kMergeMaxSplits];
  auto load = [&](int i0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < kMergeMaxSplits; ++k) {
        v[h][k] = col < da && i0 + k < ks && r0 + rt + 8 * h < rS
                      ? *reinterpret_cast<const float4*>(
                            wacc + ((size_t)(i0 + k) * kRows + rt + 8 * h) *
                                       da + col)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
  };
  load(0);
  for (int i = threadIdx.x; i < ks * kRows; i += kMergeThreads) {
    ml[i] = wml[i];
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    float m = -INFINITY;
    for (int i = 0; i < ks; ++i) m = fmaxf(m, ml[i * kRows + r].x);
    float l = 0.0f;
    for (int i = 0; i < ks; ++i) {
      const float mi = ml[i * kRows + r].x;
      const float w = isinf(mi) ? 0.0f : expf(mi - m);
      wt[i * kRows + r] = w;
      l += w * ml[i * kRows + r].y;
    }
    lsum[r] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  if (col >= da) return;
  float4 o[2] = {make_float4(0.0f, 0.0f, 0.0f, 0.0f),
                 make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
  for (int i0 = 0; i0 < ks; i0 += kMergeMaxSplits) {
    if (i0 > 0) load(i0);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < kMergeMaxSplits; ++k) {
        const float w =
            i0 + k < ks ? wt[(i0 + k) * kRows + rt + 8 * h] : 0.0f;
        if (w != 0.0f) {
          o[h].x += w * v[h][k].x;
          o[h].y += w * v[h][k].y;
          o[h].z += w * v[h][k].z;
          o[h].w += w * v[h][k].w;
        }
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rt + 8 * h;
    if (r0 + r >= rS) continue;
    store4(out + ((size_t)b * rS + r0 + r) * da + col, o[h], lsum[r]);
  }
}

template <typename OT>
cudaError_t merge_run(const float* ws, void* out, int units, int row_tiles,
                      int kv_splits, int da, int rS, cudaStream_t stream) {
  const size_t smem = merge_smem_bytes(kv_splits);
  static size_t smem_set = 0;  // per instantiation: raise the limit once
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_merge_kernel<OT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const dim3 grid((da + kMergeCols - 1) / kMergeCols, units);
  paged_attention_merge_kernel<OT><<<grid, kMergeThreads, smem, stream>>>(
      ws, static_cast<OT*>(out), units, row_tiles, kv_splits, da, rS);
  return cudaGetLastError();
}

}  // namespace
}  // namespace merge

// bf16 GQA / window on the tensor cores (the kernel's notes above).  q:
// (B, KVH, rS, hd) pre-scaled bf16; k / v pools (nb, bs, KVH, hd) bf16; out
// (B, KVH, rS, hd) bf16, written here only with kv_splits == 1.  With
// kv_splits > 1, ws receives B * KVH * row_tiles * kv_splits * 16 * (hd +
// 2) floats of partials for paged_attention_merge_launch.  rec / rec_cta:
// the issue-order record (rec may be null).
extern "C" int paged_attention_tc_launch(
    const void* q, const void* k, const void* v, const int* tables,
    const int* positions, void* out, float* ws, int* rec, int B, int MB,
    int bs, int kvh, int hd, int S, int rS, int row_tiles, int kv_splits,
    int G, int C, int window, int rec_cta, void* stream) {
  gqa_tc::GqaTcArgs a = gqa_tc::args_of(bs, kvh, hd, G);
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.tables = tables;
  a.positions = positions;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ws = ws;
  a.rec = rec;
  a.rec_cta = rec_cta;
  a.MB = MB;
  a.kv_splits = kv_splits;
  a.S = S;
  a.rS = rS;
  a.row_tiles = row_tiles;
  a.C = C;
  a.window = window;
  return (int)gqa_tc::run_any(a, B, static_cast<cudaStream_t>(stream),
                              nullptr);
}

// CTAs of the tensor-core GQA kernel one SM holds at this block size, head
// dim and ring (the card's answer, after the launch's own attribute
// settings); < 0 is minus a cudaError_t.
extern "C" int paged_attention_tc_ctas_per_sm(int bs, int hd, int G) {
  const gqa_tc::GqaTcArgs a = gqa_tc::args_of(bs, 1, hd, G);
  int ctas = 0;
  const cudaError_t e = gqa_tc::run_any(a, 0, nullptr, &ctas);
  return e == cudaSuccess ? ctas : -(int)e;
}

// Merge the partials a split kernel left in ws (kv_splits > 1) into out
// (units / row_tiles, rS, da), f32 (dtype 0) or bf16 (dtype 1): one CTA
// per (64-column slice, unit).  `units` = lanes x row tiles (MLA), lanes x
// KV heads x row tiles (GQA).
extern "C" int paged_attention_merge_launch(const float* ws, void* out,
                                            int units, int row_tiles,
                                            int kv_splits, int da, int rS,
                                            int dtype, void* stream) {
  using namespace merge;
  if (ws == nullptr || units < 1 || row_tiles < 1 || units % row_tiles ||
      kv_splits < 2 || da < 8 || da % 8 != 0 || rS < 1 ||
      row_tiles * kRows < rS || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? merge_run<float>(ws, out, units, row_tiles,
                                             kv_splits, da, rS, st)
                          : merge_run<bf16>(ws, out, units, row_tiles,
                                            kv_splits, da, rS, st));
}
