// Paged attention (GQA, optional sliding window, and MLA) for sm_90a.
//
// Replaces repro/kernels/paged_attention.py::paged_attention (the Pallas TPU
// kernel, pallas_call at :341, body _paged_attn_kernel :111), both its
// GQA/window path and its `mla=True` path (:173-177).  Six kernels, five
// C entries:
//
// * paged_attention_kernel / paged_attention_mla_kernel (entry
//   paged_attention_launch): CUDA-core FMA kernels, one CTA per (lane, KV
//   head, row split) walking all of the lane's blocks.  GQA in f32, and in
//   bf16 at shapes the GQA tensor-core kernel does not take; MLA in f32,
//   and in bf16 at block sizes the MLA tensor-core kernel does not take.
// * paged_attention_mla_tc_kernel (entry paged_attention_mla_tc_launch)
//   and paged_attention_tc_kernel (paged_attention_tc_launch): bf16 MLA and
//   bf16 GQA / window on the tensor cores with the KV walk split across
//   CTAs; paged_attention_merge_kernel (paged_attention_merge_launch)
//   merges either one's partials.  Each after its own notes further down.
//
// Two pools, a and b, stream through two rings.  GQA: a = K, b = V, one
// head_dim for both.  MLA (weight-absorbed, the TPU kernel's form): a =
// c_kv (the 512-wide latent), b = k_rope (64), one shared KV head; the key
// row is concat(a, b) (576) and the VALUE is the a row itself — the value
// is read from the c_kv ring, with no third ring, as on the TPU.  The
// output is then the latent (rows x 512), which the caller up-projects.
//
// One CTA per (lane, KV head, row split).  The CTA reads its lane's block
// table row and position itself (the TPU kernel's scalar prefetch) and walks
// the lane's logical blocks; each physical block's K and V rows of the CTA's
// head stream through two G-slot shared-memory rings on the generalized
// ping-pong chunk schedule (ring.cuh).  Blocks wholly outside the lane's
// visible range — past its last query position, or expired behind the
// window — are skipped for the copy and the compute by one predicate, pure
// in the step, used at the issue site and the compute site.  Each live block
// gets one online-softmax step with f32 m / l / acc:
//   logits = q . k (q pre-scaled in f32 and cast to the KV dtype by the
//   wrapper), masked to -inf per (row, slot) by position and window;
//   p = exp(logits - m_safe); l = l * corr + sum(p) in f32;
//   acc = acc * corr + cast_kv(p) . v;   out = acc / max(l, 1e-30).
// The f32 q and acc rows are dk and dv wide: at MLA's 576 / 512 the planner
// (core.schedule.plan_paged_attn_sm90) gives a CTA 16 query rows (one
// query's 16 heads) instead of 32, so both fit beside the rings in 227 KB.
//
// What bounds it on the H100: the KV bytes — decode does ~2 FLOPs per KV
// byte (MLA: 16 heads share each latent row, ~32 FLOPs a byte, still far
// below the ridge).  A block's K and V rows arrive in C chunks issued over the C steps
// before it, so the streams of the lane's next blocks overlap this block's
// softmax step; with a few 16-row blocks per lane, as on the serving path,
// the per-block wait and the CTA's barriers set the time, not the bytes.
//
// C interface (ctypes): the launch entries return the launch's
// cudaError_t.  The kernels only read the pools.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "ring.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round an f32 value through the KV dtype (the p cast before PV)
__device__ __forceinline__ float through(float v, const float*) { return v; }
__device__ __forceinline__ float through(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct PagedArgs {
  const void* q;         // (B, KVH, rS, dk): pre-scaled, KV dtype
  const void* pool_a;    // (nb, bs, KVH, da): k, or c_kv (MLA)
  const void* pool_b;    // (nb, bs, KVH, db): v, or k_rope (MLA)
  const int* tables;     // (B, MB); 0 = the null block
  const int* positions;  // (B,): first query position of each lane
  void* out;             // (B, KVH, rS, dv), KV dtype
  int MB, bs, kvh, da, db;
  int S, rS;             // queries per lane, rows per head (rep * S)
  int rows_per_cta;
  int G, C;
  int window;            // <= 0: none
  int vec;               // cp.async width for both pools' rows
  int row_bytes_a;       // shared-memory stride of one a / b ring row
  int row_bytes_b;
};

// MLA == false: key a, value b (da == db).  MLA == true: key a|b, value a.
template <typename KT, bool MLA>
__device__ __forceinline__ void paged_attention_body(const PagedArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, g = blockIdx.y;
  const int r0 = blockIdx.z * a.rows_per_cta;
  const int nr = min(a.rows_per_cta, a.rS - r0);
  const int dk = MLA ? a.da + a.db : a.da;
  const int dv = MLA ? a.da : a.db;
  const size_t slot_a = (size_t)a.bs * a.row_bytes_a;
  const size_t slot_b = (size_t)a.bs * a.row_bytes_b;
  unsigned char* ring_a = smem;
  unsigned char* ring_b = smem + a.G * slot_a;
  float* qs = reinterpret_cast<float*>(ring_b + a.G * slot_b);
  float* acc = qs + a.rows_per_cta * dk;
  float* ps = acc + a.rows_per_cta * dv;
  float* ms = ps + a.rows_per_cta * a.bs;
  float* ls = ms + a.rows_per_cta;
  float* cs = ls + a.rows_per_cta;

  const KT* q = static_cast<const KT*>(a.q);
  const KT* pa = static_cast<const KT*>(a.pool_a);
  const KT* pb = static_cast<const KT*>(a.pool_b);
  const int pos = a.positions[b];
  const int* trow = a.tables + (size_t)b * a.MB;
  const int stride_a = a.row_bytes_a / (int)sizeof(KT);
  const int stride_b = a.row_bytes_b / (int)sizeof(KT);

  // logical block j overlaps the lane's visible keys (pos - window,
  // pos + S - 1]: the one predicate of the issue and compute sites
  auto live = [&](int j) {
    bool ok = j * a.bs <= pos + (a.S - 1);
    if (a.window > 0) ok = ok && (j + 1) * a.bs - 1 > pos - a.window;
    return ok;
  };

  auto issue = [&](int j, int c) {
    if (!live(j)) return;
    int lo, hi;
    gpp::chunk_bounds(a.bs, a.C, c, &lo, &hi);
    const size_t phys = (size_t)trow[j];
    auto arow = [&](int r) -> const char* {
      return reinterpret_cast<const char*>(
          pa + ((phys * a.bs + r) * a.kvh + g) * a.da);
    };
    auto brow = [&](int r) -> const char* {
      return reinterpret_cast<const char*>(
          pb + ((phys * a.bs + r) * a.kvh + g) * a.db);
    };
    const int a_bytes = a.da * (int)sizeof(KT);
    const int b_bytes = a.db * (int)sizeof(KT);
    gpp::copy_rows_vec(a.vec,
                       reinterpret_cast<char*>(ring_a + (j % a.G) * slot_a),
                       a.row_bytes_a, lo, hi, a_bytes, a_bytes, arow,
                       reinterpret_cast<const char*>(pa));
    gpp::copy_rows_vec(a.vec,
                       reinterpret_cast<char*>(ring_b + (j % a.G) * slot_b),
                       a.row_bytes_b, lo, hi, b_bytes, b_bytes, brow,
                       reinterpret_cast<const char*>(pb));
  };

  const KT* qg = q + ((size_t)(b * a.kvh + g) * a.rS + r0) * dk;
  for (int i = threadIdx.x; i < nr * dk; i += kThreads) qs[i] = to_f32(qg[i]);
  for (int i = threadIdx.x; i < nr * dv; i += kThreads) acc[i] = 0.0f;
  for (int r = threadIdx.x; r < nr; r += kThreads) {
    ms[r] = -INFINITY;
    ls[r] = 0.0f;
  }
  // (the barrier in run_chunk_schedule publishes qs / acc / ms / ls)

  for (int j = 0; j < a.MB; ++j) {
    gpp::run_chunk_schedule(j, a.MB, a.G, a.C, issue);
    if (live(j)) {  // uniform across the CTA
      const KT* at = reinterpret_cast<const KT*>(ring_a + (j % a.G) * slot_a);
      const KT* bt = reinterpret_cast<const KT*>(ring_b + (j % a.G) * slot_b);
      for (int e = threadIdx.x; e < nr * a.bs; e += kThreads) {
        const int r = e / a.bs, t = e % a.bs;
        const float* qr = qs + r * dk;
        const KT* kr = at + t * stride_a;
        float dot = 0.0f;
        for (int d = 0; d < a.da; ++d) dot = fmaf(qr[d], to_f32(kr[d]), dot);
        if (MLA) {  // the key's rope tail: q[da:] . k_rope
          const KT* kb = bt + t * stride_b;
          for (int d = 0; d < a.db; ++d) {
            dot = fmaf(qr[a.da + d], to_f32(kb[d]), dot);
          }
        }
        const int qpos = pos + (r0 + r) % a.S;
        const int kpos = j * a.bs + t;
        bool valid = kpos <= qpos;
        if (a.window > 0) valid = valid && kpos > qpos - a.window;
        ps[e] = valid ? dot : -INFINITY;
      }
      __syncthreads();
      for (int r = threadIdx.x; r < nr; r += kThreads) {
        float* pr = ps + r * a.bs;
        const float m = ms[r];
        float mx = -INFINITY;
        for (int t = 0; t < a.bs; ++t) mx = fmaxf(mx, pr[t]);
        const float m_new = fmaxf(m, mx);
        const float m_safe = isinf(m_new) ? 0.0f : m_new;
        float sum = 0.0f;
        for (int t = 0; t < a.bs; ++t) {
          const float p = expf(pr[t] - m_safe);
          pr[t] = p;
          sum += p;
        }
        const float corr = isinf(m) ? 0.0f : expf(m - m_safe);
        ms[r] = m_new;
        ls[r] = ls[r] * corr + sum;
        cs[r] = corr;
      }
      __syncthreads();
      // the value: the b ring (GQA) or the a ring's latent rows (MLA)
      const KT* vt = MLA ? at : bt;
      const int vstride = MLA ? stride_a : stride_b;
      for (int e = threadIdx.x; e < nr * dv; e += kThreads) {
        const int r = e / dv, d = e % dv;
        const float* pr = ps + r * a.bs;
        float pv = 0.0f;
        for (int t = 0; t < a.bs; ++t) {
          pv = fmaf(through(pr[t], pa), to_f32(vt[t * vstride + d]), pv);
        }
        acc[e] = acc[e] * cs[r] + pv;
      }
    }
    __syncthreads();  // the slot is free for the next step's issue
  }

  KT* out = static_cast<KT*>(a.out) +
            ((size_t)(b * a.kvh + g) * a.rS + r0) * dv;
  for (int e = threadIdx.x; e < nr * dv; e += kThreads) {
    out[e] = from_f32<KT>(acc[e] / fmaxf(ls[e / dv], 1e-30f));
  }
}

// two entry points, so the GQA and MLA launches show apart in a trace
template <typename KT>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(PagedArgs a) {
  paged_attention_body<KT, false>(a);
}

template <typename KT>
__global__ void __launch_bounds__(kThreads)
    paged_attention_mla_kernel(PagedArgs a) {
  paged_attention_body<KT, true>(a);
}

template <typename KT, bool MLA>
cudaError_t launch(const PagedArgs& a, int B, int splits,
                   cudaStream_t stream) {
  auto kernel = MLA ? paged_attention_mla_kernel<KT>
                    : paged_attention_kernel<KT>;
  const int dk = MLA ? a.da + a.db : a.da;
  const int dv = MLA ? a.da : a.db;
  const size_t ring =
      (size_t)a.G * a.bs * ((size_t)a.row_bytes_a + a.row_bytes_b);
  const size_t smem = ring + (size_t)a.rows_per_cta * (dk + dv) * 4 +
                      (size_t)a.rows_per_cta * a.bs * 4 +
                      3 * (size_t)a.rows_per_cta * 4;
  static size_t smem_set = 0;  // per instantiation: raise the limit once
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const dim3 grid(B, a.kvh, splits);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, pools and output alike).
// GQA: mla = 0, da = db = head_dim.  MLA: mla = 1, kvh = 1, da = kv_lora,
// db = rope_dim.
extern "C" int paged_attention_launch(
    const void* q, const void* pool_a, const void* pool_b, const int* tables,
    const int* positions, void* out, int B, int MB, int bs, int kvh, int da,
    int db, int mla, int S, int rS, int rows_per_cta, int splits, int G,
    int C, int window, int vec, int row_bytes_a, int row_bytes_b, int dtype,
    void* stream) {
  if (G < 1 || C < 1 || rows_per_cta < 1 || splits < 1 ||
      row_bytes_a % 16 != 0 || row_bytes_b % 16 != 0 ||
      (!mla && da != db) || (mla && kvh != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  PagedArgs a{q,  pool_a, pool_b, tables,       positions, out,
              MB, bs,     kvh,    da,           db,        S,
              rS, rows_per_cta,   G,            C,         window,
              vec, row_bytes_a,   row_bytes_b};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + (mla ? 1 : 0)) {
    case 0:
      return (int)launch<float, false>(a, B, splits, st);
    case 1:
      return (int)launch<float, true>(a, B, splits, st);
    case 2:
      return (int)launch<__nv_bfloat16, false>(a, B, splits, st);
    case 3:
      return (int)launch<__nv_bfloat16, true>(a, B, splits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
// FMA kernel above spends 40+ us on one CTA per (lane, KV head), 64 CTAs
// for 132 SMs, each walking the lane's blocks in order with three barriers
// a block and a handful of threads in 16- to 64-long serial FMA chains.
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
// the two tensor-core kernels above (bf16 MLA: a unit is (lane, row tile),
// da the latent width; bf16 GQA: a unit is (lane, KV head, row tile), da
// the head_dim).  The workspace holds, per unit and split, 16 rows of f32
// acc (da wide), then every (unit, split)'s 16 (m, l) pairs.
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
__global__ void __launch_bounds__(kMergeThreads)
    paged_attention_merge_kernel(const float* ws, bf16* out, int units,
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
    const float l = lsum[r];
    bf16* dst = out + ((size_t)b * rS + r0 + r) * da + col;
    *reinterpret_cast<__nv_bfloat162*>(dst) =
        __floats2bfloat162_rn(o[h].x / l, o[h].y / l);
    *reinterpret_cast<__nv_bfloat162*>(dst + 2) =
        __floats2bfloat162_rn(o[h].z / l, o[h].w / l);
  }
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

// Merge the partials a tensor-core kernel left in ws (kv_splits > 1) into
// out (units / row_tiles, rS, da) bf16: one CTA per (64-column slice,
// unit).  `units` = lanes x row tiles (MLA), lanes x KV heads x row tiles
// (GQA).
extern "C" int paged_attention_merge_launch(const float* ws, void* out,
                                            int units, int row_tiles,
                                            int kv_splits, int da, int rS,
                                            void* stream) {
  using namespace merge;
  if (ws == nullptr || units < 1 || row_tiles < 1 || units % row_tiles ||
      kv_splits < 2 || da < 8 || da % 8 != 0 || rS < 1 ||
      row_tiles * kRows < rS) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = merge_smem_bytes(kv_splits);
  static size_t smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_merge_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const dim3 grid((da + kMergeCols - 1) / kMergeCols, units);
  paged_attention_merge_kernel<<<grid, kMergeThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      ws, static_cast<__nv_bfloat16*>(out), units, row_tiles, kv_splits, da,
      rS);
  return (int)cudaGetLastError();
}
