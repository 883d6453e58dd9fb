// Paged attention (GQA, optional sliding window, and MLA) for sm_90a.
//
// Replaces repro/kernels/paged_attention.py::paged_attention (the Pallas TPU
// kernel, pallas_call at :341, body _paged_attn_kernel :111), both its
// GQA/window path and its `mla=True` path (:173-177).
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
// C interface (ctypes): paged_attention_launch returns the launch's
// cudaError_t.  The kernel only reads the pools.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
