// Paged attention (GQA, optional sliding window) for sm_90a.
//
// Replaces repro/kernels/paged_attention.py::paged_attention, GQA/window path
// (the Pallas TPU kernel, pallas_call at :341, body _paged_attn_kernel :111).
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
//
// What bounds it on the H100: the KV bytes — decode does ~2 FLOPs per KV
// byte.  A block's K and V rows arrive in C chunks issued over the C steps
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
  const void* q;         // (B, KVH, rS, hd): pre-scaled, KV dtype
  const void* k_pool;    // (nb, bs, KVH, hd)
  const void* v_pool;    // (nb, bs, KVH, hd)
  const int* tables;     // (B, MB); 0 = the null block
  const int* positions;  // (B,): first query position of each lane
  void* out;             // (B, KVH, rS, hd), KV dtype
  int MB, bs, kvh, hd;
  int S, rS;             // queries per lane, rows per head (rep * S)
  int rows_per_cta;
  int G, C;
  int window;            // <= 0: none
  int vec;               // cp.async width for K/V rows
  int row_bytes;         // shared-memory stride of one K/V row
};

template <typename KT>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(PagedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, g = blockIdx.y;
  const int r0 = blockIdx.z * a.rows_per_cta;
  const int nr = min(a.rows_per_cta, a.rS - r0);
  const size_t slot_bytes = (size_t)a.bs * a.row_bytes;
  unsigned char* ring_k = smem;
  unsigned char* ring_v = smem + a.G * slot_bytes;
  float* qs = reinterpret_cast<float*>(smem + 2 * a.G * slot_bytes);
  float* acc = qs + a.rows_per_cta * a.hd;
  float* ps = acc + a.rows_per_cta * a.hd;
  float* ms = ps + a.rows_per_cta * a.bs;
  float* ls = ms + a.rows_per_cta;
  float* cs = ls + a.rows_per_cta;

  const KT* q = static_cast<const KT*>(a.q);
  const KT* kp = static_cast<const KT*>(a.k_pool);
  const KT* vp = static_cast<const KT*>(a.v_pool);
  const int pos = a.positions[b];
  const int* trow = a.tables + (size_t)b * a.MB;
  const int hd_bytes = a.hd * (int)sizeof(KT);
  const int kstride = a.row_bytes / (int)sizeof(KT);

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
    const size_t slot = (size_t)(j % a.G) * slot_bytes;
    auto krow = [&](int r) -> const char* {
      return reinterpret_cast<const char*>(
          kp + ((phys * a.bs + r) * a.kvh + g) * a.hd);
    };
    auto vrow = [&](int r) -> const char* {
      return reinterpret_cast<const char*>(
          vp + ((phys * a.bs + r) * a.kvh + g) * a.hd);
    };
    gpp::copy_rows_vec(a.vec, reinterpret_cast<char*>(ring_k + slot),
                       a.row_bytes, lo, hi, hd_bytes, hd_bytes, krow,
                       reinterpret_cast<const char*>(kp));
    gpp::copy_rows_vec(a.vec, reinterpret_cast<char*>(ring_v + slot),
                       a.row_bytes, lo, hi, hd_bytes, hd_bytes, vrow,
                       reinterpret_cast<const char*>(vp));
  };

  const KT* qg = q + ((size_t)(b * a.kvh + g) * a.rS + r0) * a.hd;
  for (int i = threadIdx.x; i < nr * a.hd; i += kThreads) {
    qs[i] = to_f32(qg[i]);
    acc[i] = 0.0f;
  }
  for (int r = threadIdx.x; r < nr; r += kThreads) {
    ms[r] = -INFINITY;
    ls[r] = 0.0f;
  }
  // (the barrier in run_chunk_schedule publishes qs / acc / ms / ls)

  for (int j = 0; j < a.MB; ++j) {
    gpp::run_chunk_schedule(j, a.MB, a.G, a.C, issue);
    if (live(j)) {  // uniform across the CTA
      const KT* kt = reinterpret_cast<const KT*>(
          ring_k + (size_t)(j % a.G) * slot_bytes);
      const KT* vt = reinterpret_cast<const KT*>(
          ring_v + (size_t)(j % a.G) * slot_bytes);
      for (int e = threadIdx.x; e < nr * a.bs; e += kThreads) {
        const int r = e / a.bs, t = e % a.bs;
        const float* qr = qs + r * a.hd;
        const KT* kr = kt + t * kstride;
        float dot = 0.0f;
        for (int d = 0; d < a.hd; ++d) dot = fmaf(qr[d], to_f32(kr[d]), dot);
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
      for (int e = threadIdx.x; e < nr * a.hd; e += kThreads) {
        const int r = e / a.hd, d = e % a.hd;
        const float* pr = ps + r * a.bs;
        float pv = 0.0f;
        for (int t = 0; t < a.bs; ++t) {
          pv = fmaf(through(pr[t], kp), to_f32(vt[t * kstride + d]), pv);
        }
        acc[e] = acc[e] * cs[r] + pv;
      }
    }
    __syncthreads();  // the slot is free for the next step's issue
  }

  KT* out = static_cast<KT*>(a.out) +
            ((size_t)(b * a.kvh + g) * a.rS + r0) * a.hd;
  for (int e = threadIdx.x; e < nr * a.hd; e += kThreads) {
    out[e] = from_f32<KT>(acc[e] / fmaxf(ls[e / a.hd], 1e-30f));
  }
}

template <typename KT>
cudaError_t launch(const PagedArgs& a, int B, int splits,
                   cudaStream_t stream) {
  const size_t ring = 2 * (size_t)a.G * a.bs * a.row_bytes;
  const size_t smem = ring + (size_t)a.rows_per_cta * a.hd * 4 * 2 +
                      (size_t)a.rows_per_cta * a.bs * 4 +
                      3 * (size_t)a.rows_per_cta * 4;
  static size_t smem_set = 0;  // per instantiation: raise the limit once
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const dim3 grid(B, a.kvh, splits);
  paged_attention_kernel<KT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, pools and output alike).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const int* tables,
    const int* positions, void* out, int B, int MB, int bs, int kvh, int hd,
    int S, int rS, int rows_per_cta, int splits, int G, int C, int window,
    int vec, int row_bytes, int dtype, void* stream) {
  if (G < 1 || C < 1 || rows_per_cta < 1 || splits < 1 ||
      row_bytes % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  PagedArgs a{q,  k_pool, v_pool, tables, positions, out, MB,     bs,
              kvh, hd,    S,      rS,     rows_per_cta, G, C, window,
              vec, row_bytes};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(a, B, splits, st);
    case 1:
      return (int)launch<__nv_bfloat16>(a, B, splits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
