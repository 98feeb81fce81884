// GATv2 per-head edge logits without the softmax, forward and backward
// (CUDA, sm_90a).
//
// Forward, replaces scripts/bench_gat.py::pallas_logits (kernel :76), the
// forward of ctvae_tpu/ops/gat.py::fused_gat_logits (:49-72). Per (b, k):
//
//   e[b,s,t,k] = sum_f att[k,f] leaky(xl[b,s,k,f] + xr[b,t,k,f]
//                                      + adj[b,s,t] we[k,f], ns)
//
// with xl [B,S,K,F], xr [B,T,K,F], adj [B,S,T], and we / att either shared
// [K,F] (batch stride 0) or per sample [B,K,F] (the CT transition's head
// subset, DenseGATv2Layer.heads_call). The output is [B,S,T,K], the layout
// masked_incoming_softmax takes.
//
// Bound on the H100: the [B,S,T,K,F] domain (192*65*65*2*64 = 1.04e8
// elements at the causal step) costs ~7 f32 operations per element and is
// never stored; inputs and output are ~23 MB, so the kernel is bound by f32
// operations. One block per (b, k) holds xl[b,:,k,:] and xr[b,:,k,:] in
// shared memory (33 KB at F = 64, 52 KB at F = 100; rows padded to an odd
// stride, so the lanes of a warp, which take neighbouring targets, read
// distinct banks) and we / att of its head; its threads take the (s, t)
// pairs and each loops over the features, so every input element is read
// from device memory once and each logit is summed by one thread.
//
// Backward, replaces the one-walk VJP ctvae_tpu/ops/gat.py::_fgl_bwd
// (:85-100). From d_e [B,S,T,K], with g = d_e (pre >= 0 ? 1 : ns):
//
//   dxl[s,f]   = att[f] sum_t g          dxr[t,f]  = att[f] sum_s g
//   dadj_k[s,t] = sum_f g att[f] we[f]   dwe_k[f]  = att[f] sum_{s,t} g adj
//   datt_k[f]  = sum_{s,t} pre g         (= sum act d_e)
//
// dadj sums over heads and, for shared heads, dwe / datt over the batch: a
// (b, k) block cannot do either, so it writes per-head dadj_k [B,K,S,T] and
// per-sample dwe_k / datt_k [B,K,F], and the caller sums them. Bound: the
// domain re-walked twice at ~15 f32 operations per element, never stored.
// One block per (b, k) holds xl, xr, adj and d_e of its head in shared
// memory. Phase 1, one warp per source s, lanes over features: dxl, the
// dadj row (one shuffle reduction per edge) and the dwe / datt partials.
// Phase 2, one warp per target t: the walk again for dxr. Each output
// element is summed by one thread (the dwe / datt partials by one thread
// per feature over the warps, in warp order), with no atomics, so two runs
// agree bit for bit. Pairs with d_e = 0 (the softmax's non-edges) are
// skipped; they add exact zeros to every sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxF = 128;  // features per head held in registers (4 / lane)
constexpr int kFwdThreads = 256;

// (xl + xr) + adj * we rounded as the plain version rounds it (no fused
// multiply-add), so kernel and plain version agree on the leaky slope
// where pre is within rounding of 0
__device__ __forceinline__ float pre_act(float xl, float xr, float a,
                                         float we) {
  return __fadd_rn(xl + xr, __fmul_rn(a, we));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// xl[b,:,k,:] -> xl_s [S, Fp] and xr[b,:,k,:] -> xr_s [T, Fp]
__device__ void load_head(const float* __restrict__ xl,
                          const float* __restrict__ xr, float* xl_s,
                          float* xr_s, int b, int k, int S, int T, int K,
                          int F, int Fp) {
  const int KF = K * F;
  for (int i = threadIdx.x; i < S * F; i += blockDim.x) {
    const int s = i / F, f = i % F;
    xl_s[s * Fp + f] = xl[((size_t)b * S + s) * KF + k * F + f];
  }
  for (int i = threadIdx.x; i < T * F; i += blockDim.x) {
    const int t = i / F, f = i % F;
    xr_s[t * Fp + f] = xr[((size_t)b * T + t) * KF + k * F + f];
  }
}

__global__ void gat_logits_fwd_kernel(const float* __restrict__ xl,
                                      const float* __restrict__ xr,
                                      const float* __restrict__ adj,
                                      const float* __restrict__ we,
                                      const float* __restrict__ att,
                                      float* __restrict__ out, int S, int T,
                                      int K, int F, int wstride, float ns) {
  extern __shared__ float smem[];
  const int Fp = F | 1;  // odd row stride
  float* xl_s = smem;                   // [S, Fp]
  float* xr_s = xl_s + (size_t)S * Fp;  // [T, Fp]
  float* we_s = xr_s + (size_t)T * Fp;  // [F]
  float* at_s = we_s + F;               // [F]

  const int b = blockIdx.x / K;
  const int k = blockIdx.x % K;
  load_head(xl, xr, xl_s, xr_s, b, k, S, T, K, F, Fp);
  const float* wb = we + (size_t)b * wstride + k * F;
  const float* ab = att + (size_t)b * wstride + k * F;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    we_s[f] = wb[f];
    at_s[f] = ab[f];
  }
  __syncthreads();

  const float* adjb = adj + (size_t)b * S * T;
  for (int p = threadIdx.x; p < S * T; p += blockDim.x) {
    const int s = p / T, t = p % T;
    const float a = adjb[p];
    const float* xs = xl_s + (size_t)s * Fp;
    const float* xt = xr_s + (size_t)t * Fp;
    float acc = 0.f;
    for (int f = 0; f < F; ++f) {
      const float v = pre_act(xs[f], xt[f], a, we_s[f]);
      acc = fmaf(v >= 0.f ? v : ns * v, at_s[f], acc);
    }
    out[((size_t)b * S * T + p) * K + k] = acc;
  }
}

// per-warp scratch floats: a dadj row of T, or the final reduction's 2 x F
// when that is longer
__host__ __device__ inline int bwd_warp_floats(int T, int F) {
  return T > 2 * F ? T : 2 * F;
}

__global__ void gat_logits_bwd_kernel(const float* __restrict__ xl,
                                      const float* __restrict__ xr,
                                      const float* __restrict__ adj,
                                      const float* __restrict__ we,
                                      const float* __restrict__ att,
                                      const float* __restrict__ de,
                                      float* __restrict__ dxl,
                                      float* __restrict__ dxr,
                                      float* __restrict__ dadj_k,
                                      float* __restrict__ dwe_k,
                                      float* __restrict__ datt_k, int S,
                                      int T, int K, int F, int wstride,
                                      float ns) {
  extern __shared__ float smem[];
  const int nwarps = blockDim.x / 32;
  const int Fp = F | 1;
  const int wf = bwd_warp_floats(T, F);
  float* xl_s = smem;                    // [S, Fp]
  float* xr_s = xl_s + (size_t)S * Fp;   // [T, Fp]
  float* adj_s = xr_s + (size_t)T * Fp;  // [S, T]
  float* de_s = adj_s + (size_t)S * T;   // [S, T]: d_e of this head
  float* scr_s = de_s + (size_t)S * T;   // [nwarps, wf]

  const int b = blockIdx.x / K;
  const int k = blockIdx.x % K;
  load_head(xl, xr, xl_s, xr_s, b, k, S, T, K, F, Fp);
  const size_t st0 = (size_t)b * S * T;
  for (int p = threadIdx.x; p < S * T; p += blockDim.x) {
    adj_s[p] = adj[st0 + p];
    de_s[p] = de[(st0 + p) * K + k];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int KF = K * F;
  const float* wb = we + (size_t)b * wstride + k * F;
  const float* ab = att + (size_t)b * wstride + k * F;
  float wev[kMaxF / 32], attv[kMaxF / 32], awv[kMaxF / 32];
  float gw[kMaxF / 32], ga[kMaxF / 32];
#pragma unroll
  for (int j = 0; j < kMaxF / 32; ++j) {
    const int f = lane + 32 * j;
    wev[j] = f < F ? wb[f] : 0.f;
    attv[j] = f < F ? ab[f] : 0.f;
    awv[j] = attv[j] * wev[j];
    gw[j] = 0.f;
    ga[j] = 0.f;
  }
  float* qrow = scr_s + (size_t)warp * wf;  // this warp's dadj row

  // phase 1: one warp per source s
  for (int s = warp; s < S; s += nwarps) {
    float xlv[kMaxF / 32], gl[kMaxF / 32];
#pragma unroll
    for (int j = 0; j < kMaxF / 32; ++j) {
      const int f = lane + 32 * j;
      xlv[j] = f < F ? xl_s[(size_t)s * Fp + f] : 0.f;
      gl[j] = 0.f;
    }
    const float* as = adj_s + (size_t)s * T;
    const float* ds = de_s + (size_t)s * T;
    for (int t = 0; t < T; ++t) {
      const float d = ds[t];
      if (d == 0.f) {  // warp-uniform
        if (lane == 0) qrow[t] = 0.f;
        continue;
      }
      const float a = as[t], dn = ns * d;
      const float* xt = xr_s + (size_t)t * Fp;
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxF / 32; ++j) {
        const int f = lane + 32 * j;
        if (f < F) {
          const float pre = pre_act(xlv[j], xt[f], a, wev[j]);
          const float g = pre >= 0.f ? d : dn;
          gl[j] += g;
          p = fmaf(g, awv[j], p);
          gw[j] = fmaf(g, a, gw[j]);
          ga[j] = fmaf(pre, g, ga[j]);
        }
      }
      p = warp_sum(p);
      if (lane == 0) qrow[t] = p;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kMaxF / 32; ++j) {
      const int f = lane + 32 * j;
      if (f < F) dxl[((size_t)b * S + s) * KF + k * F + f] = attv[j] * gl[j];
    }
    float* dq = dadj_k + (((size_t)b * K + k) * S + s) * T;
    for (int t = lane; t < T; t += 32) dq[t] = qrow[t];
    __syncwarp();
  }

  // phase 2: one warp per target t
  for (int t = warp; t < T; t += nwarps) {
    float xrv[kMaxF / 32], gr[kMaxF / 32];
#pragma unroll
    for (int j = 0; j < kMaxF / 32; ++j) {
      const int f = lane + 32 * j;
      xrv[j] = f < F ? xr_s[(size_t)t * Fp + f] : 0.f;
      gr[j] = 0.f;
    }
    for (int s = 0; s < S; ++s) {
      const float d = de_s[(size_t)s * T + t];
      if (d == 0.f) continue;  // warp-uniform
      const float a = adj_s[(size_t)s * T + t], dn = ns * d;
      const float* xs = xl_s + (size_t)s * Fp;
#pragma unroll
      for (int j = 0; j < kMaxF / 32; ++j) {
        const int f = lane + 32 * j;
        if (f < F) gr[j] += pre_act(xs[f], xrv[j], a, wev[j]) >= 0.f ? d : dn;
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxF / 32; ++j) {
      const int f = lane + 32 * j;
      if (f < F) dxr[((size_t)b * T + t) * KF + k * F + f] = attv[j] * gr[j];
    }
  }
  __syncthreads();

  // the warps' dwe / datt partials meet in the (now free) scratch rows
  float* red = scr_s;  // [2, nwarps, F] within nwarps * wf floats
#pragma unroll
  for (int j = 0; j < kMaxF / 32; ++j) {
    const int f = lane + 32 * j;
    if (f < F) {
      red[(size_t)warp * F + f] = gw[j];
      red[((size_t)nwarps + warp) * F + f] = ga[j];
    }
  }
  __syncthreads();
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float w = 0.f, a = 0.f;
    for (int i = 0; i < nwarps; ++i) {
      w += red[(size_t)i * F + f];
      a += red[((size_t)nwarps + i) * F + f];
    }
    const size_t o = ((size_t)b * K + k) * F + f;
    dwe_k[o] = ab[f] * w;
    datt_k[o] = a;
  }
}

}  // namespace

extern "C" size_t gat_logits_fwd_smem_bytes(int S, int T, int F) {
  return sizeof(float) * (((size_t)S + T) * (size_t)(F | 1) + 2 * (size_t)F);
}

extern "C" int gat_logits_fwd(const float* xl, const float* xr,
                              const float* adj, const float* we,
                              const float* att, float* out, int B, int S,
                              int T, int K, int F, int wstride, float ns,
                              void* stream) {
  if (F > kMaxF) return (int)cudaErrorInvalidValue;
  size_t smem = gat_logits_fwd_smem_bytes(S, T, F);
  cudaError_t err = cudaFuncSetAttribute(
      gat_logits_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && K > 0) {
    gat_logits_fwd_kernel<<<B * K, kFwdThreads, smem, (cudaStream_t)stream>>>(
        xl, xr, adj, we, att, out, S, T, K, F, wstride, ns);
  }
  return (int)cudaGetLastError();
}

extern "C" size_t gat_logits_bwd_smem_bytes(int S, int T, int F, int nwarps) {
  return sizeof(float) * (((size_t)S + T) * (size_t)(F | 1) +
                          2 * (size_t)S * T +
                          (size_t)nwarps * bwd_warp_floats(T, F));
}

extern "C" int gat_logits_bwd(const float* xl, const float* xr,
                              const float* adj, const float* we,
                              const float* att, const float* de, float* dxl,
                              float* dxr, float* dadj_k, float* dwe_k,
                              float* datt_k, int B, int S, int T, int K,
                              int F, int wstride, int nwarps, float ns,
                              void* stream) {
  if (F > kMaxF || nwarps < 1 || nwarps > 32) return (int)cudaErrorInvalidValue;
  size_t smem = gat_logits_bwd_smem_bytes(S, T, F, nwarps);
  cudaError_t err = cudaFuncSetAttribute(
      gat_logits_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && K > 0) {
    gat_logits_bwd_kernel<<<B * K, nwarps * 32, smem, (cudaStream_t)stream>>>(
        xl, xr, adj, we, att, de, dxl, dxr, dadj_k, dwe_k, datt_k, S, T, K, F,
        wstride, ns);
  }
  return (int)cudaGetLastError();
}
