// GATv2 masked attention, forward and backward (CUDA, sm_90a).
//
// Forward, replaces ctvae_tpu/ops/gat_flash.py::flash_gat (_fwd_kernel
// :117). Per (b, t, h):
//
//   e[s]     = sum_f leaky(xl[b,s,h,f] + xr[b,t,h,f] + adj[b,s,t] we[h,f], ns)
//              * att[h,f]
//   alpha[s] = softmax of e over the sources s with mask[b,s,t]
//              (all zeros when t has no incoming edge)
//   out[b,t,h,f] = sum_s alpha[s] xl[b,s,h,f]
//
// Bound on the H100: the [B,T,S,H,F] logit domain (192*65*65*1300 = 1.05e9
// elements in causal serving) costs ~7 f32 operations per element plus the
// aggregation, and is never stored; inputs and output are ~130 MB, so the
// kernel is bound by f32 operations. A whole xl[b] (65 x 1300 floats, 338 KB)
// does not fit in shared memory, so the design tiles over heads: one block
// per (b, h) holds the 26 KB slice xl[b,:,h,:] and we/att[h] in shared memory
// and its warps loop over the targets, so every xl element is read from
// device memory once. One warp per target: lanes own features (coalesced,
// conflict-free), xr[b,t,h] + adj*we stays in registers, a shuffle reduces
// each logit, the masked softmax runs over a per-warp logit row in shared
// memory, and the aggregation walks the shared slice once more. When the
// caller passes an alpha pointer (training), the warp also writes its
// normalised row as the f32 residual alpha[b, h, t, s] ([B, H, T, S], zero
// for non-edges and for an edgeless target); serving passes null.
//
// Backward, replaces _flash_vjp_bwd (_bwd_kernel :175). Per (b, h), from
// the residual alpha and dout:
//
//   dalpha[t,s] = sum_f dout[t,f] xl[s,f]
//   de[t,s]     = alpha[t,s] (dalpha[t,s] - sum_s' alpha[t,s'] dalpha[t,s'])
//   g[t,s,f]    = de[t,s] (pre >= 0 ? 1 : ns),  pre as in the forward
//   dxr[t,f]    = att[f] sum_s g            dxl[s,f] = att[f] sum_t g
//                                                      + sum_t alpha dout[t,f]
//   dadj_h[t,s] = sum_f g att[f] we[f]      dwe_h[f] = att[f] sum_{t,s} g adj
//   datt_h[f]   = sum_{t,s} pre g
//
// dadj sums over heads and dwe / datt over the batch; a (b, h) block cannot
// do either, so it writes per-head dadj_h [B, H, T, S] and per-sample
// dwe_h / datt_h [B, H, F], and the caller sums them. Bound: the logit
// domain re-walked at ~17 f32 operations per edge and feature, never
// stored. One block per (b, h) holds xl, xr and dout of its head in shared
// memory (rows padded to an odd stride, conflict-free both by row and by
// column) and works in two phases. Phase 1, one warp per target: lanes take
// sources for dalpha and de (stored for phase 2), then lanes take features
// for the walk that gives dxr, dadj_h and the dwe / datt sums. Phase 2, one
// warp per source: the walk again, lanes over features, for dxl. Each output
// element is summed by one thread in a fixed order (no atomics), so two runs
// agree bit for bit. Non-edges (alpha = 0) are skipped; an edgeless target
// contributes nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxF = 128;  // features per head held in registers (4 / lane)

// (xl + xr) + adj * we rounded as the plain version rounds it (no fused
// multiply-add), so kernel and plain version agree on the leaky slope
// where pre is within rounding of 0
__device__ __forceinline__ float pre_act(float xl, float xr, float a,
                                         float we) {
  return __fadd_rn(xl + xr, __fmul_rn(a, we));
}

__global__ void gat_fwd_kernel(const float* __restrict__ xl,
                               const float* __restrict__ xr,
                               const float* __restrict__ adj,
                               const uint8_t* __restrict__ mask,
                               const float* __restrict__ we,
                               const float* __restrict__ att,
                               float* __restrict__ out,
                               float* __restrict__ alpha,
                               int S, int T, int H, int F, float ns) {
  extern __shared__ float smem[];
  const int nwarps = blockDim.x / 32;
  float* xl_s = smem;                         // [S, F]
  float* row_s = xl_s + (size_t)S * F;        // [nwarps, S]: logit / alpha
  float* adj_s = row_s + (size_t)nwarps * S;  // [nwarps, S]
  uint8_t* msk_s = (uint8_t*)(adj_s + (size_t)nwarps * S);  // [nwarps, S]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int HF = H * F;
  for (int i = threadIdx.x; i < S * F; i += blockDim.x) {
    int s = i / F, f = i % F;
    xl_s[i] = xl[((size_t)b * S + s) * HF + h * F + f];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* row = row_s + warp * S;
  float* adjw = adj_s + warp * S;
  uint8_t* mw = msk_s + warp * S;

  float wev[kMaxF / 32], attv[kMaxF / 32];
#pragma unroll
  for (int j = 0; j < kMaxF / 32; ++j) {
    int f = lane + 32 * j;
    wev[j] = f < F ? we[h * F + f] : 0.f;
    attv[j] = f < F ? att[h * F + f] : 0.f;
  }

  for (int t = warp; t < T; t += nwarps) {
    float xrv[kMaxF / 32];
#pragma unroll
    for (int j = 0; j < kMaxF / 32; ++j) {
      int f = lane + 32 * j;
      xrv[j] = f < F ? xr[((size_t)b * T + t) * HF + h * F + f] : 0.f;
    }
    for (int s = lane; s < S; s += 32) {
      adjw[s] = adj[((size_t)b * S + s) * T + t];
      mw[s] = mask[((size_t)b * S + s) * T + t];
    }
    __syncwarp();

    // logits of the incoming edges
    for (int s = 0; s < S; ++s) {
      if (!mw[s]) continue;  // warp-uniform
      const float a = adjw[s];
      const float* xls = xl_s + (size_t)s * F;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxF / 32; ++j) {
        int f = lane + 32 * j;
        if (f < F) {
          float v = pre_act(xls[f], xrv[j], a, wev[j]);
          part = fmaf(fmaxf(v, ns * v), attv[j], part);
        }
      }
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) row[s] = part;
    }
    __syncwarp();

    // masked softmax over the sources
    float m = -INFINITY;
    for (int s = lane; s < S; s += 32)
      if (mw[s]) m = fmaxf(m, row[s]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float denom = 0.f;
    for (int s = lane; s < S; s += 32) {
      float w = mw[s] ? expf(row[s] - m) : 0.f;
      row[s] = w;
      denom += w;
    }
    for (int off = 16; off > 0; off >>= 1)
      denom += __shfl_xor_sync(0xffffffffu, denom, off);
    const float inv = denom > 0.f ? 1.f / denom : 0.f;
    __syncwarp();
    if (alpha != nullptr) {
      float* ar = alpha + (((size_t)b * H + h) * T + t) * S;
      for (int s = lane; s < S; s += 32) ar[s] = row[s] * inv;
    }

    // aggregation over the sources
    float acc[kMaxF / 32];
#pragma unroll
    for (int j = 0; j < kMaxF / 32; ++j) acc[j] = 0.f;
    for (int s = 0; s < S; ++s) {
      const float w = row[s];
      if (w == 0.f) continue;  // warp-uniform
      const float* xls = xl_s + (size_t)s * F;
#pragma unroll
      for (int j = 0; j < kMaxF / 32; ++j) {
        int f = lane + 32 * j;
        if (f < F) acc[j] = fmaf(w, xls[f], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxF / 32; ++j) {
      int f = lane + 32 * j;
      if (f < F) out[((size_t)b * T + t) * HF + h * F + f] = acc[j] * inv;
    }
    __syncwarp();
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// per-warp scratch floats: 4 rows of max(S, T), or the final reduction's
// 2 x F when that is longer
__host__ __device__ inline int gat_bwd_warp_floats(int S, int T, int F) {
  const int r = 4 * (S > T ? S : T);
  return r > 2 * F ? r : 2 * F;
}

__global__ void gat_bwd_kernel(const float* __restrict__ xl,
                               const float* __restrict__ xr,
                               const float* __restrict__ adj,
                               const uint8_t* __restrict__ mask,
                               const float* __restrict__ we,
                               const float* __restrict__ att,
                               const float* __restrict__ alpha,
                               const float* __restrict__ dout,
                               float* __restrict__ dxl,
                               float* __restrict__ dxr,
                               float* __restrict__ dadj_h,
                               float* __restrict__ dwe_h,
                               float* __restrict__ datt_h,
                               int S, int T, int H, int F, float ns) {
  extern __shared__ float smem[];
  const int nwarps = blockDim.x / 32;
  const int Fp = F | 1;  // odd row stride
  const int R = S > T ? S : T;
  const int wf = gat_bwd_warp_floats(S, T, F);
  float* xl_s = smem;                        // [S, Fp]
  float* xr_s = xl_s + (size_t)S * Fp;       // [T, Fp]
  float* do_s = xr_s + (size_t)T * Fp;       // [T, Fp]: dout
  float* de_s = do_s + (size_t)T * Fp;       // [T, S]: d logits
  float* scr_s = de_s + (size_t)T * S;       // [nwarps, wf]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int HF = H * F;
  for (int i = threadIdx.x; i < S * F; i += blockDim.x) {
    const int s = i / F, f = i % F;
    xl_s[s * Fp + f] = xl[((size_t)b * S + s) * HF + h * F + f];
  }
  for (int i = threadIdx.x; i < T * F; i += blockDim.x) {
    const int t = i / F, f = i % F;
    const size_t o = ((size_t)b * T + t) * HF + h * F + f;
    xr_s[t * Fp + f] = xr[o];
    do_s[t * Fp + f] = dout[o];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* mrow = scr_s + (size_t)warp * wf;  // mask (0 / 1)
  float* arow = mrow + R;                   // adj
  float* prow = arow + R;                   // alpha, then de
  float* qrow = prow + R;                   // dalpha, then dadj_h

  float wev[kMaxF / 32], attv[kMaxF / 32], awv[kMaxF / 32];
  float gw[kMaxF / 32], ga[kMaxF / 32];
#pragma unroll
  for (int j = 0; j < kMaxF / 32; ++j) {
    const int f = lane + 32 * j;
    wev[j] = f < F ? we[h * F + f] : 0.f;
    attv[j] = f < F ? att[h * F + f] : 0.f;
    awv[j] = attv[j] * wev[j];
    gw[j] = 0.f;
    ga[j] = 0.f;
  }

  // phase 1: one warp per target t
  for (int t = warp; t < T; t += nwarps) {
    const float* al = alpha + (((size_t)b * H + h) * T + t) * S;
    for (int s = lane; s < S; s += 32) {
      const size_t o = ((size_t)b * S + s) * T + t;
      mrow[s] = mask[o] ? 1.f : 0.f;
      arow[s] = adj[o];
      prow[s] = al[s];
    }
    __syncwarp();
    // dalpha over the sources (lanes take sources), and sum_s alpha dalpha
    const float* dt = do_s + (size_t)t * Fp;
    float sc = 0.f;
    for (int s = lane; s < S; s += 32) {
      float da = 0.f;
      if (mrow[s] != 0.f) {
        const float* xs = xl_s + (size_t)s * Fp;
        for (int f = 0; f < F; ++f) da = fmaf(dt[f], xs[f], da);
      }
      qrow[s] = da;
      sc = fmaf(prow[s], da, sc);
    }
    sc = warp_sum(sc);
    for (int s = lane; s < S; s += 32) {
      const float de = prow[s] * (qrow[s] - sc);
      prow[s] = de;
      de_s[(size_t)t * S + s] = de;
    }
    __syncwarp();

    // the walk over the incoming edges (lanes take features)
    float xrv[kMaxF / 32], gr[kMaxF / 32];
#pragma unroll
    for (int j = 0; j < kMaxF / 32; ++j) {
      const int f = lane + 32 * j;
      xrv[j] = f < F ? xr_s[(size_t)t * Fp + f] : 0.f;
      gr[j] = 0.f;
    }
    for (int s = 0; s < S; ++s) {
      if (mrow[s] == 0.f) {  // warp-uniform
        if (lane == 0) qrow[s] = 0.f;
        continue;
      }
      const float d = prow[s], a = arow[s];
      const float* xs = xl_s + (size_t)s * Fp;
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxF / 32; ++j) {
        const int f = lane + 32 * j;
        if (f < F) {
          const float pre = pre_act(xs[f], xrv[j], a, wev[j]);
          const float g = pre >= 0.f ? d : ns * d;
          gr[j] += g;
          p = fmaf(g, awv[j], p);
          gw[j] = fmaf(g, a, gw[j]);
          ga[j] = fmaf(pre, g, ga[j]);
        }
      }
      p = warp_sum(p);
      if (lane == 0) qrow[s] = p;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kMaxF / 32; ++j) {
      const int f = lane + 32 * j;
      if (f < F) dxr[((size_t)b * T + t) * HF + h * F + f] = attv[j] * gr[j];
    }
    float* dq = dadj_h + (((size_t)b * H + h) * T + t) * S;
    for (int s = lane; s < S; s += 32) dq[s] = qrow[s];
    __syncwarp();
  }
  __syncthreads();

  // phase 2: one warp per source s
  for (int s = warp; s < S; s += nwarps) {
    for (int t = lane; t < T; t += 32) {
      const size_t o = ((size_t)b * S + s) * T + t;
      mrow[t] = mask[o] ? 1.f : 0.f;
      arow[t] = adj[o];
      prow[t] = alpha[(((size_t)b * H + h) * T + t) * S + s];
    }
    __syncwarp();
    float xlv[kMaxF / 32], g1[kMaxF / 32], g2[kMaxF / 32];
#pragma unroll
    for (int j = 0; j < kMaxF / 32; ++j) {
      const int f = lane + 32 * j;
      xlv[j] = f < F ? xl_s[(size_t)s * Fp + f] : 0.f;
      g1[j] = 0.f;
      g2[j] = 0.f;
    }
    for (int t = 0; t < T; ++t) {
      if (mrow[t] == 0.f) continue;  // warp-uniform
      const float d = de_s[(size_t)t * S + s], a = arow[t], al = prow[t];
      const float* xt = xr_s + (size_t)t * Fp;
      const float* dt = do_s + (size_t)t * Fp;
#pragma unroll
      for (int j = 0; j < kMaxF / 32; ++j) {
        const int f = lane + 32 * j;
        if (f < F) {
          const float pre = pre_act(xlv[j], xt[f], a, wev[j]);
          g1[j] += pre >= 0.f ? d : ns * d;
          g2[j] = fmaf(al, dt[f], g2[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxF / 32; ++j) {
      const int f = lane + 32 * j;
      if (f < F)
        dxl[((size_t)b * S + s) * HF + h * F + f] = fmaf(attv[j], g1[j], g2[j]);
    }
    __syncwarp();
  }
  __syncthreads();

  // the warps' dwe / datt sums meet in the (now free) scratch rows
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
    const size_t o = ((size_t)b * H + h) * F + f;
    dwe_h[o] = att[h * F + f] * w;
    datt_h[o] = a;
  }
}

}  // namespace

extern "C" size_t gat_fwd_smem_bytes(int S, int F, int nwarps) {
  return sizeof(float) * ((size_t)S * F + 2 * (size_t)nwarps * S) +
         (size_t)nwarps * S;
}

extern "C" int gat_fwd(const float* xl, const float* xr, const float* adj,
                       const uint8_t* mask, const float* we, const float* att,
                       float* out, float* alpha, int B, int S, int T, int H,
                       int F, int nwarps, float ns, void* stream) {
  if (F > kMaxF || nwarps < 1 || nwarps > 32) return (int)cudaErrorInvalidValue;
  size_t smem = gat_fwd_smem_bytes(S, F, nwarps);
  cudaError_t err = cudaFuncSetAttribute(
      gat_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && H > 0 && T > 0) {
    gat_fwd_kernel<<<B * H, nwarps * 32, smem, (cudaStream_t)stream>>>(
        xl, xr, adj, mask, we, att, out, alpha, S, T, H, F, ns);
  }
  return (int)cudaGetLastError();
}

extern "C" size_t gat_bwd_smem_bytes(int S, int T, int F, int nwarps) {
  const size_t Fp = (size_t)(F | 1);
  return sizeof(float) * (((size_t)S + 2 * (size_t)T) * Fp + (size_t)T * S +
                          (size_t)nwarps * gat_bwd_warp_floats(S, T, F));
}

extern "C" int gat_bwd(const float* xl, const float* xr, const float* adj,
                       const uint8_t* mask, const float* we, const float* att,
                       const float* alpha, const float* dout, float* dxl,
                       float* dxr, float* dadj_h, float* dwe_h, float* datt_h,
                       int B, int S, int T, int H, int F, int nwarps, float ns,
                       void* stream) {
  if (F > kMaxF || nwarps < 1 || nwarps > 32) return (int)cudaErrorInvalidValue;
  size_t smem = gat_bwd_smem_bytes(S, T, F, nwarps);
  cudaError_t err = cudaFuncSetAttribute(
      gat_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && H > 0) {
    gat_bwd_kernel<<<B * H, nwarps * 32, smem, (cudaStream_t)stream>>>(
        xl, xr, adj, mask, we, att, alpha, dout, dxl, dxr, dadj_h, dwe_h,
        datt_h, S, T, H, F, ns);
  }
  return (int)cudaGetLastError();
}
