// GATv2 masked attention, forward (CUDA, sm_90a).
//
// Replaces ctvae_tpu/ops/gat_flash.py::flash_gat (_fwd_kernel :117). Per
// (b, t, h):
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
// memory, and the aggregation walks the shared slice once more. The alpha
// residual of the TPU kernel is a training output and is not written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxF = 128;  // features per head held in registers (4 / lane)

__global__ void gat_fwd_kernel(const float* __restrict__ xl,
                               const float* __restrict__ xr,
                               const float* __restrict__ adj,
                               const uint8_t* __restrict__ mask,
                               const float* __restrict__ we,
                               const float* __restrict__ att,
                               float* __restrict__ out,
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
          float v = xls[f] + xrv[j] + a * wev[j];
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

}  // namespace

extern "C" size_t gat_fwd_smem_bytes(int S, int F, int nwarps) {
  return sizeof(float) * ((size_t)S * F + 2 * (size_t)nwarps * S) +
         (size_t)nwarps * S;
}

extern "C" int gat_fwd(const float* xl, const float* xr, const float* adj,
                       const uint8_t* mask, const float* we, const float* att,
                       float* out, int B, int S, int T, int H, int F,
                       int nwarps, float ns, void* stream) {
  if (F > kMaxF || nwarps < 1 || nwarps > 32) return (int)cudaErrorInvalidValue;
  size_t smem = gat_fwd_smem_bytes(S, F, nwarps);
  cudaError_t err = cudaFuncSetAttribute(
      gat_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && H > 0 && T > 0) {
    gat_fwd_kernel<<<B * H, nwarps * 32, smem, (cudaStream_t)stream>>>(
        xl, xr, adj, mask, we, att, out, S, T, H, F, ns);
  }
  return (int)cudaGetLastError();
}
