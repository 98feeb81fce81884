// Pairwise discoverer edge scores, forward and backward (CUDA, sm_90a).
//
// Forward, replaces ctvae_tpu/ops/pairwise_flash.py::flash_pairwise
// (_fwd_kernel :64):
//
//   out[b,s,t] = sigmoid(sum_h leaky(xl[b,s,h] + xr[b,t,h] + b1[b,h], ns)
//                        * w2[b,h] + b2[b])
//
// with shared params (batch stride 0) or per-sample params (stride Hd / 1).
//
// Bound on the H100: the [B,S,T,Hd] pre-activation domain (192*64*64*800 =
// 6.3e8 elements in causal serving) costs ~6 f32 operations per element and
// is never stored, so the kernel is bound by f32 operations, not bytes
// (inputs and output are a few MB). The design walks the domain once from
// registers and shared memory: one block per (b, chunk of kTc targets) keeps
// xr[b,t] + b1 for its targets and w2 in shared memory; warps take source
// rows s, lanes take hidden units h (coalesced xl loads, conflict-free
// shared reads), each lane keeps kTc partial sums so one xl load serves kTc
// targets, and a warp shuffle finishes each sum.
//
// Backward, replaces _flash_vjp_bwd (_bwd_kernel :81). From the output
// residual, dz = dout * out * (1 - out), and per sample b:
//
//   g[s,t,h] = dz[s,t] * (pre >= 0 ? 1 : ns),  pre = xl[s,h] + xr[t,h] + b1[h]
//   dxl[s,h] = w2[h] sum_t g     dxr[t,h] = w2[h] sum_s g
//   dw2[h]   = sum_{s,t} pre g   db1[h]   = w2[h] sum_{s,t} g
//   db2      = sum_{s,t} dz
//
// (per-sample outputs; the caller sums them over b for a shared param).
// Bound: the same domain, re-walked once at ~7 f32 operations per element,
// never stored. Given dz, every output is separable in h, so one block per
// (b, 32 hidden units) walks all (s, t) for its units and writes finished
// outputs: no cross-block reduction, no atomics, and two runs agree bit for
// bit. Lanes own hidden units; 8 warps own the sources s = warp (mod 8) and
// walk the targets 8 at a time with the 8 xr values in registers; dz rows
// are broadcast shared reads (zero-padded to a multiple of 8 targets, so
// padding adds nothing); sum_t g collects per (s, lane) in shared memory,
// and the 8 warps' sum_s g meet in shared memory, one target per warp. pre
// is rounded in the plain version's order, (xl + xr) + b1, so the two agree
// on the slope where pre is within rounding of 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTc = 8;     // targets per block
constexpr int kWarps = 8;  // source rows in flight per block

__global__ void pairwise_fwd_kernel(const float* __restrict__ xl,
                                    const float* __restrict__ xr,
                                    const float* __restrict__ w2,
                                    const float* __restrict__ b1,
                                    const float* __restrict__ b2,
                                    float* __restrict__ out,
                                    int S, int T, int H,
                                    int64_t w2_stride, int64_t b1_stride,
                                    int64_t b2_stride, float ns) {
  extern __shared__ float smem[];
  float* xrb = smem;              // [kTc, H]: xr[b,t] + b1[b]
  float* w2s = xrb + kTc * H;     // [H]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTc;
  const float* w2b = w2 + b * w2_stride;
  const float* b1b = b1 + b * b1_stride;
  for (int i = threadIdx.x; i < kTc * H; i += blockDim.x) {
    int t = t0 + i / H, h = i % H;
    xrb[i] = t < T ? xr[((size_t)b * T + t) * H + h] + b1b[h] : 0.f;
  }
  for (int h = threadIdx.x; h < H; h += blockDim.x) w2s[h] = w2b[h];
  __syncthreads();

  const float bias2 = b2[b * b2_stride];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nt = min(kTc, T - t0);
  for (int s = warp; s < S; s += kWarps) {
    const float* xls = xl + ((size_t)b * S + s) * H;
    float acc[kTc];
#pragma unroll
    for (int t = 0; t < kTc; ++t) acc[t] = 0.f;
    for (int h = lane; h < H; h += 32) {
      float xv = xls[h];
      float wv = w2s[h];
#pragma unroll
      for (int t = 0; t < kTc; ++t) {
        float v = xv + xrb[t * H + h];
        acc[t] = fmaf(fmaxf(v, ns * v), wv, acc[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kTc; ++t) {
      for (int off = 16; off > 0; off >>= 1)
        acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], off);
    }
    if (lane < nt) {
      float z = 0.f;
#pragma unroll
      for (int t = 0; t < kTc; ++t)
        if (t == lane) z = acc[t];
      z += bias2;
      out[((size_t)b * S + s) * T + t0 + lane] = 1.f / (1.f + expf(-z));
    }
  }
}

constexpr int kBwdWarps = 8;  // source groups per block, and targets per step

__global__ void pairwise_bwd_kernel(const float* __restrict__ xl,
                                    const float* __restrict__ xr,
                                    const float* __restrict__ w2,
                                    const float* __restrict__ b1,
                                    const float* __restrict__ out,
                                    const float* __restrict__ dout,
                                    float* __restrict__ dxl,
                                    float* __restrict__ dxr,
                                    float* __restrict__ dw2,
                                    float* __restrict__ db1,
                                    float* __restrict__ db2,
                                    int S, int T, int H, int64_t w2_stride,
                                    int64_t b1_stride, float ns) {
  extern __shared__ float smem[];
  const int T8 = (T + kBwdWarps - 1) / kBwdWarps * kBwdWarps;
  float* dz_s = smem;                     // [S, T8]: dz, zero past T
  float* xl_s = dz_s + (size_t)S * T8;    // [S, 32]
  float* xr_s = xl_s + (size_t)S * 32;    // [T8, 32]
  float* gl_s = xr_s + (size_t)T8 * 32;   // [S, 32]: sum_t g
  float* red_s = gl_s + (size_t)S * 32;   // [kBwdWarps, kBwdWarps, 32]

  const int b = blockIdx.y;
  const int h0 = blockIdx.x * 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = h0 + lane;
  const bool hv = h < H;
  const float* b1b = b1 + b * b1_stride;
  const float w2h = hv ? w2[b * w2_stride + h] : 0.f;
  const float b1h = hv ? b1b[h] : 0.f;

  for (int i = threadIdx.x; i < S * T8; i += blockDim.x) {
    const int s = i / T8, t = i % T8;
    float v = 0.f;
    if (t < T) {
      const size_t o = ((size_t)b * S + s) * T + t;
      const float y = out[o];
      v = dout[o] * y * (1.f - y);
    }
    dz_s[i] = v;
  }
  for (int i = threadIdx.x; i < S * 32; i += blockDim.x) {
    const int s = i / 32, hh = h0 + i % 32;
    xl_s[i] = hh < H ? xl[((size_t)b * S + s) * H + hh] : 0.f;
    gl_s[i] = 0.f;
  }
  for (int i = threadIdx.x; i < T8 * 32; i += blockDim.x) {
    const int t = i / 32, hh = h0 + i % 32;
    xr_s[i] = (t < T && hh < H) ? xr[((size_t)b * T + t) * H + hh] : 0.f;
  }
  __syncthreads();

  float acc_w = 0.f, acc_g = 0.f;
  for (int t0 = 0; t0 < T8; t0 += kBwdWarps) {
    float xrv[kBwdWarps], acc_r[kBwdWarps];
#pragma unroll
    for (int j = 0; j < kBwdWarps; ++j) {
      xrv[j] = xr_s[(t0 + j) * 32 + lane];
      acc_r[j] = 0.f;
    }
    for (int s = warp; s < S; s += kBwdWarps) {
      const float xv = xl_s[s * 32 + lane];
      const float4* dzp =
          reinterpret_cast<const float4*>(dz_s + (size_t)s * T8 + t0);
      const float4 d0 = dzp[0], d1 = dzp[1];
      const float d[kBwdWarps] = {d0.x, d0.y, d0.z, d0.w,
                                  d1.x, d1.y, d1.z, d1.w};
      float gs = 0.f;
#pragma unroll
      for (int j = 0; j < kBwdWarps; ++j) {
        // (xl + xr) + b1, the plain version's order: the slope at pre ~ 0
        // then follows the same rounding
        const float pre = (xv + xrv[j]) + b1h;
        const float g = pre >= 0.f ? d[j] : ns * d[j];
        acc_r[j] += g;
        gs += g;
        acc_w = fmaf(pre, g, acc_w);
      }
      gl_s[s * 32 + lane] += gs;
      acc_g += gs;
    }
#pragma unroll
    for (int j = 0; j < kBwdWarps; ++j)
      red_s[(warp * kBwdWarps + j) * 32 + lane] = acc_r[j];
    __syncthreads();
    float v = 0.f;  // warp w finishes target t0 + w
    for (int w = 0; w < kBwdWarps; ++w)
      v += red_s[(w * kBwdWarps + warp) * 32 + lane];
    if (t0 + warp < T && hv) dxr[((size_t)b * T + t0 + warp) * H + h] = w2h * v;
    __syncthreads();
  }

  for (int s = warp; s < S; s += kBwdWarps)
    if (hv) dxl[((size_t)b * S + s) * H + h] = w2h * gl_s[s * 32 + lane];
  red_s[warp * 32 + lane] = acc_w;
  red_s[(kBwdWarps + warp) * 32 + lane] = acc_g;
  __syncthreads();
  if (warp == 0) {
    float w = 0.f, g = 0.f;
    for (int i = 0; i < kBwdWarps; ++i) {
      w += red_s[i * 32 + lane];
      g += red_s[(kBwdWarps + i) * 32 + lane];
    }
    if (hv) {
      dw2[(size_t)b * H + h] = w;
      db1[(size_t)b * H + h] = w2h * g;
    }
  } else if (warp == 1 && blockIdx.x == 0) {
    float z = 0.f;
    for (int i = lane; i < S * T8; i += 32) z += dz_s[i];
    for (int off = 16; off > 0; off >>= 1)
      z += __shfl_xor_sync(0xffffffffu, z, off);
    if (lane == 0) db2[b] = z;
  }
}

}  // namespace

extern "C" size_t pairwise_bwd_smem_bytes(int S, int T) {
  const size_t T8 = (size_t)(T + kBwdWarps - 1) / kBwdWarps * kBwdWarps;
  return sizeof(float) * ((size_t)S * T8 + 2 * (size_t)S * 32 + T8 * 32 +
                          (size_t)kBwdWarps * kBwdWarps * 32);
}

extern "C" int pairwise_bwd(const float* xl, const float* xr, const float* w2,
                            const float* b1, const float* out,
                            const float* dout, float* dxl, float* dxr,
                            float* dw2, float* db1, float* db2, int B, int S,
                            int T, int H, int64_t w2_stride, int64_t b1_stride,
                            float ns, void* stream) {
  size_t smem = pairwise_bwd_smem_bytes(S, T);
  cudaError_t err = cudaFuncSetAttribute(
      pairwise_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((H + 31) / 32, B);
  if (B > 0 && H > 0) {
    pairwise_bwd_kernel<<<grid, kBwdWarps * 32, smem, (cudaStream_t)stream>>>(
        xl, xr, w2, b1, out, dout, dxl, dxr, dw2, db1, db2, S, T, H, w2_stride,
        b1_stride, ns);
  }
  return (int)cudaGetLastError();
}

extern "C" size_t pairwise_fwd_smem_bytes(int H) {
  return sizeof(float) * (size_t)(kTc + 1) * H;
}

extern "C" int pairwise_fwd(const float* xl, const float* xr, const float* w2,
                            const float* b1, const float* b2, float* out,
                            int B, int S, int T, int H, int64_t w2_stride,
                            int64_t b1_stride, int64_t b2_stride, float ns,
                            void* stream) {
  size_t smem = pairwise_fwd_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      pairwise_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kTc - 1) / kTc, B);
  if (B > 0 && T > 0) {
    pairwise_fwd_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
        xl, xr, w2, b1, b2, out, S, T, H, w2_stride, b1_stride, b2_stride,
        ns);
  }
  return (int)cudaGetLastError();
}
