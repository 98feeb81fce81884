// Pairwise discoverer edge scores, forward (CUDA, sm_90a).
//
// Replaces ctvae_tpu/ops/pairwise_flash.py::flash_pairwise (_fwd_kernel :64):
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

}  // namespace

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
