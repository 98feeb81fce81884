// Nearest-codebook search for the VQ quantizer (CUDA, sm_90a).
//
// Replaces ctvae_tpu/ops/vq.py::l2_argmin_pallas (_vq_kernel :49). For every
// latent row x_n it returns argmin_k (||e_k||^2 - 2 x_n . e_k), the first
// index on ties; ||x_n||^2 is constant per row and dropped, as on the TPU.
//
// Bound on the H100: at the serving shapes (N = 1024 rows, K = 64 codes,
// D = 128) the work is 2*N*K*D = 16.8 MFLOP and ~0.6 MB of traffic, well
// under a microsecond at peak, so the kernel is launch-bound. The design
// keeps the whole codebook (32 KB) and its norms in shared memory, one warp
// per row: lanes own codes, each lane walks its codes' dot products over D
// with the row broadcast from shared memory, and a warp shuffle reduces the
// (distance, index) pairs. The shared codebook rows are padded to D + 1
// floats so the 32 lanes, each reading a different code at the same column,
// hit 32 different banks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__global__ void vq_argmin_kernel(const float* __restrict__ x,
                                 const float* __restrict__ cb,
                                 int64_t* __restrict__ out,
                                 int n, int k, int d) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* cb_s = smem;                       // [k, d + 1]
  float* norm_s = cb_s + (size_t)k * ld;    // [k]
  float* x_s = norm_s + k;                  // [kWarps, d]

  for (int i = threadIdx.x; i < k * d; i += blockDim.x) {
    cb_s[(i / d) * ld + (i % d)] = cb[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) {
      float v = cb_s[c * ld + j];
      s = fmaf(v, v, s);
    }
    norm_s[c] = s;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* xw = x_s + warp * d;
  for (int row = blockIdx.x * kWarps + warp; row < n;
       row += gridDim.x * kWarps) {
    for (int j = lane; j < d; j += 32) xw[j] = x[(size_t)row * d + j];
    __syncwarp();
    float best = INFINITY;
    int best_i = 0;  // stays in range even for a NaN row
    for (int c = lane; c < k; c += 32) {
      const float* e = cb_s + c * ld;
      float dot = 0.f;
      for (int j = 0; j < d; ++j) dot = fmaf(xw[j], e[j], dot);
      float score = norm_s[c] - 2.f * dot;
      if (score < best) {  // strict: keeps the first index on ties
        best = score;
        best_i = c;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      float ob = __shfl_xor_sync(0xffffffffu, best, off);
      int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
      if (ob < best || (ob == best && oi < best_i)) {
        best = ob;
        best_i = oi;
      }
    }
    if (lane == 0) out[row] = best_i;
    __syncwarp();
  }
}

}  // namespace

extern "C" size_t vq_argmin_smem_bytes(int k, int d) {
  return sizeof(float) * ((size_t)k * (d + 1) + k + (size_t)kWarps * d);
}

extern "C" int vq_argmin(const float* x, const float* cb, int64_t* out,
                         int n, int k, int d, void* stream) {
  size_t smem = vq_argmin_smem_bytes(k, d);
  cudaError_t err = cudaFuncSetAttribute(
      vq_argmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (n + kWarps - 1) / kWarps;
  if (blocks > 0) {
    vq_argmin_kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
        x, cb, out, n, k, d);
  }
  return (int)cudaGetLastError();
}
