// Nearest-codebook search for the VQ quantizer (CUDA, sm_90a).
//
// Replaces ctvae_tpu/ops/vq.py::l2_argmin_pallas (_vq_kernel :49). For every
// latent row x_n it returns argmin_k (||e_k||^2 - 2 x_n . e_k), the first
// index on ties; ||x_n||^2 is constant per row and dropped, as on the TPU.
// All in f32 on the CUDA cores: no TF32, whose rounding would multiply the
// near-ties between two codes.
//
// Bound on the H100: at the serving shapes (N = 1024 rows, K = 64 codes,
// D = 128) the work is 2*N*K*D = 16.8 MFLOP and ~0.6 MB of traffic, well
// under a microsecond at peak, so the kernel is bound by latency: the
// staging of the codebook, dependent chains of sums, barriers and the
// launch. The design keeps every chain short and every load wide:
// - a block owns kRows = 8 rows, so N = 1024 gives 128 blocks, one per SM
//   of the card's 132;
// - it stages the codebook (kCodes = 64 codes a pass, at most kDc = 128
//   of D a chunk, so any K and D fit) and its rows with 16-byte cp.async
//   copies, a warp per row, all in flight before one wait, into rows of
//   ld4 float4 with ld4 = 4 (mod 8): the four D-lanes of two neighbouring
//   codes then read eight different 16-byte bank groups (conflict-free);
// - every warp takes 8 code norms, a lane one float4 of each, and one
//   transposing butterfly of 9 shuffles sums the 8;
// - a thread holds a 2 x 4 register tile of (row, code) sums over a
//   quarter of D (lanes = 8 code groups x 4 D-quarters): 8 independent
//   chains of D / 4, 32 fmas per 6 float4 loads; a 6-shuffle transposing
//   butterfly sums the quarters, leaving a lane two scores of one row;
// - the argmin runs over the warp's lanes of a row (shuffles), then over
//   the block's two code halves and the passes in code order in shared
//   memory, the lower index kept on a tie.
// Each sum is taken in a fixed order (no atomics): two runs agree bit for
// bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;    // rows of a block: 4 row groups x 2 rows
constexpr int kCodes = 64;  // codes of a pass: 2 halves x 8 groups x 4
constexpr int kDc = 128;    // floats of D staged per chunk
static_assert(kThreads == 32 * 8, "8 warps: 4 row groups x 2 code halves");

__device__ __forceinline__ void copy16_async(float4* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
#endif
}

__device__ __forceinline__ void copy_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// float4 per staged row: at least n, and 4 (mod 8)
__host__ __device__ inline int row_float4s(int n) {
  return n + ((12 - n % 8) % 8);
}

// rows [0, n) of the staged tile, a warp per row: row r of the tile is row
// src_row0 + r of a [rows, D] array (zeros past its last row, and past D),
// floats [d0, d0 + 4 * dc4) of it
__device__ __forceinline__ void stage_rows(float4* dst, int ld4, int n,
                                           const float* src, int src_row0,
                                           int rows, int D, int d0, int dc4,
                                           bool vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += kThreads / 32) {
    const int sr = src_row0 + r;
    float4* d = dst + (size_t)r * ld4;
    if (lane < dc4) {
      const float* s = src + (size_t)sr * D + d0 + 4 * lane;
      if (sr >= rows) {
        d[lane] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (vec) {
        copy16_async(d + lane, s);
      } else {
        const int e = d0 + 4 * lane;
        d[lane] = make_float4(e < D ? s[0] : 0.f, e + 1 < D ? s[1] : 0.f,
                              e + 2 < D ? s[2] : 0.f, e + 3 < D ? s[3] : 0.f);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
vq_argmin_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                 int64_t* __restrict__ out, int n, int k, int d, int ld4,
                 bool vec) {
  extern __shared__ float4 smem4[];
  float4* cb_s = smem4;                             // [kCodes, ld4]
  float4* x_s = cb_s + (size_t)kCodes * ld4;        // [kRows, ld4]
  float* norm_s = reinterpret_cast<float*>(x_s + (size_t)kRows * ld4);
  float* bv_s = norm_s + kCodes;                    // [2, kRows]: best score
  int* bi_s = reinterpret_cast<int*>(bv_s + 2 * kRows);  // [2, kRows]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = warp & 1, rg = warp >> 1;   // code half, row group
  const int ds = lane & 3, cg = lane >> 2;     // D-quarter, code group
  const int r0 = blockIdx.x * kRows;
  const int dq = (d + 3) & ~3;
  float best = INFINITY;  // thread r < kRows: row r0 + r so far
  int best_i = 0;         // stays in range even for a NaN row

  for (int c0 = 0; c0 < k; c0 += kCodes) {
    if (threadIdx.x < kCodes) norm_s[threadIdx.x] = 0.f;
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < dq; d0 += kDc) {
      const int dc4 = min(kDc, dq - d0) / 4;
      if (d0 > 0) __syncthreads();  // the last chunk's reads are done
      stage_rows(cb_s, ld4, kCodes, cb, c0, k, d, d0, dc4, vec);
      stage_rows(x_s, ld4, kRows, x, r0, n, d, d0, dc4, vec);
      copy_async_wait_all();
      __syncthreads();

      // norms: warp w takes codes 8w .. 8w + 7, lane q their float4 q;
      // after the butterfly lane l holds code (l >> 2) & 7's sum
      {
        float p[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          p[u] = 0.f;
          if (lane < dc4) {
            const float4 e = cb_s[(size_t)(8 * warp + u) * ld4 + lane];
            p[u] = fmaf(e.w, e.w, fmaf(e.z, e.z, fmaf(e.y, e.y, e.x * e.x)));
          }
        }
#pragma unroll
        for (int w = 4, off = 16; w >= 1; w /= 2, off /= 2) {
          const bool hi = lane & off;
#pragma unroll
          for (int u = 0; u < w; ++u) {
            const float mine = hi ? p[u + w] : p[u];
            const float other = hi ? p[u] : p[u + w];
            p[u] = mine + __shfl_xor_sync(0xffffffffu, other, off);
          }
        }
        p[0] += __shfl_xor_sync(0xffffffffu, p[0], 2);
        p[0] += __shfl_xor_sync(0xffffffffu, p[0], 1);
        if ((lane & 3) == 0) norm_s[8 * warp + (lane >> 2)] += p[0];
      }

      // the 2 x 4 tile: rows 2 rg + i, codes 32 half + cg + 8 j, float4
      // q = ds, ds + 4, ...
      const float4* xr = x_s + (size_t)(2 * rg) * ld4;
      const float4* er = cb_s + (size_t)(32 * half + cg) * ld4;
#pragma unroll 2
      for (int q = ds; q < dc4; q += 4) {
        float4 xv[2], ev[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) xv[i] = xr[(size_t)i * ld4 + q];
#pragma unroll
        for (int j = 0; j < 4; ++j) ev[j] = er[(size_t)(8 * j) * ld4 + q];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float a = acc[i][j];
            a = fmaf(xv[i].x, ev[j].x, a);
            a = fmaf(xv[i].y, ev[j].y, a);
            a = fmaf(xv[i].z, ev[j].z, a);
            acc[i][j] = fmaf(xv[i].w, ev[j].w, a);
          }
      }
    }
    __syncthreads();  // every norm of the pass is in norm_s

    // sum the D-quarters (lane bits 1 and 0): lane (b1, b0) ends with row
    // 2 rg + b1 and codes j = 2 b0, 2 b0 + 1
    float p[4], s2[2];
    {
      const bool hi = lane & 2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float mine = hi ? acc[1][j] : acc[0][j];
        const float other = hi ? acc[0][j] : acc[1][j];
        p[j] = mine + __shfl_xor_sync(0xffffffffu, other, 2);
      }
    }
    {
      const bool hi = lane & 1;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float mine = hi ? p[u + 2] : p[u];
        const float other = hi ? p[u] : p[u + 2];
        s2[u] = mine + __shfl_xor_sync(0xffffffffu, other, 1);
      }
    }
    float bv = INFINITY;
    int bi = INT32_MAX;
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // codes in increasing order
      const int c = 32 * half + cg + 8 * (2 * (lane & 1) + u);
      const float score = norm_s[c] - 2.f * s2[u];
      if (c0 + c < k && score < bv) {  // strict: the first index on ties
        bv = score;
        bi = c0 + c;
      }
    }
    // over the lanes of the row (every lane bit but bit 1)
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      if (off == 2) continue;
      const float ob = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ob < bv || (ob == bv && oi < bi)) {
        bv = ob;
        bi = oi;
      }
    }
    if (lane == 0 || lane == 2) {
      const int r = 2 * rg + (lane >> 1);
      bv_s[half * kRows + r] = bv;
      bi_s[half * kRows + r] = bi;
    }
    __syncthreads();
    if (threadIdx.x < kRows) {  // the halves, then the passes, in order
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = bv_s[h * kRows + threadIdx.x];
        if (v < best) {
          best = v;
          best_i = bi_s[h * kRows + threadIdx.x];
        }
      }
    }
  }
  if (threadIdx.x < kRows && r0 + (int)threadIdx.x < n)
    out[r0 + threadIdx.x] = best_i;
}

}  // namespace

// float4 per staged row of a chunk at this D
static int vq_ld4(int d) {
  const int dq = (d + 3) & ~3;
  return row_float4s((dq < kDc ? dq : kDc) / 4);
}

extern "C" size_t vq_argmin_smem_bytes(int k, int d) {
  (void)k;  // codes are staged kCodes at a time
  return sizeof(float4) * (size_t)(kCodes + kRows) * vq_ld4(d) +
         sizeof(float) * (kCodes + 2 * kRows) + sizeof(int) * 2 * kRows;
}

extern "C" int vq_argmin(const float* x, const float* cb, int64_t* out,
                         int n, int k, int d, void* stream) {
  const size_t smem = vq_argmin_smem_bytes(k, d);
  const bool vec = (d & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(cb)) & 15) == 0;
  const int blocks = (n + kRows - 1) / kRows;
  if (blocks > 0) {
    vq_argmin_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        x, cb, out, n, k, d, vq_ld4(d), vec);
  }
  return (int)cudaGetLastError();
}

// resident blocks of vq_argmin_kernel per SM at this D, and the kernel's
// registers and local (spill) bytes per thread (-1 on an error)
extern "C" int vq_argmin_blocks_per_sm(int k, int d, int* regs,
                                       int* local_bytes) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, vq_argmin_kernel) != cudaSuccess)
    return -1;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, vq_argmin_kernel, kThreads, vq_argmin_smem_bytes(k, d)) !=
      cudaSuccess)
    return -1;
  return n;
}
