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
// What bounds it: the [B,S,T,Hd] pre-activation domain (192*64*64*800 =
// 6.3e8 elements in causal serving) is never stored, and its inputs and
// output are a few MB, so the kernel is bound by the f32 instructions it
// issues per element and the shared-memory loads that feed them, not by
// bytes. The tensor cores do not apply: |a + b| (or relu(a + b)) inside
// the sum is not a product of two matrices.
//
// What the design does about it. The leaky split makes the ns part
// linear and so separable: leaky(p) = (1 + ns) / 2 p + (1 - ns) / 2 |p|,
//
//   z = (1 + ns) / 2 (Ls + Rt) + (1 - ns) / 2 sum_h |xl + xr'| w2 + b2,
//   Ls = sum_h xl[s,h] w2[h],  Rt = sum_h xr'[t,h] w2[h],  xr' = xr + b1,
//
// O((S + T) Hd) per sample, which leaves an add and an fma (|x| is an
// operand modifier) per element; relu(p) = (p + |p|) / 2 in place of the
// max saves a third instruction. A block owns a 64 x 64 tile of (source,
// target) pairs of one sample, each thread a 4 x 4 register tile of them
// whose sums stay in registers; the block walks its hidden units in
// chunks of kKc, staged row-major (xl rows, xr rows, w2, b1) with
// cp.async into one of two buffers while the other is walked, and turns
// xr into xr' there while it takes the linear sums. Per four hidden units
// a thread reads four float4 of xl, four of xr' and one of w2 (no
// shared-memory load per element; rows of stride kKc + 4 keep the reads
// conflict-free) for 64 elements. No shuffle: each thread holds whole
// sums. To fill the card at B = 16 the hidden units of a tile are split
// over the C blocks of a thread-block cluster (C from the batch and the
// SM count: the smallest that gives every SM two blocks, at most 16);
// each block pushes its partial sums into the shared memory of the block
// that owns those pairs and its linear sums to every block, and after one
// cluster barrier each block sums what it got in rank order and applies
// the linear part, b2 and the sigmoid once per pair. No atomics: two runs
// agree bit for bit. A block holds 63.5 KB of shared memory at every
// shape, and three share an SM.
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
// Bound: the same domain, re-walked once and never stored, but only where
// dz is non-zero: the intervention discoverers' upstream gradient is zero
// on every source row their mask leaves out (on all of them in a base
// step). Given dz, every output is separable in h, so a block owns one
// sample and chunks of kCols = 64 hidden units (two per lane) and writes
// finished outputs: no cross-block reduction, no atomics, two runs agree
// bit for bit. A block stages out, dout and its chunk's xl / xr with
// cp.async, turns out / dout into dz in place (one warp per row; a ballot
// flags the row's 8-target segments with a non-zero dz) and lists the live
// rows. The warps take the live rows in turn and walk the targets 8 at a
// time, xr in registers and the dz row a broadcast shared read, skipping
// dead segments (a sample without a live row walks none). Per element:
// one add, the slope test, a select and the two sums. The test is xl + xr
// >= -b1, which holds exactly when (xl + xr) + b1 >= 0, the plain
// version's rounding, for finite operands without flush to zero (a float
// sum is zero only when it is exact), so the two take the same slope where
// pre is within rounding of 0. dw2 comes from the separable sums
// sum_s xl sum_t g + sum_t xr sum_s g + b1 sum g, not from an fma per
// element. sum_t g collects per (s, lane) in shared memory, and the 8
// warps' sum_s g meet there once a step, one target per warp. At the
// headline shapes (S = T = 64) a block holds 96.8 KB of shared memory, so
// two share an SM. Where out and dout staged side by side do not fit a
// block (above S = T = 120), a second instance of the kernel stages out
// alone and reads each dout row straight from device memory as it forms
// dz (coalesced, a warp per row; the same dz bit for bit): 182.9 KB at
// S = T = 128, and up to S = T = 152 in one block. When a batch gives more
// blocks than keep the card busy for kRounds rounds, a block walks several
// chunks of its sample and fills dz once.

// Element types (elem.cuh). Each entry point has a float32 and a bfloat16
// instantiation (pairwise_fwd_bf16, pairwise_bwd_bf16), as JAX's kernels
// load the compute dtype and upcast at once: at bfloat16 xl, xr, w2, b1,
// b2, out and dout are read as bfloat16 and the scores, dxl and dxr
// written as bfloat16 (rounded once), while dw2, db1 and db2 stay float32
// sums that the caller casts once after summing them over the batch for a
// shared param. Registers, sums and the shared tiles are float in both, so
// every layout's shared memory and blocks per SM are float32's; a bfloat16
// tile is staged through registers (8-byte loads of 4 values, widened)
// where float32 takes cp.async, so the forward's next chunk is no longer
// copied behind the walk of this one. The operations are float32's; the
// bytes, half of them at bfloat16, bound neither kernel.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr int kBwdWarps = 8;  // source groups per block, and targets per step
constexpr int kU = 2;         // hidden units per lane
constexpr int kCols = 32 * kU;  // hidden units per chunk
constexpr int kRed = kBwdWarps * kBwdWarps * kCols;  // reduction floats
// chunks per block: as many as leave blocks for this many rounds of the
// blocks the card holds at once
constexpr int kRounds = 8;

// rows [0, n) of a tile (row r at src + r * ld, its first `valid`
// elements) into dst rows of `width` floats, the rest of each row and rows
// [n, npad) zero: 4 elements a copy when `vec` (copy4_to_smem), else one
// at a time
template <typename E>
__device__ __forceinline__ void stage_tile(float* dst, int width,
                                           const E* src, size_t ld,
                                           int valid, int n, int npad,
                                           bool vec) {
  if (vec) {
    const int q = width / 4;
    for (int i = threadIdx.x; i < npad * q; i += blockDim.x) {
      const int r = i / q, c = 4 * (i % q);
      float* d = dst + (size_t)r * width + c;
      if (r < n && c < valid)
        copy4_to_smem(d, src + r * ld + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < npad * width; i += blockDim.x) {
      const int r = i / width, c = i % width;
      dst[i] = (r < n && c < valid) ? ldf(src[r * ld + c]) : 0.f;
    }
  }
}

// kStageDout: dout is staged beside out (the headline layout); else each
// dout row is read from device memory where dz is formed. E: the element
// type of the inputs, dxl and dxr; dw2, db1 and db2 are float32 sums
template <bool kStageDout, typename E>
__global__ void pairwise_bwd_kernel(const E* __restrict__ xl,
                                    const E* __restrict__ xr,
                                    const E* __restrict__ w2,
                                    const E* __restrict__ b1,
                                    const E* __restrict__ out,
                                    const E* __restrict__ dout,
                                    E* __restrict__ dxl,
                                    E* __restrict__ dxr,
                                    float* __restrict__ dw2,
                                    float* __restrict__ db1,
                                    float* __restrict__ db2,
                                    int S, int T, int H, int64_t w2_stride,
                                    int64_t b1_stride, float ns) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T8 = (T + kBwdWarps - 1) / kBwdWarps * kBwdWarps;
  const int nseg = T8 / kBwdWarps;
  float* p = smem;
  float* dz_s = p;  p += (size_t)S * T8;        // [S, T8]: dz, zero past T
  float* do_s = p;                              // [S, T8]: dout (staged)
  if (kStageDout) p += (size_t)S * T8;
  float* xl_s = p;  p += (size_t)S * kCols;     // [S, kCols]
  float* xr_s = p;  p += (size_t)T8 * kCols;    // [T8, kCols]
  float* gl_s = p;  p += (size_t)S * kCols;     // [S, kCols]: sum_t g
  float* red_s = p; p += kRed;                  // [8, 8, kCols]
  int* rows_s = reinterpret_cast<int*>(p);      // [S + 1]: live rows, count
  uint8_t* live_s = reinterpret_cast<uint8_t*>(rows_s + S + 1);  // [S]
  uint8_t* seg_s = live_s + S;                  // [S, nseg]

  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nch = (H + kCols - 1) / kCols;
  const E* b1b = b1 + b * b1_stride;
  const E* w2b = w2 + b * w2_stride;
  const E* xlb = xl + (size_t)b * S * H;
  const E* xrb = xr + (size_t)b * T * H;
  const size_t ob = (size_t)b * S * T;
  const bool vx = (H & 3) == 0 && vec4_aligned(xl) && vec4_aligned(xr);
  const bool vo = (T & 3) == 0 && vec4_aligned(out) && vec4_aligned(dout);

  // out into the dz tile, dout beside it, the first chunk's xl and xr
  stage_tile(dz_s, T8, out + ob, T, T, S, S, vo);
  if (kStageDout) stage_tile(do_s, T8, dout + ob, T, T, S, S, vo);
  {
    const int h0 = blockIdx.x * kCols, hvalid = min(kCols, H - h0);
    stage_tile(xl_s, kCols, xlb + h0, H, hvalid, S, S, vx);
    stage_tile(xr_s, kCols, xrb + h0, H, hvalid, T, T8, vx);
  }
  copy_async_wait_all();
  __syncthreads();
  // dz = dout out (1 - out) in place, one warp per row; a ballot flags
  // the row's 8-target segments with a non-zero dz
  for (int s = warp; s < S; s += kBwdWarps) {
    unsigned any = 0;
    // a row's dout from device memory: kLd loads in flight a lane
    constexpr int kLd = kStageDout ? 1 : 4;
    for (int c00 = 0; c00 < T8; c00 += 32 * kLd) {
      float dv[kLd];
      if (!kStageDout) {
#pragma unroll
        for (int u = 0; u < kLd; ++u) {
          const int t = c00 + 32 * u + lane;
          dv[u] = t < T ? ldf(dout[ob + (size_t)s * T + t]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kLd; ++u) {
        const int c0 = c00 + 32 * u;
        if (c0 >= T8) break;  // warp-uniform
        const int t = c0 + lane;
        const size_t i = (size_t)s * T8 + t;
        float v = 0.f;
        if (t < T8) {
          const float y = dz_s[i];
          v = (kStageDout ? do_s[i] : dv[u]) * y * (1.f - y);
          dz_s[i] = v;
        }
        const unsigned live = __ballot_sync(0xffffffffu, v != 0.f);
        if (lane < 4 && c0 / 8 + lane < nseg)
          seg_s[s * nseg + c0 / 8 + lane] = (live >> (8 * lane) & 0xffu) != 0;
        any |= live;
      }
    }
    if (lane == 0) live_s[s] = any != 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S * kCols; i += blockDim.x) gl_s[i] = 0.f;
  if (warp == 0) {  // the live rows, in order
    int n = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const bool live = s < S && live_s[s];
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) rows_s[n + __popc(m & ((1u << lane) - 1u))] = s;
      n += __popc(m);
    }
    if (lane == 0) rows_s[S] = n;
  }
  __syncthreads();
  const int nlive = rows_s[S];

  for (int c = blockIdx.x; c < nch; c += gridDim.x) {
    const int h0 = c * kCols, hvalid = min(kCols, H - h0);
    if (c != blockIdx.x && nlive > 0) {  // the next chunk's xl and xr
      __syncthreads();
      stage_tile(xl_s, kCols, xlb + h0, H, hvalid, S, S, vx);
      stage_tile(xr_s, kCols, xrb + h0, H, hvalid, T, T8, vx);
      for (int i = threadIdx.x; i < S * kCols; i += blockDim.x) gl_s[i] = 0.f;
      copy_async_wait_all();
      __syncthreads();
    }
    float w2h[kU], b1h[kU], nb1[kU], acc_g[kU], acc_w[kU];
    bool hv[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int h = h0 + u * 32 + lane;
      hv[u] = h < H;
      w2h[u] = hv[u] ? ldf(w2b[h]) : 0.f;
      b1h[u] = hv[u] ? ldf(b1b[h]) : 0.f;
      nb1[u] = -b1h[u];
      acc_g[u] = acc_w[u] = 0.f;
    }
    for (int seg = 0; seg < nseg; ++seg) {
      const int t0 = seg * kBwdWarps;
      float xrv[kBwdWarps][kU], acc_r[kBwdWarps][kU];
#pragma unroll
      for (int j = 0; j < kBwdWarps; ++j)
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          xrv[j][u] = xr_s[(t0 + j) * kCols + u * 32 + lane];
          acc_r[j][u] = 0.f;
        }
#pragma unroll 2
      for (int k = warp; k < nlive; k += kBwdWarps) {
        const int s = rows_s[k];
        if (!seg_s[s * nseg + seg]) continue;  // dz is zero there
        float xv[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) xv[u] = xl_s[s * kCols + u * 32 + lane];
        const float4* dzp =
            reinterpret_cast<const float4*>(dz_s + (size_t)s * T8 + t0);
        const float4 d0 = dzp[0], d1 = dzp[1];
        const float d[kBwdWarps] = {d0.x, d0.y, d0.z, d0.w,
                                    d1.x, d1.y, d1.z, d1.w};
        float nd[kBwdWarps];
#pragma unroll
        for (int j = 0; j < kBwdWarps; ++j) nd[j] = ns * d[j];
        float gs[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) gs[u] = 0.f;
#pragma unroll
        for (int j = 0; j < kBwdWarps; ++j)
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            // xl + xr >= -b1 exactly when (xl + xr) + b1 >= 0
            const float g = xv[u] + xrv[j][u] >= nb1[u] ? d[j] : nd[j];
            acc_r[j][u] += g;
            gs[u] += g;
          }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          gl_s[s * kCols + u * 32 + lane] += gs[u];
          acc_g[u] += gs[u];
        }
      }
#pragma unroll
      for (int j = 0; j < kBwdWarps; ++j)
#pragma unroll
        for (int u = 0; u < kU; ++u)
          red_s[(warp * kBwdWarps + j) * kCols + u * 32 + lane] = acc_r[j][u];
      __syncthreads();
      const int t = t0 + warp;  // warp w finishes target t0 + w
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float v = 0.f;
        for (int w = 0; w < kBwdWarps; ++w)
          v += red_s[(w * kBwdWarps + warp) * kCols + u * 32 + lane];
        if (t < T && hv[u])
          dxr[((size_t)b * T + t) * H + h0 + u * 32 + lane] =
              stf<E>(w2h[u] * v);
        acc_w[u] = fmaf(xr_s[t * kCols + u * 32 + lane], v, acc_w[u]);
      }
      __syncthreads();
    }

    for (int s = warp; s < S; s += kBwdWarps)
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float gl = gl_s[s * kCols + u * 32 + lane];
        if (hv[u])
          dxl[((size_t)b * S + s) * H + h0 + u * 32 + lane] =
              stf<E>(w2h[u] * gl);
        acc_w[u] = fmaf(xl_s[s * kCols + u * 32 + lane], gl, acc_w[u]);
      }
    // dw2 = sum pre g = sum_s xl sum_t g + sum_t xr sum_s g + b1 sum g
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      red_s[warp * kCols + u * 32 + lane] = acc_w[u];
      red_s[(kBwdWarps + warp) * kCols + u * 32 + lane] = acc_g[u];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float w = 0.f, g = 0.f;
        for (int i = 0; i < kBwdWarps; ++i) {
          w += red_s[i * kCols + u * 32 + lane];
          g += red_s[(kBwdWarps + i) * kCols + u * 32 + lane];
        }
        if (hv[u]) {
          dw2[(size_t)b * H + h0 + u * 32 + lane] = fmaf(b1h[u], g, w);
          db1[(size_t)b * H + h0 + u * 32 + lane] = w2h[u] * g;
        }
      }
    }
  }
  if (warp == 1 && blockIdx.x == 0) {
    float z = 0.f;
    for (int i = lane; i < S * T8; i += 32) z += dz_s[i];
    for (int off = 16; off > 0; off >>= 1)
      z += __shfl_xor_sync(0xffffffffu, z, off);
    if (lane == 0) db2[b] = z;
  }
}

}  // namespace

// bytes of shared memory a block may opt in to on the current card
// (232,448 on the H100); the wrappers refuse a launch against the same
// attribute (ops/common.py: smem_limit)
static size_t smem_limit() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)bytes;
}

// the backward's shared memory with dout staged beside out, or without
static size_t bwd_smem_bytes(int S, int T, bool stage_dout) {
  const size_t T8 = (size_t)(T + kBwdWarps - 1) / kBwdWarps * kBwdWarps;
  const size_t nseg = T8 / kBwdWarps;
  const size_t f = (stage_dout ? 2 : 1) * (size_t)S * T8 +
                   (2 * (size_t)S + T8) * kCols + kRed;
  return sizeof(float) * f + sizeof(int) * ((size_t)S + 1) +
         (size_t)S * (1 + nseg);
}

// dout is staged wherever that layout fits a block
static bool bwd_stage_dout(int S, int T) {
  return bwd_smem_bytes(S, T, true) <= smem_limit();
}

template <typename E>
using BwdKernel = void (*)(const E*, const E*, const E*, const E*, const E*,
                           const E*, E*, E*, float*, float*, float*, int, int,
                           int, int64_t, int64_t, float);

template <typename E>
static BwdKernel<E> bwd_kernel(int S, int T) {
  return bwd_stage_dout(S, T) ? pairwise_bwd_kernel<true, E>
                              : pairwise_bwd_kernel<false, E>;
}

// the shared memory of the layout a launch at these shapes takes
extern "C" size_t pairwise_bwd_smem_bytes(int S, int T) {
  return bwd_smem_bytes(S, T, bwd_stage_dout(S, T));
}

// what the backward's launch gets on this card at these shapes: registers
// and local (spill) bytes per thread, and resident blocks per SM (-1 on
// an error)
extern "C" int pairwise_bwd_blocks_per_sm(int S, int T, int* regs,
                                          int* local_bytes) {
  const size_t smem = pairwise_bwd_smem_bytes(S, T);
  const BwdKernel<float> kern = bwd_kernel<float>(S, T);
  cudaFuncAttributes attr;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kern) != cudaSuccess)
    return -1;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kern, kBwdWarps * 32, smem) != cudaSuccess)
    return -1;
  return n;
}

// the SMs of the current device and the backward's resident blocks per SM
// for this kernel at this shared-memory size, queried once per (device,
// kernel, size)
template <typename E>
static cudaError_t bwd_slots(BwdKernel<E> kern, size_t smem, int* nsm,
                             int* per_sm) {
  static thread_local int dev_c = -1, nsm_c = 0, per_sm_c = 0;
  static thread_local size_t smem_c = 0;
  static thread_local BwdKernel<E> kern_c = nullptr;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != dev_c || smem != smem_c || kern != kern_c) {
    dev_c = -1;
    if ((err = cudaDeviceGetAttribute(&nsm_c, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm_c, kern, kBwdWarps * 32, smem)) != cudaSuccess)
      return err;
    dev_c = dev;
    smem_c = smem;
    kern_c = kern;
  }
  *nsm = nsm_c;
  *per_sm = per_sm_c;
  return cudaSuccess;
}

template <typename E>
static int launch_bwd(const E* xl, const E* xr, const E* w2, const E* b1,
                      const E* out, const E* dout, E* dxl, E* dxr, float* dw2,
                      float* db1, float* db2, int B, int S, int T, int H,
                      int64_t w2_stride, int64_t b1_stride, float ns,
                      void* stream) {
  const size_t smem = pairwise_bwd_smem_bytes(S, T);
  const BwdKernel<E> kern = bwd_kernel<E>(S, T);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  // blocks per sample: enough for kRounds rounds of the blocks the card
  // holds at once; block x walks the chunks x, x + nb, ... of its sample
  int nsm = 0, per_sm = 0;
  if ((err = bwd_slots(kern, smem, &nsm, &per_sm)) != cudaSuccess)
    return (int)err;
  const int nch = (H + kCols - 1) / kCols;
  const long want = ((long)kRounds * nsm * per_sm + B - 1) / B;
  const int nb = (int)(want < 1 ? 1 : want < nch ? want : nch);
  const int per = (nch + nb - 1) / nb;  // chunks per block, evened out
  dim3 grid((nch + per - 1) / per, B);
  kern<<<grid, kBwdWarps * 32, smem, (cudaStream_t)stream>>>(
      xl, xr, w2, b1, out, dout, dxl, dxr, dw2, db1, db2, S, T, H, w2_stride,
      b1_stride, ns);
  return (int)cudaGetLastError();
}

extern "C" int pairwise_bwd(const float* xl, const float* xr, const float* w2,
                            const float* b1, const float* out,
                            const float* dout, float* dxl, float* dxr,
                            float* dw2, float* db1, float* db2, int B, int S,
                            int T, int H, int64_t w2_stride, int64_t b1_stride,
                            float ns, void* stream) {
  return launch_bwd(xl, xr, w2, b1, out, dout, dxl, dxr, dw2, db1, db2, B, S,
                    T, H, w2_stride, b1_stride, ns, stream);
}

// the bfloat16 instantiation: bfloat16 inputs, dxl and dxr; float32 dw2,
// db1 and db2 (per sample, cast by the caller)
extern "C" int pairwise_bwd_bf16(const bf16* xl, const bf16* xr,
                                 const bf16* w2, const bf16* b1,
                                 const bf16* out, const bf16* dout, bf16* dxl,
                                 bf16* dxr, float* dw2, float* db1,
                                 float* db2, int B, int S, int T, int H,
                                 int64_t w2_stride, int64_t b1_stride,
                                 float ns, void* stream) {
  return launch_bwd(xl, xr, w2, b1, out, dout, dxl, dxr, dw2, db1, db2, B, S,
                    T, H, w2_stride, b1_stride, ns, stream);
}

namespace {

namespace cg = cooperative_groups;

constexpr int kTile = 64;         // sources and targets of a block's tile
constexpr int kSi = 4;            // sources per thread (targets: 4)
constexpr int kSy = kTile / kSi;  // rows of threads, 16 columns each
constexpr int kFwdThreads = 16 * kSy;
constexpr int kKc = 32;           // hidden units per staged chunk
constexpr int kLd = kKc + 4;      // row stride of a staged tile
// threads per staged row in the linear sums, and the columns each takes
constexpr int kHalves = kFwdThreads / (2 * kTile);
constexpr int kHc = kKc / kHalves;
constexpr int kMaxCluster = 16;   // blocks splitting a tile's hidden units
// floats of one chunk buffer: the xl and xr' tiles, w2 and b1
constexpr int kBuf = 2 * kTile * kLd + 2 * kKc;
// two buffers, the partial linear sums [kHalves][2 * kTile], their totals
// [2 * kTile], and what the cluster's blocks push here: their sums of this
// block's pairs [kTile * kTile] and their linear sums [C][2 * kTile]; the
// block's own pair sums reuse the buffers at the end
constexpr int kFwdSmem = 2 * kBuf + (kHalves + 1) * 2 * kTile +
                         kTile * kTile + kMaxCluster * 2 * kTile;
static_assert(kTile * kTile <= 2 * kBuf, "pair sums must fit the buffers");

// the two halves of a cluster barrier: a block may write another's shared
// memory only once that block has arrived (it has started)
__device__ __forceinline__ void cluster_arrive_relaxed() {
#ifdef __CUDA_ARCH__
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void cluster_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#endif
}

// rows [0, n) of a chunk (row r at src + r * ld, its first `valid`
// elements) into dst rows of stride kLd: kKc floats each, past `valid`
// zero, and rows [n, nrows) zero (the pad columns past kKc are never read)
template <typename E>
__device__ __forceinline__ void stage_fwd_rows(float* dst, const E* src,
                                               size_t ld, int valid, int n,
                                               int nrows, bool vec) {
  if (vec) {
    constexpr int q = kKc / 4;
    for (int i = threadIdx.x; i < nrows * q; i += blockDim.x) {
      const int r = i / q, c = 4 * (i % q);
      float* d = dst + r * kLd + c;
      if (r < n && c < valid)
        copy4_to_smem(d, src + r * ld + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * kKc; i += blockDim.x) {
      const int r = i / kKc, c = i % kKc;
      dst[r * kLd + c] = (r < n && c < valid) ? ldf(src[r * ld + c]) : 0.f;
    }
  }
}

// one chunk of hidden units [h0, h0 + valid) into a buffer: xl rows
// [s0, s0 + 64) and xr rows [t0, t0 + 64) (rows past S / T and columns past
// valid zero), w2 and b1
template <typename E>
__device__ __forceinline__ void stage_fwd_chunk(
    float* buf, const E* xlb, const E* xrb, const E* w2b, const E* b1b,
    int H, int h0, int valid, int ns_rows, int nt_rows, bool vec) {
  stage_fwd_rows(buf, xlb + h0, H, valid, ns_rows, kTile, vec);
  stage_fwd_rows(buf + kTile * kLd, xrb + h0, H, valid, nt_rows, kTile, vec);
  stage_fwd_rows(buf + 2 * kTile * kLd, w2b + h0, 0, valid, 1, 1, vec);
  stage_fwd_rows(buf + 2 * kTile * kLd + kKc, b1b + h0, 0, valid, 1, 1, vec);
}

// E: the element type of the inputs and the scores
template <typename E>
__global__ void pairwise_fwd_kernel(const E* __restrict__ xl,
                                    const E* __restrict__ xr,
                                    const E* __restrict__ w2,
                                    const E* __restrict__ b1,
                                    const E* __restrict__ b2,
                                    E* __restrict__ out,
                                    int S, int T, int H,
                                    int64_t w2_stride, int64_t b1_stride,
                                    int64_t b2_stride, float ns) {
  extern __shared__ float4 fwd_smem4[];
  float* smem = reinterpret_cast<float*>(fwd_smem4);
  float* lin_s = smem + 2 * kBuf;  // [kHalves][2 * kTile]
  float* lint_s = lin_s + kHalves * 2 * kTile;  // [2 * kTile]: Ls, Rt
  // what the cluster's blocks push here: their sums of this block's
  // pairs [C][per], and their linear sums [C][2 * kTile]
  float* in_s = lint_s + 2 * kTile;
  float* inlin_s = in_s + kTile * kTile;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  cluster_arrive_relaxed();
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int ntt = (T + kTile - 1) / kTile;
  const int s0 = blockIdx.y / ntt * kTile, t0 = blockIdx.y % ntt * kTile;
  const E* xlb = xl + ((size_t)b * S + s0) * H;
  const E* xrb = xr + ((size_t)b * T + t0) * H;
  const E* w2b = w2 + b * w2_stride;
  const E* b1b = b1 + b * b1_stride;
  const int ns_rows = min(kTile, S - s0), nt_rows = min(kTile, T - t0);
  const bool vec = (H & 3) == 0 && vec4_aligned(xl) && vec4_aligned(xr) &&
                   vec4_aligned(w2) && vec4_aligned(b1);
  // this block's hidden units: an even share of the quads of four
  const int nq = (H + 3) / 4;
  const int hbeg = 4 * (int)((long)rank * nq / C);
  const int hend = min(H, 4 * (int)((long)(rank + 1) * nq / C));
  const int nk = hend > hbeg ? (hend - hbeg + kKc - 1) / kKc : 0;

  // targets tx + 16 j, sources ty + kSy i
  const int tx = tid & 15, ty = tid >> 4;
  const int row = tid & (2 * kTile - 1), half = tid / (2 * kTile);
  float acc[kSi][4];
#pragma unroll
  for (int i = 0; i < kSi; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float lin = 0.f;  // this thread's part of Ls (row < 64) or Rt

  if (nk > 0)
    stage_fwd_chunk(smem, xlb, xrb, w2b, b1b, H, hbeg, min(kKc, hend - hbeg),
                    ns_rows, nt_rows, vec);
  for (int k = 0; k < nk; ++k) {
    float* buf = smem + (k & 1) * kBuf;
    const int h0 = hbeg + k * kKc, valid = min(kKc, hend - h0);
    const int valid4 = (valid + 3) & ~3;
    copy_async_wait_all();
    __syncthreads();  // chunk k landed; chunk k - 1's buffer is free
    if (k + 1 < nk)
      stage_fwd_chunk(smem + ((k + 1) & 1) * kBuf, xlb, xrb, w2b, b1b, H,
                      h0 + kKc, min(kKc, hend - h0 - kKc), ns_rows, nt_rows,
                      vec);
    float* xls = buf;
    float* xrs = buf + kTile * kLd;
    const float* w2s = buf + 2 * kTile * kLd;
    const float* b1s = w2s + kKc;
    {  // xr' = xr + b1 in place, and the linear sums; row < 64 is xl's
      float4* rp = reinterpret_cast<float4*>(
          (row < kTile ? xls + row * kLd : xrs + (row - kTile) * kLd) +
          half * kHc);
      const float4* wp = reinterpret_cast<const float4*>(w2s + half * kHc);
      const float4* bp = reinterpret_cast<const float4*>(b1s + half * kHc);
#pragma unroll
      for (int q = 0; q < kHc / 4; ++q) {
        if (half * kHc + 4 * q >= valid4) break;
        float4 v = rp[q];
        const float4 w = wp[q];
        if (row >= kTile) {
          const float4 c = bp[q];
          v.x += c.x;
          v.y += c.y;
          v.z += c.z;
          v.w += c.w;
          rp[q] = v;
        }
        lin = fmaf(v.x, w.x, lin);
        lin = fmaf(v.y, w.y, lin);
        lin = fmaf(v.z, w.z, lin);
        lin = fmaf(v.w, w.w, lin);
      }
    }
    __syncthreads();
    const float* xa = xls + ty * kLd;
    const float* xc = xrs + tx * kLd;
#pragma unroll 4
    for (int h = 0; h < valid4; h += 4) {
      float4 a[kSi], c[4];
#pragma unroll
      for (int i = 0; i < kSi; ++i)
        a[i] = *reinterpret_cast<const float4*>(xa + kSy * i * kLd + h);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(xc + 16 * j * kLd + h);
      const float4 w = *reinterpret_cast<const float4*>(w2s + h);
#pragma unroll
      for (int i = 0; i < kSi; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(fabsf(a[i].x + c[j].x), w.x, acc[i][j]);
          acc[i][j] = fmaf(fabsf(a[i].y + c[j].y), w.y, acc[i][j]);
          acc[i][j] = fmaf(fabsf(a[i].z + c[j].z), w.z, acc[i][j]);
          acc[i][j] = fmaf(fabsf(a[i].w + c[j].w), w.w, acc[i][j]);
        }
    }
  }

  // the cluster's partial sums meet: each block pushes its sums of the
  // pairs to the block that owns them (pairs [r per, (r + 1) per) to rank
  // r) and its linear sums to every block, then sums what it got in rank
  // order
  __syncthreads();
  float* red = smem;  // [kTile][kTile], over the buffers
#pragma unroll
  for (int i = 0; i < kSi; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(ty + kSy * i) * kTile + tx + 16 * j] = acc[i][j];
  lin_s[half * 2 * kTile + row] = lin;
  __syncthreads();
  const int per = kTile * kTile / C;
  cluster_wait();  // every block of the cluster has started
  for (int p = tid; p < kTile * kTile; p += kFwdThreads)
    cluster.map_shared_rank(in_s, p / per)[rank * per + p % per] = red[p];
  if (tid < 2 * kTile) {
    float v = 0.f;
    for (int hf = 0; hf < kHalves; ++hf) v += lin_s[hf * 2 * kTile + tid];
    for (int q = 0; q < C; ++q)
      cluster.map_shared_rank(inlin_s, q)[rank * 2 * kTile + tid] = v;
  }
  cluster.sync();  // every push landed; nothing is read remotely after
  if (tid < 2 * kTile) {
    float v = 0.f;
    for (int q = 0; q < C; ++q) v += inlin_s[q * 2 * kTile + tid];
    lint_s[tid] = v;
  }
  __syncthreads();
  const float bias2 = ldf(b2[b * b2_stride]);
  // leaky(p) = (1 + ns) / 2 p + (1 - ns) / 2 |p|
  const float lin_w = 0.5f * (1.f + ns), abs_w = 0.5f * (1.f - ns);
  for (int p = rank * per + tid; p < (rank + 1) * per; p += kFwdThreads) {
    const int s = p / kTile, t = p % kTile;
    float r = 0.f;
    for (int q = 0; q < C; ++q) r += in_s[q * per + p - rank * per];
    if (s < ns_rows && t < nt_rows) {
      const float z =
          fmaf(lin_w, lint_s[s] + lint_s[kTile + t], fmaf(abs_w, r, bias2));
      out[((size_t)b * S + s0 + s) * T + t0 + t] =
          stf<E>(1.f / (1.f + expf(-z)));
    }
  }
}

// the SMs of the current device, the forward's resident blocks per SM and
// the largest cluster it may launch, queried once per device (and
// instantiation)
struct FwdSlots {
  int nsm, per_sm, max_cluster;
};

template <typename E>
cudaError_t fwd_slots(FwdSlots* out) {
  static thread_local int dev_c = -1;
  static thread_local FwdSlots c;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != dev_c) {
    const size_t smem = sizeof(float) * kFwdSmem;
    if ((err = cudaFuncSetAttribute(
             pairwise_fwd_kernel<E>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&c.nsm, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &c.per_sm, pairwise_fwd_kernel<E>, kFwdThreads, smem)) !=
            cudaSuccess)
      return err;
    // clusters of 16 are past the portable 8 and must be allowed (and fit)
    c.max_cluster = 8;
    if (cudaFuncSetAttribute(pairwise_fwd_kernel<E>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1) == cudaSuccess) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = kMaxCluster;
      attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
      cfg.gridDim = dim3(kMaxCluster, 1, 1);
      cfg.blockDim = dim3(kFwdThreads, 1, 1);
      cfg.dynamicSmemBytes = smem;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      int n = 0;
      if (cudaOccupancyMaxActiveClusters(&n, pairwise_fwd_kernel<E>, &cfg) ==
              cudaSuccess &&
          n > 0)
        c.max_cluster = kMaxCluster;
    }
    cudaGetLastError();  // a refused query above is not the launch's error
    dev_c = dev;
  }
  *out = c;
  return cudaSuccess;
}

// blocks splitting each tile's hidden units: the smallest power of two
// that gives every SM two blocks, at most the largest allowed and at most
// one per chunk of hidden units
int fwd_cluster(const FwdSlots& sl, int B, int S, int T, int H) {
  const long tiles = (long)((S + kTile - 1) / kTile) * ((T + kTile - 1) / kTile);
  int C = 1;
  while (C < sl.max_cluster && 2 * C * kKc <= H &&
         (long)B * tiles * C < 2L * sl.nsm)
    C *= 2;
  return C;
}

}  // namespace

extern "C" size_t pairwise_fwd_smem_bytes(void) {
  return sizeof(float) * kFwdSmem;
}

// blocks per cluster that the forward's launch takes at these shapes on
// this card (-1 on an error)
extern "C" int pairwise_fwd_cluster(int B, int S, int T, int H) {
  FwdSlots sl;
  if (fwd_slots<float>(&sl) != cudaSuccess) return -1;
  return fwd_cluster(sl, B, S, T, H);
}

// what the forward's launch gets on this card: registers and local (spill)
// bytes per thread, and resident blocks per SM (-1 on an error)
extern "C" int pairwise_fwd_blocks_per_sm(int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  FwdSlots sl;
  if (cudaFuncGetAttributes(&attr, pairwise_fwd_kernel<float>) !=
          cudaSuccess ||
      fwd_slots<float>(&sl) != cudaSuccess)
    return -1;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return sl.per_sm;
}

template <typename E>
static int launch_fwd(const E* xl, const E* xr, const E* w2, const E* b1,
                      const E* b2, E* out, int B, int S, int T, int H,
                      int64_t w2_stride, int64_t b1_stride, int64_t b2_stride,
                      float ns, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0) return (int)cudaGetLastError();
  FwdSlots sl;
  cudaError_t err = fwd_slots<E>(&sl);
  if (err != cudaSuccess) return (int)err;
  const int C = fwd_cluster(sl, B, S, T, H);
  const int tiles = ((S + kTile - 1) / kTile) * ((T + kTile - 1) / kTile);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(C, tiles, B);
  cfg.blockDim = dim3(kFwdThreads, 1, 1);
  cfg.dynamicSmemBytes = sizeof(float) * kFwdSmem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pairwise_fwd_kernel<E>, xl, xr, w2, b1, b2,
                           out, S, T, H, w2_stride, b1_stride, b2_stride, ns);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int pairwise_fwd(const float* xl, const float* xr, const float* w2,
                            const float* b1, const float* b2, float* out,
                            int B, int S, int T, int H, int64_t w2_stride,
                            int64_t b1_stride, int64_t b2_stride, float ns,
                            void* stream) {
  return launch_fwd(xl, xr, w2, b1, b2, out, B, S, T, H, w2_stride,
                    b1_stride, b2_stride, ns, stream);
}

// the bfloat16 instantiation: bfloat16 inputs and scores
extern "C" int pairwise_fwd_bf16(const bf16* xl, const bf16* xr,
                                 const bf16* w2, const bf16* b1,
                                 const bf16* b2, bf16* out, int B, int S,
                                 int T, int H, int64_t w2_stride,
                                 int64_t b1_stride, int64_t b2_stride,
                                 float ns, void* stream) {
  return launch_fwd(xl, xr, w2, b1, b2, out, B, S, T, H, w2_stride,
                    b1_stride, b2_stride, ns, stream);
}
