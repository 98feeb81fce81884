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
// two share an SM; S = T = 120 is the most that fits one block. When a
// batch gives more blocks than keep the card busy for kRounds rounds, a
// block walks several chunks of its sample and fills dz once.

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
constexpr int kU = 2;         // hidden units per lane
constexpr int kCols = 32 * kU;  // hidden units per chunk
constexpr int kRed = kBwdWarps * kBwdWarps * kCols;  // reduction floats
// chunks per block: as many as leave blocks for this many rounds of the
// blocks the card holds at once
constexpr int kRounds = 8;

__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
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

// rows [0, n) of a tile (row r at src + r * ld, its first `valid` floats)
// into dst rows of `width` floats, the rest of each row and rows [n, npad)
// zero: 16-byte copies without registers when `vec`, else one float at a
// time
__device__ __forceinline__ void stage_tile(float* dst, int width,
                                           const float* src, size_t ld,
                                           int valid, int n, int npad,
                                           bool vec) {
  if (vec) {
    const int q = width / 4;
    for (int i = threadIdx.x; i < npad * q; i += blockDim.x) {
      const int r = i / q, c = 4 * (i % q);
      float* d = dst + (size_t)r * width + c;
      if (r < n && c < valid)
        copy16_async(d, src + r * ld + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < npad * width; i += blockDim.x) {
      const int r = i / width, c = i % width;
      dst[i] = (r < n && c < valid) ? src[r * ld + c] : 0.f;
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

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
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T8 = (T + kBwdWarps - 1) / kBwdWarps * kBwdWarps;
  const int nseg = T8 / kBwdWarps;
  float* p = smem;
  float* dz_s = p;  p += (size_t)S * T8;        // [S, T8]: dz, zero past T
  float* do_s = p;  p += (size_t)S * T8;        // [S, T8]: dout
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
  const float* b1b = b1 + b * b1_stride;
  const float* w2b = w2 + b * w2_stride;
  const float* xlb = xl + (size_t)b * S * H;
  const float* xrb = xr + (size_t)b * T * H;
  const size_t ob = (size_t)b * S * T;
  const bool vx = (H & 3) == 0 && aligned16(xl) && aligned16(xr);
  const bool vo = (T & 3) == 0 && aligned16(out) && aligned16(dout);

  // out into the dz tile, dout beside it, the first chunk's xl and xr
  stage_tile(dz_s, T8, out + ob, T, T, S, S, vo);
  stage_tile(do_s, T8, dout + ob, T, T, S, S, vo);
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
    for (int c0 = 0; c0 < T8; c0 += 32) {
      const int t = c0 + lane;
      const size_t i = (size_t)s * T8 + t;
      float v = 0.f;
      if (t < T8) {
        const float y = dz_s[i];
        v = do_s[i] * y * (1.f - y);
        dz_s[i] = v;
      }
      const unsigned live = __ballot_sync(0xffffffffu, v != 0.f);
      if (lane < 4 && c0 / 8 + lane < nseg)
        seg_s[s * nseg + c0 / 8 + lane] = (live >> (8 * lane) & 0xffu) != 0;
      any |= live;
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
      w2h[u] = hv[u] ? w2b[h] : 0.f;
      b1h[u] = hv[u] ? b1b[h] : 0.f;
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
          dxr[((size_t)b * T + t) * H + h0 + u * 32 + lane] = w2h[u] * v;
        acc_w[u] = fmaf(xr_s[t * kCols + u * 32 + lane], v, acc_w[u]);
      }
      __syncthreads();
    }

    for (int s = warp; s < S; s += kBwdWarps)
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float gl = gl_s[s * kCols + u * 32 + lane];
        if (hv[u])
          dxl[((size_t)b * S + s) * H + h0 + u * 32 + lane] = w2h[u] * gl;
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

extern "C" size_t pairwise_bwd_smem_bytes(int S, int T) {
  const size_t T8 = (size_t)(T + kBwdWarps - 1) / kBwdWarps * kBwdWarps;
  const size_t nseg = T8 / kBwdWarps;
  const size_t f =
      2 * (size_t)S * T8 + (2 * (size_t)S + T8) * kCols + kRed;
  return sizeof(float) * f + sizeof(int) * ((size_t)S + 1) +
         (size_t)S * (1 + nseg);
}

// what the backward's launch gets on this card at these shapes: registers
// and local (spill) bytes per thread, and resident blocks per SM (-1 on
// an error)
extern "C" int pairwise_bwd_blocks_per_sm(int S, int T, int* regs,
                                          int* local_bytes) {
  const size_t smem = pairwise_bwd_smem_bytes(S, T);
  cudaFuncAttributes attr;
  if (cudaFuncSetAttribute(pairwise_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, pairwise_bwd_kernel) != cudaSuccess)
    return -1;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, pairwise_bwd_kernel, kBwdWarps * 32, smem) != cudaSuccess)
    return -1;
  return n;
}

// the SMs of the current device and the backward's resident blocks per SM
// at this shared-memory size, queried once per (device, size)
static cudaError_t bwd_slots(size_t smem, int* nsm, int* per_sm) {
  static thread_local int dev_c = -1, nsm_c = 0, per_sm_c = 0;
  static thread_local size_t smem_c = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != dev_c || smem != smem_c) {
    dev_c = -1;
    if ((err = cudaDeviceGetAttribute(&nsm_c, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm_c, pairwise_bwd_kernel, kBwdWarps * 32, smem)) !=
            cudaSuccess)
      return err;
    dev_c = dev;
    smem_c = smem;
  }
  *nsm = nsm_c;
  *per_sm = per_sm_c;
  return cudaSuccess;
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
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  // blocks per sample: enough for kRounds rounds of the blocks the card
  // holds at once; block x walks the chunks x, x + nb, ... of its sample
  int nsm = 0, per_sm = 0;
  if ((err = bwd_slots(smem, &nsm, &per_sm)) != cudaSuccess) return (int)err;
  const int nch = (H + kCols - 1) / kCols;
  const long want = ((long)kRounds * nsm * per_sm + B - 1) / B;
  const int nb = (int)(want < 1 ? 1 : want < nch ? want : nch);
  const int per = (nch + nb - 1) / nb;  // chunks per block, evened out
  dim3 grid((nch + per - 1) / per, B);
  pairwise_bwd_kernel<<<grid, kBwdWarps * 32, smem, (cudaStream_t)stream>>>(
      xl, xr, w2, b1, out, dout, dxl, dxr, dw2, db1, db2, S, T, H, w2_stride,
      b1_stride, ns);
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
