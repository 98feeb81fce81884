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
// Bound on the H100: f32 operations. Per live edge, head and feature the
// logit costs ~8 operations (pre, the slope, the fma) and the aggregation
// one fma; the [B,T,S,H,F] domain is never stored, and inputs and output
// are ~130 MB at A*B = 192. A whole xl[b] (65 x 1300 floats, 338 KB) does
// not fit in shared memory, so one block per (b, h) stages the slices
// xl[b,:,h,:] and xr[b,:,h,:] (cp.async, no registers held) and the
// transposed adj[b] / mask[b] tiles (read once, in order) in shared
// memory, and its warps loop over the targets, so every input element is
// read from device memory once. One warp per target, lanes over features
// (conflict-free), xr / we / att in registers: the target's live sources
// are compacted with a ballot and their logits walked 8 at a time (4 by 4,
// independent chains), one transposing butterfly of 9 shuffles reducing
// the 8 sums; the masked softmax runs over a per-warp row in shared
// memory; the aggregation walks the live sources again, a lane summing 4
// features from one float4 load. At 56 registers two blocks of 13 warps
// share an SM (launch bounds capping it at 72 made it slower). Every sum
// is taken in a fixed order (no atomics), the logits in warp_sum's, so two
// runs agree bit for bit.
// When the caller passes an alpha pointer (training), the warp also writes
// its normalised row as the f32 residual alpha[b, h, t, s] ([B, H, T, S],
// zero for non-edges and for an edgeless target); serving passes null.
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
// dwe_h / datt_h [B, H, F], and the caller sums them.
//
// Bound on the H100: f32 operations on the CUDA cores. The logit domain is
// re-walked at ~17 operations per edge and feature (pre, the slope, the
// dxr / dxl sums, the dadj / dwe / datt fmas) and never stored; the two
// small products (dalpha, sum_t alpha dout) add 2 T S F fmas per (b, h),
// and the loads are ~78 KB per (b, h) at the headline shapes (S = T = 65,
// F = 100). No tensor cores: TF32 would round pre and flip the slope where
// pre ~ 0. One block per (b, h) holds xl, xr and dout of its head in
// shared memory (rows padded to an odd stride, conflict-free both by row
// and by column) and runs in steps:
// - dalpha for the whole T x S tile as a register-tiled product of the
//   block (5 x 3 independent sums per thread, f in order), not one
//   dependent 100-long chain per lane and source; one warp per target then
//   makes de = alpha (dalpha - sum alpha dalpha), kept in shared memory.
// - Phase 1, one warp per target, lanes over features: the target's live
//   sources are compacted with a ballot and walked 8 at a time (4 by 4,
//   independent pre -> slope chains); one transposing butterfly of 9
//   shuffles reduces the 8 dadj sums, where a shuffle chain per edge took
//   40. It gives dxr, dadj_h and each warp's dwe / datt partial sums,
//   which meet in shared memory before phase 2.
// - Phase 2, one warp per source, lanes over features: the walk again for
//   dxl.
// Launch bounds of 13 warps and 2 blocks per SM cap a thread at 72
// registers (no spills), so two blocks share an SM and one's loads and
// barriers overlap the other's walks. Where the tiles with the per-warp
// scratch rows beside them do not fit a block (above S = T = 124 at F =
// 100), a second instance of the kernel lays the scratch rows over the
// dout tile, which only the dalpha product reads, and phase 2 reads each
// dout row from device memory instead (the same sums in the same order,
// so the same results bit for bit): 222.9 KB at S = T = 129, F = 100, and
// up to S = T = 133 there. Each output element is summed by one
// thread in a fixed order (no atomics), so two runs agree bit for bit.
// Non-edges (alpha = 0) are skipped; an edgeless target contributes
// nothing.

// Element types (elem.cuh). Each entry point has a float32 and a bfloat16
// instantiation (gat_fwd_bf16, gat_bwd_bf16), as JAX's kernels load the
// compute dtype and upcast at once: at bfloat16 xl, xr, adj, we, att and
// dout are read as bfloat16 and out, dxl and dxr written as bfloat16
// (rounded once), while alpha, dadj_h, dwe_h and datt_h stay float32 (the
// residual JAX keeps in float32, and the sums the caller adds over heads
// or samples and casts once). Registers and the shared tiles are float in
// both instantiations, so each layout's shared memory and blocks per SM
// are float32's; the forward stages bfloat16 rows through registers where
// float32 takes cp.async.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr int kMaxF = 128;  // features per head held in registers (4 / lane)

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

// per-warp scratch floats: 3 rows of max(S, T), or the final reduction's
// 2 x F when that is longer
__host__ __device__ inline int gat_bwd_warp_floats(int S, int T, int F) {
  const int r = 3 * (S > T ? S : T);
  return r > 2 * F ? r : 2 * F;
}

// the dalpha tile of one thread: kRT targets (strided by the warp count)
// by kRS sources (strided by 32)
constexpr int kRT = 5, kRS = 3;
// live sources per step of a walk over a target's sources (the forward's
// logits, the backward's phase 1), walked kSub at a time so that two
// blocks' registers fit on an SM
constexpr int kSrc = 8, kSub = 4;
static_assert(kSrc == 8, "the transposing butterfly reduces 8 sums");
// at most this many warps per backward block: with two blocks resident
// per SM a thread may use 65536 / (2 * 13 * 32) = 78 registers, 72 in
// the allocation unit of 8
constexpr int kBwdWarps = 13;

// n rows of F elements (row r at src + r * ld) into dst rows of stride
// Fq floats (F rounded up to 4, the tail zero): 4 elements a copy when
// they are aligned (copy4_to_smem), else one at a time
template <typename E>
__device__ __forceinline__ void stage_rows(float* dst, const E* src,
                                           size_t ld, int n, int F, int Fq,
                                           bool vec) {
  if (vec) {
    const int q = F / 4;
    for (int i = threadIdx.x; i < n * q; i += blockDim.x) {
      const int r = i / q, c = i % q;
      copy4_to_smem(dst + (size_t)r * Fq + 4 * c, src + r * ld + 4 * c);
    }
  } else {
    for (int i = threadIdx.x; i < n * Fq; i += blockDim.x) {
      const int r = i / Fq, f = i % Fq;
      dst[i] = f < F ? ldf(src[r * ld + f]) : 0.f;
    }
  }
}

// E: the element type of xl, xr, adj, we, att and out; alpha is float32
template <typename E>
__global__ void gat_fwd_kernel(const E* __restrict__ xl, const E* __restrict__ xr,
               const E* __restrict__ adj, const uint8_t* __restrict__ mask,
               const E* __restrict__ we, const E* __restrict__ att,
               E* __restrict__ out, float* __restrict__ alpha, int S,
               int T, int H, int F, float ns) {
  extern __shared__ float smem[];
  const int nwarps = blockDim.x / 32;
  const int Sp = S | 1;            // odd row stride
  const int Fq = (F + 3) & ~3;     // float4 rows
  float* xl_s = smem;                              // [S, Fq]
  float* xr_s = xl_s + (size_t)S * Fq;             // [T, Fq]
  float* adj_s = xr_s + (size_t)T * Fq;            // [T, Sp]: adj^T
  float* row_s = adj_s + (size_t)T * Sp;           // [nwarps, S]
  int* lst_s = (int*)(row_s + (size_t)nwarps * S);  // [nwarps, S]
  uint8_t* msk_s = (uint8_t*)(lst_s + (size_t)nwarps * S);  // [T, Sp]: mask^T

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int HF = H * F;
  const bool vec = (F & 3) == 0 && vec4_aligned(xl) && vec4_aligned(xr);
  stage_rows(xl_s, xl + (size_t)b * S * HF + (size_t)h * F, HF, S, F, Fq,
             vec);
  stage_rows(xr_s, xr + (size_t)b * T * HF + (size_t)h * F, HF, T, F, Fq,
             vec);
  // adj[b] and mask[b] read once, in order (4 loads in flight a thread),
  // and stored transposed: a target's column becomes a row
  const E* adj_b = adj + (size_t)b * S * T;
  const uint8_t* mask_b = mask + (size_t)b * S * T;
  for (int i0 = threadIdx.x; i0 < S * T; i0 += 4 * blockDim.x) {
    float a[4];
    uint8_t m[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      a[u] = i < S * T ? ldf(adj_b[i]) : 0.f;
      m[u] = i < S * T ? mask_b[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < S * T) {
        const int s = i / T, t = i % T;
        adj_s[t * Sp + s] = a[u];
        msk_s[t * Sp + s] = m[u];
      }
    }
  }
  copy_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* row = row_s + warp * S;  // logits, then softmax weights
  int* lst = lst_s + warp * S;    // live sources

  float wev[kMaxF / 32], attv[kMaxF / 32];
#pragma unroll
  for (int j = 0; j < kMaxF / 32; ++j) {
    const int f = lane + 32 * j;
    wev[j] = f < F ? ldf(we[h * F + f]) : 0.f;
    attv[j] = f < F ? ldf(att[h * F + f]) : 0.f;
  }

  for (int t = warp; t < T; t += nwarps) {
    const float* adj_t = adj_s + (size_t)t * Sp;
    const uint8_t* msk_t = msk_s + (size_t)t * Sp;
    float xrv[kMaxF / 32];
#pragma unroll
    for (int j = 0; j < kMaxF / 32; ++j) {
      const int f = lane + 32 * j;
      xrv[j] = f < F ? xr_s[(size_t)t * Fq + f] : 0.f;
    }
    // the live sources compacted into lst, in order (a ballot)
    int n = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const bool live = s < S && msk_t[s];
      const unsigned ballot = __ballot_sync(0xffffffffu, live);
      if (live) lst[n + __popc(ballot & ((1u << lane) - 1u))] = s;
      n += __popc(ballot);
    }
    __syncwarp();

    // logits of the live sources, kSrc at a time in steps of kSub (lanes
    // take features): kSub independent pre -> slope -> fma chains, kSrc
    // partial sums per lane, and one transposing butterfly of 9 shuffles
    // for the kSrc logits (a shuffle chain per edge took 40). A step's
    // remainder repeats its first source and is not stored; an empty
    // second half is skipped.
    for (int k0 = 0; k0 < n; k0 += kSrc) {
      float p[kSrc];
#pragma unroll
      for (int u = 0; u < kSrc; ++u) p[u] = 0.f;
#pragma unroll
      for (int u0 = 0; u0 < kSrc; u0 += kSub) {
        if (u0 > 0 && k0 + u0 >= n) break;  // warp-uniform
        int so[kSub];
        float au[kSub];
#pragma unroll
        for (int v = 0; v < kSub; ++v) {
          const int k = k0 + u0 + v;
          const int s = lst[k < n ? k : k0];
          so[v] = s * Fq;
          au[v] = adj_t[s];
        }
#pragma unroll
        for (int j = 0; j < kMaxF / 32; ++j) {
          const int f = lane + 32 * j;
          if (f < F) {
#pragma unroll
            for (int v = 0; v < kSub; ++v) {
              const float pre =
                  pre_act(xl_s[so[v] + f], xrv[j], au[v], wev[j]);
              p[u0 + v] = fmaf(fmaxf(pre, ns * pre), attv[j], p[u0 + v]);
            }
          }
        }
      }
      // as in the backward: lane l ends with source (l >> 2) & 7's sum,
      // added in warp_sum's tree
#pragma unroll
      for (int w = kSrc / 2, off = 16; w >= 1; w /= 2, off /= 2) {
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
      const int k = k0 + (lane >> 2);
      if ((lane & 3) == 0 && k < n) row[lst[k]] = p[0];
    }
    __syncwarp();

    // masked softmax over the sources
    float m = -INFINITY;
    for (int s = lane; s < S; s += 32)
      if (msk_t[s]) m = fmaxf(m, row[s]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float denom = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float w = msk_t[s] ? expf(row[s] - m) : 0.f;
      row[s] = w;
      denom += w;
    }
    denom = warp_sum(denom);
    const float inv = denom > 0.f ? 1.f / denom : 0.f;
    __syncwarp();
    if (alpha != nullptr) {
      float* ar = alpha + (((size_t)b * H + h) * T + t) * S;
      for (int s = lane; s < S; s += 32) ar[s] = row[s] * inv;
    }

    // aggregation over the live sources, in order, lane c summing
    // features 4c .. 4c + 3
    if (4 * lane < F) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < n; ++k) {
        const int s = lst[k];
        const float w = row[s];
        if (w == 0.f) continue;
        const float4 x = *reinterpret_cast<const float4*>(
            xl_s + (size_t)s * Fq + 4 * lane);
        acc[0] = fmaf(w, x.x, acc[0]);
        acc[1] = fmaf(w, x.y, acc[1]);
        acc[2] = fmaf(w, x.z, acc[2]);
        acc[3] = fmaf(w, x.w, acc[3]);
      }
      E* o = out + ((size_t)b * T + t) * HF + h * F;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * lane + i < F) o[4 * lane + i] = stf<E>(acc[i] * inv);
    }
    __syncwarp();
  }
}

// kKeepDout: dout stays in shared memory through phase 2 (the headline
// layout); else the scratch rows reuse its tile after the dalpha product,
// a block then fills an SM's shared memory alone, and launch bounds of one
// block per SM leave it the registers it needs without spilling. E: the
// element type of xl, xr, adj, we, att, dout, dxl and dxr; alpha, dadj_h,
// dwe_h and datt_h are float32
template <bool kKeepDout, typename E>
__global__ void __launch_bounds__(kBwdWarps * 32, kKeepDout ? 2 : 1)
gat_bwd_kernel(const E* __restrict__ xl, const E* __restrict__ xr,
               const E* __restrict__ adj, const uint8_t* __restrict__ mask,
               const E* __restrict__ we, const E* __restrict__ att,
               const float* __restrict__ alpha, const E* __restrict__ dout,
               E* __restrict__ dxl, E* __restrict__ dxr,
               float* __restrict__ dadj_h, float* __restrict__ dwe_h,
               float* __restrict__ datt_h, int S, int T, int H, int F,
               float ns) {
  extern __shared__ float smem[];
  const int nwarps = blockDim.x / 32;
  const int Fp = F | 1;  // odd row stride
  const int R = S > T ? S : T;
  const int wf = gat_bwd_warp_floats(S, T, F);
  const size_t scr = (size_t)nwarps * wf;
  const size_t dlen = (size_t)T * Fp;
  float* xl_s = smem;                        // [S, Fp]
  float* xr_s = xl_s + (size_t)S * Fp;       // [T, Fp]
  float* do_s = xr_s + (size_t)T * Fp;       // [T, Fp]: dout
  float* de_s = do_s + (kKeepDout || dlen > scr ? dlen : scr);  // [T, S]
  // [nwarps, wf]: beside the tiles, or over do_s after the dalpha product
  float* scr_s = kKeepDout ? de_s + (size_t)T * S : do_s;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int HF = H * F;
  for (int i = threadIdx.x; i < S * F; i += blockDim.x) {
    const int s = i / F, f = i % F;
    xl_s[s * Fp + f] = ldf(xl[((size_t)b * S + s) * HF + h * F + f]);
  }
  for (int i = threadIdx.x; i < T * F; i += blockDim.x) {
    const int t = i / F, f = i % F;
    const size_t o = ((size_t)b * T + t) * HF + h * F + f;
    xr_s[t * Fp + f] = ldf(xr[o]);
    do_s[t * Fp + f] = ldf(dout[o]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // dalpha[t, s] = sum_f dout[t, f] xl[s, f] over the whole T x S tile,
  // dense, into de_s. Each thread keeps kRT x kRS independent sums (targets
  // warp + nwarps i, sources lane + 32 j) and adds f = 0..F-1 in order: the
  // dout loads are broadcasts, the xl loads conflict-free (odd stride)
  for (int t0 = warp; t0 < T; t0 += nwarps * kRT) {
    for (int s0 = lane; s0 < S; s0 += 32 * kRS) {
      int ro[kRT], co[kRS];
      float acc[kRT][kRS];
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const int t = t0 + nwarps * i;
        ro[i] = (t < T ? t : t0) * Fp;
#pragma unroll
        for (int j = 0; j < kRS; ++j) acc[i][j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kRS; ++j) {
        const int s = s0 + 32 * j;
        co[j] = (s < S ? s : s0) * Fp;
      }
      for (int f = 0; f < F; ++f) {
        float x[kRS];
#pragma unroll
        for (int j = 0; j < kRS; ++j) x[j] = xl_s[co[j] + f];
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          const float d = do_s[ro[i] + f];
#pragma unroll
          for (int j = 0; j < kRS; ++j) acc[i][j] = fmaf(d, x[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const int t = t0 + nwarps * i;
#pragma unroll
        for (int j = 0; j < kRS; ++j) {
          const int s = s0 + 32 * j;
          if (t < T && s < S) de_s[(size_t)t * S + s] = acc[i][j];
        }
      }
    }
  }
  __syncthreads();

  float* mrow = scr_s + (size_t)warp * wf;  // phase 2: mask (0 / 1)
  int* lst = (int*)mrow;                    // phase 1: live sources
  float* arow = mrow + R;                   // adj
  float* vrow = arow + R;                   // dadj_h; in phase 2 alpha

  float wev[kMaxF / 32], awv[kMaxF / 32];
  float gw[kMaxF / 32], ga[kMaxF / 32];
#pragma unroll
  for (int j = 0; j < kMaxF / 32; ++j) {
    const int f = lane + 32 * j;
    wev[j] = f < F ? ldf(we[h * F + f]) : 0.f;
    awv[j] = f < F ? ldf(att[h * F + f]) * wev[j] : 0.f;
    gw[j] = 0.f;
    ga[j] = 0.f;
  }

  // phase 1: one warp per target t
  for (int t = warp; t < T; t += nwarps) {
    const float* al = alpha + (((size_t)b * H + h) * T + t) * S;
    float* det = de_s + (size_t)t * S;
    // de = alpha (dalpha - sum_s alpha dalpha), 0 off the edges (alpha =
    // 0); the live sources compacted into lst, in order (a ballot)
    float sc = 0.f;
    int n = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      bool live = false;
      if (s < S) {
        const size_t o = ((size_t)b * S + s) * T + t;
        live = mask[o] != 0;
        arow[s] = ldf(adj[o]);
        vrow[s] = 0.f;
        sc = fmaf(al[s], det[s], sc);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, live);
      if (live) lst[n + __popc(ballot & ((1u << lane) - 1u))] = s;
      n += __popc(ballot);
    }
    sc = warp_sum(sc);
    for (int s = lane; s < S; s += 32) det[s] = al[s] * (det[s] - sc);
    __syncwarp();

    // the walk over the live sources, kSrc at a time in steps of kSub
    // (lanes take features): kSub independent pre -> slope chains, kSrc
    // partial dadj sums per lane, and one transposing butterfly of 9
    // shuffles for the kSrc sums (a shuffle chain per edge took 40)
    float xrv[kMaxF / 32], gr[kMaxF / 32];
#pragma unroll
    for (int j = 0; j < kMaxF / 32; ++j) {
      const int f = lane + 32 * j;
      xrv[j] = f < F ? xr_s[(size_t)t * Fp + f] : 0.f;
      gr[j] = 0.f;
    }
    for (int k0 = 0; k0 < n; k0 += kSrc) {
      float p[kSrc];
#pragma unroll
      for (int u = 0; u < kSrc; ++u) p[u] = 0.f;
#pragma unroll
      for (int u0 = 0; u0 < kSrc; u0 += kSub) {
        int so[kSub];
        float au[kSub], du[kSub];
#pragma unroll
        for (int v = 0; v < kSub; ++v) {
          const int k = k0 + u0 + v;
          const int s = lst[k < n ? k : k0];
          so[v] = s * Fp;
          au[v] = arow[s];
          du[v] = k < n ? det[s] : 0.f;  // the remainder adds zeros
        }
#pragma unroll
        for (int j = 0; j < kMaxF / 32; ++j) {
          const int f = lane + 32 * j;
          if (f < F) {
#pragma unroll
            for (int v = 0; v < kSub; ++v) {
              const float pre =
                  pre_act(xl_s[so[v] + f], xrv[j], au[v], wev[j]);
              const float g = pre >= 0.f ? du[v] : ns * du[v];
              gr[j] += g;
              p[u0 + v] = fmaf(g, awv[j], p[u0 + v]);
              gw[j] = fmaf(g, au[v], gw[j]);
              ga[j] = fmaf(pre, g, ga[j]);
            }
          }
        }
      }
      // each step halves the sums a lane carries: after offsets 16, 8
      // and 4, lane l holds source (l >> 2) & 7's partial over the lanes
      // l ^ {0, 4, .., 28}; offsets 2 and 1 finish it
#pragma unroll
      for (int w = kSrc / 2, off = 16; w >= 1; w /= 2, off /= 2) {
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
      const int k = k0 + (lane >> 2);
      if ((lane & 3) == 0 && k < n) vrow[lst[k]] = p[0];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kMaxF / 32; ++j) {
      const int f = lane + 32 * j;
      if (f < F)
        dxr[((size_t)b * T + t) * HF + h * F + f] =
            stf<E>(ldf(att[h * F + f]) * gr[j]);
    }
    float* dq = dadj_h + (((size_t)b * H + h) * T + t) * S;
    for (int s = lane; s < S; s += 32) dq[s] = vrow[s];
    __syncwarp();
  }
  __syncthreads();

  // the warps' dwe / datt sums meet in the scratch rows (free between the
  // phases), so phase 2 keeps no gw / ga registers
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
    dwe_h[o] = ldf(att[h * F + f]) * w;
    datt_h[o] = a;
  }
  __syncthreads();

  // phase 2: one warp per source s
  for (int s = warp; s < S; s += nwarps) {
    for (int t = lane; t < T; t += 32) {
      const size_t o = ((size_t)b * S + s) * T + t;
      mrow[t] = mask[o] ? 1.f : 0.f;
      arow[t] = ldf(adj[o]);
      vrow[t] = alpha[(((size_t)b * H + h) * T + t) * S + s];
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
      const float d = de_s[(size_t)t * S + s], a = arow[t], al = vrow[t];
      const float* xt = xr_s + (size_t)t * Fp;
      // dout[t] from its tile, or from device memory
      const float* dts = do_s + (size_t)t * Fp;
      const E* dtg = dout + ((size_t)b * T + t) * HF + h * F;
#pragma unroll
      for (int j = 0; j < kMaxF / 32; ++j) {
        const int f = lane + 32 * j;
        if (f < F) {
          const float pre = pre_act(xlv[j], xt[f], a, wev[j]);
          g1[j] += pre >= 0.f ? d : ns * d;
          g2[j] = fmaf(al, kKeepDout ? dts[f] : ldf(dtg[f]), g2[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxF / 32; ++j) {
      const int f = lane + 32 * j;
      if (f < F)
        dxl[((size_t)b * S + s) * HF + h * F + f] =
            stf<E>(fmaf(ldf(att[h * F + f]), g1[j], g2[j]));
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" size_t gat_fwd_smem_bytes(int S, int T, int F, int nwarps) {
  const size_t Sp = (size_t)(S | 1), Fq = (size_t)((F + 3) & ~3);
  return sizeof(float) * ((S + T) * Fq + T * Sp + 2 * (size_t)nwarps * S) +
         T * Sp;
}

template <typename E>
static int launch_fwd(const E* xl, const E* xr, const E* adj,
                      const uint8_t* mask, const E* we, const E* att, E* out,
                      float* alpha, int B, int S, int T, int H, int F,
                      int nwarps, float ns, void* stream) {
  if (F > kMaxF || nwarps < 1 || nwarps > 32) return (int)cudaErrorInvalidValue;
  size_t smem = gat_fwd_smem_bytes(S, T, F, nwarps);
  cudaError_t err = cudaFuncSetAttribute(
      gat_fwd_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && H > 0 && T > 0) {
    gat_fwd_kernel<E><<<B * H, nwarps * 32, smem, (cudaStream_t)stream>>>(
        xl, xr, adj, mask, we, att, out, alpha, S, T, H, F, ns);
  }
  return (int)cudaGetLastError();
}

extern "C" int gat_fwd(const float* xl, const float* xr, const float* adj,
                       const uint8_t* mask, const float* we, const float* att,
                       float* out, float* alpha, int B, int S, int T, int H,
                       int F, int nwarps, float ns, void* stream) {
  return launch_fwd(xl, xr, adj, mask, we, att, out, alpha, B, S, T, H, F,
                    nwarps, ns, stream);
}

// the bfloat16 instantiation: bfloat16 inputs and out, float32 alpha
extern "C" int gat_fwd_bf16(const bf16* xl, const bf16* xr, const bf16* adj,
                            const uint8_t* mask, const bf16* we,
                            const bf16* att, bf16* out, float* alpha, int B,
                            int S, int T, int H, int F, int nwarps, float ns,
                            void* stream) {
  return launch_fwd(xl, xr, adj, mask, we, att, out, alpha, B, S, T, H, F,
                    nwarps, ns, stream);
}

// resident blocks of gat_fwd_kernel per SM at these shapes, and the
// kernel's registers and local (spill) bytes per thread
extern "C" int gat_fwd_blocks_per_sm(int S, int T, int F, int nwarps,
                                     int* regs, int* local_bytes) {
  const size_t smem = gat_fwd_smem_bytes(S, T, F, nwarps);
  cudaFuncAttributes attr;
  if (cudaFuncSetAttribute(gat_fwd_kernel<float>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, gat_fwd_kernel<float>) != cudaSuccess)
    return -1;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gat_fwd_kernel<float>,
                                                    nwarps * 32, smem) !=
      cudaSuccess)
    return -1;
  return n;
}

// bytes of shared memory a block may opt in to on the current card
// (232,448 on the H100); the wrappers refuse a launch against the same
// attribute (ops/common.py: smem_limit)
static size_t smem_limit() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)bytes;
}

// the backward's shared memory with dout kept beside the scratch rows,
// or with the scratch over it
static size_t bwd_smem_bytes(int S, int T, int F, int nwarps, bool keep) {
  const size_t Fp = (size_t)(F | 1), dlen = (size_t)T * Fp;
  const size_t scr = (size_t)nwarps * gat_bwd_warp_floats(S, T, F);
  return sizeof(float) * (((size_t)S + T) * Fp + (size_t)T * S +
                          (keep ? dlen + scr : dlen > scr ? dlen : scr));
}

// dout is kept wherever that layout fits a block
static bool bwd_keep_dout(int S, int T, int F, int nwarps) {
  return bwd_smem_bytes(S, T, F, nwarps, true) <= smem_limit();
}

template <typename E>
using BwdKernel = void (*)(const E*, const E*, const E*, const uint8_t*,
                           const E*, const E*, const float*, const E*, E*, E*,
                           float*, float*, float*, int, int, int, int, float);

template <typename E>
static BwdKernel<E> bwd_kernel(int S, int T, int F, int nwarps) {
  return bwd_keep_dout(S, T, F, nwarps) ? gat_bwd_kernel<true, E>
                                        : gat_bwd_kernel<false, E>;
}

// the shared memory of the layout a launch at these shapes takes
extern "C" size_t gat_bwd_smem_bytes(int S, int T, int F, int nwarps) {
  return bwd_smem_bytes(S, T, F, nwarps, bwd_keep_dout(S, T, F, nwarps));
}

template <typename E>
static int launch_bwd(const E* xl, const E* xr, const E* adj,
                      const uint8_t* mask, const E* we, const E* att,
                      const float* alpha, const E* dout, E* dxl, E* dxr,
                      float* dadj_h, float* dwe_h, float* datt_h, int B,
                      int S, int T, int H, int F, int nwarps, float ns,
                      void* stream) {
  if (F > kMaxF || nwarps < 1 || nwarps > kBwdWarps)
    return (int)cudaErrorInvalidValue;
  const size_t smem = gat_bwd_smem_bytes(S, T, F, nwarps);
  const BwdKernel<E> kern = bwd_kernel<E>(S, T, F, nwarps);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && H > 0) {
    kern<<<B * H, nwarps * 32, smem, (cudaStream_t)stream>>>(
        xl, xr, adj, mask, we, att, alpha, dout, dxl, dxr, dadj_h, dwe_h,
        datt_h, S, T, H, F, ns);
  }
  return (int)cudaGetLastError();
}

extern "C" int gat_bwd(const float* xl, const float* xr, const float* adj,
                       const uint8_t* mask, const float* we, const float* att,
                       const float* alpha, const float* dout, float* dxl,
                       float* dxr, float* dadj_h, float* dwe_h, float* datt_h,
                       int B, int S, int T, int H, int F, int nwarps, float ns,
                       void* stream) {
  return launch_bwd(xl, xr, adj, mask, we, att, alpha, dout, dxl, dxr, dadj_h,
                    dwe_h, datt_h, B, S, T, H, F, nwarps, ns, stream);
}

// the bfloat16 instantiation: bfloat16 inputs, dout, dxl and dxr; float32
// alpha and the per-head / per-sample sums dadj_h, dwe_h and datt_h
extern "C" int gat_bwd_bf16(const bf16* xl, const bf16* xr, const bf16* adj,
                            const uint8_t* mask, const bf16* we,
                            const bf16* att, const float* alpha,
                            const bf16* dout, bf16* dxl, bf16* dxr,
                            float* dadj_h, float* dwe_h, float* datt_h, int B,
                            int S, int T, int H, int F, int nwarps, float ns,
                            void* stream) {
  return launch_bwd(xl, xr, adj, mask, we, att, alpha, dout, dxl, dxr, dadj_h,
                    dwe_h, datt_h, B, S, T, H, F, nwarps, ns, stream);
}

// resident blocks of gat_bwd_kernel per SM at these shapes, and the
// kernel's registers and local (spill) bytes per thread
extern "C" int gat_bwd_blocks_per_sm(int S, int T, int F, int nwarps,
                                     int* regs, int* local_bytes) {
  const size_t smem = gat_bwd_smem_bytes(S, T, F, nwarps);
  const BwdKernel<float> kern = bwd_kernel<float>(S, T, F, nwarps);
  cudaFuncAttributes attr;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kern) != cudaSuccess)
    return -1;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, nwarps * 32,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}
