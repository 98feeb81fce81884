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
// What bounds it: the [B,S,T,K,F] domain (192*65*65*2*64 = 1.04e8 elements
// at the causal step) is never stored and its inputs and output are ~23 MB,
// so f32 operations. The leaky map in its abs form, leaky(p) = (1 + ns) / 2
// p + (1 - ns) / 2 |p|, makes the linear part separable: sum_f att p =
// L_s + R_t + adj W with L_s = sum_f att xl, R_t = sum_f att xr and W =
// sum_f att we, taken once per block, which leaves an add, the edge's fma
// and an fma with |p| per element (5 operations, an fma counted as 2; the
// leaky select took 7). A block owns a strip of at most kFwdMaxRows sources
// of one (b, k) plane against all its targets, its rows, the plane's target
// rows, adj and we / att staged by cp.async (rows padded to a stride of 4
// mod 8 floats, so float4 reads of neighbouring rows hit distinct banks); a
// thread holds a 2 x 4 tile of pairs in registers (targets strided by
// ceil(T / 4), so neighbouring threads write neighbouring logits) and reads
// 4 features a step as float4. The strips are sized so the grid gives every
// SM a block at B = 16 (9 strips of 7-8 sources at K = 1, 5 at K = 2) and
// hold at most 22 sources (3 a plane at A*B = 192). Each logit is summed by
// one thread.
//
// Backward, replaces the one-walk VJP ctvae_tpu/ops/gat.py::_fgl_bwd
// (:85-100). From d_e [B,S,T,K], with g = d_e (pre >= 0 ? 1 : ns):
//
//   dxl[s,f] = att[f] GL[s,f],  GL = sum_t g    dxr[t,f] = att[f] GR[t,f],
//   GR = sum_s g    dadj[s,t] = sum_k sum_f g att[f] we[f]
//   dwe[f] = att[f] GW[f],  GW = sum_{s,t} adj g
//   datt[f] = sum_{s,t} pre g = sum_s xl GL + sum_t xr GR + we GW
//
// (datt from the separable sums the others need, no fma per element). Only
// pairs with d_e != 0 (the softmax's edges) contribute. What bounds it: the
// bytes at the main path's live shares (15-50% of pairs): the walks cost
// ~10 operations per live element. The grid splits each sample's sources
// into row blocks (dxl, dadj summed over the heads, the dwe partial and
// the datt part sum_s xl GL + we GW) and its targets into column blocks
// (dxr and sum_t xr GR), kMaxRows at most and enough chunks for
// kBwdBlocksPerSm blocks per SM (18 blocks a sample at B = 16, 6 at 192);
// a block walks its rows head by head. Per head it stages its rows, the
// other side's rows, d_e and (once) adj with cp.async; a warp takes a row,
// compacts its live pairs with a ballot (each entry: the other row's
// offset, adj, d_e and index) and walks them 8 per group of L lanes (L = 16
// at F = 64, a lane 4 features from one float4), one transposing butterfly
// over the group reducing the 8 dadj sums. The slope test (xl + xr) >=
// -(adj we) holds exactly when the plain version's (xl + xr) + adj we >= 0
// (for finite operands without flush to zero a float sum is zero only when
// it is exact), so both take the same slope at pre ~ 0. Every block writes
// its dwe / datt partials [2, K, F], which the caller sums in a fixed
// order; each other output element is summed by one thread. No atomics:
// two runs agree bit for bit. Launch bounds of 4 blocks of 8 warps per SM
// hold a thread to 64 registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxF = 128;  // features per head at most

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// a 16-byte copy from device to shared memory that holds no register
// (cp.async); copy_async_wait_all waits for the thread's copies
__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
#endif
}

// a 4-byte copy from device to shared memory by cp.async (no register)
__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
#endif
}

__device__ __forceinline__ void copy_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// n rows of F floats (row r at src + r * ld) into dst rows of stride Fq
// (F rounded up to 4 or more): 16-byte copies when they are aligned, else
// one float at a time with the row's tail zero
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           size_t ld, int n, int F, int Fq,
                                           bool vec) {
  if (vec) {
    const int q = F / 4;
    for (int i = threadIdx.x; i < n * q; i += blockDim.x) {
      const int r = i / q, c = i % q;
      copy16_async(dst + (size_t)r * Fq + 4 * c, src + r * ld + 4 * c);
    }
  } else {
    for (int i = threadIdx.x; i < n * Fq; i += blockDim.x) {
      const int r = i / Fq, f = i % Fq;
      dst[i] = f < F ? src[r * ld + f] : 0.f;
    }
  }
}

// the SMs of the current device, queried once per device
cudaError_t device_sms(int* nsm) {
  static thread_local int dev_c = -1, nsm_c = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != dev_c) {
    err = cudaDeviceGetAttribute(&nsm_c, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    dev_c = dev;
  }
  *nsm = nsm_c;
  return cudaSuccess;
}

// ---- forward ----

// a thread's tile of pairs: kFi sources by kFj targets (the targets
// strided by ceil(T / kFj), so neighbouring threads take neighbouring
// targets and write neighbouring logits)
constexpr int kFi = 2, kFj = 4;
// sources per block at most (11 x 17 tiles at T = 65: 187 threads)
constexpr int kFwdMaxRows = 22;
// blocks of the grid per SM that the split of a plane into strips of
// sources aims for
constexpr int kFwdBlocksPerSm = 1;

// the row stride of a staged tile: F rounded up to 4, plus 4 when that is
// a multiple of 8, so 8 lanes reading 16 bytes of 8 neighbouring rows hit
// distinct banks
__host__ __device__ inline int fwd_stride(int F) {
  const int Fq = (F + 3) & ~3;
  return (Fq & 7) == 0 ? Fq + 4 : Fq;
}

// shared floats of a block with R sources of a plane against its T
// targets: xl [R, Fs], xr [T, Fs], adj [R, T], we and att [Fs] each, the
// linear sums L [R] and R_t [T], and W
__host__ __device__ inline size_t fwd_block_floats(int R, int T, int F) {
  const size_t Fs = (size_t)fwd_stride(F);
  return ((size_t)R + T + 2) * Fs + (size_t)R * T + R + T + 1;
}

__global__ void gat_logits_fwd_kernel(const float* __restrict__ xl,
                                      const float* __restrict__ xr,
                                      const float* __restrict__ adj,
                                      const float* __restrict__ we,
                                      const float* __restrict__ att,
                                      float* __restrict__ out, int S, int T,
                                      int K, int F, int wstride, int nstrip,
                                      float ns) {
  extern __shared__ float4 fwd_smem4[];
  float* smem = reinterpret_cast<float*>(fwd_smem4);
  const int Fs = fwd_stride(F);
  const int b = blockIdx.y / K, k = blockIdx.y % K;
  const int s0 = (int)((long)blockIdx.x * S / nstrip);
  const int R = (int)((long)(blockIdx.x + 1) * S / nstrip) - s0;
  float* xl_s = smem;                     // [R, Fs]
  float* xr_s = xl_s + (size_t)R * Fs;    // [T, Fs]
  float* we_s = xr_s + (size_t)T * Fs;    // [Fs]
  float* at_s = we_s + Fs;                // [Fs]
  float* adj_s = at_s + Fs;               // [R, T]
  float* lin_s = adj_s + (size_t)R * T;   // [R + T + 1]: L_s, R_t, W

  const int KF = K * F;
  const bool vec = (F & 3) == 0 && aligned16(xl) && aligned16(xr) &&
                   aligned16(we) && aligned16(att) && (wstride & 3) == 0;
  const float* wb = we + (size_t)b * wstride + k * F;
  const float* ab = att + (size_t)b * wstride + k * F;
  stage_rows(xl_s, xl + ((size_t)b * S + s0) * KF + k * F, KF, R, F, Fs, vec);
  stage_rows(xr_s, xr + (size_t)b * T * KF + k * F, KF, T, F, Fs, vec);
  stage_rows(we_s, wb, 0, 1, F, Fs, vec);
  stage_rows(at_s, ab, 0, 1, F, Fs, vec);
  const float* adjb = adj + ((size_t)b * S + s0) * T;
  for (int i = threadIdx.x; i < R * T; i += blockDim.x)
    copy4_async(adj_s + i, adjb + i);
  copy_async_wait_all();
  __syncthreads();

  // the linear sums sum_f att xl, sum_f att xr and sum_f att we, a thread
  // per row, f in order
  for (int i = threadIdx.x; i < R + T + 1; i += blockDim.x) {
    const float* x = i < R ? xl_s + (size_t)i * Fs
                           : (i < R + T ? xr_s + (size_t)(i - R) * Fs : we_s);
    float v = 0.f;
    for (int f = 0; f < F; ++f) v = fmaf(at_s[f], x[f], v);
    lin_s[i] = v;
  }

  // this thread's tile: sources kFi si + i, targets tj + nt j
  const int nt = (T + kFj - 1) / kFj;
  const int si = threadIdx.x / nt, tj = threadIdx.x % nt;
  const bool on = kFi * si < R;
  int sr[kFi], tr[kFj];
#pragma unroll
  for (int i = 0; i < kFi; ++i) sr[i] = min(kFi * si + i, R - 1);
#pragma unroll
  for (int j = 0; j < kFj; ++j) tr[j] = min(tj + nt * j, T - 1);
  float a[kFi][kFj], acc[kFi][kFj];
  if (on) {
#pragma unroll
    for (int i = 0; i < kFi; ++i)
#pragma unroll
      for (int j = 0; j < kFj; ++j) {
        a[i][j] = adj_s[sr[i] * T + tr[j]];
        acc[i][j] = 0.f;
      }
    // sum_f att |xl + xr + adj we|: per element an add, the edge's fma
    // and an fma with |pre|; four features a step from float4 loads
    for (int f = 0; f < F; f += 4) {
      float4 x[kFi], y[kFj];
#pragma unroll
      for (int i = 0; i < kFi; ++i)
        x[i] = *reinterpret_cast<const float4*>(xl_s + sr[i] * Fs + f);
#pragma unroll
      for (int j = 0; j < kFj; ++j)
        y[j] = *reinterpret_cast<const float4*>(xr_s + tr[j] * Fs + f);
      const float4 w = *reinterpret_cast<const float4*>(we_s + f);
      const float4 c = *reinterpret_cast<const float4*>(at_s + f);
#pragma unroll
      for (int i = 0; i < kFi; ++i)
#pragma unroll
        for (int j = 0; j < kFj; ++j) {
          acc[i][j] = fmaf(fabsf(fmaf(a[i][j], w.x, x[i].x + y[j].x)), c.x,
                           acc[i][j]);
          acc[i][j] = fmaf(fabsf(fmaf(a[i][j], w.y, x[i].y + y[j].y)), c.y,
                           acc[i][j]);
          acc[i][j] = fmaf(fabsf(fmaf(a[i][j], w.z, x[i].z + y[j].z)), c.z,
                           acc[i][j]);
          acc[i][j] = fmaf(fabsf(fmaf(a[i][j], w.w, x[i].w + y[j].w)), c.w,
                           acc[i][j]);
        }
    }
  }
  __syncthreads();  // the linear sums are written
  if (!on) return;
  // leaky(p) = (1 + ns) / 2 p + (1 - ns) / 2 |p|, and the linear part
  // sum_f att p = L_s + R_t + adj W
  const float lin_w = 0.5f * (1.f + ns), abs_w = 0.5f * (1.f - ns);
  const float W = lin_s[R + T];
#pragma unroll
  for (int i = 0; i < kFi; ++i) {
    const int s = kFi * si + i;
    if (s >= R) continue;
#pragma unroll
    for (int j = 0; j < kFj; ++j) {
      const int t = tj + nt * j;
      if (t >= T) continue;
      const float l = fmaf(a[i][j], W, lin_s[s] + lin_s[R + t]);
      out[(((size_t)b * S + s0 + s) * T + t) * K + k] =
          fmaf(lin_w, l, abs_w * acc[i][j]);
    }
  }
}

// strips of sources per (b, k) plane: as many as give the grid
// kFwdBlocksPerSm blocks per SM, with at most kFwdMaxRows sources (and at
// most 1024 threads) a strip and at least kFi
int fwd_strips(int B, int K, int S, int T, int nsm) {
  const int nt = (T + kFj - 1) / kFj;
  int rows = kFwdMaxRows;
  while (rows > kFi && ceil_div(rows, kFi) * nt > 1024) rows -= kFi;
  const int want = ceil_div(kFwdBlocksPerSm * nsm, B * K);
  const int lo = ceil_div(S, rows), hi = ceil_div(S, kFi);
  return want < lo ? lo : (want > hi ? hi : want);
}

struct FwdSplit {
  int nstrip, threads;
  size_t smem;
};

cudaError_t fwd_split(int B, int S, int T, int K, int F, FwdSplit* sp) {
  int nsm = 0;
  cudaError_t err = device_sms(&nsm);
  if (err != cudaSuccess) return err;
  sp->nstrip = fwd_strips(B > 0 ? B : 1, K > 0 ? K : 1, S, T, nsm);
  const int R = ceil_div(S, sp->nstrip);
  const int tiles = ceil_div(R, kFi) * ((T + kFj - 1) / kFj);
  sp->threads = 32 * ceil_div(tiles, 32);
  sp->smem = sizeof(float) * fwd_block_floats(R, T, F);
  return cudaSuccess;
}

// ---- backward ----

constexpr int kBwdWarps = 8;  // warps per block, one own row at a time each
// a side of a sample is split into chunks of at most kMaxRows own rows and
// at least kBwdWarps, so that a block holds at least one row per warp
constexpr int kMaxRows = 32;
// blocks of the grid per SM that the split aims for
constexpr int kBwdBlocksPerSm = 8;
// live pairs per group of lanes and step of a walk, walked kSub at a time
constexpr int kSrc = 8, kSub = 4;
static_assert(kSrc == 8, "the transposing butterfly reduces 8 sums");

// lanes that take a pair: 4 features each, at least 8 (the butterfly
// reduces 8 sums)
__host__ __device__ inline int bwd_lanes(int F) {
  return F <= 32 ? 8 : (F <= 64 ? 16 : 32);
}

// shared floats of a block that owns R rows of one side against the N of
// the other: the own rows and the other side [R + N, Fq], the warps' live
// lists [kBwdWarps, N] of 4 words, d_e, adj and the dadj sums [R, N | 1]
// each, and the reduction [2, kBwdWarps * 32 / bwd_lanes(F), F]
__host__ __device__ inline size_t bwd_block_floats(int R, int N, int F) {
  const size_t Fq = (size_t)((F + 3) & ~3), Np = (size_t)(N | 1);
  return ((size_t)R + N) * Fq + 4 * (size_t)kBwdWarps * N +
         3 * (size_t)R * Np + 2 * (size_t)kBwdWarps * (32 / bwd_lanes(F)) * F;
}

// One block of the backward: the own rows [r0, r0 + R) of sample b, sources
// (ROW: dxl, dadj, the dwe partial and the datt part sum_s xl GL + we GW)
// or targets (!ROW: dxr and the datt part sum_t xr GR), head by head.
template <bool ROW, int L>
__device__ __forceinline__ void bwd_block(
    float* smem, const float* __restrict__ xl, const float* __restrict__ xr,
    const float* __restrict__ adj, const float* __restrict__ we,
    const float* __restrict__ att, const float* __restrict__ de,
    float* __restrict__ dxl, float* __restrict__ dxr,
    float* __restrict__ dadj, float* __restrict__ pb, int b, int r0, int R,
    int S, int T, int K, int F, int wstride, float ns) {
  const int N = ROW ? T : S;  // the other side
  const int nown = ROW ? S : T;
  const int Fq = (F + 3) & ~3, Np = N | 1;
  float* own_s = smem;                        // [R, Fq]
  float* oth_s = own_s + (size_t)R * Fq;      // [N, Fq]
  int4* lst_s = (int4*)(oth_s + (size_t)N * Fq);  // [kBwdWarps, N]
  float* d_s = (float*)(lst_s + kBwdWarps * N);   // [R, Np]: d_e of the head
  float* a_s = d_s + (size_t)R * Np;          // [R, Np]: adj
  float* q_s = a_s + (size_t)R * Np;          // [R, Np]: dadj over heads
  float* red_s = q_s + (size_t)R * Np;  // [2, kBwdWarps * 32 / L, F]

  const int KF = K * F;
  const float* xown = (ROW ? xl : xr) + ((size_t)b * nown + r0) * KF;
  const float* xoth = (ROW ? xr : xl) + (size_t)b * N * KF;
  float* gown = (ROW ? dxl : dxr) + ((size_t)b * nown + r0) * KF;
  const float* adjb = adj + (size_t)b * S * T;
  const float* deb = de + (size_t)b * S * T * K;
  const bool vec = (F & 3) == 0 && aligned16(xl) && aligned16(xr);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int4* lst = lst_s + warp * N;

  // adj of the own rows by 4-byte cp.async, in order (a row block's rows
  // are contiguous; a column block reads runs of R targets per source)
  for (int i = threadIdx.x; i < R * N; i += blockDim.x) {
    const int r = ROW ? i / N : i % R, o = ROW ? i % N : i / R;
    copy4_async(a_s + r * Np + o, ROW ? adjb + (size_t)(r0 + r) * T + o
                                      : adjb + (size_t)o * T + r0 + r);
    if (ROW) q_s[r * Np + o] = 0.f;
  }

  for (int k = 0; k < K; ++k) {
    if (k > 0) __syncthreads();  // the previous head's tiles are read
    stage_rows(own_s, xown + k * F, KF, R, F, Fq, vec);
    stage_rows(oth_s, xoth + k * F, KF, N, F, Fq, vec);
    for (int i = threadIdx.x; i < R * N; i += blockDim.x) {
      const int r = ROW ? i / N : i % R, o = ROW ? i % N : i / R;
      copy4_async(d_s + r * Np + o,
                  ROW ? deb + ((size_t)(r0 + r) * T + o) * K + k
                      : deb + ((size_t)o * T + r0 + r) * K + k);
    }
    copy_async_wait_all();
    __syncthreads();

    // a group of L lanes takes a pair, a lane 4 features of it (one
    // float4 of the other row per pair)
    constexpr int G = 32 / L;  // groups per warp
    const int grp = lane / L, gl = lane % L, c4 = 4 * gl;
    const bool fon = c4 < F;
    const float* wb = we + (size_t)b * wstride + k * F;
    const float* ab = att + (size_t)b * wstride + k * F;
    float wev[4], awv[4], gw[4], ga[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int f = c4 + q;
      wev[q] = f < F ? wb[f] : 0.f;
      awv[q] = f < F ? ab[f] * wev[q] : 0.f;
      gw[q] = 0.f;
      ga[q] = 0.f;
    }

    for (int r = warp; r < R; r += kBwdWarps) {
      const float* dr = d_s + r * Np;
      const float* ar = a_s + r * Np;
      float xo[4] = {0.f, 0.f, 0.f, 0.f}, gs[4] = {0.f, 0.f, 0.f, 0.f};
      if (fon) {
        const float4 x =
            *reinterpret_cast<const float4*>(own_s + (size_t)r * Fq + c4);
        xo[0] = x.x;
        xo[1] = x.y;
        xo[2] = x.z;
        xo[3] = x.w;
      }
      // the row's live pairs (d_e != 0) compacted into lst in order, each
      // as (other row's offset, adj, d_e, other index): one load a pair
      int n = 0;
      for (int o0 = 0; o0 < N; o0 += 32) {
        const int o = o0 + lane;
        const float d = o < N ? dr[o] : 0.f;
        const bool live = d != 0.f;
        const unsigned ballot = __ballot_sync(0xffffffffu, live);
        if (live)
          lst[n + __popc(ballot & ((1u << lane) - 1u))] =
              make_int4(o * Fq, __float_as_int(ar[o]), __float_as_int(d), o);
        n += __popc(ballot);
      }
      __syncwarp();

      // the walk over the live pairs, kSrc per group and step, in halves
      // of kSub (group grp takes pairs k0 + kSrc grp + u): kSub independent
      // slope tests per feature and, for a row, kSrc partial dadj sums per
      // lane that one transposing butterfly over the group's L lanes
      // reduces. The slope test (xl + xr) >= -(adj we) holds exactly when
      // the plain version's pre = (xl + xr) + adj we >= 0 (for finite
      // operands without flush to zero a float sum is zero only when it is
      // exact), and pre itself is not needed: datt comes from the
      // separable sums. Pairs past the list repeat its first with a zero
      // gradient; a half that no group has is skipped.
      for (int k0 = 0; k0 < n; k0 += kSrc * G) {
        float p[kSrc];
#pragma unroll
        for (int u = 0; u < kSrc; ++u) p[u] = 0.f;
#pragma unroll
        for (int u0 = 0; u0 < kSrc; u0 += kSub) {
          if (u0 > 0 && k0 + u0 >= n) break;  // warp-uniform
          int oo[kSub];
          float au[kSub], du[kSub], dn[kSub];
#pragma unroll
          for (int v = 0; v < kSub; ++v) {
            const int kk = k0 + kSrc * grp + u0 + v;
            const int4 e = lst[kk < n ? kk : k0];
            oo[v] = e.x + c4;
            au[v] = __int_as_float(e.y);
            du[v] = kk < n ? __int_as_float(e.z) : 0.f;
            dn[v] = ns * du[v];
          }
          if (fon) {
#pragma unroll
            for (int v = 0; v < kSub; ++v) {
              const float4 y =
                  *reinterpret_cast<const float4*>(oth_s + oo[v]);
              const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float u = __fadd_rn(xo[q], yv[q]);
                const float g =
                    u >= -__fmul_rn(au[v], wev[q]) ? du[v] : dn[v];
                gs[q] += g;
                if (ROW) {
                  p[u0 + v] = fmaf(g, awv[q], p[u0 + v]);
                  gw[q] = fmaf(g, au[v], gw[q]);
                }
              }
            }
          }
        }
        if (ROW) {
          // after offsets L/2, L/4 and L/8 lane gl holds pair gl / (L/8)'s
          // partial over part of the group; the offsets below L/8 finish it
#pragma unroll
          for (int w = kSrc / 2, off = L / 2; w >= 1; w /= 2, off /= 2) {
            const bool hi = lane & off;
#pragma unroll
            for (int u = 0; u < w; ++u) {
              const float mine = hi ? p[u + w] : p[u];
              const float other = hi ? p[u] : p[u + w];
              p[u] = mine + __shfl_xor_sync(0xffffffffu, other, off);
            }
          }
#pragma unroll
          for (int off = L / 16; off >= 1; off /= 2)
            p[0] += __shfl_xor_sync(0xffffffffu, p[0], off);
          const int kk = k0 + kSrc * grp + gl / (L / 8);
          if (gl % (L / 8) == 0 && kk < n) q_s[r * Np + lst[kk].w] += p[0];
        }
      }
      // the groups' sums of the own row meet; its gradient, and its part
      // of the separable datt
#pragma unroll
      for (int off = L; off < 32; off *= 2)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          gs[q] += __shfl_xor_sync(0xffffffffu, gs[q], off);
      if (grp == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int f = c4 + q;
          if (f < F) {
            gown[(size_t)r * KF + k * F + f] = ab[f] * gs[q];
            ga[q] = fmaf(xo[q], gs[q], ga[q]);
          }
        }
      }
      __syncwarp();  // lst is rewritten by the next row
    }

    // the head's partials: the sums of each warp and group meet in shared
    // memory and are added in order
    const int nsum = kBwdWarps * G;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int f = c4 + q;
      if (f < F) {
        red_s[(warp * G + grp) * F + f] = gw[q];
        red_s[(nsum + warp * G + grp) * F + f] = ga[q];
      }
    }
    __syncthreads();
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
      float w = 0.f, a = 0.f;
      for (int i = 0; i < nsum; ++i) {
        w += red_s[i * F + f];
        a += red_s[(nsum + i) * F + f];
      }
      pb[(size_t)k * F + f] = ROW ? ab[f] * w : 0.f;
      pb[((size_t)K + k) * F + f] = ROW ? fmaf(wb[f], w, a) : a;
    }
  }
  if (ROW) {  // dadj summed over the heads; each warp wrote its own rows
    for (int r = warp; r < R; r += kBwdWarps)
      for (int o = lane; o < N; o += 32)
        dadj[((size_t)b * S + r0 + r) * T + o] = q_s[r * Np + o];
  }
}

template <int L>
__global__ void __launch_bounds__(kBwdWarps * 32, 4)
gat_logits_bwd_kernel(const float* __restrict__ xl,
                      const float* __restrict__ xr,
                      const float* __restrict__ adj,
                      const float* __restrict__ we,
                      const float* __restrict__ att,
                      const float* __restrict__ de, float* __restrict__ dxl,
                      float* __restrict__ dxr, float* __restrict__ dadj,
                      float* __restrict__ part, int S, int T, int K, int F,
                      int wstride, int nr, int nc, float ns) {
  extern __shared__ float4 bwd_smem4[];
  float* smem = reinterpret_cast<float*>(bwd_smem4);
  const int b = blockIdx.y;
  // this block's partials [2, K, F] of part [B, nr + nc, 2, K, F]
  float* pb = part + ((size_t)b * gridDim.x + blockIdx.x) * 2 * K * F;
  if ((int)blockIdx.x < nr) {
    const int c = blockIdx.x;
    const int r0 = (int)((long)c * S / nr), r1 = (int)((long)(c + 1) * S / nr);
    bwd_block<true, L>(smem, xl, xr, adj, we, att, de, dxl, dxr, dadj, pb,
                       b, r0, r1 - r0, S, T, K, F, wstride, ns);
  } else {
    const int c = blockIdx.x - nr;
    const int r0 = (int)((long)c * T / nc), r1 = (int)((long)(c + 1) * T / nc);
    bwd_block<false, L>(smem, xl, xr, adj, we, att, de, dxl, dxr, dadj, pb,
                        b, r0, r1 - r0, S, T, K, F, wstride, ns);
  }
}

typedef void (*BwdKernel)(const float*, const float*, const float*,
                          const float*, const float*, const float*, float*,
                          float*, float*, float*, int, int, int, int, int, int,
                          int, float);
// the instantiation for F features per head (F <= 4 bwd_lanes(F))
BwdKernel bwd_kernel(int F) {
  const int L = bwd_lanes(F);
  return L == 8 ? gat_logits_bwd_kernel<8>
                : (L == 16 ? gat_logits_bwd_kernel<16>
                           : gat_logits_bwd_kernel<32>);
}

// chunks of a side of n rows: as many as give the grid kBwdBlocksPerSm
// blocks per SM, within [n / kMaxRows, n / kBwdWarps] rounded up
int bwd_chunks(int want, int n) {
  const int lo = ceil_div(n, kMaxRows), hi = ceil_div(n, kBwdWarps);
  return want < lo ? lo : (want > hi ? hi : want);
}

struct BwdSplit {
  int nr, nc;
  size_t smem;
};

cudaError_t bwd_split(int B, int S, int T, int F, BwdSplit* sp) {
  int nsm = 0;
  cudaError_t err = device_sms(&nsm);
  if (err != cudaSuccess) return err;
  const int want = ceil_div(kBwdBlocksPerSm * nsm, 2 * (B > 0 ? B : 1));
  sp->nr = S > 0 ? bwd_chunks(want, S) : 0;
  sp->nc = T > 0 ? bwd_chunks(want, T) : 0;
  const size_t rows = sp->nr ? bwd_block_floats(ceil_div(S, sp->nr), T, F) : 0;
  const size_t cols = sp->nc ? bwd_block_floats(ceil_div(T, sp->nc), S, F) : 0;
  sp->smem = sizeof(float) * (rows > cols ? rows : cols);
  return cudaSuccess;
}

}  // namespace

extern "C" size_t gat_logits_fwd_smem_bytes(int B, int S, int T, int K,
                                           int F) {
  FwdSplit sp;
  if (fwd_split(B, S, T, K, F, &sp) != cudaSuccess) return (size_t)-1;
  return sp.smem;
}

extern "C" int gat_logits_fwd(const float* xl, const float* xr,
                              const float* adj, const float* we,
                              const float* att, float* out, int B, int S,
                              int T, int K, int F, int wstride, float ns,
                              void* stream) {
  if (F > kMaxF || (long)B * K > 65535) return (int)cudaErrorInvalidValue;
  if (B <= 0 || K <= 0 || S <= 0 || T <= 0) return (int)cudaGetLastError();
  FwdSplit sp;
  cudaError_t err = fwd_split(B, S, T, K, F, &sp);
  if (err != cudaSuccess) return (int)err;
  if (sp.threads > 1024) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(gat_logits_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sp.smem);
  if (err != cudaSuccess) return (int)err;
  gat_logits_fwd_kernel<<<dim3(sp.nstrip, B * K), sp.threads, sp.smem,
                          (cudaStream_t)stream>>>(
      xl, xr, adj, we, att, out, S, T, K, F, wstride, sp.nstrip, ns);
  return (int)cudaGetLastError();
}

// strips of sources per (b, k) plane that the forward's grid takes at
// these shapes on this card (-1 on an error)
extern "C" int gat_logits_fwd_strips(int B, int S, int T, int K) {
  FwdSplit sp;
  if (fwd_split(B, S, T, K, 1, &sp) != cudaSuccess) return -1;
  return sp.nstrip;
}

// what the forward's launch gets on this card at these shapes: registers
// and local (spill) bytes per thread, and resident blocks per SM (-1 on an
// error)
extern "C" int gat_logits_fwd_blocks_per_sm(int B, int S, int T, int K, int F,
                                            int* regs, int* local_bytes) {
  FwdSplit sp;
  cudaFuncAttributes attr;
  int n = 0;
  if (fwd_split(B, S, T, K, F, &sp) != cudaSuccess ||
      cudaFuncSetAttribute(gat_logits_fwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sp.smem) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, gat_logits_fwd_kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gat_logits_fwd_kernel,
                                                    sp.threads, sp.smem) !=
          cudaSuccess)
    return -1;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return n;
}

// blocks of the backward per sample (row blocks, then column blocks): the
// second dimension of its partials [B, parts, 2, K, F]; -1 on an error
extern "C" int gat_logits_bwd_parts(int B, int S, int T) {
  BwdSplit sp;
  if (bwd_split(B, S, T, 1, &sp) != cudaSuccess) return -1;
  return sp.nr + sp.nc;
}

extern "C" size_t gat_logits_bwd_smem_bytes(int B, int S, int T, int F) {
  BwdSplit sp;
  if (bwd_split(B, S, T, F, &sp) != cudaSuccess) return (size_t)-1;
  return sp.smem;
}

extern "C" int gat_logits_bwd(const float* xl, const float* xr,
                              const float* adj, const float* we,
                              const float* att, const float* de, float* dxl,
                              float* dxr, float* dadj, float* part, int B,
                              int S, int T, int K, int F, int wstride,
                              float ns, void* stream) {
  if (F > kMaxF || B > 65535) return (int)cudaErrorInvalidValue;
  if (B <= 0 || K <= 0 || S <= 0 || T <= 0) return (int)cudaGetLastError();
  BwdSplit sp;
  cudaError_t err = bwd_split(B, S, T, F, &sp);
  if (err != cudaSuccess) return (int)err;
  const BwdKernel kern = bwd_kernel(F);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sp.smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(sp.nr + sp.nc, B), kBwdWarps * 32, sp.smem,
         (cudaStream_t)stream>>>(xl, xr, adj, we, att, de, dxl, dxr, dadj,
                                 part, S, T, K, F, wstride, sp.nr, sp.nc, ns);
  return (int)cudaGetLastError();
}

// what the backward's launch gets on this card at these shapes: registers
// and local (spill) bytes per thread, and resident blocks per SM (-1 on an
// error)
extern "C" int gat_logits_bwd_blocks_per_sm(int B, int S, int T, int F,
                                            int* regs, int* local_bytes) {
  BwdSplit sp;
  cudaFuncAttributes attr;
  const BwdKernel kern = bwd_kernel(F);
  int n = 0;
  if (bwd_split(B, S, T, F, &sp) != cudaSuccess ||
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sp.smem) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kern) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kBwdWarps * 32,
                                                    sp.smem) != cudaSuccess)
    return -1;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return n;
}
