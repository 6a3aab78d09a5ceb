// Fused UCB choose for the bandit interaction rounds (stages 1 and 3).
//
// Replaces: src/repro/kernels/interact/interact.py, choose_pallas
//           (body _choose_kernel).
//
// Computes, per user u and candidate k < K:
//   s[k]      = ctx[u,k].w[u] + alpha sqrt(max(ctx[u,k] Minv[u] ctx[u,k], 0))
//                                     sqrt(log1p(occ[u]))
//   choice[u] = first-index argmax_k s[k]
//   x[u]      = ctx[u, choice[u]]
//
// Bound on an H100: memory.  Per user the kernel reads ctx (K d floats),
// Minv (d^2) and w (d) once and writes x (d) and choice; the arithmetic is
// about 2 K d^2 flops per user, far below the f32 rate for the bytes it
// reads.  At n=20480, d=25, K=20 that is ~96 MB, ~29 us at 3.35 TB/s.
//
// Every score runs the FMA chains of ucb_score.cuh in its order: t_i =
// sum_j Minv[i][j] c[j] (fmaf over j ascending from 0.f), then est and
// quad over i ascending, the bonus and the sum.  So identical candidate
// rows get bit-identical scores, the pick is the first-index argmax of
// ucb.cu's scores (either variant) bit for bit, and the two variants here
// pick the same candidate.  The [n, K] scores never reach device memory;
// the chosen row is copied from shared memory into x.
//
// Two variants; the wrapper picks one (kernels/interact/ops.py, geometry)
// and passes it, with the users a block, to the launch.
//
// Register tile (variant 1), d <= 32, one instantiation for each d (the
// rows' strides compile to immediates).  A block takes `users`
// consecutive users.  Their Minv, contexts and w are three contiguous
// spans of device memory: the block issues every 16-byte cp.async of the
// three before it waits (4-byte ones only at a span's unaligned ends; the
// copy in shared memory sits at the span's own offset mod 16 bytes), so
// one latency stages them all.  A thread then owns kTK = 2 candidates of
// one user and all d rows of Minv: for each j it loads c_k[j] for its
// candidates and Minv[i][j] for every row, and issues 2 d fmafs into a
// 2 x d register tile.  That is (2 + d) / (2 d) shared loads an FMA, 0.54
// at d = 25, where a lane that runs ucb_score alone issues 2.  The rows
// keep the device layout (stride d): a padded stride would need a
// per-element index remap in the copy that costs what vector loads would
// save.  Each thread then runs ucb_combine's order on its t columns and
// writes the scores to shared memory; a warp per user takes the
// first-index argmax.  Users a block come from the SM count (the
// wrapper): at the offline shape 12 users of 10 threads, four blocks an
// SM, so that some blocks copy while others compute; at serving's n = 256
// a block per user, so that every SM works.  Four candidates a thread
// (half the Minv loads) and resident blocks that copy the next group
// while scoring this one both read slower on the card: the copies and
// the FMAs need the warps of four blocks an SM.
//
// Warp per user (variant 0), four users a block, for the shapes the tile
// does not take (d > 32, more than kTileThreads threads a user, shared
// memory past the limit): the warp stages its user's Minv, w and the K x
// d context block in shared memory with coalesced loads, then each lane
// scores the candidates k = lane, lane + 32, ... with ucb_score, d^2 + d
// dependent FMAs each, two shared loads an FMA.
//
// Both variants reduce over (score, k), an equal score taking the smaller
// k.  Shapes are logical: no padding of K or d in device memory.
//
// bf16 Minv (choose_bf16_launch; Precision's state dtype, the bf16 case
// of choose_pallas, which widens it in VMEM): both variants, Minv read as
// bf16 and widened to f32 exactly (widen.cuh), so the FMA chains and the
// pick are the f32 kernel's on the widened Minv, bit for bit.  The warp
// variant widens as it stages Minv into its f32 region.  The register
// tile stages the bf16 bytes themselves, half the f32 span's (a user's
// block is 2 d^2 bytes, so only 2-byte aligned): 16-byte cp.async for
// the body at the source's own offset mod 16, and plain 2-byte copies for
// the at most 7 elements at each end (cp.async moves 4, 8 or 16 bytes);
// the FMA loop widens each element as it reads it from shared memory, in
// the same order.  Its Minv region is half as large (tile_bytes), so
// geometry's users a block may grow.  The bound falls with Minv's bytes:
// at n=20480, d=25, K=20, ~71 MB, ~21 us.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math.h>

#include "ucb_score.cuh"
#include "widen.cuh"

namespace {

constexpr int kWarps = 4;            // warp per user: users a block
constexpr int kTileMaxD = 32;        // register tile: largest d
constexpr int kTileThreads = 128;    // register tile: threads a block, at most
constexpr int kTK = 2;               // register tile: candidates a thread
constexpr size_t kMaxSmem = 232448;  // H100: 227 KB per block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// one element outside a span's 16-byte body: a 4-byte cp.async, or for a
// bf16 (cp.async moves 4, 8 or 16 bytes) a plain copy, which the block's
// barrier after cp.async.wait_all publishes as it does the async ones
__device__ __forceinline__ void copy_one(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_one(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src) {
  *dst = *src;
}

// src's offset past a 16-byte boundary, in elements of T
template <typename T>
__device__ __forceinline__ int shift_of(const T* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
}

// where the copy of src starts in a 16-byte aligned shared region (which
// holds 16 / sizeof(T) - 1 elements more than the copy): at src's own
// offset past a 16-byte boundary, so that both sides of every 16-byte
// copy are aligned
template <typename T>
__device__ __forceinline__ T* at_offset(T* region, const T* src) {
  return region + shift_of(src);
}

// issue the copy of n elements from src to dst = at_offset(region, src)
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n, int t,
                                      int T_) {
  constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte copy
  const int head = min(n, (kPer - shift_of(src)) % kPer);
  const int body = (n - head) / kPer;
  for (int e = t; e < head; e += T_) copy_one(dst + e, src + e);
  for (int q = t; q < body; q += T_)
    cp_async16(dst + head + kPer * q, src + head + kPer * q);
  for (int e = head + kPer * body + t; e < n; e += T_)
    copy_one(dst + e, src + e);
}

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// bytes of a shared region for n elements of T copied by stage: room for
// the copy's shift (16 / sizeof(T) - 1 elements), whole 16-byte words
template <typename T>
__host__ __device__ constexpr size_t region_bytes(int n) {
  return ((size_t)(n + 16 / sizeof(T) - 1) * sizeof(T) + 15) / 16 * 16;
}

// bytes of a register-tile block's shared memory: its users' Minv (in
// its storage type S), contexts and w, each region 16-byte aligned with
// room for the copy's shift, then the scores
template <typename S>
__host__ __device__ inline size_t tile_bytes(int users, int K, int d) {
  return region_bytes<S>(users * d * d) + region_bytes<float>(users * K * d) +
         region_bytes<float>(users * d) + 4 * (size_t)round4(users * K);
}

// the warp's first-index argmax from each lane's (best, best_k), where an
// equal score keeps the smaller k; every lane gets it
__device__ __forceinline__ int warp_first_max(float best, int best_k) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int ok = __shfl_xor_sync(0xffffffffu, best_k, off);
    if (ob > best || (ob == best && ok < best_k)) {
      best = ob;
      best_k = ok;
    }
  }
  return best_k;
}

template <typename S>
__global__ void choose_kernel(const float* __restrict__ w,
                              const S* __restrict__ Minv,
                              const float* __restrict__ ctx,
                              const int* __restrict__ occ, float alpha,
                              int n, int K, int d,
                              int* __restrict__ choice,
                              float* __restrict__ x) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int u = blockIdx.x * kWarps + warp;
  if (u >= n) return;  // the whole warp leaves together

  const int dd = d * d;
  const int Kd = K * d;
  float* m_s = smem + warp * (dd + d + Kd);
  float* w_s = m_s + dd;
  float* c_s = w_s + d;
  const S* Mu = Minv + (size_t)u * dd;
  const float* cu = ctx + (size_t)u * Kd;
  for (int i = lane; i < dd; i += 32) m_s[i] = widen(Mu[i]);
  for (int i = lane; i < d; i += 32) w_s[i] = w[(size_t)u * d + i];
  for (int i = lane; i < Kd; i += 32) c_s[i] = cu[i];
  __syncwarp();

  const float explore = ucb_explore(occ[u]);
  float best = -INFINITY;
  int best_k = INT_MAX;
  for (int k = lane; k < K; k += 32) {
    const float s = ucb_score(c_s + k * d, w_s, m_s, d, alpha, explore);
    if (best_k == INT_MAX || s > best) {  // k rises: ties keep the first
      best = s;
      best_k = k;
    }
  }
  best_k = warp_first_max(best, best_k);
  if (lane == 0) choice[u] = best_k;
  for (int j = lane; j < d; j += 32) x[(size_t)u * d + j] = c_s[best_k * d + j];
}

// ucb_combine's order for one candidate whose t_i sit in registers
template <int D>
__device__ __forceinline__ float combine(const float* c, const float* w_s,
                                         float alpha, float explore,
                                         const float (&t)[D]) {
  float est = 0.f;
  float quad = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    est = fmaf(c[i], w_s[i], est);
    quad = fmaf(c[i], t[i], quad);
  }
  const float bonus =
      __fmul_rn(__fmul_rn(alpha, sqrtf(fmaxf(quad, 0.f))), explore);
  return __fadd_rn(est, bonus);
}

template <int D, typename S>
__global__ void __launch_bounds__(kTileThreads)
    choose_tile_kernel(const float* __restrict__ w,
                       const S* __restrict__ Minv,
                       const float* __restrict__ ctx,
                       const int* __restrict__ occ, float alpha, int n,
                       int K, int users, int* __restrict__ choice,
                       float* __restrict__ x) {
  extern __shared__ __align__(16) float smem[];
  constexpr int d = D;
  constexpr int dd = D * D;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int Kd = K * d;
  const int u0 = blockIdx.x * users;
  const int nu = min(users, n - u0);
  // regions: Minv | contexts | w | scores, carved in floats from smem
  // (a carve through a byte pointer ran the f32 tile slower on the card)
  S* m_r = reinterpret_cast<S*>(smem);
  float* c_r = smem + region_bytes<S>(users * dd) / sizeof(float);
  float* w_r = c_r + region_bytes<float>(users * Kd) / sizeof(float);
  float* s_r = w_r + region_bytes<float>(users * d) / sizeof(float);

  // every copy of the three spans in flight, then one wait
  const S* sm = Minv + (size_t)u0 * dd;
  const float* sc = ctx + (size_t)u0 * Kd;
  const float* sw = w + (size_t)u0 * d;
  S* m_all = at_offset(m_r, sm);
  float* c_all = at_offset(c_r, sc);
  float* w_all = at_offset(w_r, sw);
  stage(m_all, sm, nu * dd, t, T);
  stage(c_all, sc, nu * Kd, t, T);
  stage(w_all, sw, nu * d, t, T);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // thread t: user t / P, candidates kTK (t % P) + a for a < kTK (the
  // last one again past K)
  const int P = (K + kTK - 1) / kTK;
  const int uu = t / P;
  if (uu < nu) {
    const int kb = kTK * (t - uu * P);
    const S* m_s = m_all + uu * dd;
    const float* cr[kTK];
#pragma unroll
    for (int a = 0; a < kTK; ++a)
      cr[a] = c_all + uu * Kd + min(kb + a, K - 1) * d;
    float tt[kTK][D];
#pragma unroll
    for (int a = 0; a < kTK; ++a)
#pragma unroll
      for (int i = 0; i < D; ++i) tt[a][i] = 0.f;
    int j = 0;
    for (; j + 4 <= d; j += 4) {
      float cv[kTK][4];
#pragma unroll
      for (int a = 0; a < kTK; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) cv[a][q] = cr[a][j + q];
      const S* pm = m_s + j;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const S* r = pm + i * d;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float m = widen(r[q]);
#pragma unroll
          for (int a = 0; a < kTK; ++a)
            tt[a][i] = fmaf(m, cv[a][q], tt[a][i]);
        }
      }
    }
    for (; j < d; ++j) {
      float cv[kTK];
#pragma unroll
      for (int a = 0; a < kTK; ++a) cv[a] = cr[a][j];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float m = widen(m_s[i * d + j]);
#pragma unroll
        for (int a = 0; a < kTK; ++a) tt[a][i] = fmaf(m, cv[a], tt[a][i]);
      }
    }
    const float explore = ucb_explore(occ[u0 + uu]);
    const float* w_s = w_all + uu * d;
#pragma unroll
    for (int a = 0; a < kTK; ++a)
      if (kb + a < K)
        s_r[uu * K + kb + a] = combine<D>(cr[a], w_s, alpha, explore, tt[a]);
  }
  __syncthreads();

  const int warp = t / 32;
  const int lane = t % 32;
  for (int v = warp; v < nu; v += T / 32) {
    const float* sv = s_r + v * K;
    float best = -INFINITY;
    int best_k = INT_MAX;
    for (int k = lane; k < K; k += 32) {
      if (best_k == INT_MAX || sv[k] > best) {  // as the warp variant
        best = sv[k];
        best_k = k;
      }
    }
    best_k = warp_first_max(best, best_k);
    const size_t u = (size_t)u0 + v;
    if (lane == 0) choice[u] = best_k;
    const float* cb = c_all + v * Kd + best_k * d;
    for (int jj = lane; jj < d; jj += 32) x[u * d + jj] = cb[jj];
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D, typename S>
int launch_tile(const float* w, const S* Minv, const float* ctx,
                const int* occ, float alpha, int n, int K, int d, int users,
                int* choice, float* x, cudaStream_t stream) {
  if constexpr (D < kTileMaxD) {
    if (d != D)   // one instantiation for each d <= kTileMaxD
      return launch_tile<D + 1>(w, Minv, ctx, occ, alpha, n, K, d, users,
                                choice, x, stream);
  }
  const size_t smem = tile_bytes<S>(users, K, D);
  cudaError_t e = allow_smem(choose_tile_kernel<D, S>, smem);
  if (e != cudaSuccess) return (int)e;
  const int P = (K + kTK - 1) / kTK;
  const int threads = (users * P + 31) / 32 * 32;
  const int blocks = (n + users - 1) / users;
  choose_tile_kernel<D, S><<<blocks, threads, smem, stream>>>(
      w, Minv, ctx, occ, alpha, n, K, users, choice, x);
  return (int)cudaGetLastError();
}

template <typename S>
int launch(const float* w, const S* Minv, const float* ctx, const int* occ,
           float alpha, int n, int K, int d, int variant, int users,
           int* choice, float* x, cudaStream_t stream) {
  if (variant == 1) {
    const int P = (K + kTK - 1) / kTK;
    if (d < 1 || d > kTileMaxD || users < 1 || users * P > kTileThreads)
      return (int)cudaErrorInvalidValue;
    return launch_tile<1>(w, Minv, ctx, occ, alpha, n, K, d, users, choice,
                          x, stream);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarps * (d * d + d + K * d) * sizeof(float);
  cudaError_t e = allow_smem(choose_kernel<S>, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + kWarps - 1) / kWarps;
  choose_kernel<S><<<blocks, 32 * kWarps, smem, stream>>>(
      w, Minv, ctx, occ, alpha, n, K, d, choice, x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int choose_launch(const float* w, const float* Minv,
                             const float* ctx, const int* occ, float alpha,
                             int n, int K, int d, int variant, int users,
                             int* choice, float* x, cudaStream_t stream) {
  return launch(w, Minv, ctx, occ, alpha, n, K, d, variant, users, choice, x,
                stream);
}

extern "C" int choose_bf16_launch(const float* w, const __nv_bfloat16* Minv,
                                  const float* ctx, const int* occ,
                                  float alpha, int n, int K, int d,
                                  int variant, int users, int* choice,
                                  float* x, cudaStream_t stream) {
  return launch(w, Minv, ctx, occ, alpha, n, K, d, variant, users, choice, x,
                stream);
}
