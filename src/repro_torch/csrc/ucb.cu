// UCB score matrix for a batch of users (CLUB's per-interaction scoring).
//
// Replaces: src/repro/kernels/ucb/ucb.py, ucb_scores_pallas
//           (body _ucb_kernel).
//
// Computes, per user u and candidate k < K:
//   scores[u,k] = ctx[u,k].w[u]
//                 + alpha sqrt(max(ctx[u,k] Minv[u] ctx[u,k], 0)) sqrt(log1p(occ[u]))
// and writes the [n, K] f32 matrix; there is no argmax here (choose.cu
// fuses that one in).
//
// Bound on an H100: memory.  Per user the kernel reads ctx (K d floats),
// Minv (d^2), w (d) and occ once and writes K scores; about 2 K d^2 flops
// per user is far below the f32 rate for those bytes.  At n=20480, d=25,
// K=20: ~96 MB, ~29 us at 3.35 TB/s.  On CLUB's path n = 1: 4.6 KB and
// 2.6e4 operations, ~1.4 ns; the launch itself (~5 us) is the cost, and
// then the chain of dependent steps a score takes.
//
// Three variants; the wrapper picks one (kernels/ucb/ops.py, variant)
// and passes it, with the users a block of the register tile, to the
// launch as ints.  All score every candidate with the FMA chains of
// ucb_score.cuh (ucb_t, then ucb_combine), the chains choose.cu runs, so
// the first-index argmax of a row is bit for bit choose's pick, identical
// candidate rows score identically, and the variants give the same bits
// for the same row.
//
// Register tile (variant 2), d <= 32 where kernels/interact/ops.py
// geometry takes the shape (a user's ceil(K / 2) threads within a block
// of 128): choose's tile itself (ucb_tile.cuh), with the scores written
// out instead of reduced to an argmax.  A block takes geometry's users
// a block, stages their Minv, contexts and w as three spans with every
// 16-byte cp.async in flight before one wait, and scores them on the
// 2 x d register tile, (2 + d) / (2 d) shared loads an FMA (0.54 at d =
// 25) where the warp variant's lane issues 2.  The block's users x K
// scores are one contiguous span of the output: the block writes it from
// shared memory with coalesced stores.  The warp variant spent its time
// on those shared loads (d^2 + d dependent FMAs a lane, only K = 20 of
// 32 lanes working), not on the bytes.
//
// Warp per user (variant 0), four users per block, for the shapes
// neither other variant takes (d > 32, K past the tile's threads), as
// choose.cu: the warp stages its user's Minv, w and the K x d context
// block in shared memory with coalesced loads; lane k scores candidates
// k, k + 32, ... with ucb_score, d^2 + d dependent FMAs each.  Lanes
// write neighbouring scores of a row.
//
// Block per user (variant 1), for fewer users than the card has room for
// (CLUB's n = 1) and d <= 32.  There a warp per user is one warp's
// lane-strided staging (a load feeding a store, 20 + 16 rounds at CLUB's
// shape) and then one lane's ~650-FMA chain a score.  Here the block's
// 256 threads issue every load of the user's Minv, w, contexts and occ in
// one round (kLoads a thread before any store to shared memory: 5 at
// CLUB's shape); then the K d values t[k][i] = ucb_t(Minv row i, c_k)
// are independent chains, one a thread, into shared memory; then thread
// k runs ucb_combine on its t[k][.]: ~2d dependent FMAs after d, where
// the warp variant has d^2 + d.  Loads are 4 bytes: CLUB's one-row view
// of the cluster state starts at any multiple of d^2 floats, rarely 16-
// byte aligned.  Shapes are logical: no padding of K or d.
//
// bf16 Minv (ucb_bf16_launch; Precision's state dtype, the bf16 case of
// ucb_scores_pallas, whose dot_general promotes it to f32): every variant
// with Minv read as bf16 and widened to f32 exactly (widen.cuh), so the
// scores are bit for bit the f32 kernel's on the widened Minv.  The warp
// and block variants read one element a load (a user's block is 2 d^2
// bytes, so only 2-byte aligned) and widen it as they store it to shared
// memory; the tile stages the bf16 bytes and widens as it reads.  The
// bound falls with Minv's bytes: at n=20480, d=25, K=20, ~70 MB, ~21 us.

#include <cuda_runtime.h>
#include <math.h>

#include "ucb_score.cuh"
#include "ucb_tile.cuh"
#include "widen.cuh"

namespace {

constexpr int kWarps = 4;           // users a block, warp per user
constexpr int kBlockThreads = 256;  // block per user
constexpr int kBlockMaxD = 32;
constexpr int kLoads = 8;           // loads a thread issues in one round

template <typename S>
__global__ void ucb_kernel(const float* __restrict__ w,
                           const S* __restrict__ Minv,
                           const float* __restrict__ ctx,
                           const int* __restrict__ occ, float alpha, int n,
                           int K, int d, float* __restrict__ scores) {
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
  float* su = scores + (size_t)u * K;
  for (int k = lane; k < K; k += 32)
    su[k] = ucb_score(c_s + k * d, w_s, m_s, d, alpha, explore);
}

template <typename S>
__global__ void __launch_bounds__(kBlockThreads)
    ucb_block_kernel(const float* __restrict__ w,
                     const S* __restrict__ Minv,
                     const float* __restrict__ ctx,
                     const int* __restrict__ occ, float alpha, int K, int d,
                     float* __restrict__ scores) {
  extern __shared__ float smem[];
  const int u = blockIdx.x;
  const int t = threadIdx.x;
  const int dd = d * d;
  const int Kd = K * d;
  // shared: Minv | w | contexts, in the order of the loads, then t[k][i]
  float* m_s = smem;
  float* w_s = m_s + dd;
  float* c_s = w_s + d;
  float* t_s = c_s + Kd;
  const S* Mu = Minv + (size_t)u * dd;
  const float* wu = w + (size_t)u * d;
  const float* cu = ctx + (size_t)u * Kd;

  // every load in one round (more rounds only past kLoads a thread)
  const int o = occ[u];
  const int total = dd + d + Kd;
  for (int base = 0; base < total; base += kLoads * kBlockThreads) {
    float v[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int e = base + t + q * kBlockThreads;
      if (e < dd)
        v[q] = widen(Mu[e]);
      else if (e < dd + d)
        v[q] = wu[e - dd];
      else if (e < total)
        v[q] = cu[e - dd - d];
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int e = base + t + q * kBlockThreads;
      if (e < total) smem[e] = v[q];
    }
  }
  __syncthreads();

  // t[k][i]: K d independent chains, one a thread
  for (int e = t; e < Kd; e += kBlockThreads) {
    const int k = e / d;
    const int i = e - k * d;
    t_s[e] = ucb_t(m_s + i * d, c_s + k * d, d);
  }
  __syncthreads();

  const float explore = ucb_explore(o);
  float* su = scores + (size_t)u * K;
  for (int k = t; k < K; k += kBlockThreads) {
    const float* tk = t_s + k * d;
    su[k] = ucb_combine(c_s + k * d, w_s, d, alpha, explore,
                        [&](int i) { return tk[i]; });
  }
}

// choose's register tile, its scores written out: the block's users x K
// scores are one contiguous span of the output
template <int D, typename S>
__global__ void __launch_bounds__(kTileThreads)
    ucb_tile_kernel(const float* __restrict__ w, const S* __restrict__ Minv,
                    const float* __restrict__ ctx,
                    const int* __restrict__ occ, float alpha, int n, int K,
                    int users, float* __restrict__ scores) {
  extern __shared__ __align__(16) float smem[];
  const TileSpans<S> sp = tile_stage<D, S>(smem, w, Minv, ctx, n, K, users);
  tile_scores<D, S>(sp, occ, alpha, K);
  __syncthreads();
  float* out = scores + (size_t)sp.u0 * K;
  for (int e = threadIdx.x; e < sp.nu * K; e += blockDim.x) out[e] = sp.s[e];
}

template <int D, typename S>
int launch_tile(const float* w, const S* Minv, const float* ctx,
                const int* occ, float alpha, int n, int K, int d, int users,
                float* scores, cudaStream_t stream) {
  if constexpr (D < kTileMaxD) {
    if (d != D)   // one instantiation for each d <= kTileMaxD
      return launch_tile<D + 1>(w, Minv, ctx, occ, alpha, n, K, d, users,
                                scores, stream);
  }
  const size_t smem = tile_bytes<S>(users, K, D);
  cudaError_t e = allow_smem(ucb_tile_kernel<D, S>, smem);
  if (e != cudaSuccess) return (int)e;
  const int P = (K + kTK - 1) / kTK;
  const int threads = (users * P + 31) / 32 * 32;
  const int blocks = (n + users - 1) / users;
  ucb_tile_kernel<D, S><<<blocks, threads, smem, stream>>>(
      w, Minv, ctx, occ, alpha, n, K, users, scores);
  return (int)cudaGetLastError();
}

template <typename S>
int launch(const float* w, const S* Minv, const float* ctx, const int* occ,
           float alpha, int n, int K, int d, int variant, int users,
           float* scores, cudaStream_t stream) {
  cudaError_t e;
  if (variant == 2) {
    const int P = (K + kTK - 1) / kTK;
    if (d < 1 || d > kTileMaxD || users < 1 || users * P > kTileThreads)
      return (int)cudaErrorInvalidValue;
    return launch_tile<1>(w, Minv, ctx, occ, alpha, n, K, d, users, scores,
                          stream);
  }
  if (variant == 1) {
    if (d > kBlockMaxD) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(d * d + d + 2 * K * d) * sizeof(float);
    if ((e = allow_smem(ucb_block_kernel<S>, smem)) != cudaSuccess)
      return (int)e;
    ucb_block_kernel<S><<<n, kBlockThreads, smem, stream>>>(
        w, Minv, ctx, occ, alpha, K, d, scores);
    return (int)cudaGetLastError();
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarps * (d * d + d + K * d) * sizeof(float);
  if ((e = allow_smem(ucb_kernel<S>, smem)) != cudaSuccess) return (int)e;
  const int blocks = (n + kWarps - 1) / kWarps;
  ucb_kernel<S><<<blocks, 32 * kWarps, smem, stream>>>(w, Minv, ctx, occ,
                                                       alpha, n, K, d, scores);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ucb_launch(const float* w, const float* Minv, const float* ctx,
                          const int* occ, float alpha, int n, int K, int d,
                          int variant, int users, float* scores,
                          cudaStream_t stream) {
  return launch(w, Minv, ctx, occ, alpha, n, K, d, variant, users, scores,
                stream);
}

extern "C" int ucb_bf16_launch(const float* w, const __nv_bfloat16* Minv,
                               const float* ctx, const int* occ, float alpha,
                               int n, int K, int d, int variant, int users,
                               float* scores, cudaStream_t stream) {
  return launch(w, Minv, ctx, occ, alpha, n, K, d, variant, users, scores,
                stream);
}
