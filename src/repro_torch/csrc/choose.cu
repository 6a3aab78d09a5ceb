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
// Register tile (variant 1), d <= 32: ucb_tile.cuh's tile (tile_stage,
// tile_scores) writes the block's scores to shared memory, and a warp per
// user takes their first-index argmax.  Users a block come from the SM
// count (the wrapper): at the offline shape 12 users of 10 threads, four
// blocks an SM, so that some blocks copy while others compute; at
// serving's n = 256 a block per user, so that every SM works.  Four
// candidates a thread (half the Minv loads) and resident blocks that copy
// the next group while scoring this one both read slower on the card: the
// copies and the FMAs need the warps of four blocks an SM.
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
// variant widens as it stages Minv into its f32 region; the register
// tile stages the bf16 bytes and widens as it reads (ucb_tile.cuh).  Its
// Minv region is half as large (tile_bytes), so geometry's users a block
// may grow.  The bound falls with Minv's bytes: at n=20480, d=25, K=20,
// ~71 MB, ~21 us.  kernels/interact/ops.py route sends a bf16 Minv at d
// <= 32 and K <= 64 to csrc/choose_tc.cu's tensor-core filter, which
// picks what the register tile picks; these variants serve a bf16 Minv
// elsewhere and stand beside the filter as its yardstick.
//
// Non-finite scores (repro's jnp.maximum and jnp.argmax): a NaN quad
// gives a NaN score (ucb_score.cuh quad_floor), and the pick is argmax's:
// the first NaN index if any score of the user is NaN, else the first
// index of the maximum, so -inf ties keep the first index and an all
// -inf user picks 0.  Both variants' lanes keep their (key, k) in that
// order (ucb_score.cuh pick_key) and warp_first_max, the one
// reduction of choose.cu and choose_tc.cu, leaves every lane the same
// pick, so x is ctx[choice] copied through the pick the warp agreed on.
// x is ctx[choice] also where repro's one-hot gather would spread a NaN
// of a candidate that was not picked (0 times inf or NaN): repro's own
// docstring defines x so (ROADMAP.md, queue 3, a departure kept).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math.h>

#include "ucb_score.cuh"
#include "ucb_tile.cuh"
#include "widen.cuh"

namespace {

constexpr int kWarps = 4;            // warp per user: users a block

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
  int best = INT_MIN;  // below every key
  int best_k = INT_MAX;
  for (int k = lane; k < K; k += 32) {
    const int key = pick_key(
        ucb_score(c_s + k * d, w_s, m_s, d, alpha, explore));
    if (key > best) {  // k rises: ties keep the first, NaNs the first NaN
      best = key;
      best_k = k;
    }
  }
  best_k = warp_first_max(best, best_k);
  if (lane == 0) choice[u] = best_k;
  for (int j = lane; j < d; j += 32) x[(size_t)u * d + j] = c_s[best_k * d + j];
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
  const TileSpans<S> sp = tile_stage<D, S>(smem, w, Minv, ctx, n, K, users);
  tile_scores<D, S>(sp, occ, alpha, K);
  __syncthreads();

  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int Kd = K * d;
  const int warp = t / 32;
  const int lane = t % 32;
  for (int v = warp; v < sp.nu; v += T / 32) {
    const float* sv = sp.s + v * K;
    int best = INT_MIN;
    int best_k = INT_MAX;
    for (int k = lane; k < K; k += 32) {
      const int key = pick_key(sv[k]);
      if (key > best) {  // as the warp variant
        best = key;
        best_k = k;
      }
    }
    best_k = warp_first_max(best, best_k);
    const size_t u = (size_t)sp.u0 + v;
    if (lane == 0) choice[u] = best_k;
    const float* cb = sp.c + v * Kd + best_k * d;
    for (int jj = lane; jj < d; jj += 32) x[u * d + jj] = cb[jj];
  }
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
