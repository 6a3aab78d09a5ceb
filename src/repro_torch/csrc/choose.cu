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
// Design: one warp per user, four users per block.  The warp stages its
// user's Minv, w and the K x d context block in shared memory with
// coalesced loads (the rows of ctx are d floats apart; d odd keeps the
// per-lane row reads free of bank conflicts), then each lane scores the
// candidates k = lane, lane + 32, ... in registers.  Every candidate goes
// through the same loop in the same order (ucb_score.cuh, shared with
// ucb.cu), so identical candidate rows get bit-identical scores.  A
// warp-shuffle reduction over (score, k), where
// an equal score takes the smaller k, gives the first-index argmax; the
// [n, K] scores never reach device memory.  The chosen row is copied from
// shared memory into x.  Shapes are logical: no padding of K or d.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>

#include "ucb_score.cuh"

namespace {

constexpr int kWarps = 4;

__global__ void choose_kernel(const float* __restrict__ w,
                              const float* __restrict__ Minv,
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
  const float* Mu = Minv + (size_t)u * dd;
  const float* cu = ctx + (size_t)u * Kd;
  for (int i = lane; i < dd; i += 32) m_s[i] = Mu[i];
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
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int ok = __shfl_xor_sync(0xffffffffu, best_k, off);
    if (ob > best || (ob == best && ok < best_k)) {
      best = ob;
      best_k = ok;
    }
  }
  if (lane == 0) choice[u] = best_k;
  for (int j = lane; j < d; j += 32) x[(size_t)u * d + j] = c_s[best_k * d + j];
}

}  // namespace

extern "C" int choose_launch(const float* w, const float* Minv,
                             const float* ctx, const int* occ, float alpha,
                             int n, int K, int d, int* choice, float* x,
                             cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * (d * d + d + K * d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        choose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n + kWarps - 1) / kWarps;
  choose_kernel<<<blocks, 32 * kWarps, smem, stream>>>(w, Minv, ctx, occ,
                                                        alpha, n, K, d,
                                                        choice, x);
  return (int)cudaGetLastError();
}
