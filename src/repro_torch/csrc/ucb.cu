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
// K=20: ~96 MB, ~29 us at 3.35 TB/s.  On CLUB's path n = 1, and the launch
// itself is the cost.
//
// Design: one warp per user, four users per block, as choose.cu.  The warp
// stages its user's Minv, w and the K x d context block in shared memory
// with coalesced loads; lane k scores the candidates k, k + 32, ... with
// ucb_score (ucb_score.cuh), the FMA chain choose.cu runs, so the
// first-index argmax of a row of these scores is bit for bit choose's pick
// and identical candidate rows score identically.  Lanes write neighbouring
// scores of a row.  Shapes are logical: no padding of K or d.

#include <cuda_runtime.h>
#include <math.h>

#include "ucb_score.cuh"

namespace {

constexpr int kWarps = 4;

__global__ void ucb_kernel(const float* __restrict__ w,
                           const float* __restrict__ Minv,
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
  const float* Mu = Minv + (size_t)u * dd;
  const float* cu = ctx + (size_t)u * Kd;
  for (int i = lane; i < dd; i += 32) m_s[i] = Mu[i];
  for (int i = lane; i < d; i += 32) w_s[i] = w[(size_t)u * d + i];
  for (int i = lane; i < Kd; i += 32) c_s[i] = cu[i];
  __syncwarp();

  const float explore = ucb_explore(occ[u]);
  float* su = scores + (size_t)u * K;
  for (int k = lane; k < K; k += 32)
    su[k] = ucb_score(c_s + k * d, w_s, m_s, d, alpha, explore);
}

}  // namespace

extern "C" int ucb_launch(const float* w, const float* Minv, const float* ctx,
                          const int* occ, float alpha, int n, int K, int d,
                          float* scores, cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * (d * d + d + K * d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ucb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n + kWarps - 1) / kWarps;
  ucb_kernel<<<blocks, 32 * kWarps, smem, stream>>>(w, Minv, ctx, occ, alpha,
                                                    n, K, d, scores);
  return (int)cudaGetLastError();
}
