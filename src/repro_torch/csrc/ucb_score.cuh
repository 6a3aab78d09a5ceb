// The UCB score of one candidate, shared by choose.cu and ucb.cu.
//
//   score = c.w + alpha sqrt(max(c Minv c, 0)) explore,
//   explore = sqrt(log1p(occ))
//
// Two pieces: ucb_t, the row chain t_i = sum_j Minv[i][j] c[j] (fmaf over
// j ascending from 0), and ucb_combine, the epilogue that folds the t_i
// into quad = sum_i c_i t_i and est = sum_i c_i w_i (fmaf over i
// ascending) and forms the bonus and the sum.  ucb_score is their
// composition.  Every caller runs the same FMAs in the same order, so
// identical candidate rows get bit-identical scores, and a kernel that
// writes the scores (ucb.cu, either variant) agrees bit for bit with the
// kernel that only takes their first-index argmax (choose.cu).
//
// Non-finite scores follow repro (jnp.maximum and jnp.argmax): a NaN quad
// stays NaN under the max with 0 (quad_floor; fmaxf alone would give 0
// and a finite score), and the pick is argmax's (pick_key,
// warp_first_max): the first NaN if any score is NaN, else the first
// maximum, so -inf ties keep the first index and an all -inf user picks
// 0.  csrc/choose.cu and csrc/choose_tc.cu take the pick from here, and
// every scoring epilogue (those, csrc/ucb_tile.cuh, csrc/topk.cu and
// csrc/topk_tc.cu) quad_floor.
#pragma once

#include <math.h>

#include "widen.cuh"

// max(quad, 0) as jnp.maximum and torch.clamp_min take it: NaN stays NaN
// (max.NaN, one instruction as fmaxf's max is); every other value is
// fmaxf's, so finite scores keep their bits (a chain from 0.f never ends
// at -0.0, the one value whose sign a max may choose).
__device__ __forceinline__ float quad_floor(float quad) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(quad));
  return r;
}

// A score as an int in jnp.argmax's order: a NaN above every number
// (INT_MAX), -0.0 equal to 0.0 (s + 0.f), the rest by value (the
// order-preserving encoding of the float's bits).  A pick takes the
// largest key, and the smaller k among equal keys.
__device__ __forceinline__ int pick_key(float s) {
  const int i = __float_as_int(s + 0.f);
  return isnan(s) ? 0x7fffffff : i >= 0 ? i : i ^ 0x7fffffff;
}

// The warp's pick from each lane's (key, k) (a lane with no candidate
// holds (INT_MIN, INT_MAX)).  Every k is a different candidate, so the
// order is total and every lane gets the same pick.
__device__ __forceinline__ int warp_first_max(int key, int k) {
  for (int off = 16; off > 0; off >>= 1) {
    const int ok_key = __shfl_xor_sync(0xffffffffu, key, off);
    const int ok = __shfl_xor_sync(0xffffffffu, k, off);
    if (ok_key > key || (ok_key == key && ok < k)) {
      key = ok_key;
      k = ok;
    }
  }
  return k;
}

__device__ __forceinline__ float ucb_explore(int occ) {
  return sqrtf(log1pf((float)occ));
}

// t_i for one row of Minv (``mrow``, d floats) and candidate c.
__device__ __forceinline__ float ucb_t(const float* mrow, const float* c,
                                       int d) {
  float t = 0.f;
  for (int j = 0; j < d; ++j) t = fmaf(mrow[j], c[j], t);
  return t;
}

// The score of candidate c from its t_i (``t_of(i)``, taken in i order).
template <typename TOf>
__device__ __forceinline__ float ucb_combine(const float* c,
                                             const float* w_s, int d,
                                             float alpha, float explore,
                                             TOf t_of) {
  float est = 0.f;
  float quad = 0.f;
  for (int i = 0; i < d; ++i) {
    est = fmaf(c[i], w_s[i], est);
    quad = fmaf(c[i], t_of(i), quad);
  }
  const float bonus =
      __fmul_rn(__fmul_rn(alpha, sqrtf(quad_floor(quad))), explore);
  return __fadd_rn(est, bonus);
}

// c, w and Minv (row-major d x d) lie in shared memory.
__device__ __forceinline__ float ucb_score(const float* c, const float* w_s,
                                           const float* m_s, int d,
                                           float alpha, float explore) {
  return ucb_combine(c, w_s, d, alpha, explore,
                     [&](int i) { return ucb_t(m_s + i * d, c, d); });
}
