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
#pragma once

#include <math.h>

#include "widen.cuh"

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
      __fmul_rn(__fmul_rn(alpha, sqrtf(fmaxf(quad, 0.f))), explore);
  return __fadd_rn(est, bonus);
}

// c, w and Minv (row-major d x d) lie in shared memory.
__device__ __forceinline__ float ucb_score(const float* c, const float* w_s,
                                           const float* m_s, int d,
                                           float alpha, float explore) {
  return ucb_combine(c, w_s, d, alpha, explore,
                     [&](int i) { return ucb_t(m_s + i * d, c, d); });
}
