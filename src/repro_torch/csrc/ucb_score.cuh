// The UCB score of one candidate, shared by choose.cu and ucb.cu.
//
//   score = c.w + alpha sqrt(max(c Minv c, 0)) explore,
//   explore = sqrt(log1p(occ))
//
// c, w and Minv (row-major d x d) lie in shared memory.  The FMA chain
// runs in one fixed order, so identical candidate rows get bit-identical
// scores, and a kernel that writes the scores (ucb.cu) agrees bit for bit
// with the kernel that only takes their first-index argmax (choose.cu).
#pragma once

#include <math.h>

__device__ __forceinline__ float ucb_explore(int occ) {
  return sqrtf(log1pf((float)occ));
}

__device__ __forceinline__ float ucb_score(const float* c, const float* w_s,
                                           const float* m_s, int d,
                                           float alpha, float explore) {
  float est = 0.f;
  float quad = 0.f;
  for (int i = 0; i < d; ++i) {
    est = fmaf(c[i], w_s[i], est);
    float t = 0.f;
    const float* mrow = m_s + i * d;
    for (int j = 0; j < d; ++j) t = fmaf(mrow[j], c[j], t);
    quad = fmaf(c[i], t, quad);
  }
  const float bonus =
      __fmul_rn(__fmul_rn(alpha, sqrtf(fmaxf(quad, 0.f))), explore);
  return __fadd_rn(est, bonus);
}
