// Minv's storage type to f32 and back, for the kernels that read or
// update the bandit state (choose.cu, ucb.cu, rank1.cu, topk.cu).
//
// Minv is f32 or bf16 (Precision's state dtype).  A kernel widens each
// element to f32 as it loads it, which is exact for a bf16, runs its math
// in f32, and (rank1.cu) rounds a new value back to nearest even, as the
// plain versions' f32 -> bf16 copy and repro's astype round.  So a
// kernel's f32 result on a bf16 Minv is bit for bit its result on the
// f32 widening of that Minv.
#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename S>
__device__ __forceinline__ S narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
