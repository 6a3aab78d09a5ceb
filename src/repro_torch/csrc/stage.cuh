// Staging a contiguous span of device memory in shared memory with
// cp.async, shared by choose.cu and ucb.cu (their register tile, through
// ucb_tile.cuh) and rank1.cu (its staged-span update).
//
// A span (a group of consecutive users' Minv, contexts, w, x or b) starts
// wherever its first user does, rarely on a 16-byte boundary: a user's
// Minv block is 4 d^2 bytes in f32 and 2 d^2 in bf16.  The copy in shared
// memory sits at the span's own offset mod 16 bytes (at_offset), so that
// both sides of every 16-byte copy are aligned.  The span's body moves in
// 16-byte cp.async; only its unaligned head and tail, at most 16 /
// sizeof(T) - 1 elements at each end, move one element at a time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

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

// the elements of an n-element span at src before its first 16-byte
// boundary: its head, which moves one element at a time
template <typename T>
__device__ __forceinline__ int head_of(const T* src, int n) {
  constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte copy
  return min(n, (kPer - shift_of(src)) % kPer);
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
  const int head = head_of(src, n);
  const int body = (n - head) / kPer;
  for (int e = t; e < head; e += T_) copy_one(dst + e, src + e);
  for (int q = t; q < body; q += T_)
    cp_async16(dst + head + kPer * q, src + head + kPer * q);
  for (int e = head + kPer * body + t; e < n; e += T_)
    copy_one(dst + e, src + e);
}

// bytes of a shared region for n elements of T copied by stage: room for
// the copy's shift (16 / sizeof(T) - 1 elements), whole 16-byte words
template <typename T>
__host__ __device__ constexpr size_t region_bytes(int n) {
  return ((size_t)(n + 16 / sizeof(T) - 1) * sizeof(T) + 15) / 16 * 16;
}

// let the kernel take `bytes` of dynamic shared memory (past 48 KB only
// on request)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
