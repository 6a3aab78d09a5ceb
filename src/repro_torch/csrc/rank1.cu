// Masked Sherman-Morrison rank-1 updates of the bandit state, IN PLACE.
//
// Replaces: src/repro/kernels/rank1/rank1.py
//   rank1_update_inv_pallas (body _rank1_inv_kernel): the M-free update
//   of DistCLUB's rounds (rank1_update_inv_launch);
//   rank1_update_pallas (body _rank1_kernel): the M-ful update of CLUB's
//   user and cluster rows (rank1_update_launch).
//
// For every user u with mask[u] != 0:
//   Mx      = Minv[u] x[u]
//   denom   = 1 + x[u].Mx
//   Minv[u] = Minv[u] - Mx Mx^T / denom
//   M[u]    = M[u] + x[u] x[u]^T            (M-ful variant only)
//   b[u]    = b[u] + r[u] x[u]
// A user with mask[u] == 0 is an identity update, and the kernel writes
// none of its rows, so they stay bit-identical.  The state is updated
// in place: the caller hands it over and gets it back modified (the
// wrapper returns the same tensors).  A leading-dim slice of a state
// tensor (one user's row, as CLUB updates) is a valid argument.
//
// Bound on an H100: memory.  The M-free update reads and writes Minv once
// (2 d^2 floats per live user) plus b, x and r; the M-ful one also reads
// and writes M (4 d^2 floats per live user).  About 4-7 d^2 flops per user
// is nothing beside that.  At n=20480, d=25, all users live: ~109 MB,
// ~32 us (M-free) and ~211 MB, ~63 us (M-ful) at 3.35 TB/s.  On CLUB's
// path n = 1, and the launch itself is the cost.
//
// Two variants; the wrapper picks one (kernels/rank1/ops.py, variant) and
// passes it to the launch as an int.
//
// Warp per user (variant 0), eight users per block, for many users: the
// warp copies the user's Minv (d^2 contiguous floats) and x into shared
// memory with coalesced loads; lane i forms (Minv x)_i from shared memory,
// a warp shuffle sums x.Mx, and the warp writes the downdated Minv back
// with coalesced stores; M is read, updated and written in one coalesced
// pass (its new value needs only x).
//
// Block per user (variant 1), for fewer users than the card has room for
// (CLUB's n = 1) and d <= 32.  There a warp per user is one warp's chain
// of dependent trips to memory (mask, then Minv, then M, then r); here
// the block's 256 threads start every load of the user's state in one
// round: each its <= 4 elements of Minv and of M, threads < d x and b,
// and r and mask.  The mask gates the stores, not the loads.  M' needs
// only x and is stored first; Minv goes to shared memory, where warp 0
// forms Mx and the denominator by the same FMA chain and shuffle tree as
// variant 0 (warp_denom), so the two variants give the same bits.
//
// Both round the division and subtraction as the plain version rounds
// them (outer product, then / denom, then subtract; x_i x_j, then add).
//
// bf16 Minv (rank1_update_inv_bf16_launch and rank1_update_bf16_launch;
// Precision's state dtype, the bf16 case of rank1_update_inv_pallas and
// of rank1_update_pallas): either update, in both variants, with Minv
// stored in bf16 (M, b and x stay f32).  Each element is widened to f32 as
// it is loaded (exact), the math runs in f32 in the order above, and
// the new value is rounded to bf16 to nearest even (__float2bfloat16_rn,
// as the plain version's f32 -> bf16 copy and repro's astype round).  A
// user's block is 2 d^2 bytes (1250 at d = 25), so rows are only 2-byte
// aligned: the copies move one element a lane, never assuming wider
// alignment.  The bound falls with Minv's bytes: at n=20480, d=25, all
// live, ~57 MB, ~17 us (M-free) and ~160 MB, ~48 us (M-ful).

#include <cuda_runtime.h>

#include "widen.cuh"

namespace {

constexpr int kWarps = 8;           // users a block, warp per user
constexpr int kBlockThreads = 256;  // block per user
constexpr int kBlockMaxD = 32;
constexpr int kPerThread = kBlockMaxD * kBlockMaxD / kBlockThreads;

// 1 + x.Minv x for one user, by one warp: lane i forms Mx_i = (Minv x)_i
// into mx_s as an in-order FMA chain over j, and a shuffle tree sums the
// lanes' parts of x.Mx.  Both variants call it, so they round alike.
__device__ __forceinline__ float warp_denom(const float* m_s,
                                            const float* x_s, float* mx_s,
                                            int d, int lane) {
  float part = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float* mrow = m_s + i * d;
    float t = 0.f;
    for (int j = 0; j < d; ++j) t = fmaf(mrow[j], x_s[j], t);
    mx_s[i] = t;
    part = fmaf(x_s[i], t, part);
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  return 1.f + part;
}

template <typename S, bool kWithM>
__global__ void rank1_kernel(float* __restrict__ M, S* __restrict__ Minv,
                             float* __restrict__ b,
                             const float* __restrict__ x,
                             const float* __restrict__ r,
                             const unsigned char* __restrict__ mask, int n,
                             int d) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int u = blockIdx.x * kWarps + warp;
  if (u >= n || mask[u] == 0) return;  // the whole warp leaves together

  const int dd = d * d;
  float* m_s = smem + warp * (dd + 2 * d);
  float* x_s = m_s + dd;
  float* mx_s = x_s + d;
  S* Mu = Minv + (size_t)u * dd;
  for (int e = lane; e < dd; e += 32) m_s[e] = widen(Mu[e]);
  for (int i = lane; i < d; i += 32) x_s[i] = x[(size_t)u * d + i];
  __syncwarp();

  const float denom = warp_denom(m_s, x_s, mx_s, d, lane);
  __syncwarp();

  for (int e = lane; e < dd; e += 32) {
    const int i = e / d;
    const int j = e - i * d;
    Mu[e] = narrow<S>(
        __fsub_rn(m_s[e], __fdiv_rn(__fmul_rn(mx_s[i], mx_s[j]), denom)));
  }
  if (kWithM) {
    float* Gu = M + (size_t)u * dd;
    for (int e = lane; e < dd; e += 32) {
      const int i = e / d;
      const int j = e - i * d;
      Gu[e] = __fadd_rn(Gu[e], __fmul_rn(x_s[i], x_s[j]));
    }
  }
  const float ru = r[u];
  float* bu = b + (size_t)u * d;
  for (int j = lane; j < d; j += 32)
    bu[j] = __fadd_rn(bu[j], __fmul_rn(ru, x_s[j]));
}

template <typename S, bool kWithM>
__global__ void __launch_bounds__(kBlockThreads)
    rank1_block_kernel(float* __restrict__ M, S* __restrict__ Minv,
                       float* __restrict__ b, const float* __restrict__ x,
                       const float* __restrict__ r,
                       const unsigned char* __restrict__ mask, int d) {
  __shared__ float m_s[kBlockMaxD * kBlockMaxD];
  __shared__ float x_s[kBlockMaxD];
  __shared__ float mx_s[kBlockMaxD];
  __shared__ float denom_s;
  const int u = blockIdx.x;
  const int t = threadIdx.x;
  const int dd = d * d;
  S* Mu = Minv + (size_t)u * dd;
  float* Gu = kWithM ? M + (size_t)u * dd : nullptr;
  float* bu = b + (size_t)u * d;

  // one round of loads: everything the block reads
  const bool live = mask[u] != 0;
  const float ru = r[u];
  float mi[kPerThread], g[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = t + k * kBlockThreads;
    if (e < dd) {
      mi[k] = widen(Mu[e]);
      if (kWithM) g[k] = Gu[e];
    }
  }
  float xv = 0.f, bv = 0.f;
  if (t < d) {
    xv = x[(size_t)u * d + t];
    bv = bu[t];
    x_s[t] = xv;
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = t + k * kBlockThreads;
    if (e < dd) m_s[e] = mi[k];
  }
  __syncthreads();
  if (!live) return;  // the whole block leaves: nothing is written

  if (kWithM) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int e = t + k * kBlockThreads;
      if (e < dd) {
        const int i = e / d;
        Gu[e] = __fadd_rn(g[k], __fmul_rn(x_s[i], x_s[e - i * d]));
      }
    }
  }
  if (t < 32) {
    const float denom = warp_denom(m_s, x_s, mx_s, d, t);
    if (t == 0) denom_s = denom;
  }
  __syncthreads();
  const float denom = denom_s;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = t + k * kBlockThreads;
    if (e < dd) {
      const int i = e / d;
      Mu[e] = narrow<S>(__fsub_rn(
          mi[k], __fdiv_rn(__fmul_rn(mx_s[i], mx_s[e - i * d]), denom)));
    }
  }
  if (t < d) bu[t] = __fadd_rn(bv, __fmul_rn(ru, xv));
}

template <typename S, bool kWithM>
int launch(float* M, S* Minv, float* b, const float* x, const float* r,
           const unsigned char* mask, int n, int d, int variant,
           cudaStream_t stream) {
  if (variant == 1) {
    if (d > kBlockMaxD) return (int)cudaErrorInvalidValue;
    rank1_block_kernel<S, kWithM><<<n, kBlockThreads, 0, stream>>>(
        M, Minv, b, x, r, mask, d);
    return (int)cudaGetLastError();
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarps * (d * d + 2 * d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rank1_kernel<S, kWithM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n + kWarps - 1) / kWarps;
  rank1_kernel<S, kWithM><<<blocks, 32 * kWarps, smem, stream>>>(
      M, Minv, b, x, r, mask, n, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rank1_update_inv_launch(float* Minv, float* b, const float* x,
                                       const float* r,
                                       const unsigned char* mask, int n, int d,
                                       int variant, cudaStream_t stream) {
  return launch<float, false>(nullptr, Minv, b, x, r, mask, n, d, variant,
                              stream);
}

extern "C" int rank1_update_inv_bf16_launch(__nv_bfloat16* Minv, float* b,
                                            const float* x, const float* r,
                                            const unsigned char* mask, int n,
                                            int d, int variant,
                                            cudaStream_t stream) {
  return launch<__nv_bfloat16, false>(nullptr, Minv, b, x, r, mask, n, d,
                                      variant, stream);
}

extern "C" int rank1_update_launch(float* M, float* Minv, float* b,
                                   const float* x, const float* r,
                                   const unsigned char* mask, int n, int d,
                                   int variant, cudaStream_t stream) {
  return launch<float, true>(M, Minv, b, x, r, mask, n, d, variant, stream);
}

extern "C" int rank1_update_bf16_launch(float* M, __nv_bfloat16* Minv,
                                        float* b, const float* x,
                                        const float* r,
                                        const unsigned char* mask, int n,
                                        int d, int variant,
                                        cudaStream_t stream) {
  return launch<__nv_bfloat16, true>(M, Minv, b, x, r, mask, n, d, variant,
                                     stream);
}
