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
// A user with mask[u] == 0 is an identity update: its rows stay
// bit-identical (variants 0 and 1 write none of them; variant 2 writes
// back the very bits it loaded).  The state is updated
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
// Three variants; the wrapper picks one (kernels/rank1/ops.py, variant
// and inv_variant) and passes it to the launch as an int.
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
// Staged span (variant 2), the M-free update only, d <= 32, for many
// users (DistCLUB's rounds).  The warp variant copies a user one element
// a lane (2-byte loads for a bf16 Minv), so the bytes in flight on an SM
// fall with the element's width and the kernel waits on latency: its
// bf16 twin moved 48% fewer bytes in 16% less time.  Here a block takes
// a group of kSpanWarps consecutive users, whose Minv, x and b are three
// contiguous spans: every 16-byte cp.async of the group is issued before
// one wait (stage.cuh; a span starts 16-byte aligned only every 4 users
// in f32, 8 in bf16, so its copy sits at the source's offset mod 16 and
// its at most 2 (16 / sizeof(S) - 1) end elements go through registers).
// Warp v forms user v's Mx and denominator with warp_denom on the staged
// span (lanes 0..d-1, zeros above: the FMA chain and shuffle tree of
// variants 0 and 1, so the bits are theirs) and downdates the user's
// block in shared memory; the block writes the span back with 16-byte
// stores over its body.  d is a launch argument, not a template: one
// instantiation for each width spilled registers under the launch bounds.
// A block a group, six resident an SM (40 registers a thread,
// __launch_bounds__; six blocks' spans fit an SM's shared memory at every
// d <= 32): the card's scheduler refills an SM as its blocks finish, so
// one block's copies fly while others compute.  The M-ful update keeps
// variants 0 and 1.
//
// All round the division and subtraction as the plain version rounds
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
// aligned: variants 0 and 1 move one element a lane, never assuming wider
// alignment; variant 2 stages the bf16 bytes (widened as warp_denom and
// the store read them).  The bound falls with Minv's bytes: at n=20480,
// d=25, all live, ~57 MB, ~17 us (M-free) and ~160 MB, ~48 us (M-ful).

#include <cuda_runtime.h>

#include "stage.cuh"
#include "widen.cuh"

namespace {

constexpr int kWarps = 8;           // users a block, warp per user
constexpr int kBlockThreads = 256;  // block per user
constexpr int kBlockMaxD = 32;
constexpr int kPerThread = kBlockMaxD * kBlockMaxD / kBlockThreads;
constexpr int kSpanWarps = 8;       // staged span: users (warps) a block
constexpr int kSpanThreads = 32 * kSpanWarps;
constexpr int kSpanMaxD = 32;       // staged span: a user's rows on a warp
constexpr int kSpanMinBlocks = 6;   // staged span: blocks an SM, at least

// 1 + x.Minv x for one user, by one warp: lane i forms Mx_i = (Minv x)_i
// into mx_s as an in-order FMA chain over j, and a shuffle tree sums the
// lanes' parts of x.Mx.  Every variant calls it, so they round alike (m_s
// holds f32, or the staged span's bf16, widened as it is read).
template <typename T>
__device__ __forceinline__ float warp_denom(const T* m_s, const float* x_s,
                                            float* mx_s, int d, int lane) {
  float part = 0.f;
  for (int i = lane; i < d; i += 32) {
    const T* mrow = m_s + i * d;
    float t = 0.f;
    for (int j = 0; j < d; ++j) t = fmaf(widen(mrow[j]), x_s[j], t);
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

// ---- staged span (variant 2), the M-free update only ---------------------

// bytes of a span block's shared memory: its group's Minv span (in its
// storage type S), x and b spans, each region 16-byte aligned with room
// for the copy's shift, then for each user Mx (32 floats), r and the mask
template <typename S>
__host__ __device__ constexpr size_t span_bytes(int d) {
  return region_bytes<S>(kSpanWarps * d * d) +
         2 * region_bytes<float>(kSpanWarps * d) +
         4 * (size_t)kSpanWarps * 34;
}

// the position in its span of the c-th element outside the 16-byte body:
// the head's, then the tail's
__device__ __forceinline__ int end_pos(int c, int head, int body_end) {
  return c < head ? c : body_end + (c - head);
}

// Block g takes the kSpanWarps consecutive users from g * kSpanWarps.
// Every load is issued before the one wait: the Minv span's 16-byte body
// and the x and b spans by cp.async; the Minv span's at most
// 2 (16 / sizeof(S) - 1) end elements (a bf16 cannot move by cp.async
// alone), r and the mask of user t into this thread's registers, stored
// to shared memory after the wait.  (A) warp v forms user v's Mx and
// denominator with warp_denom, the FMA chain and shuffle tree of variants
// 0 and 1, on the staged span, writes b, and downdates the user's block in
// place in shared memory, a row at a time, lane j its column (Mx_j and the
// denominator in registers, Mx_i a broadcast); (B) the block copies the
// span back to device memory, 16-byte stores over its body and element
// stores at its ends.  Masked users: (A) skips them, so their staged
// elements keep the bits loaded, and (B) stores those very bits back
// (of the contract's two options, store back what was loaded, or store
// nothing; a word can hold up to 16 / sizeof(S) users' elements at small
// d, and a per-word test of their masks read slower on the card).  A
// group with no live user stores nothing.
template <typename S>
__global__ void __launch_bounds__(kSpanThreads, kSpanMinBlocks)
    rank1_span_kernel(S* __restrict__ Minv, float* __restrict__ b,
                      const float* __restrict__ x,
                      const float* __restrict__ r,
                      const unsigned char* __restrict__ mask, int n,
                      int d) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kPer = 16 / sizeof(S);
  const int dd = d * d;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  const int u0 = blockIdx.x * kSpanWarps;
  const int nu = min(kSpanWarps, n - u0);
  const int total = nu * dd;
  S* gm = Minv + (size_t)u0 * dd;
  const float* gx = x + (size_t)u0 * d;
  const float* gb = b + (size_t)u0 * d;

  // the regions: each span at its source's offset mod 16
  S* m_s = at_offset(reinterpret_cast<S*>(smem), gm);
  float* x_r = smem + region_bytes<S>(kSpanWarps * dd) / sizeof(float);
  float* b_r = x_r + region_bytes<float>(kSpanWarps * d) / sizeof(float);
  float* x_s = at_offset(x_r, gx);
  float* b_s = at_offset(b_r, gb);
  float* mx_s = b_r + region_bytes<float>(kSpanWarps * d) / sizeof(float);
  float* r_s = mx_s + 32 * kSpanWarps;
  int* live_s = reinterpret_cast<int*>(r_s + kSpanWarps);

  const int head = head_of(gm, total);
  const int body_end = head + (total - head) / kPer * kPer;
  const int ends = total - (body_end - head);
  for (int p = head + kPer * t; p < body_end; p += kPer * kSpanThreads)
    cp_async16(m_s + p, gm + p);
  stage(x_s, gx, nu * d, t, kSpanThreads);
  stage(b_s, gb, nu * d, t, kSpanThreads);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  S end_v{};
  float r_v = 0.f;
  int m_v = 0;
  if (t < ends) end_v = gm[end_pos(t, head, body_end)];
  if (t < nu) {
    r_v = r[u0 + t];
    m_v = mask[u0 + t];
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (t < ends) m_s[end_pos(t, head, body_end)] = end_v;
  if (t < nu) {
    r_s[t] = r_v;
    live_s[t] = m_v;
  }
  if (!__syncthreads_or(t < nu && m_v)) return;  // no live user: no store

  // (A) Mx, the denominator, b and the downdated block of each live user,
  // a warp each
  if (warp < nu && live_s[warp]) {  // the whole warp takes it or skips it
    const int v = warp;
    const float* xv = x_s + v * d;
    float* mx = mx_s + 32 * v;
    S* mv = m_s + v * dd;
    const float den = warp_denom(mv, xv, mx, d, lane);
    if (lane < d)
      b[(size_t)(u0 + v) * d + lane] =
          __fadd_rn(b_s[v * d + lane], __fmul_rn(r_s[v], xv[lane]));
    __syncwarp();
    if (lane < d) {
      const float mx_j = mx[lane];
#pragma unroll 4
      for (int i = 0; i < d; ++i)
        mv[i * d + lane] =
            narrow<S>(__fsub_rn(widen(mv[i * d + lane]),
                                __fdiv_rn(__fmul_rn(mx[i], mx_j), den)));
    }
  }
  __syncthreads();

  // (B) the span back: 16-byte words over its body, elements at its ends
  for (int p = head + kPer * t; p < body_end; p += kPer * kSpanThreads)
    *reinterpret_cast<uint4*>(gm + p) =
        *reinterpret_cast<const uint4*>(m_s + p);
  for (int c = t; c < ends; c += kSpanThreads) {
    const int e = end_pos(c, head, body_end);
    gm[e] = m_s[e];
  }
}

template <typename S>
int launch_span(S* Minv, float* b, const float* x, const float* r,
                const unsigned char* mask, int n, int d,
                cudaStream_t stream) {
  const size_t smem = span_bytes<S>(d);
  cudaError_t e = allow_smem(rank1_span_kernel<S>, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n + kSpanWarps - 1) / kSpanWarps;
  rank1_span_kernel<S><<<grid, kSpanThreads, smem, stream>>>(Minv, b, x, r,
                                                             mask, n, d);
  return (int)cudaGetLastError();
}

template <typename S, bool kWithM>
int launch(float* M, S* Minv, float* b, const float* x, const float* r,
           const unsigned char* mask, int n, int d, int variant,
           cudaStream_t stream) {
  if (variant == 2) {
    if constexpr (kWithM) {
      return (int)cudaErrorInvalidValue;
    } else {
      if (d < 1 || d > kSpanMaxD) return (int)cudaErrorInvalidValue;
      return launch_span(Minv, b, x, r, mask, n, d, stream);
    }
  }
  if (variant == 1) {
    if (d > kBlockMaxD) return (int)cudaErrorInvalidValue;
    rank1_block_kernel<S, kWithM><<<n, kBlockThreads, 0, stream>>>(
        M, Minv, b, x, r, mask, d);
    return (int)cudaGetLastError();
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarps * (d * d + 2 * d) * sizeof(float);
  cudaError_t e = allow_smem(rank1_kernel<S, kWithM>, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n + kWarps - 1) / kWarps;
  rank1_kernel<S, kWithM><<<grid, 32 * kWarps, smem, stream>>>(
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
