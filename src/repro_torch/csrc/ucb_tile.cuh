// The register tile that scores a block of consecutive users' candidates,
// shared by choose.cu (choose_tile_kernel, which reduces the scores to
// the first-index argmax) and ucb.cu (ucb_tile_kernel, which writes them
// out).  One body, so that choose's pick and ucb's scores keep coming
// from the same FMAs.
//
// d <= 32, one instantiation for each d (the rows' strides compile to
// immediates).  A block takes `users` consecutive users.  Their Minv,
// contexts and w are three contiguous spans of device memory:
// tile_stage issues every 16-byte cp.async of the three (stage.cuh)
// before it waits, so one latency stages them all.  tile_scores then
// gives a thread kTK = 2 candidates of one user and all d rows of Minv:
// for each j it loads c_k[j] for its candidates and Minv[i][j] for every
// row, and issues 2 d fmafs into a 2 x d register tile.  That is (2 + d)
// / (2 d) shared loads an FMA, 0.54 at d = 25, where a lane that runs
// ucb_score alone issues 2.  The rows keep the device layout (stride d):
// a padded stride would need a per-element index remap in the copy that
// costs what vector loads would save.  Each thread then runs
// ucb_combine's order on its t columns (combine) and writes the scores
// to the block's scores region, [users][K].
//
// The FMAs are ucb_score.cuh's chains in its order: t_i = sum_j Minv[i][j]
// c[j] (fmaf over j ascending from 0.f), then est and quad over i
// ascending, the bonus and the sum.  So identical candidate rows get
// bit-identical scores, and every kernel that runs ucb_score.cuh's
// chains (ucb's warp and block variants, choose's warp variant) gives the
// same bits for the same row.
//
// bf16 Minv: the tile stages the bf16 bytes themselves, half the f32
// span's (a user's block is 2 d^2 bytes, so only 2-byte aligned): 16-byte
// cp.async for the body at the source's own offset mod 16, and plain
// 2-byte copies for the at most 7 elements at each end; the FMA loop
// widens each element as it reads it from shared memory (widen.cuh), in
// the same order, so the scores are the f32 tile's on the widened Minv.
// Its Minv region is half as large (tile_bytes).  choose on a bf16 Minv
// at d <= 32 and K <= 64 takes csrc/choose_tc.cu's tensor-core filter
// instead (kernels/interact/ops.py route); ucb's scores and every other
// choose stay on this tile.
#pragma once

#include <math.h>

#include "stage.cuh"
#include "ucb_score.cuh"
#include "widen.cuh"

namespace {

constexpr int kTileMaxD = 32;        // register tile: largest d
constexpr int kTileThreads = 128;    // register tile: threads a block, at most
constexpr int kTK = 2;               // register tile: candidates a thread

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// bytes of a register-tile block's shared memory: its users' Minv (in
// its storage type S), contexts and w, each region 16-byte aligned with
// room for the copy's shift, then the scores
template <typename S>
__host__ __device__ inline size_t tile_bytes(int users, int K, int d) {
  return region_bytes<S>(users * d * d) + region_bytes<float>(users * K * d) +
         region_bytes<float>(users * d) + 4 * (size_t)round4(users * K);
}

// ucb_combine's order for one candidate whose t_i sit in registers
template <int D>
__device__ __forceinline__ float combine(const float* c, const float* w_s,
                                         float alpha, float explore,
                                         const float (&t)[D]) {
  float est = 0.f;
  float quad = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    est = fmaf(c[i], w_s[i], est);
    quad = fmaf(c[i], t[i], quad);
  }
  const float bonus =
      __fmul_rn(__fmul_rn(alpha, sqrtf(quad_floor(quad))), explore);
  return __fadd_rn(est, bonus);
}

// a tile block's staged spans in shared memory, each at its source's
// offset mod 16, and its scores region [users][K]
template <typename S>
struct TileSpans {
  const S* m;       // Minv, users x d x d
  const float* c;   // contexts, users x K x d
  const float* w;   // w, users x d
  float* s;         // scores, users x K
  int u0;           // the block's first user
  int nu;           // its users (fewer in the last block)
};

// carve the block's shared memory and stage its users' three spans: every
// copy in flight, then one wait and the block's barrier
template <int D, typename S>
__device__ __forceinline__ TileSpans<S> tile_stage(
    float* smem, const float* __restrict__ w, const S* __restrict__ Minv,
    const float* __restrict__ ctx, int n, int K, int users) {
  constexpr int d = D;
  constexpr int dd = D * D;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int Kd = K * d;
  const int u0 = blockIdx.x * users;
  const int nu = min(users, n - u0);
  // regions: Minv | contexts | w | scores, carved in floats from smem
  // (a carve through a byte pointer ran the f32 tile slower on the card)
  S* m_r = reinterpret_cast<S*>(smem);
  float* c_r = smem + region_bytes<S>(users * dd) / sizeof(float);
  float* w_r = c_r + region_bytes<float>(users * Kd) / sizeof(float);
  float* s_r = w_r + region_bytes<float>(users * d) / sizeof(float);

  // every copy of the three spans in flight, then one wait
  const S* sm = Minv + (size_t)u0 * dd;
  const float* sc = ctx + (size_t)u0 * Kd;
  const float* sw = w + (size_t)u0 * d;
  S* m_all = at_offset(m_r, sm);
  float* c_all = at_offset(c_r, sc);
  float* w_all = at_offset(w_r, sw);
  stage(m_all, sm, nu * dd, t, T);
  stage(c_all, sc, nu * Kd, t, T);
  stage(w_all, sw, nu * d, t, T);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  return {m_all, c_all, w_all, s_r, u0, nu};
}

// every candidate's score into sp.s; the caller's barrier publishes them
template <int D, typename S>
__device__ __forceinline__ void tile_scores(const TileSpans<S>& sp,
                                            const int* __restrict__ occ,
                                            float alpha, int K) {
  constexpr int d = D;
  constexpr int dd = D * D;
  const int t = threadIdx.x;
  const int Kd = K * d;
  // thread t: user t / P, candidates kTK (t % P) + a for a < kTK (the
  // last one again past K)
  const int P = (K + kTK - 1) / kTK;
  const int uu = t / P;
  if (uu < sp.nu) {
    const int kb = kTK * (t - uu * P);
    const S* m_s = sp.m + uu * dd;
    const float* cr[kTK];
#pragma unroll
    for (int a = 0; a < kTK; ++a)
      cr[a] = sp.c + uu * Kd + min(kb + a, K - 1) * d;
    float tt[kTK][D];
#pragma unroll
    for (int a = 0; a < kTK; ++a)
#pragma unroll
      for (int i = 0; i < D; ++i) tt[a][i] = 0.f;
    int j = 0;
    for (; j + 4 <= d; j += 4) {
      float cv[kTK][4];
#pragma unroll
      for (int a = 0; a < kTK; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) cv[a][q] = cr[a][j + q];
      const S* pm = m_s + j;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const S* r = pm + i * d;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float m = widen(r[q]);
#pragma unroll
          for (int a = 0; a < kTK; ++a)
            tt[a][i] = fmaf(m, cv[a][q], tt[a][i]);
        }
      }
    }
    for (; j < d; ++j) {
      float cv[kTK];
#pragma unroll
      for (int a = 0; a < kTK; ++a) cv[a] = cr[a][j];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float m = widen(m_s[i * d + j]);
#pragma unroll
        for (int a = 0; a < kTK; ++a) tt[a][i] = fmaf(m, cv[a], tt[a][i]);
      }
    }
    const float explore = ucb_explore(occ[sp.u0 + uu]);
    const float* w_s = sp.w + uu * d;
#pragma unroll
    for (int a = 0; a < kTK; ++a)
      if (kb + a < K)
        sp.s[uu * K + kb + a] = combine<D>(cr[a], w_s, alpha, explore, tt[a]);
  }
}

}  // namespace
