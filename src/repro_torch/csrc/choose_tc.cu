// Fused UCB choose on a bf16 Minv, at d <= 32 and K <= 64: the
// tensor-core filter ahead of the exact chain (the engines' bf16-state
// rounds, Precision's state dtype).
//
// Replaces: src/repro/kernels/interact/interact.py, choose_pallas
//           (body _choose_kernel), on a bf16 Minv (:39-41, :97), at d <=
//           32 and K <= 64; csrc/choose.cu's register tile
//           (choose_bf16_launch, variant 1) stays launchable beside it as
//           its yardstick, and serves every other shape.
//
// Computes csrc/choose.cu's (choice, x) bit for bit: per user u the
// first-index argmax over k < K of
//   s[k] = ctx[u,k].w[u] + alpha sqrt(max(ctx[u,k] Minv[u] ctx[u,k], 0))
//                                  sqrt(log1p(occ[u]))
// by ucb_score.cuh's chains in their order, and x[u] = ctx[u, choice[u]].
// What differs is which candidates reach the chains.
//
// Bound on an H100: bytes.  A user's Minv (2 d^2), contexts (4 K d) and
// w (4 d) are read once, choice and x written: ~71 MB, ~21 us at n =
// 20480, d = 25, K = 20.  The register tile scores every candidate on the
// CUDA cores (n K d^2 FMAs, about 0.54 shared loads and 0.5 widens an
// FMA) and copies a block's spans before it scores them, so issue time
// and the copy add up (PERF.md section 6, row 1b).  Here the tensor cores
// bound every candidate, the chains run only for the candidates that can
// still win, and the next group's spans are in flight while a group is
// filtered.
//
// Layout.  Persistent blocks of 8 warps (grid from the SM count and the
// occupancy, kernels/interact/ops.py) walk groups of kUsers = 8
// consecutive users, a warp each.  A ring of two stages in shared memory
// holds a group's three spans (Minv bf16, contexts, w): at the top of
// each round the block waits for the group it is about to filter and
// issues the copy of its next group into the other stage.  Where the
// three spans start on 16 bytes and are whole 16-byte words (a group of 8
// users is 16 d^2, 32 K d and 32 d bytes, so every full group of an
// aligned tensor), thread 0 issues three bulk copies (cp.async.bulk, the
// tensor memory accelerator) that complete on the stage's mbarrier; else
// (views such as ctx[1:], a ragged last group) every thread stages them
// by stage.cuh's cp.async (16 bytes at each span's own offset mod 16,
// single elements at its head and tail).  The bulk copies took the
// per-thread staging loops off the issue slots: 0.0450 ms on the card
// where cp.async read 0.0474 (PERF.md section 6, PR 35).  A wait that
// never completes traps rather than hangs.
//
// Product (warp per user).  The user's K contexts form ceil(K / 16) row
// tiles of 16 (rows past K zero), taken a pair at a time and, within the
// pair, a tile at a time (its fragments and accumulator live only there);
// each f32 row x is split as csrc/topk_tc.cu repack_split splits the
// catalog's f32 rows: ahi = bf16(x), alo = bf16(x - ahi), two features a
// conversion, straight into the m16n8k16 A fragments (lane (g, t) holds
// features 16 ks + 8 h + 2t + {0, 1} of rows g and g + 8), so no A tile
// passes through shared memory.  B is the user's Minv as its one bf16
// piece, B[j][i] = M[i][j], read from the staged bytes (a pair of
// elements is one aligned word, or a funnel shift of two where the lane's
// rows start at an odd element: a user's block is 2 d^2 bytes), with w's
// hi and lo pieces in columns 30 and 31 where d <= 30.  mma.sync m16n8k16
// bf16, f32 accumulation: T = ahi M + alo M (per accumulator: ahi's two
// k-steps, then alo's), 16 a tile.  The code is kept free of branches
// between the loads and the product (rows past K are masked, not
// skipped), so that the compiler can overlap the user's shuffle
// reductions (|M|_F, |w|) with the product: a build with those branches
// read 0.0550 ms on the card in the turns where this one read 0.0484
// (PERF.md section 6, PR 35).
//
// Epilogue (topk_tc.cu's for f32 items, but for one thing): q~ = sum_i
// x_i T_i with x the row itself, kept in registers from the split, where
// topk_tc.cu multiplies by the pieces' sum a; e~ = T_30 + T_31 (d <= 30)
// or sum_i x_i w_i (d = 31, 32); two rounds of shuffles leave lane (g, t)
// candidate 8t + g of the pair.  Then
//   UB = (e~ + E_est) + alpha sqrt(q~ + E) ex          (alpha >= 0)
//   LB = (e~ - E_est) + alpha sqrt(max(q~ - E, 0)) ex
// every operation rounded up for UB and down for LB (the root by sqrt_up
// and sqrt_down), the two roots swapped where alpha < 0; E = kQRel F en2 +
// kAbs (en2 + 1) and E_est = kERelTc W en + kAbs (en + 1) with F >= |M|_F,
// W >= |w|, en2 >= |x|^2 and en >= |x| rounded up; a row with a nonzero
// |x_j| < 2^-102, or with |x|^2 past kHuge, gets en2 = inf.  UB and LB are
// NaN where q~ or e~ is not finite.  (On the card x in registers read
// 0.0475 ms where a from the fragments read 0.0493: PERF.md, PR 35.)
//
// Bound, derived.  topk_tc.cu's header, "f32 items", holds term for term
// with x in place of a in the epilogue, and the split enters once: |x' M a
// - x' M x| = |x' M (a - x)| <= 2^-16 A (there 2 2^-16 + 2^-32, a' M a
// being formed); the accumulation 68 2^-23 p A, the epilogue g_10 p (1 +
// 1e-5) A and the chain 3.82e-6 A as there: |q~ - quad| <= 2.79e-5 A,
// under Q_EPS_F32 (4.32e-5); kQRel covers it 8.7 times.  est: 4.09e-5
// sum |x_j| |w_j| from the tensor cores (E_EPS_TC_F32) and g_10 + g_d =
// 2.5e-6 on the CUDA cores; kERelTc on both.  So quad lies in [q~ - E, q~
// + E] and est in [e~ - E_est, e~ + E_est], and the chain's score, the
// round-to-nearest of a function monotone in each (explore computed as
// the chain computes it), lies in [LB, UB].  kernels/interact/ref.py
// choose_filter_ref is this in torch, with the product summed in each
// order of kernels/topk/ref.py tc_sum.
//
// Survivors.  Candidate k survives if !(UB_k < max_j LB_j) (j < K), so a
// NaN passes.  The winner survives (its score >= every LB_j, <= its UB);
// a dropped candidate's score < max_j LB_j <= some survivor's score, so
// it can neither win nor tie.  A user with a non-finite UB or LB, or with
// |M|_F or |w| past kHuge, keeps all K.  A lone survivor is therefore the
// pick (at K = 1 the register tile's too, whatever its score) and is not
// rescored: about 95% of users at the offline shape.
//
// Rescore (the warp, 32 of its user's survivors a round, where two or
// more survive).  The warp lists them in k order as (k, UB, LB), then runs
// ucb_score.cuh's chain in its order: every t_i = sum_j Minv[i][j] c[j]
// (fmaf over j ascending from 0.f) of the round's survivors, one
// (survivor, i) a lane, so that a survivor's d^2 FMAs spread over the
// warp; then, one survivor a lane, est and quad over i ascending, the
// bonus and the sum, as ucb_combine.  A rescored score above its UB or
// below its LB is a violation; each warp counts its rescored pairs and
// violations into fstats.  Survivor e sits on lane e % 32, which folds it
// into its (best, best_k) as the register tile's reduction does, then
// warp_first_max (ucb_score.cuh, choose.cu's): for a user that kept all K
// this is the tile's own reduction, so ties, -inf and NaN fall out as
// there (the first NaN index if a score is NaN: repro's jnp.argmax); for
// the others every score is finite and the first-index argmax over the
// survivors is the tile's pick.  A score can be NaN only where some
// bound is not finite or |M|_F or |w| is past kHuge (a NaN or inf in
// ctx, Minv, w or occ's factor, or an overflow past them), and then the
// user keeps all K.  Every lane ends with the same pick, and x is copied
// from its staged row.  A block syncs once
// a group, to hand over a stage; its warps rescore and reduce on their
// own.  (Rescoring every survivor, the lone ones too, added ~0.016 ms a
// launch on the card: PERF.md section 6, PR 35.)
//
// Shared memory at d = 25, K = 20: two stages of 26.9 KB, each warp's
// list (240 bytes) and t (4.2 KB) and the two mbarriers, ~89 KB, two
// blocks an SM (122 registers a thread); at d = 32, K = 64, ~206 KB, one
// block (d = 31 and 32 take one block an SM: at two they spilled).
// chip_smoke.py prints the ptxas lines (no spill) and requires HMMA in
// the SASS.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math.h>
#include <string.h>

#include "sqrt_rn.cuh"
#include "stage.cuh"
#include "ucb_score.cuh"

namespace {

constexpr int kUsers = 8;            // users a group: a warp each
constexpr int kThreads = 32 * kUsers;
constexpr int kMaxD = 32;            // the filter takes d <= kMaxD
constexpr int kMaxK = 64;            // and K <= kMaxK (two pairs of tiles)
constexpr int kChunk = 32;           // survivors rescored a round
constexpr int kTStride = 33;         // a survivor's t_i, padded
constexpr unsigned kFull = 0xffffffffu;
// csrc/topk_tc.cu's constants (tests/test_torch_choose_filter.py holds
// them equal)
constexpr float kQRel = 0x1p-12f;    // E's relative constant
constexpr float kERelTc = 0x1p-12f;  // E_est's (f32 items: either way)
constexpr float kAbs = 0x1p-100f;    // E's and E_est's absolute terms
constexpr float kHuge = 0x1p60f;     // a norm from here on keeps all K
// (bits << 1) - 2 of a feature below this: a nonzero |x_j| < 2^-102
constexpr uint32_t kTinyKey = 2u * 0x0c800000u - 2u;

// A survivor: its k and bounds, in the warp's list.
struct Entry {
  int k;
  float ub, lb;
};

// Byte offsets of the block's shared memory: a stage's three spans (each
// region with room for stage.cuh's shift, Minv's with one word more for
// the pair loads' second word), the two stages, then each warp's list of
// survivors (K entries) and the rescore's t (kChunk pairs x kTStride).
struct Layout {
  int m, c, w, stage;
  int lists, tbuf, bars, total;
};

__host__ __device__ inline Layout layout(int d, int K) {
  Layout L;
  L.m = 0;
  L.c = L.m + (int)region_bytes<__nv_bfloat16>(kUsers * d * d) + 16;
  L.w = L.c + (int)region_bytes<float>(kUsers * K * d);
  L.stage = L.w + (int)region_bytes<float>(kUsers * d);
  L.lists = 2 * L.stage;
  L.tbuf = L.lists + (int)sizeof(Entry) * kUsers * K;
  L.bars = L.tbuf + 4 * kUsers * kChunk * kTStride;
  L.total = L.bars + 16;
  return L;
}

__device__ __forceinline__ uint32_t lds_u32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ uint32_t lds_u16(uint32_t a) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ float lds_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}
// the bulk copies' mbarriers (one a stage, one arrival a phase: thread
// 0's expect_tx)
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (long spin = 0; !done; ++spin) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spin > (1l << 28)) asm volatile("trap;");  // a lost copy
  }
}

__device__ __forceinline__ float bf_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof u);
  return u;
}
// (bits << 1) - 2: below kTinyKey exactly for a nonzero |x| < 2^-102
__device__ __forceinline__ uint32_t tiny_key(float x) {
  return __float_as_uint(x) * 2u - 2u;
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Bounds on sqrt(v) (v >= 0 or +inf) from the correctly rounded root,
// as csrc/topk_tc.cu's.
__device__ __forceinline__ float sqrt_up(float v) {
  const float r = sqrt_rn(v);
  return r < INFINITY ? __uint_as_float(__float_as_uint(r) + 1u) : r;
}
__device__ __forceinline__ float sqrt_down(float v) {
  const float r = sqrt_rn(v);
  return r > 0.f && r < INFINITY ? __uint_as_float(__float_as_uint(r) - 1u)
                                 : r;
}

__device__ __forceinline__ float warp_sum_ru(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_ru(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Sums of a quad's four lanes for rows g, g + 8 of two tiles (v[tile][row
// half]), as the epilogue combines them: round 1 (lanes t ^ 2) keeps tile
// t / 2, round 2 (t ^ 1) row half t % 2.  ``Op``: the sum's rounding.
template <typename Op>
__device__ __forceinline__ float quad_reduce(const float (&v)[2][2], int t,
                                             Op op) {
  const bool hi_tile = t >= 2, hi_row = t & 1;
  const float r0 = op(hi_tile ? v[1][0] : v[0][0],
                      __shfl_xor_sync(kFull, hi_tile ? v[0][0] : v[1][0], 2));
  const float r1 = op(hi_tile ? v[1][1] : v[0][1],
                      __shfl_xor_sync(kFull, hi_tile ? v[0][1] : v[1][1], 2));
  return op(hi_row ? r1 : r0, __shfl_xor_sync(kFull, hi_row ? r0 : r1, 1));
}

// A group's spans in a stage, each at its source's offset mod 16.
struct Spans {
  const __nv_bfloat16* m;  // Minv, users x d x d
  const float* c;          // contexts, users x K x d
  const float* w;          // w, users x d
};

template <int D>
__device__ __forceinline__ Spans spans_of(unsigned char* base,
                                          const Layout& L,
                                          const float* __restrict__ w,
                                          const __nv_bfloat16* __restrict__ Minv,
                                          const float* __restrict__ ctx,
                                          int u0, int K) {
  const __nv_bfloat16* sm = Minv + (size_t)u0 * D * D;
  const float* sc = ctx + (size_t)u0 * K * D;
  const float* sw = w + (size_t)u0 * D;
  return {at_offset(reinterpret_cast<__nv_bfloat16*>(base + L.m), sm),
          at_offset(reinterpret_cast<float*>(base + L.c), sc),
          at_offset(reinterpret_cast<float*>(base + L.w), sw)};
}

// Whether group g's three spans start on 16 bytes and are whole 16-byte
// words, so that a bulk copy takes each.
template <int D>
__device__ __forceinline__ bool bulk_ok(const float* w,
                                        const __nv_bfloat16* Minv,
                                        const float* ctx, int g, int n,
                                        int K) {
  const int u0 = g * kUsers, nu = min(kUsers, n - u0);
  const uintptr_t a = reinterpret_cast<uintptr_t>(Minv + (size_t)u0 * D * D) |
                      reinterpret_cast<uintptr_t>(ctx + (size_t)u0 * K * D) |
                      reinterpret_cast<uintptr_t>(w + (size_t)u0 * D);
  const uint32_t b = (uint32_t)(nu * D * D * 2) | (uint32_t)(nu * K * D * 4) |
                     (uint32_t)(nu * D * 4);
  return ((a | b) & 15) == 0;
}

// Issue every copy of group g's spans into the stage at ``base``: three
// bulk copies by thread 0 on the stage's mbarrier where they are whole
// 16-byte words, else every thread's cp.async (stage.cuh).
template <int D>
__device__ __forceinline__ void stage_group(unsigned char* base,
                                            const Layout& L, uint32_t bar,
                                            const float* __restrict__ w,
                                            const __nv_bfloat16* __restrict__ Minv,
                                            const float* __restrict__ ctx,
                                            int g, int n, int K) {
  const int u0 = g * kUsers, nu = min(kUsers, n - u0);
  const int t = threadIdx.x;
  const __nv_bfloat16* sm = Minv + (size_t)u0 * D * D;
  const float* sc = ctx + (size_t)u0 * K * D;
  const float* sw = w + (size_t)u0 * D;
  const Spans sp = spans_of<D>(base, L, w, Minv, ctx, u0, K);
  if (bulk_ok<D>(w, Minv, ctx, g, n, K)) {
    if (t == 0) {
      const uint32_t bm = nu * D * D * 2, bc = nu * K * D * 4, bw = nu * D * 4;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"(bm + bc + bw)
          : "memory");
      bulk_copy(smem_u32(sp.m), sm, bm, bar);
      bulk_copy(smem_u32(sp.c), sc, bc, bar);
      bulk_copy(smem_u32(sp.w), sw, bw, bar);
    }
    return;
  }
  stage(const_cast<__nv_bfloat16*>(sp.m), sm, nu * D * D, t, kThreads);
  stage(const_cast<float*>(sp.c), sc, nu * K * D, t, kThreads);
  stage(const_cast<float*>(sp.w), sw, nu * D, t, kThreads);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Warp ``v``'s user u (valid: u < n) against the filter: its candidates'
// bounds, its survivors listed in k order (``list``, K entries) and
// rescored, 32 at a time (``tbuf``: their t_i), the register tile's
// reduction over their scores into choice[u] and x[u]; the pairs rescored
// and the violations added to lane 0's ``rescored`` and ``viol``.
template <int D>
__device__ __forceinline__ void filter_user(const Spans& sp, int v,
                                            bool valid, int u, int occ_u,
                                            float alpha, int K, Entry* list,
                                            float* tbuf, int* __restrict__ choice,
                                            float* __restrict__ x,
                                            int& rescored, int& viol,
                                            int lane) {
  const int gq = lane >> 2, t = lane & 3;
  const __nv_bfloat16* Mu = sp.m + v * D * D;
  const uint32_t mb = smem_u32(Mu);
  const uint32_t wb = smem_u32(sp.w + v * D);
  const uint32_t cu = smem_u32(sp.c + v * K * D);
  const uint32_t xlane = cu + 4u * (uint32_t)(gq * D + 2 * t);

  // ---- B: Minv's one piece, B[j][i] = M[i][j] at i = 8 nt + g, j = 16 ks
  // + 8 h + 2t + {0, 1}; w's hi and lo pieces at i = 30, 31 (d <= 30)
  uint32_t bh[4][2][2];
  float f2 = 0.f;
  const uint32_t mlane = mb + 2u * (uint32_t)(gq * D + 2 * t);
  const uint32_t mb4 = mlane & ~3u;
  const bool modd = mlane & 2u;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int i = 8 * nt + gq;
    const bool mrow = 8 * nt + 8 <= D || i < D;  // a row of Minv
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jb = 16 * ks + 8 * h;
        const int j = jb + 2 * t;
        uint32_t word = 0u;
        if (jb < D && 8 * nt < D) {
          // elements (i, j) and (i, j + 1) from the aligned word at or
          // below them and, where they straddle it, the next (the offset
          // past the lane's base is a multiple of 4)
          const uint32_t a4 = mb4 + 2u * (8 * nt * D + jb);
          const uint32_t w0 = mrow ? lds_u32(a4) : 0u;
          const uint32_t w1 = mrow && modd ? lds_u32(a4 + 4) : 0u;
          word = modd ? __funnelshift_r(w0, w1, 16) : w0;
          if (jb + 8 > D)
            word = j + 1 < D ? word : j < D ? (word & 0xffffu) : 0u;
          const float m0 = bf_lo(word), m1 = bf_hi(word);
          f2 = __fmaf_ru(m0, m0, f2);
          f2 = __fmaf_ru(m1, m1, f2);
        }
        if (D <= 30 && nt == 3 && jb < D) {
          // est's columns: w_j's hi piece at i = 30, its lo piece at 31
          const float w0 = j < D ? lds_f32(wb + 4 * j) : 0.f;
          const float w1 = j + 1 < D ? lds_f32(wb + 4 * (j + 1)) : 0.f;
          const uint32_t hi = bf2_bits(__floats2bfloat162_rn(w0, w1));
          const uint32_t lo = bf2_bits(
              __floats2bfloat162_rn(w0 - bf_lo(hi), w1 - bf_hi(hi)));
          word = i == 30 ? hi : i == 31 ? lo : word;
        }
        bh[nt][ks][h] = word;
      }
  }
  // the bounds' per-user factors, formed after the first product is
  // issued (their shuffles overlap it)
  float cM = 0.f, cW = 0.f, ex = 0.f;
  float wv[4][2];

  float ubv[2], lbv[2];
  bool live[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    ubv[p] = lbv[p] = 0.f;
    live[p] = false;
    if (32 * p >= K) continue;  // the warp together
    // tile by tile (its A fragments and accumulator live only there):
    // rows 32 p + 16 tt + g (+ 8 hr) split into two pieces, the product,
    // the lane's share of q~ (and e~) for rows g and g + 8
    float qv[2][2], ev[2][2], n2[2][2];
    uint32_t least[2][2];
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
      uint32_t ah[2][4], al[2][4];  // [k-step][register]
      float xk[2][2][2][2] = {};    // [hr][k-step][h]: the lane's x
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int rb = 32 * p + 16 * tt + 8 * hr;
        const bool rv = rb + gq < K;
        const uint32_t cb = xlane + 4u * (rb * D);  // row rb + g, feature 2t
        n2[tt][hr] = 0.f;
        least[tt][hr] = 0xffffffffu;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int jb = 16 * ks + 8 * h;
            const int j = jb + 2 * t;
            uint32_t hi = 0u, lo = 0u;
            if (jb < D) {
              const float x0 =
                  rv && (jb + 8 <= D || j < D) ? lds_f32(cb + 4 * jb) : 0.f;
              const float x1 = rv && (jb + 8 <= D || j + 1 < D)
                                   ? lds_f32(cb + 4 * jb + 4)
                                   : 0.f;
              hi = bf2_bits(__floats2bfloat162_rn(x0, x1));
              // x - ahi, exact; its bf16 rounding, the lo piece
              lo = bf2_bits(
                  __floats2bfloat162_rn(x0 - bf_lo(hi), x1 - bf_hi(hi)));
              xk[hr][ks][h][0] = x0;
              xk[hr][ks][h][1] = x1;
              n2[tt][hr] = __fmaf_ru(x0, x0, n2[tt][hr]);
              n2[tt][hr] = __fmaf_ru(x1, x1, n2[tt][hr]);
              least[tt][hr] = min(least[tt][hr], tiny_key(x0));
              least[tt][hr] = min(least[tt][hr], tiny_key(x1));
            }
            ah[ks][hr + 2 * h] = hi;
            al[ks][hr + 2 * h] = lo;
          }
      }
      // the product: ahi's k-steps, then alo's, on each accumulator
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[nt], ah[ks], bh[nt][ks]);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[nt], al[ks], bh[nt][ks]);
      if (p == 0 && tt == 0) {
        cM = sqrt_up(warp_sum_ru(f2));  // F >= |M|_F
        cM = cM < kHuge ? __fadd_ru(__fmul_ru(kQRel, cM), kAbs) : INFINITY;
        const float wl = lane < D ? lds_f32(wb + 4 * lane) : 0.f;
        cW = sqrt_up(warp_sum_ru(__fmul_ru(wl, wl)));  // W >= |w|
        cW = cW < kHuge ? __fadd_ru(__fmul_ru(kERelTc, cW), kAbs)
                        : INFINITY;
        ex = sqrtf(log1pf((float)occ_u));
        // est on the CUDA cores (d = 31, 32): w at the lane's columns
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 8 * nt + 2 * t + e;
            wv[nt][e] = D > 30 && j < D ? lds_f32(wb + 4 * j) : 0.f;
          }
      }
      // the share on x itself, kept from the split: the A fragment and
      // the accumulator share their column map, so columns 8 nt + 2t + {0,
      // 1} are the lane's features of k-step nt / 2, half nt % 2
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float q = 0.f, es = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float a0 = xk[hr][nt >> 1][nt & 1][0];
          const float a1 = xk[hr][nt >> 1][nt & 1][1];
          q = fmaf(a0, acc[nt][2 * hr], q);
          q = fmaf(a1, acc[nt][2 * hr + 1], q);
          if (D > 30) {
            es = fmaf(a0, wv[nt][0], es);
            es = fmaf(a1, wv[nt][1], es);
          }
        }
        if (D <= 30)  // columns 30 and 31 at t = 3: w's hi + lo
          es = acc[3][2 * hr] + acc[3][2 * hr + 1];
        qv[tt][hr] = q;
        ev[tt][hr] = es;
      }
    }
    const auto add = [](float a, float b) { return a + b; };
    const float qs = quad_reduce(qv, t, add);
    float es;
    if (D <= 30) {
      const int src = lane | 3;
      const float e00 = __shfl_sync(kFull, ev[0][0], src);
      const float e01 = __shfl_sync(kFull, ev[0][1], src);
      const float e10 = __shfl_sync(kFull, ev[1][0], src);
      const float e11 = __shfl_sync(kFull, ev[1][1], src);
      es = t >= 2 ? (t & 1 ? e11 : e10) : (t & 1 ? e01 : e00);
    } else {
      es = quad_reduce(ev, t, add);
    }
    const float rn2 =
        quad_reduce(n2, t, [](float a, float b) { return __fadd_ru(a, b); });
    float lk[2][2];
#pragma unroll
    for (int tt = 0; tt < 2; ++tt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        lk[tt][hr] = __uint_as_float(least[tt][hr]);
    const uint32_t rl = __float_as_uint(quad_reduce(
        lk, t, [](float a, float b) {
          return __uint_as_float(min(__float_as_uint(a), __float_as_uint(b)));
        }));
    // ---- the bounds of candidate 8t + g of the pair
    const float en = sqrt_up(rn2);
    const float en2 = !(rn2 < kHuge) || rl < kTinyKey ? INFINITY : rn2;
    const float E = __fadd_ru(__fmul_ru(cM, en2), kAbs);
    const float Ee = __fadd_ru(__fmul_ru(cW, en), kAbs);
    const float su = sqrt_up(fmaxf(__fadd_ru(qs, E), 0.f));
    const float sd = sqrt_down(fmaxf(__fadd_rd(qs, -E), 0.f));
    const float bu = alpha >= 0.f ? su : sd, bl = alpha >= 0.f ? sd : su;
    const float ub = __fadd_ru(__fadd_ru(es, Ee),
                               __fmul_ru(__fmul_ru(alpha, bu), ex));
    const float lb = __fadd_rd(__fadd_rd(es, -Ee),
                               __fmul_rd(__fmul_rd(alpha, bl), ex));
    const bool fin = fabsf(qs) < INFINITY && fabsf(es) < INFINITY;
    ubv[p] = fin ? ub : NAN;
    lbv[p] = fin ? lb : NAN;
    live[p] = valid && 32 * p + 8 * t + gq < K;
  }

  // ---- survivors: !(UB < max LB); all K where a bound is not finite
  const auto finite = [](float f) { return fabsf(f) < INFINITY; };
  const bool bad = (live[0] && !(finite(ubv[0]) && finite(lbv[0]))) ||
                   (live[1] && !(finite(ubv[1]) && finite(lbv[1])));
  const bool all =
      __any_sync(kFull, bad) || !(cM < INFINITY) || !(cW < INFINITY);
  float mlb = fmaxf(live[0] ? lbv[0] : -INFINITY,
                    live[1] ? lbv[1] : -INFINITY);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mlb = fmaxf(mlb, __shfl_xor_sync(kFull, mlb, o));
  const bool s0 = live[0] && (all || !(ubv[0] < mlb));
  const bool s1 = live[1] && (all || !(ubv[1] < mlb));
  const unsigned b0 = __ballot_sync(kFull, s0), b1 = __ballot_sync(kFull, s1);
  const int c0 = __popc(b0), cnt = c0 + __popc(b1);
  int best = INT_MIN;  // the lane's pick_key, below every key
  int best_k = INT_MAX;
  if (cnt == 1) {
    // the winner survives, so a lone survivor is the pick (and the
    // register tile's at K = 1, whatever its score)
    const int l = __ffs(b0 | b1) - 1;
    best_k = (b0 ? 0 : 32) + 8 * (l & 3) + (l >> 2);
  } else if (cnt > 1) {
    // lane (g, t) holds candidate 8t + g: the lanes before it in k order
    const unsigned below = 0x11111111u * ((1u << t) - 1u) |
                           ((0x11111111u << t) & ((1u << lane) - 1u));
    if (s0) list[__popc(b0 & below)] = {8 * t + gq, ubv[0], lbv[0]};
    if (s1)
      list[c0 + __popc(b1 & below)] = {32 + 8 * t + gq, ubv[1], lbv[1]};
    __syncwarp();
    // ---- rescore the survivors, 32 at a time: every t_i, one (survivor,
    // i) a lane; then est and quad over i, the bonus and the sum, one
    // survivor a lane, survivor e on lane e % 32, which folds it into its
    // (best, best_k) as the register tile's reduction does
    const uint32_t mu = smem_u32(sp.m + v * D * D);
    const float* cv = sp.c + v * K * D;
    const float* wu = sp.w + v * D;
    for (int e0 = 0; e0 < cnt; e0 += kChunk) {
      const int m = min(kChunk, cnt - e0);
      for (int tau = lane; tau < m * D; tau += 32) {
        const int e = tau / D, i = tau - e * D;
        const uint32_t mr = mu + 2u * (uint32_t)(i * D);
        const float* c = cv + list[e0 + e].k * D;
        float tv = 0.f;
#pragma unroll
        for (int j = 0; j < D; ++j)
          tv = fmaf(__uint_as_float(lds_u16(mr + 2 * j) << 16), c[j], tv);
        tbuf[e * kTStride + i] = tv;
      }
      __syncwarp();
      float score = 0.f;
      Entry en{0, 0.f, 0.f};
      if (lane < m) {
        en = list[e0 + lane];
        const float* c = cv + en.k * D;
        const float* tv = tbuf + lane * kTStride;
        float est = 0.f, quad = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          est = fmaf(c[i], wu[i], est);
          quad = fmaf(c[i], tv[i], quad);
        }
        score = __fadd_rn(
            est, __fmul_rn(__fmul_rn(alpha, sqrtf(quad_floor(quad))), ex));
        const int key = pick_key(score);
        if (key > best) {  // k rises
          best = key;
          best_k = en.k;
        }
      }
      rescored += m;
      viol += __popc(__ballot_sync(
          kFull, lane < m && (score > en.ub || score < en.lb)));
      __syncwarp();  // the next round's t, the next user's list
    }
  }
  // every lane gets the same pick (a lone survivor's is every lane's)
  if (cnt > 1) best_k = warp_first_max(best, best_k);
  if (valid) {
    if (lane == 0) choice[u] = best_k;
    const float* cb = sp.c + (v * K + best_k) * D;
    for (int jj = lane; jj < D; jj += 32) x[(size_t)u * D + jj] = cb[jj];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D > 30 ? 1 : 2)
    choose_tc_kernel(const float* __restrict__ w,
                     const __nv_bfloat16* __restrict__ Minv,
                     const float* __restrict__ ctx,
                     const int* __restrict__ occ, float alpha, int n, int K,
                     int* __restrict__ choice, float* __restrict__ x,
                     int* __restrict__ fstats) {
  extern __shared__ __align__(16) float smem[];
  unsigned char* raw = reinterpret_cast<unsigned char*>(smem);
  const Layout L = layout(D, K);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  Entry* list = reinterpret_cast<Entry*>(raw + L.lists) + warp * K;
  float* tbuf = reinterpret_cast<float*>(raw + L.tbuf) +
                warp * kChunk * kTStride;
  const int groups = (n + kUsers - 1) / kUsers;
  int rescored = 0, viol = 0;
  // the ring: group g in stage s, the block's next group in stage s ^ 1;
  // stage s's mbarrier at bars + 8 s, its phase bit s of ``phase``
  const uint32_t bars = smem_u32(raw + L.bars);
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t phase = 0;
  int g = blockIdx.x;
  int occ_u = 0;  // the warp's next user's, loaded a group ahead
  if (g < groups) {
    stage_group<D>(raw, L, bars, w, Minv, ctx, g, n, K);
    if (g * kUsers + warp < n) occ_u = __ldg(occ + g * kUsers + warp);
  }
  for (int s = 0; g < groups; g += gridDim.x, s ^= 1) {
    if (bulk_ok<D>(w, Minv, ctx, g, n, K)) {
      mbar_wait(bars + 8 * s, (phase >> s) & 1u);
      phase ^= 1u << s;
    } else {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    __syncthreads();  // group g has arrived; the last group is done
    const int gn = g + gridDim.x;
    int occ_n = 0;
    if (gn < groups) {
      stage_group<D>(raw + (s ^ 1) * L.stage, L, bars + 8 * (s ^ 1), w,
                     Minv, ctx, gn, n, K);
      if (gn * kUsers + warp < n) occ_n = __ldg(occ + gn * kUsers + warp);
    }
    const int u = g * kUsers + warp;
    const Spans sp =
        spans_of<D>(raw + s * L.stage, L, w, Minv, ctx, g * kUsers, K);
    filter_user<D>(sp, warp, u < n, u, occ_u, alpha, K, list, tbuf, choice,
                   x, rescored, viol, lane);
    occ_u = occ_n;
  }
  if (lane == 0) {
    const size_t at = ((size_t)blockIdx.x * kUsers + warp) * 2;
    fstats[at] = rescored;
    fstats[at + 1] = viol;
  }
}

bool valid_shape(int d, int K) {
  return d >= 1 && d <= kMaxD && K >= 1 && K <= kMaxK;
}

template <int D>
int launch_d(const float* w, const __nv_bfloat16* Minv, const float* ctx,
             const int* occ, float alpha, int n, int K, int d, int grid,
             int* choice, float* x, int* fstats, int* blocks,
             cudaStream_t stream) {
  if constexpr (D < kMaxD) {
    if (d != D)  // one instantiation for each d <= kMaxD
      return launch_d<D + 1>(w, Minv, ctx, occ, alpha, n, K, d, grid,
                             choice, x, fstats, blocks, stream);
  }
  const size_t bytes = layout(D, K).total;
  cudaError_t e = allow_smem(choose_tc_kernel<D>, bytes);
  if (e != cudaSuccess) return (int)e;
  if (blocks)  // the occupancy query, no launch
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, choose_tc_kernel<D>, kThreads, bytes);
  choose_tc_kernel<D><<<grid, kThreads, bytes, stream>>>(
      w, Minv, ctx, occ, alpha, n, K, choice, x, fstats);
  return (int)cudaGetLastError();
}

}  // namespace

// The filter on a bf16 Minv (w, ctx, x f32; occ, choice i32): ``grid``
// persistent blocks (at most the groups of 8 users), fstats [grid, 8, 2]
// i32 receiving each warp's rescored pairs and violations.  A shape
// past d <= 32 and K <= 64 is refused (cudaErrorInvalidValue).
extern "C" int choose_bf16_tc_launch(const float* w,
                                     const __nv_bfloat16* Minv,
                                     const float* ctx, const int* occ,
                                     float alpha, int n, int K, int d,
                                     int grid, int* choice, float* x,
                                     int* fstats, cudaStream_t stream) {
  if (!valid_shape(d, K) || grid < 1) return (int)cudaErrorInvalidValue;
  return launch_d<1>(w, Minv, ctx, occ, alpha, n, K, d, grid, choice, x,
                     fstats, nullptr, stream);
}

// Resident blocks an SM of the filter at (d, K), for the grid.
extern "C" int choose_tc_blocks_per_sm(int d, int K, int* blocks) {
  if (!valid_shape(d, K)) return (int)cudaErrorInvalidValue;
  return launch_d<1>(nullptr, nullptr, nullptr, nullptr, 0.f, 0, K, d, 1,
                     nullptr, nullptr, nullptr, blocks, nullptr);
}
