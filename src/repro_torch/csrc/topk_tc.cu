// Streaming UCB top-K over bf16 and int8 catalogs, and over f32 catalogs
// for a bf16 Minv, at d <= 32, unpruned and cluster-pruned: the filter
// kernels (the retrieval engine of reduced-precision catalog serving).
//
// Replaces: src/repro/kernels/topk/topk.py, topk_pallas (:114) and
//           topk_pruned_pallas (:229), for bf16 and int8 items, and for
//           f32 items with a bf16 Minv (:73, :75, :195, :197), at d <= 32
//           (topk.cu's chain kernels serve the rest and stand beside these
//           as their yardstick).
//
// Computes topk.cu's shortlists (the same scores, by the FMA chains of
// csrc/ucb_score.cuh in their order, and the same (score desc, id asc)
// lists), bit for bit; what differs is which pairs reach the chains.
//
// Filter (topk_tc_kernel and topk_pruned_tc_kernel behind the ten
// *_tc_launch entries: bf16 and int8 items with Minv f32 or bf16, f32
// items with Minv bf16; topk_pallas's and
// topk_pruned_pallas's bodies score on the matrix unit, and here the
// tensor cores only bound the scores).  A tensor-core
// product gives each (user, item) pair an upper bound UB of the chain's
// score; only the pairs with UB >= the user's floor (or UB not finite)
// are rescored by the chain and offered to the list, so the shortlist
// and its score bits are the chain kernels'.  Bound on an H100: no
// longer the 2 d^2 + 4 d + 6 operations of every pair (the chain
// kernels' bound, at the f32 rate), but the product's d (d + 1)
// multiply-adds a pair and piece at the bf16 tensor-core rate plus the
// rescored pairs' chains at the f32 rate, or the bytes where larger
// (chip_smoke.py phase 6 times each kernel against its own bound, the
// chain kernels' beside it).  The epilogue's O(d) operations a pair on
// the CUDA cores are not in the bound.  For a block of 8 users (a warp
// each, with its list) and 256 threads:
// - Chunks of kTcRows = 512 rows are staged as the chain kernels stage
//   them (one chunk ahead, bytes by cp.async).  All threads then repack
//   the chunk into the A tile: bf16 rows as they are, int8 codes as bf16
//   (exact), 32 features a row (zeros past d), 64 bytes with their 16-byte
//   words swizzled so that ldmatrix reads 8 rows in 32 banks; beside it
//   each row's en2 >= |x|^2 and en >= |x| (x = s a, s the int8 scale, 1
//   for bf16), rounded up.  f32 rows are split into two A tiles
//   (repack_split, "f32 items" below).
// - Each warp holds its user's B operand in registers, loaded once a
//   block: B[j][i] = M[i][j] (M = Minv in f32, widened where bf16) as the
//   m16n8k16 fragments of 4 n-tiles x 2 k-steps, split into pieces hi =
//   bf16(M) and lo = bf16(M - hi) (M - hi is exact in f32; a bf16 Minv
//   has lo = 0 and runs one piece).  Two bf16 pieces rather than three,
//   or two TF32 ones: the product costs one mma a piece, and the residual
//   |M - hi - lo| <= 2^-16 |M| only widens the bound (E below), not the
//   result.  Where d <= 30, B's columns 30 and 31 hold w's hi and lo
//   pieces, so the product also gives est (the features there are 0).
// - The product is mma.sync m16n8k16 bf16 with f32 accumulation, 4 tiles
//   of 16 rows a warp's step (8 or 16 mma a tile): T[r][i] ~ sum_j
//   a_rj M_ij.  mma.sync and not wgmma: a warp per user keeps each
//   user's list, B and epilogue in one warp, and the A fragment and the
//   accumulator share their column map (lane (g, t) holds features 8 nt
//   + 2t + {0, 1} of rows g and g + 8 in both), so the epilogue reads no
//   shared memory for x; the product is not what bounds the kernel.
// - Epilogue: q~ = sum_i a_ri T[r][i] (8 FMAs a lane, then two rounds of
//   shuffles over the quad that leave each lane one (tile, row) of a
//   pair of tiles), times s^2 for int8; est from columns 30 and 31 (or 8
//   FMAs and the same shuffles where d > 30), times s; then UB:
//     E = kQRel F en2 + kAbs (en2 + 1),   E_est = c W en + kAbs (en + 1)
//     (c = kERelTc where est comes from the product or the items are
//     f32, else kERel)
//     UB = (e~ + E_est) + alpha sqrt(q~ + E) ex       (alpha >= 0)
//     UB = (e~ + E_est) + alpha sqrt(max(q~ - E, 0)) ex (alpha < 0)
//   every operation rounded up (the root: sqrt_up / sqrt_down, the
//   neighbours of the correctly rounded sqrt_rn, never tighter than
//   __fsqrt_ru / __fsqrt_rd), F >= |M|_F and W >= |w| rounded up.  The
//   chain's score is the round-to-nearest of the same monotone function
//   of (quad, est), so score <= UB whenever |q~ - quad| <= E and |e~ -
//   est| <= E_est.  A non-finite q~ or e~ makes UB NaN, and a pair with
//   UB NaN passes.  So does a pair whose chain score is NaN: a NaN or
//   inf in the row, its scale, Minv or w makes q~ or e~ non-finite, and
//   finite inputs overflow the chain only past kHuge, where E (or E_est)
//   is inf and UB inf or NaN at alpha >= 0; at alpha < 0 such a pair
//   passes where q~ overflows with quad (not within q~'s error of
//   FLT_MAX).  The rescore of a NaN score poisons the user's list, which
//   ends as repro's select_topk fixed point (NaN, INT_MAX)
//   (topk_shared.cuh).
// - A live pair passes if !(UB < floor): floor the k-th entry of the
//   warp's list (pruned: the larger of it and the published floor, as the
//   skip test), read after each round of rescoring.  A passing pair joins
//   the warp's ring (kQueue) with its repacked row, UB, id and scale, so
//   the ring outlives the chunk.  When the ring holds 64, or every
//   kTcFlush chunks for all warps at once, or at the end, the warp
//   rescores 32 at a time, one a lane (rescore): ucb_score.cuh's chains
//   in their order (t_i over j from 0, quad and est over i from 0, the
//   bonus and the sum as ucb_combine) on the widened row (bf16 exactly,
//   int8 by __fmul_rn(code, scale)), eight rows of Minv at a time.  The
//   chain is copied, not called: ucb_t and ucb_combine read the row
//   through a pointer, which would put the lane's row (in registers
//   here) in local memory.  chip_smoke.py's check_topk_filter (phases 3,
//   4p and 5) holds it to them: the shortlist's scores are ucb_scores'
//   bits on the widened rows, and the chain kernels' shortlist.  Then
//   merge32 merges the 32 into the list (a bitonic sort, then each
//   entry's place by binary search).  The list is the top k of all
//   offered items under the total order, so the result is the chain
//   kernels'.  A rescored pair whose score exceeds its UB is counted as a
//   violation; each warp writes (rescored, violations) to fstats.
// - Pruned: the chain kernel's walk, skip test, published floors and
//   first chunk (one tile, its ring emptied before the second is picked)
//   unchanged; the filter runs inside each chunk of kTcRows rows.
// - One block an SM: about 166-179 KB of shared memory at d = 25 (the
//   ring takes 78 KB); chip_smoke.py prints the ptxas lines.
//
// f32 items (a bf16 Minv only: f32 Minv over f32 items would need the
// products hi.Mhi, hi.Mlo and lo.Mhi, and stays on the chain kernels).
// - Repack (repack_split): each f32 row x becomes two A tiles, ahi =
//   bf16(x) and alo = bf16(x - ahi): x - ahi is exact in f32, |x - ahi -
//   alo| <= 2^-16 |x| featurewise, and a = ahi + alo is exact in f32 (a
//   multiple of ulp(x) no larger than (1 + 2^-16) |x|).  en2 and en come
//   from x itself.  A row with a nonzero |x_j| below 2^-102 goes to the
//   chain (en2 = inf): from there down x_j - ahi_j, a multiple of
//   ulp(x_j), may be nonzero below 2^-126, where the residual is not
//   relative (a piece subnormal or 0); above it every piece is normal.
//   So does a row whose split overflows (|x|^2 is then past kHuge).
// - Product: T = ahi M + alo M, the two A tiles against the one B piece
//   of the bf16 Minv, 2 mma a tile step (an f32 Minv over bf16 items costs
//   as much); the epilogue multiplies by a, summed from the two
//   fragments, which share the accumulator's column map.
// - Ring: the f32 row (128 bytes) would not fit beside the second A tile
//   and the f32 chunk, so the ring keeps (UB, id, the row's position in
//   the catalog) and the rescore reads the row from global memory (about
//   1% of pairs are rescored, rows staged a few chunks before).  Shared
//   memory at d = 25: 171 KB pruned at k = 128 (the two A tiles 64 KB,
//   the f32 chunk 50 KB, the ring 12 KB); at d = 32, 197 KB.
//
// E, derived.  u = 2^-24, g_n = n u / (1 - n u), d <= 32; a is the row the
// filter multiplies (bf16 features or int8 codes), s its scale (1 for
// bf16), x the chain's widened row (x_j = a_j, or fl(a_j s) = s a_j (1 +
// d_j), |d_j| <= u), A = sum_ij |a_i| |M_ij| |a_j| <= |a|^2 |M|_F.
//  1. The chain: |quad - Q(x)| <= (2 g_d + g_d^2) A(x), A(x) <= (1 + u)^2
//     s^2 A: 3.82e-6 s^2 A.
//  2. The int8 widening: |Q(x) - s^2 Q(a)| <= (2u + u^2) s^2 A: 1.2e-7.
//  3. The split's residual: |M - hi - lo| <= 2^-16 |M| (+ 2^-133 below
//     bf16's normal range): 1.526e-5.  And |hi| + |lo| <= (1 + 2^-7) |M|.
//  4. The tensor cores' accumulation, taken as no better than aligning
//     each k-step's 16 exact products and the accumulator to the largest
//     and truncating them: < 17 ulps of the largest, <= 17 2^-23 of the
//     step's sum of |terms|; four steps (two pieces x K = 32), the
//     accumulator at most the earlier |products|: |T[r][i] - exact| <= 68
//     2^-23 sum_j |a_j| (|hi| + |lo|)_ij: 8.17e-6 A.
//  5. The epilogue: 8 FMAs and 2 adds, g_10 sum_i |a_i| |T_i|: 6.0e-7;
//     the int8 s^2 (two roundings): 1.2e-7.
//  So |q~ - quad| <= 2.81e-5 s^2 A; kQRel = 2^-12 = 2.44e-4 is 8.7 times
//  that.  kAbs covers underflow and flushing (products, accumulator,
//  pieces below 2^-126: <= 2^-117 (1 + s^2 |a|^2)); a subnormal bf16
//  feature sends its row to the chain (en2 = inf).  est: on the CUDA
//  cores (g_10 + g_d + 2u) s sum |a_j| |w_j| = 2.63e-6 (kERel = 2^-15,
//  11.6 times); from the tensor cores (w's two pieces, one add) 2^-16 + 68
//  2^-23 (1 + 2^-7) + g_d + 3u = 2.56e-5 (kERelTc = 2^-12, 9.5 times); sum
//  |a_j| |w_j| <= |a| |w|.  A row with s^2 |a|^2 >= 2^60, or a user with
//  |M|_F or |w| >= 2^60 (or NaN), gets E = inf and passes every pair;
//  below them no partial of either computation overflows, so the bounds
//  hold.
//  f32 items (a bf16 Minv: term 3 is 0, as are 2 and the s^2; A here is
//  sum_ij |x_i| |M_ij| |x_j| <= |x|^2 |M|_F, a = ahi + alo, |a_j| <= (1 +
//  2^-16) |x_j|, |ahi_j| + |alo_j| <= p |x_j| with p = 1 + 2^-7 + 2^-16):
//  1. The chain: 3.82e-6 A.
//  6. The item split: |Q(x) - Q(a)| = |2 dx' M x - dx' M dx| (dx = x - a)
//     <= (2 2^-16 + 2^-32) A: 3.05e-5.
//  4. The accumulation, four steps (two A pieces x K = 32): 68 2^-23
//     sum_i |a_i| sum_j (|ahi_j| + |alo_j|) |M_ij| <= 68 2^-23 (1 +
//     2^-16) p A: 8.17e-6.
//  5. The epilogue on a (its sum of the two pieces exact): g_10 (1 +
//     2^-16) p (1 + 1e-5) A: 6.0e-7.
//  So |q~ - quad| <= 4.32e-5 A; kQRel is 5.7 times that.  est: from the
//  tensor cores, the item split 2^-16, w's split 2^-16 (1 + 2^-16), the
//  accumulation over both A pieces 68 2^-23 p^2, the chain g_d, 3u: 4.09e-5
//  of sum |x_j| |w_j| (kERelTc, 6.0 times); on the CUDA cores 2^-16 +
//  g_10 (1 + 2^-16) + g_d = 1.78e-5, for which kERel would be 1.7 times
//  only: f32 items take kERelTc there too (13.7 times).
//  kernels/topk/ref.py filter_ref is this derivation in torch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "sqrt_rn.cuh"
#include "ucb_score.cuh"
#include "widen.cuh"

namespace {

// topk.cu's constants (tests/test_torch_topk_filter.py holds them equal)
constexpr int kUsers = 8;       // users per block: one warp each to select
constexpr int kThreads = 256;
constexpr int kMaxK = 128;
constexpr int kSmallD = 32;     // the filter kernels take d <= kSmallD
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // H100: 227 KB per block
constexpr int kMaxTiles = 32;   // tiles a pruned chunk gathers: a lane each

}  // namespace

#include "topk_shared.cuh"

namespace {

// ---------------------------------------------------------------------------
// The filter kernels: bf16 and int8 items, and f32 items with a bf16
// Minv, at d <= kSmallD (header, "Filter" and "f32 items")
// ---------------------------------------------------------------------------

constexpr int kTcRows = 512;       // chunk rows of the filter kernels
constexpr int kTcTiles = 4;        // row tiles of 16 a warp's step holds
constexpr int kQueue = 128;        // a warp's ring of queued candidates
constexpr int kTcFlush = 16;       // chunks between the warps' ring flushes
constexpr float kQRel = 0x1p-12f;  // E's relative constant (header)
constexpr float kERel = 0x1p-15f;  // E_est's relative constant: CUDA cores
constexpr float kERelTc = 0x1p-12f;  // and from the tensor cores (d <= 30)
constexpr float kAbs = 0x1p-100f;  // E's and E_est's absolute terms
constexpr float kHuge = 0x1p60f;   // a norm from here on passes every pair

// A queued candidate: its upper bound, its id and its int8 scale (f32
// items: the bits of its row's position in the catalog, from which the
// rescore reads the row); bf16 and int8 rows (64 bytes) queue beside it.
struct Cand {
  float ub;
  int id;
  float sc;
};

// The filter kernels' own regions: the chunk's A operand (bf16, 32
// features a row, 64 bytes, its four 16-byte words swizzled by row; f32
// items: two, the hi and lo pieces), the rows' norm bounds, and each
// warp's ring of candidates, which outlives the chunk: a bf16 or int8
// candidate's row is copied in with it, an f32 one is read again from
// the catalog.
struct Tc {
  __nv_bfloat16* xa;  // [kTcRows][32]
  __nv_bfloat16* xl;  // [kTcRows][32] f32 items: the lo pieces
  float2* rn;         // [kTcRows] (en2, en): bounds on |x|^2 and |x|
  uint4* qx;          // [kUsers][kQueue][4] the queued rows (not f32)
  Cand* qc;           // [kUsers][kQueue]
  float2* ms;         // [kUsers][32] merge32's scratch
  const float* rows;  // f32 items: the catalog, which the rescore reads
  int DP;             // Minv's and w's padded row: d rounded up to 4
};

__host__ __device__ inline int padded_d(int d) { return (d + 3) & ~3; }

__host__ __device__ inline size_t tc_smem_bytes(int d, int k, bool pruned,
                                                int item) {
  const size_t CH = kTcRows, DP = padded_d(d);
  return CH * 32 * sizeof(__nv_bfloat16) * (item == 0 ? 2 : 1) +
         (size_t)kUsers * kQueue *
             ((item == 0 ? 0 : 4 * sizeof(uint4)) + sizeof(Cand)) +
         sizeof(float2) * kUsers * 32 +
         sizeof(float) * (kUsers * d * DP + kUsers * DP + kUsers) +
         sizeof(float2) * CH +
         sizeof(float) * (chunk_floats(d, kTcRows, item) + 2 * CH +
                          (item == 2 ? 2 * CH : 0) + (pruned ? 2 * CH : 0) +
                          (size_t)kUsers * k) +
         sizeof(int) * (size_t)kUsers * k + (pruned ? sizeof(Walk) : 0);
}

// The filter kernels' shared memory: the Smem regions the shared routines
// read (Ms and ws as [u][i][DP] and [u][DP]; no score tile) and the Tc
// regions; every region that is read 16 bytes at a time starts on 16.
__device__ Smem carve_tc(float* base, int d, int k, bool pruned, int item,
                         Tc& tc) {
  const int CH = kTcRows;
  tc.DP = padded_d(d);
  tc.xa = reinterpret_cast<__nv_bfloat16*>(base);
  if (item == 0) {  // the lo tile, and no rows in the ring
    tc.xl = tc.xa + CH * 32;
    tc.qx = nullptr;
    tc.qc = reinterpret_cast<Cand*>(tc.xl + CH * 32);
  } else {
    tc.xl = nullptr;
    tc.qx = reinterpret_cast<uint4*>(tc.xa + CH * 32);
    tc.qc = reinterpret_cast<Cand*>(tc.qx + kUsers * kQueue * 4);
  }
  tc.ms = reinterpret_cast<float2*>(tc.qc + kUsers * kQueue);
  Smem s;
  s.Ms = reinterpret_cast<float*>(tc.ms + kUsers * 32);
  s.ws = s.Ms + kUsers * d * tc.DP;
  s.ex = s.ws + kUsers * tc.DP;
  tc.rn = reinterpret_cast<float2*>(s.ex + kUsers);
  s.xs = reinterpret_cast<float*>(tc.rn + CH);
  s.lv = s.xs + chunk_floats(d, CH, item);
  s.sc = s.lv + 2 * CH;
  s.id = reinterpret_cast<int*>(s.sc + (item == 2 ? 2 * CH : 0));
  s.ss = nullptr;
  s.ls = reinterpret_cast<float*>(s.id + (pruned ? 2 * CH : 0));
  s.li = reinterpret_cast<int*>(s.ls + kUsers * k);
  s.walk = reinterpret_cast<Walk*>(s.li + kUsers * k);
  return s;
}

// stage_users for the filter kernels: Minv (widened) as [u][i][DP] and w
// as [u][DP], zero past d, so that a lane reads a row 16 bytes at a time.
template <typename S>
__device__ void stage_users_tc(const float* __restrict__ w,
                               const S* __restrict__ Minv,
                               const int* __restrict__ occ,
                               const long long* __restrict__ order, int n,
                               int d, int k, int u0, int DP, const Smem& s) {
  const int dd = d * d, row = d * DP;
  for (int e = threadIdx.x; e < kUsers * row; e += kThreads) {
    const int u = e / row, p = e - u * row, i = p / DP, j = p - i * DP;
    s.Ms[e] = u0 + u < n && j < d
                  ? widen(Minv[user_of(order, u0 + u) * dd + i * d + j])
                  : 0.f;
  }
  for (int e = threadIdx.x; e < kUsers * DP; e += kThreads) {
    const int u = e / DP, j = e - u * DP;
    s.ws[e] = u0 + u < n && j < d ? w[user_of(order, u0 + u) * d + j] : 0.f;
  }
  if (threadIdx.x < kUsers) {
    const int u = u0 + threadIdx.x;
    s.ex[threadIdx.x] =
        u < n ? sqrtf(log1pf((float)occ[user_of(order, u)])) : 0.f;
  }
  for (int e = threadIdx.x; e < kUsers * k; e += kThreads) {
    s.ls[e] = -INFINITY;
    s.li[e] = -1;
  }
}

__device__ __forceinline__ void stage_users_tc_of(
    const float* w, const void* Minv, int minv_bf16, const int* occ,
    const long long* order, int n, int d, int k, int u0, int DP,
    const Smem& s) {
  if (minv_bf16)
    stage_users_tc(w, static_cast<const __nv_bfloat16*>(Minv), occ, order, n,
                   d, k, u0, DP, s);
  else
    stage_users_tc(w, static_cast<const float*>(Minv), occ, order, n, d, k,
                   u0, DP, s);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8 x 8 bf16 matrices from shared memory (A of an m16n8k16 product).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
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

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof u);
  return u;
}
__device__ __forceinline__ float bf_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// The byte address of row r's 16-byte word c in the A tile: word c sits
// at c ^ ((r >> 1) & 3), so that the 8 rows an ldmatrix phase reads fall
// in 32 distinct banks.
__device__ __forceinline__ int xa_word(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// Shared-memory accesses by shared address, so that they compile to
// LDS/STS whatever the compiler can prove about a pointer's space.
__device__ __forceinline__ uint32_t lds_u32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ float lds_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ float2 lds_f2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a));
  return v;
}
__device__ __forceinline__ float4 lds_f4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ uint4 lds_u4(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ void sts_u4(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}
__device__ __forceinline__ void sts_u32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a), "r"(v));
}
__device__ __forceinline__ void sts_f2(uint32_t a, float2 v) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a), "f"(v.x),
               "f"(v.y));
}

// Bounds on sqrt(v) (v >= 0 or +inf) from the correctly rounded root of
// sqrt_rn.cuh: the float above it is >= sqrt(v), the float below it <=
// sqrt(v); never tighter than __fsqrt_ru and __fsqrt_rd, in whose place
// they stand at the cost of sqrt_rn.
__device__ __forceinline__ float sqrt_up(float v) {
  const float r = sqrt_rn(v);
  return r < INFINITY ? __uint_as_float(__float_as_uint(r) + 1u) : r;
}
__device__ __forceinline__ float sqrt_down(float v) {
  const float r = sqrt_rn(v);
  return r > 0.f && r < INFINITY ? __uint_as_float(__float_as_uint(r) - 1u)
                                 : r;
}

// An upward-rounded sum over the warp.
__device__ __forceinline__ float warp_sum_ru(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_ru(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// A warp's user, as the filter reads it: Minv as the B operand of the
// product (hi and lo bf16 pieces; two: lo is not all zero), w at the
// lane's 8 columns, and the bounds' per-user factors.
struct Filt {
  uint32_t bh[4][2][2];  // [n-tile][k-step][register]
  uint32_t bl[4][2][2];
  float wv[4][2];
  float cM;  // kQRel |M|_F + kAbs, rounded up; inf past kHuge
  float cW;  // kERel |w| + kAbs, rounded up; inf past kHuge
  float ex;
  bool two;
  bool est_tc;  // d <= 30: w's pieces sit in B's columns 30 and 31
};

// Lane (g, t) = (lane / 4, lane % 4) holds, for n-tile nt and k-step ks,
// B[j][i] = M[i][j] at i = 8 nt + g, j = 16 ks + 2t + {0, 1, 8, 9}: the
// m16n8k16 B fragment, every (i, j) of the 32 x 32 once over the warp.
// ``f32_items``: E_est takes kERelTc whichever way est comes (header).
__device__ __forceinline__ void filt_setup(const Smem& s, int d, int DP,
                                           int u, int lane, bool f32_items,
                                           Filt& f) {
  const int g = lane >> 2, t = lane & 3;
  const float* M = s.Ms + u * d * DP;
  float f2 = 0.f;
  bool lo_any = false;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = nt * 8 + g, j = ks * 16 + 2 * t + 8 * h;
        const float m0 = i < d && j < d ? M[i * DP + j] : 0.f;
        const float m1 = i < d && j + 1 < d ? M[i * DP + j + 1] : 0.f;
        const __nv_bfloat16 h0 = __float2bfloat16_rn(m0);
        const __nv_bfloat16 h1 = __float2bfloat16_rn(m1);
        const __nv_bfloat16 l0 =
            __float2bfloat16_rn(m0 - __bfloat162float(h0));
        const __nv_bfloat16 l1 =
            __float2bfloat16_rn(m1 - __bfloat162float(h1));
        f.bh[nt][ks][h] = pack2(h0, h1);
        f.bl[nt][ks][h] = pack2(l0, l1);
        lo_any |= (f.bl[nt][ks][h] & 0x7fff7fffu) != 0;
        f2 = __fmaf_ru(m0, m0, f2);
        f2 = __fmaf_ru(m1, m1, f2);
        if (d <= 30 && (i == 30 || i == 31)) {
          // est's columns: w_j's hi piece at i = 30, its lo piece at 31
          const float w0 = j < d ? s.ws[u * DP + j] : 0.f;
          const float w1 = j + 1 < d ? s.ws[u * DP + j + 1] : 0.f;
          const __nv_bfloat16 wh0 = __float2bfloat16_rn(w0);
          const __nv_bfloat16 wh1 = __float2bfloat16_rn(w1);
          f.bh[nt][ks][h] =
              i == 30 ? pack2(wh0, wh1)
                      : pack2(__float2bfloat16_rn(w0 - __bfloat162float(wh0)),
                              __float2bfloat16_rn(w1 - __bfloat162float(wh1)));
        }
      }
  const float F = sqrt_up(warp_sum_ru(f2));
  const float* wu = s.ws + u * DP;
  float w2 = 0.f;
  if (lane < d) w2 = __fmul_ru(wu[lane], wu[lane]);
  const float W = sqrt_up(warp_sum_ru(w2));
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = nt * 8 + 2 * t + e;
      f.wv[nt][e] = j < d ? wu[j] : 0.f;
    }
  f.cM = F < kHuge ? __fadd_ru(__fmul_ru(kQRel, F), kAbs) : INFINITY;
  f.est_tc = d <= 30;
  f.cW = W < kHuge ? __fadd_ru(__fmul_ru(f.est_tc || f32_items ? kERelTc
                                                               : kERel,
                                         W),
                               kAbs)
                   : INFINITY;
  f.ex = s.ex[u];
  f.two = __any_sync(kFull, lo_any);
}

// The chunk's rows [0, cnt) into the A tile (bf16 as they are, int8
// codes as bf16, exact; zeros past d and past cnt) with their norm
// bounds: en2 >= |x|^2 and en >= |x| of the widened row x = s a (s = 1
// for bf16), each rounded up, and en2 = inf where a row passes every
// pair (a norm past kHuge, a non-finite or a subnormal feature).
template <int ITEM, typename RowAt>
__device__ __forceinline__ void repack(const Smem& s, const Tc& tc, int d,
                                       int cnt, int lb, RowAt row_at) {
  constexpr int RT = kTcRows / kThreads;  // rows a thread
  uint32_t v[RT][16];
  float n2[RT];
  bool sub[RT];
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    const int r = threadIdx.x + q * kThreads;
    n2[q] = 0.f;
    sub[q] = false;
    // the row's bytes as whole words from the word at or below its start
    // (a reduced row starts on any 2- or 1-byte boundary), without a
    // branch on d: features past d are masked to 0 after the loads, and
    // the words past the row lie in the chunk buffer's slack
    const uint32_t at = r < cnt ? smem_u32(row_at(r)) : smem_u32(s.xs);
    const uint32_t base = at & ~3u, sh = 8 * (at & 3u);
    constexpr int W = ITEM == 1 ? 17 : 9;
    uint32_t wd[W];
#pragma unroll
    for (int i = 0; i < W; ++i) wd[i] = lds_u32(base + 4 * i);
    if constexpr (ITEM == 1) {
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        uint32_t pr = __funnelshift_r(wd[p], wd[p + 1], sh);
        if (2 * p >= d || r >= cnt) pr = 0u;
        else if (2 * p + 1 >= d) pr &= 0xffffu;
        v[q][p] = pr;
      }
    } else {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const uint32_t c4 = __funnelshift_r(wd[p], wd[p + 1], sh);
        uint32_t h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // an int8 code as bf16: exact (8 significant bits)
          const int code = (int)(signed char)(c4 >> (8 * e));
          h[e] = 4 * p + e < d && r < cnt
                     ? __float_as_uint((float)code) >> 16
                     : 0u;
        }
        v[q][2 * p] = h[0] | (h[1] << 16);
        v[q][2 * p + 1] = h[2] | (h[3] << 16);
      }
    }
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const float lo = bf_lo(v[q][p]), hi = bf_hi(v[q][p]);
      n2[q] = __fmaf_ru(lo, lo, n2[q]);
      n2[q] = __fmaf_ru(hi, hi, n2[q]);
      if constexpr (ITEM == 1)
        sub[q] |= (fabsf(lo) < 0x1p-126f && lo != 0.f) ||
                  (fabsf(hi) < 0x1p-126f && hi != 0.f);
    }
  }
  const uint32_t xa = smem_u32(tc.xa), rn = smem_u32(tc.rn);
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    const int r = threadIdx.x + q * kThreads;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      sts_u4(xa + xa_word(r, c), make_uint4(v[q][4 * c], v[q][4 * c + 1],
                                            v[q][4 * c + 2], v[q][4 * c + 3]));
    float en2 = 0.f, en = 0.f;
    if (r < cnt) {
      en = sqrt_up(n2[q]);
      en2 = n2[q];
      if constexpr (ITEM == 2) {
        const float sa =
            fabsf(lds_f32(smem_u32(s.sc) + 4 * (lb * kTcRows + r)));
        en2 = __fmul_ru(__fmul_ru(sa, sa), n2[q]);
        en = __fmul_ru(sa, en);
      }
      if (!(en2 < kHuge) || sub[q]) en2 = INFINITY;
    }
    sts_f2(rn + 8 * r, make_float2(en2, en));
  }
}

// The chunk's f32 rows [0, cnt), staged at stride stride_of(d), into the
// two A tiles (header, "f32 items"): ahi = bf16(x) into xa, alo = bf16(x
// - ahi) into xl (x - ahi exact in f32), two features a conversion,
// zeros past d and past cnt, with en2 >= |x|^2 and en >= |x| of x
// itself, each rounded up, and en2 = inf where the row passes every pair
// (a norm past kHuge, a non-finite feature, a nonzero |x_j| below
// 2^-102).  A thread's row is read as 32 floats from its start, without
// a branch on d: the reads past the row stay in shared memory and are
// masked to 0.
__device__ __forceinline__ void repack_split(const Smem& s, const Tc& tc,
                                             int d, int cnt) {
  constexpr int RT = kTcRows / kThreads;  // rows a thread
  const int XS = stride_of(d);
  const uint32_t xs = smem_u32(s.xs), xa = smem_u32(tc.xa),
                 xl = smem_u32(tc.xl), rn = smem_u32(tc.rn);
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    const int r = threadIdx.x + q * kThreads;
    float x[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) x[j] = lds_f32(xs + 4 * (r * XS + j));
    uint32_t vh[16], vl[16];
    float n2 = 0.f;
    uint32_t least = 0xffffffffu;  // the least |x_j| bits - 1 (0: the most)
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const float x0 = 2 * p < d && r < cnt ? x[2 * p] : 0.f;
      const float x1 = 2 * p + 1 < d && r < cnt ? x[2 * p + 1] : 0.f;
      vh[p] = bf2_bits(__floats2bfloat162_rn(x0, x1));
      // x - ahi, exact; then its bf16 rounding, the lo pieces
      vl[p] = bf2_bits(
          __floats2bfloat162_rn(x0 - bf_lo(vh[p]), x1 - bf_hi(vh[p])));
      n2 = __fmaf_ru(x0, x0, n2);
      n2 = __fmaf_ru(x1, x1, n2);
      least = min(least, (__float_as_uint(x0) & 0x7fffffffu) - 1u);
      least = min(least, (__float_as_uint(x1) & 0x7fffffffu) - 1u);
    }
    // a nonzero |x_j| below 2^-102 (bits 0x0c800000): x_j - ahi_j may be
    // nonzero below 2^-126, where the split's residual is not relative
    const bool sub = least < 0x0c800000u - 1u;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sts_u4(xa + xa_word(r, c),
             make_uint4(vh[4 * c], vh[4 * c + 1], vh[4 * c + 2], vh[4 * c + 3]));
      sts_u4(xl + xa_word(r, c),
             make_uint4(vl[4 * c], vl[4 * c + 1], vl[4 * c + 2], vl[4 * c + 3]));
    }
    float en2 = 0.f, en = 0.f;
    if (r < cnt) {
      en = sqrt_up(n2);
      en2 = !(n2 < kHuge) || sub ? INFINITY : n2;
    }
    sts_f2(rn + 8 * r, make_float2(en2, en));
  }
}

// The upper bound of the chain's score from the filter's quad q and est
// e (of the widened row), with the directed roundings of the header's
// derivation; NaN where q or e is not finite, so that the pair passes.
__device__ __forceinline__ float score_bound(float q, float e, float2 rn,
                                             const Filt& f, float alpha) {
  const float E = __fadd_ru(__fmul_ru(f.cM, rn.x), kAbs);
  const float eu = __fadd_ru(e, __fadd_ru(__fmul_ru(f.cW, rn.y), kAbs));
  const float b = alpha >= 0.f ? sqrt_up(fmaxf(__fadd_ru(q, E), 0.f))
                               : sqrt_down(fmaxf(__fadd_rd(q, -E), 0.f));
  const float ub = __fadd_ru(eu, __fmul_ru(__fmul_ru(alpha, b), f.ex));
  return fabsf(q) < INFINITY && fabsf(e) < INFINITY ? ub : NAN;
}

// x8[e] = x[i0 + e] for a runtime i0 in {0, 8, 16, 24} (no memory).
__device__ __forceinline__ void pick8(const float (&x)[32], int i0,
                                      float (&x8)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e)
    x8[e] = i0 == 0 ? x[e] : i0 == 8 ? x[8 + e] : i0 == 16 ? x[16 + e]
                                                          : x[24 + e];
}

// The warp's 32 candidates (lane l: score sc, id, ``cand`` if it may
// enter) into its sorted list of k at once: a bitonic sort of the 32 by
// (score desc, id asc), then each list entry's and each candidate's place
// in the merged order by binary search, and the first k written back.
// The list stays the top k of everything offered, as offer's one-by-one
// insertion leaves it.  ``scratch``: the warp's 32 (score, id) slots.
__device__ __forceinline__ void merge32(float* ls, int* li, int k,
                                        bool cand, float sc, int id,
                                        float2* scratch, int lane) {
  if (!__any_sync(kFull, cand)) return;
  if (!cand) {  // ranks after every list entry, empty ones included
    sc = -INFINITY;
    id = 0x7fffffff;
  }
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float os = __shfl_xor_sync(kFull, sc, stride);
      const int oi = __shfl_xor_sync(kFull, id, stride);
      // ascending by "beats" within a bitonic block where lane & size is 0
      const bool first = (lane & stride) == 0;
      const bool desc = (lane & size) == 0 || size == 32;
      const bool take = beats(os, oi, sc, id) == (first == desc);
      if (take) {
        sc = os;
        id = oi;
      }
    }
  scratch[lane] = make_float2(sc, __int_as_float(id));
  __syncwarp();
  // each list entry: the candidates that beat it (a prefix of the 32)
  constexpr int R = kMaxK / 32;
  float ev[R];
  int ei[R], ep[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = r * 32 + lane;
    ep[r] = k;
    if (j < k) {
      ev[r] = ls[j];
      ei[r] = li[j];
      int lo = 0, hi = 32;  // scratch[0, lo) beat it, scratch[hi, 32) not
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const float2 c = scratch[mid];
        if (beats(c.x, __float_as_int(c.y), ev[r], ei[r]))
          lo = mid + 1;
        else
          hi = mid;
      }
      ep[r] = j + lo;
    }
  }
  // each candidate: the list entries that beat it (a prefix of the k)
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (beats(ls[mid], li[mid], sc, id))
      lo = mid + 1;
    else
      hi = mid;
  }
  const int cp = lane + lo;
  __syncwarp();  // every read is done: write the merged list in place
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (ep[r] < k) {
      ls[ep[r]] = ev[r];
      li[ep[r]] = ei[r];
    }
  if (cp < k) {
    ls[cp] = sc;
    li[cp] = id;
  }
  __syncwarp();
}

// Rescore the m (<= 32) candidates at ring positions head .. head + m - 1
// of the warp's ring, one a lane, by a copy of csrc/ucb_score.cuh's
// chains (t_i over j from 0, quad and est over i from 0, then
// ucb_combine's bonus and sum) on the widened row in registers, and
// offer them to the warp's list.  Copied because ucb_t and ucb_combine
// take the row by pointer; chip_smoke.py's check_topk_filter holds the
// copy to ucb_scores bit for bit.  Eight rows of Minv at a time: their t
// chains are independent.  A pair whose exact score exceeds its upper
// bound counts as a violation.  f32 items: the lane reads its row from
// the catalog (tc.rows, at the position the ring keeps).
template <int ITEM>
__device__ __forceinline__ void rescore(const Smem& s, const Tc& tc, int d,
                                     int k, float alpha, float ex,
                                     float pub, int head, int m,
                                     int& rescored, int& viol, int warp,
                                     int lane) {
  const int pos = (head + (lane < m ? lane : 0)) & (kQueue - 1);
  const uint32_t ca = smem_u32(tc.qc + warp * kQueue + pos);
  const Cand cd{lds_f32(ca), __float_as_int(lds_f32(ca + 4)),
                lds_f32(ca + 8)};
  float x[32];
  if constexpr (ITEM == 0) {
    const float* xr = tc.rows + (size_t)__float_as_int(cd.sc) * d;
#pragma unroll
    for (int j = 0; j < 32; ++j) x[j] = j < d ? __ldg(xr + j) : 0.f;
  } else {
    const uint32_t row = smem_u32(tc.qx + (warp * kQueue + pos) * 4);
#pragma unroll
    for (int w4 = 0; w4 < 4; ++w4) {
      const uint4 v = lds_u4(row + 16 * w4);
      const uint32_t vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        x[8 * w4 + 2 * p] = bf_lo(vv[p]);
        x[8 * w4 + 2 * p + 1] = bf_hi(vv[p]);
      }
    }
  }
  if constexpr (ITEM == 2) {
#pragma unroll
    for (int j = 0; j < 32; ++j) x[j] = __fmul_rn(x[j], cd.sc);
  }
  const int DP = tc.DP;
  const uint32_t M = smem_u32(s.Ms + warp * d * DP);
  float quad = 0.f;
  for (int i0 = 0; i0 < d; i0 += 8) {
    float t[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) t[e] = 0.f;
    // rows past d read the next rows of shared memory; their t is unused
    const uint32_t m0 = M + 4 * i0 * DP;
#pragma unroll
    for (int j4 = 0; j4 < 8; ++j4) {
      if (4 * j4 >= d) break;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float4 mv = lds_f4(m0 + 4 * (e * DP + 4 * j4));
        t[e] = fmaf(mv.x, x[4 * j4], t[e]);
        if (4 * j4 + 1 < d) t[e] = fmaf(mv.y, x[4 * j4 + 1], t[e]);
        if (4 * j4 + 2 < d) t[e] = fmaf(mv.z, x[4 * j4 + 2], t[e]);
        if (4 * j4 + 3 < d) t[e] = fmaf(mv.w, x[4 * j4 + 3], t[e]);
      }
    }
    float x8[8];
    pick8(x, i0, x8);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (i0 + e < d) quad = fmaf(x8[e], t[e], quad);
  }
  const uint32_t wu = smem_u32(s.ws + warp * DP);
  float est = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j >= d) break;
    est = fmaf(x[j], lds_f32(wu + 4 * j), est);
  }
  const float score = __fadd_rn(
      est, __fmul_rn(__fmul_rn(alpha, sqrt_rn(quad_floor(quad))), ex));
  const bool valid = lane < m;
  rescored += m;
  viol += __popc(__ballot_sync(kFull, valid && score > cd.ub));
  float* ls = s.ls + warp * k;
  int* li = s.li + warp * k;
  // the ring holds live pairs only: a NaN poisons the list
  if (__any_sync(kFull, valid && isnan(score))) poison(ls, li, k, lane);
  const bool cand = valid && !(score < pub) &&
                    beats(score, cd.id, ls[k - 1], li[k - 1]);
  merge32(ls, li, k, cand, score, cd.id, tc.ms + warp * 32, lane);
}

// A warp's ring of candidates and its counts, across the chunks.
struct Ring {
  int head, tail;
  int rescored, viol;
};

// The warp's user against the repacked chunk (rows [0, cnt), live flags,
// ids and int8 scales in buffer lb): kTcTiles tiles of 16 rows a step,
// the product on the tensor cores, the bound in the epilogue; the rows
// that pass join the warp's ring with their row, which is rescored 32 at
// a time once it holds 64.  ``pub``: the published floor (pruned; -inf
// otherwise).  ``id_of(r)``: row r's item id; ``pos_of(r)``: f32 items,
// its position in the catalog (the ring keeps it in the scale's place).
// f32 items take the product on both A tiles (hi, then lo) and the
// epilogue's features as the sum of the two fragments' (exact).
//
// The epilogue takes the tiles two at a time: lane (g, t) sums its
// features' share of q for rows g and g + 8 of both, and two rounds of
// shuffles leave each lane of the quad the whole q of one (tile, row):
// tile t / 2, row g + 8 (t % 2).  est comes from the accumulator's
// columns 30 and 31 (w's hi and lo pieces, at lane t = 3) where d <= 30,
// else from the lane's features as q's share is.
template <int ITEM, typename IdOf, typename PosOf>
__device__ __forceinline__ void filter_chunk(const Smem& s, const Tc& tc,
                                             const Filt& f, int d, int k,
                                             int cnt, int lb, float pub,
                                             float alpha, IdOf id_of,
                                             PosOf pos_of, Ring& q, int warp,
                                             int lane) {
  static_assert(kTcTiles % 2 == 0, "tiles go two at a time");
  const int g = lane >> 2, t = lane & 3;
  const bool hi_tile = t >= 2, hi_row = t & 1;
  const float* ls = s.ls + warp * k;
  const uint32_t qc = smem_u32(tc.qc + warp * kQueue);
  const uint32_t qx = ITEM == 0 ? 0u : smem_u32(tc.qx + warp * kQueue * 4);
  const uint32_t xa = smem_u32(tc.xa), rns = smem_u32(tc.rn);
  const uint32_t xl = ITEM == 0 ? smem_u32(tc.xl) : 0u;
  const uint32_t lvs = smem_u32(s.lv + lb * kTcRows);
  const uint32_t scs = smem_u32(s.sc + lb * kTcRows);
  float bar = fmaxf(ls[k - 1], pub);  // the floor a pair must reach
  const int tiles = (cnt + 15) >> 4;
  for (int rt0 = 0; rt0 < tiles; rt0 += kTcTiles) {
    // kTcRows is a multiple of 16 kTcTiles: the step's tiles lie in the
    // A tile (zero rows past cnt)
    uint32_t a[kTcTiles][2][4];
    uint32_t al[ITEM == 0 ? kTcTiles : 1][2][4];  // f32 items: lo pieces
    float acc[kTcTiles][4][4];
#pragma unroll
    for (int tt = 0; tt < kTcTiles; ++tt) {
      const int lrow = (rt0 + tt) * 16 + (lane & 15);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int word = xa_word(lrow, 2 * ks + (lane >> 4));
        ldsm_x4(a[tt][ks], xa + word);
        if constexpr (ITEM == 0) ldsm_x4(al[tt][ks], xl + word);
      }
    }
    // the lane's rows (one a pair of tiles): bounds, live flags, scales
    constexpr int P = kTcTiles / 2;
    int row[P];
    float2 rnv[P];
    float lvv[P], sc[P];
#pragma unroll
    for (int pp = 0; pp < P; ++pp) {
      row[pp] =
          (rt0 + 2 * pp + (hi_tile ? 1 : 0)) * 16 + g + (hi_row ? 8 : 0);
      rnv[pp] = lds_f2(rns + 8 * row[pp]);
      lvv[pp] = lds_f32(lvs + 4 * row[pp]);
      sc[pp] = ITEM == 2 ? lds_f32(scs + 4 * row[pp]) : 1.f;
    }
#pragma unroll
    for (int tt = 0; tt < kTcTiles; ++tt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[tt][nt][e] = 0.f;
    // the product: hi piece, then lo where Minv has one, or (f32 items,
    // a bf16 Minv) the items' lo piece against Minv's one (the
    // accumulator of each (tile, n-tile) takes its k-steps in order)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int tt = 0; tt < kTcTiles; ++tt)
          mma_bf16(acc[tt][nt], a[tt][ks], f.bh[nt][ks]);
    if constexpr (ITEM == 0) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int tt = 0; tt < kTcTiles; ++tt)
            mma_bf16(acc[tt][nt], al[tt][ks], f.bh[nt][ks]);
    } else if (f.two) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int tt = 0; tt < kTcTiles; ++tt)
            mma_bf16(acc[tt][nt], a[tt][ks], f.bl[nt][ks]);
    }
    float ub[P];
    bool pass[P];
#pragma unroll
    for (int pp = 0; pp < P; ++pp) {
      // the lane's share for rows g (0) and g + 8 (1) of the pair's tiles:
      // features 8 nt + 2t + {0, 1}, from a[nt / 2][2 (nt % 2)] (row g)
      // and the register after it (g + 8), as the accumulator's columns
      float qv[2][2], ev[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tt = 2 * pp + h;
        float qg = 0.f, qh = 0.f, eg = 0.f, eh = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t ag = a[tt][nt >> 1][2 * (nt & 1)];
          const uint32_t ah = a[tt][nt >> 1][2 * (nt & 1) + 1];
          float g0 = bf_lo(ag), g1 = bf_hi(ag), h0 = bf_lo(ah),
                h1 = bf_hi(ah);
          if constexpr (ITEM == 0) {  // a = ahi + alo, exact
            const uint32_t lg = al[tt][nt >> 1][2 * (nt & 1)];
            const uint32_t lh = al[tt][nt >> 1][2 * (nt & 1) + 1];
            g0 += bf_lo(lg);
            g1 += bf_hi(lg);
            h0 += bf_lo(lh);
            h1 += bf_hi(lh);
          }
          qg = fmaf(g0, acc[tt][nt][0], qg);
          qg = fmaf(g1, acc[tt][nt][1], qg);
          qh = fmaf(h0, acc[tt][nt][2], qh);
          qh = fmaf(h1, acc[tt][nt][3], qh);
          if (!f.est_tc) {
            eg = fmaf(g0, f.wv[nt][0], eg);
            eg = fmaf(g1, f.wv[nt][1], eg);
            eh = fmaf(h0, f.wv[nt][0], eh);
            eh = fmaf(h1, f.wv[nt][1], eh);
          }
        }
        if (f.est_tc) {  // columns 30 and 31 at t = 3: w's hi + lo
          eg = acc[tt][3][0] + acc[tt][3][1];
          eh = acc[tt][3][2] + acc[tt][3][3];
        }
        qv[h][0] = qg;
        qv[h][1] = qh;
        ev[h][0] = eg;
        ev[h][1] = eh;
      }
      // round 1 (lanes t ^ 2): keep tile t / 2; round 2 (t ^ 1): keep
      // row t % 2
      const float q0 = (hi_tile ? qv[1][0] : qv[0][0]) +
                       __shfl_xor_sync(kFull, hi_tile ? qv[0][0] : qv[1][0], 2);
      const float q1 = (hi_tile ? qv[1][1] : qv[0][1]) +
                       __shfl_xor_sync(kFull, hi_tile ? qv[0][1] : qv[1][1], 2);
      float qs = (hi_row ? q1 : q0) +
                 __shfl_xor_sync(kFull, hi_row ? q0 : q1, 1);
      float es;
      if (f.est_tc) {
        const int src = lane | 3;
        const float e00 = __shfl_sync(kFull, ev[0][0], src);
        const float e01 = __shfl_sync(kFull, ev[0][1], src);
        const float e10 = __shfl_sync(kFull, ev[1][0], src);
        const float e11 = __shfl_sync(kFull, ev[1][1], src);
        es = hi_tile ? (hi_row ? e11 : e10) : (hi_row ? e01 : e00);
      } else {
        const float e0 =
            (hi_tile ? ev[1][0] : ev[0][0]) +
            __shfl_xor_sync(kFull, hi_tile ? ev[0][0] : ev[1][0], 2);
        const float e1 =
            (hi_tile ? ev[1][1] : ev[0][1]) +
            __shfl_xor_sync(kFull, hi_tile ? ev[0][1] : ev[1][1], 2);
        es = (hi_row ? e1 : e0) +
             __shfl_xor_sync(kFull, hi_row ? e0 : e1, 1);
      }
      if constexpr (ITEM == 2) {
        qs = __fmul_rn(__fmul_rn(sc[pp], sc[pp]), qs);
        es = __fmul_rn(sc[pp], es);
      }
      ub[pp] = score_bound(qs, es, rnv[pp], f, alpha);
      pass[pp] = row[pp] < cnt && lvv[pp] > 0.f &&
                 !(ub[pp] < bar);
    }
#pragma unroll
    for (int pp = 0; pp < P; ++pp) {
      const unsigned m = __ballot_sync(kFull, pass[pp]);
      if (pass[pp]) {
        const int p =
            (q.tail + __popc(m & ((1u << lane) - 1))) & (kQueue - 1);
        const uint32_t ca = qc + sizeof(Cand) * p;
        sts_u32(ca, __float_as_uint(ub[pp]));
        sts_u32(ca + 4, (uint32_t)id_of(row[pp]));
        if constexpr (ITEM == 0) {
          sts_u32(ca + 8, (uint32_t)pos_of(row[pp]));
        } else {
          sts_u32(ca + 8, __float_as_uint(sc[pp]));
#pragma unroll
          for (int w4 = 0; w4 < 4; ++w4)
            sts_u4(qx + 64 * p + 16 * w4, lds_u4(xa + xa_word(row[pp], w4)));
        }
      }
      q.tail += __popc(m);
    }
    if (q.tail - q.head >= 64) {
      __syncwarp();
      do {
        rescore<ITEM>(s, tc, d, k, alpha, f.ex, pub, q.head, 32, q.rescored,
                      q.viol, warp, lane);
        q.head += 32;
      } while (q.tail - q.head >= 64);
      bar = fmaxf(ls[k - 1], pub);
    }
  }
  __syncwarp();
}

// The rest of the warp's ring, 32 at a time.
template <int ITEM>
__device__ __forceinline__ void flush_ring(const Smem& s, const Tc& tc,
                                           const Filt& f, int d, int k,
                                           float pub, float alpha, Ring& q,
                                           int warp, int lane) {
  __syncwarp();
  while (q.tail > q.head) {
    const int m = min(32, q.tail - q.head);
    rescore<ITEM>(s, tc, d, k, alpha, f.ex, pub, q.head, m, q.rescored,
                  q.viol, warp, lane);
    q.head += m;
  }
  __syncwarp();
}

// The filter counts of warp ``warp`` of block (g, split): pairs rescored
// and violations, at fstats[((g S + split) 8 + warp) 2 + {0, 1}].
__device__ __forceinline__ void write_fstats(int* fstats, int S, int split,
                                             const Ring& q, int warp,
                                             int lane) {
  if (lane == 0) {
    const size_t at = (((size_t)blockIdx.x * S + split) * kUsers + warp) * 2;
    fstats[at] = q.rescored;
    fstats[at + 1] = q.viol;
  }
}

template <int ITEM>
__global__ void __launch_bounds__(kThreads, 1)
    topk_tc_kernel(const float* __restrict__ w, const void* __restrict__ Minv,
                   int minv_bf16, const int* __restrict__ occ,
                   const void* __restrict__ items,
                   const float* __restrict__ live,
                   const float* __restrict__ scales, float alpha, int n,
                   int N, int d, int k, int S, float* __restrict__ out_s,
                   int* __restrict__ out_i, int* __restrict__ fstats) {
  using T = typename ItemType<ITEM>::T;
  extern __shared__ __align__(16) float smem[];
  constexpr int CH = kTcRows;
  Tc tc;
  const Smem s = carve_tc(smem, d, k, false, ITEM, tc);
  tc.rows = ITEM == 0 ? static_cast<const float*>(items) : nullptr;
  const int u0 = blockIdx.x * kUsers, split = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_chunks = (N + CH - 1) / CH;
  auto stage = [&](int c, int lb) {
    const size_t first = (size_t)c * CH;
    stage_chunk<ITEM>(items, live, nullptr, scales, first,
                      min(CH, N - (int)first), 0, 0, d, CH, s, lb);
    cp_commit();
  };
  if (split < n_chunks) stage(split, 0);
  stage_users_tc_of(w, Minv, minv_bf16, occ, nullptr, n, d, k, u0, tc.DP, s);
  __syncthreads();
  const bool mine = u0 + warp < n;
  Filt f;
  if (mine) filt_setup(s, d, tc.DP, warp, lane, ITEM == 0, f);
  Ring q{0, 0, 0, 0};
  int lb = 0;
  for (int c = split; c < n_chunks; c += S) {
    cp_wait_all();
    __syncthreads();  // chunk c has arrived; the last chunk is filtered
    const size_t first = (size_t)c * CH;
    const int cnt = min(CH, N - (int)first);
    if constexpr (ITEM == 0) {
      repack_split(s, tc, d, cnt);
    } else {
      const T* src = static_cast<const T*>(items) + first * d;
      repack<ITEM>(s, tc, d, cnt, lb, [&](int r) {
          return region_at(s, 0, src) + (size_t)r * d * sizeof(T);
        });
    }
    __syncthreads();  // the A tile is ready, the chunk buffer free
    if (c + S < n_chunks) stage(c + S, lb ^ 1);
    if (mine) {
      const auto at = [&](int r) { return (int)(first + r); };
      filter_chunk<ITEM>(s, tc, f, d, k, cnt, lb, -INFINITY, alpha, at, at,
                         q, warp, lane);
      if (((c - split) / S) % kTcFlush == kTcFlush - 1)
        flush_ring<ITEM>(s, tc, f, d, k, -INFINITY, alpha, q, warp, lane);
    }
    lb ^= 1;
  }
  if (mine) flush_ring<ITEM>(s, tc, f, d, k, -INFINITY, alpha, q, warp, lane);
  __syncthreads();  // lists staged by other warps when nothing streamed
  write_lists(s, nullptr, n, k, u0, split, out_s, out_i);
  write_fstats(fstats, S, split, q, warp, lane);
}

template <int ITEM>
__global__ void __launch_bounds__(kThreads, 1)
    topk_pruned_tc_kernel(const float* __restrict__ w,
                          const void* __restrict__ Minv, int minv_bf16,
                          const int* __restrict__ occ,
                          const void* __restrict__ items,
                          const float* __restrict__ live,
                          const int* __restrict__ ids,
                          const float* __restrict__ scales,
                          const long long* __restrict__ user_order,
                          const float* __restrict__ tb_walk,
                          const long long* __restrict__ tile_order,
                          int* gfloor, float alpha, int n, int T, int tile,
                          int d, int k, int S, float* __restrict__ out_s,
                          int* __restrict__ out_i, int* __restrict__ skipped,
                          int* __restrict__ fstats) {
  using Item = typename ItemType<ITEM>::T;
  extern __shared__ __align__(16) float smem[];
  constexpr int CH = kTcRows;
  Tc tc;
  const Smem s = carve_tc(smem, d, k, true, ITEM, tc);
  tc.rows = ITEM == 0 ? static_cast<const float*>(items) : nullptr;
  Walk& wk = *s.walk;
  const int g = blockIdx.x, split = blockIdx.y;
  const int u0 = g * kUsers;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long* order = tile_order + (size_t)g * T;
  const float* tbw = tb_walk + (size_t)g * T * kUsers;
  const int TPC = tiles_per_chunk(tile, CH);
  const int SPT = tile > CH ? (tile + CH - 1) / CH : 1;  // slices a tile
  auto rows = [&](const Chunk& c) {
    return SPT > 1 ? min(CH, tile - c.slice * CH) : c.n_tiles * tile;
  };
  const int R = region_bytes(tile, d, ITEM);
  auto src_of = [&](const Chunk& c, int q) {  // the first row of tile q
    return static_cast<const Item*>(items) +
           ((size_t)c.tiles[q] * tile + (size_t)c.slice * CH) * d;
  };
  auto stage = [&](int b) {
    const Chunk& c = wk.chunk[b];
    for (int q = 0; q < c.n_tiles; ++q)
      stage_chunk<ITEM>(items, live, ids, scales,
                        (size_t)c.tiles[q] * tile + (size_t)c.slice * CH,
                        SPT > 1 ? rows(c) : tile, q * tile, q * R, d, CH, s,
                        b);
    cp_commit();
  };
  auto next_chunk = [&](int b, bool own, int tpc) {
    if (warp == 0)
      pick_chunk(wk, wk.chunk[b], wk.chunk[b ^ 1], s, gfloor, order, tbw, T,
                 S, split, n, u0, k, own, tpc, SPT, lane);
    __syncthreads();  // the chunk buffer is free; the next chunk is picked
    stage(b);
  };
  if (threadIdx.x == 0) {
    wk.next = 0;
    wk.skipped = 0;
    wk.chunk[1].n_tiles = 0;
  }
  __syncthreads();
  next_chunk(0, false, 1);  // the first chunk: one tile, published floors
  stage_users_tc_of(w, Minv, minv_bf16, occ, user_order, n, d, k, u0, tc.DP,
                    s);
  __syncthreads();
  const bool mine = u0 + warp < n;
  Filt f;
  if (mine) filt_setup(s, d, tc.DP, warp, lane, ITEM == 0, f);
  Ring q{0, 0, 0, 0};
  int lb = 0, n_chunks = 0;
  for (bool first = true;; first = false) {
    cp_wait_all();
    __syncthreads();  // chunk lb has arrived; the last chunk is filtered
    const Chunk& c = wk.chunk[lb];
    if (c.n_tiles == 0) break;
    if constexpr (ITEM == 0) {
      repack_split(s, tc, d, rows(c));
    } else {
      repack<ITEM>(s, tc, d, rows(c), lb, [&](int r) {
        int qt = r / tile;  // 0 where tile > CH: one tile's slice
        if (qt >= c.n_tiles) qt = 0;
        return region_at(s, qt * R, src_of(c, qt)) +
               (size_t)(r - qt * tile) * d * sizeof(Item);
      });
    }
    if (first)
      __syncthreads();  // the A tile is ready
    else
      next_chunk(lb ^ 1, true, TPC);  // floors before c's filter
    if (mine) {
      const int* id_s = s.id + lb * CH;
      filter_chunk<ITEM>(
          s, tc, f, d, k, rows(c), lb, wk.pub[warp], alpha,
          [&](int r) { return id_s[r]; },
          [&](int r) {  // the row's position in the sorted catalog
            const int qt = SPT > 1 ? 0 : r / tile;
            return c.tiles[qt] * tile + c.slice * CH + (r - qt * tile);
          },
          q, warp, lane);
      // the first chunk's candidates are all rescored before its floor is
      // published and the second chunk is picked against it; later, every
      // warp empties its ring every kTcFlush chunks, all in the same chunk
      if (first || ++n_chunks % kTcFlush == 0)
        flush_ring<ITEM>(s, tc, f, d, k, wk.pub[warp], alpha, q, warp,
                         lane);
      const float fl = s.ls[warp * k + k - 1];  // publish once a chunk
      if (lane == 0 && fl > -INFINITY) atomicMax(gfloor + u0 + warp, f2o(fl));
    }
    if (first) {  // the second chunk, against the first one's floors
      __syncthreads();
      next_chunk(lb ^ 1, true, TPC);
    }
    lb ^= 1;
  }
  if (mine)
    flush_ring<ITEM>(s, tc, f, d, k, wk.pub[warp], alpha, q, warp, lane);
  __syncthreads();  // lists staged by other warps when nothing streamed
  write_lists(s, user_order, n, k, u0, split, out_s, out_i);
  if (threadIdx.x == 0) skipped[(size_t)g * S + split] = wk.skipped;
  write_fstats(fstats, S, split, q, warp, lane);
}

bool valid_tc(int d, int k, int item) {
  return d >= 1 && d <= kSmallD && k >= 1 && k <= kMaxK && item >= 0 &&
         item <= 2;
}

// f32 items only with a bf16 Minv (header, "f32 items")
bool valid_minv(int item, int minv_bf16) { return item != 0 || minv_bf16; }

using TcFn = void (*)(const float*, const void*, int, const int*,
                      const void*, const float*, const float*, float, int,
                      int, int, int, int, float*, int*, int*);
using PrunedTcFn = void (*)(const float*, const void*, int, const int*,
                            const void*, const float*, const int*,
                            const float*, const long long*, const float*,
                            const long long*, int*, float, int, int, int,
                            int, int, int, float*, int*, int*, int*);

TcFn tc_fn(int item) {
  return item == 0   ? topk_tc_kernel<0>
         : item == 1 ? topk_tc_kernel<1>
                     : topk_tc_kernel<2>;
}
PrunedTcFn pruned_tc_fn(int item) {
  return item == 0   ? topk_pruned_tc_kernel<0>
         : item == 1 ? topk_pruned_tc_kernel<1>
                     : topk_pruned_tc_kernel<2>;
}

int launch_topk_tc(const float* w, const void* Minv, int minv_bf16,
                   const int* occ, const void* items, const float* live,
                   const float* scales, int item, float alpha, int n, int N,
                   int d, int k, int S, float* part_s, int* part_i,
                   float* out_s, int* out_i, int* fstats,
                   cudaStream_t stream) {
  const size_t bytes = tc_smem_bytes(d, k, false, item);
  if (!valid_tc(d, k, item) || !valid_minv(item, minv_bf16) || S < 1 ||
      bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kUsers - 1) / kUsers, S);
  float* ls = S == 1 ? out_s : part_s;
  int* li = S == 1 ? out_i : part_i;
  const TcFn kernel = tc_fn(item);
  cudaError_t e;
  if ((e = allow_smem(kernel, bytes)) != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, bytes, stream>>>(w, Minv, minv_bf16, occ, items,
                                            live, scales, alpha, n, N, d, k,
                                            S, ls, li, fstats);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (S > 1) return (int)merge(part_s, part_i, n, k, S, out_s, out_i, stream);
  return 0;
}

int launch_pruned_tc(const float* w, const void* Minv, int minv_bf16,
                     const int* occ, const void* items, const float* live,
                     const int* ids, const float* scales, int item,
                     const long long* user_order, const float* tb_walk,
                     const long long* tile_order, int* gfloor, float alpha,
                     int n, int T, int tile, int d, int k, int S,
                     float* part_s, int* part_i, float* out_s, int* out_i,
                     int* skipped, int* fstats, cudaStream_t stream) {
  const size_t bytes = tc_smem_bytes(d, k, true, item);
  if (!valid_tc(d, k, item) || !valid_minv(item, minv_bf16) || S < 1 ||
      tile < 1 || bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kUsers - 1) / kUsers, S);
  float* ls = S == 1 ? out_s : part_s;
  int* li = S == 1 ? out_i : part_i;
  const PrunedTcFn kernel = pruned_tc_fn(item);
  cudaError_t e;
  if ((e = allow_smem(kernel, bytes)) != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, bytes, stream>>>(
      w, Minv, minv_bf16, occ, items, live, ids, scales, user_order, tb_walk,
      tile_order, gfloor, alpha, n, T, tile, d, k, S, ls, li, skipped,
      fstats);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (S > 1) return (int)merge(part_s, part_i, n, k, S, out_s, out_i, stream);
  return 0;
}

}  // namespace

// The filter kernels (bf16 and int8 items, and f32 items with a bf16
// Minv, at d <= 32; the header's "Filter"): the chain kernels' entries
// with Minv f32 or bf16, plus fstats [groups, S, 8, 2] i32, which
// receives each warp's rescored pairs and violations.  A shape they do
// not take is refused (cudaErrorInvalidValue), as is an f32 Minv over
// f32 items, which no entry passes.
extern "C" int topk_tc_blocks_per_sm(int d, int k, int pruned, int item,
                                     int* blocks) {
  const size_t bytes = tc_smem_bytes(d, k, pruned, item);
  if (!valid_tc(d, k, item) || bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (pruned) {
    const PrunedTcFn fn = pruned_tc_fn(item);
    if ((e = allow_smem(fn, bytes)) != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads,
                                                      bytes);
  } else {
    const TcFn fn = tc_fn(item);
    if ((e = allow_smem(fn, bytes)) != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads,
                                                      bytes);
  }
  return (int)e;
}

extern "C" int topk_bf16_tc_launch(const float* w, const float* Minv,
                                   const int* occ,
                                   const __nv_bfloat16* items,
                                   const float* live, float alpha, int n,
                                   int N, int d, int k, int S, float* part_s,
                                   int* part_i, float* out_s, int* out_i,
                                   int* fstats, cudaStream_t stream) {
  return launch_topk_tc(w, Minv, 0, occ, items, live, nullptr, 1, alpha, n,
                        N, d, k, S, part_s, part_i, out_s, out_i, fstats,
                        stream);
}

extern "C" int topk_int8_tc_launch(const float* w, const float* Minv,
                                   const int* occ, const signed char* items,
                                   const float* live, const float* scales,
                                   float alpha, int n, int N, int d, int k,
                                   int S, float* part_s, int* part_i,
                                   float* out_s, int* out_i, int* fstats,
                                   cudaStream_t stream) {
  return launch_topk_tc(w, Minv, 0, occ, items, live, scales, 2, alpha, n,
                        N, d, k, S, part_s, part_i, out_s, out_i, fstats,
                        stream);
}

extern "C" int topk_minv_bf16_tc_launch(
    const float* w, const __nv_bfloat16* Minv, const int* occ,
    const float* items, const float* live, float alpha, int n, int N, int d,
    int k, int S, float* part_s, int* part_i, float* out_s, int* out_i,
    int* fstats, cudaStream_t stream) {
  return launch_topk_tc(w, Minv, 1, occ, items, live, nullptr, 0, alpha, n,
                        N, d, k, S, part_s, part_i, out_s, out_i, fstats,
                        stream);
}

extern "C" int topk_minv_bf16_bf16_tc_launch(
    const float* w, const __nv_bfloat16* Minv, const int* occ,
    const __nv_bfloat16* items, const float* live, float alpha, int n, int N,
    int d, int k, int S, float* part_s, int* part_i, float* out_s,
    int* out_i, int* fstats, cudaStream_t stream) {
  return launch_topk_tc(w, Minv, 1, occ, items, live, nullptr, 1, alpha, n,
                        N, d, k, S, part_s, part_i, out_s, out_i, fstats,
                        stream);
}

extern "C" int topk_minv_bf16_int8_tc_launch(
    const float* w, const __nv_bfloat16* Minv, const int* occ,
    const signed char* items, const float* live, const float* scales,
    float alpha, int n, int N, int d, int k, int S, float* part_s,
    int* part_i, float* out_s, int* out_i, int* fstats,
    cudaStream_t stream) {
  return launch_topk_tc(w, Minv, 1, occ, items, live, scales, 2, alpha, n,
                        N, d, k, S, part_s, part_i, out_s, out_i, fstats,
                        stream);
}

extern "C" int topk_pruned_bf16_tc_launch(
    const float* w, const float* Minv, const int* occ,
    const __nv_bfloat16* items, const float* live, const int* ids,
    const long long* user_order, const float* tb_walk,
    const long long* tile_order, int* gfloor, float alpha, int n, int T,
    int tile, int d, int k, int S, float* part_s, int* part_i, float* out_s,
    int* out_i, int* skipped, int* fstats, cudaStream_t stream) {
  return launch_pruned_tc(w, Minv, 0, occ, items, live, ids, nullptr, 1,
                          user_order, tb_walk, tile_order, gfloor, alpha, n,
                          T, tile, d, k, S, part_s, part_i, out_s, out_i,
                          skipped, fstats, stream);
}

extern "C" int topk_pruned_int8_tc_launch(
    const float* w, const float* Minv, const int* occ,
    const signed char* items, const float* live, const int* ids,
    const float* scales, const long long* user_order, const float* tb_walk,
    const long long* tile_order, int* gfloor, float alpha, int n, int T,
    int tile, int d, int k, int S, float* part_s, int* part_i, float* out_s,
    int* out_i, int* skipped, int* fstats, cudaStream_t stream) {
  return launch_pruned_tc(w, Minv, 0, occ, items, live, ids, scales, 2,
                          user_order, tb_walk, tile_order, gfloor, alpha, n,
                          T, tile, d, k, S, part_s, part_i, out_s, out_i,
                          skipped, fstats, stream);
}

extern "C" int topk_pruned_minv_bf16_tc_launch(
    const float* w, const __nv_bfloat16* Minv, const int* occ,
    const float* items, const float* live, const int* ids,
    const long long* user_order, const float* tb_walk,
    const long long* tile_order, int* gfloor, float alpha, int n, int T,
    int tile, int d, int k, int S, float* part_s, int* part_i, float* out_s,
    int* out_i, int* skipped, int* fstats, cudaStream_t stream) {
  return launch_pruned_tc(w, Minv, 1, occ, items, live, ids, nullptr, 0,
                          user_order, tb_walk, tile_order, gfloor, alpha, n,
                          T, tile, d, k, S, part_s, part_i, out_s, out_i,
                          skipped, fstats, stream);
}

extern "C" int topk_pruned_minv_bf16_bf16_tc_launch(
    const float* w, const __nv_bfloat16* Minv, const int* occ,
    const __nv_bfloat16* items, const float* live, const int* ids,
    const long long* user_order, const float* tb_walk,
    const long long* tile_order, int* gfloor, float alpha, int n, int T,
    int tile, int d, int k, int S, float* part_s, int* part_i, float* out_s,
    int* out_i, int* skipped, int* fstats, cudaStream_t stream) {
  return launch_pruned_tc(w, Minv, 1, occ, items, live, ids, nullptr, 1,
                          user_order, tb_walk, tile_order, gfloor, alpha, n,
                          T, tile, d, k, S, part_s, part_i, out_s, out_i,
                          skipped, fstats, stream);
}

extern "C" int topk_pruned_minv_bf16_int8_tc_launch(
    const float* w, const __nv_bfloat16* Minv, const int* occ,
    const signed char* items, const float* live, const int* ids,
    const float* scales, const long long* user_order, const float* tb_walk,
    const long long* tile_order, int* gfloor, float alpha, int n, int T,
    int tile, int d, int k, int S, float* part_s, int* part_i, float* out_s,
    int* out_i, int* skipped, int* fstats, cudaStream_t stream) {
  return launch_pruned_tc(w, Minv, 1, occ, items, live, ids, scales, 2,
                          user_order, tb_walk, tile_order, gfloor, alpha, n,
                          T, tile, d, k, S, part_s, part_i, out_s, out_i,
                          skipped, fstats, stream);
}
