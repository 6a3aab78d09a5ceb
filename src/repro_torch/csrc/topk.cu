// Streaming UCB top-K over the item catalog, unpruned and cluster-pruned
// (the retrieval engine of catalog serving).
//
// Replaces: src/repro/kernels/topk/topk.py, topk_pallas (body _topk_kernel)
//           and topk_pruned_pallas (body _topk_pruned_kernel).
//
// Computes, per user u and live item i:
//   s[u,i] = x_i.w_u + alpha sqrt(max(x_i Minv_u x_i, 0)) sqrt(log1p(occ_u))
// and keeps each user's k best by (score desc, id asc); dead items never
// enter, an underfull list holds (-inf, -1).  The [n, N] score matrix never
// reaches device memory.
//
// Bound on an H100: operations.  Per (user, live item) pair the score is
// 2d^2 + 4d + 6 f32 operations against d floats of the item read once per
// block of users; at B=256 users, N=2^18 items, d=25 that is ~9.1e10
// operations, ~1.36 ms at 67 TFLOP/s, against 26 MB of catalog (~8 us).
//
// Design, for a block of 8 users and 256 threads:
// - The users' Minv, w and widen factor are staged once in shared memory,
//   Minv as [(i d + j) * 8 + u], so one float4 pair broadcasts the 8 users'
//   M_ij to the whole block.
// - The catalog streams through shared memory in chunks of CH = 256*TK
//   rows (row-major, odd row stride against bank conflicts; one contiguous
//   16-byte cp.async copy where d is odd) with their live flags (and,
//   pruned, their ids).  Thread t owns rows t, t + 256, ... of the chunk
//   and first loads their features into registers (DMAX = 32 or 64, a
//   compile-time bucket of d): TK = 4 rows at d <= 32 (128 registers), 1
//   above.  Then the block stages the next chunk into the same buffer (the
//   live flags and ids alternate between two) while it scores this one.
// - Scoring (score_items, the one routine of both kernels): for each i
//   the j loop runs in straight-line blocks of 8 steps (the loads of a
//   block are scheduled ahead of its FMAs) and a tail guarded by d; a
//   step reads only the 8 users' M_ij from shared memory, two broadcast
//   float4s for 8 TK FMAs; x_i comes from the registers through a jump
//   table.  The FMA chains are those of csrc/ucb_score.cuh (t over j from
//   0, quad over i, est over j; sqrt_rn is sqrtf bit for bit), so a score
//   here is bit-equal to ucb's and choose's score of the same item, and
//   identical items tie bit-exactly.  Scores go to a [8, CH] shared tile.
// - Selection: one warp per user keeps a sorted list of k (score, id) in
//   shared memory.  Lanes test 128 items at a time (4 each) against the
//   list's floor (the k-th entry) by value (>, ==: -0.0 and 0.0 tie); the
//   few that beat it are inserted one by one (ballot, then a warp-parallel
//   rank and shift).  Insertion order does not change the result: the list is the
//   top k of a set under a total order.
// - The grid is (user groups, splits): each split of a group streams every
//   S-th chunk (pruned: every S-th tile of the group's order) and writes a
//   partial list; a merge kernel folds the S partial lists per user with
//   the same insertion (S == 1 writes the output directly).  The wrapper
//   sizes S from the resident blocks per SM (topk_blocks_per_sm, the
//   occupancy API) so the grid fills whole waves or fits in one
//   (kernels/topk/ops.py launch_plan).
// - Pruned: the catalog arrives cluster-sorted with per-(user, tile) upper
//   bounds tb and a per-group tile order (bound-descending), which the
//   wrapper also uses to lay each group's bounds out in visit order.  A
//   chunk gathers the next tiles_per_chunk tiles of the split's walk that
//   pass the skip test (a tile longer than CH streams in CH-row slices,
//   one a chunk); its rows carry their own ids and live flags, so the
//   scan needs nothing else.  A split's first chunk is its first passing
//   tile alone, scored and scanned before the second is picked, so that
//   the second is tested against the block's own floors (a split that
//   walks few tiles would otherwise take them all before any list
//   exists).  From then on warp 0 picks chunk c + 1 (32 positions of the
//   walk a round, one a lane: a tile id and two float4s of bounds,
//   independent loads, then a ballot) while the other warps load chunk c
//   into registers; the block stages it while it scores chunk c, so no
//   copy waits on the critical path.  A tile is skipped when every valid
//   user has tb[u,t] strictly below its floor: the larger of the block's
//   own k-th score (before chunk c's scan) and the best k-th score any
//   split of the same users has published (atomicMax on an
//   order-preserving int encoding, once a chunk).  Any list's k-th score
//   lower-bounds the final k-th score, so skipping against an older floor
//   is exact; it only skips less.  The scan drops items strictly below
//   the published floor too: the walk brings a user's best tiles in
//   bursts of inserts, one warp's at a time while the block waits, and a
//   split whose sibling has seen that user's best items skips its burst.
//   Skip counts depend on timing; the shortlist does not.  Both kernels
//   score through score_items, so the pruned shortlist is bit-equal to
//   the unpruned one.
//
// Reduced-precision catalogs (the ITEM template code: 0 f32, 1 bf16, 2
// int8 with a per-row f32 scale; topk_pallas's and topk_pruned_pallas's
// bf16 and int8 cases): a row is 2d or d bytes (50 or 25 at d = 25), so
// the f32 staging, which copies whole floats into padded rows, does not
// apply.  The block stages the chunk's byte range instead, contiguous for
// the unpruned kernel and per tile for the pruned one: 16-byte cp.async
// for the aligned body, placed at the source's own offset mod 16 within
// the region, and plain byte copies for the at most 15 bytes at each end.
// The int8 scales are staged beside the live flags.  A thread widens its
// rows to f32 as it loads them into registers (load_items): bf16 exactly,
// int8 as __fmul_rn(code, scale), one rounding that nvcc cannot contract
// into the scoring FMAs, as the plain version's items.float() * scale
// rounds.  From there score_items and the ucb_score.cuh chains run
// unchanged, so a shortlisted score is ucb's score of the dequantized
// item and the pruned shortlist stays bit-equal to the unpruned one.
// These chain kernels serve bf16 and int8 items at 32 < d <= 64; at d <=
// 32 they are the yardstick of the filter kernels (topk_tc.cu, whose
// bound is their own).  The chain kernels' bound stays the operations'
// (the dequant is d multiplies an item per block of 8 users beside 2 d^2
// FMAs a pair); the catalog's bytes fall to a half (bf16) or about a
// quarter (int8).
//
// bf16 Minv (the topk_minv_bf16* and topk_pruned_minv_bf16* entries, each
// over the three item kinds; Precision's state dtype, the bf16 case of
// topk_pallas and topk_pruned_pallas, which widen it in VMEM): the
// users' Minv is read once a block, by stage_users, which widens each
// element (exact, widen.cuh) into the same f32 Ms tile.  Everything past
// it is the f32 kernels' code on the same f32 values, so a shortlist and
// its score bits are the f32-Minv kernel's on the widened Minv, and the
// shared memory, the occupancy and the split plan do not change.  The
// storage type is a launch argument (minv_bf16), not a template
// parameter: stage_users is the one place that reads it, and a second
// set of the twelve scoring instantiations would double the build for
// code that is the same past it.  On the chain kernels the bound stays
// the operations'; the filter kernels read a bf16 Minv as one piece.
//
// The filter kernels (bf16 and int8 items at d <= 32: a tensor-core bound
// in front of the same chains) are topk_tc.cu's; topk_shared.cuh holds
// what both sources run (the staging, the pruned walk, the lists and the
// merge of the splits), so each builds on its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sqrt_rn.cuh"
#include "widen.cuh"

namespace {

constexpr int kUsers = 8;       // users per block: one warp each to select
constexpr int kThreads = 256;
constexpr int kMaxK = 128;
constexpr int kSmallD = 32;     // d <= kSmallD: DMAX 32; else 64
constexpr int kMaxD = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // H100: 227 KB per block
constexpr int kMaxTiles = 32;   // tiles a pruned chunk gathers: a lane each

}  // namespace

#include "topk_shared.cuh"

namespace {

// Items a thread scores per chunk, in both kernels: 4 items' features in
// registers up to d = 32 (128 registers), 1 above (64).
__host__ __device__ inline int items_per_thread(int d) {
  return d <= kSmallD ? 4 : 1;
}

__host__ __device__ inline size_t score_smem_bytes(int d, int k, int TK,
                                                   bool pruned, int item) {
  const size_t CH = (size_t)kThreads * TK;
  return sizeof(float) * ((size_t)kUsers * d * d + (size_t)kUsers * d +
                          kUsers + chunk_floats(d, (int)CH, item) + 2 * CH +
                          (item == 2 ? 2 * CH : 0) + (pruned ? 2 * CH : 0) +
                          kUsers * CH + (size_t)kUsers * k) +
         sizeof(int) * (size_t)kUsers * k + (pruned ? sizeof(Walk) : 0);
}

__device__ Smem carve(float* base, int d, int k, int TK, bool pruned,
                      int item) {
  const int CH = kThreads * TK;
  Smem s;
  s.Ms = base;
  s.ws = s.Ms + kUsers * d * d;
  s.ex = s.ws + kUsers * d;
  s.xs = s.ex + kUsers;
  s.lv = s.xs + chunk_floats(d, CH, item);
  s.sc = s.lv + 2 * CH;
  s.id = reinterpret_cast<int*>(s.sc + (item == 2 ? 2 * CH : 0));
  s.ss = reinterpret_cast<float*>(s.id + (pruned ? 2 * CH : 0));
  s.ls = s.ss + kUsers * CH;
  s.li = reinterpret_cast<int*>(s.ls + kUsers * k);
  s.walk = reinterpret_cast<Walk*>(s.li + kUsers * k);
  return s;
}

// Stage the block's users (rows past n are zero; Minv, stored as S,
// widened to f32) and empty their lists.
template <typename S>
__device__ void stage_users(const float* __restrict__ w,
                            const S* __restrict__ Minv,
                            const int* __restrict__ occ,
                            const long long* __restrict__ order, int n,
                            int d, int k, int u0, const Smem& s) {
  const int dd = d * d;
  for (int e = threadIdx.x; e < kUsers * dd; e += kThreads) {
    const int u = e / dd, p = e - u * dd;
    s.Ms[p * kUsers + u] =
        u0 + u < n ? widen(Minv[user_of(order, u0 + u) * dd + p]) : 0.f;
  }
  for (int e = threadIdx.x; e < kUsers * d; e += kThreads) {
    const int u = e / d, j = e - u * d;
    s.ws[j * kUsers + u] =
        u0 + u < n ? w[user_of(order, u0 + u) * d + j] : 0.f;
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

// stage_users with Minv in its storage type: bf16 where minv_bf16, else f32
__device__ __forceinline__ void stage_users_of(
    const float* w, const void* Minv, int minv_bf16, const int* occ,
    const long long* order, int n, int d, int k, int u0, const Smem& s) {
  if (minv_bf16)
    stage_users(w, static_cast<const __nv_bfloat16*>(Minv), occ, order, n, d,
                k, u0, s);
  else
    stage_users(w, static_cast<const float*>(Minv), occ, order, n, d, k, u0,
                s);
}

// The thread's TK items of the staged chunk (items t, t + 256, ...) into
// registers; features past d are 0.  Reduced items are widened here:
// ``row_at(c)`` is chunk row c's first byte in the chunk buffer, and an
// int8 code is multiplied by its row's scale (scale buffer ``lb``) with
// one rounding, as the plain version's dequantization.
template <int DMAX, int TK, int ITEM, typename RowAt>
__device__ __forceinline__ void load_items(float (&x)[TK][DMAX],
                                           const Smem& s, int d, int lb,
                                           RowAt row_at) {
  if constexpr (ITEM == 0) {
    const int XS = stride_of(d);
#pragma unroll
    for (int q = 0; q < TK; ++q) {
      const float* row = s.xs + (threadIdx.x + q * kThreads) * XS;
#pragma unroll
      for (int j = 0; j < DMAX; ++j) x[q][j] = j < d ? row[j] : 0.f;
    }
  } else {
    using T = typename ItemType<ITEM>::T;
    constexpr int CH = kThreads * TK;
#pragma unroll
    for (int q = 0; q < TK; ++q) {
      const int c = threadIdx.x + q * kThreads;
      const T* row = reinterpret_cast<const T*>(row_at(c));
      if constexpr (ITEM == 1) {
#pragma unroll
        for (int j = 0; j < DMAX; ++j)
          x[q][j] = j < d ? __bfloat162float(row[j]) : 0.f;
      } else {
        const float sc = s.sc[lb * CH + c];
#pragma unroll
        for (int j = 0; j < DMAX; ++j)
          x[q][j] = j < d ? __fmul_rn((float)row[j], sc) : 0.f;
      }
    }
  }
}

// t[u][q] += M_ij x_j for one j (a constant once the caller's loop is
// unrolled): the 8 users' M_ij as two broadcast float4s.
template <int DMAX, int TK>
__device__ __forceinline__ void t_step(float (&t)[kUsers][TK],
                                       const float (&x)[TK][DMAX],
                                       const float* mrow, int j) {
  const float4 ma = *reinterpret_cast<const float4*>(mrow + j * kUsers);
  const float4 mb = *reinterpret_cast<const float4*>(mrow + j * kUsers + 4);
  const float mu[kUsers] = {ma.x, ma.y, ma.z, ma.w, mb.x, mb.y, mb.z, mb.w};
#pragma unroll
  for (int u = 0; u < kUsers; ++u)
#pragma unroll
    for (int q = 0; q < TK; ++q) t[u][q] = fmaf(mu[u], x[q][j], t[u][q]);
}

// Steps j = J0 .. J0 + 7 (``guard``: only those below d).  Unguarded, the
// eight steps are straight-line code, so their loads are scheduled ahead
// of the FMAs.
template <int J0, int DMAX, int TK>
__device__ __forceinline__ void t_block(float (&t)[kUsers][TK],
                                        const float (&x)[TK][DMAX],
                                        const float* mrow, bool guard,
                                        int d) {
  if constexpr (J0 < DMAX) {
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) {
      if (guard && J0 + j8 >= d) return;
      t_step<DMAX, TK>(t, x, mrow, J0 + j8);
    }
  }
}

// Score the thread's TK items (features in x) for the 8 users into
// ss[u][c].  The one scoring routine of both kernels.  Nothing is read
// from the chunk buffer, which the block restages meanwhile.
template <int DMAX, int TK>
__device__ __forceinline__ void score_items(const Smem& s,
                                            const float (&x)[TK][DMAX],
                                            int d, float alpha) {
  static_assert(DMAX % 8 == 0 && DMAX <= 64, "DMAX: 8 .. 64 by 8");
  constexpr int CH = kThreads * TK;
  float quad[kUsers][TK];
#pragma unroll
  for (int u = 0; u < kUsers; ++u)
#pragma unroll
    for (int q = 0; q < TK; ++q) quad[u][q] = 0.f;

  const int full = d / 8;  // blocks of 8 steps below d; then the tail
  for (int i = 0; i < d; ++i) {
    float t[kUsers][TK];
#pragma unroll
    for (int u = 0; u < kUsers; ++u)
#pragma unroll
      for (int q = 0; q < TK; ++q) t[u][q] = 0.f;
    const float* mrow = s.Ms + i * d * kUsers;
    // j ascending: the full blocks, then the tail block guarded by d
    if (full > 0) t_block<0, DMAX, TK>(t, x, mrow, false, d);
    if (full > 1) t_block<8, DMAX, TK>(t, x, mrow, false, d);
    if (full > 2) t_block<16, DMAX, TK>(t, x, mrow, false, d);
    if (full > 3) t_block<24, DMAX, TK>(t, x, mrow, false, d);
    if (full > 4) t_block<32, DMAX, TK>(t, x, mrow, false, d);
    if (full > 5) t_block<40, DMAX, TK>(t, x, mrow, false, d);
    if (full > 6) t_block<48, DMAX, TK>(t, x, mrow, false, d);
    if (full > 7) t_block<56, DMAX, TK>(t, x, mrow, false, d);
    switch (full) {
      case 0: t_block<0, DMAX, TK>(t, x, mrow, true, d); break;
      case 1: t_block<8, DMAX, TK>(t, x, mrow, true, d); break;
      case 2: t_block<16, DMAX, TK>(t, x, mrow, true, d); break;
      case 3: t_block<24, DMAX, TK>(t, x, mrow, true, d); break;
      case 4: t_block<32, DMAX, TK>(t, x, mrow, true, d); break;
      case 5: t_block<40, DMAX, TK>(t, x, mrow, true, d); break;
      case 6: t_block<48, DMAX, TK>(t, x, mrow, true, d); break;
      case 7: t_block<56, DMAX, TK>(t, x, mrow, true, d); break;
      default: break;
    }
    float xi[TK];
    pick<DMAX, TK>(x, i, xi);
#pragma unroll
    for (int q = 0; q < TK; ++q)
#pragma unroll
      for (int u = 0; u < kUsers; ++u)
        quad[u][q] = fmaf(xi[q], t[u][q], quad[u][q]);
  }
  float est[kUsers][TK];
#pragma unroll
  for (int u = 0; u < kUsers; ++u)
#pragma unroll
    for (int q = 0; q < TK; ++q) est[u][q] = 0.f;
#pragma unroll
  for (int j = 0; j < DMAX; ++j) {
    if (j >= d) break;
    const float4 wa = *reinterpret_cast<const float4*>(s.ws + j * kUsers);
    const float4 wb = *reinterpret_cast<const float4*>(s.ws + j * kUsers + 4);
    const float wu[kUsers] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int u = 0; u < kUsers; ++u)
#pragma unroll
      for (int q = 0; q < TK; ++q) est[u][q] = fmaf(x[q][j], wu[u], est[u][q]);
  }
#pragma unroll
  for (int u = 0; u < kUsers; ++u)
#pragma unroll
    for (int q = 0; q < TK; ++q) {
      const float bonus = __fmul_rn(
          __fmul_rn(alpha, sqrt_rn(fmaxf(quad[u][q], 0.f))), s.ex[u]);
      s.ss[u * CH + threadIdx.x + q * kThreads] = __fadd_rn(est[u][q], bonus);
    }
}

// The warp's user against the scored chunk (live flags and ids in buffer
// ``buf``): items at catalog rows [pos0, pos0 + cnt), ids from the staged
// ids (sorted catalog) or the row itself.  Each lane tests 4 items a
// step against the list's floor, and (pruned) against ``pub``, the
// best k-th score another split has published: an item strictly below
// it cannot be in the final list.  A step where none passes costs two
// float4 loads.
__device__ void scan_chunk(const Smem& s, int buf, int cnt, bool with_ids,
                           size_t pos0, float pub, int k, int CH, int warp,
                           int lane) {
  const float* ss_u = s.ss + warp * CH;
  const float* lv = s.lv + buf * CH;
  const int* id_s = s.id + buf * CH;
  float* ls = s.ls + warp * k;
  int* li = s.li + warp * k;
  for (int base = 0; base < cnt; base += 128) {  // CH is a multiple of 128
    const int c0 = base + 4 * lane;
    const float4 sv = *reinterpret_cast<const float4*>(ss_u + c0);
    const float4 lvv = *reinterpret_cast<const float4*>(lv + c0);
    int4 iv = make_int4(0, 0, 0, 0);
    if (with_ids) iv = *reinterpret_cast<const int4*>(id_s + c0);
    const float sc[4] = {sv.x, sv.y, sv.z, sv.w};
    const float lve[4] = {lvv.x, lvv.y, lvv.z, lvv.w};
    const int ide[4] = {iv.x, iv.y, iv.z, iv.w};
    const float fs = ls[k - 1];
    const int fi = li[k - 1];
    bool cand[4], any = false;
    int id[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      id[e] = with_ids ? ide[e] : (int)(pos0 + c0 + e);
      cand[e] = c0 + e < cnt && lve[e] > 0.f && !(sc[e] < pub) &&
                beats(sc[e], id[e], fs, fi);
      any |= cand[e];
    }
    if (__any_sync(kFull, any)) {
#pragma unroll
      for (int e = 0; e < 4; ++e) offer(ls, li, k, cand[e], sc[e], id[e], lane);
    }
  }
}

template <int DMAX, int TK, int ITEM>
__global__ void __launch_bounds__(kThreads, 1)
    topk_kernel(const float* __restrict__ w, const void* __restrict__ Minv,
                int minv_bf16, const int* __restrict__ occ,
                const void* __restrict__ items,
                const float* __restrict__ live,
                const float* __restrict__ scales, float alpha, int n, int N,
                int d, int k, int S, float* __restrict__ out_s,
                int* __restrict__ out_i) {
  using T = typename ItemType<ITEM>::T;
  extern __shared__ __align__(16) float smem[];
  constexpr int CH = kThreads * TK;
  const Smem s = carve(smem, d, k, TK, false, ITEM);
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
  stage_users_of(w, Minv, minv_bf16, occ, nullptr, n, d, k, u0, s);
  int lb = 0;
  for (int c = split; c < n_chunks; c += S) {
    cp_wait_all();
    __syncthreads();  // chunk c has arrived; the last chunk is scanned
    float x[TK][DMAX];
    const T* src = static_cast<const T*>(items) + (size_t)c * CH * d;
    load_items<DMAX, TK, ITEM>(x, s, d, lb, [&](int r) {
      return region_at(s, 0, src) + (size_t)r * d * sizeof(T);
    });
    __syncthreads();  // the chunk buffer is free: stage the next chunk
    if (c + S < n_chunks) stage(c + S, lb ^ 1);
    score_items<DMAX, TK>(s, x, d, alpha);
    __syncthreads();
    const size_t first = (size_t)c * CH;
    if (u0 + warp < n)
      scan_chunk(s, lb, min(CH, N - (int)first), false, first, -INFINITY, k,
                 CH, warp, lane);
    lb ^= 1;
  }
  __syncthreads();  // lists staged by other warps when nothing streamed
  write_lists(s, nullptr, n, k, u0, split, out_s, out_i);
}

template <int DMAX, int TK, int ITEM>
__global__ void __launch_bounds__(kThreads, 1)
    topk_pruned_kernel(const float* __restrict__ w,
                       const void* __restrict__ Minv, int minv_bf16,
                       const int* __restrict__ occ,
                       const void* __restrict__ items,
                       const float* __restrict__ live,
                       const int* __restrict__ ids,
                       const float* __restrict__ scales,
                       const long long* __restrict__ user_order,
                       const float* __restrict__ tb_walk,
                       const long long* __restrict__ tile_order,
                       int* gfloor,
                       float alpha, int n, int T, int tile, int d, int k,
                       int S, float* __restrict__ out_s,
                       int* __restrict__ out_i, int* __restrict__ skipped) {
  using Item = typename ItemType<ITEM>::T;
  extern __shared__ __align__(16) float smem[];
  constexpr int CH = kThreads * TK;
  const Smem s = carve(smem, d, k, TK, true, ITEM);
  Walk& wk = *s.walk;
  const int g = blockIdx.x, split = blockIdx.y;
  const int u0 = g * kUsers;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long* order = tile_order + (size_t)g * T;
  const float* tbw = tb_walk + (size_t)g * T * kUsers;
  const int TPC = tiles_per_chunk(tile, CH);
  const int SPT = tile > CH ? (tile + CH - 1) / CH : 1;  // slices a tile
  auto rows = [&](const Chunk& c) {  // rows of a chunk
    return SPT > 1 ? min(CH, tile - c.slice * CH) : c.n_tiles * tile;
  };
  // a reduced chunk's tiles each have a region of the chunk buffer (a
  // tile's slice where tile > CH: one region)
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
  // warp 0 picks chunk b, the one after chunk b ^ 1 (``own``: against the
  // lists' floors too, at most tpc tiles), then the block stages it
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
  stage_users_of(w, Minv, minv_bf16, occ, user_order, n, d, k, u0, s);
  int lb = 0;
  for (bool first = true;; first = false) {
    cp_wait_all();
    __syncthreads();  // chunk lb has arrived; the last chunk is scanned
    const Chunk& c = wk.chunk[lb];
    if (c.n_tiles == 0) break;
    float x[TK][DMAX];
    load_items<DMAX, TK, ITEM>(x, s, d, lb, [&](int r) {
      int q = r / tile;  // 0 where tile > CH: one tile's slice
      if (q >= c.n_tiles) q = 0;  // a row past the chunk's: never scanned
      return region_at(s, q * R, src_of(c, q)) +
             (size_t)(r - q * tile) * d * sizeof(Item);
    });
    if (!first) next_chunk(lb ^ 1, true, TPC);  // floors before c's scan
    score_items<DMAX, TK>(s, x, d, alpha);
    __syncthreads();
    if (u0 + warp < n) {
      scan_chunk(s, lb, rows(c), true, 0, wk.pub[warp], k, CH, warp, lane);
      __syncwarp();
      const float f = s.ls[warp * k + k - 1];  // publish once a chunk
      if (lane == 0 && f > -INFINITY) atomicMax(gfloor + u0 + warp, f2o(f));
    }
    if (first) {  // the second chunk, against the first one's floors
      __syncthreads();
      next_chunk(lb ^ 1, true, TPC);
    }
    lb ^= 1;
  }
  __syncthreads();  // lists staged by other warps when nothing streamed
  write_lists(s, user_order, n, k, u0, split, out_s, out_i);
  if (threadIdx.x == 0) skipped[(size_t)g * S + split] = wk.skipped;
}

bool valid_shape(int d, int k) {
  return d >= 1 && d <= kMaxD && k >= 1 && k <= kMaxK;
}

using TopkFn = void (*)(const float*, const void*, int, const int*,
                        const void*, const float*, const float*, float, int,
                        int, int, int, int, float*, int*);
using PrunedFn = void (*)(const float*, const void*, int, const int*,
                          const void*, const float*, const int*,
                          const float*, const long long*, const float*,
                          const long long*, int*, float, int, int, int, int,
                          int, int, float*, int*, int*);

// The kernels that serve d over items of ``item``, and their shared
// memory at (d, k).
template <int ITEM>
TopkFn topk_fn_of(int d) {
  return d <= kSmallD ? topk_kernel<32, 4, ITEM> : topk_kernel<64, 1, ITEM>;
}
template <int ITEM>
PrunedFn pruned_fn_of(int d) {
  return d <= kSmallD ? topk_pruned_kernel<32, 4, ITEM>
                      : topk_pruned_kernel<64, 1, ITEM>;
}
TopkFn topk_fn(int d, int item) {
  return item == 0 ? topk_fn_of<0>(d)
                   : item == 1 ? topk_fn_of<1>(d) : topk_fn_of<2>(d);
}
PrunedFn pruned_fn(int d, int item) {
  return item == 0 ? pruned_fn_of<0>(d)
                   : item == 1 ? pruned_fn_of<1>(d) : pruned_fn_of<2>(d);
}
size_t smem_bytes(int d, int k, bool pruned, int item) {
  return score_smem_bytes(d, k, items_per_thread(d), pruned, item);
}

int launch_topk(const float* w, const void* Minv, int minv_bf16,
                const int* occ, const void* items, const float* live,
                const float* scales, int item, float alpha, int n, int N,
                int d, int k, int S, float* part_s, int* part_i,
                float* out_s, int* out_i, cudaStream_t stream) {
  const size_t bytes = smem_bytes(d, k, false, item);
  if (!valid_shape(d, k) || S < 1 || bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const int CH = kThreads * items_per_thread(d);
  const int chunks = (N + CH - 1) / CH;
  if (S > chunks) S = chunks > 0 ? chunks : 1;
  const dim3 grid((n + kUsers - 1) / kUsers, S);
  float* ls = S == 1 ? out_s : part_s;
  int* li = S == 1 ? out_i : part_i;
  const TopkFn kernel = topk_fn(d, item);
  cudaError_t e;
  if ((e = allow_smem(kernel, bytes)) != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, bytes, stream>>>(w, Minv, minv_bf16, occ, items,
                                            live, scales, alpha, n, N, d, k,
                                            S, ls, li);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (S > 1) return (int)merge(part_s, part_i, n, k, S, out_s, out_i, stream);
  return 0;
}

int launch_pruned(const float* w, const void* Minv, int minv_bf16,
                  const int* occ, const void* items, const float* live,
                  const int* ids, const float* scales, int item,
                  const long long* user_order, const float* tb_walk,
                  const long long* tile_order, int* gfloor, float alpha,
                  int n, int T, int tile, int d, int k, int S, float* part_s,
                  int* part_i, float* out_s, int* out_i, int* skipped,
                  cudaStream_t stream) {
  const size_t bytes = smem_bytes(d, k, true, item);
  if (!valid_shape(d, k) || S < 1 || tile < 1 || bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kUsers - 1) / kUsers, S);
  float* ls = S == 1 ? out_s : part_s;
  int* li = S == 1 ? out_i : part_i;
  const PrunedFn kernel = pruned_fn(d, item);
  cudaError_t e;
  if ((e = allow_smem(kernel, bytes)) != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, bytes, stream>>>(
      w, Minv, minv_bf16, occ, items, live, ids, scales, user_order, tb_walk,
      tile_order, gfloor, alpha, n, T, tile, d, k, S, ls, li, skipped);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (S > 1) return (int)merge(part_s, part_i, n, k, S, out_s, out_i, stream);
  return 0;
}

}  // namespace

// Resident blocks per SM of the kernel that serves (d, k) (``pruned``:
// topk_pruned_kernel) over items of ``item`` (0 f32, 1 bf16, 2 int8), from
// the occupancy API, into *blocks.
extern "C" int topk_blocks_per_sm(int d, int k, int pruned, int item,
                                  int* blocks) {
  if (item < 0 || item > 2) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(d, k, pruned, item);
  if (!valid_shape(d, k) || bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (pruned) {
    const PrunedFn fn = pruned_fn(d, item);
    if ((e = allow_smem(fn, bytes)) != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads,
                                                      bytes);
  } else {
    const TopkFn fn = topk_fn(d, item);
    if ((e = allow_smem(fn, bytes)) != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads,
                                                      bytes);
  }
  return (int)e;
}

// S splits per group of 8 users (lowered to the chunk count).  With one
// split the lists go straight to out_s/out_i; otherwise to part_s/part_i
// ([splits, n, k], room for S) and then merged.  Items f32 (topk_launch),
// bf16 (topk_bf16_launch) or int8 codes with their f32 scales
// (topk_int8_launch); the topk_minv_bf16 entries take the same three with
// Minv in bf16.
extern "C" int topk_launch(const float* w, const float* Minv, const int* occ,
                           const float* items, const float* live, float alpha,
                           int n, int N, int d, int k, int S, float* part_s,
                           int* part_i, float* out_s, int* out_i,
                           cudaStream_t stream) {
  return launch_topk(w, Minv, 0, occ, items, live, nullptr, 0, alpha, n, N,
                     d, k, S, part_s, part_i, out_s, out_i, stream);
}

extern "C" int topk_bf16_launch(const float* w, const float* Minv,
                                const int* occ, const __nv_bfloat16* items,
                                const float* live, float alpha, int n, int N,
                                int d, int k, int S, float* part_s,
                                int* part_i, float* out_s, int* out_i,
                                cudaStream_t stream) {
  return launch_topk(w, Minv, 0, occ, items, live, nullptr, 1, alpha, n, N,
                     d, k, S, part_s, part_i, out_s, out_i, stream);
}

extern "C" int topk_int8_launch(const float* w, const float* Minv,
                                const int* occ, const signed char* items,
                                const float* live, const float* scales,
                                float alpha, int n, int N, int d, int k,
                                int S, float* part_s, int* part_i,
                                float* out_s, int* out_i,
                                cudaStream_t stream) {
  return launch_topk(w, Minv, 0, occ, items, live, scales, 2, alpha, n, N, d,
                     k, S, part_s, part_i, out_s, out_i, stream);
}

extern "C" int topk_minv_bf16_launch(const float* w,
                                     const __nv_bfloat16* Minv,
                                     const int* occ, const float* items,
                                     const float* live, float alpha, int n,
                                     int N, int d, int k, int S,
                                     float* part_s, int* part_i,
                                     float* out_s, int* out_i,
                                     cudaStream_t stream) {
  return launch_topk(w, Minv, 1, occ, items, live, nullptr, 0, alpha, n, N,
                     d, k, S, part_s, part_i, out_s, out_i, stream);
}

extern "C" int topk_minv_bf16_bf16_launch(
    const float* w, const __nv_bfloat16* Minv, const int* occ,
    const __nv_bfloat16* items, const float* live, float alpha, int n, int N,
    int d, int k, int S, float* part_s, int* part_i, float* out_s,
    int* out_i, cudaStream_t stream) {
  return launch_topk(w, Minv, 1, occ, items, live, nullptr, 1, alpha, n, N,
                     d, k, S, part_s, part_i, out_s, out_i, stream);
}

extern "C" int topk_minv_bf16_int8_launch(
    const float* w, const __nv_bfloat16* Minv, const int* occ,
    const signed char* items, const float* live, const float* scales,
    float alpha, int n, int N, int d, int k, int S, float* part_s,
    int* part_i, float* out_s, int* out_i, cudaStream_t stream) {
  return launch_topk(w, Minv, 1, occ, items, live, scales, 2, alpha, n, N, d,
                     k, S, part_s, part_i, out_s, out_i, stream);
}

// user_order [n] groups the users by 8 (block row r is user
// user_order[r]; the lists go to the users' own rows); tile_order
// [groups, T] is each group's visit order and tb_walk [groups, T, 8] its
// users' tile bounds in that order; gfloor [groups * 8] (by block row)
// holds the order-encoded -inf on entry; skipped [groups, S] receives the
// skips.  Items and Minv as topk's six entries.
extern "C" int topk_pruned_launch(
    const float* w, const float* Minv, const int* occ, const float* items,
    const float* live, const int* ids, const long long* user_order,
    const float* tb_walk, const long long* tile_order,
    int* gfloor, float alpha, int n, int T, int tile, int d, int k, int S,
    float* part_s, int* part_i, float* out_s, int* out_i, int* skipped,
    cudaStream_t stream) {
  return launch_pruned(w, Minv, 0, occ, items, live, ids, nullptr, 0,
                       user_order, tb_walk, tile_order, gfloor, alpha, n, T,
                       tile, d, k, S, part_s, part_i, out_s, out_i, skipped,
                       stream);
}

extern "C" int topk_pruned_bf16_launch(
    const float* w, const float* Minv, const int* occ,
    const __nv_bfloat16* items, const float* live, const int* ids,
    const long long* user_order, const float* tb_walk,
    const long long* tile_order, int* gfloor, float alpha, int n, int T,
    int tile, int d, int k, int S, float* part_s, int* part_i, float* out_s,
    int* out_i, int* skipped, cudaStream_t stream) {
  return launch_pruned(w, Minv, 0, occ, items, live, ids, nullptr, 1,
                       user_order, tb_walk, tile_order, gfloor, alpha, n, T,
                       tile, d, k, S, part_s, part_i, out_s, out_i, skipped,
                       stream);
}

extern "C" int topk_pruned_int8_launch(
    const float* w, const float* Minv, const int* occ,
    const signed char* items, const float* live, const int* ids,
    const float* scales, const long long* user_order, const float* tb_walk,
    const long long* tile_order, int* gfloor, float alpha, int n, int T,
    int tile, int d, int k, int S, float* part_s, int* part_i, float* out_s,
    int* out_i, int* skipped, cudaStream_t stream) {
  return launch_pruned(w, Minv, 0, occ, items, live, ids, scales, 2,
                       user_order, tb_walk, tile_order, gfloor, alpha, n, T,
                       tile, d, k, S, part_s, part_i, out_s, out_i, skipped,
                       stream);
}

extern "C" int topk_pruned_minv_bf16_launch(
    const float* w, const __nv_bfloat16* Minv, const int* occ,
    const float* items, const float* live, const int* ids,
    const long long* user_order, const float* tb_walk,
    const long long* tile_order, int* gfloor, float alpha, int n, int T,
    int tile, int d, int k, int S, float* part_s, int* part_i, float* out_s,
    int* out_i, int* skipped, cudaStream_t stream) {
  return launch_pruned(w, Minv, 1, occ, items, live, ids, nullptr, 0,
                       user_order, tb_walk, tile_order, gfloor, alpha, n, T,
                       tile, d, k, S, part_s, part_i, out_s, out_i, skipped,
                       stream);
}

extern "C" int topk_pruned_minv_bf16_bf16_launch(
    const float* w, const __nv_bfloat16* Minv, const int* occ,
    const __nv_bfloat16* items, const float* live, const int* ids,
    const long long* user_order, const float* tb_walk,
    const long long* tile_order, int* gfloor, float alpha, int n, int T,
    int tile, int d, int k, int S, float* part_s, int* part_i, float* out_s,
    int* out_i, int* skipped, cudaStream_t stream) {
  return launch_pruned(w, Minv, 1, occ, items, live, ids, nullptr, 1,
                       user_order, tb_walk, tile_order, gfloor, alpha, n, T,
                       tile, d, k, S, part_s, part_i, out_s, out_i, skipped,
                       stream);
}

extern "C" int topk_pruned_minv_bf16_int8_launch(
    const float* w, const __nv_bfloat16* Minv, const int* occ,
    const signed char* items, const float* live, const int* ids,
    const float* scales, const long long* user_order, const float* tb_walk,
    const long long* tile_order, int* gfloor, float alpha, int n, int T,
    int tile, int d, int k, int S, float* part_s, int* part_i, float* out_s,
    int* out_i, int* skipped, cudaStream_t stream) {
  return launch_pruned(w, Minv, 1, occ, items, live, ids, scales, 2,
                       user_order, tb_walk, tile_order, gfloor, alpha, n, T,
                       tile, d, k, S, part_s, part_i, out_s, out_i, skipped,
                       stream);
}
