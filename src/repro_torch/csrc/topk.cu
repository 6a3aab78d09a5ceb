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
// The bound stays the operations' (the dequant is d multiplies an item
// per block of 8 users beside 2 d^2 FMAs a pair); the catalog's bytes
// fall to a half (bf16) or about a quarter (int8).
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
// code that is the same past it.  The bound stays the operations'.

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

__device__ __forceinline__ bool beats(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

// Order-preserving int encoding of a float (for atomicMax on floors).
__device__ __forceinline__ int f2o(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float o2f(int o) {
  return __int_as_float(o >= 0 ? o : o ^ 0x7fffffff);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The catalog's storage type of each ITEM code.
template <int ITEM>
struct ItemType;
template <>
struct ItemType<0> {
  using T = float;
};
template <>
struct ItemType<1> {
  using T = __nv_bfloat16;
};
template <>
struct ItemType<2> {
  using T = signed char;
};
__host__ __device__ inline int item_bytes(int item) {
  return item == 0 ? 4 : item == 1 ? 2 : 1;
}

// Items a thread scores per chunk, in both kernels: 4 items' features in
// registers up to d = 32 (128 registers), 1 above (64).
__host__ __device__ inline int items_per_thread(int d) {
  return d <= kSmallD ? 4 : 1;
}
// Tiles a pruned chunk of CH rows gathers: as many whole tiles as fit, at
// most kMaxTiles; a tile longer than CH is streamed a CH-row slice a chunk.
__host__ __device__ inline int tiles_per_chunk(int tile, int CH) {
  if (tile >= CH) return 1;
  return CH / tile < kMaxTiles ? CH / tile : kMaxTiles;
}
// The chunk's row stride in shared memory: odd, so that the 32 lanes'
// rows fall in 32 banks.
__host__ __device__ inline int stride_of(int d) { return d | 1; }

// A chunk of the pruned kernel: its tiles (where tile > CH, one tile's
// CH-row slice ``slice``).  n_tiles 0: the split's walk has ended.
struct Chunk {
  int n_tiles;
  int slice;
  int tiles[kMaxTiles];
};
// The pruned kernel's walk: the next position of the split's tile order
// to test, the tiles skipped so far, the two chunks in flight, and the
// users' published floors as the last pick read them.
struct Walk {
  int next;
  int skipped;
  Chunk chunk[2];
  float pub[kUsers];
};

struct Smem {
  float* Ms;  // [d*d][kUsers]
  float* ws;  // [d][kUsers]
  float* ex;  // [kUsers]
  float* xs;  // [CH][XS]   chunk rows (f32); reduced items: their bytes
  float* lv;  // [2][CH]    live flags of the chunk (two: the next's too)
  float* sc;  // [2][CH]    int8 scales of the chunk, likewise
  int* id;    // [2][CH]    ids of the chunk, likewise (pruned)
  float* ss;  // [kUsers][CH] scores
  float* ls;  // [kUsers][k]  sorted list scores
  int* li;    // [kUsers][k]  sorted list ids
  Walk* walk;  // pruned
};

// Floats of the chunk buffer: padded f32 rows, or a reduced chunk's
// bytes with room for each tile's region to start at its source's offset
// mod 16 (a region per tile of the pruned kernel, at most kMaxTiles),
// whole 16-byte words.
__host__ __device__ inline size_t chunk_floats(int d, int CH, int item) {
  if (item == 0) return (size_t)CH * stride_of(d);
  const size_t bytes = (size_t)CH * d * item_bytes(item) + 32 * kMaxTiles + 16;
  return (bytes + 15) / 16 * 4;
}
// A pruned tile's region in the reduced chunk buffer: its bytes rounded
// up to 16, and 16 more for the offset.
__host__ __device__ inline int region_bytes(int tile, int d, int item) {
  return (tile * d * item_bytes(item) + 15) / 16 * 16 + 16;
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

// The user at the block's row u0 + u: ``order``'s entry (pruned: users
// grouped by the wrapper), else the row itself.
__device__ __forceinline__ size_t user_of(const long long* order, int r) {
  return order ? (size_t)order[r] : (size_t)r;
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

// n floats from src to dst (shared): 16-byte copies where both are
// 16-byte aligned, 4-byte ones for the rest.
__device__ __forceinline__ void stage_floats(void* dst, const void* src,
                                             int n) {
  int done = 0;
  if (aligned16(dst) && aligned16(src)) {
    done = n & ~3;
    for (int e = 4 * threadIdx.x; e < done; e += 4 * kThreads)
      cp_async16(static_cast<float*>(dst) + e,
                 static_cast<const float*>(src) + e);
  }
  for (int e = done + threadIdx.x; e < n; e += kThreads)
    cp_async4(static_cast<float*>(dst) + e, static_cast<const float*>(src) + e);
}

// n bytes from src to dst (shared), dst at the same offset mod 16 as
// src: the aligned body by 16-byte cp.async, the at most 15 bytes before
// and after it by plain byte copies (a reduced row's range starts and
// ends anywhere).
__device__ __forceinline__ void stage_bytes(unsigned char* dst,
                                            const unsigned char* src,
                                            int n) {
  const int lead = (int)((16 - (reinterpret_cast<size_t>(src) & 15)) & 15);
  const int head = lead < n ? lead : n;
  const int body = (n - head) & ~15;
  for (int e = head + 16 * threadIdx.x; e < head + body; e += 16 * kThreads)
    cp_async16(dst + e, src + e);
  const int t = threadIdx.x;
  if (t < head) dst[t] = __ldg(src + t);
  if (t < n - head - body) dst[head + body + t] = __ldg(src + head + body + t);
}

// Where a reduced chunk's region starts in the chunk buffer: ``region``
// bytes in, plus the source's offset mod 16.
__device__ __forceinline__ unsigned char* region_at(const Smem& s,
                                                    int region,
                                                    const void* src) {
  return reinterpret_cast<unsigned char*>(s.xs) + region +
         (reinterpret_cast<size_t>(src) & 15);
}

// Start copying catalog rows [first, first + cnt) into the chunk buffer,
// their live flags into live buffer ``lb`` from row ``row0`` on (and
// their ids into id buffer ``lb``, int8 scales into scale buffer
// ``lb``), by cp.async; the caller commits and waits.  f32 rows go to
// their padded slots from row ``row0`` on: where the row stride in
// shared memory is d itself (d odd) the rows are one contiguous copy,
// otherwise each float goes to its slot.  Reduced rows go as one byte
// range to the region ``region`` bytes into the buffer.
template <int ITEM>
__device__ void stage_chunk(const void* __restrict__ items,
                            const float* __restrict__ live,
                            const int* __restrict__ ids,
                            const float* __restrict__ scales, size_t first,
                            int cnt, int row0, int region, int d, int CH,
                            const Smem& s, int lb) {
  if constexpr (ITEM != 0) {
    using T = typename ItemType<ITEM>::T;
    const T* src = static_cast<const T*>(items) + first * d;
    stage_bytes(region_at(s, region, src),
                reinterpret_cast<const unsigned char*>(src),
                cnt * d * (int)sizeof(T));
    if constexpr (ITEM == 2)
      stage_floats(s.sc + lb * CH + row0, scales + first, cnt);
    stage_floats(s.lv + lb * CH + row0, live + first, cnt);
    if (ids) stage_floats(s.id + lb * CH + row0, ids + first, cnt);
    return;
  }
  const int XS = stride_of(d);
  const float* src = static_cast<const float*>(items) + first * d;
  float* xs = s.xs + row0 * XS;
  if (XS == d) {
    stage_floats(xs, src, cnt * d);
  } else {
    const int dc = kThreads / d, dj = kThreads - dc * d;
    int c = threadIdx.x / d, j = threadIdx.x - c * d;
    for (int e = threadIdx.x; e < cnt * d; e += kThreads) {
      cp_async4(xs + c * XS + j, src + e);
      c += dc;
      j += dj;
      if (j >= d) {
        j -= d;
        ++c;
      }
    }
  }
  stage_floats(s.lv + lb * CH + row0, live + first, cnt);
  if (ids) stage_floats(s.id + lb * CH + row0, ids + first, cnt);
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

// xi[q] = x[q][i] for a runtime i < DMAX (a jump table, no memory).
template <int DMAX, int TK>
__device__ __forceinline__ void pick(const float (&x)[TK][DMAX], int i,
                                     float (&xi)[TK]) {
#define TOPK_PICK(J)                                                 \
  case J:                                                            \
    _Pragma("unroll") for (int q = 0; q < TK; ++q) xi[q] =           \
        x[q][(J) < DMAX ? (J) : 0];                                  \
    break;
  switch (i) {
    TOPK_PICK(0) TOPK_PICK(1) TOPK_PICK(2) TOPK_PICK(3) TOPK_PICK(4)
    TOPK_PICK(5) TOPK_PICK(6) TOPK_PICK(7) TOPK_PICK(8) TOPK_PICK(9)
    TOPK_PICK(10) TOPK_PICK(11) TOPK_PICK(12) TOPK_PICK(13) TOPK_PICK(14)
    TOPK_PICK(15) TOPK_PICK(16) TOPK_PICK(17) TOPK_PICK(18) TOPK_PICK(19)
    TOPK_PICK(20) TOPK_PICK(21) TOPK_PICK(22) TOPK_PICK(23) TOPK_PICK(24)
    TOPK_PICK(25) TOPK_PICK(26) TOPK_PICK(27) TOPK_PICK(28) TOPK_PICK(29)
    TOPK_PICK(30) TOPK_PICK(31) TOPK_PICK(32) TOPK_PICK(33) TOPK_PICK(34)
    TOPK_PICK(35) TOPK_PICK(36) TOPK_PICK(37) TOPK_PICK(38) TOPK_PICK(39)
    TOPK_PICK(40) TOPK_PICK(41) TOPK_PICK(42) TOPK_PICK(43) TOPK_PICK(44)
    TOPK_PICK(45) TOPK_PICK(46) TOPK_PICK(47) TOPK_PICK(48) TOPK_PICK(49)
    TOPK_PICK(50) TOPK_PICK(51) TOPK_PICK(52) TOPK_PICK(53) TOPK_PICK(54)
    TOPK_PICK(55) TOPK_PICK(56) TOPK_PICK(57) TOPK_PICK(58) TOPK_PICK(59)
    TOPK_PICK(60) TOPK_PICK(61) TOPK_PICK(62) TOPK_PICK(63)
    default: break;
  }
#undef TOPK_PICK
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

// Insert (cs, ci) into the warp's sorted list if it beats the floor.
// Every lane holds the same (cs, ci), so the early return is warp-uniform.
__device__ void insert(float* ls, int* li, int k, float cs, int ci,
                       int lane) {
  if (!beats(cs, ci, ls[k - 1], li[k - 1])) return;
  int pos = 0;
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int j = j0 + lane;
    const bool better = j < k && beats(ls[j], li[j], cs, ci);
    pos += __popc(__ballot_sync(kFull, better));
  }
  float v[kMaxK / 32];
  int vi[kMaxK / 32];
#pragma unroll
  for (int r = 0; r < kMaxK / 32; ++r) {
    const int j = r * 32 + lane;
    if (j >= pos && j < k - 1) {
      v[r] = ls[j];
      vi[r] = li[j];
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kMaxK / 32; ++r) {
    const int j = r * 32 + lane;
    if (j >= pos && j < k - 1) {
      ls[j + 1] = v[r];
      li[j + 1] = vi[r];
    }
  }
  if (lane == 0) {
    ls[pos] = cs;
    li[pos] = ci;
  }
  __syncwarp();
}

// Offer 32 candidates per step (lane c holds one, ``cand`` if it may
// beat the floor) to the warp's list.
__device__ __forceinline__ void offer(float* ls, int* li, int k, bool cand,
                                     float sc, int id, int lane) {
  unsigned m = __ballot_sync(kFull, cand);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cs = __shfl_sync(kFull, sc, src);
    const int ci = __shfl_sync(kFull, id, src);
    insert(ls, li, k, cs, ci, lane);
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

// The block's lists into rows [split, user] (the users' own rows).
__device__ void write_lists(const Smem& s, const long long* order, int n,
                            int k, int u0, int split, float* out_s,
                            int* out_i) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (u0 + warp >= n) return;
  const size_t row = ((size_t)split * n + user_of(order, u0 + warp)) * k;
  for (int j = lane; j < k; j += 32) {
    out_s[row + j] = s.ls[warp * k + j];
    out_i[row + j] = s.li[warp * k + j];
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

// The floors of the block's users for the skip test: the larger of the
// list's k-th score (``own``; false before the lists exist) and the
// published one, read from L2 (``gfloor`` holds whole groups: two 16-byte
// loads) and kept in the walk for the scan; +inf for users past n, so
// that they vote skip.
__device__ __forceinline__ void floors(const Smem& s, const int* gfloor,
                                       int n, int u0, int k, bool own,
                                       int lane, float (&f)[kUsers]) {
  const int4 a = __ldcg(reinterpret_cast<const int4*>(gfloor + u0));
  const int4 b = __ldcg(reinterpret_cast<const int4*>(gfloor + u0 + 4));
  const int g[kUsers] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int u = 0; u < kUsers; ++u) {
    const float pub = o2f(g[u]);
    if (lane == u) s.walk->pub[u] = pub;
    f[u] = INFINITY;
    if (u0 + u < n) f[u] = own ? fmaxf(s.ls[u * k + k - 1], pub) : pub;
  }
}

// The bounds of position p of the group's walk (``tbw``: the group's
// [T][8] bounds in walk order): two float4s.
__device__ __forceinline__ void bounds_at(const float* __restrict__ tbw,
                                          int p, float4& a, float4& b) {
  a = __ldg(reinterpret_cast<const float4*>(tbw + (size_t)p * kUsers));
  b = __ldg(reinterpret_cast<const float4*>(tbw + (size_t)p * kUsers + 4));
}

// Whether a tile with bounds (a, b) must be scored: some valid user's
// bound is not strictly below its floor.
__device__ __forceinline__ bool passes(const float4& a, const float4& b,
                                       int n, int u0,
                                       const float (&f)[kUsers]) {
  const float bu[kUsers] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  bool pass = false;
#pragma unroll
  for (int u = 0; u < kUsers; ++u)
    if (u0 + u < n && !(bu[u] < f[u])) pass = true;
  return pass;
}

// Warp 0: the tiles of the next chunk into ``c`` (``prev``: the chunk
// before it), tested against the floors (``own``: the lists' too; false
// before they exist).  Where tile > CH and the previous tile has a slice
// left, that slice; otherwise the next tiles of the split's walk
// (positions split, split + S, ... of the group's ``order`` and bounds
// ``tbw``) that pass the skip test, at most TPC, 32 tested a round, one
// a lane; the tiles that fail are counted as skipped.  A round's tile ids
// and bounds are loaded before the floors, so that their trips overlap.
__device__ void pick_chunk(Walk& wk, Chunk& c, const Chunk& prev,
                           const Smem& s, const int* gfloor,
                           const long long* __restrict__ order,
                           const float* __restrict__ tbw, int T, int S,
                           int split, int n, int u0, int k, bool own,
                           int TPC, int SPT, int lane) {
  const int J = split < T ? (T - split + S - 1) / S : 0;  // the walk's tiles
  int next = wk.next;
  int t = 0;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
  auto load_round = [&]() {
    if (next + lane < J) {
      const int p = split + (next + lane) * S;
      t = (int)__ldg(order + p);
      bounds_at(tbw, p, a, b);
    }
  };
  load_round();
  float f[kUsers];
  floors(s, gfloor, n, u0, k, own, lane, f);
  if (SPT > 1 && prev.n_tiles > 0 && prev.slice + 1 < SPT) {
    if (lane == 0) {
      c.n_tiles = 1;
      c.slice = prev.slice + 1;
      c.tiles[0] = prev.tiles[0];
    }
    return;
  }
  int taken = 0, skipped = 0;
  while (taken < TPC && next < J) {
    const bool pass = next + lane < J && passes(a, b, n, u0, f);
    const unsigned m = __ballot_sync(kFull, pass);
    // lanes consumed: up to the (TPC - taken)-th pass, else all tested
    int used = min(32, J - next);
    if (__popc(m) >= TPC - taken) {
      unsigned mm = m;
      for (int r = 1; r < TPC - taken; ++r) mm &= mm - 1;
      used = __ffs(mm);
    }
    const unsigned took = m & (used == 32 ? kFull : (1u << used) - 1);
    if (pass && lane < used)
      c.tiles[taken + __popc(took & ((1u << lane) - 1))] = t;
    taken += __popc(took);
    skipped += used - __popc(took);
    next += used;
    if (taken < TPC && next < J) load_round();
  }
  __syncwarp();
  if (lane == 0) {
    c.n_tiles = taken;
    c.slice = 0;
    wk.next = next;
    wk.skipped += skipped;
  }
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

// Fold S partial lists per user ([S, n, k]) into the final [n, k].
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const float* __restrict__ part_s,
                 const int* __restrict__ part_i, int n, int k, int S,
                 float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  float* ls = smem;
  int* li = reinterpret_cast<int*>(ls + kUsers * k);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int u = blockIdx.x * kUsers + warp;
  if (u >= n) return;  // the whole warp leaves together
  float* my_s = ls + warp * k;
  int* my_i = li + warp * k;
  for (int j = lane; j < k; j += 32) {
    my_s[j] = -INFINITY;
    my_i[j] = -1;
  }
  __syncwarp();
  for (int sp = 0; sp < S; ++sp) {
    const size_t row = ((size_t)sp * n + u) * k;
    for (int base = 0; base < k; base += 32) {
      const int j = base + lane;
      float sc = 0.f;
      int id = 0;
      bool cand = false;
      if (j < k) {
        sc = part_s[row + j];
        id = part_i[row + j];
        cand = beats(sc, id, my_s[k - 1], my_i[k - 1]);
      }
      offer(my_s, my_i, k, cand, sc, id, lane);
    }
  }
  for (int j = lane; j < k; j += 32) {
    out_s[(size_t)u * k + j] = my_s[j];
    out_i[(size_t)u * k + j] = my_i[j];
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

cudaError_t merge(const float* part_s, const int* part_i, int n, int k,
                  int S, float* out_s, int* out_i, cudaStream_t stream) {
  const size_t bytes = (size_t)kUsers * k * (sizeof(float) + sizeof(int));
  const int groups = (n + kUsers - 1) / kUsers;
  merge_kernel<<<groups, kThreads, bytes, stream>>>(part_s, part_i, n, k, S,
                                                   out_s, out_i);
  return cudaGetLastError();
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
