// What the two top-K sources share: topk.cu (the chain kernels, which
// score every pair) and topk_tc.cu (the filter kernels, which score only
// the pairs that can reach a user's list): the catalog's staging into
// shared memory, the pruned kernels' walk over the tiles and their skip
// test, the sorted lists and their insertion, and the merge of a group's
// split lists.  Each source includes it once, after it has defined
// kUsers, kThreads, kMaxK, kFull and kMaxTiles in an unnamed namespace,
// so that each builds into a library of its own.
//
// A NaN score (repro's select_topk: max is NaN, and no entry equals it, so
// every slot of the user's list becomes (NaN, INT_MAX) and stays so
// through later tiles and the merge of shards): the warp that scans a
// user's live pairs poisons the user's list when one scores NaN (the
// chain kernels' scan_chunk passes a NaN by beats_or_nan, whose test of
// a number costs what beats' does, and marks the list in its rare path;
// the filter kernels' rescore: a NaN pair always reaches the rescore,
// topk_tc.cu's header);
// write_lists writes a poisoned list as (NaN, INT_MAX) in all k slots,
// and merge_kernel so a user any of whose split lists holds a NaN.  Dead
// pairs are never tested, so a NaN on a dead slot changes nothing, and a
// user with no NaN gets the list it got before.
//
// The pruned kernels' skip test relies on NaN comparing false: a tile is
// kept where !(tb < floor), so a NaN bound is always scored.  Floors are
// never NaN: a list's k-th score is a number or +-inf, and f2o and
// atomicMax publish it in order.  A poisoned user's floor is +inf: its
// own result is fixed, and a skip only drops pairs strictly below every
// user's floor, so no other user's list moves.  (repro's
// topk_ref_pruned keeps a poisoned user's tiles, its NaN floor failing
// the test: the skip counts differ, the lists do not.)
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <math.h>

namespace {

__device__ __forceinline__ bool beats(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

// beats, or ``as`` is NaN (an unordered compare, one instruction as ``>``
// is): the scan's test, so that a NaN reaches the scan's rare path at no
// cost to the test of a number.  ``bs`` is a list's k-th score, never NaN.
__device__ __forceinline__ bool beats_or_nan(float as, int ai, float bs,
                                             int bi) {
  return !(as <= bs) || (as == bs && ai < bi);
}

// A poisoned list (a live pair of its user scored NaN) holds (+inf, -1)
// in its k-th slot, which no list holds otherwise (-1 marks an empty,
// -inf slot): no pair beats it, a scan passes only a NaN, and its floor,
// +inf once published, lets every split skip the user's tiles.
__device__ __forceinline__ void poison(float* ls, int* li, int k,
                                       int lane) {
  if (lane == 0) {
    ls[k - 1] = INFINITY;
    li[k - 1] = -1;
  }
  __syncwarp();
}
__device__ __forceinline__ bool poisoned(const float* ls, const int* li,
                                         int k) {
  return ls[k - 1] == INFINITY && li[k - 1] == -1;
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

// The user at the block's row u0 + u: ``order``'s entry (pruned: users
// grouped by the wrapper), else the row itself.
__device__ __forceinline__ size_t user_of(const long long* order, int r) {
  return order ? (size_t)order[r] : (size_t)r;
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

// The block's lists into rows [split, user] (the users' own rows); a
// poisoned list as (NaN, INT_MAX) in every slot.
__device__ void write_lists(const Smem& s, const long long* order, int n,
                            int k, int u0, int split, float* out_s,
                            int* out_i) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (u0 + warp >= n) return;
  const bool bad = poisoned(s.ls + warp * k, s.li + warp * k, k);
  const size_t row = ((size_t)split * n + user_of(order, u0 + warp)) * k;
  for (int j = lane; j < k; j += 32) {
    out_s[row + j] = bad ? NAN : s.ls[warp * k + j];
    out_i[row + j] = bad ? INT_MAX : s.li[warp * k + j];
  }
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

// Fold S partial lists per user ([S, n, k]) into the final [n, k]; a user
// any of whose lists is poisoned gets (NaN, INT_MAX).
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
  bool nan = false;
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
        nan |= isnan(sc);
        cand = beats(sc, id, my_s[k - 1], my_i[k - 1]);
      }
      offer(my_s, my_i, k, cand, sc, id, lane);
    }
  }
  const bool bad = __any_sync(kFull, nan);
  for (int j = lane; j < k; j += 32) {
    out_s[(size_t)u * k + j] = bad ? NAN : my_s[j];
    out_i[(size_t)u * k + j] = bad ? INT_MAX : my_i[j];
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

}  // namespace
