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
// - The catalog streams through shared memory in chunks of 256*TK items,
//   stored transposed (feature-major, stride chunk + 2 against bank
//   conflicts).  Each thread scores TK items for all 8 users with the same
//   FMA chains as csrc/choose.cu (est over j; t_i over j; quad over i), in
//   registers: every (user, item) pair is scored by one fixed-order loop
//   wherever it sits, so identical items tie bit-exactly and a score here
//   equals choose's score of the same item.  Scores go to a [8, chunk]
//   shared tile.
// - Selection: one warp per user keeps a sorted list of k (score, id) in
//   shared memory.  Lanes test 32 items at a time against the list's floor
//   (the k-th entry) by value (>, ==: -0.0 and 0.0 tie); the few that beat
//   it are inserted one by one (ballot, then a warp-parallel rank and
//   shift).  Insertion order does not change the result: the list is the
//   top k of a set under a total order.
// - The grid is (user groups, splits): each split of a group streams every
//   S-th chunk (or tile) and writes a partial list; a merge kernel folds
//   the S partial lists per user with the same insertion (S == 1 writes the
//   output directly).
// - Pruned: the catalog arrives cluster-sorted with per-(user, tile) upper
//   bounds tb and a per-group tile order (bound-descending, from the
//   wrapper).  Before a tile the block skips it when every valid user has
//   tb[u,t] strictly below its floor, and counts the skip.  A floor is the
//   larger of the block's own k-th score and the best k-th score any split
//   of the same users has published (atomicMax on an order-preserving int
//   encoding): any split's full list lower-bounds the final k-th score, so
//   skipping against it is exact.  Skip counts therefore depend on timing;
//   the shortlist does not.  Both kernels score through score_chunk, so the
//   pruned shortlist is bit-equal to the unpruned one.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kUsers = 8;       // users per block: one warp each to select
constexpr int kThreads = 256;
constexpr int kMaxK = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // H100: 227 KB per block

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

struct Smem {
  float* Ms;  // [d*d][kUsers]
  float* ws;  // [d][kUsers]
  float* ex;  // [kUsers]
  float* xs;  // [d][XS]  transposed chunk
  float* ss;  // [kUsers][CH] scores
  float* ls;  // [kUsers][k]  sorted list scores
  int* li;    // [kUsers][k]  sorted list ids
};

__host__ __device__ inline int chunk_of(int TK) { return kThreads * TK; }

__host__ __device__ inline size_t score_smem_bytes(int d, int k, int TK) {
  const size_t CH = chunk_of(TK);
  return sizeof(float) * ((size_t)kUsers * d * d + (size_t)kUsers * d +
                          kUsers + (size_t)d * (CH + 2) + kUsers * CH +
                          (size_t)kUsers * k) +
         sizeof(int) * (size_t)kUsers * k;
}

__device__ Smem carve(float* base, int d, int k, int TK) {
  const int CH = chunk_of(TK);
  Smem s;
  s.Ms = base;
  s.ws = s.Ms + kUsers * d * d;
  s.ex = s.ws + kUsers * d;
  s.xs = s.ex + kUsers;
  s.ss = s.xs + d * (CH + 2);
  s.ls = s.ss + kUsers * CH;
  s.li = reinterpret_cast<int*>(s.ls + kUsers * k);
  return s;
}

// Stage the block's users (rows past n are zero) and empty their lists.
__device__ void stage_users(const float* __restrict__ w,
                            const float* __restrict__ Minv,
                            const int* __restrict__ occ, int n, int d, int k,
                            int u0, const Smem& s) {
  const int dd = d * d;
  for (int e = threadIdx.x; e < kUsers * dd; e += kThreads) {
    const int u = e / dd, p = e - u * dd;
    s.Ms[p * kUsers + u] =
        u0 + u < n ? Minv[(size_t)(u0 + u) * dd + p] : 0.f;
  }
  for (int e = threadIdx.x; e < kUsers * d; e += kThreads) {
    const int u = e / d, j = e - u * d;
    s.ws[j * kUsers + u] = u0 + u < n ? w[(size_t)(u0 + u) * d + j] : 0.f;
  }
  if (threadIdx.x < kUsers) {
    const int u = u0 + threadIdx.x;
    s.ex[threadIdx.x] = u < n ? sqrtf(log1pf((float)occ[u])) : 0.f;
  }
  for (int e = threadIdx.x; e < kUsers * k; e += kThreads) {
    s.ls[e] = -INFINITY;
    s.li[e] = -1;
  }
}

// Items [first, first + cnt) of ``items`` into the transposed chunk.
__device__ void stage_items(const float* __restrict__ items, size_t first,
                            int cnt, int d, int XS, float* xs) {
  const float* src = items + first * d;
  for (int e = threadIdx.x; e < cnt * d; e += kThreads) {
    const int c = e / d, j = e - c * d;
    xs[j * XS + c] = src[e];
  }
}

// Score the staged chunk for the 8 users into ss[u][c].  The one scoring
// routine of both kernels.
template <int TK>
__device__ __forceinline__ void score_chunk(const Smem& s, int d, float alpha) {
  constexpr int CH = kThreads * TK;
  constexpr int XS = CH + 2;
  const int k0 = threadIdx.x * TK;
  float est[kUsers][TK], quad[kUsers][TK];
#pragma unroll
  for (int u = 0; u < kUsers; ++u)
#pragma unroll
    for (int q = 0; q < TK; ++q) est[u][q] = quad[u][q] = 0.f;

  for (int j = 0; j < d; ++j) {
    float xv[TK];
#pragma unroll
    for (int q = 0; q < TK; ++q) xv[q] = s.xs[j * XS + k0 + q];
    const float4 wa = *reinterpret_cast<const float4*>(s.ws + j * kUsers);
    const float4 wb = *reinterpret_cast<const float4*>(s.ws + j * kUsers + 4);
    const float wu[kUsers] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int u = 0; u < kUsers; ++u)
#pragma unroll
      for (int q = 0; q < TK; ++q) est[u][q] = fmaf(xv[q], wu[u], est[u][q]);
  }
  for (int i = 0; i < d; ++i) {
    float t[kUsers][TK];
#pragma unroll
    for (int u = 0; u < kUsers; ++u)
#pragma unroll
      for (int q = 0; q < TK; ++q) t[u][q] = 0.f;
    const float* mrow = s.Ms + i * d * kUsers;
    for (int j = 0; j < d; ++j) {
      float xv[TK];
#pragma unroll
      for (int q = 0; q < TK; ++q) xv[q] = s.xs[j * XS + k0 + q];
      const float4 ma = *reinterpret_cast<const float4*>(mrow + j * kUsers);
      const float4 mb =
          *reinterpret_cast<const float4*>(mrow + j * kUsers + 4);
      const float mu[kUsers] = {ma.x, ma.y, ma.z, ma.w,
                                mb.x, mb.y, mb.z, mb.w};
#pragma unroll
      for (int u = 0; u < kUsers; ++u)
#pragma unroll
        for (int q = 0; q < TK; ++q) t[u][q] = fmaf(mu[u], xv[q], t[u][q]);
    }
#pragma unroll
    for (int q = 0; q < TK; ++q) {
      const float xi = s.xs[i * XS + k0 + q];
#pragma unroll
      for (int u = 0; u < kUsers; ++u) quad[u][q] = fmaf(xi, t[u][q], quad[u][q]);
    }
  }
#pragma unroll
  for (int u = 0; u < kUsers; ++u)
#pragma unroll
    for (int q = 0; q < TK; ++q) {
      const float bonus = __fmul_rn(
          __fmul_rn(alpha, sqrtf(fmaxf(quad[u][q], 0.f))), s.ex[u]);
      s.ss[u * CH + k0 + q] = __fadd_rn(est[u][q], bonus);
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

// The warp's user against the scored chunk: items at catalog rows
// [pos0, pos0 + cnt), ids from ``ids`` (sorted catalog) or the row itself.
__device__ void scan_chunk(const float* ss_u, int cnt,
                           const float* __restrict__ live,
                           const int* __restrict__ ids, size_t pos0,
                           float* ls, int* li, int k, int lane) {
  for (int base = 0; base < cnt; base += 32) {
    const int c = base + lane;
    float sc = 0.f;
    int id = 0;
    bool cand = false;
    if (c < cnt && live[pos0 + c] > 0.f) {
      sc = ss_u[c];
      id = ids ? ids[pos0 + c] : (int)(pos0 + c);
      cand = beats(sc, id, ls[k - 1], li[k - 1]);
    }
    offer(ls, li, k, cand, sc, id, lane);
  }
}

__device__ void write_lists(const Smem& s, int n, int k, int u0, int split,
                            float* out_s, int* out_i) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int u = u0 + warp;
  if (u >= n) return;
  const size_t row = ((size_t)split * n + u) * k;
  for (int j = lane; j < k; j += 32) {
    out_s[row + j] = s.ls[warp * k + j];
    out_i[row + j] = s.li[warp * k + j];
  }
}

template <int TK>
__global__ void __launch_bounds__(kThreads)
    topk_kernel(const float* __restrict__ w, const float* __restrict__ Minv,
                const int* __restrict__ occ, const float* __restrict__ items,
                const float* __restrict__ live, float alpha, int n, int N,
                int d, int k, int S, float* __restrict__ out_s,
                int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  constexpr int CH = kThreads * TK;
  const Smem s = carve(smem, d, k, TK);
  const int u0 = blockIdx.x * kUsers, split = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  stage_users(w, Minv, occ, n, d, k, u0, s);
  const int n_chunks = (N + CH - 1) / CH;
  for (int c = split; c < n_chunks; c += S) {
    const size_t first = (size_t)c * CH;
    const int cnt = min(CH, N - (int)first);
    __syncthreads();
    stage_items(items, first, cnt, d, CH + 2, s.xs);
    __syncthreads();
    score_chunk<TK>(s, d, alpha);
    __syncthreads();
    if (u0 + warp < n)
      scan_chunk(s.ss + warp * CH, cnt, live, nullptr, first,
                 s.ls + warp * k, s.li + warp * k, k, lane);
  }
  __syncthreads();  // lists staged by other warps when nothing streamed
  write_lists(s, n, k, u0, split, out_s, out_i);
}

template <int TK>
__global__ void __launch_bounds__(kThreads)
    topk_pruned_kernel(const float* __restrict__ w,
                       const float* __restrict__ Minv,
                       const int* __restrict__ occ,
                       const float* __restrict__ items,
                       const float* __restrict__ live,
                       const int* __restrict__ ids,
                       const float* __restrict__ tb,
                       const int* __restrict__ tile_order, int* gfloor,
                       float alpha, int n, int T, int tile, int d, int k,
                       int S, float* __restrict__ out_s,
                       int* __restrict__ out_i, int* __restrict__ skipped) {
  extern __shared__ __align__(16) float smem[];
  constexpr int CH = kThreads * TK;
  const Smem s = carve(smem, d, k, TK);
  const int g = blockIdx.x, split = blockIdx.y;
  const int u0 = g * kUsers;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  stage_users(w, Minv, occ, n, d, k, u0, s);
  int n_skipped = 0;
  for (int jpos = split; jpos < T; jpos += S) {
    const int t = tile_order[(size_t)g * T + jpos];
    bool below = true;  // threads past the block's valid users vote skip
    __syncthreads();    // the lists of the last tile are complete
    if (threadIdx.x < kUsers && u0 + threadIdx.x < n) {
      const int u = u0 + threadIdx.x;
      const float own = s.ls[threadIdx.x * k + k - 1];
      const float shared = o2f(*(volatile int*)(gfloor + u));
      below = tb[(size_t)u * T + t] < fmaxf(own, shared);  // STRICT
    }
    if (__syncthreads_and(below)) {
      ++n_skipped;
      continue;
    }
    for (int c0 = 0; c0 < tile; c0 += CH) {
      const size_t first = (size_t)t * tile + c0;
      const int cnt = min(CH, tile - c0);
      __syncthreads();
      stage_items(items, first, cnt, d, CH + 2, s.xs);
      __syncthreads();
      score_chunk<TK>(s, d, alpha);
      __syncthreads();
      if (u0 + warp < n)
        scan_chunk(s.ss + warp * CH, cnt, live, ids, first, s.ls + warp * k,
                   s.li + warp * k, k, lane);
    }
    __syncthreads();
    if (threadIdx.x < kUsers && u0 + threadIdx.x < n) {
      const float f = s.ls[threadIdx.x * k + k - 1];
      if (f > -INFINITY) atomicMax(gfloor + u0 + threadIdx.x, f2o(f));
    }
  }
  __syncthreads();  // lists staged by other warps when nothing streamed
  write_lists(s, n, k, u0, split, out_s, out_i);
  if (threadIdx.x == 0) skipped[(size_t)g * S + split] = n_skipped;
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

// TK = 2 items per thread where the shared memory allows, else 1; 0 if
// even that does not fit.
int pick_tk(int d, int k) {
  if (score_smem_bytes(d, k, 2) <= kMaxSmem) return 2;
  if (score_smem_bytes(d, k, 1) <= kMaxSmem) return 1;
  return 0;
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

// Up to S splits per group of 8 users, never more than there are chunks.
// With one split the lists go straight to out_s/out_i; otherwise to
// part_s/part_i ([splits, n, k], room for S) and then merged.
extern "C" int topk_launch(const float* w, const float* Minv, const int* occ,
                           const float* items, const float* live, float alpha,
                           int n, int N, int d, int k, int S, float* part_s,
                           int* part_i, float* out_s, int* out_i,
                           cudaStream_t stream) {
  if (k < 1 || k > kMaxK || S < 1) return (int)cudaErrorInvalidValue;
  const int TK = pick_tk(d, k);
  if (TK == 0) return (int)cudaErrorInvalidValue;
  const int chunks = (N + chunk_of(TK) - 1) / chunk_of(TK);
  if (S > chunks) S = chunks > 0 ? chunks : 1;
  const size_t bytes = score_smem_bytes(d, k, TK);
  const dim3 grid((n + kUsers - 1) / kUsers, S);
  float* ls = S == 1 ? out_s : part_s;
  int* li = S == 1 ? out_i : part_i;
  cudaError_t e;
  if (TK == 2) {
    if ((e = allow_smem(topk_kernel<2>, bytes)) != cudaSuccess) return (int)e;
    topk_kernel<2><<<grid, kThreads, bytes, stream>>>(
        w, Minv, occ, items, live, alpha, n, N, d, k, S, ls, li);
  } else {
    if ((e = allow_smem(topk_kernel<1>, bytes)) != cudaSuccess) return (int)e;
    topk_kernel<1><<<grid, kThreads, bytes, stream>>>(
        w, Minv, occ, items, live, alpha, n, N, d, k, S, ls, li);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (S > 1) return (int)merge(part_s, part_i, n, k, S, out_s, out_i, stream);
  return 0;
}

// Rows of w/Minv/occ/tb are grouped by 8 in the order the wrapper chose;
// tile_order [groups, T] is each group's visit order; gfloor [n] holds the
// order-encoded -inf on entry; skipped [groups, S] receives the skips.
extern "C" int topk_pruned_launch(
    const float* w, const float* Minv, const int* occ, const float* items,
    const float* live, const int* ids, const float* tb, const int* tile_order,
    int* gfloor, float alpha, int n, int T, int tile, int d, int k, int S,
    float* part_s, int* part_i, float* out_s, int* out_i, int* skipped,
    cudaStream_t stream) {
  if (k < 1 || k > kMaxK || S < 1 || tile < 1) return (int)cudaErrorInvalidValue;
  const int TK = pick_tk(d, k);
  if (TK == 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = score_smem_bytes(d, k, TK);
  const dim3 grid((n + kUsers - 1) / kUsers, S);
  float* ls = S == 1 ? out_s : part_s;
  int* li = S == 1 ? out_i : part_i;
  cudaError_t e;
  if (TK == 2) {
    if ((e = allow_smem(topk_pruned_kernel<2>, bytes)) != cudaSuccess)
      return (int)e;
    topk_pruned_kernel<2><<<grid, kThreads, bytes, stream>>>(
        w, Minv, occ, items, live, ids, tb, tile_order, gfloor, alpha, n, T,
        tile, d, k, S, ls, li, skipped);
  } else {
    if ((e = allow_smem(topk_pruned_kernel<1>, bytes)) != cudaSuccess)
      return (int)e;
    topk_pruned_kernel<1><<<grid, kThreads, bytes, stream>>>(
        w, Minv, occ, items, live, ids, tb, tile_order, gfloor, alpha, n, T,
        tile, d, k, S, ls, li, skipped);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (S > 1) return (int)merge(part_s, part_i, n, k, S, out_s, out_i, stream);
  return 0;
}
