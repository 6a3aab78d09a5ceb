// One min-label hop of connected components over the bit-packed adjacency
// (stage 2).
//
// Replaces: src/repro/kernels/graph/graph.py, cc_hop_packed_pallas
//           (body _cc_hop_kernel).
//
// For every row i:
//   out[i] = min(labels_self[i], min over set bits j of labels_j[j])
// with BIG_LABEL (2^30) standing in where row i has no neighbour; bits at
// columns >= C count as no neighbour.  Integer-exact.  The pointer-doubling
// step min(l, l[l]) and the convergence test stay with the caller.
//
// Bound on an H100: memory.  A hop reads the packed adjacency once
// (R W 4 bytes, 52 MB at n=20480, ~16 us at 3.35 TB/s) plus the labels of
// the set bits; there is almost no arithmetic.
//
// Design (cc_hop_kernel): a streaming read.  A warp owns one row at a time.
// Its lanes issue every load of a chunk of the row (kLaneWords words a
// lane, as V-word vectors, with streaming loads that do not stay in L1)
// before they look at any word, so a warp keeps a whole row of W = 640 in
// flight (2.5 KB) and an SM 70 KB, against the ~20 KB an SM needs at
// 3.35 TB/s and ~0.8 us of latency.  The grid is persistent, one block of
// kWarps warps on each SM (the wrapper reads the SM count:
// kernels/graph/ops.py cc_hop_geometry), so the block's table below is
// built once an SM, and the warps stride over the rows, so no wave runs
// part-empty.  V (16,
// 8 or 4 bytes a load) is the widest that the row length and the base
// address allow, so a row view at any offset runs the same kernel.
//
// A row's min starts at labels_self[row].  A word's set bits are walked
// with __ffs, gathering the labels of those columns only (labels_j, 80 KB
// at n=20480, stays in L1 and L2), or, past dense_min set bits and wholly
// below C, its 32 labels are read as eight int4 with a select per bit.
// Dense graphs (the first stage 2 of an epoch holds ~23% of the bits, every
// CLUB network update of chip_smoke.py all of them) would gather the same
// labels for every row, so a block whose first rows hold a word past
// kTableMinBits bits first builds a table of each word's min label in shared
// memory (coalesced int4 loads, 8 threads a word).  With it a word whose
// min is no lower than the row's min so far is skipped, a full word takes
// its min, a walk stops once it reaches the word's min, and the warp shares
// its min after each vector of words so that the bound tightens.  A sparse
// graph never builds it.  dense_min >= 32 walks every word, without the
// table.
//
// cc_hop_warp_kernel is the design before it (one warp per row, eight rows
// a block; a lane walks each 4-byte word before it loads the next, so a
// warp keeps ~128 bytes in flight).  Nothing on the path launches it: it
// stays as the yardstick of chip_smoke.py.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 28;            // the most whose 72 registers fit an SM
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSm = 1;
constexpr int kLaneWords = 20;        // words a lane loads per chunk of a row
constexpr int kTableMaxWords = 8192;  // 32 KB of shared memory
constexpr int kTableBatch = 8;        // int4 a thread in flight, building it
constexpr int kTableMinBits = 8;      // a first row's word past it: a table
constexpr int kWarpRows = 8;          // cc_hop_warp_kernel's rows a block
constexpr int kBigLabel = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = uint4;
};
template <>
struct Vec<2> {
  using T = uint2;
};
template <>
struct Vec<1> {
  using T = unsigned;
};

__device__ __forceinline__ unsigned word_of(const uint4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}
__device__ __forceinline__ unsigned word_of(const uint2& v, int c) {
  return c == 0 ? v.x : v.y;
}
__device__ __forceinline__ unsigned word_of(unsigned v, int) { return v; }

// m lowered by the set bits of word w (bits at columns >= C cleared): the
// select over all 32 labels for a word of more than dense_min bits wholly
// below C, else a walk of its bits that stops once m is down to least (no
// label of the word is lower).
__device__ __forceinline__ int word_min(unsigned bits, int w, int C,
                                        const int* __restrict__ labels_j,
                                        int dense_min, bool lj16, int least,
                                        int m) {
  if (__popc(bits) > dense_min && 32 * w + 32 <= C) {
    const int* lab = labels_j + 32 * w;
    if (lj16) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int4 l = __ldg(reinterpret_cast<const int4*>(lab) + q);
        const unsigned b = bits >> (4 * q);
        if (b & 1u) m = min(m, l.x);
        if (b & 2u) m = min(m, l.y);
        if (b & 4u) m = min(m, l.z);
        if (b & 8u) m = min(m, l.w);
      }
    } else {
#pragma unroll
      for (int b = 0; b < 32; ++b)
        if ((bits >> b) & 1u) m = min(m, __ldg(lab + b));
    }
    return m;
  }
  while (bits && m > least) {
    const int j = 32 * w + __ffs(bits) - 1;
    bits &= bits - 1;
    m = min(m, __ldg(labels_j + j));
  }
  return m;
}

// wmin[w] = the min of labels_j[32 w .. 32 w + 31] for every word wholly
// below C, by the whole block: 8 threads a word, an int4 of its labels
// each, kTableBatch loads a thread issued before any is used.
__device__ void build_table(int* wmin, const int* __restrict__ labels_j,
                            int C, bool lj16) {
  const int n4 = 8 * (C / 32);
  for (int base = 0; base < n4; base += kTableBatch * kThreads) {
    int mm[kTableBatch];
#pragma unroll
    for (int u = 0; u < kTableBatch; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      int4 l = make_int4(kBigLabel, kBigLabel, kBigLabel, kBigLabel);
      if (i < n4)
        l = lj16 ? __ldg(reinterpret_cast<const int4*>(labels_j) + i)
                 : make_int4(__ldg(labels_j + 4 * i),
                             __ldg(labels_j + 4 * i + 1),
                             __ldg(labels_j + 4 * i + 2),
                             __ldg(labels_j + 4 * i + 3));
      mm[u] = min(min(l.x, l.y), min(l.z, l.w));
    }
#pragma unroll
    for (int u = 0; u < kTableBatch; ++u) {
      int x = mm[u];
      x = min(x, __shfl_xor_sync(kFull, x, 1));
      x = min(x, __shfl_xor_sync(kFull, x, 2));
      x = min(x, __shfl_xor_sync(kFull, x, 4));
      const int i = base + u * kThreads + threadIdx.x;
      if (i < n4 && (threadIdx.x & 7) == 0) wmin[i >> 3] = x;
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    cc_hop_kernel(const unsigned* __restrict__ adj,
                  const int* __restrict__ labels_self,
                  const int* __restrict__ labels_j, int R, int W, int C,
                  int dense_min, int table_words, int* __restrict__ out) {
  using T = typename Vec<V>::T;
  constexpr int kLoads = kLaneWords / V;   // vector loads a lane, a chunk
  constexpr int kChunk = 32 * kLaneWords;  // words a warp, a chunk
  extern __shared__ int wmin[];            // [table_words]
  const int lane = threadIdx.x % 32;
  const int stride = gridDim.x * kWarps;
  const int wfull = C / 32;  // the words wholly below C: the table's
  const bool lj16 = (reinterpret_cast<uintptr_t>(labels_j) & 15) == 0;
  const bool may_table = table_words > 0 && dense_min < 32;
  bool table = false;  // the same in every thread of the block
  // Every warp passes the first iteration, a row or not, so that the block
  // can meet there to decide on the table; the whole warp takes each row.
  for (int row = blockIdx.x * kWarps + threadIdx.x / 32, first = 1;
       first || row < R; row += stride, first = 0) {
    const bool live = row < R;
    const T* arow = reinterpret_cast<const T*>(adj + (size_t)row * W);
    int m = live ? __ldg(labels_self + row) : kBigLabel;
    for (int w0 = 0; w0 < W; w0 += kChunk) {
      const int nvec = live ? min(kChunk, W - w0) / V : 0;  // W % V == 0
      const T* base = arow + w0 / V;
      T v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int q = lane + 32 * k;
        v[k] = q < nvec ? __ldcs(base + q) : T{};
      }
      if (first && w0 == 0 && may_table) {
        bool dense = false;
#pragma unroll
        for (int k = 0; k < kLoads; ++k)
#pragma unroll
          for (int c = 0; c < V; ++c)
            dense |= __popc(word_of(v[k], c)) > kTableMinBits;
        if (__syncthreads_or(dense)) {
          build_table(wmin, labels_j, C, lj16);
          __syncthreads();
          table = true;
        }
      }
      unsigned any = 0;
#pragma unroll
      for (int k = 0; k < kLoads; ++k)
#pragma unroll
        for (int c = 0; c < V; ++c) any |= word_of(v[k], c);
      if (!__any_sync(kFull, any != 0)) continue;  // most of a sparse graph
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const int w = w0 + (lane + 32 * k) * V + c;
          unsigned bits = word_of(v[k], c);
          const int left = C - 32 * w;
          if (left < 32) bits &= left > 0 ? (1u << left) - 1 : 0u;
          if (!bits) continue;
          int least = INT_MIN;
          if (table && w < wfull) {
            least = wmin[w];  // no bit of w goes below it
            if (least >= m) continue;
            if (bits == kFull) {
              m = least;
              continue;
            }
          }
          m = word_min(bits, w, C, labels_j, dense_min, lj16, least, m);
        }
        if (table) m = __reduce_min_sync(kFull, m);
      }
    }
    if (live) {
      m = __reduce_min_sync(kFull, m);
      if (lane == 0) out[row] = m;
    }
  }
}

__global__ void cc_hop_warp_kernel(const unsigned* __restrict__ adj,
                                   const int* __restrict__ labels_self,
                                   const int* __restrict__ labels_j, int R,
                                   int W, int C, int* __restrict__ out) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarpRows + warp;
  if (row >= R) return;  // the whole warp leaves together
  const unsigned* arow = adj + (size_t)row * W;
  int m = kBigLabel;
  for (int w = lane; w < W; w += 32) {
    unsigned bits = arow[w];
    while (bits) {
      const int j = w * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
      if (j < C) m = min(m, labels_j[j]);
    }
  }
  m = __reduce_min_sync(kFull, m);
  if (lane == 0) out[row] = min(labels_self[row], m);
}

}  // namespace

// vec: words a load (4, 2 or 1); the caller guarantees W % vec == 0 and a
// (4 vec)-byte aligned adj.  blocks: the persistent grid, at most one a
// SM.  dense_min: a word with more set bits takes the select over all of
// its labels (32 or more: every word is walked, and no table is built).
extern "C" int cc_hop_launch(const unsigned* adj, const int* labels_self,
                             const int* labels_j, int R, int W, int C,
                             int vec, int blocks, int dense_min, int* out,
                             cudaStream_t stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  const int table = W <= kTableMaxWords ? W : 0;
  const size_t smem = sizeof(int) * table;
  if (vec == 4)
    cc_hop_kernel<4><<<blocks, kThreads, smem, stream>>>(
        adj, labels_self, labels_j, R, W, C, dense_min, table, out);
  else if (vec == 2)
    cc_hop_kernel<2><<<blocks, kThreads, smem, stream>>>(
        adj, labels_self, labels_j, R, W, C, dense_min, table, out);
  else if (vec == 1)
    cc_hop_kernel<1><<<blocks, kThreads, smem, stream>>>(
        adj, labels_self, labels_j, R, W, C, dense_min, table, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int cc_hop_warp_launch(const unsigned* adj,
                                  const int* labels_self,
                                  const int* labels_j, int R, int W, int C,
                                  int* out, cudaStream_t stream) {
  const int blocks = (R + kWarpRows - 1) / kWarpRows;
  cc_hop_warp_kernel<<<blocks, 32 * kWarpRows, 0, stream>>>(
      adj, labels_self, labels_j, R, W, C, out);
  return (int)cudaGetLastError();
}
