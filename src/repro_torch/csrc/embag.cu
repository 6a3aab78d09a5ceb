// EmbeddingBag: weighted sum of gathered table rows per bag.
//
// Replaces: src/repro/kernels/embag/embag.py, embedding_bag_pallas
//           (body _embag_kernel).
//
//   out[b, :] = sum_l wt[b, l] * table[id(b, l), :]
//   id(b, l)  = clamp(idx[b, l] < 0 ? idx[b, l] + V : idx[b, l], 0, V - 1)
//
// (jnp's gather rule, which the JAX package's models index with.)  A slot
// whose weight is 0 is a pad: its row is not read, and it adds nothing.
//
// Bound on an H100: memory.  Each bag reads its L ids and weights (8 B
// each), the rows of its non-pad slots (4 D B each, at random rows of the
// table) and writes its sum once: at 262144 bags of L = 50 over a D = 16
// table with 20% pads, ~0.79 GB, ~0.24 ms at 3.35 TB/s.  There is no data
// reuse to exploit: the rows never go through shared memory.  What the
// card waits on is the latency of each dependent trip to memory (ids,
// then the rows they name), so the design starts every load of a trip
// at once and keeps the trips few.
//
// Design: a warp per bag, `warps` bags a block.  The warp's 32 lanes form
// S = 32 / G slot groups of G chunk lanes (G a power of two that covers
// the row's chunks, at most 32): lane (s, g) owns the 16-byte chunk g of
// the row (4-byte chunks when D is not a multiple of 4 or the table is not
// 16-byte aligned; chunks g, g + G, ... in turn past 32 chunks), and its
// group takes the slots s, s + S, ....  A step covers kRows * S slots:
//   1. the warp reads their ids and weights in one coalesced pass (lane l
//      holds slots l, l + 32, ...) and applies the id rule there;
//   2. each lane takes its kRows slots' ids and weights from the lanes
//      that hold them (__shfl_sync) and starts all kRows predicated row
//      loads, a pad's not at all;
//   3. the next step's ids and weights are loaded while the rows arrive;
//   4. the lane adds its rows in slot order (FMA).
// At D = 16 a step covers 64 slots, so a bag of 50 costs two dependent
// trips.  xor shuffles then sum the S groups' partial sums, and group 0
// stores the bag's sum once.  The launch geometry (VEC, G, warps a block)
// comes from the wrapper (kernels/embag/ops.py, launch_geometry).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 8;       // row loads a lane keeps in flight per step
constexpr int kMaxWarps = 8;   // warps a block, at most

template <int VEC>
struct Chunk;
template <>
struct Chunk<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T fma(float w, T r, T a) {
    return make_float4(fmaf(w, r.x, a.x), fmaf(w, r.y, a.y),
                       fmaf(w, r.z, a.z), fmaf(w, r.w, a.w));
  }
  __device__ static T add_xor(T a, int off) {
    return make_float4(a.x + __shfl_xor_sync(kFull, a.x, off),
                       a.y + __shfl_xor_sync(kFull, a.y, off),
                       a.z + __shfl_xor_sync(kFull, a.z, off),
                       a.w + __shfl_xor_sync(kFull, a.w, off));
  }
};
template <>
struct Chunk<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T fma(float w, T r, T a) { return fmaf(w, r, a); }
  __device__ static T add_xor(T a, int off) {
    return a + __shfl_xor_sync(kFull, a, off);
  }
};

__device__ __forceinline__ int wrap_id(int id, int V) {
  if (id < 0) id += V;
  return min(max(id, 0), V - 1);
}

// Raw ids and weights of the kSlots slots from `base`, lane l holding
// slots base + l + 32 i; slots past the bag (or the step) get weight 0.
template <int kSlots, int kIds>
__device__ __forceinline__ void load_slots(const int* ib, const float* wb,
                                           int base, int L, int lane,
                                           int (&id)[kIds], float (&w)[kIds]) {
#pragma unroll
  for (int i = 0; i < kIds; ++i) {
    const int j = lane + 32 * i;
    const bool in = j < kSlots && base + j < L;
    id[i] = in ? ib[base + j] : 0;
    w[i] = in ? wb[base + j] : 0.f;
  }
}

template <int VEC, int G>
__global__ void __launch_bounds__(32 * kMaxWarps)
    embag_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                 const float* __restrict__ wt, float* __restrict__ out, int V,
                 int D, int B, int L) {
  using C = Chunk<VEC>;
  using T = typename C::T;
  constexpr int S = 32 / G;                   // slot groups of the warp
  constexpr int kSlots = kRows * S;           // slots a step covers
  constexpr int kIds = (kSlots + 31) / 32;    // ids a lane holds per step
  const int lane = threadIdx.x & 31;
  const long bag = (long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (bag >= B) return;  // the whole warp leaves together
  const int s = lane / G;
  const int chunks = D / VEC;
  const int* ib = idx + bag * L;
  const float* wb = wt + bag * L;
  const T* rows = reinterpret_cast<const T*>(table);
  T* ob = reinterpret_cast<T*>(out + bag * D);

  for (int c0 = 0; c0 < chunks; c0 += G) {  // uniform across the warp
    const int c = c0 + lane % G;
    const bool has_chunk = c < chunks;
    T acc = C::zero();
    int raw[kIds];
    float nw[kIds];
    load_slots<kSlots>(ib, wb, 0, L, lane, raw, nw);
    for (int base = 0; base < L; base += kSlots) {
      int id[kIds];
      float w[kIds];
#pragma unroll
      for (int i = 0; i < kIds; ++i) {
        id[i] = wrap_id(raw[i], V);
        w[i] = nw[i];
      }
      // slot base + s + k S is held by lane s + S (k % G), register k / G
      T r[kRows];
      float rw[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int src = s + S * (k % G);
        const int rid = __shfl_sync(kFull, id[k / G], src);
        rw[k] = __shfl_sync(kFull, w[k / G], src);
        r[k] = has_chunk && rw[k] != 0.f ? rows[(size_t)rid * chunks + c]
                                         : C::zero();
      }
      if (base + kSlots < L)
        load_slots<kSlots>(ib, wb, base + kSlots, L, lane, raw, nw);
#pragma unroll
      for (int k = 0; k < kRows; ++k) acc = C::fma(rw[k], r[k], acc);
    }
#pragma unroll
    for (int off = G; off < 32; off <<= 1) acc = C::add_xor(acc, off);
    if (s == 0 && has_chunk) ob[c] = acc;
  }
}

template <int VEC, int G>
int run(const float* table, const int* idx, const float* wt, float* out,
        int V, int D, int B, int L, int warps, cudaStream_t stream) {
  const long blocks = ((long)B + warps - 1) / warps;
  embag_kernel<VEC, G><<<(unsigned)blocks, 32 * warps, 0, stream>>>(
      table, idx, wt, out, V, D, B, L);
  return (int)cudaGetLastError();
}

template <int VEC>
int dispatch(const float* table, const int* idx, const float* wt, float* out,
             int V, int D, int B, int L, int G, int warps,
             cudaStream_t stream) {
  switch (G) {
    case 1: return run<VEC, 1>(table, idx, wt, out, V, D, B, L, warps, stream);
    case 2: return run<VEC, 2>(table, idx, wt, out, V, D, B, L, warps, stream);
    case 4: return run<VEC, 4>(table, idx, wt, out, V, D, B, L, warps, stream);
    case 8: return run<VEC, 8>(table, idx, wt, out, V, D, B, L, warps, stream);
    case 16:
      return run<VEC, 16>(table, idx, wt, out, V, D, B, L, warps, stream);
    case 32:
      return run<VEC, 32>(table, idx, wt, out, V, D, B, L, warps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// vec (4 or 1 floats a chunk), G (chunk lanes a slot group) and warps (a
// block) are the wrapper's geometry; a vec of 4 that the table's shape or
// alignment does not allow is refused, as is a block of more than
// kMaxWarps warps.
extern "C" int embedding_bag_launch(const float* table, const int* idx,
                                    const float* wt, float* out, int V, int D,
                                    int B, int L, int vec, int G, int warps,
                                    cudaStream_t stream) {
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  if (vec == 4) {
    if (D % 4 != 0 || (uintptr_t)table % 16 != 0 || (uintptr_t)out % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return dispatch<4>(table, idx, wt, out, V, D, B, L, G, warps, stream);
  }
  if (vec == 1)
    return dispatch<1>(table, idx, wt, out, V, D, B, L, G, warps, stream);
  return (int)cudaErrorInvalidValue;
}
