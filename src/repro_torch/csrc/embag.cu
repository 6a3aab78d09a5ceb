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
// reuse to exploit; the design is about keeping many independent row
// loads in flight.
//
// Design: the TPU kernel's sequential (bag, slot) grid with scalar-
// prefetched row DMAs becomes per-thread gathers.  A group of G lanes
// (a power of two, at most 32, so groups never straddle a warp) owns one
// bag; lane i owns the 16-byte chunks i, i + G, ... of the row (4-byte
// chunks when D is not a multiple of 4 or the table is not 16-byte
// aligned).  The slots are taken four at a time: four ids and weights,
// then four predicated row loads, then four FMAs into registers in slot
// order, and the lane writes its chunk of the sum once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

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
};
template <>
struct Chunk<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T fma(float w, T r, T a) { return fmaf(w, r, a); }
};

__device__ __forceinline__ int wrap_id(int id, int V) {
  if (id < 0) id += V;
  return min(max(id, 0), V - 1);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    embag_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                 const float* __restrict__ wt, float* __restrict__ out, int V,
                 int D, int B, int L, int G) {
  using C = Chunk<VEC>;
  using T = typename C::T;
  const long t = (long)blockIdx.x * kThreads + threadIdx.x;
  const long bag = t / G;
  const int lane = (int)(t % G);
  if (bag >= B) return;
  const int chunks = D / VEC;
  const int* ib = idx + bag * L;
  const float* wb = wt + bag * L;
  const T* rows = reinterpret_cast<const T*>(table);
  T* ob = reinterpret_cast<T*>(out + bag * D);

  for (int c = lane; c < chunks; c += G) {
    T acc = C::zero();
    int l = 0;
    for (; l + kUnroll <= L; l += kUnroll) {
      int id[kUnroll];
      float w[kUnroll];
      T r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        w[u] = wb[l + u];
        id[u] = wrap_id(ib[l + u], V);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        r[u] = w[u] != 0.f ? rows[(size_t)id[u] * chunks + c] : C::zero();
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = C::fma(w[u], r[u], acc);
    }
    for (; l < L; ++l) {
      const float w = wb[l];
      if (w != 0.f)
        acc = C::fma(w, rows[(size_t)wrap_id(ib[l], V) * chunks + c], acc);
    }
    ob[c] = acc;
  }
}

}  // namespace

extern "C" int embedding_bag_launch(const float* table, const int* idx,
                                    const float* wt, float* out, int V, int D,
                                    int B, int L, cudaStream_t stream) {
  const bool vec = D % 4 == 0 && (uintptr_t)table % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const int chunks = vec ? D / 4 : D;
  int G = 1;
  while (G < chunks && G < 32) G <<= 1;
  const long lanes = (long)B * G;
  const int blocks = (int)((lanes + kThreads - 1) / kThreads);
  if (vec)
    embag_kernel<4><<<blocks, kThreads, 0, stream>>>(table, idx, wt, out, V, D,
                                                     B, L, G);
  else
    embag_kernel<1><<<blocks, kThreads, 0, stream>>>(table, idx, wt, out, V, D,
                                                     B, L, G);
  return (int)cudaGetLastError();
}
