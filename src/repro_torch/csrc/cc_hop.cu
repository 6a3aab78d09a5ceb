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
// Design: one warp per row, eight rows per block.  The lanes stride over
// the row's words, so each warp reads its row with coalesced loads; a lane
// walks the set bits of its word with __ffs and gathers the labels of
// those columns only (a pruned graph is sparse, so most words are 0 and
// cost one load).  __reduce_min_sync takes the warp's minimum.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kBigLabel = 1 << 30;

__global__ void cc_hop_kernel(const unsigned* __restrict__ adj,
                              const int* __restrict__ labels_self,
                              const int* __restrict__ labels_j, int R, int W,
                              int C, int* __restrict__ out) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
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
  m = __reduce_min_sync(0xffffffffu, m);
  if (lane == 0) out[row] = min(labels_self[row], m);
}

}  // namespace

extern "C" int cc_hop_launch(const unsigned* adj, const int* labels_self,
                             const int* labels_j, int R, int W, int C,
                             int* out, cudaStream_t stream) {
  const int blocks = (R + kWarps - 1) / kWarps;
  cc_hop_kernel<<<blocks, 32 * kWarps, 0, stream>>>(adj, labels_self,
                                                    labels_j, R, W, C, out);
  return (int)cudaGetLastError();
}
