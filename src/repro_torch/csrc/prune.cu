// CLUB edge pruning over the bit-packed adjacency (stage 2).
//
// Replaces: src/repro/kernels/graph/graph.py, prune_packed_pallas
//           (body _prune_kernel).
//
// For every row i and column j (bit j % 32 of word j / 32 of row i):
//   d2   = (|v_i|^2 + |v_j|^2) - 2 v_i.v_j
//   keep = sqrt(max(d2, 0)) < gamma (cb_i + cb_j)
//   out  = adj AND keep
// Columns >= C (the ragged end of the last word) see zero vectors, as in
// the reference; their adjacency bits are 0, so they stay 0.
//
// Bound on an H100: f32 arithmetic.  Every pair costs ~2d + 8 flops
// (58 at d=25), 2.4e10 flops for a full 20480^2 graph, ~0.36 ms at
// 67 TFLOP/s; the packed adjacency it reads and writes is only 105 MB
// (~31 us).  The arithmetic is plain f32 FMAs on the CUDA cores: TF32 or
// tensor cores would round the distance differently and move edge bits.
//
// Design: each thread owns one 32-bit word of a row, i.e. 32 column
// distances against one row vector.  A block of 256 threads covers 8
// words (256 columns) by 64 rows: the 256 column vectors, their squared
// norms and widths are staged in shared memory once and reused by the 64
// rows.  Column vectors are stored transposed and interleaved
// (feature k, bit b, word w at k*256 + b*8 + w) so the 8 words a warp
// reads for one bit are 8 consecutive banks.  A thread walks only the set
// bits of its word (__ffs): a bit that is already 0 stays 0 under the AND,
// so pruned-out pairs cost nothing in later epochs.  The word is rebuilt
// with AND-NOT and written once; the [n, n] distances never reach memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWordsPerBlock = 8;
constexpr int kColsPerBlock = 32 * kWordsPerBlock;   // 256
constexpr int kRowGroups = 2;
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kRowGroups * kThreads / kWordsPerBlock;  // 64

__global__ void prune_kernel(const unsigned* __restrict__ adj,
                             const float* __restrict__ v_i,
                             const float* __restrict__ cb_i,
                             const float* __restrict__ v_j,
                             const float* __restrict__ cb_j, float gamma,
                             int R, int W, int C, int d,
                             unsigned* __restrict__ out) {
  extern __shared__ float smem[];
  float* vjT = smem;                                // [d][256]
  float* sqj = vjT + d * kColsPerBlock;             // [256]
  float* cbj = sqj + kColsPerBlock;                 // [256]
  float* vi_s = cbj + kColsPerBlock;                // [64][d]
  float* sqi = vi_s + kRowsPerBlock * d;            // [64]
  float* cbi = sqi + kRowsPerBlock;                 // [64]

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kColsPerBlock;
  const int row0 = blockIdx.y * kRowsPerBlock;

  // column tile: global reads in row-major order, interleaved store
  for (int f = tid; f < kColsPerBlock * d; f += kThreads) {
    const int c = f / d;
    const int k = f - c * d;
    const int gc = col0 + c;
    const float val = gc < C ? v_j[(size_t)col0 * d + f] : 0.f;
    vjT[k * kColsPerBlock + (c % 32) * kWordsPerBlock + c / 32] = val;
  }
  {
    const int c = tid;  // kThreads == kColsPerBlock
    const int gc = col0 + c;
    cbj[(c % 32) * kWordsPerBlock + c / 32] = gc < C ? cb_j[gc] : 0.f;
  }
  for (int f = tid; f < kRowsPerBlock * d; f += kThreads) {
    const int gr = row0 + f / d;
    vi_s[f] = gr < R ? v_i[(size_t)row0 * d + f] : 0.f;
  }
  if (tid < kRowsPerBlock) {
    const int gr = row0 + tid;
    cbi[tid] = gr < R ? cb_i[gr] : 0.f;
  }
  __syncthreads();
  {
    float s = 0.f;
    for (int k = 0; k < d; ++k) {
      const float v = vjT[k * kColsPerBlock + tid];
      s = fmaf(v, v, s);
    }
    sqj[tid] = s;
  }
  if (tid < kRowsPerBlock) {
    float s = 0.f;
    for (int k = 0; k < d; ++k) {
      const float v = vi_s[tid * d + k];
      s = fmaf(v, v, s);
    }
    sqi[tid] = s;
  }
  __syncthreads();

  const int wi = tid % kWordsPerBlock;
  const int gw = blockIdx.x * kWordsPerBlock + wi;
  if (gw >= W) return;
  for (int g = 0; g < kRowGroups; ++g) {
    const int rr = tid / kWordsPerBlock + g * (kThreads / kWordsPerBlock);
    const int gr = row0 + rr;
    if (gr >= R) break;
    const unsigned word = adj[(size_t)gr * W + gw];
    unsigned keep = word;
    unsigned todo = word;
    const float* vi = vi_s + rr * d;
    while (todo) {
      const int b = __ffs(todo) - 1;
      todo &= todo - 1;
      const int cc = b * kWordsPerBlock + wi;
      float dot = 0.f;
      for (int k = 0; k < d; ++k)
        dot = fmaf(vi[k], vjT[k * kColsPerBlock + cc], dot);
      const float d2 =
          __fsub_rn(__fadd_rn(sqi[rr], sqj[cc]), __fmul_rn(2.f, dot));
      const float dist = sqrtf(fmaxf(d2, 0.f));
      const float thresh = __fmul_rn(gamma, __fadd_rn(cbi[rr], cbj[cc]));
      if (!(dist < thresh)) keep &= ~(1u << b);
    }
    out[(size_t)gr * W + gw] = keep;
  }
}

}  // namespace

extern "C" int prune_launch(const unsigned* adj, const float* v_i,
                            const float* cb_i, const float* v_j,
                            const float* cb_j, float gamma, int R, int W,
                            int C, int d, unsigned* out, cudaStream_t stream) {
  const size_t smem =
      ((size_t)(kColsPerBlock + kRowsPerBlock) * (d + 2)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        prune_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + kWordsPerBlock - 1) / kWordsPerBlock,
                  (R + kRowsPerBlock - 1) / kRowsPerBlock);
  prune_kernel<<<grid, kThreads, smem, stream>>>(adj, v_i, cb_i, v_j, cb_j,
                                                 gamma, R, W, C, d, out);
  return (int)cudaGetLastError();
}
