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
// Design.  A first kernel (prune_prep_kernel) writes both vector sets
// transposed, [k][vector] with the vector count padded to 128, the
// columns interleaved within each 128 as [bit][word], and their squared
// norms (fmaf from 0 in ascending k, as the reference).  The main kernel
// is persistent (as many blocks as fit on the card) over tiles of 128
// rows by 4 words (128 columns); a warp owns 16 of the rows, and lane b
// owns bit b of the 4 words, i.e. 4 columns.  While a block works on a
// tile it loads its next tile's words.  Each warp counts the set bits of
// its 64 words; a tile whose block has a warp with more than sparse_max
// of them is dense, the others sparse:
// - dense: the block's row and column vectors stream through shared
//   memory in slabs of kSlab features, double-buffered with 16-byte
//   cp.async (any d fits); for each k a lane reads its 16 rows as 4
//   broadcast float4s and its 4 columns as one float4, 8 shared
//   wavefronts per 64 FMAs into 64 accumulators (16 rows x 4 columns), so
//   the FMA pipe, not shared memory, is the limit (a dependent chain per
//   set bit with both operands from shared memory was 2 wavefronts per
//   FMA).  The keep bits of a (row, word) are one __ballot_sync, ANDed
//   with the word and stored once; the square root is sqrt_rn, sqrtf
//   without its branch, so the 64 pairs' epilogues interleave.
// - sparse: each warp compacts its set bits into a list; lane l takes
//   entries l, l + 32, ... and reads only those pairs' features from the
//   transposed vectors in global memory (a warp's 16 rows and 128 columns
//   are contiguous there, so its loads coalesce); a failing pair clears
//   its bit in the warp's copy of the words with a shared atomicAnd.
//   Nothing is staged, and a tile whose 512 words are all 0 only writes
//   zeros.
// The threshold is a block's choice, not a warp's: in a dense tile the
// dense warps set the block's time, and a walk would add to it.  Both
// branches run the reference's per-pair arithmetic in its order (the dot
// product fmaf from 0 in ascending k, then the rounded adds, product,
// square root and strict compare of keep_pair, the one keep test of
// both), so the words do not depend on the branch.

#include <cuda_runtime.h>
#include <math.h>

#include "sqrt_rn.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 16;
constexpr int kWords = 4;                        // words per block = per lane
constexpr int kRows = kWarps * kRowsPerWarp;     // 128 rows per block
constexpr int kCols = 32 * kWords;               // 128 columns per block
constexpr int kSlab = 16;                        // features per stage
constexpr int kTileWords = kRowsPerWarp * kWords;  // 64 words per warp
constexpr int kSparseRounds = 8;
constexpr int kSparseCap = 32 * kSparseRounds;   // 256 set bits per warp
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The keep bit of one pair, as the reference computes it (sqrt_rn is
// sqrtf bit for bit, without its branch).
__device__ __forceinline__ bool keep_pair(float dot, float sqi, float sqj,
                                          float cbi, float cbj,
                                          float gamma) {
  const float d2 = __fsub_rn(__fadd_rn(sqi, sqj), __fmul_rn(2.f, dot));
  const float dist = sqrt_rn(fmaxf(d2, 0.f));
  const float thresh = __fmul_rn(gamma, __fadd_rn(cbi, cbj));
  return dist < thresh;
}

// v_i[row] . v_j[col] from the transposed vectors (``ri`` = vTi + row,
// ``cj`` = vTj + interleaved column), fmaf from 0 in ascending k, with 8
// features' loads in flight at once.
__device__ __forceinline__ float dot_global(const float* __restrict__ ri,
                                            const float* __restrict__ cj,
                                            int Rp, int Cp, int d) {
  float dot = 0.f;
  int k = 0;
  for (; k + 8 <= d; k += 8) {
    float a[8], c[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      a[u] = __ldg(ri + (size_t)(k + u) * Rp);
      c[u] = __ldg(cj + (size_t)(k + u) * Cp);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) dot = fmaf(a[u], c[u], dot);
  }
  for (; k < d; ++k)
    dot = fmaf(__ldg(ri + (size_t)k * Rp), __ldg(cj + (size_t)k * Cp), dot);
  return dot;
}

// v [n, d] -> vT [d, np] (np = n padded to kCols; with ``interleave``
// vector c of each 128 at (c % 32) * kWords + c / 32) and sq [np], zero
// past n.
__global__ void __launch_bounds__(kCols)
    prune_prep_kernel(const float* __restrict__ v, int n, int np, int d,
                      bool interleave, float* __restrict__ vT,
                      float* __restrict__ sq) {
  const int r = blockIdx.x * kCols + threadIdx.x;
  const int c = threadIdx.x;
  const int pos = interleave
                      ? blockIdx.x * kCols + (c % 32) * kWords + c / 32
                      : r;
  float s = 0.f;
  for (int k = 0; k < d; ++k) {
    const float x = r < n ? v[(size_t)r * d + k] : 0.f;
    s = fmaf(x, x, s);
    vT[(size_t)k * np + pos] = x;
  }
  sq[r] = s;
}

struct Slabs {
  float rows[2][kSlab][kRows];           // [buf][k][row]
  float cols[2][kSlab][kCols];           // [buf][k][bit * kWords + word]
};

// Slab of features [k0, k0 + kSlab) of the block's rows and columns from
// the transposed vectors; the features past d are zero-filled.
__device__ __forceinline__ void stage_slab(Slabs& sm, int buf,
                                           const float* __restrict__ vTi,
                                           const float* __restrict__ vTj,
                                           int Rp, int Cp, int d, int row0,
                                           int col0, int k0) {
  constexpr int kChunks = kSlab * kRows / 4;     // 16-byte pieces per set
  for (int q = threadIdx.x; q < 2 * kChunks; q += kThreads) {
    const bool rows = q < kChunks;
    const int e = rows ? q : q - kChunks;
    const int kk = e / (kRows / 4), part = e % (kRows / 4);
    const bool ok = k0 + kk < d;
    const size_t k = ok ? k0 + kk : 0;
    if (rows)
      cp_async16(&sm.rows[buf][kk][4 * part], vTi + k * Rp + row0 + 4 * part,
                 ok);
    else
      cp_async16(&sm.cols[buf][kk][4 * part], vTj + k * Cp + col0 + 4 * part,
                 ok);
  }
}

// The sparse branch: the warp's listed pairs, 32 at a time, features
// from the transposed vectors in global memory.  Clears the failing
// pairs' bits in ``words`` (the warp's 64 words in shared memory).
__device__ __forceinline__ void walk_pairs(
    const unsigned short* list, int count, unsigned* words,
    const float* __restrict__ vTi, const float* __restrict__ vTj, int Rp,
    int Cp, int d, int row0, int col0, int wrow0, const float* sq_r,
    const float* sq_c, const float* cb_r, const float* cb_c, float gamma,
    int lane) {
  for (int q = lane; q - lane < count; q += 32) {
    const bool live = q < count;
    const int code = live ? list[q] : 0;         // word idx * 32 + bit
    const int idx = code / 32, b = code % 32;
    const int row = wrow0 + idx / kWords;        // row in the block
    const int cw = idx % kWords, cc = cw * 32 + b;
    const float dot = dot_global(vTi + row0 + row,
                                 vTj + col0 + b * kWords + cw, Rp, Cp, d);
    if (live &&
        !keep_pair(dot, sq_r[row], sq_c[cc], cb_r[row], cb_c[cc], gamma))
      atomicAnd(&words[idx], ~(1u << b));
  }
}

// acc[r][w] += row r's k-th feature x column w's, for the slab's first
// kn features (``guard``; all kSlab of them otherwise, as straight-line
// code whose loads are scheduled ahead of the FMAs).
__device__ __forceinline__ void dense_slab(
    float (&acc)[kRowsPerWarp][kWords], const float (*rows)[kRows],
    const float (*cols)[kCols], int wrow0, int lane, bool guard, int kn) {
#pragma unroll
  for (int kk = 0; kk < kSlab; ++kk) {
    if (guard && kk >= kn) return;
    const float4 c =
        *reinterpret_cast<const float4*>(&cols[kk][lane * kWords]);
#pragma unroll
    for (int rq = 0; rq < kRowsPerWarp / 4; ++rq) {
      const float4 v =
          *reinterpret_cast<const float4*>(&rows[kk][wrow0 + 4 * rq]);
      const float vr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[4 * rq + i][0] = fmaf(vr[i], c.x, acc[4 * rq + i][0]);
        acc[4 * rq + i][1] = fmaf(vr[i], c.y, acc[4 * rq + i][1]);
        acc[4 * rq + i][2] = fmaf(vr[i], c.z, acc[4 * rq + i][2]);
        acc[4 * rq + i][3] = fmaf(vr[i], c.w, acc[4 * rq + i][3]);
      }
    }
  }
}

// The warp's 64 words of tile (by, bx): word idx = lane + 32 s is (row
// idx / 4, word idx % 4); 0 past the adjacency.
__device__ __forceinline__ void load_words(const unsigned* __restrict__ adj,
                                           int R, int W, int by, int bx,
                                           int wrow0, int lane,
                                           unsigned (&wd)[2]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int idx = lane + 32 * s;
    const int gr = by * kRows + wrow0 + idx / kWords;
    const int gw = bx * kWords + idx % kWords;
    wd[s] = gr < R && gw < W ? __ldcs(adj + (size_t)gr * W + gw) : 0u;
  }
}

// The dense branch's words: every pair of the warp's 16 x 128 tile, one
// ballot per (row, word).
__device__ __forceinline__ void dense_words(
    const float (&acc)[kRowsPerWarp][kWords], unsigned (&wd)[2], int wrow0,
    const float* sq_r, const float* sq_c, const float* cb_r,
    const float* cb_c, float gamma, int lane) {
  float sqj[kWords], cbj[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    sqj[w] = sq_c[w * 32 + lane];
    cbj[w] = cb_c[w * 32 + lane];
  }
  unsigned res[2] = {0u, 0u};
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float sqi = sq_r[wrow0 + r], cbi = cb_r[wrow0 + r];
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const unsigned m = __ballot_sync(
          kFull, keep_pair(acc[r][w], sqi, sqj[w], cbi, cbj[w], gamma));
      const int idx = r * kWords + w;
      if (lane == idx % 32) res[idx / 32] = m;
    }
  }
  wd[0] &= res[0];
  wd[1] &= res[1];
}

// The sparse branch's words: the set bits listed (code = word idx * 32 +
// bit, in order) and walked.
__device__ __forceinline__ void sparse_words(
    unsigned (&wd)[2], int count, unsigned* words, unsigned short* list,
    const float* __restrict__ vTi, const float* __restrict__ vTj, int Rp,
    int Cp, int d, int row0, int col0, int wrow0, const float* sq_r,
    const float* sq_c, const float* cb_r, const float* cb_c, float gamma,
    int lane) {
  words[lane] = wd[0];
  words[lane + 32] = wd[1];
  const int mine = __popc(wd[0]) + __popc(wd[1]);
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  int pos = incl - mine;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    unsigned w = wd[s];
    while (w) {
      const int b = __ffs(w) - 1;
      w &= w - 1;
      list[pos++] = (unsigned short)((lane + 32 * s) * 32 + b);
    }
  }
  __syncwarp();
  walk_pairs(list, count, words, vTi, vTj, Rp, Cp, d, row0, col0, wrow0,
             sq_r, sq_c, cb_r, cb_c, gamma, lane);
  __syncwarp();
  wd[0] = words[lane];
  wd[1] = words[lane + 32];
}

// Persistent: block b takes tiles b, b + gridDim.x, ... of the
// (Rp / kRows) x (Cp / kCols) tiles, row-major, and loads the next tile's
// words while it works on the current one.
__global__ void __launch_bounds__(kThreads, 2)
    prune_kernel(const unsigned* __restrict__ adj,
                 const float* __restrict__ vTi, const float* __restrict__ sqi,
                 const float* __restrict__ cb_i,
                 const float* __restrict__ vTj, const float* __restrict__ sqj,
                 const float* __restrict__ cb_j, float gamma, int R, int W,
                 int C, int Rp, int Cp, int d, int sparse_max,
                 unsigned* __restrict__ out) {
  __shared__ __align__(16) Slabs sm;
  __shared__ float sq_r[kRows], sq_c[kCols], cb_r[kRows], cb_c[kCols];
  __shared__ unsigned words_s[kWarps][kTileWords];
  __shared__ unsigned short list_s[kWarps][kSparseCap];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wrow0 = warp * kRowsPerWarp;       // the warp's rows in the block
  const int tiles_x = Cp / kCols, tiles = tiles_x * (Rp / kRows);
  const int n_slabs = (d + kSlab - 1) / kSlab;
  const int thresh = min(sparse_max, kSparseCap);
  unsigned next[2];
  if (blockIdx.x < tiles)
    load_words(adj, R, W, blockIdx.x / tiles_x, blockIdx.x % tiles_x, wrow0,
               lane, next);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int by = tile / tiles_x, bx = tile % tiles_x;
    const int row0 = by * kRows, word0 = bx * kWords, col0 = 32 * word0;
    unsigned wd[2] = {next[0], next[1]};
    const int after = tile + gridDim.x;
    if (after < tiles)
      load_words(adj, R, W, after / tiles_x, after % tiles_x, wrow0, lane,
                 next);
    const int count =
        __reduce_add_sync(kFull, __popc(wd[0]) + __popc(wd[1]));
    // also the barrier between this tile and the last one's epilogue
    if (__syncthreads_or(count > 0)) {
      // a block with a warp over the threshold stages its slabs, and then
      // every warp computes its tile densely: the dense warps set the
      // block's time, and the walk would add to it
      const bool dense = __syncthreads_or(count > thresh);
      if (dense) {
        stage_slab(sm, 0, vTi, vTj, Rp, Cp, d, row0, col0, 0);
        cp_commit();
      }
      if (tid < kRows) {
        const int gr = row0 + tid;
        sq_r[tid] = sqi[gr];
        cb_r[tid] = gr < R ? cb_i[gr] : 0.f;
      } else {
        const int cc = tid - kRows, gc = col0 + cc;
        sq_c[cc] = sqj[gc];
        cb_c[cc] = gc < C ? cb_j[gc] : 0.f;
      }

      float acc[kRowsPerWarp][kWords];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int w = 0; w < kWords; ++w) acc[r][w] = 0.f;
      for (int s = 0; dense && s < n_slabs; ++s) {
        const int buf = s & 1;
        if (s + 1 < n_slabs) {
          stage_slab(sm, buf ^ 1, vTi, vTj, Rp, Cp, d, row0, col0,
                     (s + 1) * kSlab);
          cp_commit();
          cp_wait<1>();
        } else {
          cp_wait<0>();
        }
        __syncthreads();
        const int kn = min(kSlab, d - s * kSlab);
        if (kn == kSlab)
          dense_slab(acc, sm.rows[buf], sm.cols[buf], wrow0, lane, false, kn);
        else
          dense_slab(acc, sm.rows[buf], sm.cols[buf], wrow0, lane, true, kn);
        __syncthreads();  // buf is restaged by the next iteration
      }

      if (!dense || n_slabs == 0) {  // sq_r .. cb_c
        cp_wait<0>();
        __syncthreads();
      }

      if (dense)
        dense_words(acc, wd, wrow0, sq_r, sq_c, cb_r, cb_c, gamma, lane);
      else if (count > 0)
        sparse_words(wd, count, words_s[warp], list_s[warp], vTi, vTj, Rp,
                     Cp, d, row0, col0, wrow0, sq_r, sq_c, cb_r, cb_c, gamma,
                     lane);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int idx = lane + 32 * s;
      const int gr = row0 + wrow0 + idx / kWords, gw = word0 + idx % kWords;
      if (gr < R && gw < W) __stcs(out + (size_t)gr * W + gw, wd[s]);
    }
  }
}

// Counts the x in [+0, +inf] whose sqrt_rn differs from sqrtf in its bits.
__global__ void sqrt_check_kernel(unsigned long long* mismatches) {
  unsigned long long n = 0;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned b = blockIdx.x * blockDim.x + threadIdx.x; b <= 0x7f800000u;
       b += stride) {
    const float x = __uint_as_float(b);
    n += __float_as_uint(sqrt_rn(x)) != __float_as_uint(sqrtf(x));
  }
  atomicAdd(mismatches, n);
}

}  // namespace

// sqrt_rn against sqrtf on every non-negative float: adds the mismatches
// to *mismatches (a zeroed device counter).
extern "C" int prune_sqrt_check(unsigned long long* mismatches,
                                cudaStream_t stream) {
  sqrt_check_kernel<<<1024, 256, 0, stream>>>(mismatches);
  return (int)cudaGetLastError();
}

// sparse_max: a warp whose 64 words hold at most this many set bits (and
// at most kSparseCap) walks them; above it, every pair of its tile.
// ``work`` is scratch for the transposed vectors and norms:
// (d + 1) (Rp + Cp) floats, Rp = R and Cp = 32 W each rounded up to 128.
extern "C" int prune_launch(const unsigned* adj, const float* v_i,
                            const float* cb_i, const float* v_j,
                            const float* cb_j, float gamma, int R, int W,
                            int C, int d, int sparse_max, float* work,
                            unsigned* out, cudaStream_t stream) {
  const int Rp = (R + kRows - 1) / kRows * kRows;
  const int Cp = (W + kWords - 1) / kWords * kCols;
  float* vTi = work;
  float* sqi = vTi + (size_t)d * Rp;
  float* vTj = sqi + Rp;
  float* sqj = vTj + (size_t)d * Cp;
  prune_prep_kernel<<<Rp / kCols, kCols, 0, stream>>>(v_i, R, Rp, d, false,
                                                      vTi, sqi);
  prune_prep_kernel<<<Cp / kCols, kCols, 0, stream>>>(v_j, C, Cp, d, true,
                                                      vTj, sqj);
  // persistent: as many blocks as fit on the card at once
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, prune_kernel, kThreads, 0)) != cudaSuccess)
    return (int)e;
  const int tiles = (Cp / kCols) * (Rp / kRows);
  const int grid = min(tiles, max(1, sms * per_sm));
  prune_kernel<<<grid, kThreads, 0, stream>>>(adj, vTi, sqi, cb_i, vTj, sqj,
                                              cb_j, gamma, R, W, C, Rp, Cp,
                                              d, sparse_max, out);
  return (int)cudaGetLastError();
}
