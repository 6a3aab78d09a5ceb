// DCN-v2 cross layer: a GEMM with its epilogue fused.
//
// Replaces: src/repro/kernels/cross/cross.py, cross_layer_pallas
//           (body _cross_kernel).
//
//   out[b, j] = x0[b, j] * (sum_k xl[b, k] W[j, k] + bias[j]) + xl[b, j]
//
// The contraction runs over W's dim 1 (xl @ W^T): both operands are
// contiguous along k, an "NT" product.  f32 in, out and accumulation, on
// the CUDA cores: no TF32, no tensor cores.  The output goes to a fresh
// buffer, never over xl: blocks of the same rows read all of xl while
// others write.
//
// Bound on an H100: f32 arithmetic at large batch.  At the published
// config (d = 429) and B = 262144 a layer is 2 B d^2 = 9.65e10 flops,
// 1.44 ms at 67 TFLOP/s, against 1.35 GB of x0, xl and out (0.40 ms at
// 3.35 TB/s).  At B = 512 the bound is ~3 us and the launch sets the time.
//
// Design: shared-memory-tiled SIMT FMA with a register micro-tile.  A
// block owns a BM x BN tile of out and walks k in steps of BK: each step's
// xl and W tiles are loaded from global memory into registers (coalesced
// along k, masked to 0 past B, d and the depth), stored transposed into
// one of two shared buffers, and each thread accumulates a TM x TN
// micro-tile from float4 reads of the other buffer, one barrier per step.
// The epilogue adds the bias, multiplies by x0 and adds xl with one read
// of each and one write of out.  d = 429 is not a multiple of any tile:
// ragged rows, columns and depth are masked, nothing is padded.  Two tile
// shapes: 128 x 64 (8 x 4 per thread) where it launches at least two
// blocks per SM, else 32 x 32 (2 x 2 per thread), so that B = 512 at
// d = 429 still launches 16 x 14 = 224 blocks on the 132 SMs.

#include <cuda_runtime.h>

namespace {

template <int N>
__device__ __forceinline__ void load_shared(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    cross_kernel(const float* __restrict__ x0, const float* __restrict__ xl,
                 const float* __restrict__ W, const float* __restrict__ bias,
                 float* __restrict__ out, int B, int d) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  static_assert(kThreads % BK == 0, "a load pass covers whole rows");
  constexpr int kStep = kThreads / BK;     // rows per load pass
  constexpr int kLoadsA = BM / kStep;
  constexpr int kLoadsB = BN / kStep;
  static_assert(kLoadsA * kStep == BM && kLoadsB * kStep == BN, "tiling");
  // +4: rows stay 16-byte aligned, and the transposed stores of one warp
  // fall into distinct banks but for a 2-way overlap
  __shared__ __align__(16) float As[2][BK][BM + 4];
  __shared__ __align__(16) float Bs[2][BK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int lk = tid % BK;                 // this thread's k in a tile
  const int lr = tid / BK;                 // and its first row

  float ra[kLoadsA], rb[kLoadsB];
  auto load = [&](int k0) {
    const int k = k0 + lk;
#pragma unroll
    for (int i = 0; i < kLoadsA; ++i) {
      const int r = row0 + lr + i * kStep;
      ra[i] = (r < B && k < d) ? xl[(size_t)r * d + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kLoadsB; ++i) {
      const int c = col0 + lr + i * kStep;
      rb[i] = (c < d && k < d) ? W[(size_t)c * d + k] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kLoadsA; ++i) As[buf][lk][lr + i * kStep] = ra[i];
#pragma unroll
    for (int i = 0; i < kLoadsB; ++i) Bs[buf][lk][lr + i * kStep] = rb[i];
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int steps = (d + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    if (t + 1 < steps) load((t + 1) * BK);   // in flight during the FMAs
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
      load_shared(a, &As[buf][k][ty * TM]);
      load_shared(b, &Bs[buf][k][tx * TN]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (t + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

  // epilogue, rounded as the plain version rounds it:
  // (acc + bias), times x0, plus xl
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= B) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c < d) {
        const size_t o = (size_t)r * d + c;
        out[o] = __fadd_rn(__fmul_rn(x0[o], __fadd_rn(acc[i][j], bias[c])),
                           xl[o]);
      }
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
int launch_tiles(const float* x0, const float* xl, const float* W,
                 const float* bias, float* out, int B, int d,
                 cudaStream_t stream) {
  const dim3 grid((B + BM - 1) / BM, (d + BN - 1) / BN);
  cross_kernel<BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(x0, xl, W, bias, out, B,
                                                   d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cross_launch(const float* x0, const float* xl, const float* W,
                            const float* bias, float* out, int B, int d,
                            cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long big = (long)((B + 127) / 128) * ((d + 63) / 64);
  if (big >= 2L * sms)
    return launch_tiles<128, 64, 16, 8, 4>(x0, xl, W, bias, out, B, d, stream);
  return launch_tiles<32, 32, 16, 2, 2>(x0, xl, W, bias, out, B, d, stream);
}
