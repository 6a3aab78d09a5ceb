// DCN-v2 cross layer: a GEMM with its epilogue fused.
//
// Replaces: src/repro/kernels/cross/cross.py, cross_layer_pallas
//           (body _cross_kernel).
//
//   out[b, j] = x0[b, j] * (sum_k xl[b, k] W[j, k] + bias[j]) + xl[b, j]
//
// The contraction runs over W's dim 1 (xl @ W^T): both operands are
// contiguous along k, an "NT" product.  f32 in, out and epilogue.  The
// output goes to a fresh buffer, never over xl: blocks of the same rows
// read all of xl while others write.  The wrapper picks one of two routes
// (kernels/cross/ops.py, route) and passes it to the launch.
//
// Tensor route (route 1), at large batch: 3xTF32 on the tensor cores.
// Each f32 operand v is split into hi = cvt.rna.tf32(v) and lo =
// cvt.rna.tf32(v - hi) (round to nearest: truncation would lose a bit),
// and the product accumulates lo.hi + hi.lo + hi.hi; hi + lo holds v to
// 2^-21, and one TF32 product alone errs ~100x the 2e-5 contract.  The
// tensor cores' f32 accumulation does not round to nearest: a sum carried
// through all 429 terms broke the contract (1.3x it at B = 262144), so
// each 32-term stage accumulates from 0 in a register tile of its own,
// added into the layer's sum with one f32 rounding.
// Bound on an H100: at the published config (d = 429) and B = 262144 a
// layer is 3 x 2 B d^2 = 2.9e11 TF32 flops, 0.585 ms at 495 TFLOP/s,
// against 1.35 GB of x0, xl and out (0.40 ms at 3.35 TB/s).
// Design: W is split once a call (cross_split_kernel, its own launch)
// into hi and lo tiles laid out as wgmma's B operand: 144 columns x 32 k,
// K-major, in the 128-byte swizzle, one contiguous 36 KB block a tile and
// stage.  A block of the main kernel, one warpgroup, owns a 64 x 144 tile
// of out (3 x 144 = 432 columns cover d = 429) and walks k in stages of
// 32: a stage's B block arrives in one bulk async copy (mbarrier), two
// buffers; its xl tile by 4-byte cp.async (a row of 429 floats is 1716
// bytes, no multiple of 16, so no TMA or 16-byte copy can load it) into
// a ring of three raw slots, two stages ahead, rows padded to 36 floats
// so that the fragment reads hit 32 banks.  Each thread reads its wgmma A
// fragments of the stage from the ring, splits them in registers, and
// issues m64n144k8 wgmmas with A from registers (3 a k-step of 8).  The
// barrier and the next copies are issued while they run; the fragments
// of the next stage are split after the wait (split while the wgmmas ran,
// they came out wrong in some rows).  The epilogue stages the tile in
// shared memory and reads x0 and xl and writes out a warp-contiguous row
// segment at a time, 8 rows' loads in flight, rounded as the plain
// version rounds it.  100 KB of shared memory a block: two an SM, each
// one's copies and epilogue under the other's wgmmas.
//
// SIMT route (route 0), at small batch, where the tensor route's tiles
// leave SMs idle: shared-memory-tiled f32 FMA on the CUDA cores with a
// register micro-tile, no TF32.  Bound: 2 B d^2 flops at 67 TFLOP/s
// (1.44 ms at B = 262144; ~3 us at B = 512, where the launch sets the
// time).  A block owns a BM x BN tile of out and walks k in steps of BK:
// each step's xl and W tiles are loaded from global memory into registers
// (coalesced along k, masked to 0 past B, d and the depth), stored
// transposed into one of two shared buffers, and each thread accumulates
// a TM x TN micro-tile from float4 reads of the other buffer, one barrier
// per step.  Ragged rows, columns and depth are masked, nothing is
// padded.  Two tile shapes: 128 x 64 (8 x 4 per thread) where it launches
// at least two blocks per SM, else 32 x 32 (2 x 2 per thread), so that B
// = 512 at d = 429 still launches 16 x 14 = 224 blocks on the 132 SMs.

#include <cuda_runtime.h>
#include <cstdint>

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

// ---- tensor route: 3xTF32 wgmma ---------------------------------------------

constexpr int TC_BM = 64;              // rows a block: one warpgroup
constexpr int TC_BN = 144;             // columns a block (m64n144k8)
constexpr int TC_BK = 32;              // k a stage: a 128-byte swizzled row
constexpr int TC_THREADS = 128;
constexpr int TC_WARPS = TC_THREADS / 32;
constexpr int TC_ACC = TC_BN / 2;      // f32 accumulators a thread
constexpr int B_BYTES = TC_BN * 128;   // one of hi / lo, a stage
constexpr int A_STRIDE = TC_BK + 4;    // floats a raw A row: conflict-free
constexpr int A_SLOTS = 3;             // raw A stages: two in flight
constexpr int A_RAW_BYTES = TC_BM * A_STRIDE * 4;
constexpr int SPLIT_THREADS = 256;
// two B stages (hi, lo), three raw A stages, two mbarriers, room to align
// to 1024: 100 KB, two blocks an SM
constexpr int TC_SMEM = 2 * 2 * B_BYTES + A_SLOTS * A_RAW_BYTES + 16 + 1024;
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a wgmma operand descriptor: 128-byte swizzle, lbo and sbo in bytes
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from touching accumulator registers across the
// asynchronous wgmma: each read after the wait depends on this
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for A fragments in registers: the wgmma reads them until the
// wait, and the compiler must not reuse their registers before it
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// bytes (a multiple of 16) global -> shared by the bulk copy engine,
// completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 4 bytes global -> shared; zero-filled (nothing read) unless ok
__device__ __forceinline__ void cp_async4(void* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most one committed cp.async group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// d += A B, A [64 x 8] tf32 from registers (a warp's 16 rows: a[0] row
// g col t4, a[1] row g + 8 col t4, a[2] row g col t4 + 4, a[3] row g + 8
// col t4 + 4, with g = lane / 4, t4 = lane % 4), B [8 x 144] K-major in
// swizzled shared memory; d is overwritten where accumulate is 0.  The
// fragments are read-write operands: the wgmma reads their own registers
// until the wait (an input-only operand may be handed a copy, whose
// register the compiler reuses while the wgmma still reads it)
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[TC_ACC],
                                              uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k8.f32.tf32.tf32 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,"
      "%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71"
      "}, "
      "{%72,%73,%74,%75}, %76, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "l"(b), "r"(accumulate));
}

// v's hi and lo at (row, k) of a [rows x 32] tile, K-major, in the
// 128-byte swizzle: row r's 16-byte chunk c sits at chunk c ^ (r % 8)
__device__ __forceinline__ void put_split(unsigned char* hi, unsigned char* lo,
                                          int row, int k, float v) {
  const uint32_t h = tf32_rna(v);
  const uint32_t l = tf32_rna(__fsub_rn(v, __uint_as_float(h)));  // exact
  const int off = row * 128 + ((((k >> 2) ^ (row & 7)) << 4) | ((k & 3) << 2));
  *reinterpret_cast<uint32_t*>(hi + off) = h;
  *reinterpret_cast<uint32_t*>(lo + off) = l;
}

// W split once a call: block (tile, stage) writes W's columns [tile 144,
// + 144) x k [stage 32, + 32) as hi, then lo, each [144 x 32] tf32 in the
// 128-byte swizzle, zeros past d: the B operand of one stage of the main
// kernel, one contiguous 36 KB block of `split`
__global__ void __launch_bounds__(SPLIT_THREADS)
    cross_split_kernel(const float* __restrict__ W, int d,
                       unsigned char* __restrict__ split) {
  const int steps = (d + TC_BK - 1) / TC_BK;
  const int tile = blockIdx.x / steps;
  const int stage = blockIdx.x % steps;
  unsigned char* hi = split + (size_t)blockIdx.x * 2 * B_BYTES;
  for (int e = threadIdx.x; e < TC_BN * TC_BK; e += SPLIT_THREADS) {
    const int row = e / TC_BK;
    const int k = e % TC_BK;
    const int c = tile * TC_BN + row;
    const int kk = stage * TC_BK + k;
    put_split(hi, hi + B_BYTES, row, k,
              (c < d && kk < d) ? W[(size_t)c * d + kk] : 0.f);
  }
}

__global__ void __launch_bounds__(TC_THREADS, 2)
    cross_tc_kernel(const float* __restrict__ x0, const float* __restrict__ xl,
                    const unsigned char* __restrict__ split,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int B, int d) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  // B stage s % 2 (hi | lo), raw A stage s % 3, the B barriers
  unsigned char* Bs = base;
  float* Ar = reinterpret_cast<float*>(base + 2 * 2 * B_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      base + 2 * 2 * B_BYTES + A_SLOTS * A_RAW_BYTES);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int m0 = blockIdx.y * TC_BM;
  const int n0 = blockIdx.x * TC_BN;
  const int steps = (d + TC_BK - 1) / TC_BK;
  const unsigned char* Bsrc = split + (size_t)blockIdx.x * steps * 2 * B_BYTES;

  // B stage s: one bulk copy of its split block into buffer s % 2
  auto fetch_b = [&](int s) {
    mbar_expect_tx(&full[s & 1], 2 * B_BYTES);
    bulk_load(Bs + (s & 1) * 2 * B_BYTES, Bsrc + (size_t)s * 2 * B_BYTES,
              2 * B_BYTES, &full[s & 1]);
  };
  // A stage s's f32 tile into raw slot s % 3: thread (warp, lane) copies
  // k = lane of rows warp + 4 q, a warp one row's 128 bytes, zeros past
  // B, d and the depth.  One cp.async group a call, empty past the last
  // stage, so that every thread's groups stay in step.
  auto fetch_a = [&](int s) {
    if (s < steps) {
      float* slot = Ar + (s % A_SLOTS) * TC_BM * A_STRIDE;
      const int k = s * TC_BK + lane;
#pragma unroll
      for (int q = 0; q < TC_BM / TC_WARPS; ++q) {
        const int r = warp + TC_WARPS * q;
        const bool ok = k < d && m0 + r < B;
        cp_async4(slot + r * A_STRIDE + lane,
                  ok ? xl + (size_t)(m0 + r) * d + k : xl, ok);
      }
    }
    cp_async_commit();
  };

  // this thread's A fragments of stage s, split into hi and lo: a warp's
  // rows 16 warp + g (+ 8), columns 8 kk + t4 (+ 4)
  const int row = warp * 16 + g;
  auto frags = [&](int s, uint32_t (&ah)[TC_BK / 8][4],
                   uint32_t (&al)[TC_BK / 8][4]) {
    const float* slot = Ar + (s % A_SLOTS) * TC_BM * A_STRIDE;
#pragma unroll
    for (int kk = 0; kk < TC_BK / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = slot[(row + 8 * (e & 1)) * A_STRIDE + 8 * kk + t4 +
                             4 * (e >> 1)];
        ah[kk][e] = tf32_rna(v);
        al[kk][e] = tf32_rna(__fsub_rn(v, __uint_as_float(ah[kk][e])));
      }
  };

  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fetch_b(0);
  }
  fetch_a(0);
  fetch_a(1);
  cp_async_wait_one();
  __syncthreads();
  if (tid == 0 && steps > 1) fetch_b(1);
  fetch_a(2);
  uint32_t ah[TC_BK / 8][4], al[TC_BK / 8][4];
  frags(0, ah, al);
  float acc[TC_ACC], part[TC_ACC];
#pragma unroll
  for (int i = 0; i < TC_ACC; ++i) acc[i] = part[i] = 0.f;
  for (int s = 0; s < steps; ++s) {
    const unsigned char* bh = Bs + (s & 1) * 2 * B_BYTES;
    const unsigned char* bl = bh + B_BYTES;
    const int ks = min(TC_BK / 8, (d - s * TC_BK + 7) / 8);   // k-steps of 8
    mbar_wait(&full[s & 1], (s >> 1) & 1);
    fence_regs(ah);
    fence_regs(al);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 8; ++kk) {
      if (kk < ks) {
        wgmma_tf32_rs(part, al[kk], gmma_desc(bh + kk * 32, 16, 1024), kk > 0);
        wgmma_tf32_rs(part, ah[kk], gmma_desc(bl + kk * 32, 16, 1024), 1);
        wgmma_tf32_rs(part, ah[kk], gmma_desc(bh + kk * 32, 16, 1024), 1);
      }
    }
    wgmma_commit();
    // while they run: A stage s + 1 has landed (all but the newest group)
    // and is seen by all; every thread has issued stage s and finished
    // stage s - 1, so B buffer (s + 1) % 2 and raw slot s % 3 are free:
    // the copies of B stage s + 1 (if not in flight) and A stage s + 3 go
    // there.  Stage s + 1's fragments are split after the wait: split
    // while the wgmmas ran, they came out wrong in some rows of two
    // stages (the A registers are read until the wait).
    cp_async_wait_one();
    __syncthreads();
    if (tid == 0 && s >= 1 && s + 1 < steps) fetch_b(s + 1);
    fetch_a(s + 3);
    wgmma_wait_all();
    fence_regs(part);
    fence_regs(ah);
    fence_regs(al);
#pragma unroll
    for (int i = 0; i < TC_ACC; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    if (s + 1 < steps) frags(s + 1, ah, al);
  }
  __syncthreads();   // every wgmma is done: the B buffers are free

  // epilogue through shared memory: the tile, then rows read and written
  // a warp-contiguous 32 columns at a time, rounded as the plain version
  // rounds it: (acc + bias), times x0, plus xl.  acc[4 q + 2 i + x] is
  // row 16 warp + g + 8 i, column 8 q + 2 t4 + x
  constexpr int CT = TC_BN + 4;          // the tile's row stride, floats
  float* ct = reinterpret_cast<float*>(base);
#pragma unroll
  for (int q = 0; q < TC_BN / 8; ++q)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(&ct[(row + 8 * i) * CT + 8 * q + 2 * t4]) =
          make_float2(acc[4 * q + 2 * i], acc[4 * q + 2 * i + 1]);
  __syncthreads();
  // a warp's rows warp + 4 i, columns lane + 32 j: every load of a batch
  // of rows issued before its first use
  constexpr int CJ = (TC_BN + 31) / 32;
  constexpr int RB = 8;                  // rows a batch
#pragma unroll 1
  for (int i0 = 0; i0 < TC_BM / TC_WARPS; i0 += RB) {
    float vx[RB][CJ], vl[RB][CJ];
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int r = m0 + warp + TC_WARPS * (i0 + i);
        const int c = n0 + lane + 32 * j;
        const bool ok = r < B && c < d && lane + 32 * j < TC_BN;
        const size_t o = (size_t)r * d + c;
        vx[i][j] = ok ? x0[o] : 0.f;
        vl[i][j] = ok ? xl[o] : 0.f;
      }
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int rr = warp + TC_WARPS * (i0 + i);
        const int cc = lane + 32 * j;
        const int r = m0 + rr;
        const int c = n0 + cc;
        if (r < B && c < d && cc < TC_BN)
          out[(size_t)r * d + c] = __fadd_rn(
              __fmul_rn(vx[i][j], __fadd_rn(ct[rr * CT + cc], bias[c])),
              vl[i][j]);
      }
  }
}

int launch_tensor(const float* x0, const float* xl, const unsigned char* split,
                  const float* bias, float* out, int B, int d,
                  cudaStream_t stream) {
  const dim3 grid((d + TC_BN - 1) / TC_BN, (B + TC_BM - 1) / TC_BM);
  if (grid.y > MAX_GRID_Y || split == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      cross_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (e != cudaSuccess) return (int)e;
  cross_tc_kernel<<<grid, TC_THREADS, TC_SMEM, stream>>>(x0, xl, split, bias,
                                                         out, B, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cross_split_launch(const float* W, int d, unsigned char* split,
                                  cudaStream_t stream) {
  const int blocks = ((d + TC_BN - 1) / TC_BN) * ((d + TC_BK - 1) / TC_BK);
  cross_split_kernel<<<blocks, SPLIT_THREADS, 0, stream>>>(W, d, split);
  return (int)cudaGetLastError();
}

// route 1 (tensor) reads W as its split (cross_split_launch, same stream,
// before); route 0 (SIMT) reads W itself and ignores split
extern "C" int cross_launch(const float* x0, const float* xl, const float* W,
                            const float* bias, float* out, int B, int d,
                            int route, const unsigned char* split,
                            cudaStream_t stream) {
  if (route == 1)
    return launch_tensor(x0, xl, split, bias, out, B, d, stream);
  if (route != 0) return (int)cudaErrorInvalidValue;
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
