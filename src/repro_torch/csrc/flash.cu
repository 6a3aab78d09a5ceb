// Blocked GQA flash attention, causal or bidirectional, with an online
// softmax: the [Sq, Skv] score matrix never reaches device memory.
//
// Replaces: src/repro/kernels/flash/flash.py, flash_attention_pallas
//           (body _flash_kernel).
//
//   out[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / group, j] * Dh^-0.5)
//                  v[b, h / group, j]
//
// over the keys j < kv_len (and j <= q_offset + i when causal).  Where the
// Pallas kernel and the JAX package's chunked_attention part ways, this
// follows chunked_attention, which is what the LM path computes: kv_len
// bounds the keys (and the loop); a row with no valid key comes out 0 (the
// Pallas kernel's -1e30 fill would average v there); ragged Sq and Skv
// are masked here, nothing is padded.  Scores, the running max and sum
// and the accumulator are f32; q, k, v and out are f32 or bf16 (the
// output in q's type); Dh is 32, 64, 128 or 256.
//
// Bound on an H100 at the LM slice's shapes (Qwen3-4B, Hq 32, Hkv 8,
// Dh 128, bf16):
//   prefill, B 8, S 2048, causal: 2 B Hq S^2 Dh = 2.75e11 operations,
//     0.28 ms at 989 TFLOP/s bf16 on the tensor cores: operations-bound;
//   decode, B 8, Sq 1, at position ~2111 of a 4096-slot cache: the K/V
//     prefix is 69 MB, 20.7 us at 3.35 TB/s, against 4 rows x Dh 128 of
//     arithmetic a key: bytes-bound by ~100x.
//
// The rows of a (batch, kv head) are the rows of its q heads, so one K/V
// tile serves the whole GQA group (K/V read once per kv head and row
// tile, as the Pallas index map reads them).  Three variants:
//   * decode, bf16, at most 16 rows a (batch, kv head), Dh <= 128:
//     flash_split_kernel + flash_combine_kernel.  The bound is bytes, and
//     one block per (batch, kv head) streams too little at once to reach
//     it, so the keys [0, kend) are cut into splits (the wrapper picks
//     their number from kv_len and the SM count: 4 x 64 = 256 blocks, all
//     resident, at the slice's shape).  A warp streams its 16-key tiles,
//     bf16 as they are, through a private cp.async ring (two tiles in
//     flight ahead of the math); both products run on the tensor cores
//     (mma.sync, the rows as the 16 rows of the tile), so the arithmetic
//     stays far below the loads.  Each split writes its partial (m, l,
//     acc) to a workspace the wrapper allocates; the merge by log-sum-exp
//     is a second small kernel (two launches a call).
//   * prefill, bf16, more than 16 rows, Dh <= 128: flash_wgmma_kernel.
//     The bound is the tensor cores' rate, which only wgmma reaches and
//     only if the loads and the softmax stay off its path.  Warp-
//     specialised and persistent (one block a multiprocessor walks the
//     work items): a producer thread keeps a ring of K/V tiles of 128
//     keys in flight by TMA (128-byte swizzle, mbarriers), two consumer
//     warpgroups of 64 rows run S = Q K^T (wgmma, both operands in shared
//     memory) and O += P V (P from registers, rounded to bf16 as the
//     plain version rounds it; V MN-major by the transpose bit) and
//     overlap each tile's softmax with the previous tile's P V.  A work
//     item's 128 rows are P positions x GB q heads of one kv head, head-
//     major, one 3-D TMA box; only tiles crossing kend or the diagonal
//     are masked.
//   * everything else (f32, Dh 256): flash_kernel, 256 threads on the
//     CUDA cores in f32, S = Q K^T as a 16 x 16 grid of thread micro-
//     tiles, P through shared memory; 64 rows (RM 4), or 16 (RM 1) where
//     a (batch, kv head) has at most 16 rows.
// In every variant a block walks the keys only up to the last one any of
// its rows may see, so tiles wholly above the diagonal or past kv_len are
// never visited, and the online softmax is chunked_attention's: the
// masks, m_safe, corr on masked rows and the final max(l, 1e-30) (the
// prefill variant takes it in base 2, with exp's weights).

#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TX = 16;               // threads across a tile's keys
constexpr int TY = 16;               // thread rows
constexpr int kThreads = TX * TY;
constexpr int BN = 64;               // keys per tile
constexpr int CN = BN / TX;          // keys per thread

// 16-byte vector loads: 4 f32 or 8 bf16 values, widened to f32
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&v)[N]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  __device__ static float store(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[N]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
};

// rows [n_rows) of a [rows, DH] source into a shared tile of row stride
// `ld`, zero past n_rows
template <typename T, int DH>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int rows, int n_rows) {
  constexpr int N = Vec<T>::N;
  constexpr int kPerRow = DH / N;
  for (int e = threadIdx.x; e < rows * kPerRow; e += kThreads) {
    const int r = e / kPerRow;
    const int c = (e % kPerRow) * N;
    float v[N];
    if (r < n_rows) {
      Vec<T>::load(src + (size_t)r * DH + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) dst[r * ld + c + i] = v[i];
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = TX / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = TX / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DH, int RM>
constexpr size_t smem_bytes() {
  // Q [BM][DH+1], K [BN][DH+1], V [BN][DH], P [BM][BN]
  return sizeof(float) * ((size_t)TY * RM * (DH + 1) + (size_t)BN * (DH + 1) +
                          (size_t)BN * DH + (size_t)TY * RM * BN);
}

template <typename T, int DH, int RM>
__global__ void __launch_bounds__(kThreads, DH <= 128 ? 2 : 1)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Hq,
                 int Hkv, int Sq, int Skv, int q_offset, int kv_len,
                 int causal, float scale) {
  constexpr int BM = TY * RM;
  constexpr int CD = DH / TX;            // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // [BM][DH + 1]
  float* Ks = Qs + BM * (DH + 1);        // [BN][DH + 1]
  float* Vs = Ks + BN * (DH + 1);        // [BN][DH]
  float* Ps = Vs + BN * DH;              // [BM][BN]

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int rows = group * Sq;           // q rows of this (b, kv head)
  const int row0 = blockIdx.x * BM;
  const int n_rows = min(BM, rows - row0);

  // stage the block's q rows: row r is (head kvh * group + r % group,
  // position r / group); q is [B, Hq, Sq, DH]
  {
    constexpr int N = Vec<T>::N;
    constexpr int kPerRow = DH / N;
    for (int e = threadIdx.x; e < BM * kPerRow; e += kThreads) {
      const int r = e / kPerRow;
      const int c = (e % kPerRow) * N;
      float x[N];
      if (r < n_rows) {
        const int R = row0 + r;
        const size_t src =
            (((size_t)b * Hq + kvh * group + R % group) * Sq + R / group) *
                DH + c;
        Vec<T>::load(q + src, x);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) x[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) Qs[r * (DH + 1) + c + i] = x[i];
    }
  }

  // the keys any row of the block may see: [0, kend)
  const int kv_lim = min(kv_len, Skv);
  int kend = kv_lim;
  if (causal) kend = min(kend, q_offset + (row0 + n_rows - 1) / group + 1);
  const int n_tiles = kend > 0 ? (kend + BN - 1) / BN : 0;

  bool row_ok[RM];
  int qpos[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + TY * i;
    row_ok[i] = r < n_rows;
    qpos[i] = q_offset + (row0 + r) / group;
  }

  float m[RM], l[RM], acc[RM][CD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;
  }

  const size_t kv_base = ((size_t)b * Hkv + kvh) * (size_t)Skv * DH;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    const int valid = min(BN, kend - k0);
    __syncthreads();                     // the last tile's P V is done
    stage<T, DH>(Ks, DH + 1, k + kv_base + (size_t)k0 * DH, BN, valid);
    stage<T, DH>(Vs, DH, v + kv_base + (size_t)k0 * DH, BN, valid);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float a[RM], kk[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = Qs[(ty + TY * i) * (DH + 1) + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kk[j] = Ks[(tx + TX * j) * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

    // mask, then the online softmax as chunked_attention takes it
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      bool ok[CN];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = k0 + tx + TX * j;
        ok[j] = row_ok[i] && kpos < kend && (!causal || kpos <= qpos[i]);
        s[i][j] = ok[j] ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float m_safe = isinf(m_new) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_safe) : 0.f;
        sum += p;
        Ps[(ty + TY * i) * BN + tx + TX * j] = p;
      }
      const float corr = isinf(m[i]) ? 0.f : expf(m[i] - m_safe);
      l[i] = corr * l[i] + half_warp_sum(sum);
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

    const int n_keys = min(BN, valid);
    for (int kk = 0; kk < n_keys; ++kk) {
      float p[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = Ps[(ty + TY * i) * BN + kk];
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        const float x = Vs[kk * DH + tx + TX * j];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (!row_ok[i]) continue;
    const int R = row0 + ty + TY * i;
    T* dst = out + (((size_t)b * Hq + kvh * group + R % group) * Sq +
                    R / group) * DH;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < CD; ++j)
      dst[tx + TX * j] = Vec<T>::store(acc[i][j] * inv);
  }
}


// ---- split-KV decode: bf16, at most 16 rows a (batch, kv head) ------------
//
// Block (split s, kv head, batch) of SW warps: the keys [s * split,
// (s + 1) * split) of [0, kend), in tiles of SKT = 16 keys dealt to the
// warps in turn.  Each warp streams its tiles, bf16 as they are, through
// a private ring of SST stages in shared memory by cp.async (SST - 1
// tiles of K and V in flight ahead of the math) and runs both products on
// the tensor cores with the rows of the (batch, kv head) as the 16 rows
// of mma.sync m16n8k16 (f32 accumulate): q's fragments stay in registers,
// K's and V's come from ldmatrix (V's transposed), P goes from the S
// accumulators into P V's A fragments, rounded to bf16 as the plain
// version rounds it.  Rows past group x Sq are zero and masked.  The
// block merges its warps' (m, l, O) and writes the split's partial to the
// workspace; flash_combine_kernel merges the splits.

constexpr int SW = 4;                  // warps a split block
constexpr int SST = 3;                 // stages of a warp's K/V ring
constexpr int SKT = 16;                // keys a stage
constexpr int SPLIT_ALIGN = 16;        // a split's keys: a multiple of this

template <int DH>
struct DShape {
  static constexpr int LD = DH + 8;              // padded row, bf16
  static constexpr int STAGE = 2 * SKT * LD;     // K, then V
  static constexpr size_t RING = sizeof(__nv_bfloat16) * SW * SST * STAGE;
  static constexpr size_t MERGE = sizeof(float) * SW * 16 * (DH + 2);
  static constexpr size_t SMEM = RING > MERGE ? RING : MERGE;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) unless ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b, a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DH>
__global__ void __launch_bounds__(SW * 32, 2)
    flash_split_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       float* __restrict__ ws, int Hq, int Hkv, int Sq,
                       int Skv, int q_offset, int kv_len, int causal,
                       float scale, int split) {
  using D = DShape<DH>;
  constexpr int LD = D::LD;
  constexpr int KS = DH / 16;            // k-steps of Q K^T
  constexpr int DT = DH / 8;             // 8-wide column tiles of O
  constexpr int CH = DH / 8;             // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int split_id = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int rows = group * Sq;           // <= 16
  const int g = lane / 4;
  const int c4 = lane % 4;
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(smem_raw) + warp * SST * D::STAGE;

  int kend = min(kv_len, Skv);
  if (causal) kend = min(kend, q_offset + (rows - 1) / group + 1);
  const int k_lo = split_id * split;
  const int k_hi = min(kend, k_lo + split);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + SKT - 1) / SKT : 0;
  const int n_it = n_tiles > warp ? (n_tiles - warp + SW - 1) / SW : 0;

  // row r is position r / group of q head kvh * group + r % group; this
  // lane's rows are g and g + 8; q's A fragments straight from memory
  bool row_ok[2];
  int qpos[2];
  uint32_t qa[KS][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    row_ok[i] = r < rows;
    qpos[i] = q_offset + r / group;
    const __nv_bfloat16* src =
        q + (((size_t)b * Hq + kvh * group + r % group) * Sq + r / group) * DH;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        qa[ks][i + 2 * h] =
            row_ok[i] ? *reinterpret_cast<const uint32_t*>(
                            src + ks * 16 + 2 * c4 + 8 * h)
                      : 0u;
  }

  // this warp's it-th tile: keys k_lo + (warp + it SW) SKT + [0, SKT)
  const size_t kv_base = ((size_t)b * Hkv + kvh) * (size_t)Skv * DH;
  auto issue = [&](int it) {
    __nv_bfloat16* Kt = ring + (it % SST) * D::STAGE;
    __nv_bfloat16* Vt = Kt + SKT * LD;
    const int key0 = k_lo + (warp + it * SW) * SKT;
#pragma unroll
    for (int e = lane; e < SKT * CH; e += 32) {
      const int r = e / CH;
      const int c = (e % CH) * 8;
      const bool ok = it < n_it && key0 + r < k_hi;
      const size_t off = ok ? kv_base + (size_t)(key0 + r) * DH + c : 0;
      cp_async16(Kt + r * LD + c, k + off, ok);
      cp_async16(Vt + r * LD + c, v + off, ok);
    }
    cp_async_commit();
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[j][x] = 0.f;

#pragma unroll
  for (int it = 0; it < SST - 1; ++it) issue(it);
  for (int it = 0; it < n_it; ++it) {
    issue(it + SST - 1);                 // into the stage read last step
    cp_async_wait<SST - 1>();            // tile it has landed
    __syncwarp();
    const __nv_bfloat16* Kt = ring + (it % SST) * D::STAGE;
    const __nv_bfloat16* Vt = Kt + SKT * LD;
    const int key0 = k_lo + (warp + it * SW) * SKT;

    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[n][x] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t bk[4];
      ldsm_x4(bk, Kt + (lane % 8 + (lane / 16) * 8) * LD + ks * 16 +
                      ((lane / 8) % 2) * 8);
      mma_bf16(s[0], qa[ks], bk[0], bk[1]);
      mma_bf16(s[1], qa[ks], bk[2], bk[3]);
    }

    // mask, then the online softmax as chunked_attention takes it; a
    // row's 16 values sit in the 4 lanes of a quad: s[n][2 i + x] is row
    // g + 8 i, key key0 + 8 n + 2 c4 + x
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int kpos = key0 + 8 * n + 2 * c4 + x;
          const bool ok =
              row_ok[i] && kpos < k_hi && (!causal || kpos <= qpos[i]);
          float& e = s[n][2 * i + x];
          e = ok ? e * scale : -INFINITY;
          mx = fmaxf(mx, e);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = isinf(m_new) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float& e = s[n][2 * i + x];
          e = expf(e - m_safe);          // masked: exp(-inf) = 0
          sum += e;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = isinf(m[i]) ? 0.f : expf(m[i] - m_safe);
      l[i] = corr * l[i] + sum;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[j][2 * i] *= corr;
        o[j][2 * i + 1] *= corr;
      }
      m[i] = m_new;
    }

    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int j = 0; j < DT / 2; ++j) {
      uint32_t bv[4];
      ldsm_x4_trans(bv, Vt + (lane % 8 + ((lane / 8) % 2) * 8) * LD +
                            j * 16 + (lane / 16) * 8);
      mma_bf16(o[2 * j], pa, bv[0], bv[1]);
      mma_bf16(o[2 * j + 1], pa, bv[2], bv[3]);
    }
    __syncwarp();                        // the stage is read: reusable
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the warps in the ring's place: the split's partial (m, l,
  // acc[Dh]) per row, at ws[b][kvh][split][row][Dh + 2]
  float* sm_m = reinterpret_cast<float*>(smem_raw);     // [SW][16]
  float* sm_l = sm_m + SW * 16;                         // [SW][16]
  float* sm_acc = sm_l + SW * 16;                       // [SW][16][DH]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    if (c4 == 0) {
      sm_m[warp * 16 + r] = m[i];
      sm_l[warp * 16 + r] = l[i];
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      sm_acc[(warp * 16 + r) * DH + j * 8 + 2 * c4] = o[j][2 * i];
      sm_acc[(warp * 16 + r) * DH + j * 8 + 2 * c4 + 1] = o[j][2 * i + 1];
    }
  }
  __syncthreads();
  float* dst = ws + (((size_t)b * Hkv + kvh) * gridDim.x + split_id) *
                        (size_t)rows * (DH + 2);
  for (int t = threadIdx.x; t < rows * DH; t += SW * 32) {
    const int r = t / DH;
    const int c = t % DH;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < SW; ++w) M = fmaxf(M, sm_m[w * 16 + r]);
    float L = 0.f, A = 0.f;
    if (!isinf(M)) {
#pragma unroll
      for (int w = 0; w < SW; ++w) {
        const float m_w = sm_m[w * 16 + r];
        if (isinf(m_w)) continue;
        const float wt = expf(m_w - M);
        L = fmaf(wt, sm_l[w * 16 + r], L);
        A = fmaf(wt, sm_acc[(w * 16 + r) * DH + c], A);
      }
    }
    dst[r * (DH + 2) + 2 + c] = A;
    if (c == 0) {
      dst[r * (DH + 2)] = M;
      dst[r * (DH + 2) + 1] = L;
    }
  }
}

// merge the splits of one row by log-sum-exp: splits with m = -inf weigh
// 0, a row with no valid key anywhere comes out 0
template <int DH>
__global__ void __launch_bounds__(DH)
    flash_combine_kernel(const float* __restrict__ ws,
                         __nv_bfloat16* __restrict__ out, int Hq, int Hkv,
                         int Sq, int n_splits) {
  const int r = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int rows = group * Sq;
  const size_t stride = (size_t)rows * (DH + 2);   // split to split
  const float* src =
      ws + (((size_t)b * Hkv + kvh) * n_splits * rows + r) * (DH + 2);
  float M = -INFINITY;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, src[s * stride]);
  const int c = threadIdx.x;
  float L = 0.f, A = 0.f;
  if (!isinf(M)) {
    for (int s = 0; s < n_splits; ++s) {
      const float m_s = src[s * stride];
      if (isinf(m_s)) continue;
      const float wt = expf(m_s - M);
      L = fmaf(wt, src[s * stride + 1], L);
      A = fmaf(wt, src[s * stride + 2 + c], A);
    }
  }
  out[(((size_t)b * Hq + kvh * group + r % group) * Sq + r / group) * DH +
      c] = __float2bfloat16(A / fmaxf(L, 1e-30f));
}

// ---- prefill: warp-specialised wgmma + TMA, bf16, more than 16 rows --------
//
// 384 threads: warpgroups 0 and 1 consume (64 rows each), one thread of
// warpgroup 2 produces; setmaxnreg moves registers from the producer
// warpgroup (24 each) to the consumers (240 each).  Shared memory,
// 1024-byte aligned for the 128-byte swizzle: Q [NP panels][128 rows][64
// columns], then WST stages of K and of V, each [NP][WN keys][64
// columns], then the mbarriers.  A panel row is 128 bytes, so every
// operand is the canonical SW128 layout: K-major for Q and K (rows 128
// bytes apart, 8-row groups 1024 apart, a k-step of 16 columns 32 bytes
// on), MN-major for V (8-key groups 1024 bytes apart, panels WN * 128
// apart).  At Dh 128: 32 KB of Q and 3 stages of 64 KB.  Dh 32 loads a
// 64-column panel whose upper half TMA fills with zeros.

constexpr int WM = 128;                // rows a work item
constexpr int WN = 128;                // keys a K/V tile
constexpr int WST = 3;                 // K/V stages in flight
constexpr int PANEL = 64;              // bf16 columns of a swizzled row
constexpr int W_THREADS = 384;

template <int DH>
struct WShape {
  static constexpr int NP = (DH + PANEL - 1) / PANEL;   // column panels
  static constexpr int ON = NP * PANEL;                 // O's columns
  static constexpr int Q_BYTES = NP * WM * 128;
  static constexpr int KV_BYTES = NP * WN * 128;        // K or V, a stage
  static constexpr size_t SMEM =
      1024 + Q_BYTES + 2 * WST * KV_BYTES + 8 * (2 * WST + 2);
};

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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
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

// a 3-D box of the tensor map at (c0, c1, c2) into shared memory,
// completing on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// 2^x, flushing subnormal results to 0 (weights below 2^-126 of the max)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// until at most N committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from touching accumulator registers across the
// asynchronous wgmma: each read after the wait depends on this
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B, A [64 x 16] and B [16 x 128] both K-major in swizzled
// shared memory (descriptors a, b); d is the m64n128 f32 accumulator
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,"
      "%56,%57,%58,%59,%60,%61,%62,%63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, A [64 x 16] bf16 from registers (the accumulator layout
// packed), B [16 x 64] MN-major in swizzled shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31"
      "}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B, A [64 x 16] bf16 from registers (the accumulator layout
// packed), B [16 x 128] MN-major in swizzled shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,"
      "%56,%57,%58,%59,%60,%61,%62,%63"
      "}, "
      "{%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += P V at O's width: n64 for Dh <= 64, n128 for Dh 128
template <int ON>
__device__ __forceinline__ void wgmma_pv(float (&o)[ON / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (ON == 64)
    wgmma_rs_n64(o, a, b);
  else
    wgmma_rs_n128(o, a, b);
}

// issue (and commit, not wait for) S = Q K^T of one tile, [64 rows x WN
// keys] a warpgroup
template <int NP>
__device__ __forceinline__ void issue_qk(float (&s)[WN / 2],
                                         const unsigned char* Qw,
                                         const unsigned char* Kt) {
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int kk = 0; kk < PANEL / 16; ++kk)
      wgmma_ss_n128(s, gmma_desc(Qw + p * WM * 128 + kk * 32, 16, 1024),
                   gmma_desc(Kt + p * WN * 128 + kk * 32, 16, 1024),
                   p + kk > 0);
  wgmma_commit();
}

// A work item is the rows of one (batch, kv head, head tile, position
// tile): GB q heads of the group at P positions, 128 rows, row r being q
// head h0 + r / P at position p0 + r % P, as the Q box lays it out.
// Items are numbered (batch, kv head)-major, position tiles longest
// first within, so the blocks at work at once share one or two heads'
// K/V in L2.
struct WItem {
  int b, kvh, h0, p0, kend, n_tiles;
};

__device__ __forceinline__ WItem witem(int i, int Hkv, int Sq, int q_offset,
                                       int kv_lim, int causal, int P, int GB,
                                       int n_pos, int n_head) {
  WItem it;
  const int per = n_pos * n_head;
  const int grp = i / per;
  const int j = i % per;
  it.b = grp / Hkv;
  it.kvh = grp % Hkv;
  it.h0 = (j / n_pos) * GB;
  it.p0 = (n_pos - 1 - j % n_pos) * P;
  // the keys any row of the item may see: [0, kend)
  it.kend = kv_lim;
  if (causal) it.kend = min(it.kend, q_offset + min(it.p0 + P, Sq));
  it.n_tiles = it.kend > 0 ? (it.kend + WN - 1) / WN : 0;
  return it;
}

// Persistent: one block a multiprocessor takes items blockIdx.x,
// blockIdx.x + gridDim.x, ...; the producer loads an item's Q as soon as
// the consumers have issued its predecessor's last S, and the K/V ring
// runs on across items, so one item's loads overlap the last one's tail.
//
// A consumer warpgroup pipelines its tiles as FlashAttention-3 does: S of
// tile t is issued before P V of tile t - 1, and tile t's softmax runs on
// the CUDA cores while that P V runs on the tensor cores.  (FA3's ping-
// pong, the two warpgroups taking turns to issue at named barriers,
// measured no faster here and is left out.)  Only the tiles that cross
// kend or the diagonal are masked.
template <int DH>
__global__ void __launch_bounds__(W_THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ out, int Hq, int Hkv,
                       int Sq, int q_offset, int kv_lim, int causal,
                       float scale, int P, int GB, int n_pos, int n_head,
                       int n_items) {
  using W = WShape<DH>;
  constexpr int NP = W::NP, ON = W::ON;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* Qs = base;
  unsigned char* Ks = Qs + W::Q_BYTES;
  unsigned char* Vs = Ks + WST * W::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + WST * W::KV_BYTES);
  uint64_t* empty = full + WST;
  uint64_t* qbar = empty + WST;        // Q has landed
  uint64_t* qfree = qbar + 1;          // Q is no longer read
  const int group = Hq / Hkv;
  auto item = [&](int i) {
    return witem(i, Hkv, Sq, q_offset, kv_lim, causal, P, GB, n_pos, n_head);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < WST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2 * 128);
    }
    mbar_init(qbar, 1);
    mbar_init(qfree, 2 * 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: each item's Q, then its K/V tiles into the ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int nq = 0, g = 0;               // items with keys, tiles, so far
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const WItem it = item(i);
        if (it.n_tiles == 0) continue;
        if (nq > 0) mbar_wait(qfree, (nq - 1) & 1);
        mbar_expect_tx(qbar, NP * 128 * P * GB);
        for (int p = 0; p < NP; ++p)
          tma_load_3d(Qs + p * WM * 128, &qmap, qbar, p * PANEL, it.p0,
                      it.b * Hq + it.kvh * group + it.h0);
        for (int t = 0; t < it.n_tiles; ++t, ++g) {
          const int st = g % WST;
          if (g >= WST) mbar_wait(&empty[st], (g / WST - 1) & 1);
          mbar_expect_tx(&full[st], 2 * W::KV_BYTES);
          for (int p = 0; p < NP; ++p) {
            tma_load_3d(Ks + st * W::KV_BYTES + p * WN * 128, &kmap,
                        &full[st], p * PANEL, t * WN, it.b * Hkv + it.kvh);
            tma_load_3d(Vs + st * W::KV_BYTES + p * WN * 128, &vmap,
                        &full[st], p * PANEL, t * WN, it.b * Hkv + it.kvh);
          }
        }
        ++nq;
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c4 = lane % 4;
  const int rl[2] = {wg * 64 + warp * 16 + g, wg * 64 + warp * 16 + g + 8};
  const unsigned char* Qw = Qs + wg * 64 * 128;
  const float scale2 = scale * 1.4426950408889634f;   // Dh^-0.5 log2(e)

  bool row_ok[2];
  int qpos[2];
  float m[2], l[2], corr[2];
  float o[ON / 2];
  float s[WN / 2];
  uint32_t pa[WN / 16][4];

  // mask (tiles crossing kend or the diagonal), then the online softmax
  // of tile t as chunked_attention takes it, in base 2: m holds the
  // scores' max times Dh^-0.5 log2(e), and exp2(fma(score, scale2, -m))
  // is exp's weight; s becomes P (f32), corr the rows' correction of O.
  // A row's values sit in the 4 lanes of a quad: s[4 j + 2 i + x] is row
  // g + 8 i, key 8 j + 2 c4 + x
  auto softmax = [&](const WItem& it, int t) {
    const int k0 = t * WN;
    const bool edge = k0 + WN > it.kend ||
                      (causal && k0 + WN - 1 > q_offset + it.p0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float& e = s[4 * j + 2 * i + x];
          if (edge) {
            const int kpos = k0 + j * 8 + 2 * c4 + x;
            const bool ok = row_ok[i] && kpos < it.kend &&
                            (!causal || kpos <= qpos[i]);
            e = ok ? e : -INFINITY;
          }
          mx = fmaxf(mx, e);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx * scale2);
      const float m_safe = isinf(m_new) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float& e = s[4 * j + 2 * i + x];
          e = ex2(fmaf(e, scale2, -m_safe));     // masked: ex2(-inf) = 0
          sum += e;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      corr[i] = isinf(m[i]) ? 0.f : ex2(m[i] - m_safe);
      l[i] = corr[i] * l[i] + sum;
      m[i] = m_new;
    }
  };
  // P rounded to bf16 into the A registers of P V, 16 keys a step
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < WN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  // O = corr O, then issue (and commit) O += P V from ring stage st
  auto issue_pv = [&](int st) {
    if (corr[0] != 1.f || corr[1] != 1.f) {   // the max moved
#pragma unroll
      for (int j = 0; j < ON / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * j + 2 * i] *= corr[i];
          o[4 * j + 2 * i + 1] *= corr[i];
        }
    }
    const unsigned char* Vt = Vs + st * W::KV_BYTES;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WN / 16; ++kk)
      wgmma_pv<ON>(o, pa[kk], gmma_desc(Vt + kk * 16 * 128, WN * 128, 1024));
    wgmma_commit();
  };

  int nq = 0, g0 = 0;                  // items with keys, tiles, so far
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const WItem it = item(i);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = rl[x];
      const int pos = it.p0 + r % P;
      row_ok[x] = r < P * GB && it.h0 + r / P < group && pos < Sq;
      qpos[x] = q_offset + pos;
      m[x] = -INFINITY;
      l[x] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < ON / 2; ++j) o[j] = 0.f;

    const int n = it.n_tiles;
    if (n > 0) {
      mbar_wait(qbar, nq & 1);
      mbar_wait(&full[g0 % WST], (g0 / WST) & 1);
      issue_qk<NP>(s, Qw, Ks + (g0 % WST) * W::KV_BYTES);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(it, 0);
      pack();
      // tile t's S runs on the tensor cores beside O's rescale, then tile
      // t - 1's P V runs beside tile t's softmax
      for (int t = 1; t < n; ++t) {
        const int st = (g0 + t) % WST;
        mbar_wait(&full[st], ((g0 + t) / WST) & 1);
        issue_qk<NP>(s, Qw, Ks + st * W::KV_BYTES);
        issue_pv((g0 + t - 1) % WST);
        wgmma_wait<1>();                 // S of tile t
        fence_regs(s);
        softmax(it, t);
        wgmma_wait<0>();                 // P V of tile t - 1
        fence_regs(o);
        mbar_arrive(&empty[(g0 + t - 1) % WST]);
        pack();
      }
      mbar_arrive(qfree);                // every S of the item is done
      issue_pv((g0 + n - 1) % WST);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&empty[(g0 + n - 1) % WST]);
      g0 += n;
      ++nq;
    }

#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (!row_ok[x]) continue;
      const int r = rl[x];
      __nv_bfloat16* dst =
          out + (((size_t)it.b * Hq + it.kvh * group + it.h0 + r / P) * Sq +
                 it.p0 + r % P) * DH;
      const float inv = 1.f / fmaxf(l[x], 1e-30f);
#pragma unroll
      for (int j = 0; j < ON / 8; ++j) {
        const int c = j * 8 + 2 * c4;
        if (c < DH)
          *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(
              o[4 * j + 2 * x] * inv, o[4 * j + 2 * x + 1] * inv);
      }
    }
  }
}

// ---- host: tensor maps and launchers ---------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime's
// entry-point query, so the library does not link libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [d2][d1][Dh] bf16 tensor whose dim-2 rows are `rows2` dim-1 rows apart
// (d1 <= rows2: rows past d1 read as zeros), boxes of (64, b1, b2),
// 128-byte swizzle
bool bf16_map(CUtensorMap* map, const void* ptr, int Dh, int d1, int rows2,
              int d2, int b1, int b2) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)Dh, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)Dh * 2,
                                 (cuuint64_t)rows2 * Dh * 2};
  const cuuint32_t box[3] = {(cuuint32_t)PANEL, (cuuint32_t)b1,
                             (cuuint32_t)b2};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int Hq, int Hkv, int Sq, int Skv, int q_offset,
                 int kv_len, int causal, float scale, cudaStream_t stream) {
  constexpr size_t bytes = WShape<DH>::SMEM;
  auto kernel = flash_wgmma_kernel<DH>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int group = Hq / Hkv;
  const int GB = group < WM ? group : WM;   // q heads an item
  const int P = WM / GB;                    // positions an item
  const int n_pos = (Sq + P - 1) / P;
  const int n_head = (group + GB - 1) / GB;
  const int n_items = B * Hkv * n_head * n_pos;
  const int kv_lim = kv_len < Skv ? kv_len : Skv;
  // keys past kv_lim read as zeros; they are masked all the same
  CUtensorMap qmap, kmap, vmap;
  if (!bf16_map(&qmap, q, DH, Sq, Sq, B * Hq, P, GB) ||
      !bf16_map(&kmap, k, DH, kv_lim > 0 ? kv_lim : 1, Skv, B * Hkv, WN, 1) ||
      !bf16_map(&vmap, v, DH, kv_lim > 0 ? kv_lim : 1, Skv, B * Hkv, WN, 1))
    return (int)cudaErrorInvalidValue;
  int device = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int grid = n_items < n_sm ? n_items : n_sm;   // persistent
  kernel<<<grid, W_THREADS, bytes, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), Hq, Hkv, Sq,
      q_offset, kv_lim, causal, scale, P, GB, n_pos, n_head, n_items);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_split(const void* q, const void* k, const void* v, void* out,
                 void* ws, size_t ws_bytes, int B, int Hq, int Hkv, int Sq,
                 int Skv, int q_offset, int kv_len, int causal,
                 int n_splits, float scale, cudaStream_t stream) {
  constexpr size_t bytes = DShape<DH>::SMEM;
  auto kernel = flash_split_kernel<DH>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int rows = (Hq / Hkv) * Sq;
  if (n_splits < 1 ||
      ws_bytes < sizeof(float) * (size_t)B * Hkv * n_splits * rows * (DH + 2))
    return (int)cudaErrorInvalidValue;
  // keys a split: kv_len over n_splits, rounded up to SPLIT_ALIGN
  const int kv_lim = kv_len < Skv ? kv_len : Skv;
  int split = (kv_lim + n_splits - 1) / n_splits;
  split = ((split + SPLIT_ALIGN - 1) / SPLIT_ALIGN) * SPLIT_ALIGN;
  if (split == 0) split = SPLIT_ALIGN;
  float* w = static_cast<float*>(ws);
  kernel<<<dim3(n_splits, Hkv, B), SW * 32, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), w, Hq, Hkv, Sq, Skv, q_offset,
      kv_len, causal, scale, split);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_combine_kernel<DH><<<dim3(rows, Hkv, B), DH, 0, stream>>>(
      w, static_cast<__nv_bfloat16*>(out), Hq, Hkv, Sq, n_splits);
  return (int)cudaGetLastError();
}

template <typename T, int DH, int RM>
int launch_tiles(const void* q, const void* k, const void* v, void* out,
                 int B, int Hq, int Hkv, int Sq, int Skv, int q_offset,
                 int kv_len, int causal, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DH, RM>();
  auto kernel = flash_kernel<T, DH, RM>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int rows = (Hq / Hkv) * Sq;
  const dim3 grid((rows + TY * RM - 1) / (TY * RM), Hkv, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Sq, Skv,
      q_offset, kv_len, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_rows(const void* q, const void* k, const void* v, void* out,
                void* ws, size_t ws_bytes, int B, int Hq, int Hkv, int Sq,
                int Skv, int q_offset, int kv_len, int causal, int n_splits,
                float scale, cudaStream_t stream) {
  const int rows = (Hq / Hkv) * Sq;
  if constexpr (std::is_same<T, __nv_bfloat16>::value && DH <= 128) {
    if (rows <= 16)
      return launch_split<DH>(q, k, v, out, ws, ws_bytes, B, Hq, Hkv, Sq,
                              Skv, q_offset, kv_len, causal, n_splits, scale,
                              stream);
    return launch_wgmma<DH>(q, k, v, out, B, Hq, Hkv, Sq, Skv, q_offset,
                            kv_len, causal, scale, stream);
  } else {
    if (rows <= TY)                    // one 16-row SIMT tile
      return launch_tiles<T, DH, 1>(q, k, v, out, B, Hq, Hkv, Sq, Skv,
                                    q_offset, kv_len, causal, scale, stream);
    return launch_tiles<T, DH, 4>(q, k, v, out, B, Hq, Hkv, Sq, Skv,
                                  q_offset, kv_len, causal, scale, stream);
  }
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, void* out,
                 void* ws, size_t ws_bytes, int B, int Hq, int Hkv, int Sq,
                 int Skv, int Dh, int q_offset, int kv_len, int causal,
                 int n_splits, float scale, cudaStream_t stream) {
  switch (Dh) {
    case 32:
      return launch_rows<T, 32>(q, k, v, out, ws, ws_bytes, B, Hq, Hkv, Sq,
                                Skv, q_offset, kv_len, causal, n_splits,
                                scale, stream);
    case 64:
      return launch_rows<T, 64>(q, k, v, out, ws, ws_bytes, B, Hq, Hkv, Sq,
                                Skv, q_offset, kv_len, causal, n_splits,
                                scale, stream);
    case 128:
      return launch_rows<T, 128>(q, k, v, out, ws, ws_bytes, B, Hq, Hkv, Sq,
                                 Skv, q_offset, kv_len, causal, n_splits,
                                 scale, stream);
    case 256:
      return launch_rows<T, 256>(q, k, v, out, ws, ws_bytes, B, Hq, Hkv, Sq,
                                 Skv, q_offset, kv_len, causal, n_splits,
                                 scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Hq, Sq, Dh], k and v [B, Hkv, Skv, Dh], out like q; all contiguous,
// of one type (bf16 when is_bf16, else f32); Hq a multiple of Hkv; scale
// is Dh^-0.5 rounded to f32 by the caller, as the plain version rounds it;
// kv_len <= Skv.  The split-KV decode variant (bf16, group x Sq <= 16,
// Dh <= 128) cuts the keys into n_splits and needs a workspace of
// 4 B Hkv n_splits group Sq (Dh + 2) bytes at ws (ws_bytes its size) for
// the splits' partials; the other variants take neither.
extern "C" int flash_launch(const void* q, const void* k, const void* v,
                            void* out, void* ws, size_t ws_bytes, int B,
                            int Hq, int Hkv, int Sq, int Skv, int Dh,
                            int q_offset, int kv_len, int causal,
                            int is_bf16, int n_splits, float scale,
                            cudaStream_t stream) {
  if (is_bf16)
    return launch_dtype<__nv_bfloat16>(q, k, v, out, ws, ws_bytes, B, Hq,
                                       Hkv, Sq, Skv, Dh, q_offset, kv_len,
                                       causal, n_splits, scale, stream);
  return launch_dtype<float>(q, k, v, out, ws, ws_bytes, B, Hq, Hkv, Sq,
                             Skv, Dh, q_offset, kv_len, causal, n_splits,
                             scale, stream);
}
