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
//     0.28 ms at 989 TFLOP/s bf16 on the tensor cores (4.1 ms at 67
//     TFLOP/s f32 outside them);
//   decode, B 8, Sq 1, at position ~2111 of a 4096-slot cache: the K/V
//     prefix is 69 MB, 20.7 us at 3.35 TB/s.
//
// Design: simple and right first.  A block owns the rows of one (batch,
// kv head): the q heads of that kv head are folded into the rows (row r
// is position r / group of q head kvh * group + r % group), so each K/V
// tile staged in shared memory serves the whole group (the GQA sharing
// of the Pallas index map: K/V read once per kv head, not once per q
// head).  It walks the key tiles of 64 up to the last key that any of its
// rows may see, so tiles wholly above the diagonal and past kv_len are
// never visited.  Two variants:
//   * bf16 with more than 16 rows a (batch, kv head) and Dh <= 128 (the
//     prefill): flash_mma_kernel, 4 warps x 16 rows, both products on
//     the tensor cores (mma.sync m16n8k16, f32 accumulate), K/V double-
//     buffered by cp.async, P rounded to bf16 for P V as the plain
//     version rounds it;
//   * everything else (f32, decode, Dh 256): flash_kernel, 256 threads
//     on the CUDA cores in f32, S = Q K^T as a 16 x 16 grid of thread
//     micro-tiles (RM rows x 4 keys each), the row max and sum by half-
//     warp shuffles, P through shared memory, acc += P V with the same
//     rows per thread; 64 rows (RM 4), or 16 (RM 1) where a (batch, kv
//     head) has at most 16 rows (decode: group x 1).
// No wgmma, no TMA, no split-KV: decode launches one block per (batch, kv
// head), 64 blocks at the slice's shape, and is held to the bytes bound.

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

// ---- tensor-core variant: bf16, more than 16 rows a (batch, kv head) ------
//
// The same rows, masks and online softmax, with both products on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate).  A block of
// 4 warps owns 64 rows (16 a warp); Q's fragments stay in registers, K
// and V tiles of 64 keys are double-buffered in shared memory by
// cp.async (keys past kend are zero-filled), fragments come from
// ldmatrix (V's transposed), and P goes from the S accumulators straight
// into the A fragments of P V, rounded to bf16 as the plain version
// rounds it.

constexpr int MW = 4;                  // warps a block
constexpr int MBM = 16 * MW;           // rows a block
constexpr int MBN = 64;                // keys a tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) unless ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
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
constexpr size_t mma_smem_bytes() {
  // Q [MBM][DH+8], K and V [2][MBN][DH+8], bf16; the 8-element pad puts
  // the 8 rows an ldmatrix reads in distinct banks
  return sizeof(__nv_bfloat16) * (size_t)(MBM + 4 * MBN) * (DH + 8);
}

template <int DH>
__global__ void __launch_bounds__(MW * 32)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int Sq,
                     int Skv, int q_offset, int kv_len, int causal,
                     float scale) {
  constexpr int LD = DH + 8;
  constexpr int KS = DH / 16;            // k-steps of Q K^T
  constexpr int NT = MBN / 8;            // 8-key column tiles of S
  constexpr int DT = DH / 8;             // 8-wide column tiles of O
  constexpr int CH = DH / 8;             // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + MBM * LD;     // [2][MBN][LD]
  __nv_bfloat16* Vs = Ks + 2 * MBN * LD; // [2][MBN][LD]

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int rows = group * Sq;
  const int row0 = blockIdx.x * MBM;
  const int n_rows = min(MBM, rows - row0);

  for (int e = threadIdx.x; e < MBM * CH; e += MW * 32) {
    const int r = e / CH;
    const int c = (e % CH) * 8;
    const int R = row0 + r;
    const bool ok = r < n_rows;
    const __nv_bfloat16* src =
        ok ? q + (((size_t)b * Hq + kvh * group + R % group) * Sq +
                  R / group) * DH + c
           : q;
    cp_async16(Qs + r * LD + c, src, ok);
  }

  const int kv_lim = min(kv_len, Skv);
  int kend = kv_lim;
  if (causal) kend = min(kend, q_offset + (row0 + n_rows - 1) / group + 1);
  const int n_tiles = kend > 0 ? (kend + MBN - 1) / MBN : 0;
  const size_t kv_base = ((size_t)b * Hkv + kvh) * (size_t)Skv * DH;

  auto load_kv = [&](int t, int buf) {
    const int k0 = t * MBN;
    for (int e = threadIdx.x; e < MBN * CH; e += MW * 32) {
      const int r = e / CH;
      const int c = (e % CH) * 8;
      const bool ok = k0 + r < kend;
      const size_t off = kv_base + (size_t)(k0 + r) * DH + c;
      cp_async16(Ks + (buf * MBN + r) * LD + c, ok ? k + off : k, ok);
      cp_async16(Vs + (buf * MBN + r) * LD + c, ok ? v + off : v, ok);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  asm volatile("cp.async.commit_group;\n");

  // this thread's two rows of the warp's 16: g and g + 8
  const int g = lane / 4;
  const int c4 = lane % 4;
  bool row_ok[2];
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    row_ok[i] = r < n_rows;
    qpos[i] = q_offset + (row0 + r) / group;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[j][x] = 0.f;
  uint32_t qf[KS][4];

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    const int k0 = t * MBN;
    if (t + 1 < n_tiles) load_kv(t + 1, buf ^ 1);
    asm volatile("cp.async.commit_group;\n");
    asm volatile("cp.async.wait_group 1;\n");  // Q and tile t have landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qf[ks], Qs + (warp * 16 + lane % 16) * LD + ks * 16 +
                            (lane / 16) * 8);
    }

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[j][x] = 0.f;
    const __nv_bfloat16* Kt = Ks + buf * MBN * LD;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t bk[4];
        ldsm_x4(bk, Kt + (j * 16 + lane % 8 + (lane / 16) * 8) * LD +
                        ks * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * j], qf[ks], bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], qf[ks], bk[2], bk[3]);
      }
    }

    // mask, then the online softmax as chunked_attention takes it; a
    // row's 16 values of a tile sit in the 4 lanes of one quad
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int kpos = k0 + j * 8 + 2 * c4 + x;
          const bool ok =
              row_ok[i] && kpos < kend && (!causal || kpos <= qpos[i]);
          float& e = s[j][2 * i + x];
          e = ok ? e * scale : -INFINITY;
          mx = fmaxf(mx, e);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = isinf(m_new) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float& e = s[j][2 * i + x];
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

    const __nv_bfloat16* Vt = Vs + buf * MBN * LD;
#pragma unroll
    for (int kk = 0; kk < MBN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DT / 2; ++j) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, Vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                   LD + j * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * j], pa, bv[0], bv[1]);
        mma_bf16(o[2 * j + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();                     // buf is refilled two tiles on
  }
  asm volatile("cp.async.wait_all;\n");

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    const int R = row0 + warp * 16 + g + 8 * i;
    __nv_bfloat16* dst = out + (((size_t)b * Hq + kvh * group + R % group) *
                                    Sq + R / group) * DH;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8 + 2 * c4) =
          __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
  }
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int Hq, int Hkv, int Sq, int Skv, int q_offset, int kv_len,
               int causal, float scale, cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes<DH>();
  auto kernel = flash_mma_kernel<DH>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int rows = (Hq / Hkv) * Sq;
  const dim3 grid((rows + MBM - 1) / MBM, Hkv, B);
  kernel<<<grid, MW * 32, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Hq, Hkv, Sq, Skv, q_offset, kv_len, causal, scale);
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
                int B, int Hq, int Hkv, int Sq, int Skv, int q_offset,
                int kv_len, int causal, float scale, cudaStream_t stream) {
  if ((Hq / Hkv) * Sq <= TY)           // decode: one 16-row SIMT tile
    return launch_tiles<T, DH, 1>(q, k, v, out, B, Hq, Hkv, Sq, Skv,
                                  q_offset, kv_len, causal, scale, stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value && DH <= 128)
    return launch_mma<DH>(q, k, v, out, B, Hq, Hkv, Sq, Skv, q_offset,
                          kv_len, causal, scale, stream);
  else
    return launch_tiles<T, DH, 4>(q, k, v, out, B, Hq, Hkv, Sq, Skv,
                                  q_offset, kv_len, causal, scale, stream);
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, void* out,
                 int B, int Hq, int Hkv, int Sq, int Skv, int Dh,
                 int q_offset, int kv_len, int causal, float scale,
                 cudaStream_t stream) {
  switch (Dh) {
    case 32:
      return launch_rows<T, 32>(q, k, v, out, B, Hq, Hkv, Sq, Skv, q_offset,
                                kv_len, causal, scale, stream);
    case 64:
      return launch_rows<T, 64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, q_offset,
                                kv_len, causal, scale, stream);
    case 128:
      return launch_rows<T, 128>(q, k, v, out, B, Hq, Hkv, Sq, Skv,
                                 q_offset, kv_len, causal, scale, stream);
    case 256:
      return launch_rows<T, 256>(q, k, v, out, B, Hq, Hkv, Sq, Skv,
                                 q_offset, kv_len, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Hq, Sq, Dh], k and v [B, Hkv, Skv, Dh], out like q; all contiguous,
// of one type (bf16 when is_bf16, else f32); Hq a multiple of Hkv; scale
// is Dh^-0.5 rounded to f32 by the caller, as the plain version rounds it.
extern "C" int flash_launch(const void* q, const void* k, const void* v,
                            void* out, int B, int Hq, int Hkv, int Sq,
                            int Skv, int Dh, int q_offset, int kv_len,
                            int causal, int is_bf16, float scale,
                            cudaStream_t stream) {
  if (is_bf16)
    return launch_dtype<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Skv, Dh,
                                       q_offset, kv_len, causal, scale,
                                       stream);
  return launch_dtype<float>(q, k, v, out, B, Hq, Hkv, Sq, Skv, Dh, q_offset,
                             kv_len, causal, scale, stream);
}
