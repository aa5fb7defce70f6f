// Causal flash attention, backward, for Hopper (sm_90a), with fp32-accurate
// products on the tensor cores (3xTF32): the gradients dQ, dK, dV of
//
//     o[bh, i] = sum_{j <= i} softmax_j(q[bh, i] . k[bh / g, j] / sqrt(D))
//                v[bh / g, j],
//
// given q, o, dO (BH, S, D) and k, v (BH / g, S, D), contiguous, of one
// storage type (fp32, bf16, fp16), 8 <= D <= 256 with D % 8 == 0:
//
//     LSE_i = log sum_{j <= i} exp(S_ij),  S_ij = q_i . k_j / sqrt(D),
//     D_i = dO_i . O_i,  P_ij = exp(S_ij - LSE_i),
//     dV_j = sum_i P_ij dO_i,  dS_ij = P_ij (dO_i . v_j - D_i),
//     dQ_i = sum_j dS_ij k_j / sqrt(D),  dK_j = sum_i dS_ij q_i / sqrt(D),
//
// dK and dV of KV row bkv summed over the g query rows bh = bkv g + h that
// read it.  The results are rounded once to the storage type.
//
// Replaces no TPU kernel: the reference trains through dense attention
// that XLA differentiates (src/repro/models/attention.py:62-93) and has no
// Pallas backward.  The port's full-sequence attention runs through the
// flash forward kernels (flash_attn.cu, flash_attn_wgmma.cu), so training
// needs this gradient.  Plain version: flash_attention_bwd_ref in
// src/repro_torch/kernels/ref.py.  Caller: ops.flash_attention's
// torch.autograd.Function, for CUDA tensors of fp32 at every D and of bf16
// and fp16 at D outside {64, 128} (those go to flash_attn_bwd_wgmma.cu).
//
// What bounds it on the H100.  The five products (S = Q K^T, dP = dO V^T,
// dV += P^T dO, dQ += dS K, dK += dS^T Q) are 10 D flops a (query, key)
// pair on or below the diagonal: at granite-3-2b's training shape (q (128,
// 4096, 64), k, v (32, 4096, 64), g 4) 687 GFLOP against 0.34 GB moved in
// fp32 (0.1 ms at 3.35 TB/s), so the products bound it.  At fp32 accuracy
// each product is three TF32 products (CUTLASS's 3xTF32, as in
// flash_attn.cu: a = hi + lo, each rounded to TF32, a b ~ hi hi + hi lo +
// lo hi summed in fp32; the dropped lo lo is 2^-22 of a b), 165 TFLOP/s of
// the tensor cores' 495: 4.2 ms, against 10.3 ms for the same products on
// fp32 FMAs.  bf16 and fp16 inputs are exact in TF32 and take their hi
// term alone; P and dS are fp32 and are split whatever the storage type.
// The design:
//   * two kernels and no atomics, so a repeat is bit for bit the same:
//     - dq_kernel, one CTA per (query row bh, kBQ query rows), heaviest
//       tiles first, one warp per 16 query rows (its scores, softmax and dQ
//       rows in registers, FlashAttention-2's split).  It walks the key
//       tiles up to the diagonal twice: once for each row's LSE (an online
//       max and sum over S), written with D_i to an fp32 (BH, S) scratch,
//       then for S, dP, dS and dQ += dS K;
//     - dkdv_kernel, one CTA per (KV row, kBKV keys), one warp per 16 keys.
//       It walks the g query rows that share the KV row and, for each, the
//       query tiles from the diagonal down, rebuilds P^T = exp(K Q^T - LSE)
//       from the scratch, and keeps dK and dV in registers across all of
//       them.  Above D = 128 the two sums do not fit one thread's registers
//       together, so grid z = 2 gives dV and dK CTAs of their own (dV's
//       CTA skips dP: six products where five would do);
//   * Q and dO rows (dq) and K and V rows (dkdv) stay in shared memory in
//     the storage type; the tiles walked (K and V; Q, dO, LSE and D) come
//     through a double-buffered cp.async ring, the next tile in flight
//     while this one is multiplied.  Tiles are picked by D (Cfg<DP>, DP in
//     {64, 128, 192, 256}) to fit the 227 KB a block may have in fp32 and
//     a thread's 255 registers.  With one 16-row tile a warp the kernels
//     wait on latency more than on the tensor cores, so at D <= 64 the
//     tiles are cut to let two CTAs share an SM (16 warps, 128 registers a
//     thread: 32 ms in place of 36.6 at granite's fp32 shape on an H100);
//   * every product on mma.sync.m16n8k8 TF32 tiles with fp32 sums.  The
//     tensor cores do not round their sums to nearest, and P's exponent
//     (S) and dS's difference (dP - D_i) turn a bias of S and dP grown
//     over D into errors of dQ above 1e-4 (D = 96, S = 1000), so each
//     8-row slice of the column products (dV, dQ, dK) and, with fp32
//     inputs, each 8-column slice of the row products (S, dP) is formed
//     from zero and added in fp32: with fp32 inputs no sum on the tensor
//     cores runs longer than 24 TF32 products.  The split rounds by
//     integer operations, at full issue rate;
//   * the row products' reduction index is permuted within each 8-slice
//     (logical t <-> 2t, t + 4 <-> 2t + 1), so the accumulator fragment of
//     S (or S^T) is the operand fragment of the column product as it
//     stands, and the 8 keys (or queries) of a slice are taken in the order
//     sig(n) = n ^ (n >> 2), so that with a row stride of 8 mod 16 (16-bit)
//     or 8 mod 32 words (fp32) both the pair loads of the row products and
//     the single loads of the column products hit 32 distinct banks;
//   * the diagonal and the ragged edge S % tile are masked in the body:
//     rows and keys past S load as zeros, take P = 0 and are not stored.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kDV = 1, kDK = 2;           // what a dkdv CTA sums

template <int DP> struct Cfg {
  // dq_kernel: query rows of a CTA, keys of a K, V tile
  static constexpr int kBQ = DP <= 128 ? 128 : 64;
  static constexpr int kBK = DP <= 192 ? 32 : 16;
  // dkdv_kernel: keys of a CTA, query rows of a Q, dO tile
  static constexpr int kBKV = kBQ;
  static constexpr int kBR = kBK;
  // dK and dV by CTAs of their own (their sums take 2 D / 2 registers)
  static constexpr bool kSplit = DP > 128;
  // CTAs an SM: at D <= 64 two fit both registers (128 a thread) and
  // shared memory
  static constexpr int kMinBlocks = DP <= 64 ? 2 : 1;
};

// Row stride (elements) of every tile in shared memory: 8 mod 16 elements
// (16-bit types) or 8 or 24 mod 32 words (fp32), and 16-byte rows.
__host__ __device__ inline int ld_of(int D) {
  return D + (D % 16 == 0 ? 8 : 0);
}

template <typename T, int DP> __host__ inline int dq_smem(int D) {
  using C = Cfg<DP>;
  return (2 * C::kBQ + 4 * C::kBK) * ld_of(D) * (int)sizeof(T);
}
template <typename T, int DP> __host__ inline int dkdv_smem(int D) {
  using C = Cfg<DP>;
  return (2 * C::kBKV + 4 * C::kBR) * ld_of(D) * (int)sizeof(T) +
         4 * C::kBR * (int)sizeof(float);
}

// the key (or query) of column n of an 8-slice
__device__ __forceinline__ int sig(int n) { return n ^ (n >> 2); }

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ inline T from_f(float x);
template <> __device__ inline float from_f<float>(float x) { return x; }
template <> __device__ inline __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ inline __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// elements p[0], p[1] as floats (p even-aligned)
__device__ inline float2 pair_f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ inline float2 pair_f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ inline float2 pair_f(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, by integer operations
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo in TF32; an input of a 16-bit type is exact: hi, and lo 0
template <typename T>
__device__ __forceinline__ void split_in(float x, uint32_t& hi,
                                         uint32_t& lo) {
  if constexpr (sizeof(T) == 4) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// D (16x8) += A (16x8) B (8x8) on TF32 with fp32 sums.  Lane (g, t) =
// (lane / 4, lane % 4) holds A[g + 8h][t + 4q] in a[h + 2q], B[t + 4q][g]
// in b[q] and D[g + 8h][2t + e] in d[2h + e].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b over split operands: the small terms first, then hi*hi; a
// 16-bit input's lo is 0 and its term is skipped
template <bool ALo, bool BLo>
__device__ __forceinline__ void mma_3x(float (&d)[4], const uint32_t (&ahi)[4],
                                       const uint32_t (&alo)[4],
                                       const uint32_t (&bhi)[2],
                                       const uint32_t (&blo)[2]) {
  if constexpr (ALo) mma_tf32(d, alo, bhi);
  if constexpr (BLo) mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + rows) of x (S, D) into dst (rows, ld) by 16-byte cp.async
// copies; rows past S are zero-filled.  cpr = D * sizeof(T) / 16 chunks a
// row, magic = 2^32 / cpr rounded up (i / cpr == __umulhi(i, magic) for
// cpr > 1).
template <typename T, int NT>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* x, int S,
                                          int D, int r0, int rows, int cpr,
                                          unsigned magic) {
  constexpr int E = 16 / sizeof(T);
  for (int i = threadIdx.x; i < rows * cpr; i += NT) {
    const int r = cpr == 1 ? i : (int)__umulhi(i, magic);
    const int c = (i - r * cpr) * E;
    const int row = r0 + r;
    const bool in = row < S;
    cp16(dst + r * ld + c, in ? x + (size_t)row * D + c : x, in ? 16 : 0);
  }
}

// acc[j] = A B^T over D for 16 rows of A against the 8 NJ rows of B (a
// tile): a points at A(g, 2t), rows of stride ld; B's row of column n of
// slice j is 8 j + sig(n).  With fp32 inputs each 8-column slice of D is
// summed on the tensor cores from zero and added in fp32 (see the header);
// 16-bit inputs are summed on the tensor cores over all of D.
template <typename T, int NJ, int NO>
__device__ __forceinline__ void row_products(float (&acc)[NJ][4], const T* a,
                                             const T* b_tile, int ld, int nd,
                                             int g, int t) {
  constexpr bool F32 = sizeof(T) == 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const T* b = b_tile + sig(g) * ld + 2 * t;
#pragma unroll
  for (int ks8 = 0; ks8 < NO; ++ks8) {
    if (ks8 >= nd) break;
    const float2 top = pair_f(a + 8 * ks8);
    const float2 bot = pair_f(a + 8 * ld + 8 * ks8);
    const float av[4] = {top.x, bot.x, top.y, bot.y};
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_in<T>(av[e], ahi[e], alo[e]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 bb = pair_f(b + 8 * j * ld + 8 * ks8);
      uint32_t bhi[2], blo[2];
      split_in<T>(bb.x, bhi[0], blo[0]);
      split_in<T>(bb.y, bhi[1], blo[1]);
      if constexpr (F32) {
        float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_3x<true, true>(p, ahi, alo, bhi, blo);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += p[e];
      } else {
        mma_3x<false, false>(acc[j], ahi, alo, bhi, blo);
      }
    }
  }
}

// out[u] += W X over the 8 NI rows of a tile X: W (16 x 8 NI) the
// accumulator fragments of a row product, as they stand (its column n of
// slice i is X's row 8 i + sig(n)); out[u] the 16 x 8 block of columns
// [8u, 8u + 8).  W is fp32 and split; each slice's product is formed from
// zero and added in fp32.
template <typename T, int NI, int NO>
__device__ __forceinline__ void col_products(float (&out)[NO][4],
                                             const float (&w)[NI][4],
                                             const T* x_tile, int ld, int nd,
                                             int g, int t) {
  constexpr bool F32 = sizeof(T) == 4;
  const int r0 = sig(2 * t), r1 = sig(2 * t + 1);
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const float wa[4] = {w[i][0], w[i][2], w[i][1], w[i][3]};
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_in<float>(wa[e], ahi[e], alo[e]);
    const T* x0 = x_tile + (8 * i + r0) * ld + g;
    const T* x1 = x_tile + (8 * i + r1) * ld + g;
#pragma unroll
    for (int u = 0; u < NO; ++u) {
      if (u >= nd) break;
      uint32_t bhi[2], blo[2];
      split_in<T>(to_f(x0[8 * u]), bhi[0], blo[0]);
      split_in<T>(to_f(x1[8 * u]), bhi[1], blo[1]);
      float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_3x<true, F32>(p, ahi, alo, bhi, blo);
#pragma unroll
      for (int e = 0; e < 4; ++e) out[u][e] += p[e];
    }
  }
}

// Rows r0 + g + 8h of out (S, D) from a 16 x D block of fragments times mul;
// rows past S skipped.
template <typename T, int NO>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[NO][4],
                                           float mul, int r0, int S, int D,
                                           int nd, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= S) continue;
    T* o = out + (size_t)row * D + 2 * t;
#pragma unroll
    for (int u = 0; u < NO; ++u) {
      if (u >= nd) break;
      o[8 * u] = from_f<T>(acc[u][2 * h] * mul);
      o[8 * u + 1] = from_f<T>(acc[u][2 * h + 1] * mul);
    }
  }
}

// dQ of kBQ query rows of row bh, and the rows' LSE and D into the
// scratch.  Iterations [0, n_kv) walk the key tiles for the LSE (K alone),
// [n_kv, 2 n_kv) walk them again (K and V) for dS and dQ.
template <typename T, int DP>
__global__ void __launch_bounds__(2 * Cfg<DP>::kBQ, Cfg<DP>::kMinBlocks)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, T* __restrict__ dq,
              float* __restrict__ lse_out, float* __restrict__ dsum_out,
              int group, int S, int D, float scale, int n_tiles) {
  using C = Cfg<DP>;
  constexpr int BQ = C::kBQ, BK = C::kBK, NT = 2 * BQ;
  constexpr int NJ = BK / 8, NO = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float row_d[BQ];
  const int ld = ld_of(D);
  T* qs = reinterpret_cast<T*>(smem);      // (BQ, ld)
  T* dos = qs + BQ * ld;                   // (BQ, ld)
  T* ks = dos + BQ * ld;                   // 2 x (BK, ld)
  T* vs = ks + 2 * BK * ld;                // 2 x (BK, ld)

  const int tile = n_tiles - 1 - (int)blockIdx.x;      // heaviest first
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * S * D;
  const size_t kv_base = (size_t)(bh / group) * S * D;
  const int q0 = tile * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = q0 + warp * 16;           // the warp's first query row
  const int nd = D / 8;
  const int n_kv = (min(q0 + BQ, S) + BK - 1) / BK;
  const int cpr = D * (int)sizeof(T) / 16;
  const unsigned magic = cpr == 1 ? 0u : 0xffffffffu / (unsigned)cpr + 1u;
  const int cs[2] = {sig(2 * t), sig(2 * t + 1)};

  load_rows<T, NT>(qs, ld, q + base, S, D, q0, BQ, cpr, magic);
  load_rows<T, NT>(dos, ld, dout + base, S, D, q0, BQ, cpr, magic);
  load_rows<T, NT>(ks, ld, k + kv_base, S, D, 0, BK, cpr, magic);
  cp_commit();

  // D_i = dO_i . O_i of the warp's 16 rows, a warp a row
#pragma unroll 4
  for (int r = 0; r < 16; ++r) {
    const int row = wr + r;
    float s = 0.0f;
    if (row < S) {
      const T* orow = o + base + (size_t)row * D;
      const T* drow = dout + base + (size_t)row * D;
      for (int c = lane; c < D; c += 32)
        s = fmaf(to_f(drow[c]), to_f(orow[c]), s);
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, m);
    if (lane == 0) row_d[warp * 16 + r] = s;
  }
  __syncwarp();
  const float dsum[2] = {row_d[warp * 16 + g], row_d[warp * 16 + g + 8]};

  const T* qw = qs + (warp * 16 + g) * ld + 2 * t;     // Q(g, 2t)
  const T* dow = dos + (warp * 16 + g) * ld + 2 * t;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float lse[2] = {0.0f, 0.0f};
  float acc[NO][4];
#pragma unroll
  for (int u = 0; u < NO; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.0f;

  for (int it = 0; it < 2 * n_kv; ++it) {
    const int st = it & 1;
    if (it + 1 < 2 * n_kv) {
      const int nxt = it + 1 < n_kv ? it + 1 : it + 1 - n_kv;
      load_rows<T, NT>(ks + (st ^ 1) * BK * ld, ld, k + kv_base, S, D,
                       nxt * BK, BK, cpr, magic);
      if (it + 1 >= n_kv)
        load_rows<T, NT>(vs + (st ^ 1) * BK * ld, ld, v + kv_base, S, D,
                         nxt * BK, BK, cpr, magic);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* kt_s = ks + st * BK * ld;
    const T* vt_s = vs + st * BK * ld;
    if (it == n_kv) {                      // the LSE, into the scratch
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        lse[h] = m[h] + logf(l[h]);
        const int row = wr + g + 8 * h;
        if (t == 0 && row < S) {
          lse_out[(size_t)bh * S + row] = lse[h];
          dsum_out[(size_t)bh * S + row] = dsum[h];
        }
      }
    }
    if (it < n_kv) {
      const int k0 = it * BK;
      if (wr < S && k0 <= wr + 15) {       // pass 1: online max and sum
        float sc[NJ][4];
        row_products<T, NJ, NO>(sc, qw, kt_s, ld, nd, g, t);
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + cs[e & 1];
            float s = sc[j][e] * scale;
            if (key > wr + g + 8 * (e >> 1)) s = kNegInf;
            sc[j][e] = s;
            mx[e >> 1] = fmaxf(mx[e >> 1], s);
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          l[h] *= expf(m[h] - mx[h]);
          m[h] = mx[h];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) l[e >> 1] += expf(sc[j][e] - m[e >> 1]);
      }
    } else {
      const int k0 = (it - n_kv) * BK;
      const bool ds_tile = wr < S && k0 <= wr + 15;
      if (ds_tile) {                       // pass 2: dS, then dQ += dS K
        float sc[NJ][4], dp[NJ][4];
        row_products<T, NJ, NO>(sc, qw, kt_s, ld, nd, g, t);
        row_products<T, NJ, NO>(dp, dow, vt_s, ld, nd, g, t);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + cs[e & 1];
            const int h = e >> 1;
            const float p = key <= wr + g + 8 * h
                                ? expf(sc[j][e] * scale - lse[h]) : 0.0f;
            sc[j][e] = p * (dp[j][e] - dsum[h]);
          }
        col_products<T, NJ, NO>(acc, sc, kt_s, ld, nd, g, t);
      }
    }
    __syncthreads();                       // this stage may be refilled
  }
  store_rows<T, NO>(dq + base, acc, scale, wr, S, D, nd, g, t);
}

// dK and/or dV (MODE) of kBKV keys of KV row bkv, summed over its g query
// rows: iteration it takes query row bkv g + it / n_qt and the query tile
// qt0 + it % n_qt, from the diagonal down.
template <typename T, int DP, int MODE>
__device__ __forceinline__ void dkdv_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
    const float* __restrict__ lse_in, const float* __restrict__ dsum_in,
    int g_rows, int S, int D, float scale) {
  using C = Cfg<DP>;
  constexpr int BKV = C::kBKV, BR = C::kBR, NT = 2 * BKV;
  constexpr int NI = BR / 8, NO = DP / 8;
  constexpr bool DV = MODE & kDV, DK = MODE & kDK;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = ld_of(D);
  T* ks = reinterpret_cast<T*>(smem);      // (BKV, ld)
  T* vs = ks + BKV * ld;                   // (BKV, ld)
  T* qs = vs + BKV * ld;                   // 2 x (BR, ld)
  T* dos = qs + 2 * BR * ld;               // 2 x (BR, ld)
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BR * ld);   // 2 x BR
  float* dsum_s = lse_s + 2 * BR;                               // 2 x BR

  const int bkv = blockIdx.y;
  const int k0 = blockIdx.x * BKV;         // tile 0 walks the most queries
  const size_t kv_base = (size_t)bkv * S * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = k0 + warp * 16;           // the warp's first key
  const int nd = D / 8;
  const int qt0 = k0 / BR;
  const int n_qt = (S + BR - 1) / BR - qt0;
  const int n_iters = g_rows * n_qt;
  const int cpr = D * (int)sizeof(T) / 16;
  const unsigned magic = cpr == 1 ? 0u : 0xffffffffu / (unsigned)cpr + 1u;
  const int cs[2] = {sig(2 * t), sig(2 * t + 1)};

  // the query tile of iteration it into ring stage st
  auto load_q = [&](int it, int st) {
    const int bh = bkv * g_rows + it / n_qt;
    const int r0 = (qt0 + it % n_qt) * BR;
    const size_t base = (size_t)bh * S * D;
    load_rows<T, NT>(qs + st * BR * ld, ld, q + base, S, D, r0, BR, cpr,
                     magic);
    load_rows<T, NT>(dos + st * BR * ld, ld, dout + base, S, D, r0, BR, cpr,
                     magic);
    if (threadIdx.x < BR) {
      const int row = r0 + threadIdx.x;
      const bool in = row < S;
      const size_t at = (size_t)bh * S + (in ? row : 0);
      cp4(lse_s + st * BR + threadIdx.x, lse_in + at, in ? 4 : 0);
      cp4(dsum_s + st * BR + threadIdx.x, dsum_in + at, in ? 4 : 0);
    }
  };

  load_rows<T, NT>(ks, ld, k + kv_base, S, D, k0, BKV, cpr, magic);
  if constexpr (DK)
    load_rows<T, NT>(vs, ld, v + kv_base, S, D, k0, BKV, cpr, magic);
  load_q(0, 0);
  cp_commit();

  float dk_acc[DK ? NO : 1][4], dv_acc[DV ? NO : 1][4];
#pragma unroll
  for (int u = 0; u < NO; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (DK) dk_acc[u][e] = 0.0f;
      if constexpr (DV) dv_acc[u][e] = 0.0f;
    }
  const T* kw_s = ks + (warp * 16 + g) * ld + 2 * t;   // K(g, 2t)
  const T* vw_s = vs + (warp * 16 + g) * ld + 2 * t;

  for (int it = 0; it < n_iters; ++it) {
    const int st = it & 1;
    if (it + 1 < n_iters) {
      load_q(it + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int q0 = (qt0 + it % n_qt) * BR;
    const T* qt_s = qs + st * BR * ld;
    const T* dot_s = dos + st * BR * ld;
    const float* lse_t = lse_s + st * BR;
    const float* dsum_t = dsum_s + st * BR;
    if (kw < S && q0 + BR - 1 >= kw) {     // the tile has rows at or after
      float pt[NI][4];                     // P^T: (keys, queries)
      row_products<T, NI, NO>(pt, kw_s, qt_s, ld, nd, g, t);
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * i + cs[e & 1];
          const int query = q0 + r;
          const int key = kw + g + 8 * (e >> 1);
          const bool live = key <= query && query < S;
          pt[i][e] = live ? expf(pt[i][e] * scale - lse_t[r]) : 0.0f;
        }
      if constexpr (DV)
        col_products<T, NI, NO>(dv_acc, pt, dot_s, ld, nd, g, t);
      if constexpr (DK) {
        float dpt[NI][4];                  // dP^T = V dO^T
        row_products<T, NI, NO>(dpt, vw_s, dot_s, ld, nd, g, t);
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[i][e] = pt[i][e] * (dpt[i][e] - dsum_t[8 * i + cs[e & 1]]);
        col_products<T, NI, NO>(dk_acc, dpt, qt_s, ld, nd, g, t);
      }
    }
    __syncthreads();                       // this stage may be refilled
  }
  if constexpr (DK) store_rows<T, NO>(dk + kv_base, dk_acc, scale, kw, S, D,
                                      nd, g, t);
  if constexpr (DV) store_rows<T, NO>(dv + kv_base, dv_acc, 1.0f, kw, S, D,
                                      nd, g, t);
}

template <typename T, int DP>
__global__ void __launch_bounds__(2 * Cfg<DP>::kBKV,
                                  Cfg<DP>::kMinBlocks)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                T* __restrict__ dk, T* __restrict__ dv,
                const float* __restrict__ lse_in,
                const float* __restrict__ dsum_in, int group, int S, int D,
                float scale) {
  if constexpr (Cfg<DP>::kSplit) {
    if (blockIdx.z == 0)
      dkdv_body<T, DP, kDV>(q, k, v, dout, dk, dv, lse_in, dsum_in, group, S,
                            D, scale);
    else
      dkdv_body<T, DP, kDK>(q, k, v, dout, dk, dv, lse_in, dsum_in, group, S,
                            D, scale);
  } else {
    dkdv_body<T, DP, kDV | kDK>(q, k, v, dout, dk, dv, lse_in, dsum_in, group,
                                S, D, scale);
  }
}

template <typename T, int DP>
int launch_dp(const T* q, const T* k, const T* v, const T* o, const T* dout,
              T* dq, T* dk, T* dv, float* lse, float* dsum, int BH, int BHkv,
              int S, int D, float scale, cudaStream_t stream) {
  using C = Cfg<DP>;
  const int group = BH / BHkv;
  const int s1 = dq_smem<T, DP>(D), s2 = dkdv_smem<T, DP>(D);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkdv_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s2);
  if (err != cudaSuccess) return (int)err;
  const int n_q = (S + C::kBQ - 1) / C::kBQ;
  dq_kernel<T, DP><<<dim3(n_q, BH), 2 * C::kBQ, s1, stream>>>(
      q, k, v, o, dout, dq, lse, dsum, group, S, D, scale, n_q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_k = (S + C::kBKV - 1) / C::kBKV;
  dkdv_kernel<T, DP>
      <<<dim3(n_k, BHkv, C::kSplit ? 2 : 1), 2 * C::kBKV, s2, stream>>>(
          q, k, v, dout, dk, dv, lse, dsum, group, S, D, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* dsum, int BH, int BHkv, int S, int D, float scale,
           void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv || S <= 0 || D < 8 || D > 256 ||
      D % 8 || BH > 65535 || BHkv > 65535)
    return (int)cudaErrorInvalidValue;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* to = static_cast<const T*>(o);
  const T* tdo = static_cast<const T*>(dout);
  T* tdq = static_cast<T*>(dq);
  T* tdk = static_cast<T*>(dk);
  T* tdv = static_cast<T*>(dv);
  float* fl = static_cast<float*>(lse);
  float* fd = static_cast<float*>(dsum);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_dp<T, 64>(tq, tk, tv, to, tdo, tdq, tdk, tdv, fl, fd, BH,
                            BHkv, S, D, scale, st);
  if (D <= 128)
    return launch_dp<T, 128>(tq, tk, tv, to, tdo, tdq, tdk, tdv, fl, fd, BH,
                             BHkv, S, D, scale, st);
  if (D <= 192)
    return launch_dp<T, 192>(tq, tk, tv, to, tdo, tdq, tdk, tdv, fl, fd, BH,
                             BHkv, S, D, scale, st);
  return launch_dp<T, 256>(tq, tk, tv, to, tdo, tdq, tdk, tdv, fl, fd, BH,
                           BHkv, S, D, scale, st);
}

}  // namespace

// dq, dk, dv and the fp32 scratch lse, dsum (BH, S) are allocated by the
// caller; pointers start on 16-byte boundaries.  Returns 0 or a CUDA error
// code (cudaErrorInvalidValue for a shape the kernel does not take).
#define FLASH_BWD_ENTRY(suffix, T)                                           \
  extern "C" int flash_attn_bwd_##suffix(                                    \
      const void* q, const void* k, const void* v, const void* o,            \
      const void* dout, void* dq, void* dk, void* dv, void* lse, void* dsum, \
      int BH, int BHkv, int S, int D, float scale, void* stream) {           \
    return launch<T>(q, k, v, o, dout, dq, dk, dv, lse, dsum, BH, BHkv, S,  \
                     D, scale, stream);                                      \
  }

FLASH_BWD_ENTRY(f32, float)
FLASH_BWD_ENTRY(bf16, __nv_bfloat16)
FLASH_BWD_ENTRY(f16, __half)
