// Causal flash attention (forward) for Hopper (sm_90a), with fp32-accurate
// products on the tensor cores (3xTF32):
//
//     o[bh, i] = sum_{j <= i} softmax_j(q[bh, i] . k[bh / g, j] / sqrt(D))
//                v[bh / g, j],
//     q, o (BH, S, D); k, v (BH / g, S, D); contiguous, one storage type
//     (fp32, bf16, fp16), 1 <= D <= 256 with D % 8 == 0.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:64, pallas_call :74).  Plain version:
// flash_attention_ref in src/repro_torch/kernels/ref.py.  Caller: the LM's
// full-sequence attention (src/repro_torch/models/attention.py), through
// ops.flash_attention, for fp32 and for the head widths other than 64 and
// 128 (bf16 and fp16 at D in {64, 128} go to flash_attn_wgmma.cu).  Query
// row bh reads KV row bh / g: g query heads share one KV head, with no
// repeated copy of k and v.
//
// What bounds it on the H100.  At its main-path shape (BH = 80, S = 2048,
// D = 128, fp32, g = 4: the four-layer fp32 check of phi3-medium-14b at
// b = 2) the causal products are 4*BH*D*S(S+1)/2 = 85.9 GFLOP against 210 MB
// of q, o and the grouped k, v (63 us at 3.35 TB/s).  At fp32 FMA rate (67
// TFLOP/s) that is 1.28 ms.  The tensor cores multiply TF32 (10 mantissa
// bits) at 495 TFLOP/s, and fp32 accuracy costs three TF32 products: each
// operand is split a = hi + lo, hi = a rounded to TF32 (to nearest), lo =
// (a - hi) rounded to TF32, and a*b ~ hi*hi + hi*lo + lo*hi, summed in fp32
// (CUTLASS's 3xTF32); the dropped lo*lo is 2^-22 of a*b.  So the bound is
// 3 x 85.9 GFLOP at 495 TFLOP/s, 0.52 ms, set by operations.  The design:
//   * one CTA of 8 warps per (bh, 128 query rows) (4 warps and 64 rows at
//     D > 128); grid x walks the query tiles heaviest first, grid y is bh.
//     Each warp owns 16 query rows, FlashAttention-2's split: its scores,
//     its online softmax (max m, sum l) and its rows of the output stay in
//     registers, and no warp waits on another's rows;
//   * Q fragments stay in registers across KV tiles (in shared memory at
//     D > 128, where O alone takes 128 registers); K and V tiles of 64 keys
//     (32 at D > 128) come through a double-buffered cp.async ring, the
//     next tile in flight while this one is multiplied;
//   * both products on mma.sync.m16n8k8 TF32 tiles with fp32 sums: Q K^T,
//     and P V with P kept in fp32 and split like the other operands.  The
//     tensor cores do not round their sums to nearest, so each 8-key slice
//     of P V is formed from zero and added to O in fp32, and so is each
//     128-column chunk of Q K^T: no sum on the tensor cores runs longer than
//     48 TF32 products.  The split rounds by integer operations, which
//     issue at full rate, not by cvt, which issues at a quarter of it.  The
//     reduction index of each product is permuted within its 8-slice
//     (logical k = t <-> 2t, t + 4 <-> 2t + 1), so the scores' accumulator
//     fragment is P's operand fragment as it stands (no shuffles) and Q and
//     K fragments are adjacent pairs;
//   * bf16 and fp16 values are exact in TF32, so their Q, K and V need no
//     lo term (P still does); hence the 1/sqrt(D) scale goes on the scores,
//     not on Q;
//   * KV tiles are walked only up to the diagonal, and a warp skips the
//     tiles wholly above its rows; the diagonal and the ragged edge S % 64
//     are masked in the body (keys past S load as zeros, rows past S are
//     computed and not stored); the output is rounded once to the storage
//     type.
// Row strides in shared memory are padded so that each warp's fragment
// loads hit 32 distinct banks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
// The lo terms of the 3xTF32 products; without them each product is one
// TF32 product (1xTF32, about 3 decimal digits).
constexpr bool kLoTerms = true;

template <int DP> struct Cfg {
  static constexpr int kBQ = DP <= 128 ? 128 : 64;    // query rows of a CTA
  static constexpr int kBK = DP <= 128 ? 64 : 32;     // keys of a KV tile
  static constexpr int kThreads = 2 * kBQ;            // one warp per 16 rows
  static constexpr bool kQRegs = DP <= 128;           // Q fragments in registers
};

// Row strides (elements) of the tiles in shared memory.  Q and K are read
// as adjacent pairs (row g, column 2t): 32-bit types want a stride = 8 or
// 24 mod 32 words (8-byte loads go by half warps), 16-bit ones = 8 mod 16
// elements.  V is read as single elements (rows 2t and 2t + 1, column g):
// fp32 wants 4 mod 8, 16-bit types 8 or 24 mod 32.  Every stride keeps rows
// 16-byte aligned for cp.async.
template <typename T> __host__ __device__ inline int ld_qk(int D) {
  if (sizeof(T) == 4) return D + (D % 16 == 0 ? 8 : 16);
  return D + (D % 16 == 0 ? 8 : 0);
}
template <typename T> __host__ __device__ inline int ld_v(int D) {
  if (sizeof(T) == 4) return D + 4;
  return D + (D % 16 == 0 ? 8 : 16);
}

template <typename T, int DP> __host__ inline int smem_bytes(int D) {
  using C = Cfg<DP>;
  return (C::kBQ * ld_qk<T>(D) + 2 * C::kBK * (ld_qk<T>(D) + ld_v<T>(D))) *
         (int)sizeof(T);
}

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
// zero: cvt.rna.tf32.f32's result, by integer operations, which issue at
// full rate where the conversion unit takes a quarter
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi = x rounded to TF32, lo = the rest rounded to TF32.  An
// input of a 16-bit type is exact in TF32: its bits are hi, and lo is 0.
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

// the softmax weights, split like an fp32 input whatever the storage type
__device__ __forceinline__ void split_p(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
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

// d += a b over split operands: the small terms first, then hi*hi.  A
// 16-bit input's lo is 0, so its term is skipped.
template <bool ALo, bool BLo>
__device__ __forceinline__ void mma_3x(float (&d)[4], const uint32_t (&ahi)[4],
                                       const uint32_t (&alo)[4],
                                       const uint32_t (&bhi)[2],
                                       const uint32_t (&blo)[2]) {
  if constexpr (kLoTerms && ALo) mma_tf32(d, alo, bhi);
  if constexpr (kLoTerms && BLo) mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
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
// cpr > 1; 2^32 does not fit 32 bits, so cpr = 1 is its own case).
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

template <typename T, int DP>
__global__ void __launch_bounds__(Cfg<DP>::kThreads, 1)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int S, int D,
                  int group, float scale, int n_tiles) {
  using C = Cfg<DP>;
  constexpr int BQ = C::kBQ, BK = C::kBK, NT = C::kThreads;
  constexpr int NJ = BK / 8;               // 8-key slices of a KV tile
  constexpr int NO = DP / 8;               // 8-column slices of D (at most)
  constexpr int KC = 16;                   // slices of D summed per chunk
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldq = ld_qk<T>(D), ldv = ld_v<T>(D);
  T* qs = reinterpret_cast<T*>(smem);      // (BQ, ldq)
  T* ks = qs + BQ * ldq;                   // 2 x (BK, ldq)
  T* vs = ks + 2 * BK * ldq;               // 2 x (BK, ldv)

  const int tile = n_tiles - 1 - blockIdx.x;     // heaviest first
  const size_t base = (size_t)blockIdx.y * S * D;
  const size_t kv_base = (size_t)(blockIdx.y / group) * S * D;
  const int q0 = tile * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = q0 + warp * 16;           // the warp's first query row
  const int nd = D / 8;                    // live 8-column slices of D
  const int n_kv = (min(q0 + BQ, S) + BK - 1) / BK;
  const int cpr = D * (int)sizeof(T) / 16;
  const unsigned magic = cpr == 1 ? 0u : 0xffffffffu / (unsigned)cpr + 1u;

  load_rows<T, NT>(qs, ldq, q + base, S, D, q0, BQ, cpr, magic);
  load_rows<T, NT>(ks, ldq, k + kv_base, S, D, 0, BK, cpr, magic);
  load_rows<T, NT>(vs, ldv, v + kv_base, S, D, 0, BK, cpr, magic);
  cp_commit();

  float acc[NO][4];
  float qf[C::kQRegs ? NO : 1][4];
#pragma unroll
  for (int u = 0; u < NO; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const T* qw = qs + (warp * 16 + g) * ldq + 2 * t;   // Q(g, 2t) of slice 0

  for (int kt = 0; kt < n_kv; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kv) {
      load_rows<T, NT>(ks + (st ^ 1) * BK * ldq, ldq, k + kv_base, S, D,
                       (kt + 1) * BK, BK, cpr, magic);
      load_rows<T, NT>(vs + (st ^ 1) * BK * ldv, ldv, v + kv_base, S, D,
                       (kt + 1) * BK, BK, cpr, magic);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if constexpr (C::kQRegs) {
      if (kt == 0) {
#pragma unroll
        for (int ks8 = 0; ks8 < NO; ++ks8) {
          if (ks8 >= nd) break;
          const float2 top = pair_f(qw + 8 * ks8);
          const float2 bot = pair_f(qw + 8 * ldq + 8 * ks8);
          qf[ks8][0] = top.x;
          qf[ks8][1] = bot.x;
          qf[ks8][2] = top.y;
          qf[ks8][3] = bot.y;
        }
      }
    }
    const int k0 = kt * BK;
    const T* kt_s = ks + st * BK * ldq;
    const T* vt_s = vs + st * BK * ldv;
    if (k0 <= wr + 15 && wr < S) {        // the warp has keys at or before
      // S = Q K^T on this tile: sc[j] is keys [8j, 8j + 8).  Past KC
      // 8-column slices of D (D > 128), each chunk of KC is summed on the
      // tensor cores from zero and the chunks are added in fp32 (tot; see
      // P V below)
      float sc[NJ][4], tot[NO > KC ? NJ : 1][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
      if constexpr (NO > KC) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) tot[j][e] = 0.0f;
      }
#pragma unroll
      for (int ks8 = 0; ks8 < NO; ++ks8) {
        if (ks8 >= nd) break;
        float a[4];
        if constexpr (C::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[ks8][e];
        } else {
          const float2 top = pair_f(qw + 8 * ks8);
          const float2 bot = pair_f(qw + 8 * ldq + 8 * ks8);
          a[0] = top.x;
          a[1] = bot.x;
          a[2] = top.y;
          a[3] = bot.y;
        }
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_in<T>(a[e], ahi[e], alo[e]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 kk = pair_f(kt_s + (8 * j + g) * ldq + 8 * ks8 + 2 * t);
          uint32_t bhi[2], blo[2];
          split_in<T>(kk.x, bhi[0], blo[0]);
          split_in<T>(kk.y, bhi[1], blo[1]);
          mma_3x<F32, F32>(sc[j], ahi, alo, bhi, blo);
        }
        if constexpr (NO > KC) {
          if (ks8 % KC == KC - 1 && ks8 < nd - 1) {
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                tot[j][e] += sc[j][e];
                sc[j][e] = 0.0f;
              }
          }
        }
      }
      if constexpr (NO > KC) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = tot[j][e] + sc[j][e];
      }
      // scale, mask keys after the row, online softmax over the tile
      const bool diag = k0 + BK - 1 > wr;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = sc[j][e] * scale;
          if (diag && k0 + 8 * j + 2 * t + (e & 1) > wr + g + 8 * (e >> 1))
            s = kNegInf;
          sc[j][e] = s;
          mx[e >> 1] = fmaxf(mx[e >> 1], s);
        }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = expf(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= corr[h];
      }
#pragma unroll
      for (int u = 0; u < NO; ++u) {
        acc[u][0] *= corr[0];
        acc[u][1] *= corr[0];
        acc[u][2] *= corr[1];
        acc[u][3] *= corr[1];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(sc[j][e] - m[e >> 1]);
          sc[j][e] = p;
          l[e >> 1] += p;
        }
      // O += P V: slice j's scores are P's operand as they stand (key 2t is
      // logical t, key 2t + 1 logical t + 4).  Each slice's product starts
      // from zero and is added to O in fp32: the tensor cores' sums are
      // not rounded to nearest, and a bias grown over every key of a long
      // row (up to 3e-5 of the row at S = 2048) would exceed CHECK_TOLS.
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float pa[4] = {sc[j][0], sc[j][2], sc[j][1], sc[j][3]};
        uint32_t phi[4], plo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_p(pa[e], phi[e], plo[e]);
        const T* v0 = vt_s + (8 * j + 2 * t) * ldv + g;
#pragma unroll
        for (int u = 0; u < NO; ++u) {
          if (u >= nd) break;
          uint32_t bhi[2], blo[2];
          split_in<T>(to_f(v0[8 * u]), bhi[0], blo[0]);
          split_in<T>(to_f(v0[ldv + 8 * u]), bhi[1], blo[1]);
          float pv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_3x<true, F32>(pv, phi, plo, bhi, blo);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][e] += pv[e];
        }
      }
    }
    __syncthreads();                       // this stage may be refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr + g + 8 * h;
    if (row >= S) continue;
    T* out = o + base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int u = 0; u < NO; ++u) {
      if (u >= nd) break;
      out[8 * u] = from_f<T>(acc[u][2 * h] / l[h]);
      out[8 * u + 1] = from_f<T>(acc[u][2 * h + 1] / l[h]);
    }
  }
}

template <typename T, int DP>
int launch_dp(const void* q, const void* k, const void* v, void* o, int BH,
              int BHKV, int S, int D, float scale, void* stream) {
  const int bytes = smem_bytes<T, DP>(D);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attn_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_tiles = (S + Cfg<DP>::kBQ - 1) / Cfg<DP>::kBQ;
  const dim3 grid(n_tiles, BH);
  flash_attn_kernel<T, DP>
      <<<grid, Cfg<DP>::kThreads, bytes, (cudaStream_t)stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (T*)o, S, D, BH / BHKV,
          scale, n_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int BHKV, int S, int D, float scale, void* stream) {
  if (D < 8 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  if (D <= 32)
    return launch_dp<T, 32>(q, k, v, o, BH, BHKV, S, D, scale, stream);
  if (D <= 64)
    return launch_dp<T, 64>(q, k, v, o, BH, BHKV, S, D, scale, stream);
  if (D <= 128)
    return launch_dp<T, 128>(q, k, v, o, BH, BHKV, S, D, scale, stream);
  if (D <= 256)
    return launch_dp<T, 256>(q, k, v, o, BH, BHKV, S, D, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, one symbol per storage type.  Pointers are device
// pointers to contiguous q, o (BH, S, D) and k, v (BHKV, S, D), each
// starting on a 16-byte boundary; the wrapper (kernels/flash_attention.py)
// checks 1 <= D <= 256 with D % 8 == 0, 1 <= BH <= 65535, BHKV dividing BH
// and S >= 1, and passes scale = 1/sqrt(D).  Each returns cudaGetLastError()
// after the launch.
#define FLASH_API(SUFFIX, T)                                                  \
  extern "C" int flash_attn_##SUFFIX(const void* q, const void* k,           \
                                     const void* v, void* o, int BH,         \
                                     int BHKV, int S, int D, float scale,    \
                                     void* stream) {                         \
    return launch<T>(q, k, v, o, BH, BHKV, S, D, scale, stream);             \
  }

FLASH_API(f32, float)
FLASH_API(bf16, __nv_bfloat16)
FLASH_API(f16, __half)
