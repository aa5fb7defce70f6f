// Causal flash attention, backward, for Hopper (sm_90a): the gradients
// dQ, dK, dV of
//
//     o[bh, i] = sum_{j <= i} softmax_j(q[bh, i] . k[bh / g, j] / sqrt(D))
//                v[bh / g, j],
//
// given q, o, dO (BH, S, D) and k, v (BH / g, S, D), contiguous, of one
// storage type (fp32, bf16, fp16), 8 <= D <= 128 with D % 8 == 0:
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
// torch.autograd.Function, for CUDA tensors.
//
// What bounds it on the H100.  At the training shape of granite-3-2b (q
// (128, 4096, 64), k, v (32, 4096, 64), bf16, g 4) the design below does
// 16 D flops a (query, key) pair on or below the diagonal: 1.10 TFLOP a
// launch against 0.34 GB moved (q, k, v, o, dO read, dQ, dK, dV written:
// 0.1 ms at 3.35 TB/s).  On fp32 FMAs (67 TFLOP/s) that is 16.4 ms, so the
// products bound it.  This first version runs every product on FMAs in
// fp32 from tiles in shared memory, which keeps fp32 inputs at fp32
// accuracy and makes bf16 and fp16 exact products; tensor cores (mma.sync
// or wgmma) are later work.  The design:
//   * two kernels and no atomics, so a repeat is bit for bit the same:
//     - dq_kernel, one CTA of 256 threads per (query row bh, 64 query
//       rows), heaviest tiles first.  It walks the key tiles up to the
//       diagonal once to rebuild each row's LSE (an online max and sum),
//       writes LSE and D to an fp32 (BH, S) scratch, then walks them again
//       for dS and dQ;
//     - dkdv_kernel, one CTA per (KV row, 64 keys).  It walks the g query
//       rows that share the KV row and, for each, the query tiles from the
//       diagonal down, recomputes P from the scratch LSE, and keeps dK and
//       dV in registers across all of them;
//   * every tile lives in shared memory as fp32 rows of D + 4 floats (16-
//     byte aligned, and an odd number of 16-byte units, so the 8 lanes of
//     a quarter warp reading 8 rows at one column hit 8 distinct bank
//     groups).  The row products (S, dP) give each thread a 4 x 4 block:
//     4 rows of one tile (a broadcast within the half warp) against 4 rows
//     of the other 16 apart, by float4 along D.  The column products (dQ,
//     dK, dV) give each thread 4 rows and one or two 4-column chunks of the
//     result, summed over the tile's 64 rows of dS or P kept transposed in
//     shared memory;
//   * the diagonal and the ragged edge S % 64 are masked in the body: rows
//     and keys past S load as zeros, take P = 0 and are not stored.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>

namespace {

constexpr int kB = 64;            // rows of every tile (queries or keys)
constexpr int kThreads = 256;
constexpr int kLdT = kB + 4;      // row stride of the transposed dS and P

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

__host__ __device__ inline int ld_of(int D) { return D + 4; }

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__host__ inline size_t dq_smem(int D) {
  return (size_t)(4 * kB * ld_of(D) + kB * kLdT) * sizeof(float);
}
__host__ inline size_t dkdv_smem(int D) {
  return (size_t)(4 * kB * ld_of(D) + 2 * kB * kLdT) * sizeof(float);
}

// Rows [r0, r0 + kB) of x (S, D) into dst (kB, ld) as fp32; rows past S
// are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* x,
                                          int S, int D, int r0) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int row = r0 + r;
    dst[r * ld + c] = row < S ? to_f(x[(size_t)row * D + c]) : 0.f;
  }
}

// acc[a][b] = sum_d A[ra + a][d] * B[rb + 16 b][d], a, b < 4, over tiles
// of row stride ld in shared memory.
__device__ __forceinline__ void row_dots(float (&acc)[4][4], const float* A,
                                         int ra, const float* B, int rb,
                                         int ld, int D) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      av[a] = *reinterpret_cast<const float4*>(A + (ra + a) * ld + d);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      bv[b] = *reinterpret_cast<const float4*>(B + (rb + 16 * b) * ld + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float s = acc[a][b];
        s = fmaf(av[a].x, bv[b].x, s);
        s = fmaf(av[a].y, bv[b].y, s);
        s = fmaf(av[a].z, bv[b].z, s);
        s = fmaf(av[a].w, bv[b].w, s);
        acc[a][b] = s;
      }
  }
}

// The sum over the 16 lanes of a half warp (the lanes that share rows).
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

// acc[a][j][e] += sum_{r < kB} W[r][ra + a] * X[r][4 (cb + 16 j) + e]: W
// (kB, kLdT) transposed weights, X (kB, ld) a tile; chunks past D skipped.
template <int NC>
__device__ __forceinline__ void col_sums(float (&acc)[4][NC][4],
                                         const float* W, int ra,
                                         const float* X, int cb, int ld,
                                         int D) {
  for (int r = 0; r < kB; ++r) {
    const float4 w = *reinterpret_cast<const float4*>(W + r * kLdT + ra);
    const float wa[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = 4 * (cb + 16 * j);
      if (c < D) {
        const float4 x = *reinterpret_cast<const float4*>(X + r * ld + c);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a][j][0] = fmaf(wa[a], x.x, acc[a][j][0]);
          acc[a][j][1] = fmaf(wa[a], x.y, acc[a][j][1]);
          acc[a][j][2] = fmaf(wa[a], x.z, acc[a][j][2]);
          acc[a][j][3] = fmaf(wa[a], x.w, acc[a][j][3]);
        }
      }
    }
  }
}

// Rows r0 + ra + a of out (S, D) from acc times mul; rows past S skipped.
template <typename T, int NC>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[4][NC][4],
                                           float mul, int r0, int ra, int cb,
                                           int S, int D) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = r0 + ra + a;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = 4 * (cb + 16 * j);
      if (c >= D) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(size_t)row * D + c + e] = from_f<T>(acc[a][j][e] * mul);
    }
  }
}

// dQ of 64 query rows of one row bh, and the rows' LSE and D into the
// scratch.  Thread t owns tile rows ra..ra+3 (ra = 4 (t / 16)), keys
// cb + 16 b of each key tile (cb = t % 16), and the dQ columns of chunks
// cb + 16 j.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, T* __restrict__ dq,
              float* __restrict__ lse_out, float* __restrict__ dsum_out,
              int g, int S, int D, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float row_lse[kB], row_d[kB];
  const int ld = ld_of(D);
  float* sQ = smem;
  float* sdO = sQ + kB * ld;
  float* sK = sdO + kB * ld;
  float* sV = sK + kB * ld;
  float* sdS = sV + kB * ld;          // dS transposed: (keys, rows)

  const int n_tiles = (S + kB - 1) / kB;
  const int tile = n_tiles - 1 - (int)blockIdx.x;    // heaviest first
  const int bh = blockIdx.y;
  const int q0 = tile * kB;
  const size_t base = (size_t)bh * S * D;
  const size_t kv_base = (size_t)(bh / g) * S * D;
  const int tid = threadIdx.x;
  const int ra = 4 * (tid / 16);
  const int cb = tid % 16;

  load_tile(sQ, ld, q + base, S, D, q0);
  load_tile(sdO, ld, dout + base, S, D, q0);
  {  // D_i = dO_i . O_i, four lanes a row
    const int r = tid / 4, part = tid % 4, row = q0 + r;
    float s = 0.f;
    if (row < S) {
      const T* orow = o + base + (size_t)row * D;
      const T* drow = dout + base + (size_t)row * D;
      for (int c = part; c < D; c += 4)
        s = fmaf(to_f(drow[c]), to_f(orow[c]), s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0) row_d[r] = s;
  }

  // pass 1: each row's LSE by an online max and sum over the key tiles
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = neg_inf();
    l[a] = 0.f;
  }
  for (int kt = 0; kt <= tile; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();
    load_tile(sK, ld, k + kv_base, S, D, k0);
    __syncthreads();
    float s[4][4];
    row_dots(s, sQ, ra, sK, cb, ld, D);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + ra + a;
      float mx = m[a];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int key = k0 + cb + 16 * b;
        s[a][b] = (key <= row && key < S) ? s[a][b] * scale : neg_inf();
        mx = fmaxf(mx, s[a][b]);
      }
      mx = half_warp_max(mx);       // finite: key 0 is live in tile 0
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) sum += expf(s[a][b] - mx);
      sum = half_warp_sum(sum);
      l[a] = l[a] * expf(m[a] - mx) + sum;
      m[a] = mx;
    }
  }
  if (cb == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) row_lse[ra + a] = m[a] + logf(l[a]);
  }
  __syncthreads();
  if (tid < kB && q0 + tid < S) {
    lse_out[(size_t)bh * S + q0 + tid] = row_lse[tid];
    dsum_out[(size_t)bh * S + q0 + tid] = row_d[tid];
  }
  float lse[4], dsum[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    lse[a] = row_lse[ra + a];
    dsum[a] = row_d[ra + a];
  }

  // pass 2: dS and dQ
  float acc[4][NC][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.f;
  for (int kt = 0; kt <= tile; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();
    load_tile(sK, ld, k + kv_base, S, D, k0);
    load_tile(sV, ld, v + kv_base, S, D, k0);
    __syncthreads();
    float s[4][4], dp[4][4];
    row_dots(s, sQ, ra, sK, cb, ld, D);
    row_dots(dp, sdO, ra, sV, cb, ld, D);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int key = k0 + cb + 16 * b;
      float ds[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int row = q0 + ra + a;
        const float p = (key <= row && key < S)
                            ? expf(s[a][b] * scale - lse[a]) : 0.f;
        ds[a] = p * (dp[a][b] - dsum[a]);
      }
      *reinterpret_cast<float4*>(sdS + (cb + 16 * b) * kLdT + ra) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    col_sums<NC>(acc, sdS, ra, sK, cb, ld, D);
  }
  store_rows<T, NC>(dq + base, acc, scale, q0, ra, cb, S, D);
}

// dK and dV of 64 keys of KV row bkv, summed over its g query rows.
// Thread t owns keys ka..ka+3 of the tile (ka = 4 (t / 16)), query rows
// rb + 16 b of each query tile (rb = t % 16), and the dK, dV columns of
// chunks rb + 16 j.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                T* __restrict__ dk, T* __restrict__ dv,
                const float* __restrict__ lse_in,
                const float* __restrict__ dsum_in, int g, int S, int D,
                float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float row_lse[kB], row_d[kB];
  const int ld = ld_of(D);
  float* sK = smem;
  float* sV = sK + kB * ld;
  float* sQ = sV + kB * ld;
  float* sdO = sQ + kB * ld;
  float* sP = sdO + kB * ld;          // P transposed: (rows, keys)
  float* sdS = sP + kB * kLdT;        // dS transposed: (rows, keys)

  const int n_tiles = (S + kB - 1) / kB;
  const int ktile = blockIdx.x;       // tile 0 walks the most query tiles
  const int bkv = blockIdx.y;
  const int k0 = ktile * kB;
  const size_t kv_base = (size_t)bkv * S * D;
  const int tid = threadIdx.x;
  const int ka = 4 * (tid / 16);
  const int rb = tid % 16;

  load_tile(sK, ld, k + kv_base, S, D, k0);
  load_tile(sV, ld, v + kv_base, S, D, k0);
  float dk_acc[4][NC][4], dv_acc[4][NC][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk_acc[a][j][e] = 0.f;
        dv_acc[a][j][e] = 0.f;
      }

  for (int h = 0; h < g; ++h) {
    const int bh = bkv * g + h;
    const size_t base = (size_t)bh * S * D;
    for (int qt = ktile; qt < n_tiles; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();
      load_tile(sQ, ld, q + base, S, D, q0);
      load_tile(sdO, ld, dout + base, S, D, q0);
      if (tid < kB) {
        const bool in = q0 + tid < S;
        row_lse[tid] = in ? lse_in[(size_t)bh * S + q0 + tid] : 0.f;
        row_d[tid] = in ? dsum_in[(size_t)bh * S + q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      row_dots(s, sK, ka, sQ, rb, ld, D);      // s[a][b] = k_a . q_b
      row_dots(dp, sV, ka, sdO, rb, ld, D);    // dp[a][b] = v_a . dO_b
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = rb + 16 * b;
        const int row = q0 + r;
        const float lse = row_lse[r], dsum = row_d[r];
        float p[4], ds[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int key = k0 + ka + a;
          const bool live = key <= row && row < S && key < S;
          p[a] = live ? expf(s[a][b] * scale - lse) : 0.f;
          ds[a] = p[a] * (dp[a][b] - dsum);
        }
        *reinterpret_cast<float4*>(sP + r * kLdT + ka) =
            make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(sdS + r * kLdT + ka) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();
      col_sums<NC>(dv_acc, sP, ka, sdO, rb, ld, D);
      col_sums<NC>(dk_acc, sdS, ka, sQ, rb, ld, D);
    }
  }
  store_rows<T, NC>(dk + kv_base, dk_acc, scale, k0, ka, rb, S, D);
  store_rows<T, NC>(dv + kv_base, dv_acc, 1.f, k0, ka, rb, S, D);
}

template <typename T, int NC>
int launch_nc(const T* q, const T* k, const T* v, const T* o, const T* dout,
              T* dq, T* dk, T* dv, float* lse, float* dsum, int BH, int BHkv,
              int S, int D, float scale, cudaStream_t stream) {
  const int g = BH / BHkv;
  const int n_tiles = (S + kB - 1) / kB;
  const size_t s1 = dq_smem(D), s2 = dkdv_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkdv_kernel<T, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s2);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T, NC><<<dim3(n_tiles, BH), kThreads, s1, stream>>>(
      q, k, v, o, dout, dq, lse, dsum, g, S, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<T, NC><<<dim3(n_tiles, BHkv), kThreads, s2, stream>>>(
      q, k, v, dout, dk, dv, lse, dsum, g, S, D, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* dsum, int BH, int BHkv, int S, int D, float scale,
           void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv || S <= 0 || D < 8 || D > 128 ||
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
    return launch_nc<T, 1>(tq, tk, tv, to, tdo, tdq, tdk, tdv, fl, fd, BH,
                           BHkv, S, D, scale, st);
  return launch_nc<T, 2>(tq, tk, tv, to, tdo, tdq, tdk, tdv, fl, fd, BH,
                         BHkv, S, D, scale, st);
}

}  // namespace

// dq, dk, dv and the fp32 scratch lse, dsum (BH, S) are allocated by the
// caller; returns 0 or a CUDA error code.
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
