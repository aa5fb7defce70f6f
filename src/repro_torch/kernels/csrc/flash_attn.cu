// Causal flash attention (forward) for Hopper (sm_90a):
//
//     o[bh, i] = sum_{j <= i} softmax_j(q[bh, i] . k[bh / g, j] / sqrt(D))
//                v[bh / g, j],
//     q, o (BH, S, D); k, v (BH / g, S, D); contiguous, one storage type
//     (fp32, bf16, fp16).
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
// b = 2) the causal products are 4*BH*D*S(S+1)/2 = 85.9 GFLOP, 1.28 ms at
// the 67 TFLOP/s of fp32 (fp32 has no tensor-core route at fp32 precision),
// against 210 MB of q, o and the grouped k, v, 63 us at 3.35 TB/s: the bound
// is 1.28 ms, set by operations.  This first version is simple and right,
// not fast:
//   * one block of 256 threads per (bh, 64-row query tile); grid x walks the
//     query tiles heaviest first (the last tile has the most KV tiles), grid
//     y is bh;
//   * the Q tile (scaled by 1/sqrt(D) as it is loaded), the current K tile
//     and the current V tile sit in dynamic shared memory as fp32, columns
//     padded with zeros to DP in {32, 64, 128, 256}; the softmax weights P of
//     the tile reuse the K tile's space once Q K^T is formed;
//   * thread (tr, tc) owns rows tr + 16 i (i < 4) of the tile: a 4 x 4 block
//     of the scores (columns tc + 16 j) and a 4 x DP/16 block of the
//     accumulator (columns tc + 16 j), in registers, with the running max m
//     and sum l of its rows; the 16 threads of a row reduce with shuffles;
//   * KV tiles are walked only up to the diagonal; the diagonal tile is
//     masked in the body, and so is the ragged edge S % 64 != 0 (rows past S
//     are computed on zeros and not stored);
//   * everything is fp32 FMA, p stays fp32 for P V (as the TPU kernel), and
//     the output is rounded once to the storage type.
// Its shared-memory reads (about one per two FMAs) hold it well below the
// 67 TFLOP/s of fp32 FMA.  For bf16 and fp16 at D = 64 and
// 128, flash_attn_wgmma.cu runs the same function on the tensor cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int kBQ = 64;          // query rows of a block
constexpr int kBK = 64;          // keys of a KV tile
constexpr int kThreads = 256;    // 16 row groups x 16 column groups
constexpr int kPLD = kBK + 16;   // row stride of P: rows tr, tr+1 hit other banks
constexpr float kNegInf = -1e30f;

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

// the block's shared memory, in floats: Q (64, DP+1), the K tile (64, DP+1)
// or P (64, kPLD) in one space, V (64, DP)
template <int DP> __host__ __device__ constexpr int kp_floats() {
  return kBK * (DP + 1) > kBQ * kPLD ? kBK * (DP + 1) : kBQ * kPLD;
}
template <int DP> __host__ __device__ constexpr int smem_floats() {
  return kBQ * (DP + 1) + kp_floats<DP>() + kBK * DP;
}

// rows [r0, r0 + 64) of x (S, D) into dst (64, ld) as fp32 times mul, zero
// past S and past D up to DP
template <typename T, int DP>
__device__ void load_tile(const T* __restrict__ x, int S, int D, int r0,
                          float mul, float* dst, int ld) {
  for (int i = threadIdx.x; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    const int row = r0 + r;
    dst[r * ld + c] = (row < S && c < D)
                          ? to_f(x[(size_t)row * D + c]) * mul : 0.0f;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int S, int D,
                  int group, float scale, int n_tiles) {
  constexpr int LD = DP + 1;     // Q and K row stride: rows on distinct banks
  constexpr int NJ = DP / 16;    // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* kp = qs + kBQ * LD;     // the K tile, then the tile's P
  float* vs = kp + kp_floats<DP>();

  const int tile = n_tiles - 1 - blockIdx.x;     // heaviest first
  const size_t base = (size_t)blockIdx.y * S * D;
  const size_t kv_base = (size_t)(blockIdx.y / group) * S * D;
  const int q0 = tile * kBQ;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;

  load_tile<T, DP>(q + base, S, D, q0, scale, qs, LD);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  for (int kt = 0; kt <= tile; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();             // the previous tile's P V is done
    load_tile<T, DP>(k + kv_base, S, D, k0, 1.0f, kp, LD);
    load_tile<T, DP>(v + kv_base, S, D, k0, 1.0f, vs, DP);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(tr + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = kp[(tc + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
    if (kt == tile) {            // the diagonal tile: keys after the query
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (tc + 16 * j > tr + 16 * i) s[i][j] = kNegInf;
    }
    __syncthreads();             // every thread is done with the K tile

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        kp[(tr + 16 * i) * kPLD + tc + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();             // P is in shared memory

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = kp[(tr + 16 * i) * kPLD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = vs[c * DP + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tc + 16 * j;
      if (col < D) o[base + (size_t)row * D + col] = from_f<T>(acc[i][j] / den);
    }
  }
}

template <typename T, int DP>
int launch_dp(const void* q, const void* k, const void* v, void* o, int BH,
              int BHKV, int S, int D, float scale, void* stream) {
  const int bytes = smem_floats<DP>() * (int)sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attn_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_tiles = (S + kBQ - 1) / kBQ;
  const dim3 grid(n_tiles, BH);
  flash_attn_kernel<T, DP><<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, D, BH / BHKV, scale,
      n_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int BHKV, int S, int D, float scale, void* stream) {
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
// pointers to contiguous q, o (BH, S, D) and k, v (BHKV, S, D); the wrapper
// (kernels/flash_attention.py) checks 1 <= D <= 256 with D % 8 == 0,
// 1 <= BH <= 65535, BHKV dividing BH and S >= 1, and passes
// scale = 1/sqrt(D).  Each returns cudaGetLastError() after the launch.
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
