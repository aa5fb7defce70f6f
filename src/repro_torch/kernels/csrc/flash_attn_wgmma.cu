// Causal flash attention (forward) for Hopper (sm_90a) on the tensor cores:
//
//     o[bh, i] = sum_{j <= i} softmax_j(q[bh, i] . k[bh / g, j] / sqrt(D))
//                v[bh / g, j],
//     q, o (BH, S, D); k, v (BH / g, S, D); contiguous, bf16 or fp16,
//     D in {64, 128}.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:64, pallas_call :74) for 16-bit
// types at D = 64 and 128; flash_attn.cu keeps fp32 and every other D.
// Plain version: flash_attention_ref in src/repro_torch/kernels/ref.py.
// Caller: the LM's full-sequence attention
// (src/repro_torch/models/attention.py) through ops.flash_attention, with
// the KV heads as they are: query row bh reads KV row bh / g (g query
// heads share one KV head, the reference's jnp.repeat(k, g, axis=2) order
// once heads are flattened as b * nh + h), so no repeated copy of k and v
// is made.
//
// What bounds it on the H100.  At the main-path shape (BH = 80, S = 2048,
// D = 128, bf16, g = 4: phi3-medium-14b prefill at b = 2) the causal
// products are 4*BH*D*S(S+1)/2 = 85.9 GFLOP, 86.9 us on the bf16 tensor
// cores at 989 TFLOP/s, against 105 MB of q, o and the grouped k, v, 31 us
// at 3.35 TB/s: the bound is 86.9 us, set by operations.  So the products
// must run on the tensor cores (wgmma), the score and probability tiles
// must never leave registers, and the copies must overlap the products:
//   * one CTA per (bh, 128-row query tile), 384 threads: two consumer
//     warpgroups own 64 query rows each, one producer warpgroup (after
//     setmaxnreg, 24 registers a thread; the consumers take 240) of which
//     one thread issues the TMA loads;
//   * TMA brings Q (128 x D) once and K, V tiles of 128 keys x D into a
//     ring of 2 stages, 128-byte swizzled, one box of 64 columns per
//     128-byte row (a D = 128 tile is two boxes).  A full mbarrier per
//     stage counts the bytes; an empty mbarrier per stage takes one
//     arrival from each consumer warp once its products on the stage are
//     done.  The tensor maps are 3-D, (D, S, BH) for q and (D, S,
//     BH / g) for k and v, so the ragged edge S % 128 != 0 reads zeros
//     (out-of-bounds fill) and never the next head's rows; they are made
//     on the host per call with cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint (no -lcuda), and passed as
//     __grid_constant__ parameters;
//   * S = Q K^T by wgmma m64n128k16 with both operands in shared memory
//     (K-major), the fp32 accumulator in registers (64 a thread);
//   * the online softmax runs on that accumulator: scores times
//     log2(e)/sqrt(D), exp2, the row max reduced over the 4 threads that
//     share a row, the row sum kept per thread and reduced once at the
//     end; the diagonal tile is masked per warpgroup (its rows cut the tile
//     at other columns);
//   * O += P V by wgmma with P as the A operand from registers: the fp32
//     accumulator of two n8 slices is the A fragment of one k16 step, so P
//     is packed to 16 bits in place.  V is B in shared memory, MN-major
//     (the transpose bit).  O (64 x D fp32) stays in registers;
//   * the epilogue divides by l, rounds once to the storage type and
//     stores with row masks;
//   * grid (BH, query tiles), the heaviest tiles (most KV tiles) first.
// Not yet here: a persistent scheduler, and two-warpgroup ping-pong (one
// warpgroup's softmax overlapping the other's products).
//
// Numerics differ from the TPU kernel in one place: P is rounded to the
// storage type before P V, where the reference keeps it in fp32 (l sums
// the fp32 values).  For p in [0, 1] that is a relative 2^-9 (bf16) per
// weight; tests/test_torch_flash.py shows on the CPU that it stays inside
// the reference's bf16 tolerance.
//
// A wait on an mbarrier that lasts about 2^33 clocks (seconds) traps, so a
// fault in the ring ends the launch with an error instead of hanging the
// card.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;             // query rows of a CTA
constexpr int kBK = 128;             // keys of a KV tile
constexpr int kStages = 2;           // the K/V ring
constexpr int kConsumers = 2;        // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBoxCols = 64;         // 128 bytes of 16-bit values
constexpr int kBoxBytes = kBK * kBoxCols * 2;   // 128 rows x 64 columns
constexpr long long kWaitLimit = 1LL << 33;     // clocks

// shared memory, in bytes from a 1024-aligned base: Q, K[stages],
// V[stages], then the barriers q_full, full[stages], empty[stages]
template <int D> struct Smem {
  static constexpr int kTile = (D / kBoxCols) * kBoxBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kAlloc = kBar + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t bar_full(uint32_t bar, int s) {
  return bar + 8 * (1 + s);
}
__device__ __forceinline__ uint32_t bar_empty(uint32_t bar, int s) {
  return bar + 8 * (1 + kStages + s);
}

// ---- mbarrier and TMA -----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
               "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitLimit) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// A shared-memory matrix descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
// K-major (rows of 64 values, 128 bytes): SBO = 1024 bytes from one 8-row
// group to the next, LBO unused.  MN-major (V as B of P V): SBO = 1024
// bytes from one group of 8 keys to the next, LBO = the distance to the
// next 64 columns (the tile's next box).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_ACC64 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
    "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define WG_REGS64 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

#define WG_ACC32 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define WG_REGS32 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 128, fp32) (+)= A (64 x 16) B (16 x 128), both from shared memory,
// K-major; scale_d = 0 overwrites d
#define WGMMA_SS_N128(TY)                                                     \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"                 \
               " wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
               WG_REGS64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"                    \
               : WG_ACC64 : "l"(da), "l"(db), "r"(scale_d))

// d (64 x N, fp32) += A (64 x 16, four registers of two 16-bit values)
// B (16 x N) from shared memory, MN-major (transpose bit set)
#define WGMMA_RS_N128(TY)                                                     \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"                 \
               " wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
               WG_REGS64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"      \
               : WG_ACC64 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),       \
                 "l"(db), "r"(1))
#define WGMMA_RS_N64(TY)                                                      \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"                 \
               " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "   \
               WG_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"      \
               : WG_ACC32 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),       \
                 "l"(db), "r"(1))

template <typename T> struct Ty;
template <> struct Ty<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void mma_qk(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
    WGMMA_SS_N128("bf16");
  }
  static __device__ __forceinline__ void mma_pv(float (&d)[64],
                                                const uint32_t* a,
                                                uint64_t db) {
    WGMMA_RS_N128("bf16");
  }
  static __device__ __forceinline__ void mma_pv(float (&d)[32],
                                                const uint32_t* a,
                                                uint64_t db) {
    WGMMA_RS_N64("bf16");
  }
};
template <> struct Ty<__half> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void mma_qk(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
    WGMMA_SS_N128("f16");
  }
  static __device__ __forceinline__ void mma_pv(float (&d)[64],
                                                const uint32_t* a,
                                                uint64_t db) {
    WGMMA_RS_N128("f16");
  }
  static __device__ __forceinline__ void mma_pv(float (&d)[32],
                                                const uint32_t* a,
                                                uint64_t db) {
    WGMMA_RS_N64("f16");
  }
};

// ---- the consumer warpgroup's pieces -----------------------------------------
//
// Thread t of a warpgroup (warp w = t / 32, lane) holds, of a 64 x N fp32
// accumulator, rows r0 = 16 w + lane / 4 and r0 + 8, columns
// 8 n + 2 (lane % 4) + {0, 1}: register 4 n + 2 i + j is (r0 + 8 i,
// 8 n + 2 (lane % 4) + j).

// S (64 x 128) = Q[rows 64 wg ..] K^T from the staged tiles
template <typename T, int D>
__device__ __forceinline__ void qk_product(float (&s)[64], uint32_t q_tile,
                                           uint32_t k_tile, int wg) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    Ty<T>::mma_qk(s, sw128_desc(q_tile + off + wg * 64 * 128, 16, 1024),
                  sw128_desc(k_tile + off, 16, 1024), kk > 0);
  }
  wg_commit();
  wg_wait_all();
  reg_fence(s);
}

// O (64 x D) += P V, P packed as A fragments: p[4 kk + r] for keys
// 16 kk .. 16 kk + 15
template <typename T, int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&p)[32],
                                           uint32_t v_tile) {
  reg_fence(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    Ty<T>::mma_pv(o, &p[4 * kk],
                  sw128_desc(v_tile + kk * 16 * 128, kBoxBytes, 1024));
  wg_commit();
  wg_wait_all();
  reg_fence(o);
}

// the accumulator of score columns 16 kk .. 16 kk + 15 (n8 slices 2 kk and
// 2 kk + 1) is the A fragment of k16 step kk
template <typename T>
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&p)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = Ty<T>::pack(s[2 * i], s[2 * i + 1]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  T* __restrict__ o, int S, int group, float scale_log2,
                  int n_tiles) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_tile = base + L::kQ, bar = base + L::kBar;
  const int bh = blockIdx.x;
  const int tile = n_tiles - 1 - (int)blockIdx.y;    // heaviest first
  const int q0 = tile * kBQ;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(bar, s), 1);
      mbar_init(bar_empty(bar, s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring filled ----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      const int bkv = bh / group;
      mbar_expect_tx(bar, L::kTile);
#pragma unroll
      for (int h = 0; h < D / kBoxCols; ++h)
        tma_load(q_tile + h * kBoxBytes, &qmap, bar, h * kBoxCols, q0, bh);
      for (int kt = 0; kt <= tile; ++kt) {
        const int s = kt % kStages;
        mbar_wait(bar_empty(bar, s), ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full(bar, s), 2 * L::kTile);
        const uint32_t k_tile = base + L::kK + s * L::kTile;
        const uint32_t v_tile = base + L::kV + s * L::kTile;
#pragma unroll
        for (int h = 0; h < D / kBoxCols; ++h) {
          tma_load(k_tile + h * kBoxBytes, &kmap, bar_full(bar, s),
                   h * kBoxCols, kt * kBK, bkv);
          tma_load(v_tile + h * kBoxBytes, &vmap, bar_full(bar, s),
                   h * kBoxCols, kt * kBK, bkv);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r0 = (t / 32) * 16 + lane / 4;        // and r0 + 8
    const int c0 = 2 * (lane % 4);
    const float neg_inf = -__int_as_float(0x7f800000);
    float acc[D / 2], s[64], m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;

    mbar_wait(bar, 0);
    for (int kt = 0; kt <= tile; ++kt) {
      const int st = kt % kStages;
      mbar_wait(bar_full(bar, st), (kt / kStages) & 1);
      qk_product<T, D>(s, q_tile, base + L::kK + st * L::kTile, wg);

      if (kt == tile) {            // the diagonal tile: keys after the row
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              if (8 * n + c0 + j > wg * 64 + r0 + 8 * i)
                s[4 * n + 2 * i + j] = neg_inf;
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = neg_inf;
#pragma unroll
        for (int n = 0; n < 16; ++n)
          mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx * scale_log2);
        corr[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float e = exp2f(fmaf(s[4 * n + 2 * i + j], scale_log2,
                                       -m_new));
            s[4 * n + 2 * i + j] = e;
            sum += e;
          }
        l[i] = l[i] * corr[i] + sum;
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[4 * n + 2 * i] *= corr[i];
          acc[4 * n + 2 * i + 1] *= corr[i];
        }
      pack_p<T>(s, p);
      pv_product<T, D>(acc, p, base + L::kV + st * L::kTile);
      if (lane == 0) mbar_arrive(bar_empty(bar, st));   // per warp
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int row = q0 + wg * 64 + r0 + 8 * i;
      if (row >= S) continue;
      const float inv = 1.f / l[i];
      T* orow = o + ((size_t)bh * S + row) * D + c0;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) = Ty<T>::pack(
            acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
    }
  }
}

// ---- host ---------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the CUDA driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (D, S, rows) map of a contiguous (rows, S, D) tensor, boxes of 64
// columns x 128 rows x 1, 128-byte swizzle, zeros outside
CUresult make_map(EncodeTiled encode, CUtensorMap* map,
                  CUtensorMapDataType type, const void* ptr, int rows, int S,
                  int D) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {kBoxCols, kBK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int BH,
             int BHKV, int S, float scale, void* stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  CUtensorMap qm, km, vm;
  CUresult r = make_map(encode, &qm, Ty<T>::kMap, q, BH, S, D);
  if (r == CUDA_SUCCESS) r = make_map(encode, &km, Ty<T>::kMap, k, BHKV, S, D);
  if (r == CUDA_SUCCESS) r = make_map(encode, &vm, Ty<T>::kMap, v, BHKV, S, D);
  if (r != CUDA_SUCCESS) return 100000 + (int)r;
  const int bytes = Smem<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      attn_wgmma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (S + kBQ - 1) / kBQ;
  const dim3 grid(BH, n_tiles);
  attn_wgmma_kernel<T, D><<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      qm, km, vm, (T*)o, S, BH / BHKV, scale * 1.4426950408889634f, n_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int BHKV, int S, int D, float scale, void* stream) {
  if (D == 64) return launch_d<T, 64>(q, k, v, o, BH, BHKV, S, scale, stream);
  if (D == 128)
    return launch_d<T, 128>(q, k, v, o, BH, BHKV, S, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, one symbol per storage type.  Pointers are device
// pointers, 16-byte aligned, to contiguous q, o (BH, S, D) and k, v
// (BHKV, S, D); the wrapper (kernels/flash_attention.py) checks D in
// {64, 128}, BHKV dividing BH, 1 <= S with ceil(S / 128) <= 65535, and
// passes scale = 1/sqrt(D).  Each returns 0 on success, -1 when the
// CUDA driver's cuTensorMapEncodeTiled cannot be reached, 100000 + the
// CUresult when a tensor map is refused, else cudaGetLastError() after
// the launch.
#define FLASH_WGMMA_API(SUFFIX, T)                                            \
  extern "C" int flash_attn_wgmma_##SUFFIX(const void* q, const void* k,     \
                                           const void* v, void* o, int BH,   \
                                           int BHKV, int S, int D,           \
                                           float scale, void* stream) {      \
    return launch<T>(q, k, v, o, BH, BHKV, S, D, scale, stream);             \
  }

FLASH_WGMMA_API(bf16, __nv_bfloat16)
FLASH_WGMMA_API(f16, __half)
