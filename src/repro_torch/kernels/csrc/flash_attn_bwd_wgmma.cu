// Causal flash attention, backward, for Hopper (sm_90a) on the tensor
// cores: the gradients dQ, dK, dV of
//
//     o[bh, i] = sum_{j <= i} softmax_j(q[bh, i] . k[bh / g, j] / sqrt(D))
//                v[bh / g, j],
//
// given q, o, dO (BH, S, D) and k, v (BH / g, S, D), contiguous, bf16 or
// fp16, D in {64, 128}:
//
//     LSE_i = log sum_{j <= i} exp(S_ij),  S_ij = q_i . k_j / sqrt(D),
//     D_i = dO_i . O_i,  P_ij = exp(S_ij - LSE_i),
//     dV_j = sum_i P_ij dO_i,  dS_ij = P_ij (dO_i . v_j - D_i),
//     dQ_i = sum_j dS_ij k_j / sqrt(D),  dK_j = sum_i dS_ij q_i / sqrt(D),
//
// dK and dV of KV row bkv summed over the g query rows bh = bkv g + h that
// read it, the results rounded once to the storage type: what
// flash_attn_bwd.cu computes, which keeps fp32 and every other D.
//
// Replaces no TPU kernel: the reference trains through dense attention
// that XLA differentiates (src/repro/models/attention.py:62-93) and has no
// Pallas backward.  Plain version: flash_attention_bwd_ref in
// src/repro_torch/kernels/ref.py.  Caller: ops.flash_attention's
// torch.autograd.Function, for CUDA tensors of bf16 and fp16 at D in {64,
// 128} (flash_attention.bwd_kernel_for).
//
// What bounds it on the H100.  At the training shape of granite-3-2b (q
// (128, 4096, 64), k, v (32, 4096, 64), bf16, g 4) the five products of
// the backward (S, dP, dV, dQ, dK) are 10 D flops a (query, key) pair on or
// below the diagonal, 687 GFLOP, 0.695 ms on the bf16 tensor cores at 989
// TFLOP/s, against 336 MB moved (q, k, v, o, dO read, dQ, dK, dV written),
// 0.10 ms at 3.35 TB/s: the products bound it.  This design does 16 D flops
// a pair (S twice more, and dP twice: once for dQ, once for dK), 1.11 ms at
// the peak, in exchange for two kernels without atomics, so a repeat is
// bit for bit the same.  Every product runs on wgmma with fp32
// accumulators, fed by TMA through an mbarrier ring.  Both kernels run 288
// threads: two consumer warpgroups and one producer warp.  ptxas gives
// every thread of a kernel the same registers, at most 168 when 9 or more
// warps share the SM's four sub-partitions of 16,384 registers (3 on one),
// and setmaxnreg did not raise that budget for the consumers' code (with a
// producer warpgroup and setmaxnreg 240, ptxas still allotted 168 and the
// dkdv kernel spilled 420 bytes at D = 128), so no producer warpgroup is
// kept and the tiles are sized to fit 168:
//   * bwd_dq_wgmma_kernel, one CTA per (query row bh, 128 query rows),
//     heaviest tiles first: the consumer warpgroups own 64 query rows each;
//     one thread of the producer warp issues the TMA loads: Q and dO once,
//     the K (walk 1) or K and V (walk 2) tiles of 64 keys of KV row bh / g
//     into a ring of 3 stages.  Walk 1 rebuilds each row's LSE from S =
//     Q K^T (wgmma m64n64k16, both operands K-major in shared memory) with
//     an online max and sum, as the forward's softmax does, and writes LSE
//     and D_i (dO_i . O_i from global memory, four lanes a row) to an fp32
//     (BH, S) scratch.  Walk 2 issues S = Q K^T and dP = dO V^T together,
//     forms P = exp(S scale - LSE) masked on the diagonal and dS = P (dP -
//     D) in the accumulator's registers, packs dS to the storage type as
//     the A fragment and adds dS K (wgmma m64nDk16, K as B MN-major, the
//     transpose bit) to dQ, which stays in registers (64 x D fp32 a
//     warpgroup) and is scaled and rounded once;
//   * bwd_dkdv_wgmma_kernel, one CTA per (KV row, 128 keys, columns of dK
//     and dV), tile 0 (the most query tiles) first: two consumer
//     warpgroups of 64 keys, K and V loaded once.  The producer warp
//     streams the Q and dO tiles of 64 query rows of the g query rows bh,
//     each from the diagonal down, through a ring of 3 stages; its 32
//     lanes copy the tile's LSE and D from the scratch into the stage and
//     arrive on the stage's full barrier beside the TMA bytes.  Per tile
//     S^T = K Q^T and dP^T = V dO^T together, P^T masked and dS^T = P^T
//     (dP^T - D) column by column, each packed as an A fragment as soon as
//     it is made, then dV += P^T dO and dK += dS^T Q together.  dK and dV
//     stay in registers across the g query rows and their tiles and are
//     stored once.  At D = 128 the whole of dK and dV (128 accumulators a
//     thread beside S^T's and dP^T's 64) spilled over 1 KB, so a CTA keeps
//     one half of D's columns (DkdvCols) and S^T and dP^T are formed once
//     for each half;
//   * the two consumer warpgroups of bwd_dkdv_wgmma_kernel take turns to
//     issue their score products (named barriers 1 and 2), so one's
//     exponentials run beside the other's products (8 % faster on an
//     H100); the same turns made bwd_dq_wgmma_kernel 13 % slower there,
//     and it has none;
//   * every tile is 128-byte swizzled, one box of 64 columns x 64 rows per
//     TMA copy (a 128-row tile is two boxes a column box, a D = 128 tile two
//     column boxes); the tensor maps are 3-D, (D, S, rows), so the ragged
//     edge S % 64 != 0 reads zeros and never the next head's rows, and are
//     made on the host per call with cuTensorMapEncodeTiled, reached
//     through cudaGetDriverEntryPoint (no -lcuda);
//   * a tile of a warpgroup that lies wholly above the diagonal is skipped
//     (its stage still released); the mask is applied only on tiles that
//     cut the diagonal or the ragged edge.
// Not yet here: the LSE saved by the forward (S computed once less), a
// persistent scheduler, 128-row streamed tiles (they need more than 168
// registers a thread: 256 threads, with no producer warp, would allow 255).
//
// Numerics differ from flash_attn_bwd.cu in one place, on purpose: P and dS
// are rounded to the storage type before the products that take them from
// registers (dV += P^T dO, dQ += dS K, dK += dS^T Q), as the forward rounds
// P before P V; the plain version keeps them in fp32.  For bf16 that is a
// relative 2^-9 per weight.  The sums stay fp32.
//
// A wait on an mbarrier that lasts about 2^33 clocks (seconds) traps, so a
// fault in a ring ends the launch with an error instead of hanging the
// card.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 128;            // a CTA's own rows (queries or keys)
constexpr int kSmall = 64;           // a streamed tile's rows
constexpr int kStages = 3;           // the rings
constexpr int kConsumers = 2;        // warpgroups of 64 of a CTA's rows
constexpr int kThreads = 128 * kConsumers + 32;   // and one producer warp
constexpr int kBoxCols = 64;         // 128 bytes of 16-bit values
constexpr int kBoxRows = 64;
constexpr int kBoxBytes = kBoxRows * kBoxCols * 2;
constexpr long long kWaitLimit = 1LL << 33;     // clocks
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// a tile of R rows x D columns in shared memory: D / 64 column boxes, each
// R rows of 128 bytes
template <int D, int R> struct Tile {
  static constexpr int kColBytes = R * 128;
  static constexpr int kBytes = (D / kBoxCols) * kColBytes;
};

// shared memory, in bytes from a 1024-aligned base
template <int D> struct DqSmem {           // Q, dO, K[stages], V[stages]
  static constexpr int kBigT = Tile<D, kBig>::kBytes;
  static constexpr int kSmallT = Tile<D, kSmall>::kBytes;
  static constexpr int kQ = 0;
  static constexpr int kDO = kBigT;
  static constexpr int kK = 2 * kBigT;
  static constexpr int kV = kK + kStages * kSmallT;
  static constexpr int kBar = kV + kStages * kSmallT;
  static constexpr int kAlloc = kBar + 8 * (1 + 2 * kStages) + 1024;
};
template <int D> struct DkdvSmem {  // K, V, Q[st], dO[st], LSE[st], D[st]
  static constexpr int kBigT = Tile<D, kBig>::kBytes;
  static constexpr int kSmallT = Tile<D, kSmall>::kBytes;
  static constexpr int kK = 0;
  static constexpr int kV = kBigT;
  static constexpr int kQ = 2 * kBigT;
  static constexpr int kDO = kQ + kStages * kSmallT;
  static constexpr int kLse = kDO + kStages * kSmallT;
  static constexpr int kDsum = kLse + kStages * kSmall * 4;
  static constexpr int kBar = kDsum + kStages * kSmall * 4;
  static constexpr int kAlloc = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// the barriers: in (the CTA's own tiles), full[stages], empty[stages]
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

// rows r0 .. r0 + R - 1 of head z into a tile of R rows at dst, one TMA
// box of 64 x 64 at a time
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int r0, int z) {
#pragma unroll
  for (int h = 0; h < D / kBoxCols; ++h)
#pragma unroll
    for (int r = 0; r < R / kBoxRows; ++r)
      tma_load(dst + h * Tile<D, R>::kColBytes + r * kBoxBytes, map, bar,
               h * kBoxCols, r0 + r * kBoxRows, z);
}

// ---- wgmma ----------------------------------------------------------------

// A shared-memory matrix descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
// K-major (rows of 64 values, 128 bytes): SBO = 1024 bytes from one 8-row
// group to the next, LBO unused.  MN-major (a streamed tile as B of a
// register-A product): SBO = 1024 bytes from one group of 8 rows to the
// next, LBO = the distance to the next 64 columns (the next column box).
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

// d (64 x 64, fp32) (+)= A (64 x 16) B (16 x 64), both from shared memory,
// K-major; scale_d = 0 overwrites d
#define WGMMA_SS_N64(TY)                                                      \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"                 \
               " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "   \
               WG_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"                    \
               : WG_ACC32 : "l"(da), "l"(db), "r"(scale_d))

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
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  }
  static __device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
    WGMMA_SS_N64("bf16");
  }
  static __device__ __forceinline__ void mma_rs(float (&d)[64],
                                                const uint32_t* a,
                                                uint64_t db) {
    WGMMA_RS_N128("bf16");
  }
  static __device__ __forceinline__ void mma_rs(float (&d)[32],
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
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<__half2*>(&u));
  }
  static __device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
    WGMMA_SS_N64("f16");
  }
  static __device__ __forceinline__ void mma_rs(float (&d)[64],
                                                const uint32_t* a,
                                                uint64_t db) {
    WGMMA_RS_N128("f16");
  }
  static __device__ __forceinline__ void mma_rs(float (&d)[32],
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

// issue d (64 x 64) = A B^T: A rows a_row .. a_row + 63 of a tile of RA
// rows at a_tile, B the streamed tile of 64 rows at b_tile, both K-major
// over D
template <typename T, int D, int RA>
__device__ __forceinline__ void ss_product(float (&d)[32], uint32_t a_tile,
                                           int a_row, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    Ty<T>::mma_ss(d, sw128_desc(a_tile + (kk / 4) * Tile<D, RA>::kColBytes +
                                    a_row * 128 + col, 16, 1024),
                  sw128_desc(b_tile + (kk / 4) * Tile<D, kSmall>::kColBytes +
                                 col, 16, 1024), kk > 0);
  }
}

// issue d (64 x D) += A B: A (64 x 64) packed as A fragments, a[4 kk + r]
// for rows 16 kk .. 16 kk + 15 of B, the streamed tile of 64 rows at
// b_tile, MN-major
template <typename T, int D>
__device__ __forceinline__ void rs_product(float (&d)[D / 2],
                                           const uint32_t (&a)[16],
                                           uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < kSmall / 16; ++kk)
    Ty<T>::mma_rs(d, &a[4 * kk],
                  sw128_desc(b_tile + kk * 16 * 128,
                             Tile<D, kSmall>::kColBytes, 1024));
}

// the accumulator of columns 16 kk .. 16 kk + 15 (n8 slices 2 kk and
// 2 kk + 1) is the A fragment of k16 step kk
template <typename T>
__device__ __forceinline__ void pack_a(const float (&s)[32],
                                       uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = Ty<T>::pack(s[2 * i], s[2 * i + 1]);
}

// rows row0 + r0 + 8 i (< S) of out (rows ld apart) from the 64 x N
// accumulator times mul, rounded once
template <typename T, int N>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[N / 2],
                                           float mul, int row0, int r0,
                                           int c0, int S, int ld) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r0 + 8 * i;
    if (row >= S) continue;
    T* orow = out + (size_t)row * ld + c0;
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) = Ty<T>::pack(
          acc[4 * n + 2 * i] * mul, acc[4 * n + 2 * i + 1] * mul);
  }
}

// Ping-pong of the two consumer warpgroups: warpgroup w issues the score
// products of a tile only after the other warpgroup issued its own, so one
// warpgroup's exponentials and packing run beside the other's products.
// Named barrier 1 + w (256 threads: w's 128 waiting, the other's 128
// arriving) is w's turn.  Both warpgroups pass every tile of a walk, those
// they skip too, so the arrivals match: warpgroup 1 gives the first turn
// (turn_start) and warpgroup 0 takes the last one back (turn_end).
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
}
__device__ __forceinline__ void turn_start(int wg) {
  if (wg == 1) turn_pass(1);
}
__device__ __forceinline__ void turn_end(int wg) {
  if (wg == 0) turn_wait(0);
}

__device__ __forceinline__ void init_barriers(uint32_t bar,
                                              uint32_t full_count) {
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(bar, s), full_count);
      mbar_init(bar_empty(bar, s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// dQ of 128 query rows of row bh, and the rows' LSE and D into the scratch
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    T* __restrict__ dq, float* __restrict__ lse_out,
                    float* __restrict__ dsum_out, int S, int group,
                    float scale, float scale_log2, int n_tiles) {
  using L = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + L::kBar;
  const int bh = blockIdx.x;
  const int tile = n_tiles - 1 - (int)blockIdx.y;    // heaviest first
  const int q0 = tile * kBig;
  // key tiles of 64 up to the diagonal, walked twice
  const int n_keys = min(2 * tile + 2, (S + kSmall - 1) / kSmall);
  const int wg = threadIdx.x / 128;
  init_barriers(bar, 1);

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring filled ----------------------
    if (threadIdx.x == kConsumers * 128) {
      const int bkv = bh / group;
      mbar_expect_tx(bar, 2 * L::kBigT);
      load_tile<D, kBig>(base + L::kQ, &qmap, bar, q0, bh);
      load_tile<D, kBig>(base + L::kDO, &domap, bar, q0, bh);
      for (int it = 0; it < 2 * n_keys; ++it) {
        const int s = it % kStages, kt = it % n_keys;
        const bool walk2 = it >= n_keys;
        mbar_wait(bar_empty(bar, s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full(bar, s), (walk2 ? 2 : 1) * L::kSmallT);
        load_tile<D, kSmall>(base + L::kK + s * L::kSmallT, &kmap,
                             bar_full(bar, s), kt * kSmall, bkv);
        if (walk2)
          load_tile<D, kSmall>(base + L::kV + s * L::kSmallT, &vmap,
                               bar_full(bar, s), kt * kSmall, bkv);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ------------------------------------
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r0 = (t / 32) * 16 + lane / 4;        // and r0 + 8
    const int c0 = 2 * (lane % 4);
    const int row_first = q0 + wg * 64, row_last = row_first + 63;
    const float neg_inf = -__int_as_float(0x7f800000);

    // D_i = dO_i . O_i of rows r0, r0 + 8: four lanes a row, D / 4 columns
    // each, from global memory
    float dsum[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_first + r0 + 8 * i;
      float acc = 0.f;
      if (row < S) {
        const size_t off = ((size_t)bh * S + row) * D + (lane % 4) * (D / 4);
        const uint4* orow = reinterpret_cast<const uint4*>(o + off);
        const uint4* drow = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
        for (int c = 0; c < D / 32; ++c) {
          const uint4 a = orow[c], b = drow[c];
          const uint32_t av[4] = {a.x, a.y, a.z, a.w};
          const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 fa = Ty<T>::unpack(av[e]), fb = Ty<T>::unpack(bv[e]);
            acc = fmaf(fa.x, fb.x, acc);
            acc = fmaf(fa.y, fb.y, acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      dsum[i] = acc;
    }

    float s[32], dp[32], acc[D / 2];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint32_t q_tile = base + L::kQ, do_tile = base + L::kDO;
    mbar_wait(bar, 0);

    // walk 1: each row's LSE by an online max and sum (log2 units)
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
    int it = 0;
    for (int kt = 0; kt < n_keys; ++kt, ++it) {
      const int st = it % kStages, k0 = kt * kSmall;
      mbar_wait(bar_full(bar, st), (it / kStages) & 1);
      if (kt * kSmall <= row_last) {
        reg_fence(s);
        wg_fence();
        ss_product<T, D, kBig>(s, q_tile, wg * 64,
                               base + L::kK + st * L::kSmallT);
        wg_commit();
        wg_wait_all();
        reg_fence(s);
        if (k0 + kSmall - 1 > row_first) {      // the tile cuts the diagonal
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 2; ++j)
                if (k0 + 8 * n + c0 + j > row_first + r0 + 8 * i)
                  s[4 * n + 2 * i + j] = neg_inf;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = neg_inf;
#pragma unroll
          for (int n = 0; n < 8; ++n)
            mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[i], mx * scale_log2);
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              sum += exp2f(fmaf(s[4 * n + 2 * i + j], scale_log2, -m_new));
          l[i] = l[i] * exp2f(m[i] - m_new) + sum;
          m[i] = m_new;
        }
      }
      if (lane == 0) mbar_arrive(bar_empty(bar, st));   // per warp
    }
    float lse2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const float lse = (m[i] + log2f(l[i])) * kLn2;   // natural log
      const int row = row_first + r0 + 8 * i;
      if (lane % 4 == 0 && row < S) {
        lse_out[(size_t)bh * S + row] = lse;
        dsum_out[(size_t)bh * S + row] = dsum[i];
      }
      lse2[i] = lse * kLog2e;          // as bwd_dkdv_wgmma_kernel reads it
    }

    // walk 2: dS and dQ
    for (int kt = 0; kt < n_keys; ++kt, ++it) {
      const int st = it % kStages, k0 = kt * kSmall;
      mbar_wait(bar_full(bar, st), (it / kStages) & 1);
      const bool live_tile = k0 <= row_last;
      if (live_tile) {
        const uint32_t k_tile = base + L::kK + st * L::kSmallT;
        reg_fence(s);
        reg_fence(dp);
        wg_fence();
        ss_product<T, D, kBig>(s, q_tile, wg * 64, k_tile);
        ss_product<T, D, kBig>(dp, do_tile, wg * 64,
                               base + L::kV + st * L::kSmallT);
        wg_commit();
        wg_wait_all();
        reg_fence(s);
        reg_fence(dp);
        const bool diag = k0 + kSmall - 1 > row_first;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int x = 4 * n + 2 * i + j;
              float p = exp2f(fmaf(s[x], scale_log2, -lse2[i]));
              if (diag && k0 + 8 * n + c0 + j > row_first + r0 + 8 * i)
                p = 0.f;
              dp[x] = p * (dp[x] - dsum[i]);
            }
        uint32_t a[16];
        pack_a<T>(dp, a);
        reg_fence(acc);
        wg_fence();
        rs_product<T, D>(acc, a, k_tile);
        wg_commit();
        wg_wait_all();
        reg_fence(acc);
      }
      if (lane == 0) mbar_arrive(bar_empty(bar, st));
    }
    store_rows<T, D>(dq + (size_t)bh * S * D, acc, scale, row_first, r0, c0,
                     S, D);
  }
}

// the columns of dK and dV that one dkdv CTA keeps in registers: all of D
// = 64, half of D = 128 (64 + 64 accumulators a thread beside S^T and
// dP^T; the whole of D = 128 spilled under ptxas's 168 registers a thread)
template <int D> struct DkdvCols {
  static constexpr int kN = D > 64 ? 64 : D;
  static constexpr int kSplit = D / kN;
};

// dK and dV of 128 keys of KV row bkv (columns blockIdx.z * N .. + N - 1,
// N = DkdvCols<D>::kN), summed over its g query rows
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap domap,
                      T* __restrict__ dk, T* __restrict__ dv,
                      const float* __restrict__ lse_in,
                      const float* __restrict__ dsum_in, int S, int group,
                      float scale, float scale_log2) {
  using L = DkdvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* const lse_s = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                                L::kLse);
  float* const dsum_s = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                                 L::kDsum);
  const uint32_t bar = base + L::kBar;
  const int bkv = blockIdx.x;
  const int k0 = (int)blockIdx.y * kBig;  // tile 0 walks the most tiles
  // query tiles of 64 from the first that reaches key k0, for each of the
  // group's query rows
  const int qt0 = k0 / kSmall;
  const int n_qt = (S + kSmall - 1) / kSmall - qt0;
  const int n_iters = group * n_qt;
  const int wg = threadIdx.x / 128;
  init_barriers(bar, 32);

  if (wg == kConsumers) {
    // ---- producer: the warp keeps the ring filled ------------------------
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_expect_tx(bar, 2 * L::kBigT);
      load_tile<D, kBig>(base + L::kK, &kmap, bar, k0, bkv);
      load_tile<D, kBig>(base + L::kV, &vmap, bar, k0, bkv);
    }
    for (int it = 0; it < n_iters; ++it) {
      const int s = it % kStages;
      const int bh = bkv * group + it / n_qt;
      const int row0 = (qt0 + it % n_qt) * kSmall;
      mbar_wait(bar_empty(bar, s), ((it / kStages) & 1) ^ 1);
#pragma unroll
      for (int r = lane; r < kSmall; r += 32) {
        const int row = row0 + r;
        const bool in = row < S;
        lse_s[s * kSmall + r] =
            in ? lse_in[(size_t)bh * S + row] * kLog2e : 0.f;
        dsum_s[s * kSmall + r] = in ? dsum_in[(size_t)bh * S + row] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(bar_full(bar, s), 2 * L::kSmallT);
        load_tile<D, kSmall>(base + L::kQ + s * L::kSmallT, &qmap,
                             bar_full(bar, s), row0, bh);
        load_tile<D, kSmall>(base + L::kDO + s * L::kSmallT, &domap,
                             bar_full(bar, s), row0, bh);
      } else {
        mbar_arrive(bar_full(bar, s));
      }
    }
  } else {
    // ---- consumers: 64 keys each ------------------------------------------
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r0 = (t / 32) * 16 + lane / 4;        // and r0 + 8
    const int c0 = 2 * (lane % 4);
    const int key_first = k0 + wg * 64;
    constexpr int N = DkdvCols<D>::kN;
    const int col_box = blockIdx.z;        // the column box of dK and dV
    float st_[32], dpt[32], dk_acc[N / 2], dv_acc[N / 2];
#pragma unroll
    for (int i = 0; i < 32; ++i) st_[i] = dpt[i] = 0.f;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(bar, 0);
    turn_start(wg);

    for (int it = 0; it < n_iters; ++it) {
      const int s = it % kStages;
      const int row0 = (qt0 + it % n_qt) * kSmall;
      const uint32_t q_tile = base + L::kQ + s * L::kSmallT;
      const uint32_t do_tile = base + L::kDO + s * L::kSmallT;
      // a query of the tile at or after a key of the warpgroup
      const bool live_tile = row0 + kSmall - 1 >= key_first;
      mbar_wait(bar_full(bar, s), (it / kStages) & 1);
      turn_wait(wg);
      if (live_tile) {
        reg_fence(st_);
        reg_fence(dpt);
        wg_fence();
        ss_product<T, D, kBig>(st_, base + L::kK, wg * 64, q_tile);
        ss_product<T, D, kBig>(dpt, base + L::kV, wg * 64, do_tile);
        wg_commit();
      }
      turn_pass(wg);
      if (live_tile) {
        wg_wait_all();
        reg_fence(st_);
        reg_fence(dpt);
        const bool edge = row0 < key_first + 63 || row0 + kSmall > S;
        // P^T and dS^T column by column, each packed as soon as it is made
        uint32_t pa[16], pd[16];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float lc = lse_s[s * kSmall + 8 * n + c0 + j];
            const float dc = dsum_s[s * kSmall + 8 * n + c0 + j];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int x = 4 * n + 2 * i + j;
              const int key = key_first + r0 + 8 * i;
              const int col = row0 + 8 * n + c0 + j;
              float p = exp2f(fmaf(st_[x], scale_log2, -lc));
              if (edge) {
                const bool live = key <= col && col < S;
                if (!live) p = 0.f;
              }
              st_[x] = p;
              dpt[x] = p * (dpt[x] - dc);
            }
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int x = 4 * n + 2 * i;
            pa[2 * n + i] = Ty<T>::pack(st_[x], st_[x + 1]);
            pd[2 * n + i] = Ty<T>::pack(dpt[x], dpt[x + 1]);
          }
        }
        reg_fence(dv_acc);
        reg_fence(dk_acc);
        wg_fence();
        const uint32_t box = col_box * Tile<D, kSmall>::kColBytes;
        rs_product<T, N>(dv_acc, pa, do_tile + box);
        rs_product<T, N>(dk_acc, pd, q_tile + box);
        wg_commit();
        wg_wait_all();
        reg_fence(dv_acc);
        reg_fence(dk_acc);
      }
      if (lane == 0) mbar_arrive(bar_empty(bar, s));   // per warp
    }
    turn_end(wg);
    const size_t kv_base = (size_t)bkv * S * D + col_box * N;
    store_rows<T, N>(dk + kv_base, dk_acc, scale, key_first, r0, c0, S, D);
    store_rows<T, N>(dv + kv_base, dv_acc, 1.f, key_first, r0, c0, S, D);
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
// columns x 64 rows x 1, 128-byte swizzle, zeros outside
CUresult make_map(EncodeTiled encode, CUtensorMap* map,
                  CUtensorMapDataType type, const void* ptr, int rows, int S,
                  int D) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {kBoxCols, kBoxRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, float* lse,
             float* dsum, int BH, int BHkv, int S, float scale,
             cudaStream_t stream) {
  // runtime calls first: they make the device's primary context current
  // on the calling thread (autograd runs the backward on a thread of its
  // own), which cuTensorMapEncodeTiled needs
  const int s1 = DqSmem<D>::kAlloc, s2 = DkdvSmem<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_wgmma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dkdv_wgmma_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s2);
  if (err != cudaSuccess) return (int)err;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  CUtensorMap qm, km, vm, dom;
  CUresult r = make_map(encode, &qm, Ty<T>::kMap, q, BH, S, D);
  if (r == CUDA_SUCCESS) r = make_map(encode, &km, Ty<T>::kMap, k, BHkv, S, D);
  if (r == CUDA_SUCCESS) r = make_map(encode, &vm, Ty<T>::kMap, v, BHkv, S, D);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &dom, Ty<T>::kMap, dout, BH, S, D);
  if (r != CUDA_SUCCESS) return 100000 + (int)r;
  const int n_tiles = (S + kBig - 1) / kBig;
  const float scale_log2 = scale * kLog2e;
  bwd_dq_wgmma_kernel<T, D><<<dim3(BH, n_tiles), kThreads, s1, stream>>>(
      qm, km, vm, dom, (const T*)o, (const T*)dout, (T*)dq, lse, dsum, S,
      BH / BHkv, scale, scale_log2, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv_wgmma_kernel<T, D>
      <<<dim3(BHkv, n_tiles, DkdvCols<D>::kSplit), kThreads, s2, stream>>>(
      qm, km, vm, dom, (T*)dk, (T*)dv, lse, dsum, S, BH / BHkv, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* dsum, int BH, int BHkv, int S, int D, float scale,
           void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv || S <= 0 ||
      (S + kBig - 1) / kBig > 65535)
    return (int)cudaErrorInvalidValue;
  float* fl = static_cast<float*>(lse);
  float* fd = static_cast<float*>(dsum);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_d<T, 64>(q, k, v, o, dout, dq, dk, dv, fl, fd, BH, BHkv, S,
                           scale, st);
  if (D == 128)
    return launch_d<T, 128>(q, k, v, o, dout, dq, dk, dv, fl, fd, BH, BHkv,
                            S, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, one symbol per storage type, the arguments of
// flash_attn_bwd.cu's entries.  Pointers are device pointers, 16-byte
// aligned, to contiguous q, o, dout (BH, S, D) and k, v (BHkv, S, D) and
// the results dq, dk, dv of the same shapes, and the fp32 scratch lse,
// dsum (BH, S), all allocated by the caller (kernels/flash_attention.py,
// which checks D in {64, 128} and passes scale = 1/sqrt(D)).  Each returns
// 0 on success, -1 when the CUDA driver's cuTensorMapEncodeTiled cannot be
// reached, 100000 + the CUresult when a tensor map is refused, else a CUDA
// error code (cudaGetLastError() after each launch).
#define FLASH_BWD_WGMMA_ENTRY(suffix, T)                                     \
  extern "C" int flash_attn_bwd_wgmma_##suffix(                              \
      const void* q, const void* k, const void* v, const void* o,            \
      const void* dout, void* dq, void* dk, void* dv, void* lse, void* dsum, \
      int BH, int BHkv, int S, int D, float scale, void* stream) {           \
    return launch<T>(q, k, v, o, dout, dq, dk, dv, lse, dsum, BH, BHkv, S,  \
                     D, scale, stream);                                      \
  }

FLASH_BWD_WGMMA_ENTRY(bf16, __nv_bfloat16)
FLASH_BWD_WGMMA_ENTRY(f16, __half)
