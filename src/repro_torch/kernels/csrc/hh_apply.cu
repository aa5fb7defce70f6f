// Compact-WY apply for Hopper (sm_90a): per slot s,
//
//     C[s] <- C[s] - V[s] (T[s] (V[s]^T C[s])),
//     v (S, m, k), t (S, k, k), c (S, m, w), in place on c.
//
// Replaces the TPU kernel tape_apply_pallas (src/repro/kernels/hh_apply.py:56)
// and its single-slot view hh_block_apply_pallas (:33).  Plain version:
// tape_apply_ref in src/repro_torch/kernels/ref.py.  Callers: the stage-1 QR
// trailing update (S = B, C the trailing block of the padded matrix, k = nb),
// the stage-1 tape replay (S = B, C the accumulator rows at and below the
// panel's first pivot, k = nb) and the chase tape replay (S = B*G*K slots,
// m = tw+1, k = 1, C rows picked by a row table out of the padded
// accumulators).
//
// Addressing.  V and C are strided views: element (s, r, j) of V is
// v[s*v_ss + r*v_rs + j]; row r of slot s of C is c + s*c_ss + r*c_rs, or,
// with a row table (int32, spm x m), row rows[(s % spm)*m + r] of matrix
// s / spm of the accumulator c (that matrix at c + (s / spm)*c_ss).  A table
// row outside [0, R) is read as zeros and never written, so the kernels touch
// no memory outside the accumulator.  T is contiguous (S, k, k).  The
// innermost stride is 1 (the wrapper checks it).  Where every row of an
// operand starts on 16 bytes (vec_v, vec_c) its tiles are staged with 16-byte
// cp.async copies; else one element at a time (the same kernels, chosen by
// the wrapper).
//
// What bounds it on the H100, and what the design does about it.
//
// * The large-m path (stage 1: m, w up to n, k = nb).  At the panel shape
//   (1, 4224, 64, 4224) fp64, C is 142.7 MB and the products 4.6 GFLOP: one
//   read and one write of C take 85.9 us at 3.35 TB/s, the products 69 us on
//   the fp64 tensor cores (67 TFLOP/s) and 135 us on scalar FMAs.  So the
//   products run on fp64 mma.sync in the sm_90 shape m16n8k8, and staging
//   overlaps them.  C is read twice and written once (128 us of bytes): a
//   one-pass design would hold a whole column stripe (m rows) on chip
//   across a cluster; two passes keep every block independent and the grid
//   full at any m.  Three kernels, one stream, so every read of pass 1 ends
//   before any write of pass 2:
//     1. tape_apply_kernel_w1: partial W1 = V^T C over a split of the m rows,
//        grid (slot, column tile, split), 8 warps side by side over 128
//        columns.  Each block streams its rows through a 2-stage cp.async
//        ring (32 rows of V and of C per stage, two blocks per SM) and
//        accumulates a (KP x 128) tile in registers; the splits (a number
//        that depends on m, k, w only, never on S) go to a scratch buffer.
//     2. tape_apply_kernel_t: sums the splits in index order (several in
//        flight) and forms W2 = T W1 once per (slot, 32 columns), T held in
//        shared memory, into a second scratch buffer.
//     3. tape_apply_kernel_update: each block owns a 64 x 64 tile of C,
//        stages its V tile and W2 tile (two cp.async groups, one per half of
//        k, so the second half lands while the first is multiplied), loads
//        its C tile straight into the product's accumulators and writes
//        C - V W2 once.
//   Measured on the H100 at the panel shape: kernel 1 is bound by its
//   staging (C from device memory and V again for every column tile, from
//   L2), kernel 3 by C's read and write; the products, timed alone, take
//   about half of kernel 1.
//   fp32 and bf16 take the same tiling with FMA micro-tiles in the same
//   fragment layout (no TF32: it is not fp32).
// * The small-m path (the chase replay: m = tw+1 <= 64, k <= 16).  At
//   (128, 16, 1, 4096) fp64 it moves 134 MB for 0.07 GFLOP: bytes, 40 us.
//   One kernel, tape_apply_kernel_small: a block looks its m rows up once,
//   then walks a run of 128-column tiles of one slot's C, the next tile
//   loading (cp.async) while each thread forms its column's W1, W2 and
//   C - V W2 in registers and writes the tile once.  The run's length
//   makes one wave of resident blocks.  One launch per call, since the
//   replay runs 65k calls from the host.
//
// No floating-point atomics: every sum runs in a fixed order, so results
// are bitwise the same from run to run and do not depend on S.  fp64 stays
// fp64; fp32 and bf16 accumulate in fp32, and bf16 is rounded once, at the
// store.  The kernels launch on the caller's stream and allocate nothing:
// the wrapper passes the scratch buffers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <type_traits>

namespace {

template <typename T> struct AccOf { using type = T; };
template <> struct AccOf<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_acc(typename AccOf<T>::type x);
template <> __device__ __forceinline__ double from_acc<double>(double x) {
  return x;
}
template <> __device__ __forceinline__ float from_acc<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ double fma_acc(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_acc(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

template <typename T> __device__ __forceinline__ T zero() {
  return from_acc<T>(typename AccOf<T>::type(0));
}

struct Args {
  const void* v;
  long long v_ss, v_rs;       // V: slot and row strides, elements
  const void* t;              // T: contiguous (S, k, k)
  void* c;
  long long c_ss, c_rs;       // C (or the accumulator): slot and row strides
  const int* rows;            // null, or the row table (spm, m)
  int spm, R;                 // slots per matrix, rows of the accumulator
  int S, m, k, w;
  int vec_v, vec_c;           // 16-byte staging of V, of C
  void* part;                 // large path: W1 splits (nsplit, S, KP, wp)
  void* w2;                   // large path: W2 (S, KP, wp)
  int wp, nsplit, rows_per_split;
  int tiles_per_block;        // small path: column tiles of one block
};

// Row r of slot s of C; null when a table row lies outside [0, R).
template <typename T>
__device__ __forceinline__ T* c_row(const Args& a, int s, int r) {
  T* base = static_cast<T*>(a.c);
  if (a.rows == nullptr)
    return base + (long long)s * a.c_ss + (long long)r * a.c_rs;
  const int row = a.rows[(s % a.spm) * a.m + r];
  if (row < 0 || row >= a.R) return nullptr;
  return base + (long long)(s / a.spm) * a.c_ss + (long long)row * a.c_rs;
}

__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [0, nr) x columns [0, NCOLS) of a tile into shared memory dst
// (row stride ld): element (r, j) is rowptr(r)[col0 + j] when r < vr, the row
// pointer is not null and col0 + j < vc, else zero.  NCOLS * sizeof(T) is a
// multiple of 16.  vec: 16-byte cp.async copies (rows and col0 16-byte
// aligned; a copy past vc reads only what lies before it and zero-fills the
// rest), else plain element loads and stores.  A thread keeps one column of
// chunks, so its row pointers advance by a constant step.
template <typename T, int NTHREADS, int NCOLS, typename RowPtr>
__device__ __forceinline__ void stage(T* dst, int ld, int nr, int col0,
                                      int vr, int vc, bool vec,
                                      RowPtr rowptr, const void* any) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    constexpr int CPR = NCOLS / E;               // chunks per row
    static_assert(NTHREADS % CPR == 0 || CPR % NTHREADS == 0, "");
    if constexpr (CPR <= NTHREADS) {
      constexpr int STEP = NTHREADS / CPR;       // rows per pass
      const int j = (threadIdx.x % CPR) * E;
      const int left = vc - (col0 + j);
      const int bytes =
          left <= 0 ? 0 : left >= E ? 16 : left * (int)sizeof(T);
      for (int r = threadIdx.x / CPR; r < nr; r += STEP) {
        const T* src = r < vr ? rowptr(r) : nullptr;
        const int b = src == nullptr ? 0 : bytes;
        cp16(dst + r * ld + j,
             b ? static_cast<const void*>(src + col0 + j) : any, b);
      }
    } else {
      for (int r = 0; r < nr; ++r) {
        const T* src = r < vr ? rowptr(r) : nullptr;
        for (int c = threadIdx.x; c < CPR; c += NTHREADS) {
          const int j = c * E;
          const int left = vc - (col0 + j);
          const int b = (src == nullptr || left <= 0)
                            ? 0 : left >= E ? 16 : left * (int)sizeof(T);
          cp16(dst + r * ld + j,
               b ? static_cast<const void*>(src + col0 + j) : any, b);
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < nr * NCOLS; i += NTHREADS) {
      const int r = i / NCOLS;
      const int j = i - r * NCOLS;
      const T* src = r < vr ? rowptr(r) : nullptr;
      dst[r * ld + j] = (src != nullptr && col0 + j < vc) ? src[col0 + j]
                                                          : zero<T>();
    }
  }
}

// fp64 tensor-core product of one warp in the sm_90 shape, D (16x8) +=
// A (16x8) B (8x8).  Lane (g, t) = (lane / 4, lane % 4) holds A[g + 8h][t + 4q]
// in a[h + 2q], B[t + 4q][g] in b[q] and D[g + 8h][2t + e] in dh[e].
__device__ __forceinline__ void dmma(double (&d0)[2], double (&d1)[2],
                                     const double (&a)[4],
                                     const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d0[0]), "+d"(d0[1]), "+d"(d1[0]), "+d"(d1[1])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// One warp's (8 MT x 8 NT) tile, D += sign * A B over kk in [k0, k1), both
// operands in shared memory: A(r, kk) = AT ? As[kk*lda + r] : As[r*lda + kk],
// B(kk, c) = Bs[kk*ldb + c].  Lane (g, t) owns D[8i + g][8j + 2t + e], the
// layout of the fp64 mma, whatever the type.  fp64 runs on the tensor cores,
// 16 rows at a time (MT even; k0, k1 multiples of 8); fp32 and bf16 on FMAs,
// kk in order.
template <int MT, int NT, bool AT, typename Acc, typename TA, typename TB>
__device__ __forceinline__ void warp_product(Acc (&d)[MT][NT][2],
                                             const TA* As, int lda,
                                             const TB* Bs, int ldb, int k0,
                                             int k1, Acc sign) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  if constexpr (std::is_same<Acc, double>::value) {
    static_assert(MT % 2 == 0, "the fp64 product takes 16-row tiles");
    for (int kk = k0; kk < k1; kk += 8) {
      double bv[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          bv[j][q] = Bs[(kk + t + 4 * q) * ldb + 8 * j + g];
#pragma unroll
      for (int i = 0; i < MT / 2; ++i) {
        double av[4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int r = 16 * i + 8 * h + g, c = kk + t + 4 * q;
            av[h + 2 * q] = sign * (AT ? As[c * lda + r] : As[r * lda + c]);
          }
#pragma unroll
        for (int j = 0; j < NT; ++j)
          dmma(d[2 * i][j], d[2 * i + 1][j], av, bv[j]);
      }
    }
  } else {
    for (int kk = k0; kk < k1; ++kk) {
      float av[MT], bv[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        av[i] = sign * to_acc(AT ? As[kk * lda + 8 * i + g]
                                 : As[(8 * i + g) * lda + kk]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        bv[j][0] = to_acc(Bs[kk * ldb + 8 * j + 2 * t]);
        bv[j][1] = to_acc(Bs[kk * ldb + 8 * j + 2 * t + 1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          d[i][j][0] = fma_acc(av[i], bv[j][0], d[i][j][0]);
          d[i][j][1] = fma_acc(av[i], bv[j][1], d[i][j][1]);
        }
    }
  }
}

// Row stride (elements) of a shared-memory tile of `cols` columns: rows on
// 16 bytes, and the stride in bytes 32 mod 128 (8-byte elements: the fp64
// fragments' 16 lanes of a half warp hit 32 distinct banks) or 16 mod 128
// (4- and 2-byte elements: the 8 rows an FMA step reads hit 8 banks).
template <typename T> __host__ __device__ constexpr int pad_ld(int cols) {
  int ld = cols;
  while ((ld * (int)sizeof(T)) % 16 != 0 ||
         (ld * (int)sizeof(T)) % 128 != (sizeof(T) == 8 ? 32 : 16))
    ++ld;
  return ld;
}

// ---- large-m path -------------------------------------------------------

constexpr int kW1Threads = 256;   // 8 warps, side by side along the columns
constexpr int kTK = 32;           // rows of V and C per ring stage
constexpr int kStages = 2;        // depth of the cp.async ring
constexpr int kTThreads = 256;
constexpr int kTCols = 32;        // columns of W2 per block of kernel 2
constexpr int kUThreads = 128;    // 4 warps, 2 x 2 over the tile
constexpr int kTM = 64, kTN = 64; // tile of C of kernel 3

// Columns of W1 per block of kernel 1: 16 a warp (8 at KP = 128), so that a
// warp holds at most 16 fragments of 8 x 8.
__host__ __device__ constexpr int w1_cols(int kp) {
  return kp >= 128 ? 64 : 128;
}

template <typename T, int KP>
__host__ __device__ constexpr int w1_smem() {
  return kStages * kTK * (pad_ld<T>(KP) + pad_ld<T>(w1_cols(KP))) *
         (int)sizeof(T);
}

template <typename T, int KP>
__host__ __device__ constexpr int update_smem() {
  using A = typename AccOf<T>::type;
  return kTM * pad_ld<T>(KP) * (int)sizeof(T) +
         KP * pad_ld<A>(kTN) * (int)sizeof(A);
}

template <typename T, int KP>
__global__ void __launch_bounds__(kW1Threads)
tape_apply_kernel_w1(Args a) {
  using A = typename AccOf<T>::type;
  constexpr int TN = w1_cols(KP);
  constexpr int WARPS = kW1Threads / 32;
  constexpr int MT = KP / 8, NT = TN / WARPS / 8;
  constexpr int LDV = pad_ld<T>(KP), LDC = pad_ld<T>(TN);
  extern __shared__ __align__(16) unsigned char smem[];
  T* vs = reinterpret_cast<T*>(smem);           // [kStages][kTK][LDV]
  T* cs = vs + kStages * kTK * LDV;             // [kStages][kTK][LDC]
  const int s = blockIdx.x, c0 = blockIdx.y * TN, split = blockIdx.z;
  const int r_begin = split * a.rows_per_split;
  const int r_end = min(a.m, r_begin + a.rows_per_split);
  const int ntiles = r_end > r_begin ? (r_end - r_begin + kTK - 1) / kTK : 0;
  const T* V = static_cast<const T*>(a.v) + (long long)s * a.v_ss;

  auto load = [&](int tile, int slot) {
    const int r0 = r_begin + tile * kTK;
    const int vr = min(kTK, r_end - r0);
    stage<T, kW1Threads, KP>(
        vs + slot * kTK * LDV, LDV, kTK, 0, vr, a.k, a.vec_v,
        [&](int r) { return V + (long long)(r0 + r) * a.v_rs; }, a.v);
    stage<T, kW1Threads, TN>(
        cs + slot * kTK * LDC, LDC, kTK, c0, vr, a.w, a.vec_c,
        [&](int r) { return static_cast<const T*>(c_row<T>(a, s, r0 + r)); },
        a.c);
  };

  A d[MT][NT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) d[i][j][0] = d[i][j][1] = A(0);
  const int wc = (threadIdx.x / 32) * (TN / WARPS);

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ntiles) load(i, i);
    cp_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    cp_wait<kStages - 2>();
    __syncthreads();      // tile `it` landed; every warp is done with it - 1
    const int next = it + kStages - 1;
    if (next < ntiles) load(next, next % kStages);
    cp_commit();
    const int slot = it % kStages;
    warp_product<MT, NT, true>(d, vs + slot * kTK * LDV, LDV,
                               cs + slot * kTK * LDC + wc, LDC, 0, kTK, A(1));
  }

  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  A* P = static_cast<A*>(a.part) +
         ((long long)split * a.S + s) * KP * a.wp + c0 + wc;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      A* p = P + (long long)(8 * i + g) * a.wp + 8 * j + 2 * t;
      p[0] = d[i][j][0];
      p[1] = d[i][j][1];
    }
}

template <typename T, int KP>
__host__ __device__ constexpr int t_smem(int k) {
  return (KP * kTCols + k * k) * (int)sizeof(typename AccOf<T>::type);
}

template <typename T, int KP>
__global__ void __launch_bounds__(kTThreads)
tape_apply_kernel_t(Args a) {
  using A = typename AccOf<T>::type;
  constexpr int NG = kTThreads / kTCols, PER = KP / NG;
  extern __shared__ __align__(16) unsigned char smem[];
  A* w1 = reinterpret_cast<A*>(smem);          // [KP][kTCols]
  A* tm = w1 + KP * kTCols;                    // [k][k]
  const int s = blockIdx.x, c0 = blockIdx.y * kTCols;
  const int j = threadIdx.x % kTCols, grp = threadIdx.x / kTCols;
  // W1: the splits summed in index order; thread (grp, j) owns rows
  // grp + NG*q of column j
  const long long plane = (long long)a.S * KP * a.wp;
  const A* P =
      static_cast<const A*>(a.part) + (long long)s * KP * a.wp + c0 + j;
  A acc[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) acc[q] = A(0);
  constexpr int U = PER >= 16 ? 2 : 4;            // splits in flight
  for (int sp0 = 0; sp0 < a.nsplit; sp0 += U) {
    A x[U][PER];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int q = 0; q < PER; ++q)
        x[u][q] = sp0 + u < a.nsplit
                      ? P[(sp0 + u) * plane + (long long)(grp + NG * q) * a.wp]
                      : A(0);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int q = 0; q < PER; ++q)
        if (sp0 + u < a.nsplit) acc[q] += x[u][q];
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) w1[(grp + NG * q) * kTCols + j] = acc[q];
  const T* Tm = static_cast<const T*>(a.t) + (long long)s * a.k * a.k;
  for (int i = threadIdx.x; i < a.k * a.k; i += kTThreads)
    tm[i] = to_acc(Tm[i]);
  __syncthreads();
  // W2 = T W1, each sum over l in order
#pragma unroll
  for (int q = 0; q < PER; ++q) acc[q] = A(0);
  for (int l = 0; l < a.k; ++l) {
    const A x = w1[l * kTCols + j];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int i = grp + NG * q;
      if (i < a.k) acc[q] = fma_acc(tm[i * a.k + l], x, acc[q]);
    }
  }
  A* W2 = static_cast<A*>(a.w2) + (long long)s * KP * a.wp + c0 + j;
#pragma unroll
  for (int q = 0; q < PER; ++q)
    W2[(long long)(grp + NG * q) * a.wp] = acc[q];
}

// two adjacent elements of a row of C, as accumulators, and back
template <typename T>
__device__ __forceinline__ void load_pair(const T* p, int col, int w, bool vec,
                                          typename AccOf<T>::type (&x)[2]) {
  using A = typename AccOf<T>::type;
  if (vec && col + 1 < w) {
    if constexpr (std::is_same<T, double>::value) {
      const double2 q = *reinterpret_cast<const double2*>(p + col);
      x[0] = q.x; x[1] = q.y;
    } else if constexpr (std::is_same<T, float>::value) {
      const float2 q = *reinterpret_cast<const float2*>(p + col);
      x[0] = q.x; x[1] = q.y;
    } else {
      const __nv_bfloat162 q =
          *reinterpret_cast<const __nv_bfloat162*>(p + col);
      x[0] = __low2float(q); x[1] = __high2float(q);
    }
    return;
  }
  x[0] = col < w ? to_acc(p[col]) : A(0);
  x[1] = col + 1 < w ? to_acc(p[col + 1]) : A(0);
}

template <typename T>
__device__ __forceinline__ void store_pair(
    T* p, int col, int w, bool vec, const typename AccOf<T>::type (&x)[2]) {
  if (vec && col + 1 < w) {
    if constexpr (std::is_same<T, double>::value) {
      *reinterpret_cast<double2*>(p + col) = make_double2(x[0], x[1]);
    } else if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float2*>(p + col) = make_float2(x[0], x[1]);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(p + col) =
          __floats2bfloat162_rn(x[0], x[1]);
    }
    return;
  }
  if (col < w) p[col] = from_acc<T>(x[0]);
  if (col + 1 < w) p[col + 1] = from_acc<T>(x[1]);
}

template <typename T, int KP>
__global__ void __launch_bounds__(kUThreads)
tape_apply_kernel_update(Args a) {
  using A = typename AccOf<T>::type;
  constexpr int WM = kTM / 32, WN = kUThreads / 32 / WM;  // warps
  constexpr int MT = 4, NT = kTN / WN / 8;       // a warp's 32 x (kTN / WN)
  constexpr int LDV = pad_ld<T>(KP), LDW = pad_ld<A>(kTN);
  constexpr int KH = KP / 2;
  // two cp.async groups (halves of k) where each half is whole 16-byte rows
  constexpr bool HALVES = (KH * sizeof(T)) % 16 == 0;
  extern __shared__ __align__(16) unsigned char smem[];
  T* vs = reinterpret_cast<T*>(smem);                        // [kTM][LDV]
  A* ws = reinterpret_cast<A*>(smem + kTM * LDV * sizeof(T)); // [KP][LDW]
  const int s = blockIdx.x, c0 = blockIdx.y * kTN, m0 = blockIdx.z * kTM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = (warp / WN) * 32, wc = (warp % WN) * (kTN / WN);
  const T* V = static_cast<const T*>(a.v) + (long long)s * a.v_ss +
               (long long)m0 * a.v_rs;
  const A* W2 = static_cast<const A*>(a.w2) + (long long)s * KP * a.wp;
  const int vr = min(kTM, a.m - m0);
  const int k8 = min(KP, (a.k + 7) / 8 * 8);

  constexpr int NH = HALVES ? 2 : 1;
  constexpr int KC = KP / NH;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    stage<T, kUThreads, KC>(
        vs + h * KC, LDV, kTM, h * KC, vr, a.k, a.vec_v,
        [&](int r) { return V + (long long)r * a.v_rs; }, a.v);
    stage<A, kUThreads, kTN>(
        ws + h * KC * LDW, LDW, KC, c0, KC, a.wp, true,
        [&](int r) { return W2 + (long long)(h * KC + r) * a.wp; }, a.w2);
    cp_commit();
  }

  // the C tile, straight into the accumulators: lane (g, t) holds rows
  // wr + 8i + g and columns wc + 8j + 2t + {0, 1}
  T* crow[MT];
  A d[MT][NT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = m0 + wr + 8 * i + g;
    crow[i] = r < a.m ? c_row<T>(a, s, r) : nullptr;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = c0 + wc + 8 * j + 2 * t;
      if (crow[i] != nullptr) {
        load_pair<T>(crow[i], col, a.w, a.vec_c, d[i][j]);
      } else {
        d[i][j][0] = d[i][j][1] = A(0);
      }
    }
  }

  const T* va = vs + wr * LDV;
  const A* wb = ws + wc;
  if constexpr (NH == 2) {
    cp_wait<1>();
    __syncthreads();
    warp_product<MT, NT, false>(d, va, LDV, wb, LDW, 0, min(KC, k8), A(-1));
    cp_wait<0>();
    __syncthreads();
    warp_product<MT, NT, false>(d, va, LDV, wb, LDW, KC, k8, A(-1));
  } else {
    cp_wait<0>();
    __syncthreads();
    warp_product<MT, NT, false>(d, va, LDV, wb, LDW, 0, k8, A(-1));
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (crow[i] == nullptr) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      store_pair<T>(crow[i], c0 + wc + 8 * j + 2 * t, a.w, a.vec_c, d[i][j]);
  }
}

// ---- small-m path ---------------------------------------------------------

constexpr int kSmallThreads = 128;  // one column of C per thread
constexpr int kSmallK = 16;         // the small path takes k <= 16
constexpr int kSmallM = 64;         // and m <= 64

template <typename T>
__host__ __device__ constexpr int small_tile_bytes(int m) {
  return (m * kSmallThreads * (int)sizeof(T) + 15) / 16 * 16;
}

template <typename T>
__host__ __device__ constexpr int small_smem(int m, int k) {
  return kSmallM * (int)sizeof(void*) + 2 * small_tile_bytes<T>(m) +
         (m * k + k * k) * (int)sizeof(typename AccOf<T>::type);
}

template <typename T>
__global__ void __launch_bounds__(kSmallThreads)
tape_apply_kernel_small(Args a) {
  using A = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = a.m, k = a.k;
  T** rowp = reinterpret_cast<T**>(smem);                   // [m]
  unsigned char* tiles = smem + kSmallM * sizeof(void*);
  T* cs[2] = {reinterpret_cast<T*>(tiles),                  // [m][128] x 2
              reinterpret_cast<T*>(tiles + small_tile_bytes<T>(m))};
  A* vsm = reinterpret_cast<A*>(tiles + 2 * small_tile_bytes<T>(m));
  A* tsm = vsm + m * k;                                      // [k][k]
  const int s = blockIdx.x, j = threadIdx.x;
  // each row's address once (a row table lookup), V and T in shared memory
  if (j < m) rowp[j] = c_row<T>(a, s, j);
  const T* V = static_cast<const T*>(a.v) + (long long)s * a.v_ss;
  for (int i = j; i < m * k; i += kSmallThreads) {
    const int r = i / k;
    vsm[i] = to_acc(V[(long long)r * a.v_rs + (i - r * k)]);
  }
  const T* Tm = static_cast<const T*>(a.t) + (long long)s * k * k;
  for (int i = j; i < k * k; i += kSmallThreads) tsm[i] = to_acc(Tm[i]);
  __syncthreads();

  // column tiles t0 .. t1-1 of 128, the next one loading while this one is
  // applied and written
  const int ntiles = (a.w + kSmallThreads - 1) / kSmallThreads;
  const int t0 = blockIdx.y * a.tiles_per_block;
  const int t1 = min(ntiles, t0 + a.tiles_per_block);
  auto load = [&](int tile, int buf) {
    stage<T, kSmallThreads, kSmallThreads>(
        cs[buf], kSmallThreads, m, tile * kSmallThreads, m,
        a.w, a.vec_c, [&](int r) { return static_cast<const T*>(rowp[r]); },
        a.c);
  };
  if (t0 < t1) load(t0, 0);
  cp_commit();
  for (int tile = t0; tile < t1; ++tile) {
    const int buf = (tile - t0) & 1;
    if (tile + 1 < t1) load(tile + 1, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const T* c = cs[buf];
    A w1[kSmallK], w2[kSmallK];
#pragma unroll
    for (int kk = 0; kk < kSmallK; ++kk) {
      A sum = A(0);
      if (kk < k)
        for (int r = 0; r < m; ++r)
          sum = fma_acc(vsm[r * k + kk], to_acc(c[r * kSmallThreads + j]),
                        sum);
      w1[kk] = sum;
    }
#pragma unroll
    for (int i = 0; i < kSmallK; ++i) {
      A sum = A(0);
      if (i < k) {
#pragma unroll
        for (int l = 0; l < kSmallK; ++l)
          if (l < k) sum = fma_acc(tsm[i * k + l], w1[l], sum);
      }
      w2[i] = sum;
    }
    const int col = tile * kSmallThreads + j;
    if (col < a.w) {
      for (int r = 0; r < m; ++r) {
        A x = to_acc(c[r * kSmallThreads + j]);
#pragma unroll
        for (int kk = 0; kk < kSmallK; ++kk)
          if (kk < k) x = fma_acc(-vsm[r * k + kk], w2[kk], x);
        if (rowp[r] != nullptr) rowp[r][col] = from_acc<T>(x);
      }
    }
    __syncthreads();    // done with cs[buf] before the next load refills it
  }
}

// ---- launches -----------------------------------------------------------

// Blocks of `kernel` the whole card holds at once, at this many threads and
// bytes of shared memory (the last answer is kept: calls repeat shapes).
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, int bytes, int* out) {
  static K last_kernel = nullptr;
  static int last_bytes = -1, last_device = -1, last_out = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (kernel != last_kernel || bytes != last_bytes || dev != last_device) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, threads, bytes)) != cudaSuccess)
      return err;
    last_kernel = kernel;
    last_bytes = bytes;
    last_device = dev;
    last_out = sms * std::max(per_sm, 1);
  }
  *out = last_out;
  return cudaSuccess;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int KP>
int launch_large(const Args& a, cudaStream_t st) {
  cudaError_t err;
  const int s1 = w1_smem<T, KP>(), s2 = t_smem<T, KP>(a.k),
            s3 = update_smem<T, KP>();
  if ((err = allow_smem(tape_apply_kernel_w1<T, KP>, s1)) != cudaSuccess)
    return (int)err;
  if ((err = allow_smem(tape_apply_kernel_t<T, KP>, s2)) != cudaSuccess)
    return (int)err;
  if ((err = allow_smem(tape_apply_kernel_update<T, KP>, s3)) != cudaSuccess)
    return (int)err;
  tape_apply_kernel_w1<T, KP>
      <<<dim3(a.S, a.wp / w1_cols(KP), a.nsplit), kW1Threads, s1, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tape_apply_kernel_t<T, KP>
      <<<dim3(a.S, a.wp / kTCols), kTThreads, s2, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tape_apply_kernel_update<T, KP>
      <<<dim3(a.S, (a.w + kTN - 1) / kTN, (a.m + kTM - 1) / kTM), kUThreads,
         s3, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int kp, cudaStream_t st) {
  switch (kp) {
    case 0: {
      // as many tiles per block as make one wave of resident blocks (the
      // tiling does not change any column's arithmetic)
      const int bytes = small_smem<T>(a.m, a.k);
      cudaError_t err = allow_smem(tape_apply_kernel_small<T>, bytes);
      if (err != cudaSuccess) return (int)err;
      int per_sm = 0;
      if ((err = resident_blocks(tape_apply_kernel_small<T>, kSmallThreads,
                                 bytes, &per_sm)) != cudaSuccess)
        return (int)err;
      const long long tiles = (a.w + kSmallThreads - 1) / kSmallThreads;
      const long long wave = (long long)per_sm;
      Args b = a;
      b.tiles_per_block = (int)std::min<long long>(
          tiles, std::max<long long>(1, (a.S * tiles + wave - 1) / wave));
      tape_apply_kernel_small<T>
          <<<dim3(a.S, (tiles + b.tiles_per_block - 1) / b.tiles_per_block),
             kSmallThreads, bytes, st>>>(b);
      return (int)cudaGetLastError();
    }
    case 16: return launch_large<T, 16>(a, st);
    case 32: return launch_large<T, 32>(a, st);
    case 64: return launch_large<T, 64>(a, st);
    case 128: return launch_large<T, 128>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, one symbol per storage type.  v, t, c are device
// pointers (c updated in place) with the strides above, in elements; rows is
// null or the int32 row table (spm, m) into an accumulator of R rows;
// vec_v, vec_c: every row of V, of C, starts on 16 bytes.  kp
// picks the path: 0 the small-m kernel, else the large-m kernels with W1 and
// W2 padded to kp rows (16, 32, 64 or 128 >= k), nsplit splits of
// rows_per_split rows, scratch part (nsplit, S, kp, wp) and w2 (S, kp, wp) in
// the accumulation type, wp a multiple of 128 >= w.  Chosen by the wrapper
// (kernels/hh_apply.py::launch_shape).  Returns the first non-zero
// cudaGetLastError() of its launches, else 0.
#define HH_API(SUFFIX, T)                                                     \
  extern "C" int tape_apply_##SUFFIX(                                         \
      const void* v, long long v_ss, long long v_rs, const void* t, void* c, \
      long long c_ss, long long c_rs, const int* rows, int spm, int R, int S, \
      int m, int k, int w, int vec_v, int vec_c, int kp, void* part,         \
      void* w2, int wp, int nsplit, int rows_per_split, void* stream) {      \
    Args a{v,     v_ss,  v_rs, t,  c,  c_ss,   c_rs,          rows,         \
           spm,   R,     S,    m,  k,  w,      vec_v,         vec_c,        \
           part,  w2,    wp,   nsplit, rows_per_split, 1};                   \
    return launch<T>(a, kp, static_cast<cudaStream_t>(stream));               \
  }

HH_API(f64, double)
HH_API(f32, float)
HH_API(bf16, __nv_bfloat16)
