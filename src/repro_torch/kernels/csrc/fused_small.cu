// Fused small-n SVD for Hopper (sm_90a): the whole per-matrix pipeline in
// one launch (kernel 5).
//
// Replaces the TPU kernel fused_small_svd_pallas (src/repro/kernels/
// fused_small.py:266, bodies _values_kernel / _uv_kernel).  Plain version:
// fused_small_svd_ref in src/repro_torch/kernels/ref.py, whose fused_walk
// lists the same reflectors in the same order as the loops below;
// ref.fused_reduce_band runs them on this kernel's storage, in plain torch.
//
// One block per matrix, grid (B,).  Per matrix:
//   phase 1  dense -> upper band(bw): for j < n-1 a left reflector on column
//            j (rows [j, n-1]), then a right one on row j (cols [j+bw, n-1]);
//   phase 2  one SBR stage b_in = bw, tw = bw-1: for each sweep R and cycle
//            jc, pivot p = R+1+jc*bw, a right reflector on row r (R on the
//            sweep's first cycle, p-bw after) over [p, hi], then a left one
//            on column p over [p, hi], hi = min(p+bw-1, n-1);
//   phase 3  values mode: Sturm bisection on the Golub-Kahan tridiagonal,
//            sigma written descending; uv mode writes (d, e, U2, V2^T)
//            instead, and the caller composes the vectors with the staged
//            stage 3.
// A reflector whose support has one entry or none is a tau = 0 no-op in
// the reference; the walk leaves it out.
//
// What bounds it on the H100: neither bytes nor the flop rate but the chain
// of (2n + 2n^2/bw) reflectors of a matrix, each reading what the one before
// it wrote, and the bisection's chains of 2n-1 dependent divisions.  The
// design shortens each link of the chain:
//   * The working set lives in shared memory (tuning.fused_route lays it
//     out and counts its bytes; the wrapper launches with exactly that
//     many).  Phase 2 holds the band and its bulge, diagonals -(bw-1) ..
//     2bw-1, diagonal-major as core/band.py stores a band.  Phase 1 runs on
//     the trailing block A[j:, j:], in device memory (coalesced: lanes on
//     consecutive columns) until it fits, from column j0 on in shared
//     memory; the finished rows go to the band through device memory once
//     phase 1 ends.  In uv mode U2 and V2 (the transpose of V2^T) sit beside
//     them where they fit, else in device memory.  Shapes whose band does
//     not fit run the "global" route: every phase on the matrix in device
//     memory.
//   * Each reflector acts on its nonzeros only: a right one on row k over
//     [lo, hi] meets rows [k, hi], a left one on column lo over [lo, hi]
//     meets columns [lo, min(hi+bw, n-1)]; every other entry it would touch
//     is an exact zero (tests/test_torch_fused_layout.py walks the
//     reference's shapes).  U2 and V2 are dense and get all n lines.
//   * Every busy warp builds the same reflector (larfg: the formulas of
//     householder.make_reflector with the tail scaled by one reciprocal,
//     as LAPACK's dlarfg) from the pivot line, G lanes a line (a butterfly
//     sum leaves every group with the same bits), so nothing separates
//     building it from the dot products: each group of G lanes then takes
//     one line (a row of a right reflector, a column of a left one), sums
//     its dot product by shuffles and updates the line from the registers
//     it read it into.  Warp 0, which owns the pivot line, writes its fix
//     (beta at lo, exact zeros after, as ref._fix_row / _fix_col) after a
//     named barrier the other busy warps only arrive at; warps that hold
//     no line skip the reflector; one block barrier ends it.  On the
//     matrix in device memory, left reflectors (partial sums over parts of
//     the support, lanes on consecutive columns) and supports longer than
//     32 lanes hold take a general path with v in shared memory and two or
//     three barriers.
//   * Phase 3 is the schedule of csrc/sturm.cu inside the launch, its device
//     code shared through csrc/sturm_device.cuh: the tree's top counted once
//     per matrix, then s levels a round over groups of 2^s lanes (s picked
//     on the host, fused_small.bisect_schedule), every midpoint the
//     sequential bisection's, so sigma is bit for bit bisect_plain's on the
//     same (d, e).
// One block per matrix leaves SMs idle when B < 132.  Half types work in
// float and are rounded once, at the store.  Build without
// --use_fast_math: the tau = 0 test on an exact zero tail and the fp64
// tolerances need IEEE division, square root and subnormals.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "sturm_device.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 8;        // support entries a lane holds (fast path)
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct AccOf { using type = T; };
template <> struct AccOf<__nv_bfloat16> { using type = float; };

__device__ inline double to_acc(double x) { return x; }
__device__ inline float to_acc(float x) { return x; }
__device__ inline float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ inline T from_acc(typename AccOf<T>::type x);
template <> __device__ inline double from_acc<double>(double x) { return x; }
template <> __device__ inline float from_acc<float>(float x) { return x; }
template <> __device__ inline __nv_bfloat16 from_acc<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ inline double sqrt_acc(double x) { return sqrt(x); }
__device__ inline float sqrt_acc(float x) { return sqrtf(x); }
__device__ inline double abs_acc(double x) { return fabs(x); }
__device__ inline float abs_acc(float x) { return fabsf(x); }

// Power-of-two prescale of max|z| (1 for zero): 2**round_half_even(log2 zmax).
__device__ inline double pow2_scale(double zmax) {
  return zmax > 0.0 ? ldexp(1.0, (int)rint(log2(zmax))) : 1.0;
}
__device__ inline float pow2_scale(float zmax) {
  return zmax > 0.f ? ldexpf(1.f, (int)rintf(log2f(zmax))) : 1.f;
}

template <typename A>
__device__ A warp_max(A x) {
  for (int o = 16; o > 0; o >>= 1) {
    const A y = __shfl_xor_sync(kFull, x, o);
    x = y > x ? y : x;
  }
  return x;
}

// named barrier 1 over the first `count` threads (a multiple of 32): warp
// 0 waits there, the other warps only arrive
__device__ __forceinline__ void bar_sync_1(int count) {
  asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive_1(int count) {
  asm volatile("bar.arrive 1, %0;" ::"r"(count) : "memory");
}

// ---- storage of the working matrix --------------------------------------
//
// Each storage gives the offset of A[i, j] from its base pointer p, and, for
// a reflector's side, the step between consecutive entries of a line's
// support (a row's columns for a right reflector, a column's rows for a
// left one), so that a lane walks its entries by one multiply-add each.

// row-major with origin (o, o): the whole matrix in device memory (o = 0,
// ld = n) or the trailing block A[o:, o:] in shared memory
template <typename A, bool Global>
struct Dense {
  static constexpr bool kGlobal = Global;
  A* p;
  int ld, o;
  __device__ __forceinline__ int off(int i, int j) const {
    return (i - o) * ld + (j - o);
  }
  template <bool Right>
  __device__ __forceinline__ int step() const { return Right ? 1 : ld; }
};

// the band in shared memory, diagonal-major: A[i, j] at (j - i + dlo, j)
template <typename A>
struct Band {
  static constexpr bool kGlobal = false;
  A* p;
  int ld, dlo;
  __device__ __forceinline__ int off(int i, int j) const {
    return (j - i + dlo) * ld + j;
  }
  template <bool Right>
  __device__ __forceinline__ int step() const { return Right ? ld + 1 : -ld; }
};

// U2 and V2 (V2^T transposed), row-major: a reflector's support is a run of
// consecutive entries of every row
template <typename A>
struct Rows {
  A* p;
  int ld;
};

// A reflector and its lines: a right one on row k over columns [lo, hi]
// meets rows [k, hi]; a left one on column lo over rows [lo, hi] meets
// columns [lo, min(hi + bw, n - 1)].  Line lbeg is the pivot line.
struct Refl {
  int k, lo, hi, lbeg, lend;
};

__device__ __forceinline__ Refl make_refl(bool right, int k, int lo, int hi,
                                          int n, int bw) {
  return {k, lo, hi, right ? k : lo,
          right ? hi : min(hi + bw, n - 1)};
}

// offset of support entry 0 of line l
template <bool Right, typename Mat>
__device__ __forceinline__ int line_off(const Mat& m, const Refl& r, int l) {
  return Right ? m.off(l, r.lo) : m.off(r.lo, l);
}

template <typename A>
struct House {
  A tau, beta, scale;        // v = x * scale past its first entry
  bool act;                  // tau != 0
};

// larfg's scalars from alpha and the sum of squares of the tail: the
// formulas of householder.make_reflector, except that the tail is scaled
// by one reciprocal 1 / (alpha - beta), as LAPACK's dlarfg does, where the
// plain version divides each entry
template <typename A>
__device__ __forceinline__ House<A> house(A alpha, A s) {
  const A mu = sqrt_acc(alpha * alpha + s);
  const A beta = alpha >= A(0) ? -mu : mu;
  const bool safe = s > A(0);
  House<A> h;
  h.tau = safe ? (beta - alpha) / (beta == A(0) ? A(1) : beta) : A(0);
  h.beta = beta;
  h.act = h.tau != A(0);
  h.scale = h.act ? A(1) / (alpha - beta) : A(0);
  return h;
}

__device__ __forceinline__ int pow2_ceil(int x) {
  return x <= 1 ? 1 : 1 << (32 - __clz(x - 1));
}
__device__ __forceinline__ int pow2_floor(int x) {
  return 1 << (31 - __clz(x));
}

// lanes per line: few enough that one pass over the M lines keeps the block
// busy, no more than the support needs, and enough that no lane holds more
// than kPerLane entries (above 32: the general path)
__device__ __forceinline__ int group_lanes(int L, int M) {
  const int fill = pow2_floor(max(kThreads / M, 1));
  const int g = min(min(fill, 32), pow2_ceil(L));
  return max(g, pow2_ceil((L + kPerLane - 1) / kPerLane));
}

// The fast path: G lanes a line, the support in registers, one block
// barrier (the caller's).
template <typename A, bool Right, typename Mat, bool UV>
__device__ void reflect_fast(const Mat& m, const Rows<A>& uv, const Refl& r,
                             int G, int n) {
  const int L = r.hi - r.lo + 1;
  const int tid = threadIdx.x;
  const int t = tid & (G - 1);
  const int grp = tid / G;
  const int ngrp = kThreads / G;
  const int wgrp = (tid & ~31) / G;          // the warp's first group
  const int K = (L + G - 1) / G;             // support entries a lane holds
  const int nl = r.lend - r.lbeg + 1;
  // warps that hold no line (of A, or in uv mode of U2 or V2) have nothing
  // to do; the named barrier counts the others
  const int busy = ((min(UV ? max(nl, n) : nl, ngrp) * G + 31) / 32) * 32;
  if (tid >= busy) return;
  A* const p = m.p;
  const int st = m.template step<Right>();   // entry to entry
  const int gs = G * st;                     // one entry of a lane to its next
  const int piv = line_off<Right>(m, r, r.lbeg);
  A v[kPerLane];
  A s = 0;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    if (q == K) break;
    v[q] = t + q * G < L ? p[piv + t * st + q * gs] : A(0);
    if (t + q * G >= 1) s += v[q] * v[q];
  }
  for (int o = 1; o < G; o <<= 1) s += __shfl_xor_sync(kFull, s, o);
  const House<A> h = house(p[piv], s);
  if (!h.act) return;                        // a no-op, in every thread
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    if (q == K) break;
    v[q] = t + q * G == 0 ? A(1) : v[q] * h.scale;   // zero past L
  }
  if (tid < 32) bar_sync_1(busy); else bar_arrive_1(busy);
  for (int base = 0; base < nl && base + wgrp < nl; base += ngrp) {
    const int li = base + grp;
    const bool on = li < nl;
    const int o0 = line_off<Right>(m, r, r.lbeg + (on ? li : 0)) + t * st;
    A x[kPerLane];
    A w = 0, w1 = 0;                         // even and odd q
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      if (q == K) break;
      x[q] = (on && li > 0 && t + q * G < L) ? p[o0 + q * gs] : A(0);
      if (q & 1) w1 += x[q] * v[q]; else w += x[q] * v[q];
    }
    w += w1;
    for (int o = 1; o < G; o <<= 1) w += __shfl_xor_sync(kFull, w, o);
    if (on) {
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        if (q == K) break;
        const int c = t + q * G;
        if (c < L)
          p[o0 + q * gs] = li == 0 ? (c == 0 ? h.beta : A(0))
                                   : x[q] - h.tau * (w * v[q]);
      }
    }
  }
  if (UV) {                                  // U <- U H or V <- V H
    for (int base = 0; base < n && base + wgrp < n; base += ngrp) {
      const int j = base + grp;
      const bool on = j < n;
      A* row = uv.p + (size_t)(on ? j : 0) * uv.ld + r.lo + t;
      A x[kPerLane];
      A w = 0, w1 = 0;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        if (q == K) break;
        x[q] = (on && t + q * G < L) ? row[q * G] : A(0);
        if (q & 1) w1 += x[q] * v[q]; else w += x[q] * v[q];
      }
      w += w1;
      for (int o = 1; o < G; o <<= 1) w += __shfl_xor_sync(kFull, w, o);
      if (on) {
#pragma unroll
        for (int q = 0; q < kPerLane; ++q) {
          if (q == K) break;
          if (t + q * G < L) row[q * G] = x[q] - h.tau * (w * v[q]);
        }
      }
    }
  }
}

// The general path: v in shared memory (vbuf), one warp a line re-reading
// it; a left reflector on the matrix in device memory puts lanes on
// consecutive columns and splits the support over warps, whose partial sums
// meet in wpart.
template <typename A, bool Right, typename Mat, bool UV>
__device__ void reflect_general(const Mat& m, const Rows<A>& uv,
                                const Refl& r, int n, A* vbuf, A* wpart) {
  const int L = r.hi - r.lo + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  A* const p = m.p;
  const int st = m.template step<Right>();
  const int piv = line_off<Right>(m, r, r.lbeg);
  A s = 0;
  for (int c = 1 + lane; c < L; c += 32) {
    const A x = p[piv + c * st];
    s += x * x;
  }
  for (int o = 1; o < 32; o <<= 1) s += __shfl_xor_sync(kFull, s, o);
  const House<A> h = house(p[piv], s);
  if (!h.act) return;
  for (int c = tid; c < L; c += kThreads)
    vbuf[c] = c == 0 ? A(1) : p[piv + c * st] * h.scale;
  __syncthreads();                           // v complete, pivot line read
  const int nl = r.lend - r.lbeg + 1;
  if (Mat::kGlobal && !Right) {
    const int nstrips = (nl + 31) / 32;      // of 32 columns
    const int P = max(1, kWarps / nstrips);  // warps on one strip
    const int spb = kWarps / P;              // strips a pass
    const int per = (L + P - 1) / P;
    const int part = warp % P, sl = warp / P;
    const int c0 = part * per, c1 = min(L, c0 + per);
    for (int sb = 0; sb < nstrips; sb += spb) {
      const int strip = sb + sl;
      const int col = r.lbeg + strip * 32 + lane;
      const bool on = sl < spb && strip < nstrips && col <= r.lend;
      A* const pc = p + m.off(r.lo, on ? col : r.lo);
      A w = 0;
      if (on) {
#pragma unroll 8
        for (int c = c0; c < c1; ++c) w += vbuf[c] * pc[c * st];
      }
      wpart[warp * 32 + lane] = w;
      __syncthreads();
      if (on) {
        A ws = 0;
        for (int q = 0; q < P; ++q) ws += wpart[(sl * P + q) * 32 + lane];
#pragma unroll 8
        for (int c = c0; c < c1; ++c) {
          A& x = pc[c * st];
          x = col == r.lo ? (c == 0 ? h.beta : A(0))
                          : x - h.tau * (ws * vbuf[c]);
        }
      }
      __syncthreads();
    }
  } else {
    for (int li = warp; li < nl; li += kWarps) {
      A* const pl = p + line_off<Right>(m, r, r.lbeg + li);
      if (li == 0) {
        for (int c = lane; c < L; c += 32) pl[c * st] = c == 0 ? h.beta : A(0);
        continue;
      }
      A w = 0;
      for (int c = lane; c < L; c += 32) w += pl[c * st] * vbuf[c];
      for (int o = 1; o < 32; o <<= 1) w += __shfl_xor_sync(kFull, w, o);
      for (int c = lane; c < L; c += 32) {
        A& x = pl[c * st];
        x = x - h.tau * (w * vbuf[c]);
      }
    }
  }
  if (UV) {
    for (int j = warp; j < n; j += kWarps) {
      A* row = uv.p + (size_t)j * uv.ld + r.lo;
      A w = 0;
      for (int c = lane; c < L; c += 32) w += row[c] * vbuf[c];
      for (int o = 1; o < 32; o <<= 1) w += __shfl_xor_sync(kFull, w, o);
      for (int c = lane; c < L; c += 32)
        row[c] = row[c] - h.tau * (w * vbuf[c]);
    }
  }
}

// One reflector, then the block barrier that orders it before the next.
// uv: V for a right reflector, U for a left one.
template <typename A, bool Right, typename Mat, bool UV>
__device__ void reflect(const Mat& m, const Rows<A>& uv, int k, int lo,
                        int hi, int n, int bw, A* vbuf, A* wpart) {
  const Refl r = make_refl(Right, k, lo, hi, n, bw);
  const int G = group_lanes(hi - lo + 1, r.lend - r.lbeg + 1);
  // In shared memory the fast path always holds: a trailing block or band
  // that fits there has supports of fewer than 32 * kPerLane entries.  The
  // general path is built for the matrix in device memory only, which
  // keeps the hot instances small for the instruction cache.
  if constexpr (Mat::kGlobal) {
    if (G <= 32 && Right)
      reflect_fast<A, Right, Mat, UV>(m, uv, r, G, n);
    else
      reflect_general<A, Right, Mat, UV>(m, uv, r, n, vbuf, wpart);
  } else {
    reflect_fast<A, Right, Mat, UV>(m, uv, r, G, n);
  }
  __syncthreads();
}

template <typename A, typename Mat, bool UV>
__device__ void phase1_step(const Mat& m, const Rows<A>& U, const Rows<A>& V,
                            int j, int n, int bw, A* vbuf, A* wpart) {
  reflect<A, false, Mat, UV>(m, U, j, j, n - 1, n, bw, vbuf, wpart);
  if (j + bw < n - 1)
    reflect<A, true, Mat, UV>(m, V, j, j + bw, n - 1, n, bw, vbuf, wpart);
}

template <typename A, typename Mat, bool UV>
__device__ void phase2(const Mat& m, const Rows<A>& U, const Rows<A>& V,
                       int n, int bw, A* vbuf, A* wpart) {
  const int ncyc = (n - 2) / bw + 1;
  for (int R = 0; R < n - 2; ++R) {
    for (int jc = 0; jc < ncyc; ++jc) {
      const int p = R + 1 + jc * bw;
      if (p >= n - 1) break;                 // support of one entry or none
      const int r = jc == 0 ? R : p - bw;
      const int hi = min(p + bw - 1, n - 1);
      reflect<A, true, Mat, UV>(m, V, r, p, hi, n, bw, vbuf, wpart);
      reflect<A, false, Mat, UV>(m, U, p, p, hi, n, bw, vbuf, wpart);
    }
  }
}

// The layout (tuning.fused_route), in words of the accumulation type: x
// words of scratch (phases 1-2: wpart (kThreads) and vbuf (n); phase 3 over
// them: z (2n - 1), two scalars at 2n, the tree top's counts (n int32)
// after), then r words of region (the trailing block from column j0, ld
// ldt; then the band, h diagonals of ld ldb, the first dlo of them below
// the main one), then in uv mode U2 and V2 (ld ldu) where uv_smem.
struct Args {
  const void* mats;
  void *ws, *uws, *vws, *sig, *d, *e, *u, *vt;
  int n, bw, max_iter;
  double tiny;
  int smem_route, j0, uv_smem, x, r, ldt, ldb, ldu, dlo, h, dtop, s;
};

template <typename T, bool UV>
__global__ void __launch_bounds__(kThreads, 1) fused_small_kernel(Args a) {
  using A = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* sm = reinterpret_cast<A*>(smem_raw);
  A* wpart = sm;
  A* vbuf = sm + kThreads;
  A* reg = sm + a.x;
  const int n = a.n, bw = a.bw, tid = threadIdx.x;
  const size_t nn = (size_t)n * n;
  const size_t b = blockIdx.x;
  const T* src = static_cast<const T*>(a.mats) + b * nn;
  A* g = static_cast<A*>(a.ws) + b * nn;
  const bool trail = a.smem_route && a.j0 < n - 1;

  Rows<A> U{nullptr, 0}, V{nullptr, 0};
  if (UV) {
    if (a.uv_smem) {
      U = {reg + a.r, a.ldu};
      V = {reg + a.r + (size_t)n * a.ldu, a.ldu};
    } else {
      U = {static_cast<A*>(a.uws) + b * nn, n};
      V = {static_cast<A*>(a.vws) + b * nn, n};
    }
    for (size_t idx = tid; idx < nn; idx += kThreads) {
      const int i = (int)(idx / n), c = (int)(idx % n);
      const A one = i == c ? A(1) : A(0);
      U.p[(size_t)i * U.ld + c] = one;
      V.p[(size_t)i * V.ld + c] = one;
    }
  }
  if (trail && a.j0 == 0) {
    for (size_t idx = tid; idx < nn; idx += kThreads)
      reg[(idx / n) * a.ldt + idx % n] = to_acc(src[idx]);
  } else {
    for (size_t idx = tid; idx < nn; idx += kThreads)
      g[idx] = to_acc(src[idx]);
  }
  __syncthreads();

  // phase 1: dense -> upper band(bw)
  const Dense<A, true> gd{g, n, 0};
  const Dense<A, false> td{reg, a.ldt, a.j0};
  for (int j = 0; j < n - 1; ++j) {
    if (trail && j >= a.j0) {
      if (j == a.j0 && j > 0) {              // the trailing block moves in
        const int mt = n - j;
        for (int idx = tid; idx < mt * mt; idx += kThreads) {
          const int i = idx / mt, c = idx % mt;
          reg[i * a.ldt + c] = g[(size_t)(j + i) * n + j + c];
        }
        __syncthreads();
      }
      phase1_step<A, Dense<A, false>, UV>(td, U, V, j, n, bw, vbuf, wpart);
    } else {
      phase1_step<A, Dense<A, true>, UV>(gd, U, V, j, n, bw, vbuf, wpart);
    }
  }

  // the band into shared memory: rows still in the trailing block pass
  // their band entries through device memory, beside the rows done before
  if (a.smem_route) {
    if (trail) {
      const int w1 = bw + 1, rows = n - a.j0;
      for (int idx = tid; idx < rows * w1; idx += kThreads) {
        const int i = a.j0 + idx / w1, c = i + idx % w1;
        if (c < n) g[(size_t)i * n + c] = reg[(i - a.j0) * a.ldt + c - a.j0];
      }
      __syncthreads();
    }
    for (int idx = tid; idx < a.h * a.ldb; idx += kThreads) {
      const int dd = idx / a.ldb, c = idx % a.ldb, i = c + a.dlo - dd;
      reg[idx] = (c < n && i >= 0 && i <= c && c - i <= bw)
                     ? g[(size_t)i * n + c] : A(0);
    }
    __syncthreads();
  }

  // phase 2: one SBR stage b_in = bw, tw = bw - 1 (bw == 1: already done)
  if (bw >= 2 && n >= 3) {
    if (a.smem_route)
      phase2<A, Band<A>, UV>(Band<A>{reg, a.ldb, a.dlo}, U, V, n, bw, vbuf,
                             wpart);
    else
      phase2<A, Dense<A, true>, UV>(gd, U, V, n, bw, vbuf, wpart);
  }
  auto fin = [&](int i, int c) -> A {        // the bidiagonal's entries
    return a.smem_route ? reg[(c - i + a.dlo) * a.ldb + c]
                        : g[(size_t)i * n + c];
  };

  if (UV) {
    T* dout = static_cast<T*>(a.d) + b * n;
    T* eout = static_cast<T*>(a.e) + b * n;
    T* uout = static_cast<T*>(a.u) + b * nn;
    T* vtout = static_cast<T*>(a.vt) + b * nn;
    for (int k = tid; k < n; k += kThreads) {
      dout[k] = from_acc<T>(fin(k, k));
      eout[k] = from_acc<T>(k == 0 ? A(0) : fin(k - 1, k));
    }
    for (size_t idx = tid; idx < nn; idx += kThreads) {
      const int i = (int)(idx / n), c = (int)(idx % n);
      uout[idx] = from_acc<T>(U.p[(size_t)i * U.ld + c]);
      vtout[idx] = from_acc<T>(V.p[(size_t)c * V.ld + i]);
    }
    return;
  }

  // phase 3: sigma by Sturm bisection (csrc/sturm_device.cuh)
  T* sg = static_cast<T*>(a.sig) + b * n;
  if (n == 1) {
    if (tid == 0) sg[0] = from_acc<T>(abs_acc(fin(0, 0)));
    return;
  }
  A* z = sm;                                 // (d_1, e_1, d_2, ..., d_n)
  A* sc = sm + 2 * n;
  int* counts = reinterpret_cast<int*>(sm + 2 * n + 2);
  const int m = 2 * n - 1;
  for (int k = tid; k < n; k += kThreads) {
    z[2 * k] = fin(k, k);
    if (k + 1 < n) z[2 * k + 1] = fin(k, k + 1);
  }
  __syncthreads();
  if (tid < 32) {
    A zmax = 0;
    for (int i = tid; i < m; i += 32) {
      const A t = abs_acc(z[i]);
      zmax = t > zmax ? t : zmax;
    }
    zmax = warp_max(zmax);
    if (tid == 0) sc[0] = pow2_scale(zmax);
  }
  __syncthreads();
  const A scale = sc[0];
  for (int i = tid; i < m; i += kThreads) z[i] = z[i] / scale;
  __syncthreads();
  if (tid < 32) {                            // Gershgorin bound + 1
    A bnd = 0;
    for (int i = tid; i <= m; i += 32) {
      const A l = i > 0 ? abs_acc(z[i - 1]) : A(0);
      const A r = i < m ? abs_acc(z[i]) : A(0);
      bnd = l + r > bnd ? l + r : bnd;
    }
    bnd = warp_max(bnd);
    if (tid == 0) sc[1] = bnd + A(1);
  }
  __syncthreads();
  const A bound = sc[1];
  const A tiny = (A)a.tiny;
  for (int j = tid + 1; j < (1 << a.dtop); j += kThreads) {   // the top
    A lo = 0;
    A hi = bound;
    descend(j, lo, hi);
    counts[j] = sturm_count(z, 2 * n, A(0.5) * (lo + hi), tiny);
  }
  __syncthreads();
  const int S = 1 << a.s;
  const int kpb = kThreads / S;              // k a pass, 2^s lanes each
  const int lane = tid & (S - 1);
  for (int kb = 0; kb < n && kb + (tid & ~31) / S < n; kb += kpb) {
    const int kk = kb + tid / S;             // lanes past n shadow k = n
    const int k = min(kk, n - 1) + 1;        // 1-indexed, ascending
    A lo = 0;
    A hi = bound;
    walk_top(counts, n, k, a.dtop, lo, hi);
    bisect_rounds(z, n, k, lane, a.s, a.dtop, a.max_iter, tiny, lo, hi);
    if (kk < n && lane == 0)
      sg[n - k] = from_acc<T>(A(0.5) * (lo + hi) * scale);
  }
}

template <typename T>
int launch(const Args& a, int B, int compute_uv, int smem, void* stream) {
  using A = typename AccOf<T>::type;
  const long item = sizeof(A);
  const int n = a.n, bw = a.bw;
  bool ok = B > 0 && n >= 1 && bw >= 1 && bw <= (n > 1 ? n - 1 : 1) &&
            a.max_iter >= 1 && a.x >= kThreads + n && a.r >= 0 &&
            a.dtop >= 0 && a.dtop <= a.max_iter && (1 << a.dtop) <= n &&
            a.s >= 0 && a.s <= 5;
  if (!compute_uv) ok = ok && a.x * item >= (2L * n + 2) * item + 4L * n;
  if (a.smem_route) {                        // supports fit the fast path
    ok = ok && bw <= 32 * kPerLane &&
         (a.j0 >= n - 1 || n - a.j0 <= 32 * kPerLane) &&
         a.dlo == min(bw - 1, n - 1) &&
         a.h == a.dlo + min(2 * bw - 1, n - 1) + 1 && a.ldb >= n &&
         a.r >= (long)a.h * a.ldb;
    if (a.j0 < n - 1)
      ok = ok && a.j0 >= 0 && a.ldt >= n - a.j0 &&
           a.r >= (long)(n - a.j0) * a.ldt;
  }
  if (a.uv_smem) ok = ok && compute_uv && a.ldu >= n;
  const long words = (long)a.x + a.r + (a.uv_smem ? 2L * n * a.ldu : 0);
  ok = ok && words * item == smem;
  if (!ok) return (int)cudaErrorInvalidValue;
  auto kern = compute_uv ? fused_small_kernel<T, true>
                         : fused_small_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, one symbol per storage type.  bw is the effective
// bandwidth (1 <= bw <= max(n-1, 1)); tiny is 4 * the accumulation type's
// smallest normal; the layout (smem_route .. ldu, dlo, h) and smem come from
// tuning.fused_route, the bisection's (dtop, s) from
// fused_small.bisect_schedule.  Returns cudaErrorInvalidValue when they do
// not describe one consistent layout.
#define FUSED_SMALL_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* mats, void* ws, void* uws, void* vws,     \
                      void* sig, void* d, void* e, void* u, void* vt,        \
                      int B, int n, int bw, int max_iter, double tiny,       \
                      int compute_uv, int smem_route, int j0, int uv_smem,   \
                      int x, int r, int ldt, int ldb, int ldu, int dlo,      \
                      int h, int dtop, int s, int smem, void* stream) {      \
    const Args a{mats, ws,  uws, vws,        sig,     d,  e,  u,   vt,       \
                 n,    bw,  max_iter, tiny,  smem_route, j0, uv_smem, x,     \
                 r,    ldt, ldb, ldu,        dlo,     h,  dtop, s};          \
    return launch<T>(a, B, compute_uv, smem, stream);                        \
  }

FUSED_SMALL_ENTRY(fused_small_f64, double)
FUSED_SMALL_ENTRY(fused_small_f32, float)
FUSED_SMALL_ENTRY(fused_small_bf16, __nv_bfloat16)
