// Bulge-chase kernels for Hopper (sm_90a): one chase cycle per block
// (kernel 1) and K consecutive cycles of one sweep per block, on the band in
// place (kernel 2).
//
// Replaces the TPU kernels chase_cycle_pallas (src/repro/kernels/
// bulge_chase.py:126) and chase_superstep_pallas (:225).  Plain versions:
// src/repro_torch/kernels/ref.py.
//
// What bounds them on the H100.  A cycle moves (tw+1)*(H-tw+b_in) words in
// and out and does about 4*(tw+1)*(H-tw+W) flops on them: at b_in=64,
// tw=32, fp32 and G=32 slots of K=4 cycles that is ~4.6 MB per launch,
// ~1.4 us at 3.35 TB/s.  Each block is one slot, and its cycles depend on
// each other, so a launch is a chain of latencies: device-memory round
// trips, barriers and the serial dot products of the two rank-1 updates.
//
// Kernel 1 (chase_cycle_kernel, fuse 1; the host gathers and scatters its
// windows):
//   * one block of 128 threads per slot (wavefront slot x batch);
//   * only the two panels a cycle changes are staged in shared memory, in the
//     accumulation type: the column panel rows [tw,H) x cols [0,tw], and the
//     row panel rows [H-1-tw,H) x cols [tw+1,W).  The panels overlap in rows
//     [H-1-tw,H) x cols [0,tw]; those cells live once, in the column panel,
//     so the left reflector reads the values the right one just wrote.  The
//     whole window would not fit: at b_in=256, tw=16, fp64 it is ~631 KB;
//   * the larfg reductions run on warp 0 with shuffles; the per-row and
//     per-column dot products and rank-1 updates run one row (column) per
//     thread.
//
// Kernel 2 (chase_superstep_kernel, fuse K) addresses the padded band
// (B, H, n_pad) in place: slot (b, g) chases band b's columns [p, p + WK)
// through the shear (y, w) -> band[H-1-(y-w), p + i*b_in + w] of cycle i,
// and writes its reflectors straight into the stage's tape.  The same
// kernel takes G contiguous blocks (G, H, WK) (p = 0, row stride WK).
//   * The panels of consecutive cycles meet in one (tw+1) x (tw+1) corner:
//     cycle i's row panel, columns [b_in, W), is cycle i+1's column panel,
//     rows [0, tw], at the same band cells.  Every other cell a cycle
//     touches is touched by no other cycle of the launch.  So the block
//     loads each cell once, carries the corner from cycle to cycle in shared
//     memory, and stores each cell once, when no later cycle changes it.
//     The panels' layout is kernel 1's (plus a copy of column 0 for the left
//     reflector), so no more shared memory than kernel 1.
//   * 512 threads, so that the chains of dependent instructions in each
//     phase overlap across 16 warps.  A row (column) of a rank-1 update belongs to a group of
//     GS lanes, each holding up to kMaxE of its tw+1 elements in registers,
//     and its dot product is reduced by shuffles within the group.
//   * Every warp computes both larfg scalars itself from shared memory, so
//     no warp waits for another to publish them: three barriers a cycle
//     (after the right update, after the left update, after the moves).
//   * The moves walk band rows, so neighbouring threads touch neighbouring
//     addresses.
//   * Race freedom is the caller's premise: the blocks of one launch must
//     be pairwise disjoint in band columns (ops.chase_superstep_band checks
//     the schedule's separation and dump zones before launching).
// Half types accumulate in float and are rounded to their storage type after
// each of the two updates.  Build without --use_fast_math: the tau = 0 test
// on an exact zero tail (sigma > 0) and the fp64 tolerances need IEEE
// division, square root and subnormals.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;

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

// Round an accumulator value through the storage type.
template <typename T>
__device__ inline typename AccOf<T>::type rnd(typename AccOf<T>::type x) {
  return to_acc(from_acc<T>(x));
}

// Rolled dense window stored as is: cell (y, w) at y*W + w.
template <typename T> struct DenseWindow {
  T* base;
  int W;
  __device__ T* at(int y, int w) const { return base + (size_t)y * W + w; }
};

// larfg on x[0], x[stride], ..., x[(L-1)*stride], run by all 32 lanes of one
// warp.  Writes v (v[0] = 1), out[0] = tau and out[1] = beta (alpha when the
// tail is exactly zero, and then tau = 0).
template <typename A>
__device__ void larfg_warp(const A* x, int stride, int L, A* v, A* out) {
  const int lane = threadIdx.x & 31;
  const A alpha = x[0];
  A s = 0;
  for (int c = 1 + lane; c < L; c += 32) {
    const A t = x[c * stride];
    s += t * t;
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const A mu = sqrt_acc(alpha * alpha + s);
  const A beta = alpha >= A(0) ? -mu : mu;
  const bool safe = s > A(0);
  const A denom = safe ? alpha - beta : A(1);
  const A tau = safe ? (beta - alpha) / (beta == A(0) ? A(1) : beta) : A(0);
  for (int c = lane; c < L; c += 32)
    v[c] = c == 0 ? A(1) : (safe ? x[c * stride] / denom : A(0));
  if (lane == 0) {
    out[0] = tau;
    out[1] = safe ? beta : alpha;
  }
}

// One chase cycle on the window `win` (kernel 1).  Ends with a
// __syncthreads.
template <typename T, typename Win>
__device__ void chase_window(const Win& win, bool first, int b_in, int tw,
                             typename AccOf<T>::type* sm, T* tape_v,
                             T* tape_tau) {
  using A = typename AccOf<T>::type;
  const int H = b_in + 2 * tw + 1;
  const int W = b_in + tw + 1;
  const int L = tw + 1;
  const int R = H - tw;                    // column-panel rows [tw, H)
  A* cp = sm;                              // (R, L)
  A* rp = cp + R * L;                      // (L, b_in): cols [tw+1, W)
  A* v = rp + L * b_in;                    // (L,)
  A* v2 = v + L;                           // (L,)
  A* sc = v2 + L;                          // tau, beta, tau2, beta2
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int i = tid; i < R * L; i += nt)
    cp[i] = to_acc(*win.at(tw + i / L, i % L));
  for (int i = tid; i < L * b_in; i += nt)
    rp[i] = to_acc(*win.at(H - 1 - tw + i / b_in, tw + 1 + i % b_in));
  __syncthreads();

  // 1. right reflector on the pivot row (row tw, or 2*tw on a first cycle)
  const int r0 = first ? tw : 0;           // pivot row inside the panel
  if (tid < 32) larfg_warp<A>(cp + r0 * L, 1, L, v, sc);
  __syncthreads();
  const A tau = sc[0];
  const A beta = sc[1];
  // 2-3. per-row dot and rank-1 update; the pivot row becomes [beta, 0...]
  for (int r = tid; r < R; r += nt) {
    A* row = cp + r * L;
    if (r == r0 && tau != A(0)) {
      row[0] = rnd<T>(beta);
      for (int c = 1; c < L; ++c) row[c] = A(0);
      continue;
    }
    A s = 0;
    for (int c = 0; c < L; ++c) s += row[c] * v[c];
    for (int c = 0; c < L; ++c) row[c] = rnd<T>(row[c] - tau * (s * v[c]));
  }
  // 4.
  __syncthreads();

  // 5. left reflector on column 0, rows [H-1-tw, H) = panel rows [b_in, R)
  if (tid < 32) larfg_warp<A>(cp + b_in * L, L, L, v2, sc + 2);
  __syncthreads();
  const A tau2 = sc[2];
  const A beta2 = sc[3];
  for (int w = tid; w < W; w += nt) {
    A* col = w <= tw ? cp + b_in * L + w : rp + (w - tw - 1);
    const int stride = w <= tw ? L : b_in;
    if (w == 0 && tau2 != A(0)) {
      col[0] = rnd<T>(beta2);
      for (int k = 1; k < L; ++k) col[k * stride] = A(0);
      continue;
    }
    A s = 0;
    for (int k = 0; k < L; ++k) s += v2[k] * col[k * stride];
    for (int k = 0; k < L; ++k)
      col[k * stride] = rnd<T>(col[k * stride] - tau2 * (v2[k] * s));
  }
  __syncthreads();

  for (int i = tid; i < R * L; i += nt)
    *win.at(tw + i / L, i % L) = from_acc<T>(cp[i]);
  for (int i = tid; i < L * b_in; i += nt)
    *win.at(H - 1 - tw + i / b_in, tw + 1 + i % b_in) = from_acc<T>(rp[i]);
  if (tape_v != nullptr) {
    for (int c = tid; c < L; c += nt) {
      tape_v[c] = from_acc<T>(v[c]);
      tape_v[L + c] = from_acc<T>(v2[c]);
    }
    if (tid == 0) {
      tape_tau[0] = from_acc<T>(tau);
      tape_tau[1] = from_acc<T>(tau2);
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chase_cycle_kernel(T* windows, const unsigned char* is_first, int b_in,
                   int tw, T* tape_v, T* tape_tau) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = typename AccOf<T>::type;
  const int g = blockIdx.x;
  const int H = b_in + 2 * tw + 1;
  const int W = b_in + tw + 1;
  const DenseWindow<T> win{windows + (size_t)g * H * W, W};
  chase_window<T>(win, is_first[g] != 0, b_in, tw,
                  reinterpret_cast<A*>(smem_raw),
                  tape_v ? tape_v + (size_t)g * 2 * (tw + 1) : nullptr,
                  tape_tau ? tape_tau + (size_t)g * 2 : nullptr);
}

// ---------------------------------------------------------------------------
// Kernel 2: K cycles of one sweep per block, on the band in place
// ---------------------------------------------------------------------------

constexpr int kSuperThreads = 512;
constexpr int kMaxE = 9;        // elements of a row (column) held by a lane

template <typename T> struct SuperArgs {
  T* base;                      // band (block) 0
  long long band_stride;        // elements from one band (block) to the next
  int ld;                       // row stride of a band (block)
  const int* p;                 // first column of slot g's block; null: 0
  int G;                        // slots per band
  const unsigned char* first;   // slot s = b*G + g: its cycle 0 is a first
  const unsigned char* live;    // cycle i of slot (b, g):
  long long live_stride;        //   live[b*live_stride + g*K + i]
  T* tape_v;                    // null: no tape; else the pair of cycle i of
  T* tape_tau;                  //   slot (b, g) at b*tape_stride + g*K + i
  long long tape_stride;
  int zero_dead_tau;            // tau = 0 on the tape for cycles not live
  int b_in, tw, fuse;
};

// The panels in shared memory, in the accumulation type: the column panel
// cp (R, L) (window rows [tw, H) x cols [0, tw]), the row panel rp (L, b_in)
// at row stride b_in + 1 (window rows [H-1-tw, H) x cols [tw+1, W)), and x2
// (L,), column 0 of rows [b_in, R) after the right update.  The corner rp(k,
// b_in - L + c) lies at the band cell of cp(k, c) one cycle later.
template <typename A> struct Panels {
  A* cp;
  A* rp;
  A* x2;
  int b_in, tw, H, W, L, R, rld;
  unsigned magic;               // idx / L == __umulhi(idx, magic)
};

template <typename A>
__device__ Panels<A> panels_of(unsigned char* smem, int b_in, int tw) {
  Panels<A> pn;
  pn.b_in = b_in;
  pn.tw = tw;
  pn.H = b_in + 2 * tw + 1;
  pn.W = b_in + tw + 1;
  pn.L = tw + 1;
  pn.R = b_in + tw + 1;
  pn.rld = b_in + 1;
  pn.cp = reinterpret_cast<A*>(smem);
  pn.rp = pn.cp + pn.R * pn.L;
  pn.x2 = pn.rp + pn.L * pn.rld;
  pn.magic = 0xffffffffu / (unsigned)pn.L + 1u;   // exact for idx * L < 2^32
  return pn;
}

// The moves between the panels and the band, each cell by one thread: the
// column panel walked by (band row d, column c), the row panel's cells left
// of the corner by (d, row k).  The corner rp(r, b_in-L+c) goes with cp(r,
// c) (one band row), so the thread that carries it also reloads it.

// Store: every cp cell and the rp cells left of the corner to the window
// at band column col0; the corner too when `corner`.
template <typename T, typename A>
__device__ void panels_out(const Panels<A>& pn, T* band, int ld, int col0,
                           bool corner) {
  const int nt = blockDim.x;
  const int L = pn.L, b_in = pn.b_in, tw = pn.tw;
  const int jc = b_in - L;                 // first corner column of rp
  for (int idx = threadIdx.x; idx < pn.H * L; idx += nt) {
    const int d = __umulhi(idx, pn.magic);
    const int c = idx - d * L;
    const int r = b_in + tw - d + c;
    if (r >= 0 && r < pn.R) {
      T* row = band + (long long)d * ld + col0;
      row[c] = from_acc<T>(pn.cp[r * L + c]);
      if (corner && r < L)
        row[b_in + c] = from_acc<T>(pn.rp[r * pn.rld + jc + c]);
    }
  }
  for (int idx = threadIdx.x; idx < (b_in - 1) * L; idx += nt) {
    const int dd = __umulhi(idx, pn.magic);
    const int k = idx - dd * L;
    const int j = dd - tw + k;
    if (j >= 0 && j < jc)
      band[(long long)(dd + tw + 1) * ld + col0 + tw + 1 + j] =
          from_acc<T>(pn.rp[k * pn.rld + j]);
  }
}

// Load: the panels of the window at band column col0; with `carry` the
// column panel's rows [0, L) come from the corner of the row panel in shared
// memory (the window before, one cycle earlier), not from the band.
template <typename T, typename A>
__device__ void panels_in(const Panels<A>& pn, const T* band, int ld,
                          int col0, bool carry) {
  const int nt = blockDim.x;
  const int L = pn.L, b_in = pn.b_in, tw = pn.tw;
  const int jc = b_in - L;
  for (int idx = threadIdx.x; idx < pn.H * L; idx += nt) {
    const int d = __umulhi(idx, pn.magic);
    const int c = idx - d * L;
    const int r = b_in + tw - d + c;
    if (r >= 0 && r < pn.R) {
      const T* row = band + (long long)d * ld + col0;
      if (r < L) {
        A* corner = pn.rp + r * pn.rld + jc + c;
        pn.cp[r * L + c] = carry ? *corner : to_acc(row[c]);
        *corner = to_acc(row[b_in + c]);
      } else {
        pn.cp[r * L + c] = to_acc(row[c]);
      }
    }
  }
  for (int idx = threadIdx.x; idx < (b_in - 1) * L; idx += nt) {
    const int dd = __umulhi(idx, pn.magic);
    const int k = idx - dd * L;
    const int j = dd - tw + k;
    if (j >= 0 && j < jc)
      pn.rp[k * pn.rld + j] =
          to_acc(band[(long long)(dd + tw + 1) * ld + col0 + tw + 1 + j]);
  }
}

// larfg's scalars of x[0..L), computed by each warp for itself: the tail's
// sum of squares in larfg_warp's order, so every warp holds the same bits.
template <typename A> struct Refl {
  A tau, beta, denom;
  bool safe;
};

template <typename A>
__device__ __forceinline__ Refl<A> refl_of(const A* x, int L) {
  const int lane = threadIdx.x & 31;
  const A alpha = x[0];
  A s = 0;
  for (int c = 1 + lane; c < L; c += 32) {
    const A t = x[c];
    s += t * t;
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const A mu = sqrt_acc(alpha * alpha + s);
  const A beta = alpha >= A(0) ? -mu : mu;
  Refl<A> r;
  r.safe = s > A(0);
  r.denom = r.safe ? alpha - beta : A(1);
  r.tau = r.safe ? (beta - alpha) / (beta == A(0) ? A(1) : beta) : A(0);
  r.beta = r.safe ? beta : alpha;
  return r;
}

// element e of the reflector whose scalars are rf, from x[e]
template <typename A>
__device__ __forceinline__ A refl_v(const Refl<A>& rf, const A* x, int e) {
  return e == 0 ? A(1) : (rf.safe ? x[e] / rf.denom : A(0));
}

template <int GS, typename A>
__device__ __forceinline__ A group_sum(A s) {
#pragma unroll
  for (int o = GS / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// One cycle on the panels: the right reflector on the pivot row, applied to
// the column panel's rows; the left reflector on column 0 of rows [b_in, R),
// applied across the W columns.  A cycle that is not live (`act` false)
// changes nothing and only computes its pair for the tape.  tv / tt: the
// cycle's tape entries, or null.
template <typename T, int GS>
__device__ void super_cycle(const Panels<typename AccOf<T>::type>& pn,
                            bool act, bool first, T* tv, T* tt,
                            bool zero_dead) {
  using A = typename AccOf<T>::type;
  constexpr int NG = kSuperThreads / GS;   // groups of the block
  const int tid = threadIdx.x;
  const int grp = tid / GS;
  const int L = pn.L, b_in = pn.b_in, tw = pn.tw;
  const int E = (L + GS - 1) / GS;         // elements per lane, <= kMaxE
  const int e0 = (tid % GS) * E;
  A* cp = pn.cp;

  // 1. right reflector on the pivot row (row tw, or 2*tw on a first cycle)
  const int r0 = first ? tw : 0;
  const A* piv = cp + r0 * L;
  const Refl<A> rf = refl_of(piv, L);
  A v[kMaxE];
#pragma unroll
  for (int m = 0; m < kMaxE; ++m) {
    const int e = e0 + m;
    v[m] = (m < E && e < L) ? refl_v(rf, piv, e) : A(0);
  }
  for (int c = tid; tv != nullptr && c < L; c += kSuperThreads)
    tv[c] = from_acc<T>(refl_v(rf, piv, c));
  if (tt != nullptr && tid == 0)
    tt[0] = from_acc<T>(act || !zero_dead ? rf.tau : A(0));
  // every row but the pivot (whose update is [beta, 0...], written in step
  // 2, or the identity when tau = 0); a cycle that is not live needs only
  // column 0 of rows [b_in, R), for its left reflector
  for (int rb = act ? 0 : b_in; rb < pn.R; rb += NG) {
    const int r = rb + grp;
    const bool on = r < pn.R && r != r0;
    A* row = cp + r * L;
    A x[kMaxE];
    A s = 0;
#pragma unroll
    for (int m = 0; m < kMaxE; ++m) {
      const int e = e0 + m;
      x[m] = (on && m < E && e < L) ? row[e] : A(0);
      s += x[m] * v[m];
    }
    s = group_sum<GS>(s);
#pragma unroll
    for (int m = 0; m < kMaxE; ++m) {
      const int e = e0 + m;
      if (on && m < E && e < L) {
        const A y = rnd<T>(x[m] - rf.tau * (s * v[m]));
        if (act) row[e] = y;
        if (e == 0 && r >= b_in) pn.x2[r - b_in] = y;
      }
    }
  }
  __syncthreads();

  // 2. left reflector on x2 (column 0 of rows [b_in, R)), applied across
  // the W columns; column 0 becomes [beta2, 0...]
  const Refl<A> lf = refl_of(pn.x2, L);
  for (int c = tid; tv != nullptr && c < L; c += kSuperThreads)
    tv[L + c] = from_acc<T>(refl_v(lf, pn.x2, c));
  if (tt != nullptr && tid == 0)
    tt[1] = from_acc<T>(act || !zero_dead ? lf.tau : A(0));
  if (act) {
    A v2[kMaxE];
#pragma unroll
    for (int m = 0; m < kMaxE; ++m) {
      const int e = e0 + m;
      v2[m] = (m < E && e < L) ? refl_v(lf, pn.x2, e) : A(0);
    }
    if (rf.tau != A(0))
      for (int c = tid; c < L; c += kSuperThreads)
        cp[r0 * L + c] = c == 0 ? rnd<T>(rf.beta) : A(0);
    for (int wb = 0; wb < pn.W; wb += NG) {
      const int w = wb + grp;
      const bool on = w < pn.W;
      A* col = w <= tw ? cp + b_in * L + w : pn.rp + (w - tw - 1);
      const int stride = w <= tw ? L : pn.rld;
      A x[kMaxE];
      A s = 0;
#pragma unroll
      for (int m = 0; m < kMaxE; ++m) {
        const int e = e0 + m;
        x[m] = (on && m < E && e < L) ? col[e * stride] : A(0);
        s += v2[m] * x[m];
      }
      s = group_sum<GS>(s);
#pragma unroll
      for (int m = 0; m < kMaxE; ++m) {
        const int e = e0 + m;
        if (!(on && m < E && e < L)) continue;
        if (w == 0) {
          if (lf.tau != A(0)) col[e * stride] = e == 0 ? rnd<T>(lf.beta) : A(0);
        } else {
          col[e * stride] = rnd<T>(x[m] - lf.tau * (v2[m] * s));
        }
      }
    }
  }
  __syncthreads();
}

template <typename T, int GS>
__global__ void __launch_bounds__(kSuperThreads)
chase_superstep_kernel(const SuperArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = typename AccOf<T>::type;
  const int s = blockIdx.x;
  const int b = s / a.G;
  const int g = s - b * a.G;
  const int K = a.fuse;
  const unsigned char* live = a.live + b * a.live_stride + (long long)g * K;
  const bool tape = a.tape_v != nullptr;
  // the cycles run: all K with a tape, else up to the last live one
  int last = tape ? K - 1 : -1;
  for (int i = 0; i < K && !tape; ++i)
    if (live[i]) last = i;
  if (last < 0) return;                          // uniform across the block
  const Panels<A> pn = panels_of<A>(smem_raw, a.b_in, a.tw);
  T* band = a.base + b * a.band_stride;
  const int p = a.p != nullptr ? a.p[g] : 0;
  const int L = pn.L;
  panels_in<T, A>(pn, band, a.ld, p, false);
  __syncthreads();
  for (int i = 0; i <= last; ++i) {
    const bool act = live[i] != 0;
    const bool next = i < last;
    if (act || tape) {
      const long long slot = b * a.tape_stride + (long long)g * K + i;
      super_cycle<T, GS>(pn, act, i == 0 && a.first[s] != 0,
                         tape ? a.tape_v + slot * 2 * L : nullptr,
                         tape ? a.tape_tau + slot * 2 : nullptr,
                         a.zero_dead_tau != 0);
    }
    const int col0 = p + i * a.b_in;
    // the corner is final unless the next cycle is live and changes it
    if (act) panels_out<T, A>(pn, band, a.ld, col0, !(next && live[i + 1]));
    if (next) {
      panels_in<T, A>(pn, band, a.ld, col0 + a.b_in, true);
      __syncthreads();
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T>
int launch_cycle(void* windows, const void* is_first, int G, int b_in, int tw,
                 void* tape_v, void* tape_tau, int bytes, void* stream) {
  cudaError_t err = set_smem(chase_cycle_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  chase_cycle_kernel<T><<<G, kThreads, bytes, (cudaStream_t)stream>>>(
      (T*)windows, (const unsigned char*)is_first, b_in, tw, (T*)tape_v,
      (T*)tape_tau);
  return (int)cudaGetLastError();
}

template <typename T, int GS>
int launch_super_gs(const SuperArgs<T>& a, int slots, int bytes,
                    void* stream) {
  cudaError_t err = set_smem(chase_superstep_kernel<T, GS>, bytes);
  if (err != cudaSuccess) return (int)err;
  chase_superstep_kernel<T, GS>
      <<<slots, kSuperThreads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The lanes per row (column): the fewest whose kMaxE elements each cover
// the tw + 1 of a row.
template <typename T>
int launch_super(const SuperArgs<T>& a, int slots, int bytes, void* stream) {
  using A = typename AccOf<T>::type;
  const int L = a.tw + 1;
  const int need = ((a.b_in + a.tw + 1) * L + L * (a.b_in + 1) + L) *
                   (int)sizeof(A);
  if (bytes < need || a.b_in < L || a.fuse < 1) return (int)cudaErrorInvalidValue;
  if (slots == 0) return (int)cudaSuccess;
  if (L <= 2 * kMaxE) return launch_super_gs<T, 2>(a, slots, bytes, stream);
  if (L <= 4 * kMaxE) return launch_super_gs<T, 4>(a, slots, bytes, stream);
  if (L <= 8 * kMaxE) return launch_super_gs<T, 8>(a, slots, bytes, stream);
  if (L <= 16 * kMaxE) return launch_super_gs<T, 16>(a, slots, bytes, stream);
  if (L <= 32 * kMaxE) return launch_super_gs<T, 32>(a, slots, bytes, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, one symbol per storage type.  Pointers are device
// pointers; tape_v / tape_tau are null when no tape is wanted.  smem_bytes
// is the dynamic shared memory of one block as tuning.smem_bytes counts it.
// Each returns cudaGetLastError() after the launch.
//
// chase_superstep_*: G contiguous blocks (G, H, WK), is_first (G,), active
// (G, K), the tape (G, K, 2, tw+1) and (G, K, 2) with the raw tau of every
// cycle.  chase_superstep_band_*: super-cycle t of a stage on the padded
// band (B, H, n_pad) in place; p (G,) int32, first (B*G,), live (G, K), all
// row t of the stage's tables; tape_v / tape_tau point at row t of the
// stage's (B, T, G, K, 2, tw+1) and (B, T, G, K, 2) buffers, whose band
// stride is tape_stride = T*G*K pairs; tau = 0 for cycles not live.
#define CHASE_API(SUFFIX, T)                                                  \
  extern "C" int chase_cycle_##SUFFIX(void* windows, const void* is_first,   \
                                      int G, int b_in, int tw, void* tape_v, \
                                      void* tape_tau, int smem_bytes,        \
                                      void* stream) {                        \
    return launch_cycle<T>(windows, is_first, G, b_in, tw, tape_v, tape_tau, \
                           smem_bytes, stream);                              \
  }                                                                          \
  extern "C" int chase_superstep_##SUFFIX(                                   \
      void* blocks, const void* is_first, const void* active, int G,         \
      int b_in, int tw, int fuse, void* tape_v, void* tape_tau,              \
      int smem_bytes, void* stream) {                                        \
    const int wk = fuse * b_in + tw + 1;                                     \
    SuperArgs<T> a{(T*)blocks, (long long)(b_in + 2 * tw + 1) * wk, wk,      \
                   nullptr, 1, (const unsigned char*)is_first,               \
                   (const unsigned char*)active, fuse, (T*)tape_v,           \
                   (T*)tape_tau, fuse, 0, b_in, tw, fuse};                   \
    return launch_super<T>(a, G, smem_bytes, stream);                        \
  }                                                                          \
  extern "C" int chase_superstep_band_##SUFFIX(                              \
      void* band, int B, int n_pad, const void* p, int G, const void* first, \
      const void* live, void* tape_v, void* tape_tau, long long tape_stride, \
      int b_in, int tw, int fuse, int smem_bytes, void* stream) {            \
    SuperArgs<T> a{(T*)band, (long long)(b_in + 2 * tw + 1) * n_pad, n_pad,  \
                   (const int*)p, G, (const unsigned char*)first,            \
                   (const unsigned char*)live, 0, (T*)tape_v, (T*)tape_tau,  \
                   tape_stride, 1, b_in, tw, fuse};                          \
    return launch_super<T>(a, B * G, smem_bytes, stream);                    \
  }

CHASE_API(f64, double)
CHASE_API(f32, float)
CHASE_API(bf16, __nv_bfloat16)
