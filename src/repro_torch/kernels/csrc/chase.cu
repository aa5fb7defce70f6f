// Bulge-chase kernels for Hopper (sm_90a): one chase cycle per block
// (kernels 1 and 3) and K consecutive cycles of one sweep per block, on the
// band in place (kernel 2).
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
// One cycle body serves all three kernels (cycle(), below):
//   * 512 threads, so that the chains of dependent instructions in each
//     phase overlap across 16 warps.  A row (column) of a rank-1 update
//     belongs to a group of GS lanes, each holding up to kMaxE of its tw+1
//     elements in registers, and its dot product is reduced by shuffles
//     within the group.
//   * Every warp computes both larfg scalars itself from shared memory, so
//     no warp waits for another to publish them: three barriers a cycle
//     (after the right update, after the left update, after the moves).
//   * The body reaches the cells it changes through a layout: the two
//     staged panels (Panels, kernels 1 and 2) or the band rectangle as TMA
//     copied it (Tile, kernel 3).  The arithmetic, and so every bit of the
//     result, is the same whatever the layout.
//
// Kernel 1 (chase_cycle_kernel, the reference's contract: G rolled dense
// windows (G, H, W), gathered and scattered by the caller) stages only the
// two panels a cycle changes, in the accumulation type: the column panel
// rows [tw,H) x cols [0,tw], and the row panel rows [H-1-tw,H) x cols
// [tw+1,W).  The panels overlap in rows [H-1-tw,H) x cols [0,tw]; those
// cells live once, in the column panel, so the left reflector reads the
// values the right one just wrote.  The whole window would not always fit:
// at b_in=256, tw=16, fp64 it is ~631 KB.
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
//   * The moves walk band rows, so neighbouring threads touch neighbouring
//     addresses.
//
// Kernel 3 (chase_cycle_band_kernel, fuse 1) runs cycle t of a stage on the
// padded band in place, one block per slot.  Its moves are two TMA copies:
// the slot's whole band rectangle, rows [0, H) x columns [p0, p0 + BW),
// comes in as one box (129 x 100 fp32 = 52 KB at b_in=64, tw=32) and goes
// back as one box.  A box must start on a 16-byte boundary, so p0 is p
// rounded down to 16 bytes and BW covers W + 16 bytes - 1 element, rounded
// up to 16 bytes.  The cycle runs on the sheared view of the rectangle in
// shared memory, window cell (y, w) at tile row H-1-(y-w), column p-p0+w.
// Writing back the cells the cycle did not change is race-free: the slots'
// boxes are pairwise disjoint (the wrapper holds BW to the slots'
// separation of 3*b_in - 1 columns less 16 bytes), and a slot that is not
// live stores nothing.  (A live box may reach a few columns into the first
// dump zone, which is zero, and writes them back as it read them.)  The tensor map is made once per
// stage (chase_band_plan_*), so a cycle is one launch of three arguments.
//
// Race freedom is the caller's premise for kernels 2 and 3: the blocks of
// one launch must be pairwise disjoint in band columns (ops checks the
// schedule's separation and dump zones before a stage).
// Half types accumulate in float and are rounded to their storage type after
// each of the two updates.  Build without --use_fast_math: the tau = 0 test
// on an exact zero tail (sigma > 0) and the fp64 tolerances need IEEE
// division, square root and subnormals.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxE = 9;        // elements of a row (column) held by a lane
constexpr long long kWaitLimit = 1LL << 33;     // clocks

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

// ---------------------------------------------------------------------------
// Where a cycle's cells lie in shared memory
// ---------------------------------------------------------------------------

// The sizes of one cycle's window: H = b_in + 2*tw + 1, W = b_in + tw + 1,
// L = tw + 1 (a reflector's length), R = H - tw (the column panel's rows).
struct Geom {
  int b_in, tw, H, W, L, R;
};

__device__ inline Geom geom_of(int b_in, int tw) {
  return Geom{b_in, tw, b_in + 2 * tw + 1, b_in + tw + 1, tw + 1,
              b_in + tw + 1};
}

// The panels in shared memory, in the accumulation type: the column panel
// cp (R, L) (window rows [tw, H) x cols [0, tw]), the row panel rp (L, b_in)
// at row stride b_in + 1 (window rows [H-1-tw, H) x cols [tw+1, W)).  The
// corner rp(k, b_in - L + c) lies at the band cell of cp(k, c) one cycle
// later.
//   row(r): window cell (tw + r, 0); the row's cells rs apart
//   col(w): window cell (H-1-tw, w); the column's cells cs(w) apart
template <typename A> struct Panels {
  using S = A;
  A* cp;
  A* rp;
  int L, b_in, tw, R, rld;
  unsigned magic;               // idx / L == __umulhi(idx, magic)
  static constexpr int rs = 1;
  __device__ A* row(int r) const { return cp + r * L; }
  __device__ A* col(int w) const {
    return w <= tw ? cp + b_in * L + w : rp + (w - tw - 1);
  }
  __device__ int cs(int w) const { return w <= tw ? L : rld; }
};

template <typename A>
__device__ Panels<A> panels_of(unsigned char* smem, const Geom& gm) {
  Panels<A> pn;
  pn.L = gm.L;
  pn.b_in = gm.b_in;
  pn.tw = gm.tw;
  pn.R = gm.R;
  pn.rld = gm.b_in + 1;
  pn.cp = reinterpret_cast<A*>(smem);
  pn.rp = pn.cp + pn.R * pn.L;
  pn.magic = 0xffffffffu / (unsigned)pn.L + 1u;   // exact for idx * L < 2^32
  return pn;
}

// The band rectangle rows [0, H) x columns [p0, p0 + ld) as TMA stores
// it, in the storage type, row stride ld; base points at column p: window
// cell (y, w) at base + (H-1-(y-w))*ld + w.  Along a window row the cells
// are ld + 1 apart, down a window column -ld.
template <typename T> struct Tile {
  using S = T;
  T* base;
  int ld, H, tw;
  int rs;
  __device__ T* row(int r) const { return base + (H - 1 - tw - r) * ld; }
  __device__ T* col(int w) const { return base + (tw + w) * ld + w; }
  __device__ int cs(int) const { return -ld; }
};

// ---------------------------------------------------------------------------
// One cycle
// ---------------------------------------------------------------------------

// larfg's scalars of x[0], x[st], ..., x[(L-1)*st], computed by each warp
// for itself: the tail's sum of squares in lane order, then shuffles, so
// every warp holds the same bits.
template <typename A> struct Refl {
  A tau, beta, denom;
  bool safe;
};

template <typename A, typename S>
__device__ __forceinline__ Refl<A> refl_of(const S* x, int st, int L) {
  const int lane = threadIdx.x & 31;
  const A alpha = to_acc(x[0]);
  A s = 0;
  for (int c = 1 + lane; c < L; c += 32) {
    const A t = to_acc(x[c * st]);
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

// element e of the reflector whose scalars are rf, from x[e * st]
template <typename A, typename S>
__device__ __forceinline__ A refl_v(const Refl<A>& rf, const S* x, int st,
                                    int e) {
  return e == 0 ? A(1) : (rf.safe ? to_acc(x[e * st]) / rf.denom : A(0));
}

template <int GS, typename A>
__device__ __forceinline__ A group_sum(A s) {
#pragma unroll
  for (int o = GS / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// One cycle on the layout `lay`: the right reflector on the pivot row,
// applied to the column panel's rows; the left reflector on column 0 of
// rows [b_in, R), applied across the W columns.  x2 (L,) in shared memory
// takes column 0 of rows [b_in, R) after the right update.  A cycle that is
// not live (`act` false) changes nothing and only computes its pair for the
// tape.  tv / tt: the cycle's tape entries, or null.  With kAsync the
// threads' shared-memory writes are made visible to the async proxy (a TMA
// store) before the closing barrier.
template <typename T, int GS, bool kAsync = false, typename Lay>
__device__ void cycle(const Lay& lay, const Geom& gm,
                      typename AccOf<T>::type* x2, bool act, bool first,
                      T* tv, T* tt, bool zero_dead) {
  using A = typename AccOf<T>::type;
  using S = typename Lay::S;
  constexpr int NG = kThreads / GS;        // groups of the block
  const int tid = threadIdx.x;
  const int grp = tid / GS;
  const int L = gm.L, b_in = gm.b_in, tw = gm.tw;
  const int rs = lay.rs;
  const int E = (L + GS - 1) / GS;         // elements per lane, <= kMaxE
  const int e0 = (tid % GS) * E;

  // 1. right reflector on the pivot row (row tw, or 2*tw on a first cycle)
  const int r0 = first ? tw : 0;
  S* piv = lay.row(r0);
  const Refl<A> rf = refl_of<A>(piv, rs, L);
  A v[kMaxE];
#pragma unroll
  for (int m = 0; m < kMaxE; ++m) {
    const int e = e0 + m;
    v[m] = (m < E && e < L) ? refl_v(rf, piv, rs, e) : A(0);
  }
  for (int c = tid; tv != nullptr && c < L; c += kThreads)
    tv[c] = from_acc<T>(refl_v(rf, piv, rs, c));
  if (tt != nullptr && tid == 0)
    tt[0] = from_acc<T>(act || !zero_dead ? rf.tau : A(0));
  // every row but the pivot (whose update is [beta, 0...], written in step
  // 2, or the identity when tau = 0); a cycle that is not live needs only
  // column 0 of rows [b_in, R), for its left reflector
  for (int rb = act ? 0 : b_in; rb < gm.R; rb += NG) {
    const int r = rb + grp;
    const bool on = r < gm.R && r != r0;
    S* row = lay.row(r < gm.R ? r : 0);
    A x[kMaxE];
    A s = 0;
#pragma unroll
    for (int m = 0; m < kMaxE; ++m) {
      const int e = e0 + m;
      x[m] = (on && m < E && e < L) ? to_acc(row[e * rs]) : A(0);
      s += x[m] * v[m];
    }
    s = group_sum<GS>(s);
#pragma unroll
    for (int m = 0; m < kMaxE; ++m) {
      const int e = e0 + m;
      if (on && m < E && e < L) {
        const A y = rnd<T>(x[m] - rf.tau * (s * v[m]));
        if (act) row[e * rs] = from_acc<S>(y);
        if (e == 0 && r >= b_in) x2[r - b_in] = y;
      }
    }
  }
  __syncthreads();

  // 2. left reflector on x2 (column 0 of rows [b_in, R)), applied across
  // the W columns; column 0 becomes [beta2, 0...]
  const Refl<A> lf = refl_of<A>(x2, 1, L);
  for (int c = tid; tv != nullptr && c < L; c += kThreads)
    tv[L + c] = from_acc<T>(refl_v(lf, x2, 1, c));
  if (tt != nullptr && tid == 0)
    tt[1] = from_acc<T>(act || !zero_dead ? lf.tau : A(0));
  if (act) {
    A v2[kMaxE];
#pragma unroll
    for (int m = 0; m < kMaxE; ++m) {
      const int e = e0 + m;
      v2[m] = (m < E && e < L) ? refl_v(lf, x2, 1, e) : A(0);
    }
    if (rf.tau != A(0))
      for (int c = tid; c < L; c += kThreads)
        piv[c * rs] = from_acc<S>(c == 0 ? rnd<T>(rf.beta) : A(0));
    for (int wb = 0; wb < gm.W; wb += NG) {
      const int w = wb + grp;
      const bool on = w < gm.W;
      S* col = lay.col(on ? w : 0);
      const int stride = lay.cs(on ? w : 0);
      A x[kMaxE];
      A s = 0;
#pragma unroll
      for (int m = 0; m < kMaxE; ++m) {
        const int e = e0 + m;
        x[m] = (on && m < E && e < L) ? to_acc(col[e * stride]) : A(0);
        s += v2[m] * x[m];
      }
      s = group_sum<GS>(s);
#pragma unroll
      for (int m = 0; m < kMaxE; ++m) {
        const int e = e0 + m;
        if (!(on && m < E && e < L)) continue;
        if (w == 0) {
          if (lf.tau != A(0))
            col[e * stride] = from_acc<S>(e == 0 ? rnd<T>(lf.beta) : A(0));
        } else {
          col[e * stride] = from_acc<S>(rnd<T>(x[m] - lf.tau * (v2[m] * s)));
        }
      }
    }
  }
  if (kAsync) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Kernel 1: one cycle on each of G rolled dense windows
// ---------------------------------------------------------------------------

// x2 after the panels: (R*L + L*(b_in+1)) words
template <typename A>
__device__ A* x2_of(const Panels<A>& pn) {
  return pn.rp + pn.L * pn.rld;
}

template <typename T, int GS>
__global__ void __launch_bounds__(kThreads)
chase_cycle_kernel(T* windows, const unsigned char* is_first, int b_in,
                   int tw, T* tape_v, T* tape_tau) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using A = typename AccOf<T>::type;
  const int g = blockIdx.x;
  const Geom gm = geom_of(b_in, tw);
  const int L = gm.L, W = gm.W, nt = blockDim.x;
  const Panels<A> pn = panels_of<A>(smem_raw, gm);
  T* win = windows + (size_t)g * gm.H * W;
  for (int i = threadIdx.x; i < gm.R * L; i += nt)
    pn.cp[i] = to_acc(win[(tw + i / L) * W + i % L]);
  for (int i = threadIdx.x; i < L * b_in; i += nt)
    pn.rp[(i / b_in) * pn.rld + i % b_in] =
        to_acc(win[(gm.H - 1 - tw + i / b_in) * W + tw + 1 + i % b_in]);
  __syncthreads();
  cycle<T, GS>(pn, gm, x2_of(pn), true, is_first[g] != 0,
               tape_v ? tape_v + (size_t)g * 2 * L : nullptr,
               tape_tau ? tape_tau + (size_t)g * 2 : nullptr, false);
  for (int i = threadIdx.x; i < gm.R * L; i += nt)
    win[(tw + i / L) * W + i % L] = from_acc<T>(pn.cp[i]);
  for (int i = threadIdx.x; i < L * b_in; i += nt)
    win[(gm.H - 1 - tw + i / b_in) * W + tw + 1 + i % b_in] =
        from_acc<T>(pn.rp[(i / b_in) * pn.rld + i % b_in]);
}

// ---------------------------------------------------------------------------
// Kernel 2: K cycles of one sweep per block, on the band in place
// ---------------------------------------------------------------------------

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

// The moves between the panels and the band, each cell by one thread: the
// column panel walked by (band row d, column c), the row panel's cells left
// of the corner by (d, row k).  The corner rp(r, b_in-L+c) goes with cp(r,
// c) (one band row), so the thread that carries it also reloads it.

// Store: every cp cell and the rp cells left of the corner to the window
// at band column col0; the corner too when `corner`.
template <typename T, typename A>
__device__ void panels_out(const Panels<A>& pn, const Geom& gm, T* band,
                           int ld, int col0, bool corner) {
  const int nt = blockDim.x;
  const int L = pn.L, b_in = pn.b_in, tw = pn.tw;
  const int jc = b_in - L;                 // first corner column of rp
  for (int idx = threadIdx.x; idx < gm.H * L; idx += nt) {
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
__device__ void panels_in(const Panels<A>& pn, const Geom& gm,
                          const T* band, int ld, int col0, bool carry) {
  const int nt = blockDim.x;
  const int L = pn.L, b_in = pn.b_in, tw = pn.tw;
  const int jc = b_in - L;
  for (int idx = threadIdx.x; idx < gm.H * L; idx += nt) {
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

template <typename T, int GS>
__global__ void __launch_bounds__(kThreads)
chase_superstep_kernel(const SuperArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
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
  const Geom gm = geom_of(a.b_in, a.tw);
  const Panels<A> pn = panels_of<A>(smem_raw, gm);
  T* band = a.base + b * a.band_stride;
  const int p = a.p != nullptr ? a.p[g] : 0;
  const int L = pn.L;
  panels_in<T, A>(pn, gm, band, a.ld, p, false);
  __syncthreads();
  for (int i = 0; i <= last; ++i) {
    const bool act = live[i] != 0;
    const bool next = i < last;
    if (act || tape) {
      const long long slot = b * a.tape_stride + (long long)g * K + i;
      cycle<T, GS>(pn, gm, x2_of(pn), act, i == 0 && a.first[s] != 0,
                   tape ? a.tape_v + slot * 2 * L : nullptr,
                   tape ? a.tape_tau + slot * 2 : nullptr,
                   a.zero_dead_tau != 0);
    }
    const int col0 = p + i * a.b_in;
    // the corner is final unless the next cycle is live and changes it
    if (act)
      panels_out<T, A>(pn, gm, band, a.ld, col0, !(next && live[i + 1]));
    if (next) {
      panels_in<T, A>(pn, gm, band, a.ld, col0 + a.b_in, true);
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 3: cycle t of a stage on the band in place, moved by TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
               "r"(bar), "r"(bytes) : "memory");
}

// wait for the completion of the barrier's phase of this parity; a wait of
// about 2^33 clocks (seconds) traps instead of hanging the card
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

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

template <typename T> struct CycleArgs {
  const int* p;                 // row t of p_safe (G,)
  int G;
  const unsigned char* first;   // row t of first (B*G,)
  const unsigned char* live;    // row t of live (G,)
  T* tape_v;                    // null: no tape; else row t of the tape:
  T* tape_tau;                  //   slot (b, g) at b*tape_stride + g
  long long tape_stride;
  int b_in, tw, ld;             // ld: the box's columns BW
  int x2_off, bar_off;          // bytes from the 128-aligned base
};

template <typename T, int GS>
__global__ void __launch_bounds__(kThreads)
chase_cycle_band_kernel(const __grid_constant__ CUtensorMap map,
                        const CycleArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using A = typename AccOf<T>::type;
  const int s = blockIdx.x;
  const int b = s / a.G;
  const int g = s - b * a.G;
  const bool act = a.live[g] != 0;
  const bool tape = a.tape_v != nullptr;
  if (!act && !tape) return;                     // uniform across the block
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  const Geom gm = geom_of(a.b_in, a.tw);
  T* tile = reinterpret_cast<T*>(base);
  A* x2 = reinterpret_cast<A*>(base + a.x2_off);
  const uint32_t tile_s = (uint32_t)__cvta_generic_to_shared(tile);
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(base + a.bar_off);
  const int p = a.p[g];
  const int p0 = p & ~(int)(16 / sizeof(T) - 1);   // a box starts 16-aligned
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar, (uint32_t)(a.ld * gm.H * sizeof(T)));
    tma_load(tile_s, &map, bar, p0, 0, b);
  }
  __syncthreads();
  mbar_wait(bar, 0);
  const Tile<T> lay{tile + (p - p0), a.ld, gm.H, gm.tw, a.ld + 1};
  const long long slot = b * a.tape_stride + g;
  cycle<T, GS, true>(lay, gm, x2, act, a.first[s] != 0,
                     tape ? a.tape_v + slot * 2 * gm.L : nullptr,
                     tape ? a.tape_tau + slot * 2 : nullptr, true);
  if (act && threadIdx.x == 0) tma_store(&map, tile_s, p0, 0, b);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// The lanes per row (column): the fewest whose kMaxE elements each cover
// the tw + 1 of a row.  0 when no group is wide enough.
inline int group_size(int tw) {
  const int L = tw + 1;
  for (int gs = 2; gs <= 32; gs *= 2)
    if (L <= gs * kMaxE) return gs;
  return 0;
}

// Runs the statements with the group size GSV as the constant GS (a
// template argument); returns cudaErrorInvalidValue for any other value.
#define CHASE_DISPATCH_GS(GSV, ...)                          \
  switch (GSV) {                                             \
    case 2: { constexpr int GS = 2; __VA_ARGS__ } break;     \
    case 4: { constexpr int GS = 4; __VA_ARGS__ } break;     \
    case 8: { constexpr int GS = 8; __VA_ARGS__ } break;     \
    case 16: { constexpr int GS = 16; __VA_ARGS__ } break;   \
    case 32: { constexpr int GS = 32; __VA_ARGS__ } break;   \
    default: return (int)cudaErrorInvalidValue;              \
  }

template <typename T>
int panels_need(int b_in, int tw) {
  using A = typename AccOf<T>::type;
  const int L = tw + 1;
  return ((b_in + tw + 1) * L + L * (b_in + 1) + L) * (int)sizeof(A);
}

template <typename T>
int launch_cycle(void* windows, const void* is_first, int G, int b_in, int tw,
                 void* tape_v, void* tape_tau, int bytes, void* stream) {
  if (bytes < panels_need<T>(b_in, tw) || b_in < tw + 1)
    return (int)cudaErrorInvalidValue;
  if (G == 0) return (int)cudaSuccess;
  CHASE_DISPATCH_GS(group_size(tw), {
    cudaError_t err = set_smem(chase_cycle_kernel<T, GS>, bytes);
    if (err != cudaSuccess) return (int)err;
    chase_cycle_kernel<T, GS><<<G, kThreads, bytes, (cudaStream_t)stream>>>(
        (T*)windows, (const unsigned char*)is_first, b_in, tw, (T*)tape_v,
        (T*)tape_tau);
  })
  return (int)cudaGetLastError();
}

// configure: set the kernel's shared-memory limit first (a stage's plan
// does it once, when it is made)
template <typename T>
int launch_super(const SuperArgs<T>& a, int slots, int bytes, void* stream,
                 bool configure = true) {
  if (bytes < panels_need<T>(a.b_in, a.tw) || a.b_in < a.tw + 1 ||
      a.fuse < 1)
    return (int)cudaErrorInvalidValue;
  if (slots == 0) return (int)cudaSuccess;
  CHASE_DISPATCH_GS(group_size(a.tw), {
    if (configure) {
      cudaError_t err = set_smem(chase_superstep_kernel<T, GS>, bytes);
      if (err != cudaSuccess) return (int)err;
    }
    chase_superstep_kernel<T, GS>
        <<<slots, kThreads, bytes, (cudaStream_t)stream>>>(a);
  })
  return (int)cudaGetLastError();
}

// ---- a stage's plan: the checks, the tensor map and the limits, once ------

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

template <typename T> struct MapType;
template <> struct MapType<double> {
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT64;
};
template <> struct MapType<float> {
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <> struct MapType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

struct alignas(64) BandPlan {
  CUtensorMap map;              // (n_pad, H, B), boxes (box_w, H, 1)
  void* band;
  const int* p;                 // p_safe (T, G) int32
  const unsigned char* first;   // (T, B*G)
  const unsigned char* live;    // (T, G, K)
  void* tape_v;                 // null, or (B, T, G, K, 2, tw+1)
  void* tape_tau;               //          (B, T, G, K, 2)
  int B, H, n_pad, T, G, b_in, tw, fuse;
  int smem;                     // the panels (kernel 2)
  int tile_smem;                // kernel 3's; 0: kernel 3 not used
  int box_w, x2_off, bar_off;
};

BandPlan* plan_at(void* buf) {
  return reinterpret_cast<BandPlan*>(
      (reinterpret_cast<uintptr_t>(buf) + 63) & ~uintptr_t(63));
}

template <typename T>
int make_plan(void* buf, void* band, int B, int n_pad, const void* p, int T_,
              int G, const void* first, const void* live, void* tape_v,
              void* tape_tau, int b_in, int tw, int fuse, int smem,
              int tile_smem, int box_w) {
  using A = typename AccOf<T>::type;
  BandPlan* P = plan_at(buf);
  *P = BandPlan{};
  P->band = band;
  P->p = (const int*)p;
  P->first = (const unsigned char*)first;
  P->live = (const unsigned char*)live;
  P->tape_v = tape_v;
  P->tape_tau = tape_tau;
  P->B = B;
  P->H = b_in + 2 * tw + 1;
  P->n_pad = n_pad;
  P->T = T_;
  P->G = G;
  P->b_in = b_in;
  P->tw = tw;
  P->fuse = fuse;
  P->smem = smem;
  if (smem < panels_need<T>(b_in, tw) || b_in < tw + 1 || fuse < 1 ||
      group_size(tw) == 0)
    return (int)cudaErrorInvalidValue;
  CHASE_DISPATCH_GS(group_size(tw), {
    cudaError_t err = set_smem(chase_superstep_kernel<T, GS>, smem);
    if (err != cudaSuccess) return (int)err;
  })
  if (tile_smem == 0 || fuse != 1) return (int)cudaSuccess;
  // kernel 3: the box, x2 and the barrier behind it, 128 bytes of slack to
  // align the base
  const int tile = P->H * box_w * (int)sizeof(T);
  P->x2_off = (tile + 15) & ~15;
  P->bar_off = (P->x2_off + (tw + 1) * (int)sizeof(A) + 7) & ~7;
  const int per = 16 / (int)sizeof(T);           // elements in 16 bytes
  if (box_w < b_in + tw + per || box_w > 256 || P->H > 256 ||
      (box_w * (int)sizeof(T)) % 16 != 0 ||
      ((long long)n_pad * sizeof(T)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(band) % 16 != 0 ||
      tile_smem < P->bar_off + 8 + 128)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint64_t dims[3] = {(cuuint64_t)n_pad, (cuuint64_t)P->H,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)n_pad * sizeof(T),
                                 (cuuint64_t)n_pad * P->H * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)box_w, (cuuint32_t)P->H, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(&P->map, MapType<T>::kType, 3, band, dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 100000 + (int)r;
  CHASE_DISPATCH_GS(group_size(tw), {
    cudaError_t err = set_smem(chase_cycle_band_kernel<T, GS>, tile_smem);
    if (err != cudaSuccess) return (int)err;
  })
  P->tile_smem = tile_smem;
  P->box_w = box_w;
  return (int)cudaSuccess;
}

// (super-)cycle t of the plan's stage: kernel 3 at fuse 1 where the plan
// made its tensor map, else kernel 2
template <typename T>
int run_plan(const void* buf, int t, void* stream) {
  const BandPlan* P = plan_at(const_cast<void*>(buf));
  if (t < 0 || t >= P->T) return (int)cudaErrorInvalidValue;
  const int K = P->fuse, L = P->tw + 1, G = P->G;
  const long long row = (long long)t * G * K;    // pairs before row t
  T* tv = P->tape_v ? (T*)P->tape_v + row * 2 * L : nullptr;
  T* tt = P->tape_tau ? (T*)P->tape_tau + row * 2 : nullptr;
  const long long tape_stride = (long long)P->T * G * K;
  if (P->tile_smem > 0) {
    const CycleArgs<T> a{P->p + (long long)t * G, G,
                         P->first + (long long)t * P->B * G, P->live + row,
                         tv, tt, tape_stride, P->b_in, P->tw, P->box_w,
                         P->x2_off, P->bar_off};
    CHASE_DISPATCH_GS(group_size(P->tw), {
      chase_cycle_band_kernel<T, GS>
          <<<P->B * G, kThreads, P->tile_smem, (cudaStream_t)stream>>>(
              P->map, a);
    })
    return (int)cudaGetLastError();
  }
  const SuperArgs<T> a{(T*)P->band, (long long)P->H * P->n_pad, P->n_pad,
                       P->p + (long long)t * G, G,
                       P->first + (long long)t * P->B * G, P->live + row, 0,
                       tv, tt, tape_stride, 1, P->b_in, P->tw, K};
  return launch_super<T>(a, P->B * G, P->smem, stream, false);
}

}  // namespace

// Plain C interface, one symbol per storage type.  Pointers are device
// pointers; tape_v / tape_tau are null when no tape is wanted.  smem_bytes
// is the dynamic shared memory of one block as tuning.smem_bytes counts it.
// Each returns 0 on success, else cudaGetLastError() after the launch (or
// the error that refused it).
//
// chase_cycle_*: one cycle on each of G rolled dense windows (G, H, W) in
// place, is_first (G,), the tape (G, 2, tw+1) and (G, 2) with raw taus.
// chase_superstep_*: G contiguous blocks (G, H, WK), is_first (G,), active
// (G, K), the tape (G, K, 2, tw+1) and (G, K, 2) with the raw tau of every
// cycle.
//
// A stage on the padded band (B, H, n_pad), in place: chase_band_plan_*
// fills a plan in `buf` (chase_band_plan_size() bytes, any alignment) from
// the stage's tables p_safe (T, G) int32, first (T, B*G), live (T, G, K)
// and its tape (B, T, G, K, 2, tw+1) and (B, T, G, K, 2) (tau = 0 for
// cycles not live), all device pointers that must outlive the plan.  With
// fuse = 1 and tile_smem > 0 it makes kernel 3's tensor map, boxes of
// box_w columns (a multiple of 16 bytes, at least W + 16 bytes - 1
// element, box_w <= 256, H <= 256; n_pad * the item size and the band
// pointer 16-byte aligned); returns -1 when the
// driver's cuTensorMapEncodeTiled cannot be reached and 100000 + the
// CUresult when the map is refused.  chase_band_run_* launches
// (super-)cycle t of the plan on `stream`: one launch, of kernel 3 when
// the plan has its map, else of kernel 2.
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
  extern "C" int chase_band_plan_##SUFFIX(                                   \
      void* buf, void* band, int B, int n_pad, const void* p, int T_, int G, \
      const void* first, const void* live, void* tape_v, void* tape_tau,     \
      int b_in, int tw, int fuse, int smem_bytes, int tile_smem,             \
      int box_w) {                                                           \
    return make_plan<T>(buf, band, B, n_pad, p, T_, G, first, live, tape_v,  \
                        tape_tau, b_in, tw, fuse, smem_bytes, tile_smem,     \
                        box_w);                                              \
  }                                                                          \
  extern "C" int chase_band_run_##SUFFIX(const void* buf, int t,             \
                                         void* stream) {                     \
    return run_plan<T>(buf, t, stream);                                      \
  }

extern "C" int chase_band_plan_size() { return (int)sizeof(BandPlan) + 64; }

CHASE_API(f64, double)
CHASE_API(f32, float)
CHASE_API(bf16, __nv_bfloat16)
