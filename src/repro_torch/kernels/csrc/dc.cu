// Divide-and-conquer stage 3 on Hopper (sm_90a): the three sequential parts
// of src/repro_torch/core/bidiag_dc.py as kernels.
//
// No TPU kernel is replaced: the reference's divide and conquer
// (src/repro/core/bidiag_dc.py) is jnp code that XLA fuses, with no
// pallas_call.  Its sequential parts would be Python loops of tiny ops in
// eager PyTorch (tens of thousands of launches a call, and a host sync per
// data-dependent skip), so they get kernels.  Plain versions, bit for bit
// or within rounding as said below: core/bidiag_dc.py (leaf_eigen_plain,
// deflate_plain, secular_plain).  Where a result must be bit for bit, no
// multiply and add may be contracted into an FMA: the leaf's count
// recurrence has none to contract, and the scan's rotations are written
// with mul_rn / add_rn / sub_rn (__dmul_rn, ...), which round each
// operation as the plain versions' torch operations do.  Everything else
// (inverse iteration, Gram-Schmidt, the secular sums) is held to a
// tolerance, and nvcc contracts it freely.
//
//  * dc_leaf_kernel replaces _leaf_eigen (bidiag_dc.py:171) with
//    _tridiag_count (:114) and _tridiag_solve_diag (:134).  One block per
//    leaf of lm = 2 * leaf_n rows; the leaf's diagonals, eigenvalues and
//    vectors (an lm x (lm + 1) array, column k vector k) in shared memory,
//    the factors of each vector's shift (multipliers and reciprocal
//    pivots) in a (2, P, lm, lm) scratch in device memory (thread k's
//    column coalesced across a warp; it stays in L2).  Bound: latency.  A
//    count is a chain of lm dependent steps with an IEEE division.  A
//    first design gave each index one thread and bisect_iters counts in a
//    row, and ran every round of the Gram-Schmidt block-wide whether or
//    not it had work.  This one:
//      - bisects on csrc/sturm_device.cuh's schedule with the leaf's
//        count: the 2^d - 1 nodes of the tree's top under [lo0, hi0]
//        counted once per leaf, one thread a node, then each index walks
//        them and goes on s levels a round over a group of 2^s lanes
//        (dc.leaf_schedule picks (d, s), lm 2^s <= 512 threads).  Every
//        midpoint is the sequential bisection's, so the eigenvalues are
//        bit for bit the plain version's;
//      - runs the inverse iteration one thread a vector, T - lam_k I
//        factored once (one reciprocal a pivot) for every step, and for
//        the fallback's;
//      - runs the same-cluster Gram-Schmidt by cluster runs: vector k's
//        window (earlier eigenvalues within ctol) lies inside its run
//        (consecutive gaps below ctol), so a vector whose window is empty
//        is only normalised, by its own thread, and each run of two or
//        more goes to one warp, which takes only its rounds, in k order,
//        with no block barrier (leaf_round), and solves a collapsed
//        vector's fallback itself (leaf_apply_warp).  The pipeline's
//        leaves hold one run of up to 63 (the tail of tiny singular
//        values), whose rounds cannot overlap: the whole block over each
//        round, three barriers a round, read slower on the H100.
//  * dc_deflate_kernel replaces the Givens scan of _merge_pair
//    (:574-605).  Bound: latency, a chain of dependent steps with a square
//    root and two divisions (about 0.29 us a step on the H100): one thread
//    walking a subproblem takes 8,191 of them at the top merge level of an
//    n = 4096 bidiagonal.  So the chain is split, one block a subproblem.
//    Only the columns up to the last active one can merge (a merge needs
//    both flags, and the carry's flag is always its column's input flag),
//    so the block first finds that column, `last`, and walks steps
//    1..last only: every later column is its own output.  If step i - 1
//    did not merge, the carry entering step i is column i - 1 as it came
//    in, so a step's outcome then depends on the inputs alone.  Phase 1:
//    one thread a chunk of the steps runs its chunk on that assumption
//    (the speculative run), writing its columns to a scratch copy and
//    keeping its last carry and whether its last step merged.  Phase 2:
//    warp 0 finds by ballot each chunk whose previous step truly merged,
//    and one thread reruns it from the true carry until a step where
//    neither run merged (from there both carry the same input column), or
//    to its end, whose carry then passes on.  The inputs stay untouched
//    until phase 3 copies the scratch back over columns 0..last, so a
//    rerun reads them again; the reruns' length is that of the merge runs
//    that cross a chunk's start.  Every step is the plain scan's rounded
//    arithmetic (mul_rn, add_rn), so the result is bit for bit
//    deflate_plain.  The chunks' loads and stores are scattered (one
//    column of each chunk a step), so a block's time grows with its steps
//    per SM: at the top level one SM walks all of them.
//  * dc_secular_kernel replaces the root solve of _secular_roots
//    (:297-527).  One warp per root of the active prefix (only the prefix
//    is launched); the midpoint and polish passes split the pole sum over
//    the lanes and reduce by shuffles, the windowed iteration keeps the 128
//    index-nearest and 32 heaviest poles in registers (4 + 1 a lane), and a
//    warp stops polishing when its root's residual reaches the rounding
//    floor (the reference freezes such a root in its lockstep loop), and
//    leaves the windowed iteration once its root is frozen there (the
//    iterations left would change nothing).  Bound: operations, the full
//    passes' divisions.  Each pole costs one: q = 1 / (d_i - mu), then
//    w_i q and w_i q^2, where w / den and r / den would cost two.  Roots agree with the plain version within rounding (the
//    sums are taken in another order, and rounded otherwise).

#include <cuda_runtime.h>

#include <cfloat>

#include "sturm_device.cuh"

namespace {

template <typename A> struct Eps;
template <> struct Eps<double> { static constexpr double v = DBL_EPSILON; };
template <> struct Eps<float> { static constexpr float v = FLT_EPSILON; };

// one rounding per operation, never contracted into an FMA
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}

template <typename A>
__device__ __forceinline__ A guard(A p, A tiny) {
  return fabs(p) < tiny ? (p < 0 ? -tiny : tiny) : p;
}

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// leaves
// ---------------------------------------------------------------------------

// most threads of a leaf block, the cap of tuning.DC_LEAF_THREADS (which
// says why), by which dc.leaf_schedule picks s; the entry only checks it
constexpr int kLeafThreads = 512;
// most rows of a vector a lane holds in the Gram-Schmidt, so lm <= 32
// times this (shared memory caps lm at 166 fp64, 238 fp32)
template <typename A>
constexpr int kLeafRows = sizeof(A) == 8 ? 6 : 8;

// negative pivots of T - mid I, T of diagonal sa and squared off-diagonal
// sbb (lm rows): the plain version's _tridiag_count, pivots guarded at
// tiny4; a division a step, no FMA to contract
template <typename A>
__device__ __forceinline__ int leaf_count(const A* sa, const A* sbb, int lm,
                                          A mid, A tiny4) {
  A q = sa[0] - mid;
  int cnt = q < A(0);
#pragma unroll 8
  for (int i = 1; i < lm; ++i) {
    q = guard(q, tiny4);
    q = (sa[i] - mid) - sbb[i - 1] / q;
    cnt += q < A(0);
  }
  return cnt;
}

// the factors of T - shift I in Thomas elimination, pivots guarded at tg:
// the multipliers c[i * ldc] = b_i / piv_i (i < lm - 1) and the
// reciprocal pivots r[i * ldc] (one reciprocal a pivot, not two divisions)
template <typename A>
__device__ __forceinline__ void leaf_factor(A* c, A* r, int ldc, const A* sa,
                                            const A* sb, int lm, A shift,
                                            A tg) {
  A rp = A(1) / guard(sa[0] - shift, tg);
  r[0] = rp;
  for (int i = 1; i < lm; ++i) {
    const A bi = sb[i - 1];
    const A ci = bi * rp;
    rp = A(1) / guard((sa[i] - shift) - bi * ci, tg);
    c[(i - 1) * ldc] = ci;
    r[i * ldc] = rp;
  }
}

// x = (T - shift I)^-1 x in place on a column x[i * ldx] of lm rows, from
// leaf_factor's factors (stride ldc).  The entries and factors of
// kLeafChunk rows are loaded before the chunk's steps and stored after
// them, so no load waits on the chain (nor on a store it might alias).
constexpr int kLeafChunk = 8;

template <typename A>
__device__ __forceinline__ void leaf_apply(A* x, int ldx, const A* c,
                                           const A* r, int ldc, const A* sb,
                                           int lm) {
  A y = 0;
  for (int i0 = 0; i0 < lm; i0 += kLeafChunk) {
    A xx[kLeafChunk], rr[kLeafChunk], bb[kLeafChunk];
#pragma unroll
    for (int u = 0; u < kLeafChunk; ++u) {
      const int i = i0 + u;
      xx[u] = i < lm ? x[i * ldx] : A(0);
      rr[u] = i < lm ? r[i * ldc] : A(0);
      bb[u] = i > 0 && i < lm ? sb[i - 1] : A(0);
    }
#pragma unroll
    for (int u = 0; u < kLeafChunk; ++u)
      if (i0 + u < lm) {
        y = (xx[u] - bb[u] * y) * rr[u];   // bb = 0 at row 0
        xx[u] = y;
      }
#pragma unroll
    for (int u = 0; u < kLeafChunk; ++u)
      if (i0 + u < lm) x[(i0 + u) * ldx] = xx[u];
  }
  for (int i1 = lm - 1; i1 > 0; i1 -= kLeafChunk) {  // rows i1 - 1 down
    A xx[kLeafChunk], cc[kLeafChunk];
#pragma unroll
    for (int u = 0; u < kLeafChunk; ++u) {
      const int i = i1 - 1 - u;
      xx[u] = i >= 0 ? x[i * ldx] : A(0);
      cc[u] = i >= 0 ? c[i * ldc] : A(0);
    }
#pragma unroll
    for (int u = 0; u < kLeafChunk; ++u) {
      y = xx[u] - cc[u] * y;
      xx[u] = y;
    }
#pragma unroll
    for (int u = 0; u < kLeafChunk; ++u)
      if (i1 - 1 - u >= 0) x[(i1 - 1 - u) * ldx] = xx[u];
  }
}

// One warp's round of the Gram-Schmidt for vector k of a run: w (the
// lane's rows lane + 32 u) = src - sum over j in [jw, k) of (V_j . src)
// V_j, src column k of V as it stands, or where `unit`, e_k (whose dots
// are row k of V); returns ||w|| on every lane.  Lane jj forms the dots of
// columns jw + jj + 32 u over all the rows (two partial sums each), then
// each lane takes its rows' terms, the dots passed by shuffles: no
// reduction a column, and no barrier, since a warp holds a whole run.
template <typename A, int ROWS>
__device__ __forceinline__ A leaf_round(A (&w)[ROWS], const A* V, int ld,
                                        int lm, int jw, int k, bool unit,
                                        int lane) {
  const int nwin = k - jw, nd = (nwin + 31) >> 5;
  A dots[ROWS], odd[ROWS];
  const A* col[ROWS];
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    col[u] = V + jw + min(lane + 32 * u, nwin - 1);
    dots[u] = unit && u < nd ? col[u][k * ld] : A(0);
    odd[u] = 0;
  }
  if (!unit) {
    int i = 0;
#pragma unroll 4
    for (; i + 2 <= lm; i += 2) {
      const A v0 = V[i * ld + k], v1 = V[(i + 1) * ld + k];
#pragma unroll
      for (int u = 0; u < ROWS; ++u)
        if (u < nd) {
          dots[u] += col[u][i * ld] * v0;
          odd[u] += col[u][(i + 1) * ld] * v1;
        }
    }
    if (i < lm) {
      const A v0 = V[i * ld + k];
#pragma unroll
      for (int u = 0; u < ROWS; ++u)
        if (u < nd) dots[u] += col[u][i * ld] * v0;
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) dots[u] += odd[u];
  }
  A w2[ROWS];
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int i = lane + 32 * u;
    w[u] = i < lm ? (unit ? A(i == k) : V[i * ld + k]) : A(0);
    w2[u] = 0;
  }
#pragma unroll
  for (int u2 = 0; u2 < ROWS; ++u2) {
    if (32 * u2 < nwin) {
      const int cnt = min(32, nwin - 32 * u2);
      const A* c2 = V + jw + 32 * u2;
      int jl = 0;
#pragma unroll 4
      for (; jl + 2 <= cnt; jl += 2) {
        const A d0 = __shfl_sync(0xffffffffu, dots[u2], jl);
        const A d1 = __shfl_sync(0xffffffffu, dots[u2], jl + 1);
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          const int i = lane + 32 * u;
          if (i < lm) {
            w[u] -= d0 * c2[i * ld + jl];
            w2[u] -= d1 * c2[i * ld + jl + 1];
          }
        }
      }
      if (jl < cnt) {
        const A d0 = __shfl_sync(0xffffffffu, dots[u2], jl);
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          const int i = lane + 32 * u;
          if (i < lm) w[u] -= d0 * c2[i * ld + jl];
        }
      }
    }
  }
  A nn = 0;
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    w[u] += w2[u];
    nn += w[u] * w[u];
  }
  return sqrt(warp_sum(nn));
}

// x = (T - shift I)^-1 x for a vector a warp holds (the lane's rows
// lane + 32 u), from leaf_factor's factors c, r in device memory: every
// lane runs the same chain, each step's entry and factors passed by
// shuffles from the lane that holds them, which keeps the result.  The
// chain writes to yv in the forward pass and to x in the back pass, so no
// shuffle waits on it.
template <typename A, int ROWS>
__device__ __forceinline__ void leaf_apply_warp(A (&x)[ROWS], const A* c,
                                                const A* r, int ldc,
                                                const A* sb, int lm,
                                                int lane) {
  A rr[ROWS], cc[ROWS], yv[ROWS];
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int i = lane + 32 * u;
    rr[u] = i < lm ? r[i * ldc] : A(0);
    cc[u] = i < lm - 1 ? c[i * ldc] : A(0);
    yv[u] = 0;
  }
  A y = 0;
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int cnt = min(32, lm - 32 * u);
#pragma unroll 8
    for (int il = 0; il < cnt; ++il) {
      const int i = 32 * u + il;
      const A xi = __shfl_sync(0xffffffffu, x[u], il);
      const A ri = __shfl_sync(0xffffffffu, rr[u], il);
      y = (i > 0 ? xi - sb[i - 1] * y : xi) * ri;
      if (lane == il) yv[u] = y;
    }
  }
  // back: x_i = y_i - c_i x_{i+1} from i = lm - 2 down (x_{lm-1} = y)
#pragma unroll
  for (int u = ROWS - 1; u >= 0; --u) {
    const int cnt = min(32, lm - 1 - 32 * u);
    x[u] = yv[u];
#pragma unroll 8
    for (int il = cnt - 1; il >= 0; --il) {
      const A yi = __shfl_sync(0xffffffffu, yv[u], il);
      const A ci = __shfl_sync(0xffffffffu, cc[u], il);
      y = yi - ci * y;
      if (lane == il) x[u] = y;
    }
  }
}

template <typename A, int ROWS>
__global__ void __launch_bounds__(kLeafThreads)
    dc_leaf_kernel(const A* __restrict__ a, const A* __restrict__ b,
                   const A* __restrict__ lo0, const A* __restrict__ hi0,
                   const A* __restrict__ ctol, const A* __restrict__ x0,
                   A* __restrict__ lam, A* __restrict__ f, A* __restrict__ l,
                   A* __restrict__ scratch, int lm, int d, int s,
                   int bisect_iters, int inv_iters, int fallback_iters,
                   A tiny4, A tiny) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = lm + 1;
  A* V = reinterpret_cast<A*>(smem_raw);  // V[i * ld + k]: vector k
  A* sa = V + lm * ld;                     // diagonal
  A* sb = sa + lm;                         // off-diagonal (last entry 0)
  A* sbb = sb + lm;                        // its squares
  A* sl = sbb + lm;                        // eigenvalues
  A* sg = sl + lm;                         // [0]: inverse iteration's guard
  int* cb = reinterpret_cast<int*>(sg + 1);  // counts of the tree's top
  const long p = blockIdx.x;
  const int t = threadIdx.x, nthr = blockDim.x;
  const int lane = t & 31, warp = t >> 5;
  // the factors of vector k's shift: C[i * lm + k], R[i * lm + k]
  A* C = scratch + p * lm * lm;
  A* R = scratch + ((long)gridDim.x + p) * lm * lm;
  for (int i = t; i < lm; i += nthr) {
    sa[i] = a[p * lm + i];
    const A bi = i < lm - 1 ? b[p * (lm - 1) + i] : A(0);
    sb[i] = bi;
    sbb[i] = bi * bi;
  }
  __syncthreads();
  if (warp == 0) {  // the pivot guard: eps * max(|a|, |b|, 1)
    A m = 1;
    for (int i = lane; i < lm; i += 32)
      m = fmax(m, fmax(fabs(sa[i]), fabs(sb[i])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmax(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) *sg = Eps<A>::v * m;
  }
  // the bisection (csrc/sturm_device.cuh's schedule, this leaf's count):
  // the 2^d - 1 nodes of the tree's top, one thread a node, then index k
  // = t >> s walks them and goes on s levels a round over its 2^s lanes;
  // every midpoint is the sequential bisection's, so lam is bit for bit
  const A lo_0 = lo0[p], hi_0 = hi0[p];
  if (t < (1 << d) - 1) {
    A lo = lo_0, hi = hi_0;
    descend(t + 1, lo, hi);
    cb[t + 1] = leaf_count(sa, sbb, lm, A(0.5) * (lo + hi), tiny4);
  }
  __syncthreads();
  {
    const int g = t >> s, gl = t & ((1 << s) - 1);
    const int k1 = min(g, lm - 1) + 1;       // lanes past lm << s shadow
    A lo = lo_0, hi = hi_0;                  //   the last index
    walk_top(cb, 0, k1, d, lo, hi);
    bisect_rounds_by(
        [&](A mid) { return leaf_count(sa, sbb, lm, mid, tiny4); }, 0, k1,
        gl, s, d, bisect_iters, lo, hi);
    if (g < lm && gl == 0) sl[g] = A(0.5) * (lo + hi);
  }
  __syncthreads();
  const A ct = ctol[p];
  // inverse iteration, one thread a vector: T - lam_k I factored once
  if (t < lm) {
    const int k = t;
    const A lk = sl[k];
    for (int i = 0; i < lm; ++i) V[i * ld + k] = x0[k * lm + i];
    if (inv_iters > 0 || fallback_iters > 0)
      leaf_factor(C + k, R + k, lm, sa, sb, lm, lk, *sg);
    // a vector with no earlier eigenvalue within ct is also normalised
    // once more, where the Gram-Schmidt would only normalise it
    const int norms = inv_iters + (k > 0 && !(lk - sl[k - 1] < ct));
    for (int r = 0; r < norms; ++r) {
      if (r < inv_iters) leaf_apply(V + k, ld, C + k, R + k, lm, sb, lm);
      A ss = 0;
      for (int i = 0; i < lm; ++i) ss += V[i * ld + k] * V[i * ld + k];
      const A inv = A(1) / fmax(sqrt(ss), tiny);
      for (int i = 0; i < lm; ++i) V[i * ld + k] *= inv;
    }
  }
  __syncthreads();
  // the Gram-Schmidt by cluster runs: a run (consecutive gaps below ct)
  // never reads another, since every window lies inside its run; run r of
  // two or more goes to warp r mod the warps, which takes it in k order
  // (leaf_round), and solves a collapsed vector's fallback itself
  // (leaf_apply_warp)
  {
    const int nwarps = nthr >> 5;
    int runs = 0;
    for (int r0 = 0; r0 < lm;) {
      int r1 = r0 + 1;
      while (r1 < lm && sl[r1] - sl[r1 - 1] < ct) ++r1;
      if (r1 - r0 > 1 && runs++ % nwarps == warp) {
        int jw = r0;          // the window's start only moves right with kk
        for (int kk = r0 + 1; kk < r1; ++kk) {
          while (!(sl[kk] - sl[jw] < ct)) ++jw;
          A w[ROWS];
          A n1 = leaf_round(w, V, ld, lm, jw, kk, false, lane);
          if (!(n1 > A(0.01))) {
            // collapsed: e_kk off the window, then fallback_iters steps of
            // inverse iteration at lam_kk with vector kk's factors, each
            // projected again and normalised
            n1 = leaf_round(w, V, ld, lm, jw, kk, true, lane);
            for (int it = 0; it < fallback_iters; ++it) {
              const A inv = A(1) / fmax(n1, tiny);
#pragma unroll
              for (int u = 0; u < ROWS; ++u) w[u] *= inv;
              leaf_apply_warp(w, C + kk, R + kk, lm, sb, lm, lane);
#pragma unroll
              for (int u = 0; u < ROWS; ++u)
                if (lane + 32 * u < lm) V[(lane + 32 * u) * ld + kk] = w[u];
              __syncwarp();
              n1 = leaf_round(w, V, ld, lm, jw, kk, false, lane);
            }
          }
          const A inv = A(1) / fmax(n1, tiny);
#pragma unroll
          for (int u = 0; u < ROWS; ++u)
            if (lane + 32 * u < lm) V[(lane + 32 * u) * ld + kk] = w[u] * inv;
          __syncwarp();
        }
      }
      r0 = r1;
    }
  }
  __syncthreads();
  if (t < lm) {
    lam[p * lm + t] = sl[t];
    f[p * lm + t] = V[t];
    l[p * lm + t] = V[(lm - 1) * ld + t];
  }
}

// ---------------------------------------------------------------------------
// the Givens deflation scan
// ---------------------------------------------------------------------------

constexpr int kDeflateThreads = 512;   // most chunks a subproblem

// one step of the scan: the carry (dc, zc, fc, lc; active ac) meets column
// i (di, zi, fi, li; ai); emits column i - 1 into (od, oz, of, ol, oa) and
// leaves the next carry; returns whether the two merged
template <typename A>
__device__ __forceinline__ bool scan_step(A t, A& dc, A& zc, A& fc, A& lc,
                                          bool ac, A di, A zi, A fi, A li,
                                          bool ai, A& od, A& oz, A& of,
                                          A& ol, bool& oa) {
  const A r = sqrt(add_rn(mul_rn(zc, zc), mul_rn(zi, zi)));
  const bool pos = r > 0;
  const A rs = pos ? r : A(1);
  const A cg = pos ? zi / rs : A(1);
  const A sg = pos ? zc / rs : A(0);
  const A off = fabs(mul_rn(mul_rn(cg, sg), sub_rn(di, dc)));
  const bool mrg = ac && ai && off <= t;
  const A cc = mul_rn(cg, cg), ss = mul_rn(sg, sg);
  od = mrg ? add_rn(mul_rn(cc, dc), mul_rn(ss, di)) : dc;
  oz = mrg ? A(0) : zc;
  of = mrg ? sub_rn(mul_rn(cg, fc), mul_rn(sg, fi)) : fc;
  ol = mrg ? sub_rn(mul_rn(cg, lc), mul_rn(sg, li)) : lc;
  oa = ac && !mrg;
  dc = mrg ? add_rn(mul_rn(ss, dc), mul_rn(cc, di)) : di;
  zc = mrg ? r : zi;
  fc = mrg ? add_rn(mul_rn(sg, fc), mul_rn(cg, fi)) : fi;
  lc = mrg ? add_rn(mul_rn(sg, lc), mul_rn(cg, li)) : li;
  return mrg;
}

// one subproblem's columns: the inputs (in place, read until phase 3) and
// the scratch copy its outputs go to
template <typename A>
struct ScanRow {
  const A *d, *z, *f, *l;
  const unsigned char* a;
  A *sd, *sz, *sf, *sl;
  unsigned char* sa;

  // steps [i0, i1) from the carry, writing columns i0 - 1 ... i1 - 2 to
  // the scratch; `mrg` is the last step's merge.  A rerun (`rerun`) stops
  // after the first step where neither it nor the speculative run (whose
  // columns the scratch holds) merged, and returns true: from there the two
  // are the same.
  __device__ bool run(A t, int i0, int i1, A& dc, A& zc, A& fc, A& lc,
                      bool rerun, bool& mrg) const {
    // the next column is loaded one step ahead of its use; the carry's
    // flag is always its column's input flag
    A di = d[i0], zi = z[i0], fi = f[i0], li = l[i0];
    bool ai = a[i0] != 0, ac = a[i0 - 1] != 0;
    for (int i = i0; i < i1; ++i) {
      const A ci = di, cz = zi, cf = fi, cl = li;
      const bool ca = ai;
      if (i + 1 < i1) {
        di = d[i + 1];
        zi = z[i + 1];
        fi = f[i + 1];
        li = l[i + 1];
        ai = a[i + 1] != 0;
      }
      const bool spec = rerun && ac && !sa[i - 1];
      A od, oz, of, ol;
      bool oa;
      mrg = scan_step(t, dc, zc, fc, lc, ac, ci, cz, cf, cl, ca, od, oz, of,
                      ol, oa);
      sd[i - 1] = od;
      sz[i - 1] = oz;
      sf[i - 1] = of;
      sl[i - 1] = ol;
      sa[i - 1] = oa;
      if (rerun && !mrg && !spec) return true;
      ac = ca;
    }
    return false;
  }

  __device__ void put_last(int last, A dc, A zc, A fc, A lc) const {
    sd[last] = dc;
    sz[last] = zc;
    sf[last] = fc;
    sl[last] = lc;
    sa[last] = a[last];
  }
};

template <typename A>
__global__ void __launch_bounds__(kDeflateThreads)
    dc_deflate_kernel(A* __restrict__ d, A* __restrict__ z,
                      A* __restrict__ fe, A* __restrict__ le,
                      unsigned char* __restrict__ act,
                      const A* __restrict__ tol, A* __restrict__ scratch,
                      unsigned char* __restrict__ sact, int P, int m,
                      int chunk_min) {
  __shared__ A carry[4][kDeflateThreads];
  __shared__ bool merged[kDeflateThreads];
  __shared__ int wmax[kDeflateThreads / 32];
  __shared__ int last_s;
  const long p = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  A* dp = d + p * m;
  A* zp = z + p * m;
  A* fp = fe + p * m;
  A* lp = le + p * m;
  unsigned char* ap = act + p * m;
  const long pm = (long)P * m;
  const ScanRow<A> row{dp, zp, fp, lp, ap,
                       scratch + p * m, scratch + pm + p * m,
                       scratch + 2 * pm + p * m, scratch + 3 * pm + p * m,
                       sact + p * m};

  // the last active column
  int last = -1;
  for (int i = tid; i < m; i += nthr)
    if (ap[i]) last = i;
  last = __reduce_max_sync(0xffffffffu, last);
  if ((tid & 31) == 0) wmax[tid >> 5] = last;
  __syncthreads();
  if (tid == 0) {
    int v = -1;
    for (int w = 0; w < (nthr + 31) / 32; ++w) v = max(v, wmax[w]);
    last_s = v;
  }
  __syncthreads();
  last = last_s;
  if (last < 1) return;                 // no step can merge

  // the prefix's lines into L2, where the chunks' scattered loads meet them
  {
    constexpr int kLine = 128 / sizeof(A);
    for (int i = tid * kLine; i <= last; i += nthr * kLine) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(dp + i));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(zp + i));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(fp + i));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(lp + i));
    }
  }

  // phase 1: chunk k runs steps [1 + k c, 1 + (k + 1) c) from column k c
  const A t = tol[p];
  const int c = max(chunk_min, (last + nthr - 1) / nthr);
  const int nchunk = (last + c - 1) / c;
  if (tid < nchunk) {
    const int i0 = 1 + tid * c, i1 = min(i0 + c, last + 1);
    A dc = dp[i0 - 1], zc = zp[i0 - 1], fc = fp[i0 - 1], lc = lp[i0 - 1];
    bool mrg = false;
    row.run(t, i0, i1, dc, zc, fc, lc, false, mrg);
    carry[0][tid] = dc;
    carry[1][tid] = zc;
    carry[2][tid] = fc;
    carry[3][tid] = lc;
    merged[tid] = mrg;
    if (i1 == last + 1) row.put_last(last, dc, zc, fc, lc);
  }
  __syncthreads();

  // phase 2: the chunks whose entering carry was not the speculated one.
  // Warp 0 finds by ballot the next chunk q whose speculative run is true
  // (`from` on) and ended in a merge; lane 0 reruns chunk q + 1 from q's
  // carry, and the next ones while a rerun ends merged without meeting
  // the speculative run.
  if (tid < 32) {
    const int lane = tid;
    int from = 0;
    for (;;) {
      int q = -1;
      for (int base = from; base < nchunk - 1; base += 32) {
        const int k = base + lane;
        const unsigned bits =
            __ballot_sync(0xffffffffu, k < nchunk - 1 && merged[k]);
        if (bits) {
          q = base + __ffs(bits) - 1;
          break;
        }
      }
      if (q < 0) break;
      int next = 0;
      if (lane == 0) {
        A dc = carry[0][q], zc = carry[1][q], fc = carry[2][q],
          lc = carry[3][q];
        for (int k = q + 1;; ++k) {
          const int i0 = 1 + k * c, i1 = min(i0 + c, last + 1);
          bool mrg = false;
          if (row.run(t, i0, i1, dc, zc, fc, lc, true, mrg)) {
            next = k;              // from the meeting on, chunk k is its
            break;                 // speculative run, merged[k] its end
          }
          // the runs never met: the rerun's carry is the true one
          if (i1 == last + 1) row.put_last(last, dc, zc, fc, lc);
          if (!mrg || k + 1 == nchunk) {
            next = k + 1;          // chunk k + 1 started as speculated
            break;
          }
        }
      }
      from = __shfl_sync(0xffffffffu, next, 0);
    }
  }
  __syncthreads();

  // phase 3: the scratch back over columns 0 .. last
  for (int i = tid; i <= last; i += nthr) {
    dp[i] = row.sd[i];
    zp[i] = row.sz[i];
    fp[i] = row.sf[i];
    lp[i] = row.sl[i];
    ap[i] = row.sa[i];
  }
}

// ---------------------------------------------------------------------------
// the secular roots
// ---------------------------------------------------------------------------

constexpr int kWin = 128;         // _DC_WINDOW_K
constexpr int kSlots = kWin / 32;  // window slots a lane holds

template <typename A>
struct SecArgs {
  const A* d;
  const A* w;
  const A* gap;
  const unsigned char* act;
  const A* dnext;
  const unsigned char* anext;
  const long long* hidx;
  A* anc;
  A* tau;
  int P, m, nact, kh, kwin, newton_iters, polish_iters;
};

template <typename A>
struct Sums {
  A psi, phi, psip, phip;
  __device__ __forceinline__ void reduce() {
    psi = warp_sum(psi);
    phi = warp_sum(phi);
    psip = warp_sum(psip);
    phip = warp_sum(phip);
  }
  __device__ __forceinline__ void add(A r, A r2, bool left) {
    if (left) {
      psi += r;
      psip += r2;
    } else {
      phi += r;
      phip += r2;
    }
  }
};

// the middle-way step of the reference's mw_update, bracketed, frozen at
// the rounding floor; every lane computes the same scalars
template <typename A>
__device__ __forceinline__ void mw_update(A f, A fscale, A psip, A phip,
                                          A off, A gap_safe, A& t, A& lo,
                                          A& hi) {
  const bool done = fabs(f) <= A(8) * Eps<A>::v * fscale;
  if (done) return;
  if (f < 0) lo = t; else hi = t;
  const A d1 = -off - t;
  const A d2 = (gap_safe - off) - t;
  const A fp = psip + phip;
  const A aq = (d1 + d2) * f - d1 * d2 * fp;
  const A bq = d1 * d2 * f;
  const A cq = f - d1 * psip - d2 * phip;
  const A disc = sqrt(fmax(aq * aq - A(4) * bq * cq, A(0)));
  A eta;
  if (aq > 0)
    eta = A(2) * bq / (aq + disc);
  else if (cq == 0)
    eta = bq / (aq == 0 ? A(1) : aq);
  else
    eta = (aq - disc) / (A(2) * cq);
  const A cand = t + eta;
  t = (cand > lo && cand < hi) ? cand : A(0.5) * (lo + hi);
}

template <typename A>
__global__ void __launch_bounds__(128) dc_secular_kernel(SecArgs<A> g) {
  const int lane = threadIdx.x & 31;
  const long wid = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (wid >= (long)g.P * g.nact) return;   // the whole warp leaves together
  const long p = wid / g.nact;
  const int j = (int)(wid % g.nact);
  const A* dp = g.d + p * g.m;
  const A* wp = g.w + p * g.m;
  const A dj = dp[j];
  const long out = p * g.nact + j;
  if (!g.act[p * g.m + j]) {
    if (lane == 0) {
      g.anc[out] = dj;
      g.tau[out] = 0;
    }
    return;
  }
  const A gapj = g.gap[p * g.m + j];
  const A gap_safe = gapj > 0 ? gapj : A(1);
  const A half = A(0.5) * gap_safe;
  const bool nxt = g.anext[p * g.m + j] != 0;
  const A dnx = g.dnext[p * g.m + j];

  // the full pass: the pole sum of the prefix split over the lanes
  auto full = [&](A anc, A t) {
    Sums<A> s{0, 0, 0, 0};
    for (int i = lane; i < g.nact; i += 32) {
      const A wi = wp[i];
      if (wi == 0) continue;
      const A q = A(1) / ((dp[i] - anc) - t);
      const A r = wi * q;
      s.add(r, r * q, i <= j);
    }
    s.reduce();
    return s;
  };

  // the window: slots lane + 32 q of the kwin index-nearest poles, and the
  // lane-th heaviest pole, zeroed where it repeats a window slot
  const int bmin = j - g.kwin / 2;
  A dw[kSlots], ww[kSlots];
  bool lw[kSlots];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int s = lane + 32 * q;
    const int base = bmin + s;
    const int idx = base < 0 ? 0 : (base > g.m - 1 ? g.m - 1 : base);
    const bool in = s < g.kwin && base >= 0 && base < g.m;
    dw[q] = dp[idx];
    ww[q] = in ? wp[idx] : A(0);
    lw[q] = base <= j;
  }
  A dh = 0, wh = 0;
  bool lh = false;
  if (lane < g.kh) {
    const long hi = g.hidx[p * g.kh + lane];
    dh = dp[hi];
    wh = (hi >= bmin && hi < bmin + g.kwin) ? A(0) : wp[hi];
    lh = hi <= j;
  }
  // sums over the window and the heavy poles at poles - origin - t
  auto near = [&](A origin, A t) {
    Sums<A> s{0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      if (ww[q] == 0) continue;
      const A inv = A(1) / ((dw[q] - origin) - t);
      const A r = ww[q] * inv;
      s.add(r, r * inv, lw[q]);
    }
    if (wh != 0) {
      const A inv = A(1) / ((dh - origin) - t);
      const A r = wh * inv;
      s.add(r, r * inv, lh);
    }
    s.reduce();
    return s;
  };

  // the midpoint pass: the anchor and the far field's value and slope
  const Sums<A> s0 = full(dj, half);
  const A f0 = A(1) + s0.psi + s0.phi;
  const Sums<A> w0 = near(dj, half);
  const A psi_f = fmin(s0.psi - w0.psi, A(0));
  const A phi_f = fmax(s0.phi - w0.phi, A(0));
  const A psip_f = fmax(s0.psip - w0.psip, A(0));
  const A phip_f = fmax(s0.phip - w0.phip, A(0));
  const bool upper = f0 < 0 && nxt;
  const A anc = upper ? dnx : dj;
  const A off = upper ? gap_safe : A(0);
  const A lo0 = upper ? -half : (f0 < 0 ? half : A(0));
  const A hi0 = upper ? A(0) : (f0 < 0 ? gap_safe : half);

  // the windowed iteration against the frozen far field
  const A t0 = A(0.5) * (lo0 + hi0);
  A t = t0, lo = lo0, hi = hi0;
  for (int it = 0; it < g.newton_iters; ++it) {
    const A s = (off - half) + t;
    const Sums<A> nw = near(anc, t);
    const A psi_m = psi_f + psip_f * s + nw.psi;
    const A phi_m = phi_f + phip_f * s + nw.phi;
    const A f = A(1) + psi_m + phi_m;
    const A fscale = A(1) + fabs(phi_m) + fabs(psi_m);
    // frozen at the rounding floor: every later iteration would find the
    // same sums and leave t as it is (mw_update), so stop
    if (fabs(f) <= A(8) * Eps<A>::v * fscale) break;
    mw_update(f, fscale, psip_f + nw.psip, phip_f + nw.phip, off, gap_safe,
              t, lo, hi);
  }
  if (!(t > lo0 && t < hi0)) t = t0;

  // the exact polish from the original bracket, until the root's residual
  // reaches the rounding floor
  lo = lo0;
  hi = hi0;
  for (int it = 0; it < g.polish_iters; ++it) {
    const Sums<A> s = full(anc, t);
    const A f = A(1) + s.psi + s.phi;
    const A fscale = A(1) + s.phi - s.psi;
    if (fabs(f) <= A(8) * Eps<A>::v * fscale) break;
    mw_update(f, fscale, s.psip, s.phip, off, gap_safe, t, lo, hi);
  }
  if (lane == 0) {
    g.anc[out] = anc;
    g.tau[out] = t;
  }
}

template <typename A, int ROWS>
int leaf_launch(const void* a, const void* b, const void* lo0,
                const void* hi0, const void* ctol, const void* x0, void* lam,
                void* f, void* l, void* scratch, int P, int lm, int d, int s,
                int bisect_iters, int inv_iters, int fallback_iters, A tiny4,
                A tiny, int smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dc_leaf_kernel<A, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((lm << s) + 31) / 32 * 32;
  dc_leaf_kernel<A, ROWS><<<P, threads, smem, (cudaStream_t)stream>>>(
      (const A*)a, (const A*)b, (const A*)lo0, (const A*)hi0,
      (const A*)ctol, (const A*)x0, (A*)lam, (A*)f, (A*)l, (A*)scratch, lm,
      d, s, bisect_iters, inv_iters, fallback_iters, tiny4, tiny);
  return (int)cudaGetLastError();
}

// the rows a lane holds in the Gram-Schmidt: 2 to lm = 64, 4 to 128
template <typename A>
int leaf(const void* a, const void* b, const void* lo0, const void* hi0,
         const void* ctol, const void* x0, void* lam, void* f, void* l,
         void* scratch, int P, int lm, int d, int s, int bisect_iters,
         int inv_iters, int fallback_iters, A tiny4, A tiny, int smem,
         void* stream) {
  if (P < 0 || lm < 2 || lm > 32 * kLeafRows<A> || s < 0 || s > 5 ||
      (lm << s) > kLeafThreads || d < 0 || d > bisect_iters ||
      (1 << d) > lm || inv_iters < 0 || fallback_iters < 0)
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const auto go = lm <= 64    ? leaf_launch<A, 2>
                  : lm <= 128 ? leaf_launch<A, 4>
                              : leaf_launch<A, kLeafRows<A>>;
  return go(a, b, lo0, hi0, ctol, x0, lam, f, l, scratch, P, lm, d, s,
            bisect_iters, inv_iters, fallback_iters, tiny4, tiny, smem,
            stream);
}

template <typename A>
int deflate(void* d, void* z, void* fe, void* le, void* act, const void* tol,
            void* scratch, void* sact, int P, int m, int chunk_min,
            void* stream) {
  if (P < 0 || m < 1 || chunk_min < 1) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  // enough threads for chunks of chunk_min steps, at most kDeflateThreads
  const int want = ((m - 1 + chunk_min - 1) / chunk_min + 31) / 32 * 32;
  const int threads = want < 32 ? 32
                      : (want > kDeflateThreads ? kDeflateThreads : want);
  dc_deflate_kernel<A><<<P, threads, 0, (cudaStream_t)stream>>>(
      (A*)d, (A*)z, (A*)fe, (A*)le, (unsigned char*)act, (const A*)tol,
      (A*)scratch, (unsigned char*)sact, P, m, chunk_min);
  return (int)cudaGetLastError();
}

template <typename A>
int secular(const void* d, const void* w, const void* gap, const void* act,
            const void* dnext, const void* anext, const void* hidx,
            void* anc, void* tau, int P, int m, int nact, int kh, int kwin,
            int newton_iters, int polish_iters, void* stream) {
  if (P < 0 || nact < 0 || nact > m || kh < 0 || kh > 32 || kwin < 1 ||
      kwin > kWin || kwin > m)
    return (int)cudaErrorInvalidValue;
  if (P == 0 || nact == 0) return 0;
  SecArgs<A> g{(const A*)d, (const A*)w, (const A*)gap,
               (const unsigned char*)act, (const A*)dnext,
               (const unsigned char*)anext, (const long long*)hidx,
               (A*)anc, (A*)tau, P, m, nact, kh, kwin, newton_iters,
               polish_iters};
  const long threads = (long)P * nact * 32;
  dc_secular_kernel<A><<<(unsigned)((threads + 127) / 128), 128, 0,
                         (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, one symbol per kernel and accumulation type; each
// launches on `stream` and returns 0 or the CUDA error.
//
// dc_leaf: a (P, lm), b (P, lm-1), lo0, hi0, ctol (P,), x0 (lm, lm) -> lam,
//   f, l (P, lm); scratch (2, P, lm, lm) of the factors; (d, s) the
//   bisection's schedule (dc.leaf_schedule: 2^d <= lm, lm 2^s <= 512);
//   smem = tuning.dc_leaf_smem_bytes.
// dc_deflate: d, z, fe, le (P, m) and act (P, m) bool, in place; tol (P,);
//   scratch (4, P, m) and sact (P, m) bytes; chunk_min = steps a chunk at
//   the least (tuning.DC_DEFLATE_CHUNK).
// dc_secular: d, w, gap, dnext (P, m), act, anext (P, m) bool, hidx (P, kh)
//   int64 -> anc, tau (P, nact).
extern "C" {

int dc_leaf_f64(const void* a, const void* b, const void* lo0,
                const void* hi0, const void* ctol, const void* x0, void* lam,
                void* f, void* l, void* scratch, int P, int lm, int d, int s,
                int bisect_iters, int inv_iters, int fallback_iters,
                double tiny4, double tiny, int smem, void* stream) {
  return leaf<double>(a, b, lo0, hi0, ctol, x0, lam, f, l, scratch, P, lm,
                      d, s, bisect_iters, inv_iters, fallback_iters, tiny4,
                      tiny, smem, stream);
}

int dc_leaf_f32(const void* a, const void* b, const void* lo0,
                const void* hi0, const void* ctol, const void* x0, void* lam,
                void* f, void* l, void* scratch, int P, int lm, int d, int s,
                int bisect_iters, int inv_iters, int fallback_iters,
                float tiny4, float tiny, int smem, void* stream) {
  return leaf<float>(a, b, lo0, hi0, ctol, x0, lam, f, l, scratch, P, lm,
                     d, s, bisect_iters, inv_iters, fallback_iters, tiny4,
                     tiny, smem, stream);
}

int dc_deflate_f64(void* d, void* z, void* fe, void* le, void* act,
                   const void* tol, void* scratch, void* sact, int P, int m,
                   int chunk_min, void* stream) {
  return deflate<double>(d, z, fe, le, act, tol, scratch, sact, P, m,
                       chunk_min, stream);
}

int dc_deflate_f32(void* d, void* z, void* fe, void* le, void* act,
                   const void* tol, void* scratch, void* sact, int P, int m,
                   int chunk_min, void* stream) {
  return deflate<float>(d, z, fe, le, act, tol, scratch, sact, P, m,
                       chunk_min, stream);
}

int dc_secular_f64(const void* d, const void* w, const void* gap,
                   const void* act, const void* dnext, const void* anext,
                   const void* hidx, void* anc, void* tau, int P, int m,
                   int nact, int kh, int kwin, int newton_iters,
                   int polish_iters, void* stream) {
  return secular<double>(d, w, gap, act, dnext, anext, hidx, anc, tau, P, m,
                         nact, kh, kwin, newton_iters, polish_iters, stream);
}

int dc_secular_f32(const void* d, const void* w, const void* gap,
                   const void* act, const void* dnext, const void* anext,
                   const void* hidx, void* anc, void* tau, int P, int m,
                   int nact, int kh, int kwin, int newton_iters,
                   int polish_iters, void* stream) {
  return secular<float>(d, w, gap, act, dnext, anext, hidx, anc, tau, P, m,
                        nact, kh, kwin, newton_iters, polish_iters, stream);
}

}  // extern "C"
