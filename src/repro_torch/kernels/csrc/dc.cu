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
//    leaf, one thread per eigenvalue index k (lm = 2 * leaf_n threads), the
//    leaf's diagonals in shared memory.  Thread k bisects index k with the
//    reference's midpoints (eigenvalues bit for bit the plain version's),
//    then runs the inverse iteration of vector k, which lives in column k
//    of an lm x (lm + 1) array in shared memory beside its elimination
//    multipliers; the same-cluster Gram-Schmidt runs in k order, with
//    block-wide dot products, and a vector that collapses there (inverse
//    iteration gave it an earlier one's direction) is replaced by e_k
//    projected and taken through fallback_iters steps of inverse iteration
//    at its eigenvalue, one thread solving.  Bound: latency.  A count is a
//    chain of lm dependent steps with an IEEE division, and each thread
//    runs bisect_iters of them in a row; the design runs all lm indices of
//    a leaf and all leaves at once, so the launch takes about one thread's
//    chain.
//  * dc_deflate_kernel replaces the Givens scan of _merge_pair
//    (:574-605).  One thread per subproblem walks its columns in order, in
//    place.  Bound: latency, a chain of m - 1 steps with a square root and
//    two divisions, one thread per subproblem (at the top merge level one
//    thread per matrix).  Bit for bit the plain version (mul_rn, add_rn).
//  * dc_secular_kernel replaces the root solve of _secular_roots
//    (:297-527).  One warp per root of the active prefix (only the prefix
//    is launched); the midpoint and polish passes split the pole sum over
//    the lanes and reduce by shuffles, the windowed iteration keeps the 128
//    index-nearest and 32 heaviest poles in registers (4 + 1 a lane), and a
//    warp stops polishing when its root's residual reaches the rounding
//    floor (the reference freezes such a root in its lockstep loop).
//    Bound: operations, the divisions of the full passes, about
//    2 * nact^2 per pass.  Roots agree with the plain version within
//    rounding (the sums are taken in another order).

#include <cuda_runtime.h>

#include <cfloat>

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

// ---------------------------------------------------------------------------
// leaves
// ---------------------------------------------------------------------------

template <typename A>
__global__ void dc_leaf_kernel(const A* __restrict__ a,
                               const A* __restrict__ b,
                               const A* __restrict__ lo0,
                               const A* __restrict__ hi0,
                               const A* __restrict__ ctol,
                               const A* __restrict__ x0, A* __restrict__ lam,
                               A* __restrict__ f, A* __restrict__ l, int lm,
                               int bisect_iters, int inv_iters,
                               int fallback_iters, A tiny4, A tiny) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* sa = reinterpret_cast<A*>(smem_raw);  // diagonal
  A* sb = sa + lm;                          // off-diagonal (last entry 0)
  A* sl = sb + lm;                          // eigenvalues
  A* sx = sl + lm;                          // scratch: dots, then w1
  A* sy = sx + lm;                          // scratch: dots, then w2
  A* V = sy + lm;                           // V[i * ld + k]: vector k
  const int ld = lm + 1;
  A* C = V + lm * ld;                       // multipliers, same layout
  const long p = blockIdx.x;
  const int k = threadIdx.x;
  sa[k] = a[p * lm + k];
  sb[k] = k < lm - 1 ? b[p * (lm - 1) + k] : A(0);
  __syncthreads();

  // bisection of index k (1-based k + 1) on [lo0, hi0]
  A lo = lo0[p], hi = hi0[p];
  for (int it = 0; it < bisect_iters; ++it) {
    const A mid = A(0.5) * (lo + hi);
    A q = sa[0] - mid;
    int cnt = q < 0;
    for (int i = 1; i < lm; ++i) {
      q = guard(q, tiny4);
      q = (sa[i] - mid) - (sb[i - 1] * sb[i - 1]) / q;
      cnt += q < 0;
    }
    if (cnt >= k + 1) hi = mid; else lo = mid;
  }
  const A lk = A(0.5) * (lo + hi);
  sl[k] = lk;

  // inverse iteration of vector k, pivots guarded at eps * max(|a|,|b|,1)
  A amax = 1;
  for (int i = 0; i < lm; ++i)
    amax = fmax(amax, fmax(fabs(sa[i]), fabs(sb[i])));
  const A tg = Eps<A>::v * amax;
  for (int i = 0; i < lm; ++i) V[i * ld + k] = x0[k * lm + i];
  for (int r = 0; r < inv_iters; ++r) {
    A piv = guard(sa[0] - lk, tg);
    A y = V[k] / piv;
    V[k] = y;
    for (int i = 1; i < lm; ++i) {
      const A bi = sb[i - 1];
      const A c = bi / piv;
      piv = guard((sa[i] - lk) - bi * c, tg);
      y = (V[i * ld + k] - bi * y) / piv;
      V[i * ld + k] = y;
      C[(i - 1) * ld + k] = c;
    }
    A x = V[(lm - 1) * ld + k];
    for (int i = lm - 2; i >= 0; --i) {
      x = V[i * ld + k] - C[i * ld + k] * x;
      V[i * ld + k] = x;
    }
    A s = 0;
    for (int i = 0; i < lm; ++i) s += V[i * ld + k] * V[i * ld + k];
    const A nrm = fmax(sqrt(s), tiny);
    for (int i = 0; i < lm; ++i) V[i * ld + k] /= nrm;
  }
  __syncthreads();

  // same-cluster Gram-Schmidt in k order: thread j forms the masked dots
  // with vector kk, then thread i its entry of w1 = v_kk - sum_j
  // dot_j v_j and of w2 = e_kk - sum_j v_j[kk] v_j
  const A ct = ctol[p];
  for (int kk = 1; kk < lm; ++kk) {
    const int j = k;
    const bool mask = j < kk && sl[kk] - sl[j] < ct;
    A dot = 0;
    if (mask)
      for (int i = 0; i < lm; ++i) dot += V[i * ld + j] * V[i * ld + kk];
    sx[j] = dot;
    sy[j] = mask ? V[kk * ld + j] : A(0);
    __syncthreads();
    const int i = k;
    A p1 = 0, p2 = 0;
    for (int jj = 0; jj < kk; ++jj) {
      const A vij = V[i * ld + jj];
      p1 += sx[jj] * vij;
      p2 += sy[jj] * vij;
    }
    const A w1 = V[i * ld + kk] - p1;
    const A w2 = A(i == kk) - p2;
    __syncthreads();
    sx[i] = w1;
    sy[i] = w2;
    __syncthreads();
    A n1 = 0, n2 = 0;
    for (int ii = 0; ii < lm; ++ii) {
      n1 += sx[ii] * sx[ii];
      n2 += sy[ii] * sy[ii];
    }
    n1 = sqrt(n1);
    n2 = sqrt(n2);
    if (n1 > A(0.01)) {  // every thread summed n1 alike: a uniform branch
      V[i * ld + kk] = w1 / fmax(n1, tiny);
    } else {
      // the collapse fallback: e_kk projected (w2), then fallback_iters
      // steps of inverse iteration at lam_kk, each projected again and
      // normalised; thread 0 solves, sx holds its multipliers, then the
      // masked dots
      A w = w2 / fmax(n2, tiny);
      for (int r = 0; r < fallback_iters; ++r) {
        __syncthreads();
        sy[i] = w;
        __syncthreads();
        if (k == 0) {
          const A lkk = sl[kk];
          A piv = guard(sa[0] - lkk, tg);
          A y = sy[0] / piv;
          sy[0] = y;
          for (int ii = 1; ii < lm; ++ii) {
            const A bi = sb[ii - 1];
            const A c = bi / piv;
            piv = guard((sa[ii] - lkk) - bi * c, tg);
            y = (sy[ii] - bi * y) / piv;
            sy[ii] = y;
            sx[ii - 1] = c;
          }
          A x = sy[lm - 1];
          for (int ii = lm - 2; ii >= 0; --ii) {
            x = sy[ii] - sx[ii] * x;
            sy[ii] = x;
          }
        }
        __syncthreads();
        A dj = 0;
        if (mask)
          for (int ii = 0; ii < lm; ++ii) dj += V[ii * ld + j] * sy[ii];
        sx[j] = dj;
        __syncthreads();
        A pw = 0;
        for (int jj = 0; jj < kk; ++jj) pw += sx[jj] * V[i * ld + jj];
        w = sy[i] - pw;
        __syncthreads();
        sy[i] = w;
        __syncthreads();
        A nw = 0;
        for (int ii = 0; ii < lm; ++ii) nw += sy[ii] * sy[ii];
        w = w / fmax(sqrt(nw), tiny);
      }
      V[i * ld + kk] = w;
    }
    __syncthreads();
  }
  lam[p * lm + k] = lk;
  f[p * lm + k] = V[k];
  l[p * lm + k] = V[(lm - 1) * ld + k];
}

// ---------------------------------------------------------------------------
// the Givens deflation scan
// ---------------------------------------------------------------------------

template <typename A>
__global__ void dc_deflate_kernel(A* __restrict__ d, A* __restrict__ z,
                                  A* __restrict__ fe, A* __restrict__ le,
                                  unsigned char* __restrict__ act,
                                  const A* __restrict__ tol, int P, int m) {
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  A* dp = d + p * m;
  A* zp = z + p * m;
  A* fp = fe + p * m;
  A* lp = le + p * m;
  unsigned char* ap = act + p * m;
  const A t = tol[p];
  A dc = dp[0], zc = zp[0], fc = fp[0], lc = lp[0];
  bool ac = ap[0] != 0;
  for (int i = 1; i < m; ++i) {
    const A di = dp[i], zi = zp[i], fi = fp[i], li = lp[i];
    const bool ai = ap[i] != 0;
    const A r = sqrt(add_rn(mul_rn(zc, zc), mul_rn(zi, zi)));
    const bool pos = r > 0;
    const A rs = pos ? r : A(1);
    const A cg = pos ? zi / rs : A(1);
    const A sg = pos ? zc / rs : A(0);
    const A off = fabs(mul_rn(mul_rn(cg, sg), sub_rn(di, dc)));
    const bool mrg = ac && ai && off <= t;
    const A cc = mul_rn(cg, cg), ss = mul_rn(sg, sg);
    dp[i - 1] = mrg ? add_rn(mul_rn(cc, dc), mul_rn(ss, di)) : dc;
    zp[i - 1] = mrg ? A(0) : zc;
    fp[i - 1] = mrg ? sub_rn(mul_rn(cg, fc), mul_rn(sg, fi)) : fc;
    lp[i - 1] = mrg ? sub_rn(mul_rn(cg, lc), mul_rn(sg, li)) : lc;
    ap[i - 1] = ac && !mrg;
    dc = mrg ? add_rn(mul_rn(ss, dc), mul_rn(cc, di)) : di;
    zc = mrg ? r : zi;
    fc = mrg ? add_rn(mul_rn(sg, fc), mul_rn(cg, fi)) : fi;
    lc = mrg ? add_rn(mul_rn(sg, lc), mul_rn(cg, li)) : li;
    ac = ai;
  }
  dp[m - 1] = dc;
  zp[m - 1] = zc;
  fp[m - 1] = fc;
  lp[m - 1] = lc;
  ap[m - 1] = ac;
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
__device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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
      const A den = (dp[i] - anc) - t;
      const A r = wi / den;
      s.add(r, r / den, i <= j);
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
      const A den = (dw[q] - origin) - t;
      const A r = ww[q] / den;
      s.add(r, r / den, lw[q]);
    }
    if (wh != 0) {
      const A den = (dh - origin) - t;
      const A r = wh / den;
      s.add(r, r / den, lh);
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

template <typename A>
int leaf(const void* a, const void* b, const void* lo0, const void* hi0,
         const void* ctol, const void* x0, void* lam, void* f, void* l, int P,
         int lm, int bisect_iters, int inv_iters, int fallback_iters,
         A tiny4, A tiny, int smem, void* stream) {
  if (P < 0 || lm < 2 || lm > 1024) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      dc_leaf_kernel<A>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dc_leaf_kernel<A><<<P, lm, smem, (cudaStream_t)stream>>>(
      (const A*)a, (const A*)b, (const A*)lo0, (const A*)hi0,
      (const A*)ctol, (const A*)x0, (A*)lam, (A*)f, (A*)l, lm, bisect_iters,
      inv_iters, fallback_iters, tiny4, tiny);
  return (int)cudaGetLastError();
}

template <typename A>
int deflate(void* d, void* z, void* fe, void* le, void* act, const void* tol,
            int P, int m, void* stream) {
  if (P < 0 || m < 1) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const int threads = 128;
  dc_deflate_kernel<A><<<(P + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(
      (A*)d, (A*)z, (A*)fe, (A*)le, (unsigned char*)act, (const A*)tol, P, m);
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
//   f, l (P, lm); smem = tuning.dc_leaf_smem_bytes.
// dc_deflate: d, z, fe, le (P, m) and act (P, m) bool, in place; tol (P,).
// dc_secular: d, w, gap, dnext (P, m), act, anext (P, m) bool, hidx (P, kh)
//   int64 -> anc, tau (P, nact).
extern "C" {

int dc_leaf_f64(const void* a, const void* b, const void* lo0,
                const void* hi0, const void* ctol, const void* x0, void* lam,
                void* f, void* l, int P, int lm, int bisect_iters,
                int inv_iters, int fallback_iters, double tiny4, double tiny,
                int smem, void* stream) {
  return leaf<double>(a, b, lo0, hi0, ctol, x0, lam, f, l, P, lm,
                      bisect_iters, inv_iters, fallback_iters, tiny4, tiny,
                      smem, stream);
}

int dc_leaf_f32(const void* a, const void* b, const void* lo0,
                const void* hi0, const void* ctol, const void* x0, void* lam,
                void* f, void* l, int P, int lm, int bisect_iters,
                int inv_iters, int fallback_iters, float tiny4, float tiny,
                int smem, void* stream) {
  return leaf<float>(a, b, lo0, hi0, ctol, x0, lam, f, l, P, lm,
                     bisect_iters, inv_iters, fallback_iters, tiny4, tiny,
                     smem, stream);
}

int dc_deflate_f64(void* d, void* z, void* fe, void* le, void* act,
                   const void* tol, int P, int m, void* stream) {
  return deflate<double>(d, z, fe, le, act, tol, P, m, stream);
}

int dc_deflate_f32(void* d, void* z, void* fe, void* le, void* act,
                   const void* tol, int P, int m, void* stream) {
  return deflate<float>(d, z, fe, le, act, tol, P, m, stream);
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
