// Fused small-n SVD for Hopper (sm_90a): the whole per-matrix pipeline in
// one launch (kernel 5).
//
// Replaces the TPU kernel fused_small_svd_pallas (src/repro/kernels/
// fused_small.py:266, bodies _values_kernel / _uv_kernel).  Plain version:
// fused_small_svd_ref in src/repro_torch/kernels/ref.py, whose fused_walk
// lists the same reflectors in the same order as the loops below.
//
// One block per matrix, grid (B,).  Per matrix:
//   phase 1  dense -> upper band(bw): for j < n-1 a left reflector on column
//            j (rows [j, n-1]), then a right one on row j (cols [j+bw, n-1]);
//   phase 2  one SBR stage b_in = bw, tw = bw-1: for each sweep R and cycle
//            jc, pivot p = R+1+jc*bw, a right reflector on row r (R on the
//            sweep's first cycle, p-bw after) over [p, hi], then a left one
//            on column p over [p, hi], hi = min(p+bw-1, n-1);
//   phase 3  values mode: Sturm bisection on the Golub-Kahan tridiagonal, as
//            csrc/sturm.cu, one thread per k, sigma written descending.
//            uv mode writes (d, e, U2, V2^T) instead; the caller composes the
//            vectors with the staged stage 3.
// A reflector whose support has one entry or none is a tau = 0 no-op in
// the reference; the walk leaves it out.
//
// The TPU kernel applies each reflector as a masked full-length vector over
// the whole VMEM-resident (n, n) matrix, which keeps Mosaic's shapes static.
// Here the supports are plain loop bounds.  The working matrix lives in
// device memory, in the accumulation type (a per-matrix workspace; U2 and
// V2^T are accumulated in place in theirs): fp64 at n = 256 is 512 KB, over
// the 227 KB of shared memory a block can hold, and uv mode triples it.  At
// the tier's sizes the active matrices stay in the 50 MB L2.  Shared memory
// holds O(n) words (tuning.fused_smem_bytes counts them; the wrapper
// launches with exactly that many bytes): the reflector, the dot products
// w, tau and beta, and either the transform's dot products (uv) or the
// Golub-Kahan z (values).
//
// Each reflector: warp 0 builds it (larfg: the formulas of
// householder.make_reflector); barrier; the block forms w over the support
// for every row (right) or column (left) of the matrix, the reference's
// extent; barrier; the rank-1 update, with the structural fix of _fix_row /
// _fix_col (beta at lo, exact zeros on (lo, hi]) when tau != 0; barrier.
// In uv mode U <- U H after a left reflector and V^T <- H V^T after a
// right one, in the same two passes.  Every reflector reads the previous
// one's writes; the barriers order them, and __syncthreads makes the
// block's device-memory writes visible to the whole block.
//
// What bounds it on the H100: neither bytes nor the flop rate.  The
// (2n + 2n^2/bw) reflectors of a matrix run one after another, each a few
// dependent L2 round trips and three barriers; the bisection is
// max_iter*(2n-1) dependent divisions per thread.  One block per matrix
// also leaves SMs idle when B < 132.  This first version keeps that shape.
// Half types work in float and are rounded once, at the store.  Build
// without --use_fast_math: the tau = 0 test on an exact zero tail and the
// fp64 tolerances need IEEE division, square root and subnormals.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

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

// larfg on x[0], x[stride], ..., x[(L-1)*stride], run by the 32 lanes of
// warp 0.  Writes v (v[0] = 1), sc[0] = tau and sc[1] = beta (alpha when the
// tail is exactly zero, and then tau = 0).  The butterfly sum leaves every
// lane with the same bits, so all lanes agree on `safe`.
template <typename A>
__device__ void larfg_warp(const A* x, long stride, int L, A* v, A* sc) {
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
    sc[0] = tau;
    sc[1] = safe ? beta : alpha;
  }
}

// Right reflector on row r over columns [lo, hi] (L >= 2): a <- a H on all
// n rows, row r fixed; in uv mode V^T <- H V^T (rows [lo, hi], all columns).
template <typename A, bool UV>
__device__ void right_reflector(A* a, A* vt, int n, int r, int lo, int hi,
                                A* vec, A* w, A* sc, A* w2) {
  const int tid = threadIdx.x;
  const int L = hi - lo + 1;
  if (tid < 32) larfg_warp(a + (size_t)r * n + lo, 1, L, vec, sc);
  __syncthreads();
  const A tau = sc[0];
  if (tau != A(0)) {                    // uniform: every thread read sc[0]
    const A beta = sc[1];
    for (int i = tid; i < n; i += kThreads) {          // w = a[:, lo:hi] v
      const A* row = a + (size_t)i * n + lo;
      A s = 0;
      for (int c = 0; c < L; ++c) s += row[c] * vec[c];
      w[i] = s;
    }
    if (UV) {
      for (int j = tid; j < n; j += kThreads) {        // w2 = v^T vt[lo:hi]
        A s = 0;
        for (int c = 0; c < L; ++c) s += vec[c] * vt[(size_t)(lo + c) * n + j];
        w2[j] = s;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < n * L; idx += kThreads) {
      const int i = idx / L;
      const int c = idx - i * L;
      A* p = a + (size_t)i * n + lo + c;
      *p = i == r ? (c == 0 ? beta : A(0)) : *p - tau * (w[i] * vec[c]);
    }
    if (UV) {
      for (int idx = tid; idx < L * n; idx += kThreads) {
        const int c = idx / n;
        const int j = idx - c * n;
        A* p = vt + (size_t)(lo + c) * n + j;
        *p = *p - tau * (vec[c] * w2[j]);
      }
    }
  }
  __syncthreads();
}

// Left reflector on column lo over rows [lo, hi] (L >= 2): a <- H a on all
// n columns, column lo fixed; in uv mode U <- U H (cols [lo, hi], all rows).
template <typename A, bool UV>
__device__ void left_reflector(A* a, A* u, int n, int lo, int hi, A* vec,
                               A* w, A* sc, A* w2) {
  const int tid = threadIdx.x;
  const int L = hi - lo + 1;
  if (tid < 32) larfg_warp(a + (size_t)lo * n + lo, (long)n, L, vec, sc);
  __syncthreads();
  const A tau = sc[0];
  if (tau != A(0)) {
    const A beta = sc[1];
    for (int j = tid; j < n; j += kThreads) {          // w = v^T a[lo:hi, :]
      A s = 0;
      for (int c = 0; c < L; ++c) s += vec[c] * a[(size_t)(lo + c) * n + j];
      w[j] = s;
    }
    if (UV) {
      for (int i = tid; i < n; i += kThreads) {        // w2 = u[:, lo:hi] v
        const A* row = u + (size_t)i * n + lo;
        A s = 0;
        for (int c = 0; c < L; ++c) s += row[c] * vec[c];
        w2[i] = s;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < L * n; idx += kThreads) {
      const int c = idx / n;
      const int j = idx - c * n;
      A* p = a + (size_t)(lo + c) * n + j;
      *p = j == lo ? (c == 0 ? beta : A(0)) : *p - tau * (vec[c] * w[j]);
    }
    if (UV) {
      for (int idx = tid; idx < n * L; idx += kThreads) {
        const int i = idx / L;
        const int c = idx - i * L;
        A* p = u + (size_t)i * n + lo + c;
        *p = *p - tau * (w2[i] * vec[c]);
      }
    }
  }
  __syncthreads();
}

template <typename A>
__device__ A warp_max(A x) {
  for (int o = 16; o > 0; o >>= 1) {
    const A y = __shfl_xor_sync(0xffffffffu, x, o);
    x = y > x ? y : x;
  }
  return x;
}

// mats (B, n, n) in T; ws, uws, vtws (B, n, n) in the accumulation type
// (uws, vtws: uv mode only; for T == A they are the outputs u, vt).
template <typename T, bool UV>
__global__ void __launch_bounds__(kThreads) fused_small_kernel(
    const T* __restrict__ mats, typename AccOf<T>::type* ws,
    typename AccOf<T>::type* uws, typename AccOf<T>::type* vtws,
    T* sig_out, T* d_out, T* e_out, T* u_out, T* vt_out, int n, int bw,
    int max_iter, typename AccOf<T>::type tiny) {
  using A = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* vec = reinterpret_cast<A*>(smem_raw);   // (n)
  A* w = vec + n;                            // (n)
  A* sc = w + n;                             // tau, beta
  A* x3 = sc + 2;                            // uv: w2 (n); values: z (2n-1)
  const int tid = threadIdx.x;
  const size_t nn = (size_t)n * n;
  const size_t b = blockIdx.x;
  A* a = ws + b * nn;
  A* u = UV ? uws + b * nn : nullptr;
  A* vt = UV ? vtws + b * nn : nullptr;

  for (size_t i = tid; i < nn; i += kThreads) {
    a[i] = to_acc(mats[b * nn + i]);
    if (UV) {
      const A one = (i / n == i % n) ? A(1) : A(0);
      u[i] = one;
      vt[i] = one;
    }
  }
  __syncthreads();

  // phase 1: dense -> upper band(bw)
  for (int j = 0; j < n - 1; ++j) {
    left_reflector<A, UV>(a, u, n, j, n - 1, vec, w, sc, x3);
    if (j + bw < n - 1)
      right_reflector<A, UV>(a, vt, n, j, j + bw, n - 1, vec, w, sc, x3);
  }
  // phase 2: one SBR stage b_in = bw, tw = bw - 1 (bw == 1: already done)
  if (bw >= 2 && n >= 3) {
    const int ncyc = (n - 2) / bw + 1;
    for (int R = 0; R < n - 2; ++R) {
      for (int jc = 0; jc < ncyc; ++jc) {
        const int p = R + 1 + jc * bw;
        if (p >= n - 1) break;               // support of one entry or none
        const int r = jc == 0 ? R : p - bw;
        const int hi = min(p + bw - 1, n - 1);
        right_reflector<A, UV>(a, vt, n, r, p, hi, vec, w, sc, x3);
        left_reflector<A, UV>(a, u, n, p, hi, vec, w, sc, x3);
      }
    }
  }

  if (UV) {
    for (int k = tid; k < n; k += kThreads) {
      d_out[b * n + k] = from_acc<T>(a[(size_t)k * n + k]);
      e_out[b * n + k] =
          from_acc<T>(k == 0 ? A(0) : a[(size_t)(k - 1) * n + k]);
    }
    if constexpr (!std::is_same<T, A>::value) {
      for (size_t i = tid; i < nn; i += kThreads) {
        u_out[b * nn + i] = from_acc<T>(u[i]);
        vt_out[b * nn + i] = from_acc<T>(vt[i]);
      }
    }
    return;
  }

  // phase 3: sigma by Sturm bisection (csrc/sturm.cu, core/bidiag_svd.py)
  if (n == 1) {
    if (tid == 0) sig_out[b] = from_acc<T>(abs_acc(a[0]));
    return;
  }
  const int m = 2 * n - 1;
  A* z = x3;                                 // (d_1, e_1, d_2, ..., d_n)
  for (int k = tid; k < n; k += kThreads) {
    z[2 * k] = a[(size_t)k * n + k];
    if (k + 1 < n) z[2 * k + 1] = a[(size_t)k * n + k + 1];
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
  for (int k = tid + 1; k <= n; k += kThreads) {   // k-th smallest, 1-based
    A lo = 0;
    A hi = bound;
    for (int it = 0; it < max_iter; ++it) {
      const A mid = A(0.5) * (lo + hi);
      A t = -mid;
      int cnt = t < A(0);
      for (int j = 0; j < m; ++j) {
        if (abs_acc(t) < tiny) t = t < A(0) ? -tiny : tiny;
        const A zz = z[j];
        t = -mid - (zz * zz) / t;
        cnt += t < A(0);
      }
      if (cnt - n >= k) hi = mid; else lo = mid;
    }
    sig_out[b * n + (n - k)] = from_acc<T>(A(0.5) * (lo + hi) * scale);
  }
}

template <typename T>
int launch(const void* mats, void* ws, void* uws, void* vtws, void* sig,
           void* d, void* e, void* u, void* vt, int B, int n, int bw,
           int max_iter, double tiny, int compute_uv, int smem,
           void* stream) {
  using A = typename AccOf<T>::type;
  auto kern = compute_uv ? fused_small_kernel<T, true>
                         : fused_small_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)mats, (A*)ws, (A*)uws, (A*)vtws, (T*)sig, (T*)d, (T*)e,
      (T*)u, (T*)vt, n, bw, max_iter, (A)tiny);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, one symbol per storage type.  bw is the effective
// bandwidth (1 <= bw <= max(n-1, 1)); tiny is 4 * the accumulation type's
// smallest normal; smem is tuning.fused_smem_bytes(n, dtype, compute_uv).
#define FUSED_SMALL_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* mats, void* ws, void* uws, void* vtws,    \
                      void* sig, void* d, void* e, void* u, void* vt,       \
                      int B, int n, int bw, int max_iter, double tiny,      \
                      int compute_uv, int smem, void* stream) {             \
    return launch<T>(mats, ws, uws, vtws, sig, d, e, u, vt, B, n, bw,       \
                     max_iter, tiny, compute_uv, smem, stream);             \
  }

FUSED_SMALL_ENTRY(fused_small_f64, double)
FUSED_SMALL_ENTRY(fused_small_f32, float)
FUSED_SMALL_ENTRY(fused_small_bf16, __nv_bfloat16)
