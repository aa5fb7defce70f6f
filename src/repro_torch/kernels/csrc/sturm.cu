// Sturm bisection for the singular values of a batch of bidiagonals
// (kernel 3), on Hopper (sm_90a).
//
// No TPU kernel is replaced: the reference's stage 3
// (src/repro/core/bidiag_svd.py:97 bidiag_singular_values) is jnp fori_loops
// that XLA fuses.  In eager PyTorch the same recurrence would cost one launch
// per operation per step, about 60*(2n-1)*9 launches, so it gets a kernel.
// Plain version: src/repro_torch/core/bidiag_svd.py (sturm_count,
// bidiag_singular_values_plain).
//
// Input is the prescaled Golub-Kahan off-diagonal z (B, 2n-1) and the
// Gershgorin bound (B,); the wrapper computes both with torch ops.  One
// thread per (matrix, k) runs max_iter bisection steps on [0, bound]; each
// step is an LDL^T negative-pivot count over the 2n-1 entries of z, with the
// reference's guard that lifts a pivot below `tiny` to +-tiny.  The thread
// writes sigma_k (k-th smallest) to position n-k, so the row comes out
// descending.
//
// What bounds it on the H100: not bytes (z is read through L1, all threads of
// a matrix read the same word) and not the flop rate, but latency: every
// thread runs max_iter*(2n-1) dependent steps, each with an IEEE division.
// At n = 16384 in fp32 that is 40*32767 dependent divisions per thread.
// Splitting a bracket across the threads of a warp (multisection) would cut
// the chain; this first version keeps the reference's plain bisection.
// Build without --use_fast_math: the division must be IEEE.

#include <cuda_runtime.h>

namespace {

template <typename A>
__global__ void sturm_bisect_kernel(const A* __restrict__ z,
                                    const A* __restrict__ bound,
                                    A* __restrict__ out, int B, int n,
                                    int max_iter, A tiny) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)B * n) return;
  const int b = (int)(idx / n);
  const int k = (int)(idx % n) + 1;          // 1-indexed, ascending
  const A* zb = z + (size_t)b * (2 * n - 1);
  const int m = 2 * n;
  A lo = 0;
  A hi = bound[b];
  for (int it = 0; it < max_iter; ++it) {
    const A mid = A(0.5) * (lo + hi);
    A t = -mid;
    int cnt = t < A(0);
    for (int j = 1; j < m; ++j) {
      if ((t < A(0) ? -t : t) < tiny) t = t < A(0) ? -tiny : tiny;
      const A zz = zb[j - 1];
      t = -mid - (zz * zz) / t;
      cnt += t < A(0);
    }
    if (cnt - n >= k) hi = mid; else lo = mid;
  }
  out[(size_t)b * n + (n - k)] = A(0.5) * (lo + hi);
}

constexpr int kThreads = 64;

template <typename A>
int launch(const void* z, const void* bound, void* out, int B, int n,
           int max_iter, A tiny, void* stream) {
  const long total = (long)B * n;
  const int grid = (int)((total + kThreads - 1) / kThreads);
  sturm_bisect_kernel<A><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const A*)z, (const A*)bound, (A*)out, B, n, max_iter, tiny);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, one symbol per accumulation type (bf16 input is counted
// in float, as in the reference).  tiny is 4 * the type's smallest normal.
extern "C" int sturm_bisect_f64(const void* z, const void* bound, void* out,
                                int B, int n, int max_iter, double tiny,
                                void* stream) {
  return launch<double>(z, bound, out, B, n, max_iter, tiny, stream);
}

extern "C" int sturm_bisect_f32(const void* z, const void* bound, void* out,
                                int B, int n, int max_iter, float tiny,
                                void* stream) {
  return launch<float>(z, bound, out, B, n, max_iter, tiny, stream);
}
