// Sturm bisection for the singular values of a batch of bidiagonals, on
// Hopper (sm_90a).
//
// No TPU kernel is replaced: the reference's stage 3
// (src/repro/core/bidiag_svd.py:97 bidiag_singular_values) is jnp fori_loops
// that XLA fuses.  In eager PyTorch the same recurrence would cost one launch
// per operation per step, about 60*(2n-1)*9 launches, so it gets a kernel.
// Plain version: src/repro_torch/core/bidiag_svd.py (sturm_count,
// bisect_plain).
//
// Input is the prescaled Golub-Kahan off-diagonal z (B, 2n-1) and the
// Gershgorin bound (B,); the wrapper computes both with torch ops.  Every
// sigma_k (k-th smallest, 1-indexed) is found by max_iter bisection steps on
// [0, bound]; a step counts the negative pivots of an LDL^T recurrence over
// the 2n-1 entries of z at the bracket's midpoint, with the reference's
// guard that lifts a pivot below `tiny` to +-tiny.  sigma_k goes to
// position n-k, so the row comes out descending.
//
// What bounds it on the H100: not bytes (z is read through L1) and not the
// flop rate, but latency.  A count is a chain of 2n-1 dependent steps, each
// with an IEEE division, so the launch takes at least one chain per
// bisection level that runs after another.  The first design gave each
// (matrix, k) one thread for all max_iter levels: at n = 16384 fp32 40
// chains of 32,767 divisions in a row, on 2-4 warps per SM.  This one cuts
// the chains in a row and fills the SMs:
//   * Kernel 1 (sturm_bisect_top_kernel) counts the top of the bisection
//     tree once per matrix.  Every k starts on [0, bound], so the first d
//     levels of all n bisections meet only the 2^d - 1 midpoints of a
//     binary tree; a thread per (matrix, node) makes its node's bracket by
//     the same halvings, 0.5*(lo+hi), that the sequential bisection makes
//     on the way there, and counts at its midpoint.  d = min(floor(log2 n),
//     max_iter), so the top costs one chain and fewer counts than one level
//     did.
//   * Kernel 2 (sturm_bisect_walk_kernel) walks each k down the counted top
//     to its depth-d bracket without counting, then splits the remaining
//     levels over a group of 2^s lanes: the lanes count the 2^s - 1 nodes
//     of the next s levels under the group's bracket (lane j the node j + 1
//     in heap order), and every lane walks the s levels by shuffles, so the
//     group ends on the same bracket as the sequential bisection.  Uniform
//     multisection would move the shifts and so the bits; this keeps them,
//     so sigma is bit for bit the plain version's.  The wrapper picks s
//     from B*n (bisect.schedule): enough lanes to hold about 32 warps per
//     SM, no more.
// The device code is csrc/sturm_device.cuh, shared with csrc/fused_small.cu.
// Build without --use_fast_math: the division must be IEEE.

#include <cuda_runtime.h>

#include "sturm_device.cuh"

namespace {

constexpr int kThreads = 128;

// counts[b * 2^d + j], j in [1, 2^d): the count at node j's midpoint
template <typename A>
__global__ void __launch_bounds__(kThreads)
sturm_bisect_top_kernel(const A* __restrict__ z, const A* __restrict__ bound,
                 int* __restrict__ counts, int B, int n, int d, A tiny) {
  const int nodes = (1 << d) - 1;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)B * nodes) return;
  const int b = (int)(idx / nodes);
  const int j = (int)(idx % nodes) + 1;
  A lo = 0;
  A hi = bound[b];
  descend(j, lo, hi);
  counts[((long)b << d) + j] = sturm_count(z + (size_t)b * (2 * n - 1),
                                           2 * n, A(0.5) * (lo + hi), tiny);
}

template <typename A>
__global__ void __launch_bounds__(kThreads)
sturm_bisect_walk_kernel(const A* __restrict__ z, const A* __restrict__ bound,
                  const int* __restrict__ counts, A* __restrict__ out, int B,
                  int n, int max_iter, int d, int s, A tiny) {
  const long total = ((long)B * n) << s;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx - (threadIdx.x & 31) >= total) return;   // a whole warp past the end
  const long q = idx < total ? idx : total - 1;    // lanes past it shadow the
  const int lane = (int)(idx & ((1 << s) - 1));  //   last group
  const long bk = q >> s;
  const int b = (int)(bk / n);
  const int k = (int)(bk % n) + 1;           // 1-indexed, ascending
  const A* zb = z + (size_t)b * (2 * n - 1);
  const int* cb = counts + ((long)b << d);
  A lo = 0;
  A hi = bound[b];
  walk_top(cb, n, k, d, lo, hi);             // down the counted top
  bisect_rounds(zb, n, k, lane, s, d, max_iter, tiny, lo, hi);
  if (idx < total && lane == 0)
    out[(size_t)b * n + (n - k)] = A(0.5) * (lo + hi);
}

template <typename A>
int launch(const void* z, const void* bound, void* counts, void* out, int B,
           int n, int max_iter, int d, int s, A tiny, void* stream) {
  if (B <= 0 || n < 1 || d < 0 || d > max_iter || (1 << d) > n || s < 0 ||
      s > 5)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long top = (long)B * ((1 << d) - 1);
  if (top > 0) {
    sturm_bisect_top_kernel<A>
        <<<(int)((top + kThreads - 1) / kThreads), kThreads, 0, st>>>(
            (const A*)z, (const A*)bound, (int*)counts, B, n, d, tiny);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long walk = ((long)B * n) << s;
  sturm_bisect_walk_kernel<A>
      <<<(int)((walk + kThreads - 1) / kThreads), kThreads, 0, st>>>(
          (const A*)z, (const A*)bound, (const int*)counts, (A*)out, B, n,
          max_iter, d, s, tiny);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, one symbol per accumulation type (bf16 input is counted
// in float, as in the reference).  tiny is 4 * the type's smallest normal.
// counts: device scratch of B * 2^d int32; d in [0, max_iter] with 2^d <= n,
// s in [0, 5] (bisect.schedule picks both).  Two launches on `stream` (one
// when d = 0); returns 0 or the CUDA error.
extern "C" int sturm_bisect_f64(const void* z, const void* bound,
                                void* counts, void* out, int B, int n,
                                int max_iter, int d, int s, double tiny,
                                void* stream) {
  return launch<double>(z, bound, counts, out, B, n, max_iter, d, s, tiny,
                        stream);
}

extern "C" int sturm_bisect_f32(const void* z, const void* bound,
                                void* counts, void* out, int B, int n,
                                int max_iter, int d, int s, float tiny,
                                void* stream) {
  return launch<float>(z, bound, counts, out, B, n, max_iter, d, s, tiny,
                       stream);
}
