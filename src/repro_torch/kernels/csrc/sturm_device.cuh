// Device code of the Sturm bisection, shared by csrc/sturm.cu (the staged
// stage 3) and csrc/fused_small.cu (phase 3 of the one-launch small-n tier);
// csrc/dc.cu's leaves take its schedule (descend, walk_top,
// bisect_rounds_by) with their own count.
//
// The bisection of sigma_k (k-th smallest, 1-indexed) on [0, bound] over the
// prescaled Golub-Kahan off-diagonal z (2n-1 entries): a level counts the
// negative pivots of an LDL^T recurrence at the bracket's midpoint, with the
// plain version's guard that lifts a pivot below `tiny` to +-tiny
// (core/bidiag_svd.py: sturm_count, bisect_plain).  The schedule keeps every
// midpoint of the sequential bisection, so sigma is bit for bit the plain
// version's:
//   * the top d levels of all n bisections meet only the 2^d - 1 midpoints
//     of a binary tree; they are counted once per matrix (descend gives
//     node j's bracket by the halvings of its path) and each k walks down
//     them (walk_top);
//   * the other levels go s at a time over a group of 2^s lanes
//     (bisect_rounds): the lanes count the 2^s - 1 nodes of the next s
//     levels under the group's bracket, lane j the node j + 1 in heap order,
//     and every lane walks the s levels by shuffles.
// Build without --use_fast_math: the division must be IEEE.

#pragma once

#include <cuda_runtime.h>

// one step of the pivot recurrence, counting a negative pivot
template <typename A>
__device__ __forceinline__ void sturm_step(A& t, int& cnt, A zz, A mid,
                                           A tiny) {
  if ((t < A(0) ? -t : t) < tiny) t = t < A(0) ? -tiny : tiny;
  t = -mid - (zz * zz) / t;
  cnt += t < A(0);
}

// negative pivots of T_GK - mid I over zb[0 .. m-2]: the plain version's
// sturm_count.  The entries of z come in groups of kSturmChunk, loaded
// before the group's steps, so that no load waits on the chain of
// divisions.
constexpr int kSturmChunk = 8;

template <typename A>
__device__ __forceinline__ int sturm_count(const A* __restrict__ zb, int m,
                                           A mid, A tiny) {
  A t = -mid;
  int cnt = t < A(0);
  int j = 1;
  for (; j + kSturmChunk <= m; j += kSturmChunk) {
    A zz[kSturmChunk];
#pragma unroll
    for (int u = 0; u < kSturmChunk; ++u) zz[u] = zb[j - 1 + u];
#pragma unroll
    for (int u = 0; u < kSturmChunk; ++u) sturm_step(t, cnt, zz[u], mid, tiny);
  }
  for (; j < m; ++j) sturm_step(t, cnt, zb[j - 1], mid, tiny);
  return cnt;
}

// [lo, hi] becomes the bracket of node j (heap order, j >= 1) of the tree
// under it: the halvings of j's path, top bit first
template <typename A>
__device__ __forceinline__ void descend(int j, A& lo, A& hi) {
  for (int l = 30 - __clz(j); l >= 0; --l) {
    const A mid = A(0.5) * (lo + hi);
    if ((j >> l) & 1) lo = mid; else hi = mid;
  }
}

// sigma_k's bracket from [lo, hi] = [0, bound] down the d counted levels of
// the tree's top: cb[j] is the count at node j's midpoint
template <typename A>
__device__ __forceinline__ void walk_top(const int* cb, int n, int k, int d,
                                         A& lo, A& hi) {
  int j = 1;
  for (int l = 0; l < d; ++l) {
    const A mid = A(0.5) * (lo + hi);
    if (cb[j] - n >= k) { hi = mid; j = 2 * j; }
    else { lo = mid; j = 2 * j + 1; }
  }
}

// levels done .. max_iter - 1 of the bisection of index k, s levels a
// round (one where s = 0) over the 2^s lanes `lane` of an aligned group:
// count(mid) is the count at a midpoint, and the walk goes left where
// count(mid) - n >= k.  Every lane of the warp calls it, with the same s,
// done and max_iter.  csrc/dc.cu's leaves count with their own recurrence.
template <typename A, typename Count>
__device__ __forceinline__ void bisect_rounds_by(Count count, int n, int k,
                                                 int lane, int s, int done,
                                                 int max_iter, A& lo, A& hi) {
  const int S = 1 << s;
  while (done < max_iter) {
    const int lev = min(s > 0 ? s : 1, max_iter - done);
    int c = 0;
    if (lane < (1 << lev) - 1) {
      A l2 = lo, h2 = hi;
      descend(lane + 1, l2, h2);
      c = count(A(0.5) * (l2 + h2));
    }
    int jj = 1;
    for (int l = 0; l < lev; ++l) {
      const int cj = __shfl_sync(0xffffffffu, c, jj - 1, S);
      const A mid = A(0.5) * (lo + hi);
      if (cj - n >= k) { hi = mid; jj = 2 * jj; }
      else { lo = mid; jj = 2 * jj + 1; }
    }
    done += lev;
  }
}

// levels done .. max_iter - 1 of sigma_k's bisection over zb
template <typename A>
__device__ __forceinline__ void bisect_rounds(const A* __restrict__ zb, int n,
                                              int k, int lane, int s,
                                              int done, int max_iter, A tiny,
                                              A& lo, A& hi) {
  bisect_rounds_by(
      [=](A mid) { return sturm_count(zb, 2 * n, mid, tiny); }, n, k, lane,
      s, done, max_iter, lo, hi);
}
