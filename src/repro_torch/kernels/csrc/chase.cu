// Bulge-chase kernels for Hopper (sm_90a): one chase cycle per block
// (kernel 1) and K consecutive cycles of one sweep per block (kernel 2).
//
// Replaces the TPU kernels chase_cycle_pallas (src/repro/kernels/
// bulge_chase.py:126) and chase_superstep_pallas (:225).  Plain versions:
// src/repro_torch/kernels/ref.py.
//
// What bounds it on the H100.  A cycle moves (tw+1)*(H-tw+b_in) words in and
// out and does about 4*(tw+1)*(H-tw+W) flops on them: at b_in=64, tw=32, fp32
// and G=87 slots that is ~4.5 MB per launch, ~1.3 us at 3.35 TB/s, below the
// cost of a launch.  So launches, and the host loop's gather and scatter
// around them, set the pace, not this code.  The design keeps the kernel
// simple and small in shared memory:
//   * one block of 128 threads per slot (wavefront slot x batch);
//   * only the two panels a cycle changes are staged in shared memory, in the
//     accumulation type: the column panel rows [tw,H) x cols [0,tw], and the
//     row panel rows [H-1-tw,H) x cols [tw+1,W).  The panels overlap in rows
//     [H-1-tw,H) x cols [0,tw]; those cells live once, in the column panel,
//     so the left reflector reads the values the right one just wrote.  The
//     whole window would not fit: at b_in=256, tw=16, fp64 it is ~631 KB.
//     The buffer's size is computed once, by tuning.smem_bytes in Python,
//     and the wrapper passes it in as smem_bytes;
//   * the larfg reductions run on warp 0 with shuffles; the per-row and
//     per-column dot products and rank-1 updates run one row (column) per
//     thread, so they need no reductions across threads;
//   * kernel 2 keeps its band block in device memory and addresses cycle
//     i's window through the shear (y, w) -> block[H-1-(y-w), i*b_in+w]:
//     no dense workspace.  Every cell a cycle touches has y >= w, so it is
//     stored.  Cycles run in order inside the block, separated by
//     __syncthreads, which also makes the previous cycle's device-memory
//     writes visible to the next.
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

// Cycle window inside a contiguous band block (H, WK) whose first column is
// col0 (= i*b_in for fused cycle i): cell (y, w) is block[H-1-(y-w), col0+w].
template <typename T> struct ShearedWindow {
  T* base;
  int H, WK, col0;
  __device__ T* at(int y, int w) const {
    return base + (size_t)(H - 1 - (y - w)) * WK + col0 + w;
  }
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

// One chase cycle on the window `win`.  `write_band` false computes the
// reflector pair (for the tape) and leaves the window as it was.  Ends with
// a __syncthreads, so cycles can follow each other in one block.
template <typename T, typename Win>
__device__ void chase_window(const Win& win, bool first, bool write_band,
                             int b_in, int tw, typename AccOf<T>::type* sm,
                             T* tape_v, T* tape_tau) {
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

  if (write_band) {
    for (int i = tid; i < R * L; i += nt)
      *win.at(tw + i / L, i % L) = from_acc<T>(cp[i]);
    for (int i = tid; i < L * b_in; i += nt)
      *win.at(H - 1 - tw + i / b_in, tw + 1 + i % b_in) = from_acc<T>(rp[i]);
  }
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
  chase_window<T>(win, is_first[g] != 0, true, b_in, tw,
                  reinterpret_cast<A*>(smem_raw),
                  tape_v ? tape_v + (size_t)g * 2 * (tw + 1) : nullptr,
                  tape_tau ? tape_tau + (size_t)g * 2 : nullptr);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chase_superstep_kernel(T* blocks, const unsigned char* is_first,
                       const unsigned char* active, int b_in, int tw,
                       int fuse, T* tape_v, T* tape_tau) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = typename AccOf<T>::type;
  const int g = blockIdx.x;
  const int H = b_in + 2 * tw + 1;
  const int WK = fuse * b_in + tw + 1;
  T* block = blocks + (size_t)g * H * WK;
  for (int i = 0; i < fuse; ++i) {
    const bool act = active[(size_t)g * fuse + i] != 0;
    if (!act && tape_v == nullptr) continue;       // uniform across the block
    const ShearedWindow<T> win{block, H, WK, i * b_in};
    const size_t slot = (size_t)g * fuse + i;
    chase_window<T>(win, i == 0 && is_first[g] != 0, act, b_in, tw,
                    reinterpret_cast<A*>(smem_raw),
                    tape_v ? tape_v + slot * 2 * (tw + 1) : nullptr,
                    tape_tau ? tape_tau + slot * 2 : nullptr);
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

template <typename T>
int launch_superstep(void* blocks, const void* is_first, const void* active,
                     int G, int b_in, int tw, int fuse, void* tape_v,
                     void* tape_tau, int bytes, void* stream) {
  cudaError_t err = set_smem(chase_superstep_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  chase_superstep_kernel<T><<<G, kThreads, bytes, (cudaStream_t)stream>>>(
      (T*)blocks, (const unsigned char*)is_first,
      (const unsigned char*)active, b_in, tw, fuse, (T*)tape_v, (T*)tape_tau);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, one symbol per storage type.  Pointers are device
// pointers; tape_v / tape_tau are null when no tape is wanted.  smem_bytes
// is the dynamic shared memory of one block, as tuning.smem_bytes counts
// the panels, reflectors and scalars of chase_window.  Each returns
// cudaGetLastError() after the launch.
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
    return launch_superstep<T>(blocks, is_first, active, G, b_in, tw, fuse,  \
                               tape_v, tape_tau, smem_bytes, stream);        \
  }

CHASE_API(f64, double)
CHASE_API(f32, float)
CHASE_API(bf16, __nv_bfloat16)
