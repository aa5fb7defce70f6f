// Compact-WY apply for Hopper (sm_90a): per slot s,
//
//     C[s] <- C[s] - V[s] (T[s] (V[s]^T C[s])),
//     v (S, m, k), t (S, k, k), c (S, m, w), in place on c.
//
// Replaces the TPU kernel tape_apply_pallas (src/repro/kernels/hh_apply.py:56)
// and its single-slot view hh_block_apply_pallas (:33).  Plain version:
// tape_apply_ref in src/repro_torch/kernels/ref.py.  Callers: the stage-1 QR
// trailing update (S = B, m = w = padded n, k = nb), the stage-1 tape replay
// (S = B, m = w = n, k = nb) and the chase tape replay (S = B*G*K slots,
// m = tw+1, k = 1, w = n).
//
// What bounds it on the H100.  At the stage-1 shape (1, 4224, 64, 4224) fp64
// the three products are 4.6 GFLOP against 285 MB of C read and written:
// about 135 us of fp64 arithmetic at 34 TFLOP/s, so operations.  At the chase
// replay shape (128, 16, 1, 4096) fp64 it is 134 MB for 0.07 GFLOP: bytes,
// about 40 us.  The TPU kernel kept V resident in VMEM and streamed C; V does
// not fit shared memory here (4224 x 64 fp64 is 2.1 MB), so this design
// streams both, and keeps simple:
//   * grid (slot, column stripe); one block of 256 threads owns a stripe of
//     BC columns of one slot's C, all m rows of it, so it can write C in
//     place with no other block touching those cells;
//   * pass 1 walks m in tiles of TM rows, staging the V tile (TM x k) and the
//     C tile (TM x BC) in shared memory, and sums W1 = V^T C_stripe (k x BC)
//     in registers; thread (group gq, column j) owns the rows kk = gq + NG*r
//     of W1, so a warp reads one V value (a broadcast) and 32 neighbouring C
//     values per step;
//   * W1 goes to shared memory, and W2 = T W1 is formed there (T is read from
//     device memory, a warp-wide broadcast through L1);
//   * pass 2 walks m again and writes C_tile - V_tile W2, each thread 8 rows
//     of one column, dot products over k summed in registers;
//   * the wrapper picks BC in {32, ..., 256} with k * BC <= 4096 (so a thread
//     owns at most 16 rows of W1, and k <= 128), and narrows it until the
//     grid has two blocks per SM where the shape allows.  Sums run over rows,
//     then over k, in index order, so the result does not depend on BC.
// fp64 stays fp64; fp32 and bf16 accumulate in fp32 and bf16 is rounded once,
// at the store.  C is read twice (one read per pass); making the kernel fast
// (keeping small stripes resident, wgmma for the products) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPer = 16;     // rows of W1 one thread owns (k * BC <= 4096)
constexpr int kRows = 8;        // rows of a C tile one thread writes in pass 2

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

// Stage rows [r0, r0 + TM) of V (m, k) and of the stripe [c0, c0 + BC) of
// C (m, w) in shared memory, zero past the edges.
template <typename T, typename A>
__device__ void stage_tile(const T* V, const T* C, int m, int k, int w,
                           int r0, int c0, int TM, int BC, A* vt, A* ct) {
  for (int i = threadIdx.x; i < TM * k; i += kThreads) {
    const int row = r0 + i / k;
    vt[i] = row < m ? to_acc(V[(size_t)row * k + i % k]) : A(0);
  }
  for (int i = threadIdx.x; i < TM * BC; i += kThreads) {
    const int row = r0 + i / BC;
    const int col = c0 + i % BC;
    ct[i] = (row < m && col < w) ? to_acc(C[(size_t)row * w + col]) : A(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tape_apply_kernel(const T* __restrict__ v, const T* __restrict__ t, T* c,
                  int m, int k, int w, int BC) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = typename AccOf<T>::type;
  const int NG = kThreads / BC;            // column groups of the block
  const int TM = NG * kRows;               // rows of a tile
  A* vt = reinterpret_cast<A*>(smem_raw);  // (TM, k)
  A* ct = vt + TM * k;                     // (TM, BC)
  A* ws = ct + TM * BC;                    // (k, BC): W1, then W2
  const int s = blockIdx.x;
  const int c0 = blockIdx.y * BC;
  const int j = threadIdx.x % BC;
  const int gq = threadIdx.x / BC;
  const T* V = v + (size_t)s * m * k;
  const T* Tm = t + (size_t)s * k * k;
  T* C = c + (size_t)s * m * w;

  // pass 1: W1 = V^T C_stripe, rows kk = gq + NG*r of it in registers
  A acc[kMaxPer];
#pragma unroll
  for (int r = 0; r < kMaxPer; ++r) acc[r] = A(0);
  for (int r0 = 0; r0 < m; r0 += TM) {
    stage_tile<T, A>(V, C, m, k, w, r0, c0, TM, BC, vt, ct);
    __syncthreads();
    for (int rr = 0; rr < TM; ++rr) {
      const A cv = ct[rr * BC + j];
      const A* vrow = vt + rr * k;
#pragma unroll
      for (int r = 0; r < kMaxPer; ++r) {
        const int kk = gq + NG * r;
        if (kk < k) acc[r] += vrow[kk] * cv;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kMaxPer; ++r) {
    const int kk = gq + NG * r;
    if (kk < k) ws[kk * BC + j] = acc[r];
  }
  __syncthreads();

  // W2 = T W1, over the same (kk, j) cells
#pragma unroll
  for (int r = 0; r < kMaxPer; ++r) {
    const int kk = gq + NG * r;
    A sum = A(0);
    if (kk < k)
      for (int l = 0; l < k; ++l) sum += to_acc(Tm[kk * k + l]) * ws[l * BC + j];
    acc[r] = sum;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMaxPer; ++r) {
    const int kk = gq + NG * r;
    if (kk < k) ws[kk * BC + j] = acc[r];
  }
  __syncthreads();

  // pass 2: C_tile - V_tile W2, rows gq + NG*q of the tile, column j
  const int col = c0 + j;
  for (int r0 = 0; r0 < m; r0 += TM) {
    stage_tile<T, A>(V, C, m, k, w, r0, c0, TM, BC, vt, ct);
    __syncthreads();
    A dot[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) dot[q] = A(0);
    for (int kk = 0; kk < k; ++kk) {
      const A wv = ws[kk * BC + j];
#pragma unroll
      for (int q = 0; q < kRows; ++q) dot[q] += vt[(gq + NG * q) * k + kk] * wv;
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int rr = gq + NG * q;
      const int row = r0 + rr;
      if (row < m && col < w)
        C[(size_t)row * w + col] = from_acc<T>(ct[rr * BC + j] - dot[q]);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* v, const void* t, void* c, int S, int m, int k, int w,
           int bc, int bytes, void* stream) {
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tape_apply_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(S, (w + bc - 1) / bc);
  tape_apply_kernel<T><<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const T*)v, (const T*)t, (T*)c, m, k, w, bc);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, one symbol per storage type.  Pointers are device
// pointers to contiguous tensors; c is updated in place.  bc is the stripe
// width (32, 64, 128 or 256, with k * bc <= 4096) and smem_bytes the dynamic
// shared memory of one block, (TM*k + TM*bc + k*bc) accumulator words with
// TM = 8 * 256 / bc, both chosen by the wrapper (kernels/hh_apply.py).  Each
// returns cudaGetLastError() after the launch.
#define HH_API(SUFFIX, T)                                                     \
  extern "C" int tape_apply_##SUFFIX(const void* v, const void* t, void* c,  \
                                     int S, int m, int k, int w, int bc,     \
                                     int smem_bytes, void* stream) {         \
    return launch<T>(v, t, c, S, m, k, w, bc, smem_bytes, stream);           \
  }

HH_API(f64, double)
HH_API(f32, float)
HH_API(bf16, __nv_bfloat16)
