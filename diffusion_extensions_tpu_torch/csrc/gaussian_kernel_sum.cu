// Gaussian rotation-kernel sum for MMD, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `gaussian_kernel_sum_pallas` / `_kernel` in
// diffusion_extensions_tpu/ops/mmd_pallas.py.  For rotations X (N, 3, 3) and
// Y (M, 3, 3), row-major and float32, it computes
//
//   sum_{n, m} exp(-sqrt(2) * theta(X_n, Y_m)),
//   theta = atan2(|skew(X^T Y)| / 2, (tr(X^T Y) - 1) / 2),
//
// from four bilinears of the 9 entries of each pair: the trace <X, Y>_F and
// the three skew components of X^T Y, each a difference of two 3-term dots
// (X^T Y)[p][q] = <X_:p, Y_:q>.  That is the arithmetic of the plain PyTorch
// version `gaussian_kernel_matrix` (diffusion_extensions_tpu_torch/ops/
// metrics.py), with the accurate atan2f and expf.
//
// Bound on this card: the inputs are O(N + M) (36 bytes a rotation, 1.4 MB
// for a 20k x 20k sum), the work O(N * M): 67 f32 operations a pair (27 FMA
// for the bilinears count 54; the skew norm, sqrt, atan2, exp, the scales
// and the accumulate 13 more).  So it is bound by arithmetic, 0.40 ms for
// 20k x 20k at the data sheet's 67 TFLOP/s.
//
// Design: a 2-D grid of blocks, each owning kThreads X rows (one per thread,
// kept in registers) and kTileM Y rows staged in shared memory, which every
// thread of the block walks in the same order (a broadcast read).  Rows or
// columns past N or M are skipped by bounds checks, never zero-padded: a zero
// matrix would add exp(-pi sqrt(2)).  Each thread sums its pairs in f32; the
// block reduces with warp shuffles, then shared memory, and writes one
// partial; a second one-block kernel adds the partials in a fixed order in
// f64.  No float atomics, so two calls on the same input return the same
// bits.  Indices and counts are 64-bit (N * M is 4e8 at the eval's 20k).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC.  No --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // X rows per block, one per thread
constexpr int kTileM = 512;    // Y rows per block, in shared memory
constexpr int kReduceThreads = 256;
constexpr float kSqrt2 = 1.41421356237309504880f;

long long tiles(long long rows, long long per_tile) {
  return (rows + per_tile - 1) / per_tile;
}

__global__ void __launch_bounds__(kThreads)
    gaussian_kernel_tile_sums(const float* __restrict__ x, long long n,
                              const float* __restrict__ y, long long m,
                              float* __restrict__ partials) {
  __shared__ float ys[kTileM * 9];
  __shared__ float warp_sums[kThreads / 32];

  const long long y0 = (long long)blockIdx.y * kTileM;
  const int mt = (int)(m - y0 < kTileM ? m - y0 : kTileM);
  const float* ysrc = y + y0 * 9;
  for (int e = threadIdx.x; e < mt * 9; e += kThreads) ys[e] = ysrc[e];
  __syncthreads();

  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  float acc = 0.0f;
  if (row < n) {
    // a[r * 3 + c] = X[r][c]; column p of X is (a[p], a[3 + p], a[6 + p])
    float a[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) a[k] = x[row * 9 + k];
#pragma unroll 2
    for (int j = 0; j < mt; ++j) {
      const float* b = ys + j * 9;
      float tr = 0.0f;
#pragma unroll
      for (int k = 0; k < 9; ++k) tr += a[k] * b[k];
      // (X^T Y)[p][q] = sum_r X[r][p] Y[r][q]
#define XTY(p, q) (a[p] * b[q] + a[3 + p] * b[3 + q] + a[6 + p] * b[6 + q])
      const float sx = XTY(2, 1) - XTY(1, 2);
      const float sy = XTY(0, 2) - XTY(2, 0);
      const float sz = XTY(1, 0) - XTY(0, 1);
#undef XTY
      const float s = 0.5f * sqrtf(sx * sx + sy * sy + sz * sz);
      const float c = 0.5f * (tr - 1.0f);
      acc += expf(-kSqrt2 * atan2f(s, c));
    }
  }

  // fixed-order block reduction: shuffles within each warp, then the warps
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    partials[(long long)blockIdx.y * gridDim.x + blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(kReduceThreads)
    sum_partials(const float* __restrict__ partials, long long count,
                 float* __restrict__ out) {
  __shared__ double sums[kReduceThreads];
  double acc = 0.0;
  for (long long i = threadIdx.x; i < count; i += kReduceThreads) acc += partials[i];
  sums[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kReduceThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sums[threadIdx.x] += sums[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = (float)sums[0];
}

}  // namespace

// Length of the float32 scratch buffer of per-block partials that
// gaussian_kernel_sum_launch needs for these sizes.
extern "C" long long gaussian_kernel_sum_workspace(long long n, long long m) {
  return tiles(n, kThreads) * tiles(m, kTileM);
}

// x: (n, 9) and y: (m, 9) float32, row-major, on the device; partials: the
// workspace above; out: one float32.  Launches both kernels on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int gaussian_kernel_sum_launch(const void* x, long long n, const void* y,
                                          long long m, void* partials, void* out,
                                          void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const long long gx = tiles(n, kThreads);
  const long long gy = tiles(m, kTileM);
  if (gx > 0x7fffffffLL || gy > 65535LL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  gaussian_kernel_tile_sums<<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0, s>>>(
      (const float*)x, n, (const float*)y, m, (float*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<1, kReduceThreads, 0, s>>>((const float*)partials, gx * gy, (float*)out);
  return (int)cudaGetLastError();
}
