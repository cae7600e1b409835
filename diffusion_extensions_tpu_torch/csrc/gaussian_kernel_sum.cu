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
// (X^T Y)[p][q] = <X_:p, Y_:q>.  That is the function of the plain PyTorch
// version `gaussian_kernel_matrix` (diffusion_extensions_tpu_torch/ops/
// mmd_cuda.py); theta and exp are evaluated as written below, not by the
// math library.
//
// Bound on this card: the inputs are O(N + M) (36 bytes a rotation, 1.4 MB
// for a 20k x 20k sum: 0.0004 ms at 3.35 TB/s), the work O(N * M): 67 f32
// operations a pair (27 FMA for the bilinears count 54; the skew norm, sqrt,
// atan2, exp, the scales and the accumulate 13 more).  So it is bound by
// arithmetic, 0.40 ms for 20k x 20k at the data sheet's 67 TFLOP/s, and what
// costs time is scheduler slots: every instruction a pair is ~1/34 of the bound.
// Bytes are no concern, so neither TMA nor cp.async would buy anything: the
// rows a block reads are staged with plain loads.
//
// Design, in the order of what it saves:
//   * The four bilinears on the tensor cores (mma.sync m16n8k8, TF32 split
//     three ways; the layout is described at the code below).  A block owns
//     128 X rows, whose fragments its four warps keep in registers, and 512
//     Y rows, staged 128 at a time; a warp computes 32 x 8 pairs a step, 8 a
//     thread, from 24 mma, and only theta and exp stay on the FP32 pipe: ~29
//     SASS instructions a pair.
//   * theta and exp written for this function.  The 0.5 scales of both
//     atan2 arguments cancel and are dropped; c = tr - 1 starts the trace's
//     accumulator at a8 b8 - 1.  s >= 0, so atan2(s, c) is one octant
//     reduction z = min(s, |c|) / max(s, |c|) (one approximate reciprocal),
//     the odd 8-term minimax polynomial atan(z) = z P(z^2) on [0, 1]
//     (tools/fit_kernel_polys.py: 1.3e-7 rad in float32), and
//     theta = pi/2 - copysign(s > |c| ? p : pi/2 - p, c): one compare, one
//     select and one bit operation.  -sqrt(2) log2(e) is folded into the FMA
//     that feeds ex2.approx.  A 1e-36 seed in the skew norm keeps max(s, |c|)
//     above zero, so there is no 0/0.  Three MUFU instructions a pair:
//     sqrt.approx, rcp.approx, ex2.approx (each within 2 ulp).  With the
//     split's ~5e-7 on each bilinear the errors add to ~6e-7 relative a pair.
//   * Rows or columns past N or M are never zero-padded (a zero matrix would
//     add exp(-pi sqrt(2))): an X row past N is read from row N - 1 and its
//     sum dropped, a warp with no valid row skips the work, full blocks of 8
//     Y rows run unmasked and the ragged last block drops its columns past M.
//   * Each thread sums its pairs in f32, one sum per X row; the block
//     reduces in a fixed order (the thread's rows, warp shuffles, the warps)
//     and writes one partial per tile, indexed by tile; a second one-block
//     kernel adds the partials in a fixed order in f64.  No float atomics, so
//     two calls on the same input return the same bits.  Indices and counts
//     are 64-bit (N * M is 4e8 at 20k).
//
// What still holds it back: the tensor-core work does not hide under the
// FP32 work, it adds to it: the 3 mma a pair cost their warp's scheduler
// cycles that no FP32 instruction fills, on top of the ~29 instructions.
// PERF.md, section 6, keeps what was tried against that (fewer splits, wgmma,
// other tile shapes, the bilinears in FP32) and what each measured.
//
// Measured by chip_smoke.py (phase kernel_time) on an NVIDIA H100 80GB HBM3
// at a 700 W power limit: 0.658 ms per 20,000 x 20,000 sum against the
// 0.400 ms bound (61%).  ptxas: 156 registers, 33,296 bytes of shared memory,
// no spills; 28.9 SASS instructions a pair in the inner loop, 3 of them mma,
// 3 MUFU.  PERF.md, section 6, row 2 keeps the runs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC.  No --use_fast_math: each approximation is chosen
// in this source.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;               // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles16 = 2;             // m16 tiles (16 X rows) per warp
constexpr int kWarpRows = 16 * kTiles16;   // X rows per warp
constexpr int kTileN = kWarps * kWarpRows; // X rows per block
constexpr int kSubM = 128;              // Y rows staged at a time
constexpr int kSubs = 4;                // Y sub-tiles per block
constexpr int kTileM = kSubM * kSubs;   // Y rows per block
constexpr int kStageRows = kTileN > kSubM ? kTileN : kSubM;
constexpr int kRowFloats = 64;          // staged floats per row: 4 k-steps x 8 x (hi, lo)
constexpr int kMinBlocks = 3;           // blocks per SM asked of the compiler
constexpr int kReduceThreads = 256;

constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kScale = 2.04027887030908196f;   // sqrt(2) * log2(e)
constexpr float kBias = -3.20486255205783977f;   // -kScale * pi / 2
constexpr float kTiny = 1e-36f;
// atan(z) = z * P(z^2) on [0, 1], lowest coefficient first
// (tools/fit_kernel_polys.py, atan[8])
constexpr float kAtan0 = 9.999994636e-01f;
constexpr float kAtan1 = -3.333036602e-01f;
constexpr float kAtan2 = 1.995149702e-01f;
constexpr float kAtan3 = -1.392945051e-01f;
constexpr float kAtan4 = 9.687653184e-02f;
constexpr float kAtan5 = -5.644792691e-02f;
constexpr float kAtan6 = 2.218549885e-02f;
constexpr float kAtan7 = -4.132246133e-03f;

long long tiles(long long rows, long long per_tile) {
  return (rows + per_tile - 1) / per_tile;
}

__device__ __forceinline__ float sqrt_approx(float v) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// exp(-sqrt(2) theta) from c = tr(X^T Y) - 1 (= 2 cos theta) and the skew
// vector of X^T Y (of norm 2 sin theta): theta = atan2(|skew|, c).
__device__ __forceinline__ float theta_exp_term(const float c, const float sx, const float sy,
                                                const float sz) {
  float ss = fmaf(sx, sx, kTiny);
  ss = fmaf(sy, sy, ss);
  ss = fmaf(sz, sz, ss);
  const float s = sqrt_approx(ss);
  const float ac = fabsf(c);
  const bool steep = s > ac;  // the angle is nearer pi/2 than 0 or pi
  const float z = fminf(s, ac) * rcp_approx(fmaxf(s, ac));
  const float z2 = z * z;
  float p = fmaf(kAtan7, z2, kAtan6);
  p = fmaf(p, z2, kAtan5);
  p = fmaf(p, z2, kAtan4);
  p = fmaf(p, z2, kAtan3);
  p = fmaf(p, z2, kAtan2);
  p = fmaf(p, z2, kAtan1);
  p = fmaf(p, z2, kAtan0);
  p *= z;  // atan(z), in [0, pi/4]
  // theta = pi/2 - copysign(u, c), u = pi/2 - (the angle from the c axis)
  const float u = steep ? p : kHalfPi - p;
  // exp(-sqrt(2) theta) = 2^(kScale * copysign(u, c) + kBias)
  return ex2_approx(fmaf(copysignf(u, c), kScale, kBias));
}

// ---------------------------------------------------------------------------
// The bilinears on the tensor cores: mma.sync m16n8k8, TF32 with a 3-way
// split.  Every float v is hi + lo with hi = tf32(v) and lo = tf32(v - hi);
// a product is hi hi + hi lo + lo hi (lo lo, ~2^-22 of it, is dropped), so a
// bilinear is within ~5e-7 of its FP32 value for rotation entries.
//
// Features, K = 8 per k-step (a[3 r + c] = X[r][c], b likewise):
//   k-step 0, trace:  X: a0 .. a7                      Y: b0 .. b7
//                     (the ninth product a8 b8 - 1 starts the accumulator)
//   k-step 1, sx:     X: a2 a5 a8 -a1 -a4 -a7 0 0      Y: b1 b4 b7 b2 b5 b8 0 0
//   k-step 2, sy:     X: a0 a3 a6 -a2 -a5 -a8 0 0      Y: b2 b5 b8 b0 b3 b6 0 0
//   k-step 3, sz:     X: a1 a4 a7 -a0 -a3 -a6 0 0      Y: b0 b3 b6 b1 b4 b7 0 0
//
// A staged row is 16 slots of 16 bytes: slot (k-step, t) holds
// (hi[t], hi[t + 4], lo[t], lo[t + 4]) of that k-step, which is what lane
// (g, t) of a warp needs of row g for its A (X) or B (Y) fragments: one
// 16-byte load a k-step.  Slots are rotated by slot_rotation(row) so that
// neither the eight rows a staging quarter-warp writes nor the two rows x
// four t a loading quarter-warp reads share a bank.

__host__ __device__ constexpr int feature_element(const bool is_x, const int ks, const int k) {
  if (ks == 0) return k;
  if (k >= 6) return -1;
  const int first = ks == 1 ? 2 : (ks == 2 ? 0 : 1);
  const int second = ks == 1 ? 1 : (ks == 2 ? 2 : 0);
  return 3 * (k % 3) + ((k < 3) == is_x ? first : second);
}

__device__ __forceinline__ uint32_t tf32_of(const float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ int slot_rotation(const int row) {
  return ((row & 1) << 2) + ((row >> 1) & 3);
}

// d += a b (m16n8k8, TF32 operands as 32-bit patterns, FP32 accumulate)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
}

// One rotation (9 floats at src) -> its staged row and its ninth entry.
template <bool kIsX>
__device__ __forceinline__ void stage_row(const float* __restrict__ src,
                                          float* __restrict__ staged,
                                          float* __restrict__ ninth, const int row) {
  float hi[9], lo[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    const float v = src[e];
    hi[e] = __uint_as_float(tf32_of(v));
    lo[e] = __uint_as_float(tf32_of(v - hi[e]));
  }
  *ninth = src[8];
  const int rot = slot_rotation(row);
  float4* slots = reinterpret_cast<float4*>(staged);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float q[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = t + 4 * half;
        const int e = feature_element(kIsX, ks, k);
        const bool negate = kIsX && ks > 0 && k >= 3;
        q[half] = e < 0 ? 0.0f : (negate ? -hi[e] : hi[e]);
        q[2 + half] = e < 0 ? 0.0f : (negate ? -lo[e] : lo[e]);
      }
      slots[(ks * 4 + t + rot) & 15] = make_float4(q[0], q[1], q[2], q[3]);
    }
  }
}

// One block: kTileN X rows (each warp keeps the fragments of its 32 rows in
// registers) against kSubs sub-tiles of kSubM Y rows, staged one at a time
// into the shared memory that first held the X rows.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gaussian_kernel_tile_sums(const float* __restrict__ x, long long n,
                              const float* __restrict__ y, long long m,
                              long long tiles_n, float* __restrict__ partials) {
  __shared__ __align__(16) float staged[kStageRows * kRowFloats];
  __shared__ __align__(8) float ninth[kStageRows];
  __shared__ float warp_sums[kThreads / 32];

  const long long tile = blockIdx.x;
  const long long x0 = (tile % tiles_n) * kTileN;
  const long long y0 = (tile / tiles_n) * kTileM;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // the fragments' row (A, C) or column (B) group
  const int t = lane & 3;
  const int rot = slot_rotation(g);
  const float4* slots = reinterpret_cast<const float4*>(staged);

  // the block's X rows (past N: row N - 1, its sums dropped at the end)
  for (int r = threadIdx.x; r < kTileN; r += kThreads) {
    long long row = x0 + r;
    if (row >= n) row = n - 1;
    stage_row<true>(x + row * 9, staged + r * kRowFloats, ninth + r, r);
  }
  __syncthreads();
  // fragments of rows warp * 32 + tile16 * 16 + {g, g + 8}, per k-step
  uint32_t a_hi[kTiles16][4][4], a_lo[kTiles16][4][4];
  float x9[kTiles16][2];
#pragma unroll
  for (int tile16 = 0; tile16 < kTiles16; ++tile16) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * kWarpRows + tile16 * 16 + half * 8 + g;
      x9[tile16][half] = ninth[r];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const float4 q = slots[r * 16 + ((ks * 4 + t + rot) & 15)];
        a_hi[tile16][ks][half] = __float_as_uint(q.x);
        a_hi[tile16][ks][2 + half] = __float_as_uint(q.y);
        a_lo[tile16][ks][half] = __float_as_uint(q.z);
        a_lo[tile16][ks][2 + half] = __float_as_uint(q.w);
      }
    }
  }
  const bool warp_has_rows = x0 + warp * kWarpRows < n;

  float acc[kTiles16][2] = {};  // one sum per row of the thread
  // eight Y rows jb * 8 .. jb * 8 + 7 against the warp's 32 X rows; the
  // thread's pairs are rows {g, g + 8} x columns {2 t, 2 t + 1} per m16 tile
  auto column_block = [&](const int jb, const int valid_columns) {
    uint32_t b_hi[4][2], b_lo[4][2];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const float4 q = slots[(jb * 8 + g) * 16 + ((ks * 4 + t + rot) & 15)];
      b_hi[ks][0] = __float_as_uint(q.x);
      b_hi[ks][1] = __float_as_uint(q.y);
      b_lo[ks][0] = __float_as_uint(q.z);
      b_lo[ks][1] = __float_as_uint(q.w);
    }
    const float2 y9 = *reinterpret_cast<const float2*>(ninth + jb * 8 + 2 * t);
#pragma unroll
    for (int tile16 = 0; tile16 < kTiles16; ++tile16) {
      float c[4] = {fmaf(x9[tile16][0], y9.x, -1.0f), fmaf(x9[tile16][0], y9.y, -1.0f),
                    fmaf(x9[tile16][1], y9.x, -1.0f), fmaf(x9[tile16][1], y9.y, -1.0f)};
      mma_tf32(c, a_hi[tile16][0], b_lo[0]);
      mma_tf32(c, a_lo[tile16][0], b_hi[0]);
      mma_tf32(c, a_hi[tile16][0], b_hi[0]);
      float skew[3][4];
#pragma unroll
      for (int ks = 1; ks < 4; ++ks) {
        mma_tf32_zero(skew[ks - 1], a_hi[tile16][ks], b_lo[ks]);
        mma_tf32(skew[ks - 1], a_lo[tile16][ks], b_hi[ks]);
        mma_tf32(skew[ks - 1], a_hi[tile16][ks], b_hi[ks]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float term = theta_exp_term(c[i], skew[0][i], skew[1][i], skew[2][i]);
        if (2 * t + (i & 1) >= valid_columns) term = 0.0f;
        acc[tile16][i >> 1] += term;
      }
    }
  };

  for (int sub = 0; sub < kSubs; ++sub) {
    const long long ys0 = y0 + (long long)sub * kSubM;
    if (ys0 >= m) break;  // the same for every thread of the block
    const int rows = (int)(m - ys0 < kSubM ? m - ys0 : kSubM);
    __syncthreads();  // every warp has read what the shared memory held
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      stage_row<false>(y + (ys0 + r) * 9, staged + r * kRowFloats, ninth + r, r);
    }
    __syncthreads();
    if (warp_has_rows) {
      const int full = rows >> 3;
#pragma unroll 2
      for (int jb = 0; jb < full; ++jb) column_block(jb, 8);
      // the ragged last block reads rows never staged; their columns are dropped
      if (rows & 7) column_block(full, rows & 7);
    }
  }

  // fixed-order reduction: the thread's rows, shuffles within each warp, the warps
  float total = 0.0f;
#pragma unroll
  for (int tile16 = 0; tile16 < kTiles16; ++tile16) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (x0 + warp * kWarpRows + tile16 * 16 + half * 8 + g < n) total += acc[tile16][half];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) total += __shfl_down_sync(0xffffffffu, total, off);
  if (lane == 0) warp_sums[warp] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += warp_sums[w];
    partials[tile] = sum;
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

// Length of the float32 scratch buffer of per-tile partials that
// gaussian_kernel_sum_launch needs for these sizes.
extern "C" long long gaussian_kernel_sum_workspace(long long n, long long m) {
  return tiles(n, kTileN) * tiles(m, kTileM);
}

// X rows and Y rows of one tile, for callers that size test cases by it.
extern "C" void gaussian_kernel_sum_tile(int* tile_n, int* tile_m) {
  *tile_n = kTileN;
  *tile_m = kTileM;
}

// x: (n, 9) and y: (m, 9) float32, row-major, on the device; partials: the
// workspace above; out: one float32.  Launches both kernels on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int gaussian_kernel_sum_launch(const void* x, long long n, const void* y,
                                          long long m, void* partials, void* out,
                                          void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles_n = tiles(n, kTileN);
  const long long count = tiles_n * tiles(m, kTileM);
  if (count > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  gaussian_kernel_tile_sums<<<(unsigned)count, kThreads, 0, s>>>(
      (const float*)x, n, (const float*)y, m, tiles_n, (float*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<1, kReduceThreads, 0, s>>>((const float*)partials, count, (float*)out);
  return (int)cudaGetLastError();
}
