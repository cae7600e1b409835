// The row passes of the DeepSeek-V2 experts layer, over the held rows only
// (diffusion_extensions_tpu_torch/ops/moe_rows_cuda.py, called by
// models/deepseek_v2.py DeepSeekMoE._held_experts): the dispatch's gather,
// the SwiGLU activation between the two grouped products and the weighted
// combine, each forward and backward.
//
// Replaces no TPU kernel: the JAX package has no DeepSeek-V2 trunk.  The
// layer sorts its T k choices by held expert so that the grouped products
// take static shapes (a replayed CUDA graph cannot take others); only the
// first n = offs[held - 1] rows are held, about a tenth at one rank of eight.
// As PyTorch operations every pass between the sort and the combine ran over
// all T k rows: a gather, a cast, silu and a product, a gather of the rows
// back, a mask, a float32 (T, k, d) product and its sum, and their backwards
// (an atomic index_add into a zero-filled buffer among them).
//
// Bound on this card: memory.  Each pass reads and writes each of its rows
// once and does a few operations an element.  So each pass is one kernel
// that reads the count n from the card (never from the host: the launch is
// captured) and touches only rows [0, n) of the static (T k, .) buffers, or
// one token's held rows: rows past n are neither read nor written.
//
// Design:
// * A persistent grid, a few blocks an SM, walks the rows [0, n) (gather,
//   activation: one thread an 8-element piece of a row) or the tokens [0, T)
//   (a warp a token: the gather's backward and the combine, which visit a
//   token's k rows through inv).  Rows move as 16-byte vectors: 8 bf16, or
//   8 float32 as two vectors.
// * The token of row r is order[r] / k; the held rows of token t are inv[t k
//   + j] < n, j = 0 .. k - 1.
// * Rounding: each operation rounds where the plain version's PyTorch kernel
//   rounds on the card, through an explicit round-to-nearest intrinsic:
//   products and sums of bf16 values in float32 and one rounding to bf16; silu
//   as x / (1 + exp(-x)) and its derivative as dy s (1 + x (1 - s)) with the
//   inner product-sum one fused multiply-add, as PyTorch's kernels do.  A
//   sum over a token's k choices keeps four float32 partial sums, choice j
//   into partial j mod 4, and adds them as ((p0 + p1) + p2) + p3: the order
//   of PyTorch's reduction over a dimension that is not the innermost.
// * The combine's backward writes grad_ys[inv] = bf16(w g) for each held
//   choice: each row has one writer, so no zero fill and no atomics.  Its
//   grad_w is a dot product over d in float32, a warp's shuffle sum (another
//   order than PyTorch's reduction; the one result that is not bit-equal).
// * No atomics anywhere: a step's result does not depend on the order of the
//   blocks, so replayed steps repeat eager ones to the bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;  // MAX_K in moe_rows_cuda.py

using bf16 = __nv_bfloat16;

// 8 elements of a row, widened to float32
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
// 8 elements stored in the row's type, bf16 rounded to nearest even
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// x rounded to the row type and widened back (the identity for float32)
template <typename Row>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}

// PyTorch's silu on the card: x / (1 + exp(-x)), in float32
__device__ __forceinline__ float sigmoid_of(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}
__device__ __forceinline__ float silu(float x) { return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x))); }

// the four partial sums of a token's choices, added as PyTorch's reduction adds them
__device__ __forceinline__ float add4(const float (&p)[4][8], int e) {
  return __fadd_rn(__fadd_rn(__fadd_rn(p[0][e], p[1][e]), p[2][e]), p[3][e]);
}

// row r < n of xs: token order[r] / k, rounded to the row type
template <typename Row>
__global__ void __launch_bounds__(kThreads)
    moe_gather_rows(const float* __restrict__ tokens, long long ld_tok,
                    const long long* __restrict__ order, int k, const int* __restrict__ offs_last,
                    Row* __restrict__ xs, long long ld_xs, int pieces) {
  const int items = *offs_last * pieces;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < items; i += gridDim.x * kThreads) {
    const int r = i / pieces;
    const int c = (i - r * pieces) * 8;
    const int t = (int)order[r] / k;
    float v[8];
    load8(tokens + t * ld_tok + c, v);
    store8(xs + r * ld_xs + c, v);
  }
}

// token t's gradient: the sum of its held rows of grad_xs in the choices'
// order, rounded to the row type, in float32
template <typename Row>
__global__ void __launch_bounds__(kThreads)
    moe_gather_rows_backward(const Row* __restrict__ grad, long long ld_g,
                             const long long* __restrict__ inv, int k,
                             const int* __restrict__ offs_last, int n_tokens,
                             float* __restrict__ out, long long ld_out, int pieces) {
  const long long n = *offs_last;
  const int lane = threadIdx.x & 31;
  for (int t = blockIdx.x * kWarps + (threadIdx.x >> 5); t < n_tokens; t += gridDim.x * kWarps) {
    long long row[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) row[j] = j < k ? inv[(long long)t * k + j] : n;
    for (int c = lane * 8; c < pieces * 8; c += 32 * 8) {
      float p[4][8] = {};
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (row[j] < n) {
          float x[8];
          load8(grad + row[j] * ld_g + c, x);
#pragma unroll
          for (int e = 0; e < 8; ++e) p[j & 3][e] = __fadd_rn(p[j & 3][e], x[e]);
        }
      }
      float s[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = round_to<Row>(add4(p, e));
      store8(out + t * ld_out + c, s);
    }
  }
}

// row r < n: h = silu(gate) * up from the first product's [gate | up]
template <typename Row>
__global__ void __launch_bounds__(kThreads)
    moe_swiglu_rows(const Row* __restrict__ h1, long long ld_in, const int* __restrict__ offs_last,
                    int width, Row* __restrict__ h, long long ld_out, int pieces) {
  const int items = *offs_last * pieces;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < items; i += gridDim.x * kThreads) {
    const int r = i / pieces;
    const int c = (i - r * pieces) * 8;
    float g[8], u[8], o[8];
    load8(h1 + r * ld_in + c, g);
    load8(h1 + r * ld_in + width + c, u);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = __fmul_rn(round_to<Row>(silu(g[e])), u[e]);
    store8(h + r * ld_out + c, o);
  }
}

// row r < n: [d gate | d up] from dh and the first product's [gate | up];
// silu(gate) is recomputed, as the plain version's mul saved it
template <typename Row>
__global__ void __launch_bounds__(kThreads)
    moe_swiglu_rows_backward(const Row* __restrict__ dh, long long ld_dh, const Row* __restrict__ h1,
                             long long ld_in, const int* __restrict__ offs_last, int width,
                             Row* __restrict__ dh1, long long ld_out, int pieces) {
  const int items = *offs_last * pieces;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < items; i += gridDim.x * kThreads) {
    const int r = i / pieces;
    const int c = (i - r * pieces) * 8;
    float dy[8], g[8], u[8], dg[8], du[8];
    load8(dh + r * ld_dh + c, dy);
    load8(h1 + r * ld_in + c, g);
    load8(h1 + r * ld_in + width + c, u);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float s = round_to<Row>(silu(g[e]));
      du[e] = __fmul_rn(dy[e], s);
      const float ds = round_to<Row>(__fmul_rn(dy[e], u[e]));
      const float sig = sigmoid_of(g[e]);
      dg[e] = __fmul_rn(__fmul_rn(ds, sig), __fmaf_rn(g[e], __fsub_rn(1.0f, sig), 1.0f));
    }
    store8(dh1 + r * ld_out + c, dg);
    store8(dh1 + r * ld_out + width + c, du);
  }
}

// out[t] = sum over token t's held choices j of w[t, j] ys[inv[t k + j]], in float32
template <typename Row>
__global__ void __launch_bounds__(kThreads)
    moe_combine_rows(const Row* __restrict__ ys, long long ld_y, const float* __restrict__ w,
                     const long long* __restrict__ inv, int k, const int* __restrict__ offs_last,
                     int n_tokens, float* __restrict__ out, long long ld_out, int pieces) {
  const long long n = *offs_last;
  const int lane = threadIdx.x & 31;
  for (int t = blockIdx.x * kWarps + (threadIdx.x >> 5); t < n_tokens; t += gridDim.x * kWarps) {
    long long row[kMaxK];
    float wt[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      row[j] = j < k ? inv[(long long)t * k + j] : n;
      wt[j] = j < k ? w[(long long)t * k + j] : 0.0f;
    }
    for (int c = lane * 8; c < pieces * 8; c += 32 * 8) {
      float p[4][8] = {};
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (row[j] < n) {
          float y[8];
          load8(ys + row[j] * ld_y + c, y);
#pragma unroll
          for (int e = 0; e < 8; ++e) p[j & 3][e] = __fadd_rn(p[j & 3][e], __fmul_rn(y[e], wt[j]));
        }
      }
      float s[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = add4(p, e);
      store8(out + t * ld_out + c, s);
    }
  }
}

// token t: grad_ys[inv[t k + j]] = round(w[t, j] g[t]) and grad_w[t, j] =
// <g[t], ys[inv[t k + j]]> for each held choice j; 0 for a choice not held
template <typename Row>
__global__ void __launch_bounds__(kThreads)
    moe_combine_rows_backward(const float* __restrict__ g, long long ld_g, const Row* __restrict__ ys,
                              long long ld_y, const float* __restrict__ w,
                              const long long* __restrict__ inv, int k,
                              const int* __restrict__ offs_last, int n_tokens,
                              Row* __restrict__ grad_ys, long long ld_gy, float* __restrict__ grad_w,
                              int pieces) {
  const long long n = *offs_last;
  const int lane = threadIdx.x & 31;
  for (int t = blockIdx.x * kWarps + (threadIdx.x >> 5); t < n_tokens; t += gridDim.x * kWarps) {
    long long row[kMaxK];
    float wt[kMaxK], dot[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      row[j] = j < k ? inv[(long long)t * k + j] : n;
      wt[j] = j < k ? w[(long long)t * k + j] : 0.0f;
      dot[j] = 0.0f;
    }
    for (int c = lane * 8; c < pieces * 8; c += 32 * 8) {
      float gv[8];
      load8(g + t * ld_g + c, gv);
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (row[j] < n) {
          float y[8], q[8];
          load8(ys + row[j] * ld_y + c, y);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            dot[j] = __fmaf_rn(gv[e], y[e], dot[j]);
            // the product, rounded to the row type, added to index_add's zero
            q[e] = __fadd_rn(round_to<Row>(__fmul_rn(gv[e], wt[j])), 0.0f);
          }
          store8(grad_ys + row[j] * ld_gy + c, q);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      float s = dot[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0 && j < k) grad_w[(long long)t * k + j] = row[j] < n ? s : 0.0f;
    }
  }
}

// a persistent grid: as many blocks as the SMs hold at once, at most `blocks`
template <typename Kernel>
int grid_of(Kernel kernel, long long blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (int)(blocks < most ? (blocks > 0 ? blocks : 1) : most);
}

long long row_blocks(long long rows, int pieces) { return (rows * pieces + kThreads - 1) / kThreads; }
long long token_blocks(long long n_tokens) { return (n_tokens + kWarps - 1) / kWarps; }

template <typename Row>
int gather(const void* tokens, long long ld_tok, const void* order, int k, const void* offs_last,
           void* xs, long long ld_xs, long long rows, int pieces, cudaStream_t s) {
  auto kernel = moe_gather_rows<Row>;
  kernel<<<grid_of(kernel, row_blocks(rows, pieces)), kThreads, 0, s>>>(
      static_cast<const float*>(tokens), ld_tok, static_cast<const long long*>(order), k,
      static_cast<const int*>(offs_last), static_cast<Row*>(xs), ld_xs, pieces);
  return (int)cudaGetLastError();
}

template <typename Row>
int gather_backward(const void* grad, long long ld_g, const void* inv, int k, const void* offs_last,
                    int n_tokens, void* out, long long ld_out, int pieces, cudaStream_t s) {
  auto kernel = moe_gather_rows_backward<Row>;
  kernel<<<grid_of(kernel, token_blocks(n_tokens)), kThreads, 0, s>>>(
      static_cast<const Row*>(grad), ld_g, static_cast<const long long*>(inv), k,
      static_cast<const int*>(offs_last), n_tokens, static_cast<float*>(out), ld_out, pieces);
  return (int)cudaGetLastError();
}

template <typename Row>
int swiglu(const void* h1, long long ld_in, const void* offs_last, int width, void* h, long long ld_out,
           long long rows, cudaStream_t s) {
  auto kernel = moe_swiglu_rows<Row>;
  const int pieces = width / 8;
  kernel<<<grid_of(kernel, row_blocks(rows, pieces)), kThreads, 0, s>>>(
      static_cast<const Row*>(h1), ld_in, static_cast<const int*>(offs_last), width,
      static_cast<Row*>(h), ld_out, pieces);
  return (int)cudaGetLastError();
}

template <typename Row>
int swiglu_backward(const void* dh, long long ld_dh, const void* h1, long long ld_in,
                    const void* offs_last, int width, void* dh1, long long ld_out, long long rows,
                    cudaStream_t s) {
  auto kernel = moe_swiglu_rows_backward<Row>;
  const int pieces = width / 8;
  kernel<<<grid_of(kernel, row_blocks(rows, pieces)), kThreads, 0, s>>>(
      static_cast<const Row*>(dh), ld_dh, static_cast<const Row*>(h1), ld_in,
      static_cast<const int*>(offs_last), width, static_cast<Row*>(dh1), ld_out, pieces);
  return (int)cudaGetLastError();
}

template <typename Row>
int combine(const void* ys, long long ld_y, const void* w, const void* inv, int k, const void* offs_last,
            int n_tokens, void* out, long long ld_out, int pieces, cudaStream_t s) {
  auto kernel = moe_combine_rows<Row>;
  kernel<<<grid_of(kernel, token_blocks(n_tokens)), kThreads, 0, s>>>(
      static_cast<const Row*>(ys), ld_y, static_cast<const float*>(w),
      static_cast<const long long*>(inv), k, static_cast<const int*>(offs_last), n_tokens,
      static_cast<float*>(out), ld_out, pieces);
  return (int)cudaGetLastError();
}

template <typename Row>
int combine_backward(const void* g, long long ld_g, const void* ys, long long ld_y, const void* w,
                     const void* inv, int k, const void* offs_last, int n_tokens, void* grad_ys,
                     long long ld_gy, void* grad_w, int pieces, cudaStream_t s) {
  auto kernel = moe_combine_rows_backward<Row>;
  kernel<<<grid_of(kernel, token_blocks(n_tokens)), kThreads, 0, s>>>(
      static_cast<const float*>(g), ld_g, static_cast<const Row*>(ys), ld_y,
      static_cast<const float*>(w), static_cast<const long long*>(inv), k,
      static_cast<const int*>(offs_last), n_tokens, static_cast<Row*>(grad_ys), ld_gy,
      static_cast<float*>(grad_w), pieces);
  return (int)cudaGetLastError();
}

bool bad_k(int k) { return k < 1 || k > kMaxK; }

}  // namespace

// The C interface: every pointer is a device address, `offs_last` the held
// rows' count n (int32) on the card, `ld_*` row strides in elements, `width`
// and d multiples of 8, rows 16-byte aligned (the wrapper checks all of it).
// `bf16` picks bf16 rows, else float32 rows; tokens, the combine's weights,
// its result and the tokens' gradient are float32, order and inv int64.  Each
// launches on `stream`, does not synchronise, and returns cudaGetLastError().

extern "C" int moe_gather_launch(int bf16_rows, const void* tokens, long long ld_tok, const void* order,
                                 int k, const void* offs_last, void* xs, long long ld_xs,
                                 long long rows, int d, void* stream) {
  if (bad_k(k) || d % 8 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16_rows ? gather<bf16>(tokens, ld_tok, order, k, offs_last, xs, ld_xs, rows, d / 8, s)
                   : gather<float>(tokens, ld_tok, order, k, offs_last, xs, ld_xs, rows, d / 8, s);
}

extern "C" int moe_gather_backward_launch(int bf16_rows, const void* grad, long long ld_g,
                                          const void* inv, int k, const void* offs_last, int n_tokens,
                                          void* out, long long ld_out, int d, void* stream) {
  if (bad_k(k) || d % 8 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16_rows
             ? gather_backward<bf16>(grad, ld_g, inv, k, offs_last, n_tokens, out, ld_out, d / 8, s)
             : gather_backward<float>(grad, ld_g, inv, k, offs_last, n_tokens, out, ld_out, d / 8, s);
}

extern "C" int moe_swiglu_launch(int bf16_rows, const void* h1, long long ld_in, const void* offs_last,
                                 int width, void* h, long long ld_out, long long rows, void* stream) {
  if (width % 8 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16_rows ? swiglu<bf16>(h1, ld_in, offs_last, width, h, ld_out, rows, s)
                   : swiglu<float>(h1, ld_in, offs_last, width, h, ld_out, rows, s);
}

extern "C" int moe_swiglu_backward_launch(int bf16_rows, const void* dh, long long ld_dh, const void* h1,
                                          long long ld_in, const void* offs_last, int width, void* dh1,
                                          long long ld_out, long long rows, void* stream) {
  if (width % 8 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16_rows
             ? swiglu_backward<bf16>(dh, ld_dh, h1, ld_in, offs_last, width, dh1, ld_out, rows, s)
             : swiglu_backward<float>(dh, ld_dh, h1, ld_in, offs_last, width, dh1, ld_out, rows, s);
}

extern "C" int moe_combine_launch(int bf16_rows, const void* ys, long long ld_y, const void* w,
                                  const void* inv, int k, const void* offs_last, int n_tokens, void* out,
                                  long long ld_out, int d, void* stream) {
  if (bad_k(k) || d % 8 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16_rows
             ? combine<bf16>(ys, ld_y, w, inv, k, offs_last, n_tokens, out, ld_out, d / 8, s)
             : combine<float>(ys, ld_y, w, inv, k, offs_last, n_tokens, out, ld_out, d / 8, s);
}

extern "C" int moe_combine_backward_launch(int bf16_rows, const void* g, long long ld_g, const void* ys,
                                           long long ld_y, const void* w, const void* inv, int k,
                                           const void* offs_last, int n_tokens, void* grad_ys,
                                           long long ld_gy, void* grad_w, int d, void* stream) {
  if (bad_k(k) || d % 8 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16_rows ? combine_backward<bf16>(g, ld_g, ys, ld_y, w, inv, k, offs_last, n_tokens, grad_ys,
                                            ld_gy, grad_w, d / 8, s)
                   : combine_backward<float>(g, ld_g, ys, ld_y, w, inv, k, offs_last, n_tokens,
                                             grad_ys, ld_gy, grad_w, d / 8, s);
}
