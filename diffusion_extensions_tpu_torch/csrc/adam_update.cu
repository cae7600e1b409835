// Adam's update of every leaf of a model in one launch
// (diffusion_extensions_tpu_torch/ops/adam_cuda.py, called by train/optim.py).
//
// Replaces no TPU kernel: the JAX package has no Pallas kernel for its
// optimizer; optax's chain and its `fused_adam` (train/optim.py there) are
// left to XLA, which fuses each leaf's update into one loop.  On the card
// PyTorch ran the same update as many passes: about 17 small kernels a leaf
// for the plain chain, and about 11 `_foreach` sweeps plus casts of both bf16
// moments up and down for the fused order, some 130 bytes of traffic a
// parameter.
//
// Bound on this card: memory.  Each parameter reads p and g (4 + 4 bytes)
// and mu and nu (4 + 4, or 2 + 2 in bf16), and writes p, mu and nu: 28 bytes
// with float32 moments, 20 with bf16 ones.  The arithmetic (three or four
// IEEE divisions and a square root) stays under that on the H100.  So each
// element is loaded once, updated in float32 registers and stored once;
// nothing is written between, and nothing is allocated.
//
// Design:
// * The leaves are cut into chunks of `chunk` elements (the wrapper's plan),
//   one block a chunk, so the many small leaves (most of them under 4,096
//   elements) and the large ones (millions) spread over every SM alike.  A
//   block finds its leaf by a binary search over the first chunk of each leaf.
// * The leaf table (pointers, sizes, first chunks) is a kernel argument, so a
//   launch captured in a CUDA graph replays with the addresses it was
//   captured with (a captured step's gradients live in the graph's pool), and
//   an eager launch with the addresses of that call.  `__grid_constant__`
//   keeps it in the parameter bank, read with an index, never copied.
// * 16-byte loads and stores where a leaf's four pointers allow it, four such
//   vectors in flight a thread; a leaf that is not aligned, and the last
//   (size mod 4) elements of a leaf, go one element at a time.  The gradient is
//   read once: it is loaded with a streaming hint (`__ldcs`).
// * The device scalars (learning rate, both bias corrections, and with a clip
//   the gradients' norm or the clip scale) are read from device memory, so a
//   replayed graph uses each step's count.
// * Rounding: every operation of the plain version (`adam_update_ref`) is one
//   explicit round-to-nearest intrinsic here, in the plain version's order
//   (`kFused` chooses the order), and the file is built with -fmad=false, so
//   no other product and sum are contracted.  The fused order's moment updates
//   are PyTorch's `_foreach_add_(alpha=)` and `_foreach_addcmul_`, which are
//   one fused multiply-add each on the card; the plain chain's are separate
//   kernels, each rounded.  bf16 moments (the fused order only, as the
//   optimizer's factory allows) are rounded to nearest even at the store,
//   after the update has used their float32 values.
// * No atomics: a step's result does not depend on the order of the blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;  // 4-element vectors in flight a thread
constexpr int kMaxLeaves = 640;  // MAX_LEAVES in adam_cuda.py: the table fits 32,764 bytes

struct Leaves {
  int n;
  int first_chunk[kMaxLeaves + 1];  // leaf i holds chunks [first_chunk[i], first_chunk[i + 1])
  long long size[kMaxLeaves];
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  void* mu[kMaxLeaves];
  void* nu[kMaxLeaves];
};

struct Hyper {
  const float* lr;          // the schedule at the pre-increment count
  const float* bc1;         // 1 - b1^count
  const float* bc2;         // 1 - b2^count
  const float* clip_value;  // the gradients' norm (plain chain) or clip scale (fused order)
  float b1, c1, b2, c2, eps, clip;  // c1 = 1 - b1, c2 = 1 - b2, rounded from double
  long long chunk;
};

struct Scalars {
  float neg_lr, bc1, bc2, cv;
  float b1, c1, b2, c2, eps, clip;
};

// One element: p, m and v in place; g is read.
template <bool kFused, bool kClip, typename M>
__device__ __forceinline__ void adam1(float& p, float g, float& m, float& v, const Scalars& s) {
  if (kFused) {
    // _foreach_mul(grads, scale); mu * b1 then + (1 - b1) g as one fma;
    // nu * b2 then + (1 - b2) (g g) as one fma; -lr (mu / bc1) / (sqrt(nu / bc2) + eps)
    if (kClip) g = __fmul_rn(g, s.cv);
    m = __fmaf_rn(s.c1, g, __fmul_rn(m, s.b1));
    v = __fmaf_rn(s.c2, __fmul_rn(g, g), __fmul_rn(v, s.b2));
    const float upd = __fmul_rn(__fdiv_rn(m, s.bc1), s.neg_lr);
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps);
    p = __fadd_rn(p, __fdiv_rn(upd, den));
  } else {
    // where(norm < clip, g, (g / norm) clip); (1 - b1) g + b1 mu;
    // (1 - b2) (g g) + b2 nu; (mu / bc1) / (sqrt(nu / bc2) + eps) * -lr
    if (kClip && !(s.cv < s.clip)) g = __fmul_rn(__fdiv_rn(g, s.cv), s.clip);
    m = __fadd_rn(__fmul_rn(s.c1, g), __fmul_rn(s.b1, m));
    v = __fadd_rn(__fmul_rn(s.c2, __fmul_rn(g, g)), __fmul_rn(s.b2, v));
    const float u =
        __fdiv_rn(__fdiv_rn(m, s.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps));
    p = __fadd_rn(p, __fmul_rn(u, s.neg_lr));
  }
}

// Four moments at vector index i (elements 4i .. 4i + 3).
__device__ __forceinline__ float4 load4(const float* base, long long i) {
  return reinterpret_cast<const float4*>(base)[i];
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* base, long long i) {
  const uint2 raw = reinterpret_cast<const uint2*>(base)[i];
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* base, long long i, float4 v) {
  reinterpret_cast<float4*>(base)[i] = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* base, long long i, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned int*>(&lo);
  raw.y = *reinterpret_cast<const unsigned int*>(&hi);
  reinterpret_cast<uint2*>(base)[i] = raw;
}
__device__ __forceinline__ float load1(const float* base, long long i) { return base[i]; }
__device__ __forceinline__ float load1(const __nv_bfloat16* base, long long i) {
  return __bfloat162float(base[i]);
}
__device__ __forceinline__ void store1(float* base, long long i, float v) { base[i] = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* base, long long i, float v) {
  base[i] = __float2bfloat16_rn(v);
}

template <bool kFused, bool kClip, typename M>
__device__ __forceinline__ void adam4(float4& p, float4 g, float4& m, float4& v,
                                      const Scalars& s) {
  adam1<kFused, kClip, M>(p.x, g.x, m.x, v.x, s);
  adam1<kFused, kClip, M>(p.y, g.y, m.y, v.y, s);
  adam1<kFused, kClip, M>(p.z, g.z, m.z, v.z, s);
  adam1<kFused, kClip, M>(p.w, g.w, m.w, v.w, s);
}

template <bool kFused, bool kClip, typename M>
__global__ void __launch_bounds__(kThreads)
    adam_update_kernel(const __grid_constant__ Leaves t, const __grid_constant__ Hyper h) {
  // the leaf of this chunk: the last one whose first chunk is at or before it
  const int c = blockIdx.x;
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_chunk[mid] <= c) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const long long start = (long long)(c - t.first_chunk[lo]) * h.chunk;
  const long long rest = t.size[lo] - start;
  const long long len = rest < h.chunk ? rest : h.chunk;
  float* p = t.p[lo] + start;
  const float* g = t.g[lo] + start;
  M* mu = static_cast<M*>(t.mu[lo]) + start;
  M* nu = static_cast<M*>(t.nu[lo]) + start;

  Scalars s;
  s.neg_lr = -*h.lr;
  s.bc1 = *h.bc1;
  s.bc2 = *h.bc2;
  s.cv = kClip ? *h.clip_value : 0.0f;
  s.b1 = h.b1;
  s.c1 = h.c1;
  s.b2 = h.b2;
  s.c2 = h.c2;
  s.eps = h.eps;
  s.clip = h.clip;

  long long done = 0;
  const uintptr_t moment_align = 4 * sizeof(M) - 1;
  if ((((uintptr_t)p | (uintptr_t)g) & 15) == 0 &&
      (((uintptr_t)mu | (uintptr_t)nu) & moment_align) == 0) {
    const long long vecs = len >> 2;
    for (long long base = threadIdx.x; base < vecs; base += (long long)kThreads * kVecs) {
      float4 pv[kVecs], gv[kVecs], mv[kVecs], vv[kVecs];
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const long long i = base + (long long)k * kThreads;
        if (i < vecs) {
          pv[k] = load4(p, i);
          gv[k] = __ldcs(reinterpret_cast<const float4*>(g) + i);
          mv[k] = load4(mu, i);
          vv[k] = load4(nu, i);
        }
      }
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const long long i = base + (long long)k * kThreads;
        if (i < vecs) {
          adam4<kFused, kClip, M>(pv[k], gv[k], mv[k], vv[k], s);
          store4(p, i, pv[k]);
          store4(mu, i, mv[k]);
          store4(nu, i, vv[k]);
        }
      }
    }
    done = vecs << 2;
  }
  for (long long i = done + threadIdx.x; i < len; i += kThreads) {
    float pi = p[i], mi = load1(mu, i), vi = load1(nu, i);
    adam1<kFused, kClip, M>(pi, __ldcs(g + i), mi, vi, s);
    p[i] = pi;
    store1(mu, i, mi);
    store1(nu, i, vi);
  }
}

template <bool kFused, bool kClip, typename M>
void launch(const Leaves& t, const Hyper& h, cudaStream_t s) {
  adam_update_kernel<kFused, kClip, M><<<(unsigned int)t.first_chunk[t.n], kThreads, 0, s>>>(t, h);
}

}  // namespace

// One launch over `n` leaves: leaf i has `size[i]` elements at the addresses
// p[i], g[i] (float32), mu[i], nu[i] (float32, or bf16 with `bf16`), every one
// dense with the same strides, and holds chunks [first_chunk[i],
// first_chunk[i + 1]) of `chunk` elements each.  `lr`, `bc1`, `bc2` and
// `clip_value` (null without a clip) point to one float32 each in device
// memory.  `fused` picks the fused order's rounding, else the plain chain's,
// which takes float32 moments only.
// Launches on `stream` (PyTorch's current stream), does not synchronise, and
// returns cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int adam_update_launch(int n, const long long* first_chunk, const long long* size,
                                  const long long* p, const long long* g, const long long* mu,
                                  const long long* nu, const void* lr, const void* bc1,
                                  const void* bc2, const void* clip_value, float b1, float c1,
                                  float b2, float c2, float eps, float clip, long long chunk,
                                  int fused, int bf16, void* stream) {
  if (n <= 0 || n > kMaxLeaves || chunk <= 0 || chunk % 4 != 0 || first_chunk[0] != 0 ||
      (bf16 && !fused))
    return (int)cudaErrorInvalidValue;
  Leaves t;  // 28 KB; the launch copies it into the kernel's parameters
  t.n = n;
  for (int i = 0; i < n; ++i) {
    const long long chunks = (size[i] + chunk - 1) / chunk;
    if (size[i] <= 0 || first_chunk[i + 1] - first_chunk[i] != chunks ||
        first_chunk[i + 1] > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    t.first_chunk[i] = (int)first_chunk[i];
    t.size[i] = size[i];
    t.p[i] = reinterpret_cast<float*>(p[i]);
    t.g[i] = reinterpret_cast<const float*>(g[i]);
    t.mu[i] = reinterpret_cast<void*>(mu[i]);
    t.nu[i] = reinterpret_cast<void*>(nu[i]);
  }
  t.first_chunk[n] = (int)first_chunk[n];
  const Hyper h{static_cast<const float*>(lr), static_cast<const float*>(bc1),
                static_cast<const float*>(bc2), static_cast<const float*>(clip_value),
                b1, c1, b2, c2, eps, clip, chunk};
  const cudaStream_t s = (cudaStream_t)stream;
  const bool has_clip = clip_value != nullptr;
  if (fused && bf16) {
    if (has_clip) launch<true, true, __nv_bfloat16>(t, h, s);
    else launch<true, false, __nv_bfloat16>(t, h, s);
  } else if (fused) {
    if (has_clip) launch<true, true, float>(t, h, s);
    else launch<true, false, float>(t, h, s);
  } else {
    if (has_clip) launch<false, true, float>(t, h, s);
    else launch<false, false, float>(t, h, s);
  }
  return (int)cudaGetLastError();
}
