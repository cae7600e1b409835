// IGSO(3) log-density and score, fused, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `igso3_logpdf_score_pallas` /
// `_logpdf_score_kernel` in diffusion_extensions_tpu/ops/igso3_pallas.py.
// Elementwise: (angle t, sigma) -> (log f(t; sigma), d/dt log f(t; sigma)),
// the function of the plain PyTorch version `igso3_log_density` +
// `igso3_score_angle` (diffusion_extensions_tpu_torch/ops/igso3.py):
//
//   * wrapped-image terms regrouped with sinh/cosh so nothing cancels in
//     float32; q*sinh(x), q*cosh(x) for x < 1, else (e1 -/+ e2)/2 with both
//     exponents <= 0 on [0, pi], so nothing overflows;
//   * t < 1e-6: the ratio A/(2 sin(t/2)) takes its limit A'(0);
//     t == 0 takes the reference's patch constant;
//   * t < 1e-4: the score takes its analytic small-t limit.
//
// Bound on this card: per element 16 bytes of memory traffic (two f32 loads,
// two f32 stores; 12 when sigma is one value read by every thread) against
// 89 f32 operations of the plain version, each exp/log/sin/tan/sinh/cosh
// counted as one: 35 for the wrapped-image terms A and A' (1 square, 1
// division, 3 exp, sinh, cosh, 28 multiplies, adds, compares and selects),
// 27 for the log-density (sin, exp, 2 log, 3 divisions, 20 others) and 27
// for the score (tan, 6 divisions, 20 others).  So it is memory-bound: about
// 5 us per 2^20 elements at 3.35 TB/s.  On the sampling paths it runs on 32
// to 50,000 elements a call, where the launch itself is the cost.
//
// Design: one pass, one element a thread, each operand read with stride 0
// or 1 (a one-value sigma is read in place, never expanded).  Two arithmetic
// paths, chosen per element:
//   * the exact path: the plain version's expression operation by
//     operation, with the accurate expf / sinhf / coshf / sinf / tanf / logf
//     and IEEE divisions.  It runs where the function is ill-conditioned and
//     kernel and plain version agree only because every product and sum
//     rounds alike: for t < kExactBelow = 0.02 (just above t = 1e-4 the
//     score is A'/A - 0.5/tan(t/2), two terms of size 1/t whose one ulp is
//     ~1e-3, more than the score's absolute tolerance 5e-4); and near t = pi
//     with a small sigma (u = pi/var > 500 and u (pi - t) < 20), where
//     -t/(2 var) and A'/A, both of size u, cancel to a small score.  Also
//     for any t or sigma outside the range the cheap path is written for;
//   * the cheap path, for the rest of 0.02 <= t <= 3.15, where an ulp of
//     either large term is < 6e-5: u = pi/var keeps its IEEE division and
//     x - pi u its rounding (the exponent is a difference of two large
//     products, and the plain version's own rounding of it is part of its
//     value); every other division is one approximate reciprocal; exp is
//     ex2.approx; two exponentials, not four (q or q e^x by a select before
//     the exp); sinh/cosh on [0, 1] and sin/cos of t/2 on [0, pi/2] are
//     short polynomials (tools/fit_kernel_polys.py: <= 2e-7), so no
//     large-argument path; cot = cos/sin; -1.5 log(var) + log(ratio) is one
//     logf of ratio / var^1.5; no t = 0 or small-t patch is computed.
//
// Measured by chip_smoke.py (phase kernel_time) on an NVIDIA H100 80GB HBM3
// at a 700 W power limit, on t uniform on (0, pi) (0.65% of the elements
// take the exact path, and a warp that holds one runs both): 0.0111 ms at
// 2^20 elements with a dense sigma (bound 0.0050 ms, 45%) and 0.0106 ms with
// one sigma (bound 0.0038 ms); 0.0026-0.0027 ms at n = 32, 20,000 and 50,000
// (the launch and one element's latency; bounds 1.5e-7 to 1.8e-4 ms).  ptxas:
// 30 registers, no shared memory, no stack frame, no spills; 920 SASS
// instructions for both paths.  PERF.md, section 6, row 1 keeps the runs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
//        -Xcompiler -fPIC.  No --use_fast_math: each approximation is chosen
// in this source.  -fmad=false keeps every product and sum of the exact path
// rounded on its own, as the plain version's one-op-per-kernel evaluation
// rounds them; the cheap path asks for its fused multiply-adds with fmaf.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kHalfLogPi = 0.57236494292470008707f;  // 0.5 * log(pi)
constexpr float kTwoPi = 6.28318530717958647693f;       // 2 pi
constexpr float kFourPi = 12.5663706143591729539f;      // 4 pi
constexpr float kPiSq = 9.86960440108935861883f;        // pi^2
constexpr float kTwoPiSq = 19.7392088021787172377f;     // 2 pi^2
constexpr float kFourPiSq = 39.4784176043574344753f;    // 4 pi^2
constexpr float kLog2E = 1.44269504088896340736f;

// the cheap path's domain
constexpr float kExactBelow = 0.02f;
constexpr float kCheapMaxT = 3.15f;
constexpr float kCheapMinVar = 1e-10f;
constexpr float kCheapMaxVar = 1e20f;
constexpr float kNearPiMinU = 500.0f;  // near t = pi: u > this and
constexpr float kNearPiGap = 20.0f;    // pi u - x = u (pi - t) < this

// tools/fit_kernel_polys.py, lowest coefficient first:
// sin(h) = h S(h^2) and cos(h) = C(h^2) on [0, pi/2]  (sin[5], cos[6])
constexpr float kSin1 = -1.666666716e-01f;
constexpr float kSin2 = 8.333301172e-03f;
constexpr float kSin3 = -1.982934773e-04f;
constexpr float kSin4 = 2.651807563e-06f;
constexpr float kCos1 = -5.000000000e-01f;
constexpr float kCos2 = 4.166666791e-02f;
constexpr float kCos3 = -1.388882869e-03f;
constexpr float kCos4 = 2.478820716e-05f;
constexpr float kCos5 = -2.660482323e-07f;
// sinh(x) = x H(x^2) and cosh(x) = G(x^2) on [0, 1]  (sinh[4], cosh[5])
constexpr float kSinh1 = 1.666675955e-01f;
constexpr float kSinh2 = 8.329011500e-03f;
constexpr float kSinh3 = 2.045844012e-04f;
constexpr float kCosh1 = 4.999999404e-01f;
constexpr float kCosh2 = 4.166707769e-02f;
constexpr float kCosh3 = 1.387991477e-03f;
constexpr float kCosh4 = 2.563273847e-05f;

__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float rsqrt_approx(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// e^v for v <= 0 (0 below the float32 range)
__device__ __forceinline__ float exp_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v * kLog2E));
  return r;
}

// The plain version's arithmetic, operation by operation.
__device__ __forceinline__ void exact_path(const float t, const float sigma,
                                           float& logf_out, float& score_out) {
  const float var = sigma * sigma;

  // wrapped-image terms A(t), A'(t)
  const float u = kPi / var;
  const float x = u * t;
  const float pu = kPi * u;
  const float e1 = expf(x - pu);   // q e^x
  const float e2 = expf(-x - pu);  // q e^-x
  const bool small_x = x < 1.0f;
  const float xs = small_x ? x : 0.0f;
  const float q = expf(-pu);
  const float qs = small_x ? q * sinhf(xs) : 0.5f * (e1 - e2);
  const float qc = small_x ? q * coshf(xs) : 0.5f * (e1 + e2);
  const float one_m2qc = 1.0f - 2.0f * qc;
  const float a = t * one_m2qc + kFourPi * qs;
  const float da = one_m2qc - 2.0f * t * u * qs + kFourPi * u * qc;

  // log density: log_c + log(A / (2 sin(t/2)))
  const bool small_t = t < 1e-6f;
  const float t_safe = small_t ? 1.0f : t;
  float ratio = small_t ? da : a / (2.0f * sinf(t_safe / 2.0f));
  const float qv = expf(-kPiSq / var);
  if (t == 0.0f) ratio = 1.0f - 2.0f * qv + kFourPiSq * qv;
  const float log_c =
      kHalfLogPi - 1.5f * logf(var) + var / 4.0f - (t * t) / (4.0f * var);
  // NaN-propagating clamp, as torch.clamp(ratio, min=1e-38)
  const float ratio_c = ratio < 1e-38f ? 1e-38f : ratio;
  logf_out = log_c + logf(ratio_c);

  // score: -t/(2 var) + A'/A - cot(t/2)/2, or its small-t limit
  const bool small_s = t < 1e-4f;
  const float ts = small_s ? 1.0f : t;
  const float direct =
      -t / (2.0f * var) + da / (small_s ? 1.0f : a) - 0.5f / tanf(ts / 2.0f);
  const float dd_a0 = -kTwoPi * qv / var;
  const float d_a0 = 1.0f + 2.0f * qv * (kTwoPiSq / var - 1.0f);
  const float limit = dd_a0 / (2.0f * d_a0) + t / 12.0f - t / (2.0f * var);
  score_out = small_s ? limit : direct;
}

// The same function where it is well-conditioned (see logpdf_score);
// u = pi / var, x = u t and pu = pi u rounded as the plain version rounds them.
__device__ __forceinline__ void cheap_path(const float t, const float var, const float u,
                                           const float x, const float pu,
                                           float& logf_out, float& score_out) {
  const bool small_x = x < 1.0f;
  const float ea = exp_approx(small_x ? -pu : x - pu);  // q, or q e^x
  const float eb = exp_approx(-x - pu);                 // q e^-x
  const float xs = small_x ? x : 0.0f;
  const float x2 = xs * xs;
  float sh = fmaf(kSinh3, x2, kSinh2);
  sh = fmaf(sh, x2, kSinh1);
  sh = fmaf(sh, x2, 1.0f) * xs;
  float ch = fmaf(kCosh4, x2, kCosh3);
  ch = fmaf(ch, x2, kCosh2);
  ch = fmaf(ch, x2, kCosh1);
  ch = fmaf(ch, x2, 1.0f);
  const float qs = small_x ? ea * sh : 0.5f * (ea - eb);
  const float qc = small_x ? ea * ch : 0.5f * (ea + eb);
  const float w = fmaf(-2.0f, qc, 1.0f);
  const float a = fmaf(t, w, kFourPi * qs);
  const float da = fmaf(-2.0f * x, qs, fmaf(kFourPi * u, qc, w));

  // sin and cos of t/2
  const float h = 0.5f * t;
  const float h2 = h * h;
  float sn = fmaf(kSin4, h2, kSin3);
  sn = fmaf(sn, h2, kSin2);
  sn = fmaf(sn, h2, kSin1);
  sn = fmaf(sn, h2, 1.0f) * h;
  float cs = fmaf(kCos5, h2, kCos4);
  cs = fmaf(cs, h2, kCos3);
  cs = fmaf(cs, h2, kCos2);
  cs = fmaf(cs, h2, kCos1);
  cs = fmaf(cs, h2, 1.0f);
  const float inv_sin = rcp_approx(sn);

  // 1/var to under an ulp: the large terms t/(2 var), t^2/(4 var) use it
  float iv = rcp_approx(var);
  iv = fmaf(fmaf(-var, iv, 1.0f), iv, iv);
  const float hv = 0.5f * t * iv;  // t / (2 var)

  // log f = 0.5 log(pi) + log(ratio / var^1.5) + var/4 - t^2/(4 var)
  const float ratio = 0.5f * a * inv_sin;
  const float ratio_c = ratio < 1e-38f ? 1e-38f : ratio;
  const float lg = logf(ratio_c * iv * rsqrt_approx(var));
  logf_out = fmaf(-0.5f * hv, t, fmaf(0.25f, var, kHalfLogPi + lg));

  // score = -t/(2 var) + A'/A - cot(t/2)/2
  score_out = fmaf(da, rcp_approx(a), -hv) - 0.5f * cs * inv_sin;
}

// Per element: the cheap path where it applies, else the exact one.
__device__ __forceinline__ void logpdf_score(const float t, const float sigma,
                                             float& logf_out, float& score_out) {
  const float var = sigma * sigma;
  const float u = kPi / var;
  const float x = u * t;
  const float pu = kPi * u;
  const bool near_pi = u > kNearPiMinU && pu - x < kNearPiGap;
  if (t >= kExactBelow && t <= kCheapMaxT && var >= kCheapMinVar && var <= kCheapMaxVar &&
      !near_pi) {
    cheap_path(t, var, u, x, pu, logf_out, score_out);
  } else {
    exact_path(t, sigma, logf_out, score_out);
  }
}

// One element a thread, t[i * t_stride] and sigma[i * sigma_stride] with
// strides 0 or 1.
__global__ void __launch_bounds__(kThreads)
    igso3_logpdf_score_kernel(const float* __restrict__ t_in, const long long t_stride,
                              const float* __restrict__ sigma_in,
                              const long long sigma_stride, float* __restrict__ logf_out,
                              float* __restrict__ score_out, const long long n) {
  const long long step = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    logpdf_score(t_in[i * t_stride], sigma_in[i * sigma_stride], logf_out[i], score_out[i]);
  }
}

}  // namespace

// t[i * t_stride], sigma[i * sigma_stride] -> logf_out[i], score_out[i] for
// i < n; strides are 0 (one value for every element) or 1.  Launches on
// `stream` (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int igso3_logpdf_score_launch(const void* t, long long t_stride,
                                         const void* sigma, long long sigma_stride,
                                         void* logf_out, void* score_out, long long n,
                                         void* stream) {
  if (n <= 0) return 0;
  if ((t_stride | sigma_stride) & ~1LL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long max_blocks = 0x7fffffffLL;
  long long blocks = (n + kThreads - 1) / kThreads;
  blocks = blocks > max_blocks ? max_blocks : blocks;
  igso3_logpdf_score_kernel<<<(unsigned int)blocks, kThreads, 0, s>>>(
      (const float*)t, t_stride, (const float*)sigma, sigma_stride, (float*)logf_out,
      (float*)score_out, n);
  return (int)cudaGetLastError();
}
