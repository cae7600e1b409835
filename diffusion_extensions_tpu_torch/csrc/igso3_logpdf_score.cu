// IGSO(3) log-density and score, fused, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `igso3_logpdf_score_pallas` /
// `_logpdf_score_kernel` in diffusion_extensions_tpu/ops/igso3_pallas.py.
// Elementwise: (angle t, sigma) -> (log f(t; sigma), d/dt log f(t; sigma)),
// the same arithmetic as the plain PyTorch version `igso3_log_density` +
// `igso3_score_angle` (diffusion_extensions_tpu_torch/ops/igso3.py):
//
//   * wrapped-image terms regrouped with sinh/cosh so nothing cancels in
//     float32; q*sinh(x), q*cosh(x) for x < 1, else (e1 -/+ e2)/2 with both
//     exponents <= 0 on [0, pi], so nothing overflows;
//   * t < 1e-6: the ratio A/(2 sin(t/2)) takes its limit A'(0);
//     t == 0 takes the reference's patch constant;
//   * t < 1e-4: the score takes its analytic small-t limit.
//
// Bound on this card: 16 bytes of memory traffic per element (two f32 loads,
// two f32 stores) against ~80 f32 operations, so it is memory-bound: about
// 5 us per 1M elements at 3.35 TB/s.  On the sampling path it runs on B = 32
// elements per call, where the launch itself is the cost.  Measured by
// chip_smoke.py on an H100 80GB HBM3 at 700 W: 21 us at 2^20 elements (4x the
// byte bound: the accurate transcendentals make it instruction-heavy) and
// 2.5 us at 32 (the launch floor).  The design is the
// simplest that meets that bound: one grid-stride pass, one thread per
// element, coalesced loads and stores, no shared memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
//        -Xcompiler -fPIC.  No --use_fast_math: the approximate expf/sinf it
// selects break the small-t branches and the 1e-5 log-density gate.
// -fmad=false keeps every product and sum rounded on its own, as the plain
// version's one-op-per-kernel evaluation rounds them; near t = 1e-4 the score
// is a difference of two ~1/t terms, where one ulp of either is ~1e-3, about
// the score's absolute tolerance.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kHalfLogPi = 0.57236494292470008707f;  // 0.5 * log(pi)
constexpr float kTwoPi = 6.28318530717958647693f;       // 2 pi
constexpr float kFourPi = 12.5663706143591729539f;      // 4 pi
constexpr float kPiSq = 9.86960440108935861883f;        // pi^2
constexpr float kTwoPiSq = 19.7392088021787172377f;     // 2 pi^2
constexpr float kFourPiSq = 39.4784176043574344753f;    // 4 pi^2

__global__ void igso3_logpdf_score_kernel(const float* __restrict__ t_in,
                                          const float* __restrict__ sigma_in,
                                          float* __restrict__ logf_out,
                                          float* __restrict__ score_out,
                                          long long n) {
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float t = t_in[i];
    const float sigma = sigma_in[i];
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
    logf_out[i] = log_c + logf(ratio_c);

    // score: -t/(2 var) + A'/A - cot(t/2)/2, or its small-t limit
    const bool small_s = t < 1e-4f;
    const float ts = small_s ? 1.0f : t;
    const float direct =
        -t / (2.0f * var) + da / (small_s ? 1.0f : a) - 0.5f / tanf(ts / 2.0f);
    const float dd_a0 = -kTwoPi * qv / var;
    const float d_a0 = 1.0f + 2.0f * qv * (kTwoPiSq / var - 1.0f);
    const float limit = dd_a0 / (2.0f * d_a0) + t / 12.0f - t / (2.0f * var);
    score_out[i] = small_s ? limit : direct;
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream), does not synchronise, and
// returns cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int igso3_logpdf_score_launch(const void* t, const void* sigma,
                                         void* logf_out, void* score_out,
                                         long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long max_blocks = 132LL * 16;  // 16 blocks per SM, then stride
  if (blocks > max_blocks) blocks = max_blocks;
  igso3_logpdf_score_kernel<<<(unsigned int)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (const float*)t, (const float*)sigma, (float*)logf_out,
      (float*)score_out, n);
  return (int)cudaGetLastError();
}
