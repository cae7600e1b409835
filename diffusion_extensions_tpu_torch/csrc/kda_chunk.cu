// Kimi Delta Attention's chunked gated delta rule for Hopper (sm_90a), forward
// and backward, in float32 (diffusion_extensions_tpu_torch/ops/kda_cuda.py,
// called by models/kimi_linear.py chunk_kda):
//
//   per head, S (dk, dv) from 0, for t = 1 .. N:
//   S <- Diag(exp(g_t)) S;  S <- S + beta_t k_t (v_t - S^T k_t)^T;  o_t = S^T q_t
//
// Replaces no TPU kernel: the JAX package has no Kimi Linear trunk.  As
// PyTorch operations the chunked form ran ~280 kernels a mixer forward (the
// halving levels' cat / split / zeros / exp chain, 15 sequential baddbmm for
// the state), all again in the backward's recomputation, and autograd over
// them: float32 elementwise passes and copies over (B, H, N, 128) tensors.
//
// The chunked form (chunks of C = 64 points, G the in-chunk cumulative sum
// of g, G_L its last row, beta folded into A):
//
//   A[i, j] = beta_i sum_c k_ic k_jc e^(G_ic - G_jc)  (j < i)
//   P[i, j] = sum_c q_ic k_jc e^(G_ic - G_jc)          (j <= i)
//   (I + A) [W | U] = [beta k e^G | beta v]
//   v_new = U - W S;  o = (q e^G) S + P v_new;  S <- e^G_L S + (k e^(G_L - G))^T v_new
//
// Bound on this card: operations.  ~9 MFLOP a chunk and 128 dims forward
// (A and P, the substitution, W S, (q e^G) S, P v_new, the state's update),
// ~3x that backward, against 160 KB of float32 inputs and outputs a chunk.
//
// Design: every product in float32 on the FMA units (FFMA, fmaf); no TF32,
// no bf16.  Every exp takes a non-positive argument: a later-minus-earlier
// difference of G, directly within small diagonal blocks (16 points forward,
// 4 backward), and factored through a block boundary r above them
// (e^(G_i - G_r) e^(G_r - G_j), i > r >= j), the halving levels of 32 and
// 16 points forward, 32 ... 4 backward.  G is summed in float64 and kept as
// a float and a bf16 remainder, so each exp's argument is its difference
// to its own rounding (the plain chain's float32 G puts ~|G| 2^-24 into
// each, |G| up to ~1e3); P's diagonal q_i . k_i is summed in float64.
// Chunks past N are padded with q = k = v = g = beta = 0 (nothing added,
// nothing decayed).  Each block runs 256 threads; tiles go global -> shared
// by cp.async as they lie in memory, and products are register-tiled over
// them (k-major or row-major operands, 16-byte loads).  The substitutions
// take a column a thread, 16 rows at a time in registers.  No atomics,
// every sum in a fixed order: two calls give the same bits.
//
// Forward, two launches:
// * kda_intra: a block a (chunk, head, cloud).  G, A and P by the levels
//   above (one (64, 32) product a level), [W | U] by forward substitution;
//   writes W, U and P (and, for the backward, A / beta).
// * kda_state: a block a (dv tile, head, cloud), walking the chunks in
//   order with the state's tile in registers: v_new = U - W S and
//   (q e^G) S in one product, o = (q e^G) S + P v_new, then the state's
//   update; o is written in (B, N, H, dv).  The backward runs it again to
//   write each chunk's starting state and v_new instead of o.
// Backward, four launches: kda_intra again; kda_state (states, v_new);
// kda_state_backward, a block a (dv tile, head, cloud) walking the chunks in
// reverse with dS in registers (dv_new = P^T dO + K_D dS',
// dS = (q e^G)^T dO + e^G_L dS' - W^T dv_new; writes dS' and dv_new a chunk);
// kda_chunk_backward, a block a (chunk, head, cloud): dq, dk, dv, dg and
// dbeta of the chunk from S, dS', v_new, dv_new and the intra matrices (the
// transposed substitution (I + A)^T [d(beta v) | d(beta k e^G)] = [dv_new |
// dW], dA = -(d(beta v) U^T + d(beta k e^G) W^T), the levels' products
// transposed, and dg the reverse cumulative sum of dG).
//
// q, k, v, g are read in place as (B, H, N, d) views with any strides
// (unit stride last), beta as (B, H, N); o, dq, dk, dv, dg are written
// (B, N, H, d) and dbeta (B, N, H), contiguous.  Built for dk = dv = 128
// (Kimi-Linear-48B-A3B's heads) and 32 (the card tests' small trunk).
#include <cuda_runtime.h>

namespace {

constexpr int kC = 64;         // points a chunk
constexpr int kThreads = 256;  // threads a block, every kernel
constexpr int kLA = kC + 4;    // leading dim of a 64-wide tile in shared memory

struct Params {
  const float *q, *k, *v, *g, *beta, *dout;
  long long q_b, q_h, q_n, k_b, k_h, k_n, v_b, v_h, v_n, g_b, g_h, g_n, beta_b, beta_h, beta_n, do_b, do_h,
      do_n;
  int heads, n, chunks;
  float* o;                                  // (B, N, H, D)
  float *w, *u, *p, *abar;                   // a chunk: (64, D), (64, D), (64, 64), (64, 64)
  float *states, *vnew, *dstates, *dvnew;    // a chunk: (D, D), (64, D), (D, D), (64, D)
  float *dq, *dk, *dv, *dg, *dbeta;          // (B, N, H, D); dbeta (B, N, H)
};

__device__ __forceinline__ long long chunk_index(const Params& p, int b, int h, int c) {
  return (static_cast<long long>(b) * p.heads + h) * p.chunks + c;
}

// the (b, h, N, d) row t of a strided operand
__device__ __forceinline__ const float* row_of(const float* base, long long sb, long long sh, long long sn,
                                                int b, int h, int t) {
  return base + b * sb + h * sh + t * sn;
}

// row t of a (B, N, H, D) output
__device__ __forceinline__ long long out_row(const Params& p, int b, int h, int t, int d) {
  return ((static_cast<long long>(b) * p.n + t) * p.heads + h) * d;
}

// ---------------------------------------------------------------- tiles

// The i-th of a thread's TM rows (or columns) of an M-wide tile: TM
// consecutive from tile * TM, or for TM = 8 four at tile * 4 and four at
// M / 2 + tile * 4 (two 16-byte loads a k, spread over the banks).
template <int M, int TM>
__device__ __forceinline__ int frag(int tile, int i) {
  if constexpr (TM == 8) {
    return i < 4 ? tile * 4 + i : M / 2 + tile * 4 + i - 4;
  } else {
    return tile * TM + i;
  }
}

template <int M, int TM>
__device__ __forceinline__ void load_frag(float (&a)[TM], const float* row, int tile) {
  if constexpr (TM == 8) {
    const float4 x = *reinterpret_cast<const float4*>(row + tile * 4);
    const float4 y = *reinterpret_cast<const float4*>(row + M / 2 + tile * 4);
    a[0] = x.x; a[1] = x.y; a[2] = x.z; a[3] = x.w;
    a[4] = y.x; a[5] = y.y; a[6] = y.z; a[7] = y.w;
  } else if constexpr (TM == 4) {
    const float4 x = *reinterpret_cast<const float4*>(row + tile * 4);
    a[0] = x.x; a[1] = x.y; a[2] = x.z; a[3] = x.w;
  } else {
    static_assert(TM == 2, "fragments of 2, 4 or 8");
    const float2 x = *reinterpret_cast<const float2*>(row + tile * 2);
    a[0] = x.x; a[1] = x.y;
  }
}

// Every mapping of a tile onto the 256 threads: 16 row tiles x 16 column tiles.
__device__ __forceinline__ int tile_m() { return threadIdx.x / 16; }
__device__ __forceinline__ int tile_n() { return threadIdx.x % 16; }

// acc[i][j] += sum over kk < K of At[kk][row i] B[kk][col j]: an (M, N)
// product of two k-major operands in shared memory (leading dims lda, ldb,
// multiples of 4), the thread's TM x TN outputs in registers.
template <int M, int N, int TM, int TN>
__device__ __forceinline__ void gemm(float (&acc)[TM][TN], const float* At, int lda, const float* B, int ldb,
                                     int K) {
  static_assert(M / TM == 16 && N / TN == 16, "16 x 16 thread tiles");
  const int tm = tile_m(), tn = tile_n();
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float a[TM], b[TN];
    load_frag<M, TM>(a, At + kk * lda, tm);
    load_frag<N, TN>(b, B + kk * ldb, tn);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// acc[i][j] += sum over k < K of A[row i][k] B[k][col j]: A row major in k,
// B k-major (leading dims multiples of 4, K % 4 == 0); the thread's rows as
// gemm's.
template <int M, int N, int TM, int TN>
__device__ __forceinline__ void gemm_nn(float (&acc)[TM][TN], const float* A, int lda, const float* B, int ldb,
                                        int K) {
  static_assert(M / TM == 16 && N / TN == 16, "16 x 16 thread tiles");
  const int tm = tile_m(), tn = tile_n();
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[TM];
    float b[4][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(A + frag<M, TM>(tm, i) * lda + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) load_frag<N, TN>(b[u], B + (k + u) * ldb, tn);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] = fmaf(a[i].w, b[3][j], fmaf(a[i].z, b[2][j], fmaf(a[i].y, b[1][j], fmaf(a[i].x, b[0][j], acc[i][j]))));
    }
  }
}

// acc[i][j] += sum over k < K of A[row i][k] B[col j][k]: two operands row
// major in k (leading dims multiples of 4, K % 4 == 0), the thread's rows
// tile_m() * TM + i and columns tile_n() + 16 j.
template <int TM, int TN>
__device__ __forceinline__ void gemm_nt(float (&acc)[TM][TN], const float* A, int lda, const float* B, int ldb,
                                        int K) {
  const int tm = tile_m(), tn = tile_n();
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(A + (tm * TM + i) * lda + k);
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = *reinterpret_cast<const float4*>(B + (tn + 16 * j) * ldb + k);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] = fmaf(a[i].w, b[j].w, fmaf(a[i].z, b[j].z, fmaf(a[i].y, b[j].y, fmaf(a[i].x, b[j].x, acc[i][j]))));
    }
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
}

// 16 bytes global -> shared, asynchronously; zeros where !valid (no byte is
// read then, src any mapped address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0));
}
// every cp.async this thread issued has landed (a __syncthreads must follow
// before other threads read them)
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;\n" ::); }

// Rows [0, R) of W floats (W % 4 == 0) into shared memory as they are
// (dst[r * ld + c]), by cp.async: src(r) gives row r's start, or nullptr for a
// row of zeros (row 0 is never nullptr).  Complete at cp_async_wait().
template <int R, int W, typename Src>
__device__ __forceinline__ void load_async(float* dst, int ld, Src src) {
  constexpr int kVec = W / 4;
  const float* any = src(0);
  for (int f = threadIdx.x; f < R * kVec; f += kThreads) {
    const int r = f / kVec, c = (f % kVec) * 4;
    const float* s = src(r);
    cp_async16(dst + r * ld + c, s ? s + c : any, s != nullptr);
  }
}

// The in-chunk cumulative log-decays G of a chunk's 64 rows and D columns,
// summed in float64 and kept as a float hi and a bf16 lo (G = hi + lo to
// ~2^-33 of G): every decay is a difference of two of them, up to ~1e3 in
// magnitude at e^-20 a point, where one float would put ~1e-4 into each exp;
// hi + lo puts the difference's own rounding there instead.  Rows past the
// end hold g = 0.
struct Decays {
  float* hi;
  unsigned short* lo;  // bf16 bits
  int ld;

  __device__ __forceinline__ float lo_at(int r, int col) const {
    return __uint_as_float(static_cast<unsigned>(lo[r * ld + col]) << 16);
  }
  // G[a] - G[b] at column col
  __device__ __forceinline__ float diff(int a, int b, int col) const {
    return (hi[a * ld + col] - hi[b * ld + col]) + (lo_at(a, col) - lo_at(b, col));
  }
  // e^(G[a] - G[b]), a at or after b
  __device__ __forceinline__ float exp_diff(int a, int b, int col) const { return expf(diff(a, b, col)); }
  // e^G[r]
  __device__ __forceinline__ float exp_at(int r, int col) const {
    const float e = expf(hi[r * ld + col]);
    return fmaf(e, lo_at(r, col), e);
  }
};

// hi holds g (rows 0 .. 63); hi and lo become G.
template <int D>
__device__ __forceinline__ void cumsum_columns(const Decays& G) {
  for (int col = threadIdx.x; col < D; col += kThreads) {
    double s = 0.0;
    for (int r = 0; r < kC; ++r) {
      s += G.hi[r * G.ld + col];
      const float hi = static_cast<float>(s);
      unsigned u = __float_as_uint(static_cast<float>(s - hi));
      u += 0x7fffu + ((u >> 16) & 1u);  // to bf16, nearest even
      G.hi[r * G.ld + col] = hi;
      G.lo[r * G.ld + col] = static_cast<unsigned short>(u >> 16);
    }
  }
}

// The halving level of s points (32 down to 4) for row i: its half of the
// 2s-block (1: the later half), the block's start and the boundary r (the
// last point of the earlier half).
struct Level {
  int later, start, r;
};
__device__ __forceinline__ Level level_of(int i, int s) {
  const int start = (i / (2 * s)) * (2 * s);
  return {(i / s) % 2, start, start + s - 1};
}

// The pairs (i, j), j <= i, of the four 16-point diagonal blocks: 136 a
// block, numbered row by row.
constexpr int kPairs = 4 * 136;
struct Pair {
  int i, j;
};
__device__ __forceinline__ Pair diagonal_pair(int q) {
  const int t = q % 136;
  int ii = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  if ((ii + 1) * (ii + 2) / 2 <= t) ++ii;
  if (ii * (ii + 1) / 2 > t) --ii;
  const int s0 = (q / 136) * 16;
  return {s0 + ii, s0 + t - ii * (ii + 1) / 2};
}

// ---------------------------------------------------------------- forward: the intra-chunk pass

template <int D>
constexpr int intra_smem() {
  return (5 * kC * (D + 4) + 2 * kC * kLA + kC) * 4 + kC * (D + 4) * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads) kda_intra(const Params p) {
  extern __shared__ float4 kda_smem[];
  constexpr int LD = D + 4;
  float* Gs = reinterpret_cast<float*>(kda_smem);
  float* Qs = Gs + kC * LD;
  float* Ks = Qs + kC * LD;
  float* Kx = Ks + kC * LD;  // [2][64][D]: scratch of the diagonal blocks and the levels, then [W | U]
  float* As = Kx + 2 * kC * LD;  // A / beta, then A
  float* Ps = As + kC * kLA;
  float* bs = Ps + kC * kLA;
  const Decays G{Gs, reinterpret_cast<unsigned short*>(bs + kC), LD};
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int t0 = c * kC, rows = min(kC, p.n - t0);
  const long long ci = chunk_index(p, b, h, c);

  load_async<kC, D>(Qs, LD, [&](int r) { return r < rows ? row_of(p.q, p.q_b, p.q_h, p.q_n, b, h, t0 + r) : nullptr; });
  load_async<kC, D>(Ks, LD, [&](int r) { return r < rows ? row_of(p.k, p.k_b, p.k_h, p.k_n, b, h, t0 + r) : nullptr; });
  load_async<kC, D>(Gs, LD, [&](int r) { return r < rows ? row_of(p.g, p.g_b, p.g_h, p.g_n, b, h, t0 + r) : nullptr; });
  if (tid < kC) bs[tid] = tid < rows ? p.beta[b * p.beta_b + h * p.beta_h + (t0 + tid) * p.beta_n] : 0.f;
  for (int f = tid; f < kC * kLA; f += kThreads) As[f] = Ps[f] = 0.f;
  cp_async_wait();
  __syncthreads();
  cumsum_columns<D>(G);
  __syncthreads();

  // the 16-point diagonal blocks, each pair directly (one exp a pair and
  // dim): 544 pairs (j <= i) x 2 halves of the dims, four partial sums an
  // item, the halves added after
  {
    float* part = Kx;  // [2][1088]: P's and A's halves
    for (int e = tid; e < 2 * kPairs; e += kThreads) {
      const Pair pr = diagonal_pair(e / 2);
      const int c0 = (e % 2) * (D / 2);
      float sp[4] = {0.f, 0.f, 0.f, 0.f}, sa[4] = {0.f, 0.f, 0.f, 0.f};
      for (int col = c0; col < c0 + D / 2; col += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int cc = col + u;
          const float kj = Ks[pr.j * LD + cc] * G.exp_diff(pr.i, pr.j, cc);
          sp[u] = fmaf(Qs[pr.i * LD + cc], kj, sp[u]);
          sa[u] = fmaf(Ks[pr.i * LD + cc], kj, sa[u]);
        }
      }
      part[e] = (sp[0] + sp[1]) + (sp[2] + sp[3]);
      part[2 * kPairs + e] = (sa[0] + sa[1]) + (sa[2] + sa[3]);
    }
    __syncthreads();
    for (int q = tid; q < kPairs; q += kThreads) {
      const Pair pr = diagonal_pair(q);
      Ps[pr.i * kLA + pr.j] = part[2 * q] + part[2 * q + 1];
      if (pr.j < pr.i) As[pr.i * kLA + pr.j] = part[2 * kPairs + 2 * q] + part[2 * kPairs + 2 * q + 1];
    }
    __syncthreads();
    // P's diagonal, q_i . k_i (no decay), again in float64: where the decays
    // are strong it is most of o
    if (tid < kC) {
      double sd = 0.0;
      for (int col = 0; col < D; ++col) sd = fma(static_cast<double>(Qs[tid * LD + col]), static_cast<double>(Ks[tid * LD + col]), sd);
      Ps[tid * kLA + tid] = static_cast<float>(sd);
    }
    __syncthreads();
  }
  // the levels: 32 (rows 32-63 against 0-31), then 16 (16-31 against 0-15,
  // 48-63 against 32-47), through each block's boundary, each one (64, 32)
  // product: the later halves' 32 rows of q and k scaled to their boundary
  // against the earlier halves' 32 rows of k scaled from it (at 16, the
  // cross pairs of the two blocks are computed and dropped)
  {
    float* Lt = Kx;            // [D][64]: (q e^(G - G_r))^T | (k e^(G - G_r))^T, later rows
    float* Et = Lt + D * kLA;  // [D][32]: (k e^(G_r - G))^T, earlier rows
    constexpr int kLE = 32 + 4;
    for (int s = 32; s >= 16; s /= 2) {
      for (int f = tid; f < kC * D; f += kThreads) {  // a warp: 16 rows x 2 columns
        const int i = (f / 32) % (kC / 16) * 16 + f % 16, col = f / 32 / (kC / 16) * 2 + f % 32 / 16;
        const Level lv = level_of(i, s);
        const int m = (i / (2 * s)) * s + i % s;  // the row's place among its halves' 32
        if (lv.later) {
          const float x = G.exp_diff(i, lv.r, col);
          Lt[col * kLA + m] = Qs[i * LD + col] * x;
          Lt[col * kLA + 32 + m] = Ks[i * LD + col] * x;
        } else {
          Et[col * kLE + m] = Ks[i * LD + col] * G.exp_diff(lv.r, i, col);
        }
      }
      __syncthreads();
      float acc[4][2];
      zero(acc);
      gemm<kC, 32, 4, 2>(acc, Lt, kLA, Et, kLE, D);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int m = tile_m() * 4 + ii, mr = m % 32;
        const int i = (mr / s) * 2 * s + s + mr % s;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int n = tile_n() * 2 + jj, j = (n / s) * 2 * s + n % s;
          if (mr / s == n / s) (m < 32 ? Ps : As)[i * kLA + j] = acc[ii][jj];
        }
      }
      __syncthreads();
    }
  }

  // P and A / beta out; A = beta A / beta in place
  for (int f = tid; f < kC * kC; f += kThreads) {
    const int i = f / kC, j = f % kC;
    p.p[ci * kC * kC + f] = Ps[i * kLA + j];
    if (p.abar) p.abar[ci * kC * kC + f] = As[i * kLA + j];
  }
  __syncthreads();
  for (int f = tid; f < kC * kC; f += kThreads) As[(f / kC) * kLA + f % kC] *= bs[f / kC];
  __syncthreads();

  // (I + A) [W | U] = [beta k e^G | beta v], a column a thread, in blocks of
  // 16 rows: a block's right-hand sides less the solved rows' terms, then
  // the block's own triangle, row by row
  float* Vs = Qs;  // [64][D]: v (q is read no more)
  float* Xs = Kx;  // [64][2D]: [W | U]
  load_async<kC, D>(Vs, LD, [&](int r) { return r < rows ? row_of(p.v, p.v_b, p.v_h, p.v_n, b, h, t0 + r) : nullptr; });
  cp_async_wait();
  __syncthreads();
  if (tid < 2 * D) {
    const int col = tid % D;
    const bool is_w = tid < D;
    float* out = (is_w ? p.w : p.u) + ci * kC * D + col;
#pragma unroll 1
    for (int blk = 0; blk < kC / 16; ++blk) {
      const int i0 = 16 * blk;
      float acc[16];
#pragma unroll
      for (int ii = 0; ii < 16; ++ii) {
        const int i = i0 + ii;
        acc[ii] = is_w ? bs[i] * Ks[i * LD + col] * G.exp_at(i, col) : bs[i] * Vs[i * LD + col];
      }
      for (int j = 0; j < i0; j += 4) {
        const float x0 = Xs[j * 2 * D + tid], x1 = Xs[(j + 1) * 2 * D + tid];
        const float x2 = Xs[(j + 2) * 2 * D + tid], x3 = Xs[(j + 3) * 2 * D + tid];
#pragma unroll
        for (int ii = 0; ii < 16; ++ii) {
          const float4 a4 = *reinterpret_cast<const float4*>(As + (i0 + ii) * kLA + j);
          acc[ii] = fmaf(-a4.w, x3, fmaf(-a4.z, x2, fmaf(-a4.y, x1, fmaf(-a4.x, x0, acc[ii]))));
        }
      }
#pragma unroll
      for (int ii = 0; ii < 16; ++ii) {
        const float* a = As + (i0 + ii) * kLA + i0;
#pragma unroll
        for (int jj = 0; jj < ii; ++jj) acc[ii] = fmaf(-a[jj], acc[jj], acc[ii]);
        Xs[(i0 + ii) * 2 * D + tid] = acc[ii];
        out[(i0 + ii) * D] = acc[ii];
      }
    }
  }
}

// ---------------------------------------------------------------- the state pass

template <int D, int DVT>
constexpr int state_smem() {
  return (4 * kC * (D + 4) + kC * kLA + D * (DVT + 4) + kC * (DVT + 4) + D) * 4 + kC * (D + 4) * 2;
}

// kStates false: o.  kStates true (the backward): each chunk's starting
// state and v_new, no o.
template <int D, int DVT, bool kStates>
__global__ void __launch_bounds__(kThreads) kda_state(const Params p) {
  extern __shared__ float4 kda_smem[];
  constexpr int LD = D + 4, LV = DVT + 4, TMS = D / 16, TNV = DVT / 16;
  float* QW = reinterpret_cast<float*>(kda_smem);  // [128][D]: q e^G, then W
  float* KD = QW + 2 * kC * LD;                     // [64][D]: k e^(G_L - G)
  float* Ps = KD + kC * LD;                         // [64][64]: P
  float* Ss = Ps + kC * kLA;                        // [D][DVT]: the state's tile
  float* Vn = Ss + D * LV;                          // [64][DVT]: v_new
  float* Gs = Vn + kC * LV;                         // [64][D]: G's hi
  float* eL = Gs + kC * LD;                         // [D]: e^G_L
  const Decays G{Gs, reinterpret_cast<unsigned short*>(eL + D), LD};
  const int n0 = blockIdx.x * DVT, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int tm = tile_m(), tn = tile_n();

  float S[TMS][TNV];
  zero(S);
  for (int f = tid; f < D * LV; f += kThreads) Ss[f] = 0.f;

  for (int c = 0; c < p.chunks; ++c) {
    const int t0 = c * kC, rows = min(kC, p.n - t0);
    const long long ci = chunk_index(p, b, h, c);
    if constexpr (kStates) {
#pragma unroll
      for (int i = 0; i < TMS; ++i) {
#pragma unroll
        for (int j = 0; j < TNV; ++j)
          p.states[ci * D * D + frag<D, TMS>(tm, i) * D + n0 + frag<DVT, TNV>(tn, j)] = S[i][j];
      }
    }
    const float* wc = p.w + ci * kC * D;
    const float* pc = p.p + ci * kC * kC;
    load_async<kC, D>(QW, LD, [&](int r) { return r < rows ? row_of(p.q, p.q_b, p.q_h, p.q_n, b, h, t0 + r) : nullptr; });
    load_async<kC, D>(QW + kC * LD, LD, [&](int r) { return wc + r * D; });
    load_async<kC, D>(KD, LD, [&](int r) { return r < rows ? row_of(p.k, p.k_b, p.k_h, p.k_n, b, h, t0 + r) : nullptr; });
    load_async<kC, D>(Gs, LD, [&](int r) { return r < rows ? row_of(p.g, p.g_b, p.g_h, p.g_n, b, h, t0 + r) : nullptr; });
    if constexpr (!kStates) load_async<kC, kC>(Ps, kLA, [&](int r) { return pc + r * kC; });
    cp_async_wait();
    __syncthreads();
    cumsum_columns<D>(G);
    __syncthreads();
    // q e^G and k e^(G_L - G) in place
    for (int f = tid; f < kC * D; f += kThreads) {
      const int r = f / D, col = f % D;
      QW[r * LD + col] *= G.exp_at(r, col);
      KD[r * LD + col] *= G.exp_diff(kC - 1, r, col);
      if (r == 0) eL[col] = G.exp_at(kC - 1, col);
    }
    __syncthreads();

    // [(q e^G); W] S: rows 0-63 (q e^G) S, rows 64-127 W S
    float acc[8][TNV];
    zero(acc);
    gemm_nn<2 * kC, DVT, 8, TNV>(acc, QW, LD, Ss, LV, D);
    const float* uc = p.u + ci * kC * D;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tm * 4 + i;
#pragma unroll
      for (int j = 0; j < TNV; ++j) {
        const int col = frag<DVT, TNV>(tn, j);
        const float vn = uc[r * D + n0 + col] - acc[4 + i][j];
        Vn[r * LV + col] = vn;
        if constexpr (kStates) p.vnew[ci * kC * D + r * D + n0 + col] = vn;
      }
    }
    __syncthreads();

    if constexpr (!kStates) {
      // o = (q e^G) S + P v_new
      float o[4][TNV];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < TNV; ++j) o[i][j] = acc[i][j];
      }
      gemm_nn<kC, DVT, 4, TNV>(o, Ps, kLA, Vn, LV, kC);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tm * 4 + i;
        if (r < rows) {
          float* dst = p.o + out_row(p, b, h, t0 + r, D) + n0;
#pragma unroll
          for (int j = 0; j < TNV; ++j) dst[frag<DVT, TNV>(tn, j)] = o[i][j];
        }
      }
    }
    // S <- e^G_L S + (k e^(G_L - G))^T v_new
#pragma unroll
    for (int i = 0; i < TMS; ++i) {
      const float e = eL[frag<D, TMS>(tm, i)];
#pragma unroll
      for (int j = 0; j < TNV; ++j) S[i][j] *= e;
    }
    gemm<D, DVT, TMS, TNV>(S, KD, LD, Vn, LV, kC);
#pragma unroll
    for (int i = 0; i < TMS; ++i) {
#pragma unroll
      for (int j = 0; j < TNV; ++j) Ss[frag<D, TMS>(tm, i) * LV + frag<DVT, TNV>(tn, j)] = S[i][j];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- backward: the reverse state pass

template <int D, int DVT>
constexpr int state_backward_smem() {
  return (kC * kLA + 4 * kC * (D + 4) + 2 * kC * (DVT + 4) + D * (DVT + 4) + D) * 4;
}

template <int D, int DVT>
__global__ void __launch_bounds__(kThreads) kda_state_backward(const Params p) {
  extern __shared__ float4 kda_smem[];
  constexpr int LD = D + 4, LV = DVT + 4, TMS = D / 16, TNV = DVT / 16;
  float* Ps = reinterpret_cast<float*>(kda_smem);  // [64][64]: P
  float* KD = Ps + kC * kLA;                        // [64][D]: k e^(G_L - G)
  float* QG = KD + kC * LD;                         // [64][D]: q e^G
  float* Wn = QG + kC * LD;                         // [64][D]: W
  float* Gs = Wn + kC * LD;                         // [64][D]: G's hi
  float* dOs = Gs + kC * LD;                        // [64][DVT]: dO
  float* dVs = dOs + kC * LV;                       // [64][DVT]: -dv_new (G's lo before it)
  float* dSs = dVs + kC * LV;                       // [D][DVT]: dS'
  float* eL = dSs + D * LV;                         // [D]
  static_assert(kC * (D + 4) * 2 <= kC * LV * 4, "G's lo fits where -dv_new goes");
  const Decays G{Gs, reinterpret_cast<unsigned short*>(dVs), LD};
  const int n0 = blockIdx.x * DVT, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int tm = tile_m(), tn = tile_n();

  float dS[TMS][TNV];
  zero(dS);
  for (int f = tid; f < D * LV; f += kThreads) dSs[f] = 0.f;

  for (int c = p.chunks - 1; c >= 0; --c) {
    const int t0 = c * kC, rows = min(kC, p.n - t0);
    const long long ci = chunk_index(p, b, h, c);
#pragma unroll
    for (int i = 0; i < TMS; ++i) {
#pragma unroll
      for (int j = 0; j < TNV; ++j)
        p.dstates[ci * D * D + frag<D, TMS>(tm, i) * D + n0 + frag<DVT, TNV>(tn, j)] = dS[i][j];
    }
    const float* wc = p.w + ci * kC * D;
    const float* pc = p.p + ci * kC * kC;
    load_async<kC, kC>(Ps, kLA, [&](int r) { return pc + r * kC; });
    load_async<kC, DVT>(dOs, LV, [&](int r) {
      return r < rows ? row_of(p.dout, p.do_b, p.do_h, p.do_n, b, h, t0 + r) + n0 : nullptr;
    });
    load_async<kC, D>(QG, LD, [&](int r) { return r < rows ? row_of(p.q, p.q_b, p.q_h, p.q_n, b, h, t0 + r) : nullptr; });
    load_async<kC, D>(KD, LD, [&](int r) { return r < rows ? row_of(p.k, p.k_b, p.k_h, p.k_n, b, h, t0 + r) : nullptr; });
    load_async<kC, D>(Gs, LD, [&](int r) { return r < rows ? row_of(p.g, p.g_b, p.g_h, p.g_n, b, h, t0 + r) : nullptr; });
    load_async<kC, D>(Wn, LD, [&](int r) { return wc + r * D; });
    cp_async_wait();
    __syncthreads();
    cumsum_columns<D>(G);
    __syncthreads();
    // q e^G and k e^(G_L - G) in place
    for (int f = tid; f < kC * D; f += kThreads) {
      const int r = f / D, col = f % D;
      QG[r * LD + col] *= G.exp_at(r, col);
      KD[r * LD + col] *= G.exp_diff(kC - 1, r, col);
      if (r == 0) eL[col] = G.exp_at(kC - 1, col);
    }
    __syncthreads();

    // dv_new = P^T dO + K_D dS'
    float dv[4][TNV];
    zero(dv);
    gemm<kC, DVT, 4, TNV>(dv, Ps, kLA, dOs, LV, kC);
    gemm_nn<kC, DVT, 4, TNV>(dv, KD, LD, dSs, LV, D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tm * 4 + i;
#pragma unroll
      for (int j = 0; j < TNV; ++j) {
        const int col = frag<DVT, TNV>(tn, j);
        p.dvnew[ci * kC * D + r * D + n0 + col] = dv[i][j];
      }
    }
    __syncthreads();  // G is read no more: -dv_new goes over its lo
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < TNV; ++j) dVs[(tm * 4 + i) * LV + frag<DVT, TNV>(tn, j)] = -dv[i][j];
    }
    __syncthreads();

    // dS <- e^G_L dS' + (q e^G)^T dO - W^T dv_new
#pragma unroll
    for (int i = 0; i < TMS; ++i) {
      const float e = eL[frag<D, TMS>(tm, i)];
#pragma unroll
      for (int j = 0; j < TNV; ++j) dS[i][j] *= e;
    }
    gemm<D, DVT, TMS, TNV>(dS, QG, LD, dOs, LV, kC);
    gemm<D, DVT, TMS, TNV>(dS, Wn, LD, dVs, LV, kC);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TMS; ++i) {
#pragma unroll
      for (int j = 0; j < TNV; ++j) dSs[frag<D, TMS>(tm, i) * LV + frag<DVT, TNV>(tn, j)] = dS[i][j];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- backward: a chunk's gradients

template <int D>
__host__ __device__ constexpr int chunk_backward_phase() {  // floats of the largest phase
  constexpr int LD = D + 4, LY = 2 * D + 4;
  constexpr int rs = kC * LD + D * LD;             // 1 and 4: dv_new or dO, and S
  constexpr int y = kC * LY;
  constexpr int yz = y + (kC * LD > kC * kLA ? kC * LD : kC * kLA);  // 2 and 3: Y, then A^T or U / W
  constexpr int qkx = 3 * kC * LD;                 // 5 and 6: dO and v_new; q, Kx and Qx
  constexpr int vs = kC * LD + D * LD + 16 * D;    // 7: v_new, dS' and the column sums
  constexpr int a = rs > yz ? rs : yz, bb = qkx > vs ? qkx : vs;
  return a > bb ? a : bb;
}

template <int D>
constexpr int chunk_backward_smem() {
  return (2 * kC * (D + 4) + 2 * kC * kLA + kC + 2 * D + chunk_backward_phase<D>()) * 4 + kC * (D + 4) * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) kda_chunk_backward(const Params p) {
  extern __shared__ float4 kda_smem[];
  constexpr int LD = D + 4, LY = 2 * D + 4, TN = D / 16;
  // for the whole kernel
  float* Gs = reinterpret_cast<float*>(kda_smem);  // [64][D]: G
  float* Ks = Gs + kC * LD;                         // [64][D]: k
  float* dPs = Ks + kC * LD;                        // [64][64]: dP (j <= i)
  float* dAs = dPs + kC * kLA;                      // [64][64]: d(A / beta) (j < i)
  float* bs = dAs + kC * kLA;                       // [64]: beta
  float* deL = bs + kC;                             // [D]: d e^G_L
  float* dGl = deL + D;                             // [D]: dG_L
  float* ph = dGl + D;                              // the phases' region
  const Decays G{Gs, reinterpret_cast<unsigned short*>(ph + chunk_backward_phase<D>()), LD};
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int tm = tile_m(), tn = tile_n();
  const int t0 = c * kC, rows = min(kC, p.n - t0);
  const long long ci = chunk_index(p, b, h, c);
  const float* Sc = p.states + ci * D * D;
  const float* dSc = p.dstates + ci * D * D;
  const float* vnc = p.vnew + ci * kC * D;
  const float* dvnc = p.dvnew + ci * kC * D;
  auto dout_row = [&](int r) { return r < rows ? row_of(p.dout, p.do_b, p.do_h, p.do_n, b, h, t0 + r) : nullptr; };

  // the thread's outputs: rows tm * 4 + i, columns tn + 16 j
  float dq[4][TN], dk[4][TN], dG[4][TN], dbeta[4] = {0.f, 0.f, 0.f, 0.f};
  zero(dq);
  zero(dk);
  zero(dG);

  load_async<kC, D>(Ks, LD, [&](int r) { return r < rows ? row_of(p.k, p.k_b, p.k_h, p.k_n, b, h, t0 + r) : nullptr; });
  load_async<kC, D>(Gs, LD, [&](int r) { return r < rows ? row_of(p.g, p.g_b, p.g_h, p.g_n, b, h, t0 + r) : nullptr; });
  // 1. dW = -dv_new S^T
  float* Rn = ph;             // [64][D]: dv_new, later dO
  float* Sn = ph + kC * LD;   // [D][D]: S
  load_async<kC, D>(Rn, LD, [&](int r) { return dvnc + r * D; });
  load_async<D, D>(Sn, LD, [&](int r) { return Sc + r * D; });
  if (tid < kC) bs[tid] = tid < rows ? p.beta[b * p.beta_b + h * p.beta_h + (t0 + tid) * p.beta_n] : 0.f;
  cp_async_wait();
  __syncthreads();
  cumsum_columns<D>(G);
  float vs[4][TN];  // dv_new S^T = -dW
  zero(vs);
  gemm_nt<4, TN>(vs, Rn, LD, Sn, LD, D);
  __syncthreads();

  // 2. (I + A)^T X = Y, Y = [dv_new | dW], X = [d(beta v) | d(beta k e^G)]
  float* Y = ph;              // [64][2D]: Y, then X
  float* Ats = ph + kC * LY;  // [64][64]: A^T
  load_async<kC, D>(Y, LY, [&](int r) { return dvnc + r * D; });
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) Y[(tm * 4 + i) * LY + D + tn + 16 * j] = -vs[i][j];
  }
  {
    const float* ac = p.abar + ci * kC * kC;
    for (int f = tid; f < kC * kC / 4; f += kThreads) {  // a warp: 16 rows x 2 vectors
      const int r = (f / 32) % (kC / 16) * 16 + f % 16, c4 = (f / 32 / (kC / 16) * 2 + f % 32 / 16) * 4;
      float4 a = *reinterpret_cast<const float4*>(ac + r * kC + c4);
      const float be = bs[r];
      Ats[c4 * kLA + r] = a.x * be;
      Ats[(c4 + 1) * kLA + r] = a.y * be;
      Ats[(c4 + 2) * kLA + r] = a.z * be;
      Ats[(c4 + 3) * kLA + r] = a.w * be;
    }
  }
  cp_async_wait();
  __syncthreads();
  // a column a thread, in blocks of 16 rows from the last: a block's Y less
  // the solved rows' terms, then the block's own triangle from its last row;
  // X over Y
  if (tid < 2 * D) {
#pragma unroll 1
    for (int blk = kC / 16 - 1; blk >= 0; --blk) {
      const int i0 = 16 * blk;
      float acc[16];
#pragma unroll
      for (int ii = 0; ii < 16; ++ii) acc[ii] = Y[(i0 + ii) * LY + tid];
      for (int j = i0 + 16; j < kC; j += 4) {
        const float x0 = Y[j * LY + tid], x1 = Y[(j + 1) * LY + tid];
        const float x2 = Y[(j + 2) * LY + tid], x3 = Y[(j + 3) * LY + tid];
#pragma unroll
        for (int ii = 0; ii < 16; ++ii) {
          const float4 a4 = *reinterpret_cast<const float4*>(Ats + (i0 + ii) * kLA + j);
          acc[ii] = fmaf(-a4.w, x3, fmaf(-a4.z, x2, fmaf(-a4.y, x1, fmaf(-a4.x, x0, acc[ii]))));
        }
      }
#pragma unroll
      for (int ii = 15; ii >= 0; --ii) {
        const float* a = Ats + (i0 + ii) * kLA + i0;
#pragma unroll
        for (int jj = ii + 1; jj < 16; ++jj) acc[ii] = fmaf(-a[jj], acc[jj], acc[ii]);
        Y[(i0 + ii) * LY + tid] = acc[ii];
      }
    }
  }
  __syncthreads();
  const float* X = Y;  // [64][2D]
  // dv = beta d(beta v); d(beta k e^G) into dk and dG; dbeta's row terms
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tm * 4 + i;
    const float* vr = r < rows ? row_of(p.v, p.v_b, p.v_h, p.v_n, b, h, t0 + r) : nullptr;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = tn + 16 * j;
      const float xv = X[r * LY + col], xk = X[r * LY + D + col];
      const float e = G.exp_at(r, col), kg = Ks[r * LD + col] * e;
      if (vr) {
        p.dv[out_row(p, b, h, t0 + r, D) + col] = bs[r] * xv;
        dbeta[i] = fmaf(xv, vr[col], dbeta[i]);
      }
      dbeta[i] = fmaf(xk, kg, dbeta[i]);
      const float dkg = bs[r] * xk;
      dk[i][j] = fmaf(dkg, e, dk[i][j]);
      dG[i][j] = fmaf(dkg, kg, dG[i][j]);
    }
  }

  // 3. dA = -(d(beta v) U^T + d(beta k e^G) W^T), j < i; d(A / beta) = beta dA
  {
    float* Zs = ph + kC * LY;  // [64][D]: U, then W
    float acc[4][4];
    zero(acc);
    load_async<kC, D>(Zs, LD, [&](int r) { return p.u + ci * kC * D + r * D; });
    cp_async_wait();
    __syncthreads();
    gemm_nt<4, 4>(acc, X, LY, Zs, LD, D);
    __syncthreads();
    load_async<kC, D>(Zs, LD, [&](int r) { return p.w + ci * kC * D + r * D; });
    cp_async_wait();
    __syncthreads();
    gemm_nt<4, 4>(acc, X + D, LY, Zs, LD, D);
    const float* ac = p.abar + ci * kC * kC;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tm * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tn + 16 * j;
        const float da = col < r ? -acc[i][j] : 0.f;
        dbeta[i] = fmaf(da, ac[r * kC + col], dbeta[i]);
        dAs[r * kLA + col] = bs[r] * da;
      }
    }
  }
  __syncthreads();

  // 4. d(q e^G) = dO S^T, into dq and dG
  load_async<kC, D>(Rn, LD, dout_row);
  load_async<D, D>(Sn, LD, [&](int r) { return Sc + r * D; });
  cp_async_wait();
  __syncthreads();
  {
    float acc[4][TN];
    zero(acc);
    gemm_nt<4, TN>(acc, Rn, LD, Sn, LD, D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tm * 4 + i;
      const float* qr = r < rows ? row_of(p.q, p.q_b, p.q_h, p.q_n, b, h, t0 + r) : nullptr;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = tn + 16 * j;
        const float e = G.exp_at(r, col), qv = qr ? qr[col] : 0.f;
        dq[i][j] = fmaf(acc[i][j], e, dq[i][j]);
        dG[i][j] = fmaf(acc[i][j], qv * e, dG[i][j]);
      }
    }
  }
  __syncthreads();

  // 5. dP = dO v_new^T, j <= i
  {
    float* On = ph;              // [64][D]: dO
    float* Vn = ph + kC * LD;    // [64][D]: v_new
    load_async<kC, D>(On, LD, dout_row);
    load_async<kC, D>(Vn, LD, [&](int r) { return vnc + r * D; });
    cp_async_wait();
    __syncthreads();
    float acc[4][4], acc2[4][4];  // the two halves of the dims apart: half the chain
    zero(acc);
    zero(acc2);
    gemm_nt<4, 4>(acc, On, LD, Vn, LD, D / 2);
    gemm_nt<4, 4>(acc2, On + D / 2, LD, Vn + D / 2, LD, D / 2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tm * 4 + i, col = tn + 16 * j;
        dPs[r * kLA + col] = col <= r ? acc[i][j] + acc2[i][j] : 0.f;
      }
    }
  }
  __syncthreads();

  // 6. through P and A / beta into dq, dk and dG: the 4-point diagonal
  //    blocks directly, then the levels 32 ... 4 through their boundaries
  float* Qs = ph;               // [64][D]: q
  float* Kx = Qs + kC * LD;     // [64][D]: k scaled to the level's boundary
  float* Qx = Kx + kC * LD;     // [64][D]: q scaled to it (later halves)
  load_async<kC, D>(Qs, LD, [&](int r) { return r < rows ? row_of(p.q, p.q_b, p.q_h, p.q_n, b, h, t0 + r) : nullptr; });
  cp_async_wait();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tm * 4 + i, s0 = (r / 4) * 4;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = tn + 16 * j;
      const float qi = Qs[r * LD + col], ki = Ks[r * LD + col];
      float tq = 0.f, tk = 0.f, tc = 0.f;
      for (int m = s0; m < r; ++m) {  // row terms: pairs (r, m), m < r
        const float km = Ks[m * LD + col] * G.exp_diff(r, m, col);
        tq = fmaf(dPs[r * kLA + m], km, tq);
        tk = fmaf(dAs[r * kLA + m], km, tk);
      }
      for (int m = r + 1; m < s0 + 4; ++m) {  // column terms: pairs (m, r), m > r
        const float e = G.exp_diff(m, r, col);
        tc = fmaf(fmaf(dAs[m * kLA + r], Ks[m * LD + col], dPs[m * kLA + r] * Qs[m * LD + col]), e, tc);
      }
      // the pair (r, r) takes no decay: nothing into dG
      const float dpr = dPs[r * kLA + r];
      dq[i][j] += fmaf(dpr, ki, tq);
      dk[i][j] += fmaf(dpr, qi, tk + tc);
      dG[i][j] += qi * tq + ki * tk - ki * tc;
    }
  }
  for (int s = 32; s >= 4; s /= 2) {
    __syncthreads();  // the previous level's reads of Kx, Qx are done
    const Level lv = level_of(tm * 4, s);
    float own[4][TN];  // the boundary factors of the thread's elements
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tm * 4 + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = tn + 16 * j;
        own[i][j] = lv.later ? G.exp_diff(r, lv.r, col) : G.exp_diff(lv.r, r, col);
        Kx[r * LD + col] = Ks[r * LD + col] * own[i][j];
        if (lv.later) Qx[r * LD + col] = Qs[r * LD + col] * own[i][j];
      }
    }
    __syncthreads();
    if (lv.later) {  // rows of the later half against the earlier half's columns: P's, then A's
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        const float* dX = pass ? dAs : dPs;
        float t[4][TN];
        zero(t);
        for (int m = lv.start; m < lv.start + s; ++m) {
          float kx[TN];
#pragma unroll
          for (int j = 0; j < TN; ++j) kx[j] = Kx[m * LD + tn + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float dx = dX[(tm * 4 + i) * kLA + m];
#pragma unroll
            for (int j = 0; j < TN; ++j) t[i][j] = fmaf(dx, kx[j], t[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = tm * 4 + i;
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int col = tn + 16 * j;  // dG takes t k e or t q e: Kx or Qx
            if (pass) {
              dk[i][j] = fmaf(t[i][j], own[i][j], dk[i][j]);
              dG[i][j] = fmaf(t[i][j], Kx[r * LD + col], dG[i][j]);
            } else {
              dq[i][j] = fmaf(t[i][j], own[i][j], dq[i][j]);
              dG[i][j] = fmaf(t[i][j], Qx[r * LD + col], dG[i][j]);
            }
          }
        }
      }
    } else {  // columns of the earlier half against the later half's rows
      float tc[4][TN];
      zero(tc);
      for (int m = lv.start + s; m < lv.start + 2 * s; ++m) {
        float kx[TN], qx[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          kx[j] = Kx[m * LD + tn + 16 * j];
          qx[j] = Qx[m * LD + tn + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = tm * 4 + i;
          const float da = dAs[m * kLA + r], dp = dPs[m * kLA + r];
#pragma unroll
          for (int j = 0; j < TN; ++j) tc[i][j] = fmaf(da, kx[j], fmaf(dp, qx[j], tc[i][j]));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tm * 4 + i;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = tn + 16 * j;
          dk[i][j] = fmaf(tc[i][j], own[i][j], dk[i][j]);
          dG[i][j] = fmaf(-tc[i][j], Kx[r * LD + col], dG[i][j]);
        }
      }
    }
  }
  __syncthreads();

  // 7. d(k e^(G_L - G)) = v_new dS'^T, and d e^G_L = rowsum(S o dS')
  {
    float* Vn = ph;                // [64][D]: v_new
    float* dSn = ph + kC * LD;     // [D][D]: dS'
    float* red = dSn + D * LD;     // [16][D]
    load_async<kC, D>(Vn, LD, [&](int r) { return vnc + r * D; });
    load_async<D, D>(dSn, LD, [&](int r) { return dSc + r * D; });
    cp_async_wait();
    __syncthreads();
    constexpr int kLanes = D / 4;  // threads a row of dS'
    for (int f = tid; f < D * kLanes; f += kThreads) {
      const int r = f / kLanes, c4 = (f % kLanes) * 4;
      const float4 x = *reinterpret_cast<const float4*>(dSn + r * LD + c4);
      const float4 s = *reinterpret_cast<const float4*>(Sc + r * D + c4);
      float part = x.x * s.x + x.y * s.y + x.z * s.z + x.w * s.w;
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (f % kLanes == 0) deL[r] = part;
    }
    __syncthreads();
    float acc[4][TN];
    zero(acc);
    gemm_nt<4, TN>(acc, Vn, LD, dSn, LD, D);
    float colsum[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) colsum[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tm * 4 + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = tn + 16 * j;
        const float e = G.exp_diff(kC - 1, r, col);
        const float kd = Ks[r * LD + col] * e;
        dk[i][j] = fmaf(acc[i][j], e, dk[i][j]);
        dG[i][j] = fmaf(-acc[i][j], kd, dG[i][j]);
        colsum[j] = fmaf(acc[i][j], kd, colsum[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) red[tm * D + tn + 16 * j] = colsum[j];
    __syncthreads();
    if (tid < D) {
      float s = 0.f;
      for (int m = 0; m < 16; ++m) s += red[m * D + tid];
      dGl[tid] = fmaf(deL[tid], G.exp_at(kC - 1, tid), s);
    }
  }

  // 8. dq, dk and dbeta out; dg, the reverse cumulative sum of dG
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off /= 2) dbeta[i] += __shfl_xor_sync(0xffffffffu, dbeta[i], off);
  }
  __syncthreads();
  float* dGt = ph;  // [64][D]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tm * 4 + i;
    const bool in = r < rows;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = tn + 16 * j;
      dGt[r * LD + col] = dG[i][j];
      if (in) {
        const long long o = out_row(p, b, h, t0 + r, D) + col;
        p.dq[o] = dq[i][j];
        p.dk[o] = dk[i][j];
      }
    }
    if (tn == 0 && in) p.dbeta[(static_cast<long long>(b) * p.n + t0 + r) * p.heads + h] = dbeta[i];
  }
  __syncthreads();
  if (tid < D) {
    float s = dGl[tid];
    for (int r = kC - 1; r >= 0; --r) {
      s += dGt[r * LD + tid];
      if (r < rows) p.dg[out_row(p, b, h, t0 + r, D) + tid] = s;
    }
  }
}

// ---------------------------------------------------------------- launches

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int D>
int forward(const Params& p, int batch, cudaStream_t s) {
  constexpr int DVT = D == 128 ? 64 : D;
  int err = set_smem(kda_intra<D>, intra_smem<D>());
  if (err) return err;
  err = set_smem(kda_state<D, DVT, false>, state_smem<D, DVT>());
  if (err) return err;
  kda_intra<D><<<dim3(p.chunks, p.heads, batch), kThreads, intra_smem<D>(), s>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  kda_state<D, DVT, false><<<dim3(D / DVT, p.heads, batch), kThreads, state_smem<D, DVT>(), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int backward(const Params& p, int batch, cudaStream_t s) {
  constexpr int DVT = D == 128 ? 64 : D;
  int err = set_smem(kda_intra<D>, intra_smem<D>());
  if (!err) err = set_smem(kda_state<D, DVT, true>, state_smem<D, DVT>());
  if (!err) err = set_smem(kda_state_backward<D, DVT>, state_backward_smem<D, DVT>());
  if (!err) err = set_smem(kda_chunk_backward<D>, chunk_backward_smem<D>());
  if (err) return err;
  kda_intra<D><<<dim3(p.chunks, p.heads, batch), kThreads, intra_smem<D>(), s>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  kda_state<D, DVT, true><<<dim3(D / DVT, p.heads, batch), kThreads, state_smem<D, DVT>(), s>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  kda_state_backward<D, DVT><<<dim3(D / DVT, p.heads, batch), kThreads, state_backward_smem<D, DVT>(), s>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  kda_chunk_backward<D><<<dim3(p.chunks, p.heads, batch), kThreads, chunk_backward_smem<D>(), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// pointers: q, k, v, g, beta; strides: (b, h, n) of q, k, v, g and beta
Params make_params(const void* const* in, const long long* st, int batch, int n, int heads) {
  Params p = {};
  p.q = static_cast<const float*>(in[0]);
  p.k = static_cast<const float*>(in[1]);
  p.v = static_cast<const float*>(in[2]);
  p.g = static_cast<const float*>(in[3]);
  p.beta = static_cast<const float*>(in[4]);
  p.q_b = st[0], p.q_h = st[1], p.q_n = st[2];
  p.k_b = st[3], p.k_h = st[4], p.k_n = st[5];
  p.v_b = st[6], p.v_h = st[7], p.v_n = st[8];
  p.g_b = st[9], p.g_h = st[10], p.g_n = st[11];
  p.beta_b = st[12], p.beta_h = st[13], p.beta_n = st[14];
  p.heads = heads;
  p.n = n;
  p.chunks = (n + kC - 1) / kC;
  (void)batch;
  return p;
}

bool bad_shape(int d, int batch, int n, int heads) {
  return (d != 128 && d != 32) || batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || n < 1;
}

}  // namespace

// The forward (two launches): o (B, N, H, D) from q, k, v, g (B, H, N, D)
// and beta (B, H, N) at the strides given; w, u (chunks, 64, D) and p
// (chunks, 64, 64) are scratch.  Returns a cudaError_t.
extern "C" int kda_forward(int d, int batch, int n, int heads, const void* const* in, const long long* strides,
                           void* o, void* w, void* u, void* pmat, void* stream) {
  if (bad_shape(d, batch, n, heads)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(in, strides, batch, n, heads);
  p.o = static_cast<float*>(o);
  p.w = static_cast<float*>(w);
  p.u = static_cast<float*>(u);
  p.p = static_cast<float*>(pmat);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 128 ? forward<128>(p, batch, s) : forward<32>(p, batch, s);
}

// The backward (four launches): dq, dk, dv, dg (B, N, H, D) and dbeta (B, N,
// H) from the forward's inputs and dO (B, H, N, D) at the strides given
// (do_strides: b, h, n); the rest is scratch: w, u (chunks, 64, D), p, abar
// (chunks, 64, 64), states, dstates (chunks, D, D), vnew, dvnew (chunks, 64,
// D).  Returns a cudaError_t.
extern "C" int kda_backward(int d, int batch, int n, int heads, const void* const* in, const long long* strides,
                            const void* dout, const long long* do_strides, void* const* scratch, void* dq,
                            void* dk, void* dv, void* dg, void* dbeta, void* stream) {
  if (bad_shape(d, batch, n, heads)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(in, strides, batch, n, heads);
  p.dout = static_cast<const float*>(dout);
  p.do_b = do_strides[0], p.do_h = do_strides[1], p.do_n = do_strides[2];
  p.w = static_cast<float*>(scratch[0]);
  p.u = static_cast<float*>(scratch[1]);
  p.p = static_cast<float*>(scratch[2]);
  p.abar = static_cast<float*>(scratch[3]);
  p.states = static_cast<float*>(scratch[4]);
  p.vnew = static_cast<float*>(scratch[5]);
  p.dstates = static_cast<float*>(scratch[6]);
  p.dvnew = static_cast<float*>(scratch[7]);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.dg = static_cast<float*>(dg);
  p.dbeta = static_cast<float*>(dbeta);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 128 ? backward<128>(p, batch, s) : backward<32>(p, batch, s);
}
