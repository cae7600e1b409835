// The attention core of DeepSeek-V2's multi-head latent attention (MLA), for
// Hopper (sm_90a), forward and backward
// (diffusion_extensions_tpu_torch/ops/mla_attention_cuda.py, called by
// models/deepseek_v2.py MLA.forward):
//
//   o = softmax(scale q k^T) v,   k = [k_nope | k_pe], k_pe shared by the heads,
//
// over all N points of a cloud (no mask), for each of B clouds and H heads.
//
// Replaces no TPU kernel: the JAX package has no DeepSeek-V2 trunk.  As
// PyTorch operations the core cloned q, expanded and concatenated k_pe into
// k, cloned v, wrote the (B, H, N, N) logits in bf16, widened, scaled and
// softmaxed them in float32, cast the weights to bf16 and cloned o for its
// transpose; autograd kept the float32 softmax and the bf16 weights for the
// backward and mirrored every step there.  At the dsv2lite-aircraft-train
// cell's shapes (B 64, N 256, H 16, qk 128 + 64, v 128) that is 67.1 M
// logits a layer, ~3.2 GB moved forward and ~4.1 GB backward.
//
// Bound on this card: memory.  The kernels read q, k_nope, k_pe and v (the
// backward also o, dO and the log-sum-exp) and write o (dq, dkv, dk_pe) once:
// ~0.31 GB forward and ~0.61 GB backward a layer, 0.09 + 0.18 ms at 3.35
// TB/s, against 43 + 86 GFLOP of products (0.04 + 0.09 ms at 989 TFLOP/s).
//
// Design:
// * Inputs are read in place, as the projections wrote them: q from
//   q_proj's (B, N, H qk) rows, k_nope and v as two boxes of kv_b_proj's (B,
//   N, H (nope + v)) rows, k_pe from its (B, N, rope) slice of
//   kv_a_proj_with_mqa's rows.  A key tile in shared memory is filled from
//   the k_nope box and the shared k_pe box, so the expand and the cat never
//   exist.  o, dq and dkv are written in the (B, N, H, .) layouts the
//   projections read (no transposes); dk_pe as (B, N, rope).
// * FlashAttention's scheme: tiles of S = q k^T live in registers
//   (mma.sync m16n8k16, bf16 operands, float32 sums), the softmax runs
//   online in float32 in log2 units (scale log2(e) folded into one product),
//   and neither the logits nor the probabilities reach device memory.  The
//   forward keeps, beside o, only each row's log2-sum-exp; the backward
//   recomputes P from it.  P and dS are rounded to bf16 only as tensor-core
//   operands.  The plain chain rounds the logits to bf16 before its float32
//   softmax; here they stay float32.
// * Tiles of 64 queries and 64 keys, rows of shared memory padded by 16
//   bytes (ldmatrix reads them without bank conflicts); loads by cp.async,
//   the ragged last tile zero-filled, keys past N masked (forward: -inf;
//   backward: P = 0), rows past N never stored.
//   - forward: a block a (query tile, head, cloud), four warps of 16 rows;
//     key tiles double-buffered.
//   - backward, first kernel: a block a (query tile, head, cloud); computes
//     D = rowsum(dO o) in float32 (kept for the second kernel), then over the
//     keys, 32 at a time, P, dP = dO v^T, dS = P (dP - D) and dq += dS k.
//   - backward, second kernel: a block a (key tile, cloud), eight warps,
//     walking the heads in order and, in each, the query tiles: S^T and dP^T
//     (warps split keys x queries), P^T and dS^T through shared memory, then
//     dv += P^T dO and dk += dS^T q (warps split keys x columns).  A head's
//     dk_nope and dv are stored when its last query tile is done; dk_pe's
//     columns keep summing over the heads, in order, and are stored at the
//     end.  Queries and keys double-buffered.
// * No atomics anywhere, and every sum in a fixed order (dq over key tiles,
//   dk_pe over heads), so two calls give the same bits and replayed steps
//   repeat eager ones.
// * Built for (qk, rope, v) = (192, 64, 128), DeepSeek-V2-Lite's heads, and
//   (48, 16, 32), the card tests' small trunk; other head dims are refused.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // queries of a query tile, keys of a key tile
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const bf16* q;    // (B, N, H, qk) at strides q_b, q_n, q_h (elements), unit stride last
  const bf16* kv;   // (B, N, H, nope + v): [k_nope | v]
  const bf16* kpe;  // (B, N, rope)
  long long q_b, q_n, q_h, kv_b, kv_n, kv_h, kpe_b, kpe_n;
  int n, heads;
  float scale;
  bf16* o;           // (B, N, H, v), contiguous
  float* lse;        // (B, H, N): log2 sum_k 2^(scale log2(e) q.k)
  const bf16* dout;  // (B, N, H, v), contiguous
  float* delta;      // (B, H, N): rowsum(dO o)
  bf16* dq;          // (B, N, H, qk), contiguous
  bf16* dkv;         // (B, N, H, nope + v), contiguous
  bf16* dkpe;        // (B, N, rope), contiguous
};

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros where !valid (no byte is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16; d float32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as bf16 (round to nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulators of n-tiles 2 kk and 2 kk + 1 (16 columns) as the A
// operand of a product over those columns.
__device__ __forceinline__ void as_a(uint32_t (&a)[4], const float (&lo)[4], const float (&hi)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// Lane offsets (elements) into a row-major tile of pitch P for ldmatrix:
// an A operand (or a B operand read transposed from [k][n] rows) of 16 x 16
// at its top left, and a B operand read from [n][k] rows (two n-tiles of 8).
template <int P>
__device__ __forceinline__ int a_off(int lane) {
  return (lane & 15) * P + (lane >> 4) * 8;
}
template <int P>
__device__ __forceinline__ int b_off(int lane) {
  return ((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 8;
}

// Rows [0, kTile) of a box of W columns whose row r starts at src + r ld,
// into dst at pitch P; rows at or past `valid` are zero-filled.
template <int W, int P, int THREADS>
__device__ __forceinline__ void load_box(bf16* dst, const bf16* src, long long ld, int valid) {
  constexpr int kChunks = W / 8, kTotal = kTile * kChunks;
#pragma unroll
  for (int k = 0; k < (kTotal + THREADS - 1) / THREADS; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (kTotal % THREADS == 0 || i < kTotal) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = r < valid;
      cp_async16(dst + r * P + c, src + (ok ? r : 0) * ld + c, ok);
    }
  }
}

// ---------------------------------------------------------------- forward

template <int DQK, int DR, int DV>
struct Shape {
  static constexpr int DN = DQK - DR, PQ = DQK + 8, PV = DV + 8, PP = kTile + 8;
  static_assert(DQK % 16 == 0 && DR % 8 == 0 && DV % 32 == 0 && DN % 8 == 0, "head dims");
};

template <int DQK, int DR, int DV, int THREADS>
__device__ __forceinline__ void load_keys(bf16* sk, bf16* sv, const bf16* kvh, const bf16* kpb,
                                          const Params& p, int key0) {
  using S = Shape<DQK, DR, DV>;
  const int valid = p.n - key0;
  load_box<S::DN, S::PQ, THREADS>(sk, kvh + key0 * p.kv_n, p.kv_n, valid);
  load_box<DR, S::PQ, THREADS>(sk + S::DN, kpb + key0 * p.kpe_n, p.kpe_n, valid);
  load_box<DV, S::PV, THREADS>(sv, kvh + S::DN + key0 * p.kv_n, p.kv_n, valid);
}

template <int DQK, int DR, int DV>
constexpr int forward_smem() {
  using S = Shape<DQK, DR, DV>;
  return (3 * kTile * S::PQ + 2 * kTile * S::PV) * 2;
}

template <int DQK, int DR, int DV>
__global__ void __launch_bounds__(128) mla_attention_forward_kernel(const Params p) {
  using S = Shape<DQK, DR, DV>;
  constexpr int PQ = S::PQ, PV = S::PV;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kTile * PQ;      // two buffers
  bf16* sv = sk + 2 * kTile * PQ;  // two buffers
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* kvh = p.kv + b * p.kv_b + h * p.kv_h;
  const bf16* kpb = p.kpe + b * p.kpe_b;
  const int tiles = (p.n + kTile - 1) / kTile;
  const float sl2 = p.scale * kLog2e;

  load_box<DQK, PQ, 128>(sq, p.q + b * p.q_b + h * p.q_h + q0 * p.q_n, p.q_n, p.n - q0);
  load_keys<DQK, DR, DV, 128>(sk, sv, kvh, kpb, p, 0);
  cp_async_commit();

  float acc[DV / 8][4];
  zero(acc);
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const uint32_t q_a = smem_addr(sq) + 2 * ((warp * 16) * PQ + a_off<PQ>(lane));

  for (int j = 0; j < tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < tiles)
      load_keys<DQK, DR, DV, 128>(sk + (buf ^ 1) * kTile * PQ, sv + (buf ^ 1) * kTile * PV, kvh, kpb, p,
                                  (j + 1) * kTile);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // S = q k^T: 16 rows x 64 keys a warp
    float s[8][4];
    zero(s);
    const uint32_t k_b = smem_addr(sk + buf * kTile * PQ) + 2 * b_off<PQ>(lane);
#pragma unroll
    for (int ks = 0; ks < DQK / 16; ++ks) {
      uint32_t a[4];
      ldsm4(a, q_a + ks * 32);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldsm4(bk, k_b + 2 * (np * 16 * PQ + ks * 16));
        mma(s[2 * np], a, bk[0], bk[1]);
        mma(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    // the online softmax in log2 units; rows g (e = 0, 1) and g + 8 (e = 2, 3)
    const int key0 = j * kTile;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = key0 + nt * 8 + 2 * t + (e & 1);
        const float x = col < p.n ? s[nt][e] * sl2 : -CUDART_INF_F;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);  // every tile holds a key below n: mx is finite
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - m[e >> 1]);
        s[nt][e] = pe;
        ls[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    // o += P v
    const uint32_t v_t = smem_addr(sv + buf * kTile * PV) + 2 * a_off<PV>(lane);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      as_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        uint32_t bv[4];
        ldsm4_t(bv, v_t + 2 * (kk * 16 * PV + dp * 16));
        mma(acc[2 * dp], a, bv[0], bv[1]);
        mma(acc[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this buffer is refilled at the next step
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row < p.n) {
      const float inv = 1.f / l[r];
      bf16* orow = p.o + ((static_cast<long long>(b) * p.n + row) * p.heads + h) * DV;
#pragma unroll
      for (int nt = 0; nt < DV / 8; ++nt)
        *reinterpret_cast<uint32_t*>(orow + nt * 8 + 2 * t) = pack(acc[nt][2 * r] * inv, acc[nt][2 * r + 1] * inv);
      if (t == 0) p.lse[(static_cast<long long>(b) * p.heads + h) * p.n + row] = m[r] + log2f(l[r]);
    }
  }
}

// ---------------------------------------------------------------- backward: D and dq

template <int DQK, int DR, int DV>
constexpr int dq_smem() {
  using S = Shape<DQK, DR, DV>;
  return (2 * kTile * S::PQ + 2 * kTile * S::PV) * 2 + kTile * 4;
}

template <int DQK, int DR, int DV>
__global__ void __launch_bounds__(128) mla_attention_dq_kernel(const Params p) {
  using S = Shape<DQK, DR, DV>;
  constexpr int PQ = S::PQ, PV = S::PV;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + kTile * PQ;
  bf16* sk = sdo + kTile * PV;
  bf16* sv = sk + kTile * PQ;
  float* sdelta = reinterpret_cast<float*>(sv + kTile * PV);
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* kvh = p.kv + b * p.kv_b + h * p.kv_h;
  const bf16* kpb = p.kpe + b * p.kpe_b;
  const long long ld_o = static_cast<long long>(p.heads) * DV;
  const long long o_base = (static_cast<long long>(b) * p.n * p.heads + h) * DV;  // row r: + r ld_o
  const long long row_base = (static_cast<long long>(b) * p.heads + h) * p.n;     // of lse and delta
  const int tiles = (p.n + kTile - 1) / kTile;
  const float sl2 = p.scale * kLog2e;

  load_box<DQK, PQ, 128>(sq, p.q + b * p.q_b + h * p.q_h + q0 * p.q_n, p.q_n, p.n - q0);
  load_box<DV, PV, 128>(sdo, p.dout + o_base + q0 * ld_o, ld_o, p.n - q0);
  load_keys<DQK, DR, DV, 128>(sk, sv, kvh, kpb, p, 0);
  cp_async_commit();

  {  // D = rowsum(dO o) in float32, two threads a row, summed in a fixed order
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = q0 + r;
    float d = 0.f;
    if (row < p.n) {
      const bf16* orow = p.o + o_base + row * ld_o + half * (DV / 2);
      const bf16* drow = p.dout + o_base + row * ld_o + half * (DV / 2);
#pragma unroll
      for (int c = 0; c < DV / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 of = __bfloat1622float2(o2[i]), df = __bfloat1622float2(d2[i]);
          d = fmaf(of.x, df.x, d);
          d = fmaf(of.y, df.y, d);
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      sdelta[r] = d;
      if (row < p.n) p.delta[row_base + row] = d;
    }
  }
  float lse[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lse[r] = row < p.n ? p.lse[row_base + row] : 0.f;
  }

  float acc[DQK / 8][4];
  zero(acc);
  const uint32_t q_a = smem_addr(sq) + 2 * (warp * 16 * PQ + a_off<PQ>(lane));
  const uint32_t do_a = smem_addr(sdo) + 2 * (warp * 16 * PV + a_off<PV>(lane));
  const uint32_t k_b = smem_addr(sk) + 2 * b_off<PQ>(lane);
  const uint32_t k_t = smem_addr(sk) + 2 * a_off<PQ>(lane);
  const uint32_t v_b = smem_addr(sv) + 2 * b_off<PV>(lane);

  for (int j = 0; j < tiles; ++j) {
    if (j > 0) {
      __syncthreads();  // every warp is done with the last tile
      load_keys<DQK, DR, DV, 128>(sk, sv, kvh, kpb, p, j * kTile);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    if (j == 0) {
      dl[0] = sdelta[warp * 16 + g];
      dl[1] = sdelta[warp * 16 + g + 8];
    }
    // in halves of 32 keys (what the registers hold beside dq's sums)
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int kh = half * 32, key0 = j * kTile + kh;
      // S = q k^T, then P = 2^(S scale log2e - lse); keys past n give 0
      float s[4][4];
      zero(s);
#pragma unroll
      for (int ks = 0; ks < DQK / 16; ++ks) {
        uint32_t a[4];
        ldsm4(a, q_a + ks * 32);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bk[4];
          ldsm4(bk, k_b + 2 * ((kh + np * 16) * PQ + ks * 16));
          mma(s[2 * np], a, bk[0], bk[1]);
          mma(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = key0 + nt * 8 + 2 * t + (e & 1);
          s[nt][e] = col < p.n ? exp2f(fmaf(s[nt][e], sl2, -lse[e >> 1])) : 0.f;
        }
      }
      // dP = dO v^T, then dS = P (dP - D)
      float dp[4][4];
      zero(dp);
#pragma unroll
      for (int ks = 0; ks < DV / 16; ++ks) {
        uint32_t a[4];
        ldsm4(a, do_a + ks * 32);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bv[4];
          ldsm4(bv, v_b + 2 * ((kh + np * 16) * PV + ks * 16));
          mma(dp[2 * np], a, bv[0], bv[1]);
          mma(dp[2 * np + 1], a, bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= dp[nt][e] - dl[e >> 1];
      }
      // dq += dS k
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[4];
        as_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dd = 0; dd < DQK / 16; ++dd) {
          uint32_t bk[4];
          ldsm4_t(bk, k_t + 2 * ((kh + kk * 16) * PQ + dd * 16));
          mma(acc[2 * dd], a, bk[0], bk[1]);
          mma(acc[2 * dd + 1], a, bk[2], bk[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row < p.n) {
      bf16* dqrow = p.dq + ((static_cast<long long>(b) * p.n + row) * p.heads + h) * DQK;
#pragma unroll
      for (int nt = 0; nt < DQK / 8; ++nt)
        *reinterpret_cast<uint32_t*>(dqrow + nt * 8 + 2 * t) =
            pack(acc[nt][2 * r] * p.scale, acc[nt][2 * r + 1] * p.scale);
    }
  }
}

// ---------------------------------------------------------------- backward: dkv and dk_pe

template <int DQK, int DR, int DV>
constexpr int dkv_smem() {
  using S = Shape<DQK, DR, DV>;
  return (4 * kTile * S::PQ + 4 * kTile * S::PV + 2 * kTile * S::PP) * 2 + 4 * kTile * 4;
}

template <int DQK, int DR, int DV>
__global__ void __launch_bounds__(256, 1) mla_attention_dkv_kernel(const Params p) {
  using S = Shape<DQK, DR, DV>;
  constexpr int DN = S::DN, PQ = S::PQ, PV = S::PV, PP = S::PP;
  constexpr int NV = DV / 16, NK = DQK / 16;  // n-tiles of a warp's half of dv's and of dk's columns
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);  // two buffers each, by head
  bf16* sv = sk + 2 * kTile * PQ;
  bf16* sq = sv + 2 * kTile * PV;  // two buffers each, by step
  bf16* sdo = sq + 2 * kTile * PQ;
  bf16* sp = sdo + 2 * kTile * PV;  // P^T (keys x queries)
  bf16* sds = sp + kTile * PP;      // dS^T
  float* slse = reinterpret_cast<float*>(sds + kTile * PP);  // two buffers
  float* sdl = slse + 2 * kTile;                             // two buffers
  const int k0 = blockIdx.x * kTile, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kw = warp & 3, hw = warp >> 2;  // the warp's 16 keys; its half of queries / columns
  const int qtiles = (p.n + kTile - 1) / kTile, steps = p.heads * qtiles;
  const long long ld_o = static_cast<long long>(p.heads) * DV;
  const float sl2 = p.scale * kLog2e;

  auto load_head = [&](int h, int buf) {
    const bf16* kvh = p.kv + b * p.kv_b + h * p.kv_h + k0 * p.kv_n;
    load_box<DN, PQ, 256>(sk + buf * kTile * PQ, kvh, p.kv_n, p.n - k0);
    load_box<DV, PV, 256>(sv + buf * kTile * PV, kvh + DN, p.kv_n, p.n - k0);
  };
  auto load_queries = [&](int step, int buf) {
    const int h = step / qtiles, q0 = (step - h * qtiles) * kTile;
    load_box<DQK, PQ, 256>(sq + buf * kTile * PQ, p.q + b * p.q_b + h * p.q_h + q0 * p.q_n, p.q_n, p.n - q0);
    load_box<DV, PV, 256>(sdo + buf * kTile * PV,
                          p.dout + (static_cast<long long>(b) * p.n * p.heads + h) * DV + q0 * ld_o, ld_o,
                          p.n - q0);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const bool ok = row < p.n;  // past n: 0, with q and dO rows of zeros (no term)
      const long long at = (static_cast<long long>(b) * p.heads + h) * p.n + (ok ? row : 0);
      cp_async4(slse + buf * kTile + threadIdx.x, p.lse + at, ok);
      cp_async4(sdl + buf * kTile + threadIdx.x, p.delta + at, ok);
    }
  };
  // k_pe's columns of both key buffers once; head 0's k_nope and v; step 0's queries
  for (int buf = 0; buf < 2; ++buf)
    load_box<DR, PQ, 256>(sk + buf * kTile * PQ + DN, p.kpe + b * p.kpe_b + k0 * p.kpe_n, p.kpe_n, p.n - k0);
  load_head(0, 0);
  load_queries(0, 0);
  cp_async_commit();

  float dv[NV][4], dk[NK][4];
  zero(dv);
  zero(dk);
  const int dv_col = hw * (DV / 2), dk_col = hw * (DQK / 2);  // the warp's first column

  for (int step = 0; step < steps; ++step) {
    const int h = step / qtiles, i = step - h * qtiles, qb = step & 1, kb = h & 1;
    if (step + 1 < steps) {
      load_queries(step + 1, qb ^ 1);
      if ((step + 1) / qtiles != h) load_head(h + 1, kb ^ 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // phase 1: S^T = k q^T and dP^T = v dO^T for the warp's 16 keys x 32 queries
    float st[4][4], dpt[4][4];
    zero(st);
    zero(dpt);
    {
      const uint32_t k_a = smem_addr(sk + kb * kTile * PQ) + 2 * (kw * 16 * PQ + a_off<PQ>(lane));
      const uint32_t q_b = smem_addr(sq + qb * kTile * PQ) + 2 * (hw * 32 * PQ + b_off<PQ>(lane));
#pragma unroll
      for (int ks = 0; ks < DQK / 16; ++ks) {
        uint32_t a[4];
        ldsm4(a, k_a + ks * 32);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bq[4];
          ldsm4(bq, q_b + 2 * (np * 16 * PQ + ks * 16));
          mma(st[2 * np], a, bq[0], bq[1]);
          mma(st[2 * np + 1], a, bq[2], bq[3]);
        }
      }
      const uint32_t v_a = smem_addr(sv + kb * kTile * PV) + 2 * (kw * 16 * PV + a_off<PV>(lane));
      const uint32_t do_b = smem_addr(sdo + qb * kTile * PV) + 2 * (hw * 32 * PV + b_off<PV>(lane));
#pragma unroll
      for (int ks = 0; ks < DV / 16; ++ks) {
        uint32_t a[4];
        ldsm4(a, v_a + ks * 32);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bd[4];
          ldsm4(bd, do_b + 2 * (np * 16 * PV + ks * 16));
          mma(dpt[2 * np], a, bd[0], bd[1]);
          mma(dpt[2 * np + 1], a, bd[2], bd[3]);
        }
      }
    }
    // P^T = 2^(S^T scale log2e - lse), dS^T = P^T (dP^T - D), to shared memory as bf16
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = hw * 32 + nt * 8 + 2 * t;
      const float l0 = slse[qb * kTile + col], l1 = slse[qb * kTile + col + 1];
      const float d0 = sdl[qb * kTile + col], d1 = sdl[qb * kTile + col + 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = exp2f(fmaf(st[nt][2 * r], sl2, -l0)), p1 = exp2f(fmaf(st[nt][2 * r + 1], sl2, -l1));
        const int at = (kw * 16 + g + 8 * r) * PP + col;
        *reinterpret_cast<uint32_t*>(sp + at) = pack(p0, p1);
        *reinterpret_cast<uint32_t*>(sds + at) = pack(p0 * (dpt[nt][2 * r] - d0), p1 * (dpt[nt][2 * r + 1] - d1));
      }
    }
    __syncthreads();

    // phase 2: dv += P^T dO and dk += dS^T q over the 64 queries, the warp's
    // 16 keys x its half of the columns
    {
      const uint32_t p_a = smem_addr(sp) + 2 * (kw * 16 * PP + a_off<PP>(lane));
      const uint32_t ds_a = smem_addr(sds) + 2 * (kw * 16 * PP + a_off<PP>(lane));
      const uint32_t do_t = smem_addr(sdo + qb * kTile * PV) + 2 * (dv_col + a_off<PV>(lane));
      const uint32_t q_t = smem_addr(sq + qb * kTile * PQ) + 2 * (dk_col + a_off<PQ>(lane));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        ldsm4(a, p_a + kk * 32);
#pragma unroll
        for (int np = 0; np < NV / 2; ++np) {
          uint32_t bd[4];
          ldsm4_t(bd, do_t + 2 * (kk * 16 * PV + np * 16));
          mma(dv[2 * np], a, bd[0], bd[1]);
          mma(dv[2 * np + 1], a, bd[2], bd[3]);
        }
        ldsm4(a, ds_a + kk * 32);
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {
          uint32_t bq[4];
          ldsm4_t(bq, q_t + 2 * (kk * 16 * PQ + np * 16));
          mma(dk[2 * np], a, bq[0], bq[1]);
          mma(dk[2 * np + 1], a, bq[2], bq[3]);
        }
        if constexpr (NK % 2 == 1) {
          uint32_t bq[2];
          ldsm2_t(bq, q_t + 2 * (kk * 16 * PQ + (NK - 1) * 8));
          mma(dk[NK - 1], a, bq[0], bq[1]);
        }
      }
    }

    if (i == qtiles - 1) {  // head h is done: store its dv and dk_nope, keep dk_pe's columns summing
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = k0 + kw * 16 + g + 8 * r;
        if (key < p.n) {
          bf16* row = p.dkv + ((static_cast<long long>(b) * p.n + key) * p.heads + h) * (DN + DV);
#pragma unroll
          for (int nt = 0; nt < NV; ++nt)
            *reinterpret_cast<uint32_t*>(row + DN + dv_col + nt * 8 + 2 * t) = pack(dv[nt][2 * r], dv[nt][2 * r + 1]);
#pragma unroll
          for (int nt = 0; nt < NK; ++nt)
            if (dk_col + nt * 8 < DN)
              *reinterpret_cast<uint32_t*>(row + dk_col + nt * 8 + 2 * t) =
                  pack(dk[nt][2 * r] * p.scale, dk[nt][2 * r + 1] * p.scale);
        }
      }
      zero(dv);
#pragma unroll
      for (int nt = 0; nt < NK; ++nt)
        if (dk_col + nt * 8 < DN) dk[nt][0] = dk[nt][1] = dk[nt][2] = dk[nt][3] = 0.f;
    }
    __syncthreads();  // P^T, dS^T and this step's buffers are reused
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kw * 16 + g + 8 * r;
    if (key < p.n) {
      bf16* row = p.dkpe + (static_cast<long long>(b) * p.n + key) * DR;
#pragma unroll
      for (int nt = 0; nt < NK; ++nt)
        if (dk_col + nt * 8 >= DN)
          *reinterpret_cast<uint32_t*>(row + dk_col + nt * 8 - DN + 2 * t) =
              pack(dk[nt][2 * r] * p.scale, dk[nt][2 * r + 1] * p.scale);
    }
  }
}

// ---------------------------------------------------------------- launches

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return bytes > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
                           : cudaSuccess;
}

template <int DQK, int DR, int DV>
int forward(const Params& p, int batch, cudaStream_t s) {
  static const cudaError_t attr =
      allow_smem(mla_attention_forward_kernel<DQK, DR, DV>, forward_smem<DQK, DR, DV>());
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((p.n + kTile - 1) / kTile, p.heads, batch);
  mla_attention_forward_kernel<DQK, DR, DV><<<grid, 128, forward_smem<DQK, DR, DV>(), s>>>(p);
  return (int)cudaGetLastError();
}

template <int DQK, int DR, int DV>
int backward(const Params& p, int batch, cudaStream_t s) {
  static const cudaError_t attr_dq = allow_smem(mla_attention_dq_kernel<DQK, DR, DV>, dq_smem<DQK, DR, DV>());
  static const cudaError_t attr_dkv =
      allow_smem(mla_attention_dkv_kernel<DQK, DR, DV>, dkv_smem<DQK, DR, DV>());
  if (attr_dq != cudaSuccess) return (int)attr_dq;
  if (attr_dkv != cudaSuccess) return (int)attr_dkv;
  const int tiles = (p.n + kTile - 1) / kTile;
  mla_attention_dq_kernel<DQK, DR, DV><<<dim3(tiles, p.heads, batch), 128, dq_smem<DQK, DR, DV>(), s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mla_attention_dkv_kernel<DQK, DR, DV><<<dim3(tiles, batch), 256, dkv_smem<DQK, DR, DV>(), s>>>(p);
  return (int)cudaGetLastError();
}

Params make_params(const void* q, long long q_b, long long q_n, long long q_h, const void* kv, long long kv_b,
                   long long kv_n, long long kv_h, const void* kpe, long long kpe_b, long long kpe_n, int n,
                   int heads, float scale) {
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.kv = static_cast<const bf16*>(kv);
  p.kpe = static_cast<const bf16*>(kpe);
  p.q_b = q_b, p.q_n = q_n, p.q_h = q_h;
  p.kv_b = kv_b, p.kv_n = kv_n, p.kv_h = kv_h;
  p.kpe_b = kpe_b, p.kpe_n = kpe_n;
  p.n = n, p.heads = heads, p.scale = scale;
  return p;
}

bool bad_shape(int batch, int n, int heads) {
  return batch < 1 || batch > 65535 || n < 1 || heads < 1 || heads > 65535;
}

}  // namespace

// The forward: o (B, N, H, v) and lse (B, H, N).  Returns a cudaError_t.
extern "C" int mla_attention_forward(int dqk, int dr, int dv, const void* q, long long q_b, long long q_n,
                                     long long q_h, const void* kv, long long kv_b, long long kv_n,
                                     long long kv_h, const void* kpe, long long kpe_b, long long kpe_n,
                                     int batch, int n, int heads, float scale, void* o, void* lse,
                                     void* stream) {
  if (bad_shape(batch, n, heads)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, q_b, q_n, q_h, kv, kv_b, kv_n, kv_h, kpe, kpe_b, kpe_n, n, heads, scale);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dqk == 192 && dr == 64 && dv == 128) return forward<192, 64, 128>(p, batch, s);
  if (dqk == 48 && dr == 16 && dv == 32) return forward<48, 16, 32>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}

// The backward (two launches): delta (B, H, N), dq (B, N, H, qk), dkv (B, N,
// H, nope + v) and dk_pe (B, N, rope) from the forward's o and lse and dO (B,
// N, H, v).  Returns a cudaError_t.
extern "C" int mla_attention_backward(int dqk, int dr, int dv, const void* q, long long q_b, long long q_n,
                                      long long q_h, const void* kv, long long kv_b, long long kv_n,
                                      long long kv_h, const void* kpe, long long kpe_b, long long kpe_n,
                                      int batch, int n, int heads, float scale, const void* o,
                                      const void* lse, const void* dout, void* delta, void* dq, void* dkv,
                                      void* dkpe, void* stream) {
  if (bad_shape(batch, n, heads)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, q_b, q_n, q_h, kv, kv_b, kv_n, kv_h, kpe, kpe_b, kpe_n, n, heads, scale);
  p.o = const_cast<bf16*>(static_cast<const bf16*>(o));
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.dout = static_cast<const bf16*>(dout);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  p.dkv = static_cast<bf16*>(dkv);
  p.dkpe = static_cast<bf16*>(dkpe);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dqk == 192 && dr == 64 && dv == 128) return backward<192, 64, 128>(p, batch, s);
  if (dqk == 48 && dr == 16 && dv == 32) return backward<48, 16, 32>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}
