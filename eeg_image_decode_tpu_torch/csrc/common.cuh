// Shared device helpers of the port's hand-written Hopper kernels.
//
// Every kernel takes float32 or bfloat16 tensors (dtype code kF32 / kBF16),
// accumulates in float32, and rounds to the working type at the same places
// as the JAX kernel it replaces. `rnd<T>(v)` is that rounding: it takes a
// float to T's precision and back (the identity for float32).
//
// `gemm_rows` is the FMA product routine: a warp-cooperative loop over an A
// operand in shared memory and a B operand anywhere (global weights or
// shared-memory activations), with fp32 accumulators in registers. Each warp
// owns a TM-row by (32*TN)-column output tile; all lanes of a warp read the
// same A element (a shared-memory broadcast) and neighbouring B columns
// (coalesced). Shapes need no padding, and float32 operands keep full
// float32 products; the float32 designs of every kernel use it. The bfloat16
// tensor-core products live in mma_tile.cuh, which zero-fills ragged edges in
// shared memory and masks them on store, and in attention_tile.cuh, which
// pads the attention layer's widths (250, 248, 62) with zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace eid {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
// the most dynamic shared memory one block may use on sm_90
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// jax.nn.gelu(approximate=True), evaluated in fp32
__device__ __forceinline__ float gelu_tanh(float u) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * u * (1.0f + tanhf(c * (u + 0.044715f * u * u * u)));
}

// d/du of gelu_tanh (the JAX kernels' _gelu_tanh_and_grad)
__device__ __forceinline__ float gelu_tanh_grad(float u) {
  const float c = 0.7978845608028654f, a = 0.044715f;
  const float t = tanhf(c * (u + a * u * u * u));
  return 0.5f * (1.0f + t) +
         0.5f * u * (1.0f - t * t) * c * (1.0f + 3.0f * a * u * u);
}

// acc(i, n) = sum_k A[i*lda + k] * B(k, n) for i < M, n < N, then epi(i, n, acc).
// B(k, n) = col_ptr(n)[k * bsk]; col_ptr is evaluated once per output column.
template <int TM, int TN, typename TA, typename TB, typename ColPtr,
          typename Epi>
__device__ __forceinline__ void gemm_rows(const TA* A, int lda, int M, int K,
                                          int N, long bsk, ColPtr col_ptr,
                                          Epi epi) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int col_tiles = (N + 32 * TN - 1) / (32 * TN);
  const int row_tiles = (M + TM - 1) / TM;
  for (int job = warp; job < row_tiles * col_tiles; job += n_warps) {
    const int i0 = (job / col_tiles) * TM;
    const int n0 = (job % col_tiles) * 32 * TN + lane;
    const TB* bp[TN];
#pragma unroll
    for (int c = 0; c < TN; ++c)
      bp[c] = (n0 + 32 * c < N) ? col_ptr(n0 + 32 * c) : nullptr;
    const TA* ap[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r)
      ap[r] = (i0 + r < M) ? A + (long)(i0 + r) * lda : nullptr;
    float acc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = ap[r] ? to_f(ap[r][k]) : 0.f;
#pragma unroll
      for (int c = 0; c < TN; ++c) b[c] = bp[c] ? to_f(bp[c][k * bsk]) : 0.f;
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c)
        if (ap[r] && bp[c]) epi(i0 + r, n0 + 32 * c, acc[r][c]);
  }
}

// gemm_rows with a strided A: A(i, k) = A[i*a_rs + k*a_ks], so a transposed
// operand in shared memory (a_rs = 1, a_ks = row length) needs no copy.
template <int TM, int TN, typename TA, typename TB, typename ColPtr,
          typename Epi>
__device__ __forceinline__ void gemm_strided(const TA* A, int a_rs, int a_ks,
                                             int M, int K, int N, long bsk,
                                             ColPtr col_ptr, Epi epi) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int col_tiles = (N + 32 * TN - 1) / (32 * TN);
  const int row_tiles = (M + TM - 1) / TM;
  for (int job = warp; job < row_tiles * col_tiles; job += n_warps) {
    const int i0 = (job / col_tiles) * TM;
    const int n0 = (job % col_tiles) * 32 * TN + lane;
    const TB* bp[TN];
#pragma unroll
    for (int c = 0; c < TN; ++c)
      bp[c] = (n0 + 32 * c < N) ? col_ptr(n0 + 32 * c) : nullptr;
    const TA* ap[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r)
      ap[r] = (i0 + r < M) ? A + (long)(i0 + r) * a_rs : nullptr;
    float acc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r)
        a[r] = ap[r] ? to_f(ap[r][(long)k * a_ks]) : 0.f;
#pragma unroll
      for (int c = 0; c < TN; ++c) b[c] = bp[c] ? to_f(bp[c][k * bsk]) : 0.f;
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c)
        if (ap[r] && bp[c]) epi(i0 + r, n0 + 32 * c, acc[r][c]);
  }
}

// Post-norm LayerNorm of one row held by one warp: biased variance
// E[(h - mu)^2], eps inside the rsqrt, as the JAX kernels compute it.
template <typename TS>
__device__ __forceinline__ void row_mean_inv(const TS* h, int D, float eps,
                                             float& mu, float& inv) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int n = lane; n < D; n += 32) s += to_f(h[n]);
  mu = warp_sum(s) / (float)D;
  float v = 0.f;
  for (int n = lane; n < D; n += 32) {
    const float d = to_f(h[n]) - mu;
    v += d * d;
  }
  inv = rsqrtf(warp_sum(v) / (float)D + eps);
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

}  // namespace eid
