// ATM-S projection head, forward, in three dropout modes:
//
//   a = x Wi + bi (fp32);  g = gelu_tanh(a) rounded to the working type
//   z = (g Wr + br) * m (fp32);  out = LN(a + z) (fp32, eps 1e-6, biased
//   variance)
//
// where m is the residual branch's pre-scaled keep-mask: 1 (mode 0), read
// from a (B, d_out) tensor in the working type and widened to fp32 (mode 1),
// or drawn here by philox.cuh, site 4, keyed (seed, global row), with the
// kept value 1/keep in fp32 (mode 2).
//
// Replaces the TPU kernel eeg_image_decode_tpu/ops/projection.py::_fwd_kernel
// (launched by _run_fwd) with its has_mask / has_seed variants and its
// in-kernel draw _draw_keep_mask. `a` never leaves fp32 and the output is
// fp32, as in the JAX kernel.
//
// Bound on the H100 (ATM-S: 1440 -> 1024 -> 1024): at B 256, 1.3 GFLOP
// (~1.3 us at the bf16 tensor-core peak) against 5 MB of bf16 weights plus
// 1.8 MB of activations (~2 us at 3.35 TB/s): a batch this small is bound by
// the weight bytes; at the training batch (B 1024, 5.2 GFLOP, 5.2 us) by
// operations. Two designs, chosen by dtype in the launcher
// (eid_projection_fwd_design names the one a dtype takes):
//
// bfloat16, "mma_bf16": both products on the tensor cores, the chain of
// projection_chain.cuh that the backward recomputes, then a row pass:
//   1. a = x Wi + bi            -> a (fp32), gdt = rnd(gelu(a)) (workspace)
//   2. r = a + (gdt Wr + br)·m  -> straight into the fp32 output
//   3. LayerNorm over each row of the output in place, one warp per row
// LayerNorm needs a whole row of r, so the chain is un-fused there, as in
// the backward; a and gdt (6 MB at B 1024) cross launches through L2. Each
// product is mma_tile.cuh::gemm_tile (mma.sync.m16n8k16, fp32 accumulators,
// a three-stage cp.async ring), one block per output tile summing all of K
// in a fixed order: a rerun is bit-equal, and r is bit for bit the one the
// backward recomputes. A short batch (the serving buckets, B <= 256) takes
// 64 x 64 tiles, which put twice the blocks on the card; the sums are the
// same. Measured on an H100: 0.055 ms of device time at B 1024 (first
// version 0.53), 0.040 at B 256 (0.047 with 64 x 128 tiles). Each product
// launch takes 20-28 us whether it runs 16 blocks (B 8) or 128 (B 1024) and
// whether the cp.async ring holds 3 or 8 slices: the time is a block's own
// walk over its 45 K-slices, not the card's memory or tensor rate.
//
// float32, "fma_fp32": the tensor cores would round fp32 operands to TF32,
// so fp32 keeps full-fp32 FMA products, the first version of this file:
// each block takes 4 rows, keeps them (and then g) plus the fp32 `a` rows in
// shared memory, and its 16 warps (64 output columns each) stream both
// weight matrices once from L2 (common.cuh::gemm_rows). The mode is a
// template parameter.

#include "common.cuh"
#include "mma_tile.cuh"
#include "philox.cuh"
#include "projection_chain.cuh"

// ——— launches 1 and 2, shared with the backward ———

namespace eid {
namespace proj {

// The kernels and their launcher are templates: defined here only, seen by
// no other source.

// 1. a = x Wi + bi; gdt = rnd(gelu(a))
template <int BN>
__global__ void __launch_bounds__(mma::kThreads)
    projection_chain_a_kernel(const ChainFwd p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int m0, n0;
  tile_origin<BN>(blockIdx.x, p.Dout, m0, n0);
  mma::gemm_tile<true, false, BN>(
      p.x, p.Din, p.wi, p.Dout, p.B, p.Dout, p.Din, m0, n0, smem,
      [&](int r, int c, float acc) {
        const float a = acc + to_f(p.bi[c]);
        const long e = (long)r * p.Dout + c;
        p.a32[e] = a;
        p.gdt[e] = __float2bfloat16(gelu_tanh(a));
      });
}

// 2. r = a + (gdt Wr + br) * m
template <int BN>
__global__ void __launch_bounds__(mma::kThreads)
    projection_chain_r_kernel(const ChainFwd p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int m0, n0;
  tile_origin<BN>(blockIdx.x, p.Dout, m0, n0);
  const uint32_t seed = p.mode == kDropSeed ? (uint32_t)*p.seed : 0u;
  const bool drop = p.mode != kDropNone;
  mma::gemm_tile<true, false, BN>(
      p.gdt, p.Dout, p.wr, p.Dout, p.B, p.Dout, p.Dout, m0, n0, smem,
      [&](int r, int c, float acc) {
        float z = acc + to_f(p.br[c]);
        if (drop) z = z * mask_factor(p, seed, r, c);
        const long e = (long)r * p.Dout + c;
        p.r32[e] = p.a32[e] + z;
      });
}

template <int BN>
int launch_chain_as(const ChainFwd& p, cudaStream_t s) {
  const int tiles = n_tiles(p.B, p.Dout, BN);
  projection_chain_a_kernel<BN><<<tiles, mma::kThreads, mma::kSmemBytes, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  projection_chain_r_kernel<BN><<<tiles, mma::kThreads, mma::kSmemBytes, s>>>(p);
  return (int)cudaGetLastError();
}

int launch_chain_fwd(const ChainFwd& p, cudaStream_t s) {
  return chain_bn(p.B) == 64 ? launch_chain_as<64>(p, s)
                             : launch_chain_as<128>(p, s);
}

}  // namespace proj
}  // namespace eid

namespace {

using namespace eid;

// ——— bfloat16: the row pass after the chain ———

constexpr int kLnRows = 8;  // rows (warps) per block

// 3. out = LN(r) in place: mean, then the biased variance about it (two
// passes over the row, as common.cuh::row_mean_inv), eps 1e-6, ln_s, ln_b
__global__ void __launch_bounds__(32 * kLnRows)
    projection_fwd_ln_kernel(float* __restrict__ out,
                             const __nv_bfloat16* __restrict__ ln_s,
                             const __nv_bfloat16* __restrict__ ln_b, int B,
                             int Dout) {
  const int row = blockIdx.x * kLnRows + (threadIdx.x >> 5);
  if (row >= B) return;
  const int lane = threadIdx.x & 31;
  float* r = out + (long)row * Dout;
  float mu, inv;
  row_mean_inv(r, Dout, 1e-6f, mu, inv);
  for (int n = lane; n < Dout; n += 32)
    r[n] = (r[n] - mu) * inv * to_f(ln_s[n]) + to_f(ln_b[n]);
}

// the workspace of the bfloat16 design: a (fp32), then gdt (bf16)
size_t ws_a32(long B, int Dout) { return align16((size_t)B * Dout * 4); }

int launch_mma(const void* x, const void* const* w, float* out, void* ws,
               int B, int Din, int Dout, int mode, const void* mask,
               const int* seed, unsigned thresh, float inv_keep,
               unsigned sample0, cudaStream_t s) {
  using mma::bf16;
  auto W = [&](int i) { return static_cast<const bf16*>(w[i]); };
  unsigned char* base = static_cast<unsigned char*>(ws);
  proj::ChainFwd p;
  p.x = static_cast<const bf16*>(x);
  p.wi = W(0);
  p.bi = W(1);
  p.wr = W(2);
  p.br = W(3);
  p.a32 = reinterpret_cast<float*>(base);
  p.gdt = reinterpret_cast<bf16*>(base + ws_a32(B, Dout));
  p.r32 = out;
  p.B = B;
  p.Din = Din;
  p.Dout = Dout;
  p.mode = mode;
  p.mask = static_cast<const bf16*>(mask);
  p.seed = seed;
  p.thresh = thresh;
  p.inv_keep = inv_keep;
  p.sample0 = sample0;
  const int rc = proj::launch_chain_fwd(p, s);
  if (rc != 0) return rc;
  projection_fwd_ln_kernel<<<(B + kLnRows - 1) / kLnRows, 32 * kLnRows, 0,
                             s>>>(out, W(4), W(5), B, Dout);
  return (int)cudaGetLastError();
}

// ——— float32: the first version's FMA kernel ———

constexpr int kThreads = 512;
constexpr int kRows = 4;  // rows per block

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    projection_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wi,
                          const T* __restrict__ bi, const T* __restrict__ wr,
                          const T* __restrict__ br, const T* __restrict__ ln_s,
                          const T* __restrict__ ln_b, float* __restrict__ out,
                          int B, int Din, int Dout,
                          const T* __restrict__ mask,
                          const int* __restrict__ seed_ptr, uint32_t thresh,
                          float inv_keep, uint32_t sample0) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* a = reinterpret_cast<float*>(smem);                   // rows x Dout
  T* xs = reinterpret_cast<T*>(smem + align16((size_t)kRows * Dout * 4));
  // xs holds the x rows (rows x Din), then g (rows x Dout)
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, B - r0);
  uint32_t seed = 0u;
  if constexpr (MODE == kDropSeed) seed = (uint32_t)*seed_ptr;

  const T* xb = x + (long)r0 * Din;
  for (int i = threadIdx.x; i < nr * Din; i += blockDim.x) xs[i] = xb[i];
  __syncthreads();
  gemm_rows<kRows, 2, T, T>(
      xs, Din, nr, Din, Dout, Dout, [&](int n) { return wi + n; },
      [&](int i, int n, float acc) { a[i * Dout + n] = acc + to_f(bi[n]); });
  __syncthreads();
  for (int i = threadIdx.x; i < nr * Dout; i += blockDim.x)
    xs[i] = from_f<T>(gelu_tanh(a[i]));
  __syncthreads();
  gemm_rows<kRows, 2, T, T>(
      xs, Dout, nr, Dout, Dout, Dout, [&](int n) { return wr + n; },
      [&](int i, int n, float acc) {
        float z = acc + to_f(br[n]);
        if constexpr (MODE == kDropMasks)
          z = z * to_f(mask[(long)(r0 + i) * Dout + n]);
        if constexpr (MODE == kDropSeed)
          z = z * (keep_bits(seed, (uint32_t)(r0 + i) + sample0,
                             kSiteProjection, (uint32_t)n) < thresh
                       ? inv_keep
                       : 0.f);
        a[i * Dout + n] = a[i * Dout + n] + z;
      });
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < nr; i += blockDim.x >> 5) {
    const float* row = a + i * Dout;
    float mu, inv;
    row_mean_inv(row, Dout, 1e-6f, mu, inv);
    float* orow = out + (long)(r0 + i) * Dout;
    for (int n = lane; n < Dout; n += 32)
      orow[n] = (row[n] - mu) * inv * to_f(ln_s[n]) + to_f(ln_b[n]);
  }
}

size_t fma_smem(int Din, int Dout) {
  const size_t x_elems = (size_t)(Din > Dout ? Din : Dout) * kRows;
  return align16((size_t)kRows * Dout * 4) + x_elems * sizeof(float);
}

template <int MODE>
int launch_fma_mode(const void* x, const void* const* w, float* out, int B,
                    int Din, int Dout, const void* mask, const int* seed,
                    unsigned thresh, float inv_keep, unsigned sample0,
                    cudaStream_t s) {
  const size_t smem = fma_smem(Din, Dout);
  cudaError_t e = cudaFuncSetAttribute(
      projection_fwd_kernel<float, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  auto W = [&](int i) { return static_cast<const float*>(w[i]); };
  const int blocks = (B + kRows - 1) / kRows;
  projection_fwd_kernel<float, MODE><<<blocks, kThreads, smem, s>>>(
      static_cast<const float*>(x), W(0), W(1), W(2), W(3), W(4), W(5), out,
      B, Din, Dout, static_cast<const float*>(mask), seed, thresh, inv_keep,
      sample0);
  return (int)cudaGetLastError();
}

int launch_fma(int mode, const void* x, const void* const* w, float* out,
               int B, int Din, int Dout, const void* mask, const int* seed,
               unsigned thresh, float inv_keep, unsigned sample0,
               cudaStream_t s) {
  if (mode == kDropMasks)
    return launch_fma_mode<kDropMasks>(x, w, out, B, Din, Dout, mask, seed,
                                       thresh, inv_keep, sample0, s);
  if (mode == kDropSeed)
    return launch_fma_mode<kDropSeed>(x, w, out, B, Din, Dout, mask, seed,
                                      thresh, inv_keep, sample0, s);
  return launch_fma_mode<kDropNone>(x, w, out, B, Din, Dout, mask, seed,
                                    thresh, inv_keep, sample0, s);
}

}  // namespace

// Which design a dtype takes: "mma_bf16" (tensor cores) or "fma_fp32".
extern "C" const char* eid_projection_fwd_design(int dtype) {
  return dtype == kBF16 ? "mma_bf16" : "fma_fp32";
}

// Bytes of device workspace eid_projection_fwd needs (a and gdt of the
// bfloat16 design, none for float32), or -1 for a dtype or shapes it does
// not take.
extern "C" long long eid_projection_fwd_workspace(int dtype, int B, int Din,
                                                  int Dout) {
  if (B < 0 || Din <= 0 || Dout <= 0) return -1;
  if (dtype == kBF16)
    return (long long)(ws_a32(B, Dout) + (size_t)B * Dout * 2);
  if (dtype == kF32) return fma_smem(Din, Dout) <= kMaxSmem ? 0 : -1;
  return -1;
}

// x: (B, Din) in dtype; w: wi (Din, Dout), bi, wr (Dout, Dout), br, ln_s,
// ln_b, all contiguous in dtype; out: (B, Dout) float32; ws:
// eid_projection_fwd_workspace bytes. drop_mode 0: no dropout; 1: `mask`
// (B, Dout) in dtype, pre-scaled; 2: `seed` (one int32 on the device), keep
// iff bits < thresh, kept value inv_keep, the mask of rows sample0 ...
// sample0 + B - 1 (0 unless the launch takes a data-parallel rank's rows of
// a larger batch).
extern "C" int eid_projection_fwd(int dtype, const void* x,
                                  const void* const* w, void* out, void* ws,
                                  int B, int Din, int Dout, int drop_mode,
                                  const void* mask, const int* seed,
                                  unsigned thresh, float inv_keep,
                                  unsigned sample0, void* stream) {
  if (B <= 0) return 0;
  if (eid_projection_fwd_workspace(dtype, B, Din, Dout) < 0 ||
      drop_mode < kDropNone || drop_mode > kDropSeed ||
      (drop_mode == kDropMasks && mask == nullptr) ||
      (drop_mode == kDropSeed && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == kBF16)
    return launch_mma(x, w, o, ws, B, Din, Dout, drop_mode, mask, seed, thresh,
                      inv_keep, sample0, s);
  return launch_fma(drop_mode, x, w, o, B, Din, Dout, mask, seed, thresh,
                    inv_keep, sample0, s);
}

// Message for a CUDA error code returned by the launchers above.
extern "C" const char* eid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
