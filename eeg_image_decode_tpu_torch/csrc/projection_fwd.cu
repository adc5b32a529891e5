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
// fp32, as in the JAX kernel. The mode is a template parameter: mode 0
// compiles to the same code as before the dropout modes existed.
//
// Bound on the H100 (ATM-S: 1440 -> 1024 -> 1024, B 256): 1.3 GFLOP
// (~1.3 us at the bf16 tensor-core peak) against 5 MB of bf16 weights plus
// 1.8 MB of activations (~2 us at 3.35 TB/s): the head sits near the ridge
// and a batch this small is bound by the weight bytes; at the training batch
// (B 1024, 5.2 GFLOP) it is bound by operations. Each block takes 4 rows,
// keeps them (and then g) plus the fp32 `a` rows in shared memory, and its 16
// warps (64 output columns each) stream both weight matrices once from L2:
// at B 256 that is 64 blocks, each reading 5 MB of weights. The products
// are fp32 FMA loops (common.cuh::gemm_rows), so this version is bound by the
// latency of those L2 reads rather than by device memory.

#include "common.cuh"
#include "philox.cuh"

namespace {

using namespace eid;

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
                          float inv_keep) {
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
          z = z * (keep_bits(seed, (uint32_t)(r0 + i), kSiteProjection,
                             (uint32_t)n) < thresh
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

template <typename T, int MODE>
int launch_mode(const void* x, const void* const* w, void* out, int B,
                int Din, int Dout, const void* mask, const int* seed,
                unsigned thresh, float inv_keep, size_t smem,
                cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      projection_fwd_kernel<T, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + kRows - 1) / kRows;
  projection_fwd_kernel<T, MODE><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w[0]),
      static_cast<const T*>(w[1]), static_cast<const T*>(w[2]),
      static_cast<const T*>(w[3]), static_cast<const T*>(w[4]),
      static_cast<const T*>(w[5]), static_cast<float*>(out), B, Din, Dout,
      static_cast<const T*>(mask), seed, thresh, inv_keep);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int mode, const void* x, const void* const* w, void* out, int B,
           int Din, int Dout, const void* mask, const int* seed,
           unsigned thresh, float inv_keep, size_t smem, cudaStream_t s) {
  if (mode == kDropMasks)
    return launch_mode<T, kDropMasks>(x, w, out, B, Din, Dout, mask, seed,
                                      thresh, inv_keep, smem, s);
  if (mode == kDropSeed)
    return launch_mode<T, kDropSeed>(x, w, out, B, Din, Dout, mask, seed,
                                     thresh, inv_keep, smem, s);
  return launch_mode<T, kDropNone>(x, w, out, B, Din, Dout, mask, seed,
                                   thresh, inv_keep, smem, s);
}

}  // namespace

// x: (B, Din) in dtype; w: wi (Din, Dout), bi, wr (Dout, Dout), br, ln_s,
// ln_b, all contiguous in dtype; out: (B, Dout) float32. drop_mode 0: no
// dropout; 1: `mask` (B, Dout) in dtype, pre-scaled; 2: `seed` (one int32 on
// the device), keep iff bits < thresh, kept value inv_keep.
extern "C" int eid_projection_fwd(int dtype, const void* x,
                                  const void* const* w, void* out, int B,
                                  int Din, int Dout, int drop_mode,
                                  const void* mask, const int* seed,
                                  unsigned thresh, float inv_keep,
                                  void* stream) {
  if (B <= 0) return 0;
  if (drop_mode < kDropNone || drop_mode > kDropSeed ||
      (drop_mode == kDropMasks && mask == nullptr) ||
      (drop_mode == kDropSeed && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t sz = dtype == kBF16 ? 2 : 4;
  const size_t x_elems = (size_t)(Din > Dout ? Din : Dout) * kRows;
  const size_t smem = align16((size_t)kRows * Dout * 4) + x_elems * sz;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(drop_mode, x, w, out, B, Din, Dout, mask,
                                 seed, thresh, inv_keep, smem, s);
  if (dtype == kF32)
    return launch<float>(drop_mode, x, w, out, B, Din, Dout, mask, seed,
                         thresh, inv_keep, smem, s);
  return (int)cudaErrorInvalidValue;
}

// Message for a CUDA error code returned by the launchers above.
extern "C" const char* eid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
