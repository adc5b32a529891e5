// ATM-S projection head, forward, no dropout:
//
//   a = x Wi + bi (fp32);  g = gelu_tanh(a) rounded to the working type
//   z = g Wr + br (fp32);  out = LN(a + z) (fp32, eps 1e-6, biased variance)
//
// Replaces the TPU kernel eeg_image_decode_tpu/ops/projection.py::_fwd_kernel
// (launched by _run_fwd) in its mask-free, seed-free mode. `a` never leaves
// fp32 and the output is fp32, as in the JAX kernel.
//
// Bound on the H100 (ATM-S: 1440 -> 1024 -> 1024, B 256): 1.3 GFLOP
// (~1.3 us at the bf16 tensor-core peak) against 5 MB of bf16 weights plus
// 1.8 MB of activations (~2 us at 3.35 TB/s): the head sits near the ridge
// and a batch this small is bound by the weight bytes. Each block takes 4
// rows, keeps them (and then g) plus the fp32 `a` rows in shared memory, and
// its 16 warps (64 output columns each) stream both weight matrices once from
// L2: at B 256 that is 64 blocks, each reading 5 MB of weights. The products
// are fp32 FMA loops (common.cuh::gemm_rows), so this version is bound by the
// latency of those L2 reads rather than by device memory.

#include "common.cuh"

namespace {

using namespace eid;

constexpr int kThreads = 512;
constexpr int kRows = 4;  // rows per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
    projection_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wi,
                          const T* __restrict__ bi, const T* __restrict__ wr,
                          const T* __restrict__ br, const T* __restrict__ ln_s,
                          const T* __restrict__ ln_b, float* __restrict__ out,
                          int B, int Din, int Dout) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* a = reinterpret_cast<float*>(smem);                   // rows x Dout
  T* xs = reinterpret_cast<T*>(smem + align16((size_t)kRows * Dout * 4));
  // xs holds the x rows (rows x Din), then g (rows x Dout)
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, B - r0);

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
        a[i * Dout + n] = a[i * Dout + n] + (acc + to_f(br[n]));
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

template <typename T>
int launch(const void* x, const void* const* w, void* out, int B, int Din,
           int Dout, size_t smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      projection_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + kRows - 1) / kRows;
  projection_fwd_kernel<T><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w[0]),
      static_cast<const T*>(w[1]), static_cast<const T*>(w[2]),
      static_cast<const T*>(w[3]), static_cast<const T*>(w[4]),
      static_cast<const T*>(w[5]), static_cast<float*>(out), B, Din, Dout);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, Din) in dtype; w: wi (Din, Dout), bi, wr (Dout, Dout), br, ln_s,
// ln_b, all contiguous in dtype; out: (B, Dout) float32.
extern "C" int eid_projection_fwd(int dtype, const void* x,
                                  const void* const* w, void* out, int B,
                                  int Din, int Dout, void* stream) {
  if (B <= 0) return 0;
  const size_t sz = dtype == kBF16 ? 2 : 4;
  const size_t x_elems = (size_t)(Din > Dout ? Din : Dout) * kRows;
  const size_t smem = align16((size_t)kRows * Dout * 4) + x_elems * sz;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, w, out, B, Din, Dout, smem, s);
  if (dtype == kF32) return launch<float>(x, w, out, B, Din, Dout, smem, s);
  return (int)cudaErrorInvalidValue;
}

// Message for a CUDA error code returned by the launchers above.
extern "C" const char* eid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
