// Stage 1 of the ATM-S tsconv stack: a 25-tap temporal conv and a 51-wide,
// stride-5 average pool folded into one 75-tap, stride-5 correlation.
//
// Replaces the TPU kernel eeg_image_decode_tpu/ops/tsconv.py::_tsconv_kernel
// (launched by _tsconv_pallas):
//
//   out[r, p*F + f] = sum_{m < M} x[r, p*stride + m] * w~[m, f]
//
// over rows r of the (B*C, T) input, fp32 accumulation, output rounded once
// to the working type. The TPU kernel ran it as P per-position MXU products;
// here each block stages 32 rows of x and all of w~ in shared memory (as
// fp32) and each thread computes a 4-position by 4-filter register tile of
// one row: per tap it reads four x values (one per position) and one
// 16-byte vector of w~, for 16 FMAs.
//
// Bound on the H100 (ATM-S, B 256: 16,128 rows of T 250, M 75, F 40,
// P 36): 1.74 GFMA (3.5 GFLOP, ~3.5 us at the bf16 tensor-core peak)
// against 8 MB read and 46 MB written in bf16 (~16 us at 3.35 TB/s), so the
// stage is memory-bound on its output. This FMA version is bound by the
// shared-memory and FMA issue rate instead; writing each output once and
// reading each input once is what it keeps of the bound.

#include "common.cuh"

namespace {

using namespace eid;

constexpr int kThreads = 256;
constexpr int kRows = 32;  // rows of x per block
constexpr int kTP = 4;     // output positions per thread
constexpr int kTF = 4;     // filters per thread (one float4 of w~)

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tsconv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      T* __restrict__ out, int rows, int Tn, int M, int F,
                      int P, int stride) {
  extern __shared__ __align__(16) float sm[];
  const int Fp = (F + kTF - 1) / kTF * kTF;  // w~ row padded with zeros
  float* ws = sm;                            // M x Fp
  float* xs = sm + M * Fp;                   // kRows x Tn
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, rows - r0);

  for (int i = threadIdx.x; i < M * Fp; i += blockDim.x) {
    const int m = i / Fp, f = i - m * Fp;
    ws[i] = f < F ? to_f(w[m * F + f]) : 0.f;
  }
  const T* xb = x + (long)r0 * Tn;
  for (int i = threadIdx.x; i < nr * Tn; i += blockDim.x) xs[i] = to_f(xb[i]);
  __syncthreads();

  const int n_pg = (P + kTP - 1) / kTP;
  const int n_fg = Fp / kTF;
  T* ob = out + (long)r0 * P * F;
  for (int item = threadIdx.x; item < nr * n_pg * n_fg; item += blockDim.x) {
    const int fg = item % n_fg;
    const int t = item / n_fg;
    const int pg = t % n_pg;
    const int r = t / n_pg;
    const int p0 = pg * kTP;
    const int np = min(kTP, P - p0);
    const float* xr = xs + r * Tn + p0 * stride;
    const float* wc = ws + fg * kTF;
    float acc[kTP][kTF];
#pragma unroll
    for (int j = 0; j < kTP; ++j)
#pragma unroll
      for (int q = 0; q < kTF; ++q) acc[j][q] = 0.f;
#pragma unroll 5
    for (int m = 0; m < M; ++m) {
      const float4 wv = *reinterpret_cast<const float4*>(wc + m * Fp);
#pragma unroll
      for (int j = 0; j < kTP; ++j) {
        const float xv = j < np ? xr[j * stride + m] : 0.f;
        acc[j][0] = fmaf(xv, wv.x, acc[j][0]);
        acc[j][1] = fmaf(xv, wv.y, acc[j][1]);
        acc[j][2] = fmaf(xv, wv.z, acc[j][2]);
        acc[j][3] = fmaf(xv, wv.w, acc[j][3]);
      }
    }
    T* orow = ob + (long)r * P * F;
#pragma unroll
    for (int j = 0; j < kTP; ++j) {
      if (j >= np) break;
#pragma unroll
      for (int q = 0; q < kTF; ++q) {
        const int f = fg * kTF + q;
        if (f < F) orow[(p0 + j) * F + f] = from_f<T>(acc[j][q]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int rows, int Tn, int M,
           int F, int P, int stride, size_t smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      tsconv_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (rows + kRows - 1) / kRows;
  tsconv_fwd_kernel<T><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      rows, Tn, M, F, P, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (rows, Tn), w: (M, F), out: (rows, P*F), all contiguous in dtype, with
// P = (Tn - M) / stride + 1.
extern "C" int eid_tsconv_fwd(int dtype, const void* x, const void* w,
                              void* out, int rows, int Tn, int M, int F,
                              int P, int stride, void* stream) {
  if (rows <= 0) return 0;
  if (P <= 0 || (P - 1) * stride + M > Tn) return (int)cudaErrorInvalidValue;
  const int Fp = (F + kTF - 1) / kTF * kTF;
  const size_t smem = ((size_t)M * Fp + (size_t)kRows * Tn) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, w, out, rows, Tn, M, F, P, stride, smem, s);
  if (dtype == kF32)
    return launch<float>(x, w, out, rows, Tn, M, F, P, stride, smem, s);
  return (int)cudaErrorInvalidValue;
}
