// Backward of stage 1 of the ATM-S tsconv stack (the folded 75-tap,
// stride-5 correlation of csrc/tsconv_fwd.cu).
//
// Replaces the TPU kernel eeg_image_decode_tpu/ops/tsconv.py::
// _tsconv_bwd_kernel (launched by _tsconv_bwd_pallas):
//
//   dx[r, t]  = sum_p sum_f g[r, p*F + f] * w~[t - p*stride, f]    (fp32)
//   dw~[m, f] = sum_r sum_p x[r, p*stride + m] * g[r, p*F + f]     (fp32)
//
// over the rows r of the (B*C, T) input, with g and w~ in the working type
// and fp32 accumulation. The windows overlap (stride 5 < 75 taps), so dx is
// gathered per output sample, never scattered. Writing t = q*stride + j,
// the positions covering t are p = q - d (d = 0 .. ceil(M/stride) - 1)
// with tap m = d*stride + j, so one g[r, p, f] value serves the `stride`
// outputs q*stride .. q*stride + stride-1 at once: a thread owns two
// consecutive q of one row, all their residues j (2 x stride fp32
// accumulators), and per (d, f) loads 2 g and `stride` w~ values for
// 2*stride FMAs. dw~ is summed per block in registers over the block's
// rows, a 3-tap by 4-filter tile per thread (7 loads for 12 FMAs per
// (row, position)), written as one fp32 partial per block, and the partials
// are added in a fixed order (reduce.cuh::sum_rows): no atomics, so two
// runs agree bit for bit. The TPU kernel carried dw~ across its sequential
// grid instead.
//
// Each block walks its rows in slabs of 8: x (8 x T) and g (8 x P x (F+1))
// as fp32 in shared memory, and w~ as fp32 (rows padded to F + 1 floats and
// zero rows up to a multiple of the stride). The odd row pitch keeps the
// lanes of a warp, which read positions two apart, on different banks.
//
// Bound on the H100 (ATM-S, B 1024: 64,512 rows, T 250, M 75, F 40, P 36):
// x and g in bf16 read once and dx written once in fp32 move 283 MB
// (~0.085 ms at 3.35 TB/s); the two sums are 28 GFLOP (~0.03 ms at the bf16
// tensor-core peak), so the backward is memory-bound. This version runs the
// sums as fp32 FMA loops, bound by shared-memory loads, and reads and
// writes each byte of device memory once.

#include "common.cuh"
#include "reduce.cuh"

namespace {

using namespace eid;

constexpr int kThreads = 256;
constexpr int kSlab = 8;       // rows of x and g in shared memory at a time
constexpr int kMaxStride = 8;  // dx residues per thread (the pool stride)
constexpr int kTM = 3, kTF = 4;  // dw~ tile per thread: taps x filters
constexpr int kMaxBlocks = 528;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tsconv_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const T* __restrict__ w, float* __restrict__ dx,
                      float* __restrict__ part, int rows, int Tn, int M,
                      int F, int P, int stride, int rows_per_block) {
  extern __shared__ __align__(16) float sm[];
  const int Fw = F + 1, PF = P * F;
  const int Dt = (M + stride - 1) / stride;  // positions covering one t
  const int Q = (Tn + stride - 1) / stride, QP = (Q + 1) / 2;
  const int MT = (M + kTM - 1) / kTM, FT = (F + kTF - 1) / kTF;
  float* ws = sm;                       // Dt*stride x (F + 1), zero-padded
  float* xs = ws + Dt * stride * Fw;    // kSlab x Tn
  float* gs = xs + kSlab * Tn;          // kSlab x P x (F + 1)
  const int tid = threadIdx.x;
  for (int i = tid; i < Dt * stride * Fw; i += blockDim.x) {
    const int m = i / Fw, f = i - m * Fw;
    ws[i] = m < M && f < F ? to_f(w[m * F + f]) : 0.f;
  }
  // this thread's dw~ tile (tid < MT * FT): taps m0.., filters f0..
  const bool dw_owner = tid < MT * FT;
  const int m0 = (tid % MT) * kTM, f0 = (tid / MT) * kTF;
  float acc[kTM][kTF];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int k = 0; k < kTF; ++k) acc[i][k] = 0.f;

  const int r_begin = blockIdx.x * rows_per_block;
  const int r_end = min(rows, r_begin + rows_per_block);
  for (int r0 = r_begin; r0 < r_end; r0 += kSlab) {
    const int nr = min(kSlab, r_end - r0);
    __syncthreads();  // the previous slab is consumed (and w~ is loaded)
    for (int i = tid; i < nr * Tn; i += blockDim.x)
      xs[i] = to_f(x[(long)r0 * Tn + i]);
    for (int i = tid; i < nr * PF; i += blockDim.x) {
      const int r = i / PF, e = i - r * PF, p = e / F, f = e - p * F;
      gs[(r * P + p) * Fw + f] = to_f(g[(long)r0 * PF + i]);
    }
    __syncthreads();
    // dw~[m, f] += x[r, p*stride + m] * g[r, p, f]
    if (dw_owner) {
      for (int r = 0; r < nr; ++r) {
        const float* xr = xs + r * Tn;
        const float* gr = gs + r * P * Fw;
        for (int p = 0; p < P; ++p) {
          float xv[kTM], gv[kTF];
#pragma unroll
          for (int i = 0; i < kTM; ++i)  // tiles past M or F read valid data
            xv[i] = xr[p * stride + min(m0 + i, M - 1)];
#pragma unroll
          for (int k = 0; k < kTF; ++k) gv[k] = gr[p * Fw + min(f0 + k, F - 1)];
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int k = 0; k < kTF; ++k)
              acc[i][k] = fmaf(xv[i], gv[k], acc[i][k]);
        }
      }
    }
    // dx[r, q*stride + j] for q = q0, q0 + 1 and every residue j
    for (int item = tid; item < nr * QP; item += blockDim.x) {
      const int r = item / QP, q0 = 2 * (item - r * QP);
      const float* gr = gs + r * P * Fw;
      float out[2][kMaxStride];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < kMaxStride; ++j) out[a][j] = 0.f;
      for (int d = 0; d < Dt; ++d) {
        const int pa = q0 - d, pb = pa + 1;
        const bool va = pa >= 0 && pa < P, vb = pb >= 0 && pb < P;
        if (!va && !vb) continue;
        const float* ga = gr + (va ? pa : 0) * Fw;
        const float* gb = gr + (vb ? pb : 0) * Fw;
        const float sa = va ? 1.f : 0.f, sb = vb ? 1.f : 0.f;
        const float* wd = ws + d * stride * Fw;
        for (int f = 0; f < F; ++f) {
          const float a = sa * ga[f], bv = sb * gb[f];
#pragma unroll
          for (int j = 0; j < kMaxStride; ++j) {
            if (j >= stride) break;
            const float wv = wd[j * Fw + f];
            out[0][j] = fmaf(a, wv, out[0][j]);
            out[1][j] = fmaf(bv, wv, out[1][j]);
          }
        }
      }
      float* dr = dx + (long)(r0 + r) * Tn;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < kMaxStride; ++j) {
          const int t = (q0 + a) * stride + j;
          if (j < stride && t < Tn) dr[t] = out[a][j];
        }
    }
  }
  if (dw_owner) {
    float* out = part + (long)blockIdx.x * M * F;
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int k = 0; k < kTF; ++k)
        if (m0 + i < M && f0 + k < F) out[(m0 + i) * F + f0 + k] = acc[i][k];
  }
}

int n_blocks(int rows) {
  const int slabs = (rows + kSlab - 1) / kSlab;
  return slabs < kMaxBlocks ? slabs : kMaxBlocks;
}

template <typename T>
int launch(const void* x, const void* g, const void* w, float* dx, float* dw,
           float* part, int rows, int Tn, int M, int F, int P, int stride,
           cudaStream_t s) {
  const int Dt = (M + stride - 1) / stride;
  const size_t smem = ((size_t)Dt * stride * (F + 1) + (size_t)kSlab * Tn +
                       (size_t)kSlab * P * (F + 1)) *
                      sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      tsconv_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = n_blocks(rows);
  int per = (rows + blocks - 1) / blocks;
  per = (per + kSlab - 1) / kSlab * kSlab;
  tsconv_bwd_kernel<T><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(w), dx, part, rows, Tn, M, F, P, stride, per);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)sum_rows(part, blocks, (long)M * F, 1, dw, s);
}

}  // namespace

// Bytes of device workspace eid_tsconv_bwd needs (the per-block partials).
extern "C" long long eid_tsconv_bwd_workspace(int rows, int M, int F) {
  return (long long)n_blocks(rows) * M * F * (long long)sizeof(float);
}

// x: (rows, Tn), g: (rows, P*F), w: (M, F), all contiguous in dtype; dx:
// (rows, Tn) fp32; dw: (M, F) fp32; ws: eid_tsconv_bwd_workspace bytes.
extern "C" int eid_tsconv_bwd(int dtype, const void* x, const void* g,
                              const void* w, float* dx, float* dw, void* ws,
                              int rows, int Tn, int M, int F, int P,
                              int stride, void* stream) {
  if (rows <= 0) return 0;
  const int tiles = ((M + kTM - 1) / kTM) * ((F + kTF - 1) / kTF);
  if (P <= 0 || (P - 1) * stride + M > Tn || stride > kMaxStride ||
      tiles > kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(ws);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, g, w, dx, dw, part, rows, Tn, M, F, P,
                                 stride, s);
  if (dtype == kF32)
    return launch<float>(x, g, w, dx, dw, part, rows, Tn, M, F, P, stride, s);
  return (int)cudaErrorInvalidValue;
}
