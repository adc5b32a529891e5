// Deterministic cross-block reductions of the backward kernels.
//
// The TPU backward kernels sum their parameter gradients over a sequential
// grid (dimension_semantics "arbitrary"). Blocks on the H100 run in no
// order, so each gradient here is a two-pass sum in a fixed order, with no
// float atomics: two runs of a step agree bit for bit.
//
// atb_partial_kernel: part[s][a][y] = sum over rows n of chunk s of
//   A[n, a] * Y[n, y] (A: N x Ka, Y: N x Ky, both row-major in the working
//   type, fp32 accumulation). A 64 x 64 output tile per block, 32-row slabs
//   of A and Y staged in shared memory as fp32, a 4 x 4 register tile per
//   thread; the rows of a chunk are summed in order.
// sum_rows_kernel: out[c][j] = sum over rows r of chunk c of in[r][j], rows
//   in order. It adds the chunks' partials (or per-sample partial vectors).
#pragma once

#include "common.cuh"

namespace eid {

// The kernels are templates (and the host helpers inline), so several
// sources may include this header and still link.
constexpr int kAtbTile = 64;
constexpr int kAtbSlab = 32;
constexpr int kAtbThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kAtbThreads)
    atb_partial_kernel(const T* __restrict__ A, int lda,
                       const T* __restrict__ Y, int ldy, int Ka, int Ky,
                       long N, long chunk, float* __restrict__ part) {
  __shared__ __align__(16) float as[kAtbSlab][kAtbTile];
  __shared__ __align__(16) float ys[kAtbSlab][kAtbTile];
  const int y0 = blockIdx.x * kAtbTile, a0 = blockIdx.y * kAtbTile;
  const long n_begin = (long)blockIdx.z * chunk;
  const long n_end = min(N, n_begin + chunk);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4] = {};
  for (long n0 = n_begin; n0 < n_end; n0 += kAtbSlab) {
    for (int i = threadIdx.x; i < kAtbSlab * kAtbTile; i += kAtbThreads) {
      const int r = i / kAtbTile, c = i - r * kAtbTile;
      const long n = n0 + r;
      const bool row_ok = n < n_end;
      as[r][c] = row_ok && a0 + c < Ka ? to_f(A[n * lda + a0 + c]) : 0.f;
      ys[r][c] = row_ok && y0 + c < Ky ? to_f(Y[n * ldy + y0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kAtbSlab; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 yv = *reinterpret_cast<const float4*>(&ys[k][tx * 4]);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float y[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], y[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + (long)blockIdx.z * Ka * Ky;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = a0 + ty * 4 + i;
    if (a >= Ka) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int y = y0 + tx * 4 + j;
      if (y < Ky) out[(long)a * Ky + y] = acc[i][j];
    }
  }
}

template <typename TIn>
__global__ void sum_rows_kernel(const TIn* __restrict__ in, long rows,
                                long cols, long rows_per_chunk,
                                float* __restrict__ out) {
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  const long r0 = (long)blockIdx.y * rows_per_chunk;
  const long r1 = min(rows, r0 + rows_per_chunk);
  float s = 0.f;
  for (long r = r0; r < r1; ++r) s += to_f(in[r * cols + j]);
  out[(long)blockIdx.y * cols + j] = s;
}

// out[c] (chunks x cols) = the in-order sums of `rows_per_chunk` rows each.
inline cudaError_t sum_rows(const float* in, long rows, long cols,
                            int chunks, float* out, cudaStream_t s) {
  const long per = (rows + chunks - 1) / chunks;
  dim3 grid((unsigned)((cols + 255) / 256), (unsigned)chunks);
  sum_rows_kernel<float><<<grid, 256, 0, s>>>(in, rows, cols, per, out);
  return cudaGetLastError();
}

// dW (Ka x Ky, fp32) = A^T Y over N rows: `chunks` partial products, then
// their in-order sum. part holds chunks x Ka x Ky floats.
template <typename T>
cudaError_t atb(const T* A, int lda, const T* Y, int ldy, int Ka, int Ky,
                long N, int chunks, float* part, float* out, cudaStream_t s) {
  long chunk = (N + chunks - 1) / chunks;
  chunk = (chunk + kAtbSlab - 1) / kAtbSlab * kAtbSlab;
  dim3 grid((unsigned)((Ky + kAtbTile - 1) / kAtbTile),
            (unsigned)((Ka + kAtbTile - 1) / kAtbTile), (unsigned)chunks);
  atb_partial_kernel<T><<<grid, kAtbThreads, 0, s>>>(A, lda, Y, ldy, Ka, Ky,
                                                      N, chunk, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return sum_rows(part, chunks, (long)Ka * Ky, 1, out, s);
}

}  // namespace eid
