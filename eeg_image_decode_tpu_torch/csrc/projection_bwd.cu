// Backward of the ATM-S projection head, in its three dropout modes.
//
// Replaces the TPU kernel eeg_image_decode_tpu/ops/projection.py::_bwd_kernel
// (launched by _run_bwd). Point for point as that kernel: recompute
//
//   a = x Wi + bi (fp32);  g, g' = gelu_tanh(a) and its derivative
//   gdt = g rounded to the working type;  z = (gdt Wr + br) * m (fp32)
//   r = a + z;  mu, inv (two-pass biased variance, eps 1e-6);  xhat
//
// then, with the cotangent g_out (B, d_out) in fp32,
//
//   dln_s = sum_rows g_out * xhat;   dln_b = sum_rows g_out
//   gxh = g_out * ln_s;  d_r = (gxh - mean(gxh) - xhat * mean(gxh * xhat)) * inv
//   d_z = d_r * m;       dbr = sum_rows d_z (fp32)
//   dWr = gdt^T rnd(d_z);            d_g = rnd(d_z) Wr^T
//   d_a = d_r + d_g * g';            dbi = sum_rows d_a (fp32)
//   dWi = x^T rnd(d_a);              dx = rnd(d_a) Wi^T, in x's type
//
// where rnd rounds to the working type (the operands of the four products)
// and m is the keep-mask: 1, read in the working type and widened (mode 1),
// or redrawn by philox.cuh, site 4, keyed (seed, global row), value 1/keep in
// fp32 (mode 2): the bits of the forward, under any tiling.
//
// Two designs, chosen by dtype in the launcher (eid_projection_bwd_design
// names the one a dtype takes):
//
// bfloat16, "mma_bf16": the six products on the tensor cores
// (mma_tile.cuh::gemm_tile: 64 x 128 output tiles, the operand slices staged
// once per tile through a cp.async ring, fp32 accumulators). LayerNorm needs
// a whole row of r and d_g a whole row of d_z, so one block cannot own a
// narrow column tile of the whole chain: the chain is un-fused into five
// launches with fused epilogues, the first two the forward's own
// (projection_chain.cuh, launched by projection_fwd.cu's launch_chain_fwd),
//   1. a = x Wi + bi            -> a (fp32), gdt = rnd(gelu(a))
//   2. z = (gdt Wr + br) * m    -> r = a + z (fp32); m read, or redrawn per
//                                  (seed, row, column), whatever the tiling
//   3. rows: LayerNorm statistics, d_r (fp32, over r in place), rnd(d_z), and
//      per block of 8 rows the column sums of dln_s, dln_b, dbr
//   4. d_a = d_r + (d_z Wr^T) g'(a) -> d_a (fp32, over d_r in place), rnd(d_a)
//   5. dx = d_a Wi^T, dWr = gdt^T d_z, dWi = x^T d_a: three products' tiles
//      in one grid (504 tiles at B 1024)
//   6. the four vector gradients: 16 chunk sums of the per-block vectors
//      and of d_a (dbi), then reduce.cuh::sum_rows over the chunks
// all in a fixed order. a, r, d_r, d_a cross kernels in fp32; gdt, d_z,
// d_a for the products in bf16, exactly where the TPU kernel rounds. The
// intermediates (2-4 MB each) live in L2. Each dW tile sums all B rows in one
// block in a fixed order: no split-K partials, no second pass, no atomics, a
// rerun is bit-equal. Wr^T and Wi^T are never materialised: ldmatrix reads
// Wr and Wi as the K-major B operand of d_z Wr^T and d_a Wi^T, and x and gdt
// through ldmatrix.trans as the A operand of the dW products. Rows past B
// and widths that are no multiple of the tile are zero-filled in shared
// memory and masked on store; leading dimensions that are no multiple of 16
// bytes (150, 100) take mma_tile.cuh's guarded loads.
//
// float32, "fma_fp32": the tensor cores would round fp32 operands to TF32, so
// fp32 keeps full-fp32 FMA products, the first version of this file:
// 1. projection_bwd_rows_kernel: 4 rows per block, 512 threads, the four
//    products that lead to dx as warp-tiled FMA loops (common.cuh::gemm_rows)
//    over shared-memory rows. It writes dx, the operands gdt, d_z, d_a and,
//    per block, the column sums of its rows for the four vector gradients.
// 2. reduce.cuh: dWr = gdt^T d_z and dWi = x^T d_a over the B rows, as
//    ceil(B / 512) split-K chunks (at most 8) summed in order, and the
//    per-block vector sums added in a fixed order.
//    This path is handed Wr^T and Wi^T as contiguous copies, made by the
//    wrapper, so the lanes of a warp read neighbouring addresses.
//
// Bound on the H100 (B 1024, d_in 1440, d_out 1024): recompute 5.2 GFLOP,
// dWr and d_g 2.1 each, dWi and dx 3.0 each: 15.5 GFLOP, 0.016 ms at the bf16
// tensor-core peak (0.23 ms in fp32), against ~25 MB of traffic (0.0075 ms):
// bound by operations. What is left above the bound in bf16 is the launch
// chain (nine short launches) and mma.sync's rate below wgmma's.

#include "common.cuh"
#include "mma_tile.cuh"
#include "philox.cuh"
#include "projection_chain.cuh"
#include "reduce.cuh"

namespace {

using namespace eid;

constexpr int kThreads = 512;
constexpr int kRows = 4;      // rows per block
constexpr int kMaxChunks = 8; // split-K chunks of the dW products, at most
constexpr int kVecChunks = 16;
constexpr int kNVec = 4;      // dbi, dbr, dln_s, dln_b

struct Args {
  const void* x;
  const float* g;
  const void* w[6];   // wi bi wr br ln_s ln_b
  const void* wi_t;   // (Dout, Din)
  const void* wr_t;   // (Dout, Dout)
  void* dx;
  void* gdt;          // (B, Dout)
  void* dz;           // (B, Dout)
  void* da;           // (B, Dout)
  float* vpart;       // (blocks, 4, Dout)
  int B, Din, Dout;
  int mode;
  const void* mask;
  const int* seed;
  uint32_t thresh;
  float inv_keep;
  uint32_t sample0;
};

struct Smem {
  size_t f0, f1, f2, stats, xs, gs, dzs, das, total;
};

__host__ __device__ inline Smem smem_layout(int Din, int Dout, size_t sz) {
  Smem l;
  const size_t f = align16((size_t)kRows * Dout * 4);
  const size_t t = align16((size_t)kRows * Dout * sz);
  l.f0 = 0;
  l.f1 = f;
  l.f2 = 2 * f;
  l.stats = 3 * f;
  l.xs = l.stats + align16((size_t)kRows * 4 * 4);
  l.gs = l.xs + align16((size_t)kRows * Din * sz);
  l.dzs = l.gs + t;
  l.das = l.dzs + t;
  l.total = l.das + t;
  return l;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    projection_bwd_rows_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Din = p.Din, Dout = p.Dout;
  const Smem l = smem_layout(Din, Dout, sizeof(T));
  float* F0 = reinterpret_cast<float*>(smem + l.f0);  // a, then r, then d_r
  float* F1 = reinterpret_cast<float*>(smem + l.f1);  // g', then d_a
  float* MF = reinterpret_cast<float*>(smem + l.f2);  // the mask factor
  float* stats = reinterpret_cast<float*>(smem + l.stats);  // mu inv m1 m2
  T* xs = reinterpret_cast<T*>(smem + l.xs);
  T* gs = reinterpret_cast<T*>(smem + l.gs);
  T* dzs = reinterpret_cast<T*>(smem + l.dzs);
  T* das = reinterpret_cast<T*>(smem + l.das);
  auto W = [&](int i) { return static_cast<const T*>(p.w[i]); };
  const T *wi = W(0), *bi = W(1), *wr = W(2), *br = W(3), *ln_s = W(4);
  const T* wi_t = static_cast<const T*>(p.wi_t);
  const T* wr_t = static_cast<const T*>(p.wr_t);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31;
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, p.B - r0);
  const uint32_t seed = p.mode == kDropSeed ? (uint32_t)*p.seed : 0u;
  const T* mask = static_cast<const T*>(p.mask);

  // ——— forward recompute ———
  const T* xb = static_cast<const T*>(p.x) + (long)r0 * Din;
  for (int i = tid; i < nr * Din; i += nthr) xs[i] = xb[i];
  __syncthreads();
  gemm_rows<kRows, 2, T, T>(
      xs, Din, nr, Din, Dout, Dout, [&](int n) { return wi + n; },
      [&](int i, int n, float acc) { F0[i * Dout + n] = acc + to_f(bi[n]); });
  __syncthreads();
  T* gdt = static_cast<T*>(p.gdt) + (long)r0 * Dout;
  for (int e = tid; e < nr * Dout; e += nthr) {
    const float a = F0[e];
    const T g = from_f<T>(gelu_tanh(a));
    gs[e] = g;
    gdt[e] = g;
    F1[e] = gelu_tanh_grad(a);
    const int i = e / Dout, n = e - i * Dout;
    float m = 1.f;
    if (p.mode == kDropMasks)
      m = to_f(mask[(long)(r0 + i) * Dout + n]);
    else if (p.mode == kDropSeed)
      m = keep_bits(seed, (uint32_t)(r0 + i) + p.sample0, kSiteProjection,
                    (uint32_t)n) < p.thresh
              ? p.inv_keep
              : 0.f;
    MF[e] = m;
  }
  __syncthreads();
  const bool drop = p.mode != kDropNone;
  gemm_rows<kRows, 2, T, T>(
      gs, Dout, nr, Dout, Dout, Dout, [&](int n) { return wr + n; },
      [&](int i, int n, float acc) {
        float z = acc + to_f(br[n]);
        if (drop) z = z * MF[i * Dout + n];
        F0[i * Dout + n] = F0[i * Dout + n] + z;
      });
  __syncthreads();

  // ——— LayerNorm statistics and the two row means of its backward ———
  for (int i = tid >> 5; i < nr; i += nthr >> 5) {
    const float* row = F0 + i * Dout;
    const float* go = p.g + (long)(r0 + i) * Dout;
    float mu, inv;
    row_mean_inv(row, Dout, 1e-6f, mu, inv);
    float s1 = 0.f, s2 = 0.f;
    for (int n = lane; n < Dout; n += 32) {
      const float gxh = go[n] * to_f(ln_s[n]);
      s1 += gxh;
      s2 += gxh * ((row[n] - mu) * inv);
    }
    s1 = warp_sum(s1) / (float)Dout;
    s2 = warp_sum(s2) / (float)Dout;
    if (lane == 0) {
      stats[i * 4 + 0] = mu;
      stats[i * 4 + 1] = inv;
      stats[i * 4 + 2] = s1;
      stats[i * 4 + 3] = s2;
    }
  }
  __syncthreads();

  // d_r (F0), d_z rounded (dzs, scratch), and this block's column sums of
  // dln_s, dln_b and dbr over its rows, in row order
  float* vp = p.vpart + (long)blockIdx.x * kNVec * Dout;
  T* dz = static_cast<T*>(p.dz) + (long)r0 * Dout;
  for (int n = tid; n < Dout; n += nthr) {
    const float s = to_f(ln_s[n]);
    float d_lns = 0.f, d_lnb = 0.f, d_br = 0.f;
    for (int i = 0; i < nr; ++i) {
      const int e = i * Dout + n;
      const float mu = stats[i * 4], inv = stats[i * 4 + 1];
      const float go = p.g[(long)(r0 + i) * Dout + n];
      const float xhat = (F0[e] - mu) * inv;
      d_lns += go * xhat;
      d_lnb += go;
      const float gxh = go * s;
      const float d_r =
          (gxh - stats[i * 4 + 2] - xhat * stats[i * 4 + 3]) * inv;
      const float d_z = drop ? d_r * MF[e] : d_r;
      d_br += d_z;
      F0[e] = d_r;
      const T d_zdt = from_f<T>(d_z);
      dzs[e] = d_zdt;
      dz[e] = d_zdt;
    }
    vp[1 * Dout + n] = d_br;
    vp[2 * Dout + n] = d_lns;
    vp[3 * Dout + n] = d_lnb;
  }
  __syncthreads();

  // d_a = d_r + (d_z Wr^T) * g' (fp32, F1)
  gemm_rows<kRows, 2, T, T>(
      dzs, Dout, nr, Dout, Dout, Dout, [&](int n) { return wr_t + n; },
      [&](int i, int n, float acc) {
        F1[i * Dout + n] = F0[i * Dout + n] + acc * F1[i * Dout + n];
      });
  __syncthreads();
  T* da = static_cast<T*>(p.da) + (long)r0 * Dout;
  for (int n = tid; n < Dout; n += nthr) {
    float d_bi = 0.f;
    for (int i = 0; i < nr; ++i) {
      const int e = i * Dout + n;
      const float d_a = F1[e];
      d_bi += d_a;
      const T d_adt = from_f<T>(d_a);
      das[e] = d_adt;
      da[e] = d_adt;
    }
    vp[n] = d_bi;
  }
  __syncthreads();

  // dx = d_a Wi^T, in x's type
  T* dx = static_cast<T*>(p.dx) + (long)r0 * Din;
  gemm_rows<kRows, 2, T, T>(
      das, Dout, nr, Dout, Din, Din, [&](int n) { return wi_t + n; },
      [&](int i, int n, float acc) { dx[(long)i * Din + n] = from_f<T>(acc); });
}

// ——— the bfloat16 chain on the tensor cores ———

using mma::bf16;
using proj::mask_factor;
using proj::n_tiles;
using proj::tile_origin;

constexpr int kRowsP = 8;  // rows per block of the row pass

// The forward chain's operands (r32 holds r, then d_r, then d_a) and the
// backward's own
struct ChainArgs : proj::ChainFwd {
  const float* g;
  const bf16* ln_s;
  bf16* dx;
  bf16 *dz, *da;  // (B, Dout), the rounded operands
  float* vpart;   // (row blocks, 3, Dout): dbr dln_s dln_b
  float *d_wi, *d_wr;
};

// 3. per block of kRowsP rows: LayerNorm statistics and the two row means of
// its backward (one warp per row), then d_r over r in place, rnd(d_z), and
// the block's column sums of dbr, dln_s, dln_b in row order
__global__ void __launch_bounds__(256)
    projection_bwd_ln_kernel(const ChainArgs p) {
  __shared__ float stats[kRowsP][4];  // mu inv m1 m2
  const int Dout = p.Dout;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kRowsP;
  const int nr = min(kRowsP, p.B - r0);
  const uint32_t seed = p.mode == kDropSeed ? (uint32_t)*p.seed : 0u;
  const bool drop = p.mode != kDropNone;
  if (warp < nr) {
    const float* row = p.r32 + (long)(r0 + warp) * Dout;
    const float* go = p.g + (long)(r0 + warp) * Dout;
    float mu, inv;
    row_mean_inv(row, Dout, 1e-6f, mu, inv);
    float s1 = 0.f, s2 = 0.f;
    for (int n = lane; n < Dout; n += 32) {
      const float gxh = go[n] * to_f(p.ln_s[n]);
      s1 += gxh;
      s2 += gxh * ((row[n] - mu) * inv);
    }
    s1 = warp_sum(s1) / (float)Dout;
    s2 = warp_sum(s2) / (float)Dout;
    if (lane == 0) {
      stats[warp][0] = mu;
      stats[warp][1] = inv;
      stats[warp][2] = s1;
      stats[warp][3] = s2;
    }
  }
  __syncthreads();
  float* vp = p.vpart + (long)blockIdx.x * 3 * Dout;
  for (int n = tid; n < Dout; n += blockDim.x) {
    const float s = to_f(p.ln_s[n]);
    float d_lns = 0.f, d_lnb = 0.f, d_br = 0.f;
    for (int i = 0; i < nr; ++i) {
      const long e = (long)(r0 + i) * Dout + n;
      const float mu = stats[i][0], inv = stats[i][1];
      const float go = p.g[e];
      const float xhat = (p.r32[e] - mu) * inv;
      d_lns += go * xhat;
      d_lnb += go;
      const float gxh = go * s;
      const float d_r = (gxh - stats[i][2] - xhat * stats[i][3]) * inv;
      const float d_z = drop ? d_r * mask_factor(p, seed, r0 + i, n) : d_r;
      d_br += d_z;
      p.r32[e] = d_r;
      p.dz[e] = __float2bfloat16(d_z);
    }
    vp[n] = d_br;
    vp[Dout + n] = d_lns;
    vp[2 * Dout + n] = d_lnb;
  }
}

// 4. d_a = d_r + (d_z Wr^T) * g'(a), over d_r in place, and rnd(d_a)
__global__ void __launch_bounds__(mma::kThreads)
    projection_bwd_da_kernel(const ChainArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int m0, n0;
  tile_origin(blockIdx.x, p.Dout, m0, n0);
  // B(k, n) = Wr[n][k]: Wr as it lies is the K-major operand
  mma::gemm_tile<true, true>(
      p.dz, p.Dout, p.wr, p.Dout, p.B, p.Dout, p.Dout, m0, n0, smem,
      [&](int r, int c, float acc) {
        const long e = (long)r * p.Dout + c;
        const float d_a = p.r32[e] + acc * gelu_tanh_grad(p.a32[e]);
        p.r32[e] = d_a;
        p.da[e] = __float2bfloat16(d_a);
      });
}

// 5. the tiles of dx = d_a Wi^T, then of dWr = gdt^T d_z, then of dWi = x^T
// d_a, in one grid
__global__ void __launch_bounds__(mma::kThreads, 4)  // 64 registers
    projection_bwd_out_kernel(const ChainArgs p, int dx_tiles, int wr_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  int tile = blockIdx.x, m0, n0;
  if (tile < dx_tiles) {
    tile_origin(tile, p.Din, m0, n0);
    mma::gemm_tile<true, true>(
        p.da, p.Dout, p.wi, p.Dout, p.B, p.Din, p.Dout, m0, n0, smem,
        [&](int r, int c, float acc) {
          p.dx[(long)r * p.Din + c] = __float2bfloat16(acc);
        });
    return;
  }
  tile -= dx_tiles;
  if (tile < wr_tiles) {
    tile_origin(tile, p.Dout, m0, n0);
    mma::gemm_tile<false, false>(
        p.gdt, p.Dout, p.dz, p.Dout, p.Dout, p.Dout, p.B, m0, n0, smem,
        [&](int r, int c, float acc) {
          p.d_wr[(long)r * p.Dout + c] = acc;
        });
    return;
  }
  tile -= wr_tiles;
  tile_origin(tile, p.Dout, m0, n0);
  mma::gemm_tile<false, false>(
      p.x, p.Din, p.da, p.Dout, p.Din, p.Dout, p.B, m0, n0, smem,
      [&](int r, int c, float acc) { p.d_wi[(long)r * p.Dout + c] = acc; });
}

// 6. the first pass of the four vector gradients: chunk c's in-order sums,
// out[c] = [dbi dbr dln_s dln_b]. dbi sums the fp32 d_a over chunk c of the
// B rows; the other three sum the row blocks' vectors over chunk c of the
// blocks.
__global__ void projection_bwd_vec_kernel(const ChainArgs p, int blocks,
                                          float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= kNVec * p.Dout) return;
  const bool bias = j < p.Dout;
  const float* in = bias ? p.r32 + j : p.vpart + (j - p.Dout);
  const long pitch = bias ? p.Dout : 3L * p.Dout;
  const long rows = bias ? p.B : blocks;
  const long per = (rows + kVecChunks - 1) / kVecChunks;
  const long r0 = blockIdx.y * per, r1 = min(rows, r0 + per);
  float s = 0.f;
  for (long r = r0; r < r1; ++r) s += in[r * pitch];
  out[(long)blockIdx.y * kNVec * p.Dout + j] = s;
}

// ——— workspace layout (shared by the size query and the launch) ———

struct Layout {
  int blocks, chunks;
  size_t gdt, dz, da, a32, r32, vpart, vtmp, part, total;
};

size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

Layout layout(int dtype, long B, int Din, int Dout) {
  const bool tc = dtype == kBF16;
  const size_t sz = tc ? 2 : 4;
  Layout l;
  const int rows = tc ? kRowsP : kRows;
  l.blocks = (int)((B + rows - 1) / rows);
  const long c = (B + 511) / 512;
  l.chunks = (int)(c < 1 ? 1 : (c > kMaxChunks ? kMaxChunks : c));
  size_t o = 0;
  auto take = [&](size_t bytes) {
    const size_t at = o;
    o += align256(bytes);
    return at;
  };
  const size_t act = (size_t)B * Dout * sz;
  l.gdt = take(act);
  l.dz = take(act);
  l.da = take(act);
  l.a32 = take(tc ? (size_t)B * Dout * 4 : 0);
  l.r32 = take(tc ? (size_t)B * Dout * 4 : 0);
  l.vpart = take((size_t)l.blocks * kNVec * Dout * 4);
  l.vtmp = take((size_t)kVecChunks * kNVec * Dout * 4);
  // split-K partials of the fp32 path's dW products; the bf16 path has none
  const size_t big = (size_t)(Din > Dout ? Din : Dout) * Dout;
  l.part = take(tc ? 0 : (size_t)l.chunks * big * 4);
  l.total = o;
  return l;
}

template <typename T>
int launch(const Layout& l, Args a, unsigned char* ws, float* const* out,
           size_t smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      projection_bwd_rows_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  projection_bwd_rows_kernel<T><<<(unsigned)l.blocks, kThreads, smem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  float* part = reinterpret_cast<float*>(ws + l.part);
  // dWi = x^T d_a;  dWr = gdt^T d_z (the partial buffer is reused in stream
  // order)
  e = atb<T>(static_cast<const T*>(a.x), a.Din, static_cast<const T*>(a.da),
             a.Dout, a.Din, a.Dout, a.B, l.chunks, part, out[0], s);
  if (e == cudaSuccess)
    e = atb<T>(static_cast<const T*>(a.gdt), a.Dout,
               static_cast<const T*>(a.dz), a.Dout, a.Dout, a.Dout, a.B,
               l.chunks, part, out[1], s);
  // dbi | dbr | dln_s | dln_b: the blocks' vectors summed in block order
  const long nv = (long)kNVec * a.Dout;
  float* vtmp = reinterpret_cast<float*>(ws + l.vtmp);
  if (e == cudaSuccess) e = sum_rows(a.vpart, l.blocks, nv, kVecChunks, vtmp, s);
  if (e == cudaSuccess) e = sum_rows(vtmp, kVecChunks, nv, 1, out[2], s);
  return (int)e;
}

#define EID_LAUNCHED()                        \
  do {                                        \
    const cudaError_t e_ = cudaGetLastError(); \
    if (e_ != cudaSuccess) return (int)e_;    \
  } while (0)

int launch_chain(const Layout& l, const ChainArgs& p, unsigned char* ws,
                 float* vec_out, cudaStream_t s) {
  const int act_tiles = n_tiles(p.B, p.Dout);
  const int dx_tiles = n_tiles(p.B, p.Din);
  const int wr_tiles = n_tiles(p.Dout, p.Dout);
  const int wi_tiles = n_tiles(p.Din, p.Dout);
  const int smem = mma::kSmemBytes;
  const int rc = proj::launch_chain_fwd(p, s);  // a, gdt, r
  if (rc != 0) return rc;
  projection_bwd_ln_kernel<<<l.blocks, 256, 0, s>>>(p);
  EID_LAUNCHED();
  projection_bwd_da_kernel<<<act_tiles, mma::kThreads, smem, s>>>(p);
  EID_LAUNCHED();
  projection_bwd_out_kernel<<<dx_tiles + wr_tiles + wi_tiles, mma::kThreads,
                              smem, s>>>(p, dx_tiles, wr_tiles);
  EID_LAUNCHED();
  // dbi | dbr | dln_s | dln_b in two fixed-order passes
  float* vtmp = reinterpret_cast<float*>(ws + l.vtmp);
  dim3 grid((unsigned)((kNVec * p.Dout + 255) / 256), kVecChunks);
  projection_bwd_vec_kernel<<<grid, 256, 0, s>>>(p, l.blocks, vtmp);
  EID_LAUNCHED();
  return (int)sum_rows(vtmp, kVecChunks, (long)kNVec * p.Dout, 1, vec_out, s);
}

bool supported(int dtype, int Din, int Dout) {
  if (Din <= 0 || Dout <= 0) return false;
  if (dtype == kBF16) return true;  // tiles guard every edge
  return dtype == kF32 && smem_layout(Din, Dout, 4).total <= kMaxSmem;
}

}  // namespace

// Which design a dtype takes: "mma_bf16" (tensor cores) or "fma_fp32".
extern "C" const char* eid_projection_bwd_design(int dtype) {
  return dtype == kBF16 ? "mma_bf16" : "fma_fp32";
}

// Bytes of device workspace eid_projection_bwd needs, or -1 for shapes it
// does not take.
extern "C" long long eid_projection_bwd_workspace(int dtype, int B, int Din,
                                                  int Dout) {
  if (!supported(dtype, Din, Dout)) return -1;
  return (long long)layout(dtype, B, Din, Dout).total;
}

// x, dx: (B, Din) in dtype; g: (B, Dout) float32; w: the six parameters in
// dtype (as eid_projection_fwd); wi_t (Dout, Din) and wr_t (Dout, Dout): the
// transposed weights, contiguous, read by the float32 design only (null for
// bfloat16); out (fp32): dWi (Din, Dout), dWr (Dout, Dout) and the vector
// [dbi dbr dln_s dln_b]; ws: eid_projection_bwd_workspace bytes. Dropout
// arguments as eid_projection_fwd's.
extern "C" int eid_projection_bwd(int dtype, const void* x, const float* g,
                                  const void* const* w, const void* wi_t,
                                  const void* wr_t, void* dx,
                                  float* const* out, void* ws, int B, int Din,
                                  int Dout, int drop_mode, const void* mask,
                                  const int* seed, unsigned thresh,
                                  float inv_keep, unsigned sample0,
                                  void* stream) {
  if (B <= 0) return 0;
  if (!supported(dtype, Din, Dout)) return (int)cudaErrorInvalidValue;
  if (drop_mode < kDropNone || drop_mode > kDropSeed ||
      (drop_mode == kDropMasks && mask == nullptr) ||
      (drop_mode == kDropSeed && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  const Layout l = layout(dtype, B, Din, Dout);
  unsigned char* base = static_cast<unsigned char*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    auto W = [&](int i) { return static_cast<const bf16*>(w[i]); };
    ChainArgs p;
    p.x = static_cast<const bf16*>(x);
    p.g = g;
    p.wi = W(0);
    p.bi = W(1);
    p.wr = W(2);
    p.br = W(3);
    p.ln_s = W(4);
    p.dx = static_cast<bf16*>(dx);
    p.gdt = reinterpret_cast<bf16*>(base + l.gdt);
    p.dz = reinterpret_cast<bf16*>(base + l.dz);
    p.da = reinterpret_cast<bf16*>(base + l.da);
    p.a32 = reinterpret_cast<float*>(base + l.a32);
    p.r32 = reinterpret_cast<float*>(base + l.r32);
    p.vpart = reinterpret_cast<float*>(base + l.vpart);
    p.d_wi = out[0];
    p.d_wr = out[1];
    p.B = B;
    p.Din = Din;
    p.Dout = Dout;
    p.mode = drop_mode;
    p.mask = static_cast<const bf16*>(mask);
    p.seed = seed;
    p.thresh = thresh;
    p.inv_keep = inv_keep;
    p.sample0 = sample0;
    return launch_chain(l, p, base, out[2], s);
  }
  if (wi_t == nullptr || wr_t == nullptr) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.g = g;
  for (int i = 0; i < 6; ++i) a.w[i] = w[i];
  a.wi_t = wi_t;
  a.wr_t = wr_t;
  a.dx = dx;
  a.gdt = base + l.gdt;
  a.dz = base + l.dz;
  a.da = base + l.da;
  a.vpart = reinterpret_cast<float*>(base + l.vpart);
  a.B = B;
  a.Din = Din;
  a.Dout = Dout;
  a.mode = drop_mode;
  a.mask = mask;
  a.seed = seed;
  a.thresh = thresh;
  a.inv_keep = inv_keep;
  a.sample0 = sample0;
  return launch<float>(l, a, base, out, smem_layout(Din, Dout, 4).total, s);
}
