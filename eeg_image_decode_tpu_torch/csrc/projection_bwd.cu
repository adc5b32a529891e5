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
// Design (two passes, no float atomics: a rerun is bit-equal). The TPU kernel
// sums the six parameter gradients over a sequential grid; blocks here run in
// no order.
// 1. projection_bwd_rows_kernel: 4 rows per block, 512 threads, the four
//    products that lead to dx as warp-tiled FMA loops (common.cuh::gemm_rows)
//    over shared-memory rows. Rows past B are guarded, never padded. It
//    writes dx, the rounded operands gdt, d_z, d_a (3 x B x d_out in the
//    working type, 6 MB in bf16 at B 1024) and, per block, the column sums of
//    its rows for the four vector gradients (fp32).
// 2. reduce.cuh: dWr = gdt^T d_z and dWi = x^T d_a over the B rows, as
//    ceil(B / 512) split-K chunks (at most 8) summed in order: at B 1024 the
//    23 x 16 output tiles of dWi already fill the card, so two chunks, 12 MB
//    of partials. The per-block vector sums are added in a fixed order.
//
// Transposed weights: d_g and dx contract over the second axis of Wr and Wi.
// The launcher is handed Wr^T and Wi^T as contiguous copies, made once per
// backward by the wrapper (5 MB read and written in bf16, ~0.01 ms), so the
// lanes of a warp read neighbouring addresses as in the forward products.
//
// Shared memory per block (4 rows, d_in 1440, d_out 1024): x (4 x 1440) and
// gdt, d_z, d_a (4 x 1024 each) in the working type, and three fp32 buffers
// of 4 x 1024 (a -> r -> d_r; g' -> d_a; the mask factor): 83 KB in bf16,
// 118 KB in fp32.
//
// Bound on the H100 (B 1024): recompute 5.2 GFLOP, dWr and d_g 2.1 each, dWi
// and dx 3.0 each: 15.5 GFLOP, 0.016 ms at the bf16 tensor-core peak (0.23 ms
// in fp32), against ~25 MB of traffic (0.0075 ms): bound by operations. This
// version is far above it: fp32 FMA products with the weights streamed from
// L2 by each of the 256 blocks.

#include "common.cuh"
#include "philox.cuh"
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
      m = keep_bits(seed, (uint32_t)(r0 + i), kSiteProjection, (uint32_t)n) <
                  p.thresh
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

// ——— workspace layout (shared by the size query and the launch) ———

struct Layout {
  int blocks, chunks;
  size_t gdt, dz, da, vpart, vtmp, part, total;
};

size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

Layout layout(int dtype, long B, int Din, int Dout) {
  const size_t sz = dtype == kBF16 ? 2 : 4;
  Layout l;
  l.blocks = (int)((B + kRows - 1) / kRows);
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
  l.vpart = take((size_t)l.blocks * kNVec * Dout * 4);
  l.vtmp = take((size_t)kVecChunks * kNVec * Dout * 4);
  const size_t big = (size_t)(Din > Dout ? Din : Dout) * Dout;
  l.part = take((size_t)l.chunks * big * 4);
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

bool supported(int dtype, int Din, int Dout) {
  if (!(dtype == kBF16 || dtype == kF32) || Din <= 0 || Dout <= 0)
    return false;
  return smem_layout(Din, Dout, dtype == kBF16 ? 2 : 4).total <= kMaxSmem;
}

}  // namespace

// Bytes of device workspace eid_projection_bwd needs, or -1 for shapes it
// does not take.
extern "C" long long eid_projection_bwd_workspace(int dtype, int B, int Din,
                                                  int Dout) {
  if (!supported(dtype, Din, Dout)) return -1;
  return (long long)layout(dtype, B, Din, Dout).total;
}

// x, dx: (B, Din) in dtype; g: (B, Dout) float32; w: the six parameters in
// dtype (as eid_projection_fwd); wi_t (Dout, Din) and wr_t (Dout, Dout): the
// transposed weights, contiguous in dtype; out (fp32): dWi (Din, Dout), dWr
// (Dout, Dout) and the vector [dbi dbr dln_s dln_b]; ws:
// eid_projection_bwd_workspace bytes. Dropout arguments as
// eid_projection_fwd's.
extern "C" int eid_projection_bwd(int dtype, const void* x, const float* g,
                                  const void* const* w, const void* wi_t,
                                  const void* wr_t, void* dx,
                                  float* const* out, void* ws, int B, int Din,
                                  int Dout, int drop_mode, const void* mask,
                                  const int* seed, unsigned thresh,
                                  float inv_keep, void* stream) {
  if (B <= 0) return 0;
  if (!supported(dtype, Din, Dout)) return (int)cudaErrorInvalidValue;
  if (drop_mode < kDropNone || drop_mode > kDropSeed ||
      (drop_mode == kDropMasks && mask == nullptr) ||
      (drop_mode == kDropSeed && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  const Layout l = layout(dtype, B, Din, Dout);
  unsigned char* base = static_cast<unsigned char*>(ws);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_layout(Din, Dout, dtype == kBF16 ? 2 : 4).total;
  if (dtype == kBF16) return launch<__nv_bfloat16>(l, a, base, out, smem, s);
  return launch<float>(l, a, base, out, smem, s);
}
