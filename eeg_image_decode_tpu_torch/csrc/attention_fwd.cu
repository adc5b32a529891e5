// Fused post-norm channel-attention layer of ATM-S, forward.
//
// Replaces the TPU kernel eeg_image_decode_tpu/ops/attention.py::_kernel
// (launched by _attention_pallas) in its three modes: no dropout, explicit
// keep-masks (has_masks) and in-kernel seeded masks (has_seed, the draw of
// _draw_keep_masks: csrc/philox.cuh). The whole layer
//
//   q,k,v = x Wq/Wk/Wv + b (D -> H*hd)   per head: softmax(q k^T / sqrt(hd)) v
//   a = o Wo + bo;  h1 = LN1(x + a);  y = gelu_tanh(h1 W1 + b1) W2 + b2
//   out = LN2(h1 + y)
//
// for one sample per block, with every intermediate in shared memory: none
// of Q/K/V, the scores or the FFN hidden layer touches device memory.
// Rounding follows the JAX kernel: each dense is an fp32-accumulated product
// rounded to the working type, plus the bias in the working type; scores and
// softmax are fp32, the probabilities are rounded before P V; LayerNorm is
// fp32 (eps 1e-6, biased variance). Dropout multiplies, in the working type,
// the rounded probabilities (m_attn), the output projection (m_res), the
// GELU output (m_ffn1) and the second dense (m_ffn2), as the JAX kernel does;
// a seeded mask's kept value is 1/keep rounded to the working type.
//
// Bound on the H100 (ATM-S: L 64, D 250, 4 heads of 62, FF 256): about
// 52 MFLOP per sample against 64 KB of activations in and out, so the layer
// is compute-bound (13.4 GFLOP at B 256 is ~14 us at the bf16 tensor-core
// peak, the 16 MB of activations ~5 us). Mask mode adds 130 KB of bf16
// masks per sample, which brings the bytes level with the operations. This
// first version runs the products as fp32 FMA loops (common.cuh::gemm_rows),
// one block per sample, and keeps what the bound asks for: activations read
// once and written once, every intermediate on chip, seeded masks drawn in
// registers. It is bound instead by streaming the weights (0.75 MB in bf16)
// from L2: each warp job covers 8 rows, so a block reads each weight 8
// times, and 16 warps per SM hide little of the L2 latency. Tensor-core
// (mma/wgmma) products over weight tiles staged in shared memory are the
// next step.
//
// Shared memory per block: x/h1 (L x D), o / FFN hidden (L x inner, then
// L x FF), q_h k_h v_h of the current head (3 x L x hd) and the fp32 scores
// (L x L): 104 KB in bf16 (two blocks per SM), 191 KB in fp32.

#include <cmath>

#include "common.cuh"
#include "philox.cuh"

namespace {

using namespace eid;

constexpr int kThreads = 256;

struct AttnArgs {
  const void* x;
  const void* w[16];  // wq bq wk bk wv bv wo bo ln1_s ln1_b w1 b1 w2 b2 ln2_s ln2_b
  void* out;
  int L, D, inner, FF, H;
  float scale;
  size_t off_o, off_qkv, off_s;
  Dropout drop;
};

// kMode: kDropNone, kDropMasks or kDropSeed; the no-dropout kernel carries
// no dropout code at all. The dropout modes in bf16 are held to 128
// registers, so that two blocks share an SM as their 104 KB of shared memory
// allows (unbounded they take ~195).
template <typename T, int kMode>
__global__ void __launch_bounds__(
    kThreads, (kMode != kDropNone && sizeof(T) == 2) ? 2 : 1)
    attention_fwd_kernel(const AttnArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = p.L, D = p.D, inner = p.inner, FF = p.FF, H = p.H;
  const int hd = inner / H;
  const T* wq = static_cast<const T*>(p.w[0]);
  const T* bq = static_cast<const T*>(p.w[1]);
  const T* wk = static_cast<const T*>(p.w[2]);
  const T* bk = static_cast<const T*>(p.w[3]);
  const T* wv = static_cast<const T*>(p.w[4]);
  const T* bv = static_cast<const T*>(p.w[5]);
  const T* wo = static_cast<const T*>(p.w[6]);
  const T* bo = static_cast<const T*>(p.w[7]);
  const T* ln1_s = static_cast<const T*>(p.w[8]);
  const T* ln1_b = static_cast<const T*>(p.w[9]);
  const T* w1 = static_cast<const T*>(p.w[10]);
  const T* b1 = static_cast<const T*>(p.w[11]);
  const T* w2 = static_cast<const T*>(p.w[12]);
  const T* b2 = static_cast<const T*>(p.w[13]);
  const T* ln2_s = static_cast<const T*>(p.w[14]);
  const T* ln2_b = static_cast<const T*>(p.w[15]);

  T* xs = reinterpret_cast<T*>(smem);               // L x D: x, then h1
  T* os = reinterpret_cast<T*>(smem + p.off_o);     // L x inner; FFN: L x FF
  T* qh = reinterpret_cast<T*>(smem + p.off_qkv);   // L x hd each
  T* kh = qh + L * hd;
  T* vh = kh + L * hd;
  float* sc = reinterpret_cast<float*>(smem + p.off_s);  // L x L

  const long sample = blockIdx.x;
  const uint32_t seed = kMode == kDropSeed ? (uint32_t)*p.drop.seed : 0u;
  const float kept = rnd<T>(p.drop.inv_keep);
  constexpr bool drop = kMode != kDropNone;
  const long base = sample * L * D;
  const T* x = static_cast<const T*>(p.x) + base;
  T* out = static_cast<T*>(p.out) + base;
  for (int i = threadIdx.x; i < L * D; i += blockDim.x) xs[i] = x[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int h = 0; h < H; ++h) {
    const int c0 = h * hd;
    // q_h | k_h | v_h as one product of N = 3*hd columns
    gemm_rows<8, 2, T, T>(
        xs, D, L, D, 3 * hd, inner,
        [&](int n) {
          const int m = n / hd, c = n - m * hd;
          const T* w = m == 0 ? wq : (m == 1 ? wk : wv);
          return w + c0 + c;
        },
        [&](int i, int n, float acc) {
          const int m = n / hd, c = n - m * hd;
          const T* b = m == 0 ? bq : (m == 1 ? bk : bv);
          T* dst = m == 0 ? qh : (m == 1 ? kh : vh);
          dst[i * hd + c] = from_f<T>(rnd<T>(acc) + to_f(b[c0 + c]));
        });
    __syncthreads();
    // scores (fp32) = q_h k_h^T * scale
    gemm_rows<4, 2, T, T>(
        qh, hd, L, hd, L, 1, [&](int j) { return kh + j * hd; },
        [&](int i, int j, float acc) { sc[i * L + j] = acc * p.scale; });
    __syncthreads();
    // fp32 softmax over each row, probabilities rounded to the working type
    for (int i = warp; i < L; i += n_warps) {
      float* row = sc + i * L;
      float m = -INFINITY;
      for (int j = lane; j < L; j += 32) m = fmaxf(m, row[j]);
      m = warp_max(m);
      float s = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float e = expf(row[j] - m);
        row[j] = e;
        s += e;
      }
      s = warp_sum(s);
      for (int j = lane; j < L; j += 32) {
        float pr = rnd<T>(row[j] / s);
        if (drop)
          pr = rnd<T>(pr * keep_factor<T>(p.drop, seed, 0, sample, (long)H * L * L,
                                          ((long)h * L + i) * L + j, kept));
        row[j] = pr;
      }
    }
    __syncthreads();
    // o[:, head h] = P v_h
    gemm_rows<4, 2, float, T>(
        sc, L, L, L, hd, hd, [&](int e) { return vh + e; },
        [&](int i, int e, float acc) {
          os[i * inner + c0 + e] = from_f<T>(acc);
        });
    __syncthreads();
  }

  // x <- x + (o Wo + bo), in place
  gemm_rows<8, 4, T, T>(
      os, inner, L, inner, D, D, [&](int n) { return wo + n; },
      [&](int i, int n, float acc) {
        float a = rnd<T>(rnd<T>(acc) + to_f(bo[n]));
        if (drop)
          a = rnd<T>(a * keep_factor<T>(p.drop, seed, 1, sample, (long)L * D,
                                        (long)i * D + n, kept));
        xs[i * D + n] = from_f<T>(to_f(xs[i * D + n]) + a);
      });
  __syncthreads();
  // h1 = LN1(x + a), in place
  for (int i = warp; i < L; i += n_warps) {
    T* row = xs + i * D;
    float mu, inv;
    row_mean_inv(row, D, 1e-6f, mu, inv);
    __syncwarp();
    for (int n = lane; n < D; n += 32)
      row[n] = from_f<T>((to_f(row[n]) - mu) * inv * to_f(ln1_s[n]) +
                         to_f(ln1_b[n]));
  }
  __syncthreads();
  // FFN hidden = gelu_tanh(h1 W1 + b1), into the o region
  T* ys = os;
  gemm_rows<8, 4, T, T>(
      xs, D, L, D, FF, FF, [&](int n) { return w1 + n; },
      [&](int i, int n, float acc) {
        const float u = rnd<T>(rnd<T>(acc) + to_f(b1[n]));
        float y = rnd<T>(gelu_tanh(u));
        if (drop)
          y = rnd<T>(y * keep_factor<T>(p.drop, seed, 2, sample, (long)L * FF,
                                        (long)i * FF + n, kept));
        ys[i * FF + n] = from_f<T>(y);
      });
  __syncthreads();
  // h1 <- h1 + (y W2 + b2), in place
  gemm_rows<8, 4, T, T>(
      ys, FF, L, FF, D, D, [&](int n) { return w2 + n; },
      [&](int i, int n, float acc) {
        float y = rnd<T>(rnd<T>(acc) + to_f(b2[n]));
        if (drop)
          y = rnd<T>(y * keep_factor<T>(p.drop, seed, 3, sample, (long)L * D,
                                        (long)i * D + n, kept));
        xs[i * D + n] = from_f<T>(to_f(xs[i * D + n]) + y);
      });
  __syncthreads();
  // out = LN2(h1 + y)
  for (int i = warp; i < L; i += n_warps) {
    const T* row = xs + i * D;
    float mu, inv;
    row_mean_inv(row, D, 1e-6f, mu, inv);
    for (int n = lane; n < D; n += 32)
      out[i * D + n] = from_f<T>((to_f(row[n]) - mu) * inv * to_f(ln2_s[n]) +
                                 to_f(ln2_b[n]));
  }
}

template <typename T, int kMode>
int launch_mode(AttnArgs a, int B, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      attention_fwd_kernel<T, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  attention_fwd_kernel<T, kMode><<<B, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(AttnArgs a, int B, size_t smem, cudaStream_t stream) {
  if (a.drop.mode == kDropMasks)
    return launch_mode<T, kDropMasks>(a, B, smem, stream);
  if (a.drop.mode == kDropSeed)
    return launch_mode<T, kDropSeed>(a, B, smem, stream);
  return launch_mode<T, kDropNone>(a, B, smem, stream);
}

}  // namespace

// x, out: (B, L, D) contiguous; w: 16 device pointers in the order above,
// weights (D, inner), (inner, D), (D, FF), (FF, D) row-major, all in dtype.
// drop_mode 0: no dropout; 1: masks[4] in dtype, (B,H,L,L), (B,L,D),
// (B,L,FF), (B,L,D); 2: the int32 seed at seed (a device pointer), keep iff
// bits < thresh, kept value inv_keep rounded to dtype.
extern "C" int eid_attention_fwd(int dtype, const void* x,
                                 const void* const* w, void* out, int B,
                                 int L, int D, int inner, int FF, int H,
                                 int drop_mode, const void* const* masks,
                                 const int* seed, unsigned thresh,
                                 float inv_keep, void* stream) {
  if (B <= 0) return 0;
  if (H <= 0 || inner % H != 0) return (int)cudaErrorInvalidValue;
  const size_t sz = dtype == kBF16 ? 2 : 4;
  const int hd = inner / H;
  AttnArgs a;
  a.x = x;
  for (int i = 0; i < 16; ++i) a.w[i] = w[i];
  a.out = out;
  a.L = L;
  a.D = D;
  a.inner = inner;
  a.FF = FF;
  a.H = H;
  a.scale = (float)(1.0 / std::sqrt((double)hd));
  a.off_o = align16((size_t)L * D * sz);
  a.off_qkv = a.off_o + align16((size_t)L * inner * sz);
  a.off_s = a.off_qkv + align16((size_t)3 * L * hd * sz);
  a.drop.mode = drop_mode;
  for (int i = 0; i < 4; ++i) a.drop.mask[i] = masks[i];
  a.drop.seed = seed;
  a.drop.thresh = thresh;
  a.drop.inv_keep = inv_keep;
  if (drop_mode < kDropNone || drop_mode > kDropSeed ||
      (drop_mode == kDropSeed && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  size_t smem = a.off_s + (size_t)L * L * 4;
  const size_t ffn_end = a.off_o + (size_t)L * FF * sz;
  if (ffn_end > smem) smem = ffn_end;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch<__nv_bfloat16>(a, B, smem, s);
  if (dtype == kF32) return launch<float>(a, B, smem, s);
  return (int)cudaErrorInvalidValue;
}
