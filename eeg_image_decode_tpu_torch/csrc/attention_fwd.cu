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
// masks per sample, which brings the bytes level with the operations.
//
// Two designs, chosen by dtype in the launcher (eid_attention_fwd_design
// names the one a dtype takes):
// - mma_bf16: attention_fwd_mma_kernel, the layer of attention_tile.cuh on
//   the tensor cores (mma.sync.m16n8k16, fp32 accumulators) over operands
//   zero-padded to multiples of 64, after attention_pack_kernel has packed
//   the weights into that padded layout. One block of 256 threads per
//   sample; x is read once and the output written once; q|k|v, the scores
//   (in registers), the FFN hidden layer and the residual stream stay on
//   chip; seeded masks are drawn in registers. The weights (0.79 MB packed)
//   stream from L2 through a three-stage cp.async ring, once per sample.
//   It runs ~18x over its bound on the H100: with eight warps per sample
//   the code between the products is latency-bound (PERF.md).
// - fma_fp32: attention_fwd_kernel, the first version's fp32 FMA loops
//   (common.cuh::gemm_rows), one block per sample: the tensor cores would
//   take float32 operands as TF32.
//
// Shared memory per block, fma_fp32: x/h1 (L x D), o / FFN hidden
// (L x inner, then L x FF), q_h k_h v_h of the current head (3 x L x hd) and
// the fp32 scores (L x L): 191 KB. mma_bf16: a 64-row buffer (x, o, the
// hidden layer), q|k|v (later the residual stream), the fp32 bias and
// LayerNorm vectors and the ring: 200 KB.

#include <cmath>

#include "attention_tile.cuh"
#include "common.cuh"
#include "philox.cuh"

namespace eid {
namespace attn {

struct PackArgs {
  Dims d;
  Packed p;
  const bf16* w[16];
  bf16* mat;
  float* vec;
};

// The 16 parameters -> the padded layout of attention_tile.cuh: bf16
// matrices (Wq|Wk|Wv, Wo, W1, W2) and fp32 vectors, zeros in the padding.
__global__ void __launch_bounds__(256) attention_pack_kernel(const PackArgs a) {
  const Dims& d = a.d;
  const Packed& p = a.p;
  const long total = p.n_w + p.n_v;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    if (i < p.n_w) {
      bf16 v = __float2bfloat16(0.f);
      if (i < p.wo) {  // Wq|Wk|Wv: (Dp, 3 innerp)
        const int r = (int)(i / d.N3), c = (int)(i % d.N3);
        const int m = c / d.innerp, rc = real_col(d, c - m * d.innerp);
        if (r < d.D && rc >= 0) v = a.w[2 * m][(long)r * d.inner + rc];
      } else if (i < p.w1) {  // Wo: (innerp, Dp)
        const long j = i - p.wo;
        const int r = (int)(j / d.Dp), c = (int)(j % d.Dp);
        const int rr = real_col(d, r);
        if (rr >= 0 && c < d.D) v = a.w[6][(long)rr * d.D + c];
      } else if (i < p.w2) {  // W1: (Dp, FFp)
        const long j = i - p.w1;
        const int r = (int)(j / d.FFp), c = (int)(j % d.FFp);
        if (r < d.D && c < d.FF) v = a.w[10][(long)r * d.FF + c];
      } else {  // W2: (FFp, Dp)
        const long j = i - p.w2;
        const int r = (int)(j / d.Dp), c = (int)(j % d.Dp);
        if (r < d.FF && c < d.D) v = a.w[12][(long)r * d.D + c];
      }
      a.mat[i] = v;
    } else {
      const int j = (int)(i - p.n_w);
      float v = 0.f;
      if (j < p.bo) {  // bq|bk|bv
        const int m = j / d.innerp, rc = real_col(d, j - m * d.innerp);
        if (rc >= 0) v = to_f(a.w[2 * m + 1][rc]);
      } else {
        // bo ln1_s ln1_b b1 b2 ln2_s ln2_b, in the packed order
        const int start[7] = {p.bo, p.ln1_s, p.ln1_b, p.b1, p.b2, p.ln2_s,
                              p.ln2_b};
        const int param[7] = {7, 8, 9, 11, 13, 14, 15};
        int k = 6;
        while (j < start[k]) --k;
        const int c = j - start[k], n = param[k] == 11 ? d.FF : d.D;
        if (c < n) v = to_f(a.w[param[k]][c]);
      }
      a.vec[j] = v;
    }
  }
}

cudaError_t pack_weights(const Dims& d, const void* const* w, void* ws,
                         cudaStream_t s) {
  PackArgs a;
  a.d = d;
  a.p = packed_layout(d);
  for (int i = 0; i < 16; ++i) a.w[i] = static_cast<const bf16*>(w[i]);
  a.mat = static_cast<bf16*>(ws);
  a.vec = reinterpret_cast<float*>(static_cast<unsigned char*>(ws) +
                                   a.p.v_off);
  const long total = a.p.n_w + a.p.n_v;
  const int blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256
                                                      : 1024);
  attention_pack_kernel<<<blocks, 256, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace eid

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

// The fma_fp32 design (launched for float32 only). kMode: kDropNone,
// kDropMasks or kDropSeed; the no-dropout kernel carries no dropout code.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
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

// ——— the bfloat16 design on the tensor cores ———

struct MmaFwdArgs {
  attn::Dims d;
  attn::Weights w;
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  float scale;
  Dropout drop;
  size_t off_qkv, off_vec, off_ring;
};

__global__ void __launch_bounds__(attn::kThreads, 1)
    attention_fwd_mma_kernel(const MmaFwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  attn::Smem sm{};
  sm.R0 = reinterpret_cast<__nv_bfloat16*>(smem);
  sm.QKV = reinterpret_cast<__nv_bfloat16*>(smem + a.off_qkv);
  sm.XS = sm.QKV;
  sm.vec = reinterpret_cast<float*>(smem + a.off_vec);
  sm.ring = reinterpret_cast<__nv_bfloat16*>(smem + a.off_ring);
  const attn::Weights w = attn::stage_vectors(a.w, a.d.Dp, sm.vec);
  const attn::Drop dr{
      a.drop, a.drop.mode == kDropSeed ? (uint32_t)*a.drop.seed : 0u,
      (long)blockIdx.x};
  const long base = (long)blockIdx.x * a.d.L * a.d.D;
  attn::layer_chain<true>(a.d, w, a.scale, dr, a.x + base, sm,
                          a.out + base, attn::Saved{});
}

// shared memory of attention_fwd_mma_kernel: R0 | q|k|v | vectors | ring
size_t mma_fwd_smem(const attn::Dims& d, MmaFwdArgs* a) {
  const size_t qkv = align16((size_t)attn::kRows * d.P0 * 2);
  const size_t vec = qkv + align16((size_t)attn::kRows * d.Pqkv * 2);
  const size_t ring = vec + align16((size_t)attn::vector_floats(d) * 4);
  if (a) a->off_qkv = qkv, a->off_vec = vec, a->off_ring = ring;
  return ring + attn::kRingBytes;
}

int launch_mma(const attn::Dims& d, const void* x, const void* const* w,
               void* out, int B, const Dropout& drop, void* ws,
               cudaStream_t s) {
  const attn::Packed pk = attn::packed_layout(d);
  cudaError_t e = attn::pack_weights(d, w, ws, s);
  if (e != cudaSuccess) return (int)e;
  MmaFwdArgs a;
  a.d = d;
  a.w = attn::weights_at(ws, pk);
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.scale = (float)(1.0 / std::sqrt((double)d.hd));
  a.drop = drop;
  const size_t smem = mma_fwd_smem(d, &a);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(attention_fwd_mma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  attention_fwd_mma_kernel<<<B, attn::kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Which design a dtype takes: "mma_bf16" (tensor cores) or "fma_fp32".
extern "C" const char* eid_attention_fwd_design(int dtype) {
  return dtype == kBF16 ? "mma_bf16" : "fma_fp32";
}

// Bytes of device workspace eid_attention_fwd needs (the packed weights of
// the bfloat16 design, none for float32), or -1 for a dtype or shapes it
// does not take.
extern "C" long long eid_attention_fwd_workspace(int dtype, int L, int D,
                                                 int inner, int FF, int H) {
  if (dtype == kF32) return 0;
  attn::Dims d;
  if (dtype != kBF16 || !attn::make_dims(L, D, inner, FF, H, d) ||
      mma_fwd_smem(d, nullptr) > kMaxSmem)
    return -1;
  return (long long)attn::packed_layout(d).bytes;
}

// x, out: (B, L, D) contiguous; w: 16 device pointers in the order above,
// weights (D, inner), (inner, D), (D, FF), (FF, D) row-major, all in dtype;
// ws: eid_attention_fwd_workspace bytes.
// drop_mode 0: no dropout; 1: masks[4] in dtype, (B,H,L,L), (B,L,D),
// (B,L,FF), (B,L,D); 2: the int32 seed at seed (a device pointer), keep iff
// bits < thresh, kept value inv_keep rounded to dtype, the masks of samples
// sample0 ... sample0 + B - 1 (0 unless the launch takes a data-parallel
// rank's rows of a larger batch).
extern "C" int eid_attention_fwd(int dtype, const void* x,
                                 const void* const* w, void* out, void* ws,
                                 int B, int L, int D, int inner, int FF,
                                 int H, int drop_mode,
                                 const void* const* masks, const int* seed,
                                 unsigned thresh, float inv_keep,
                                 unsigned sample0, void* stream) {
  if (B <= 0) return 0;
  if (H <= 0 || inner % H != 0) return (int)cudaErrorInvalidValue;
  if (drop_mode < kDropNone || drop_mode > kDropSeed ||
      (drop_mode == kDropSeed && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  Dropout drop;
  drop.mode = drop_mode;
  for (int i = 0; i < 4; ++i) drop.mask[i] = masks[i];
  drop.seed = seed;
  drop.thresh = thresh;
  drop.inv_keep = inv_keep;
  drop.sample0 = sample0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    attn::Dims d;
    if (!attn::make_dims(L, D, inner, FF, H, d))
      return (int)cudaErrorInvalidValue;
    return launch_mma(d, x, w, out, B, drop, ws, s);
  }
  if (dtype != kF32) return (int)cudaErrorInvalidValue;
  const size_t sz = 4;
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
  a.drop = drop;
  size_t smem = a.off_s + (size_t)L * L * 4;
  const size_t ffn_end = a.off_o + (size_t)L * FF * sz;
  if (ffn_end > smem) smem = ffn_end;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return launch<float>(a, B, smem, s);
}
