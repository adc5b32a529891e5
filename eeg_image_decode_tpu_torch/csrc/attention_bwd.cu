// Backward of the fused post-norm channel-attention layer of ATM-S.
//
// Replaces the TPU kernel eeg_image_decode_tpu/ops/attention.py::_bwd_kernel
// (launched by _attention_pallas_bwd), in its three dropout modes: recompute
// the forward on chip, then backprop through LN2, the FFN (tanh-GELU
// derivative), LN1 (two-pass variance, eps 1e-6), the output projection,
// the per-head softmax and QKV. It gives dx per sample in the working type
// and fp32 gradients of all 16 parameters. Rounding follows _bwd_kernel
// point for point: the operands of every product are rounded to the working
// type and accumulated in fp32; residuals, LayerNorm, softmax and GELU are
// fp32; masks are fp32 (a seeded mask's kept value is 1/keep unrounded).
//
// Bound on the H100 (ATM-S, B 1024): the recompute and the two products per
// forward product make ~3 x 52 MFLOP per sample, 160 GFLOP, ~0.16 ms at the
// bf16 tensor-core peak; x, g and dx are 98 MB (~0.03 ms).
//
// Two designs, chosen by dtype in the launcher (eid_attention_bwd_design
// names the one a dtype takes); both run two passes with no float atomics,
// so a step is bit-reproducible:
//
// mma_bf16, on the tensor cores (mma.sync.m16n8k16, fp32 accumulators):
// 1. attention_bwd_mma_rows_kernel, one block of 256 threads per sample:
//    attention_tile.cuh's layer_chain under the backward's rounding policy
//    (the recompute), then the backward's products as rows_gemm over the
//    packed weights read K-major (W^T without a copy), all widths padded
//    with zeros as in the forward. The softmax backward runs two heads at a
//    time, one warp per (head, 16 rows), in two passes over registers: a
//    query pass (scores and probabilities recomputed, d_p, the row sums
//    sum_j d_p p, d_s, d_q = d_s k) and a key pass (the transposed scores
//    from the query pass's row statistics, d_v = pm^T d_o, d_k = d_s^T q),
//    so no warp reduces over another's rows. The block writes, per row,
//    the rounded operands of the dW products (x padded, o, h1, g1m; dq|dk|dv,
//    d_attn, d_u, d_z) and per-sample fp32 column sums for the ten bias and
//    LayerNorm gradients.
// 2. attention_dw_mma_kernel: the four dW = A^T dY over the B*L rows, as
//    gemm_tile (mma_tile.cuh) with both operands read MN-major
//    (ldmatrix.trans), split-K: each block sums one fixed chunk of rows into
//    an fp32 partial tile, and attention_dw_reduce_kernel adds the 32
//    chunks in order and drops the padding. The per-sample vectors are
//    summed over the batch in order (reduce.cuh::sum_rows).
//    On the H100 this design runs ~20x over its bound: eight warps per
//    sample leave the code between the products (epilogues, LayerNorms,
//    softmax, draws) latency-bound (PERF.md, scripts/clock_torch_attention.py).
//
// fma_fp32 (float32; the tensor cores would take it as TF32), the first
// version:
// 1. attention_bwd_rows_kernel, one block of 512 threads per sample. The
//    products that give dx run here as warp-tiled FMA loops
//    (common.cuh::gemm_rows / gemm_strided) over shared-memory operands. The
//    block writes, per row, what the weight gradients need: the product
//    operands (x is the input; o, h1, g1m) and cotangents (dq|dk|dv, d_attn,
//    d_u, d_z) in the working type, which are exactly the rounded operands of
//    the JAX kernel's dW products, and per-sample fp32 column sums for the
//    ten bias and LayerNorm gradients. Elementwise fp32 state that is needed
//    again later (xhat1, u, the probabilities) goes to device scratch, and
//    q|k|v too, so the backward heads do not recompute them.
// 2. reduce.cuh: dW = A^T dY over the B*L rows for the four weight groups
//    (x^T [dq|dk|dv], o^T d_attn, h1^T d_u, g1m^T d_z) as fp32 split-K
//    partials over 32 row chunks summed in order, and the per-sample vectors
//    summed over the batch in order.
//
// The TPU kernel summed the parameter gradients over a sequential grid in
// VMEM; the 376 k parameters (1.5 MB fp32) do not fit in one block's shared
// memory, hence the second pass.
//
// fma_fp32 shared memory per block: A1 (L x D: x, h1, d_z, d_attn), F1
// (L x D fp32: r1, xhat1, r2, xhat2, d_r2, d_h1, d_r1 = dx), two rows of
// LN statistics, and a region R that phases share: A2 (L x max(inner, FF):
// o, g1m, d_u, one of dq/dk/dv) with F2 (L x FF fp32: d_u), or the buffers
// of one head. In fp32 R does not fit beside the rest, and lives in device
// scratch, one slice per sample (the kernel is otherwise the same).
// mma_bf16: R0 (64 rows bf16), the union of q|k|v and R1 (64 rows bf16) +
// F (64 rows fp32), statistics and keep bits, the fp32 bias and LayerNorm
// vectors, and the ring (which holds two heads' q, k and v in the softmax
// backward): 209 KB.

#include <cmath>

#include "attention_tile.cuh"
#include "common.cuh"
#include "philox.cuh"
#include "reduce.cuh"

namespace {

using namespace eid;

constexpr int kThreads = 512;
constexpr int kChunks = 32;  // split-K chunks of the dW products

// offsets within region R
enum ROff {
  kRF2, kP1Q, kP1K, kP1V, kP1S,
  kB5Q, kB5K, kB5V, kB5P, kB5DS, kB5PM, kB5DSD, kB5DOH, kB5O32, kRCount
};

struct BwdArgs {
  const void* x;
  const void* g;
  const void* w[16];  // wq bq wk bk wv bv wo bo ln1_s ln1_b w1 b1 w2 b2 ln2_s ln2_b
  const void* wt[6];  // wq^T wk^T wv^T (inner x D), wo^T (D x inner), w1^T (FF x D), w2^T (D x FF)
  void* dx;
  // per-sample device scratch
  void* qkv;      // (B, L, 3 inner) q|k|v
  float* prob;    // (B, H, L, L)
  float* xhat1;   // (B, L, D)
  float* u;       // (B, L, FF)
  void* dqkv;     // (B, L, 3 inner) dq|dk|dv
  void* o;        // (B, L, inner)
  void* dattn;    // (B, L, D)
  void* h1;       // (B, L, D)
  void* dz;       // (B, L, D)
  void* du;       // (B, L, FF)
  void* g1m;      // (B, L, FF)
  float* vec;     // (B, NV) per-sample bias and LayerNorm gradients
  unsigned char* spill;  // (B, r_bytes) region R when not in shared memory
  int L, D, inner, FF, H;
  float scale;
  size_t off_f1, off_stats, off_r, r_bytes;
  size_t r[kRCount];
  bool r_in_smem;
  Dropout drop;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_rows_kernel(const BwdArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = p.L, D = p.D, inner = p.inner, FF = p.FF, H = p.H;
  const int hd = inner / H, I3 = 3 * inner;
  const long LD = (long)L * D, LF = (long)L * FF, LLH = (long)H * L * L;
  auto W = [&](int i) { return static_cast<const T*>(p.w[i]); };
  const T *wq = W(0), *bq = W(1), *wk = W(2), *bk = W(3), *wv = W(4),
          *bv = W(5), *wo = W(6), *bo = W(7), *ln1_s = W(8), *ln1_b = W(9),
          *w1 = W(10), *b1 = W(11), *w2 = W(12), *b2 = W(13), *ln2_s = W(14);
  const T* wqkv_t[3] = {static_cast<const T*>(p.wt[0]),
                        static_cast<const T*>(p.wt[1]),
                        static_cast<const T*>(p.wt[2])};
  const T* wo_t = static_cast<const T*>(p.wt[3]);
  const T* w1_t = static_cast<const T*>(p.wt[4]);
  const T* w2_t = static_cast<const T*>(p.wt[5]);

  const long b = blockIdx.x;
  const uint32_t seed = p.drop.mode == kDropSeed ? (uint32_t)*p.drop.seed : 0u;
  auto keep = [&](int site, long numel, long e) {
    return keep_factor<T>(p.drop, seed, site, b, numel, e, p.drop.inv_keep);
  };

  T* A1 = reinterpret_cast<T*>(smem);
  float* F1 = reinterpret_cast<float*>(smem + p.off_f1);
  float* inv1 = reinterpret_cast<float*>(smem + p.off_stats);
  float* inv2 = inv1 + L;
  unsigned char* R = p.r_in_smem ? smem + p.off_r : p.spill + b * p.r_bytes;
  T* A2 = reinterpret_cast<T*>(R);
  float* F2 = reinterpret_cast<float*>(R + p.r[kRF2]);

  const T* x = static_cast<const T*>(p.x) + b * LD;
  const T* g = static_cast<const T*>(p.g) + b * LD;
  T* qkv = static_cast<T*>(p.qkv) + b * L * I3;
  float* prob = p.prob + b * LLH;
  float* xh1 = p.xhat1 + b * LD;
  float* ug = p.u + b * LF;
  T* dqkv = static_cast<T*>(p.dqkv) + b * L * I3;
  T* og = static_cast<T*>(p.o) + b * (long)L * inner;
  T* dattn = static_cast<T*>(p.dattn) + b * LD;
  T* h1g = static_cast<T*>(p.h1) + b * LD;
  T* dzg = static_cast<T*>(p.dz) + b * LD;
  T* dug = static_cast<T*>(p.du) + b * LF;
  T* g1mg = static_cast<T*>(p.g1m) + b * LF;
  const int NV = I3 + 6 * D + FF;
  float* vec = p.vec + b * NV;
  float* v_bqkv = vec;
  float* v_bo = v_bqkv + I3;
  float* v_b1 = v_bo + D;
  float* v_b2 = v_b1 + FF;
  float* v_ln1s = v_b2 + D;
  float* v_ln1b = v_ln1s + D;
  float* v_ln2s = v_ln1b + D;
  float* v_ln2b = v_ln2s + D;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nthr >> 5;

  for (long i = tid; i < LD; i += nthr) A1[i] = x[i];
  __syncthreads();

  // ——— forward recompute ———
  {
    T* hq = reinterpret_cast<T*>(R + p.r[kP1Q]);
    T* hk = reinterpret_cast<T*>(R + p.r[kP1K]);
    T* hv = reinterpret_cast<T*>(R + p.r[kP1V]);
    float* sc = reinterpret_cast<float*>(R + p.r[kP1S]);
    for (int h = 0; h < H; ++h) {
      const int c0 = h * hd;
      // q|k|v of head h = (x W + b), fp32 sum rounded once
      gemm_rows<8, 2, T, T>(
          A1, D, L, D, 3 * hd, inner,
          [&](int n) {
            const int m = n / hd, c = n - m * hd;
            return (m == 0 ? wq : (m == 1 ? wk : wv)) + c0 + c;
          },
          [&](int i, int n, float acc) {
            const int m = n / hd, c = n - m * hd;
            const T* bias = m == 0 ? bq : (m == 1 ? bk : bv);
            const T v = from_f<T>(acc + to_f(bias[c0 + c]));
            (m == 0 ? hq : (m == 1 ? hk : hv))[i * hd + c] = v;
            qkv[(long)i * I3 + m * inner + c0 + c] = v;
          });
      __syncthreads();
      gemm_rows<4, 2, T, T>(
          hq, hd, L, hd, L, 1, [&](int j) { return hk + j * hd; },
          [&](int i, int j, float acc) { sc[i * L + j] = acc * p.scale; });
      __syncthreads();
      // fp32 softmax; the masked probabilities rounded for P V
      for (int i = warp; i < L; i += n_warps) {
        float* row = sc + i * L;
        float mx = -INFINITY;
        for (int j = lane; j < L; j += 32) mx = fmaxf(mx, row[j]);
        mx = warp_max(mx);
        float s = 0.f;
        for (int j = lane; j < L; j += 32) {
          const float e = expf(row[j] - mx);
          row[j] = e;
          s += e;
        }
        s = warp_sum(s);
        for (int j = lane; j < L; j += 32) {
          const long e = ((long)h * L + i) * L + j;
          const float pr = row[j] / s;
          prob[e] = pr;
          row[j] = rnd<T>(pr * keep(0, LLH, e));
        }
      }
      __syncthreads();
      gemm_rows<4, 2, float, T>(
          sc, L, L, L, hd, hd, [&](int e) { return hv + e; },
          [&](int i, int e, float acc) {
            const T v = from_f<T>(acc);
            A2[i * inner + c0 + e] = v;
            og[(long)i * inner + c0 + e] = v;
          });
      __syncthreads();
    }
  }
  // r1 = x + (o Wo + bo) * m_res, fp32
  gemm_rows<8, 4, T, T>(
      A2, inner, L, inner, D, D, [&](int n) { return wo + n; },
      [&](int i, int n, float acc) {
        const long e = (long)i * D + n;
        F1[e] = to_f(A1[e]) + (acc + to_f(bo[n])) * keep(1, LD, e);
      });
  __syncthreads();
  // LN1: xhat1 (F1, scratch), h1 rounded (A1, scratch)
  for (int i = warp; i < L; i += n_warps) {
    float* row = F1 + i * D;
    float mu, inv;
    row_mean_inv(row, D, 1e-6f, mu, inv);
    __syncwarp();
    for (int n = lane; n < D; n += 32) {
      const float xh = (row[n] - mu) * inv;
      row[n] = xh;
      xh1[i * D + n] = xh;
      const T hv = from_f<T>(xh * to_f(ln1_s[n]) + to_f(ln1_b[n]));
      A1[i * D + n] = hv;
      h1g[i * D + n] = hv;
    }
    if (lane == 0) inv1[i] = inv;
  }
  __syncthreads();
  // u = h1 W1 + b1 (fp32, scratch); g1m = gelu(u) * m_ffn1 rounded (A2)
  gemm_rows<8, 4, T, T>(
      A1, D, L, D, FF, FF, [&](int n) { return w1 + n; },
      [&](int i, int n, float acc) {
        const long e = (long)i * FF + n;
        const float u = acc + to_f(b1[n]);
        ug[e] = u;
        const T v = from_f<T>(gelu_tanh(u) * keep(2, LF, e));
        A2[e] = v;
        g1mg[e] = v;
      });
  __syncthreads();
  // r2 = h1 + (g1m W2 + b2) * m_ffn2, fp32, over xhat1 in F1
  gemm_rows<8, 4, T, T>(
      A2, FF, L, FF, D, D, [&](int n) { return w2 + n; },
      [&](int i, int n, float acc) {
        const long e = (long)i * D + n;
        const float h1 = F1[e] * to_f(ln1_s[n]) + to_f(ln1_b[n]);
        F1[e] = h1 + (acc + to_f(b2[n])) * keep(3, LD, e);
      });
  __syncthreads();
  // LN2: xhat2 in F1
  for (int i = warp; i < L; i += n_warps) {
    float* row = F1 + i * D;
    float mu, inv;
    row_mean_inv(row, D, 1e-6f, mu, inv);
    __syncwarp();
    for (int n = lane; n < D; n += 32) row[n] = (row[n] - mu) * inv;
    if (lane == 0) inv2[i] = inv;
  }
  __syncthreads();

  // ——— backward ———
  // LN2: scale and bias gradients (column sums), then d_r2 in F1
  for (int n = tid; n < D; n += nthr) {
    float ds = 0.f, db = 0.f;
    for (int i = 0; i < L; ++i) {
      const float gv = to_f(g[i * D + n]);
      ds += gv * F1[i * D + n];
      db += gv;
    }
    v_ln2s[n] = ds;
    v_ln2b[n] = db;
  }
  __syncthreads();
  for (int i = warp; i < L; i += n_warps) {
    float* row = F1 + i * D;
    float s1 = 0.f, s2 = 0.f;
    for (int n = lane; n < D; n += 32) {
      const float gxh = to_f(g[i * D + n]) * to_f(ln2_s[n]);
      s1 += gxh;
      s2 += gxh * row[n];
    }
    const float m1 = warp_sum(s1) / (float)D, m2 = warp_sum(s2) / (float)D;
    for (int n = lane; n < D; n += 32) {
      const float gxh = to_f(g[i * D + n]) * to_f(ln2_s[n]);
      row[n] = (gxh - m1 - row[n] * m2) * inv2[i];
    }
  }
  __syncthreads();
  // d_z = d_r2 * m_ffn2: rounded (A1, scratch), fp32 column sums (b2)
  for (long e = tid; e < LD; e += nthr) {
    const T v = from_f<T>(F1[e] * keep(3, LD, e));
    A1[e] = v;
    dzg[e] = v;
  }
  for (int n = tid; n < D; n += nthr) {
    float s = 0.f;
    for (int i = 0; i < L; ++i) s += F1[i * D + n] * keep(3, LD, (long)i * D + n);
    v_b2[n] = s;
  }
  __syncthreads();
  // d_u = (d_z W2^T) * m_ffn1 * gelu'(u): fp32 (F2), rounded (A2, scratch)
  gemm_rows<8, 4, T, T>(
      A1, D, L, D, FF, FF, [&](int f) { return w2_t + f; },
      [&](int i, int f, float acc) {
        const long e = (long)i * FF + f;
        const float du = acc * keep(2, LF, e) * gelu_tanh_grad(ug[e]);
        F2[e] = du;
        const T v = from_f<T>(du);
        A2[e] = v;
        dug[e] = v;
      });
  __syncthreads();
  // b1 gradient; d_h1 = d_r2 + d_u W1^T (F1)
  for (int f = tid; f < FF; f += nthr) {
    float s = 0.f;
    for (int i = 0; i < L; ++i) s += F2[i * FF + f];
    v_b1[f] = s;
  }
  gemm_rows<8, 4, T, T>(
      A2, FF, L, FF, D, D, [&](int n) { return w1_t + n; },
      [&](int i, int n, float acc) { F1[i * D + n] += acc; });
  __syncthreads();
  // LN1: scale and bias gradients, then d_r1 in F1 (the dx accumulator)
  for (int n = tid; n < D; n += nthr) {
    float ds = 0.f, db = 0.f;
    for (int i = 0; i < L; ++i) {
      const float gv = F1[i * D + n];
      ds += gv * xh1[i * D + n];
      db += gv;
    }
    v_ln1s[n] = ds;
    v_ln1b[n] = db;
  }
  __syncthreads();
  for (int i = warp; i < L; i += n_warps) {
    float* row = F1 + i * D;
    const float* xr = xh1 + i * D;
    float s1 = 0.f, s2 = 0.f;
    for (int n = lane; n < D; n += 32) {
      const float gxh = row[n] * to_f(ln1_s[n]);
      s1 += gxh;
      s2 += gxh * xr[n];
    }
    const float m1 = warp_sum(s1) / (float)D, m2 = warp_sum(s2) / (float)D;
    for (int n = lane; n < D; n += 32) {
      const float gxh = row[n] * to_f(ln1_s[n]);
      row[n] = (gxh - m1 - xr[n] * m2) * inv1[i];
    }
  }
  __syncthreads();
  // d_attn = d_r1 * m_res: rounded (A1, scratch), fp32 column sums (bo)
  for (long e = tid; e < LD; e += nthr) {
    const T v = from_f<T>(F1[e] * keep(1, LD, e));
    A1[e] = v;
    dattn[e] = v;
  }
  for (int n = tid; n < D; n += nthr) {
    float s = 0.f;
    for (int i = 0; i < L; ++i) s += F1[i * D + n] * keep(1, LD, (long)i * D + n);
    v_bo[n] = s;
  }
  __syncthreads();

  // per head: d_o_h, the softmax backward, d_q_h, d_k_h, d_v_h
  {
    T* hq = reinterpret_cast<T*>(R + p.r[kB5Q]);
    T* hk = reinterpret_cast<T*>(R + p.r[kB5K]);
    T* hv = reinterpret_cast<T*>(R + p.r[kB5V]);
    float* pr = reinterpret_cast<float*>(R + p.r[kB5P]);
    float* ds = reinterpret_cast<float*>(R + p.r[kB5DS]);
    T* pm = reinterpret_cast<T*>(R + p.r[kB5PM]);
    T* dsd = reinterpret_cast<T*>(R + p.r[kB5DSD]);
    T* doh = reinterpret_cast<T*>(R + p.r[kB5DOH]);
    float* o32 = reinterpret_cast<float*>(R + p.r[kB5O32]);
    // o32 (L x hd fp32) → its column sums (a bias gradient) and, rounded,
    // the head's columns of dq|dk|dv
    auto emit = [&](int m, int c0) {
      for (int e = tid; e < hd; e += nthr) {
        float s = 0.f;
        for (int j = 0; j < L; ++j) s += o32[j * hd + e];
        v_bqkv[m * inner + c0 + e] = s;
      }
      for (int i = tid; i < L * hd; i += nthr) {
        const int j = i / hd, e = i - j * hd;
        dqkv[(long)j * I3 + m * inner + c0 + e] = from_f<T>(o32[i]);
      }
    };
    for (int h = 0; h < H; ++h) {
      const int c0 = h * hd;
      for (int i = tid; i < L * hd; i += nthr) {
        const int j = i / hd, e = i - j * hd;
        const long src = (long)j * I3 + c0 + e;
        hq[i] = qkv[src];
        hk[i] = qkv[src + inner];
        hv[i] = qkv[src + 2 * inner];
      }
      for (int i = tid; i < L * L; i += nthr) {
        const long e = (long)h * L * L + i;
        pr[i] = prob[e];
        pm[i] = from_f<T>(prob[e] * keep(0, LLH, e));
      }
      // d_o_h = d_attn Wo^T, columns of head h, rounded
      gemm_rows<8, 2, T, T>(
          A1, D, L, D, hd, inner, [&](int e) { return wo_t + c0 + e; },
          [&](int i, int e, float acc) { doh[i * hd + e] = from_f<T>(acc); });
      __syncthreads();
      // d_p = (d_o_h v_h^T) * m_attn;  d_v_h = pm^T d_o_h
      gemm_rows<4, 2, T, T>(
          doh, hd, L, hd, L, 1, [&](int j) { return hv + j * hd; },
          [&](int i, int j, float acc) {
            ds[i * L + j] = acc * keep(0, LLH, ((long)h * L + i) * L + j);
          });
      gemm_strided<4, 2, T, T>(
          pm, 1, L, L, L, hd, hd, [&](int e) { return doh + e; },
          [&](int j, int e, float acc) { o32[j * hd + e] = acc; });
      __syncthreads();
      // d_s = (d_p - rowsum(d_p p)) p scale, fp32 and rounded
      for (int i = warp; i < L; i += n_warps) {
        float* row = ds + i * L;
        const float* prow = pr + i * L;
        float s = 0.f;
        for (int j = lane; j < L; j += 32) s += row[j] * prow[j];
        s = warp_sum(s);
        for (int j = lane; j < L; j += 32) {
          const float v = (row[j] - s) * prow[j] * p.scale;
          row[j] = v;
          dsd[i * L + j] = from_f<T>(v);
        }
      }
      emit(2, c0);
      __syncthreads();
      // d_q_h = d_s k_h
      gemm_rows<4, 2, T, T>(
          dsd, L, L, L, hd, hd, [&](int e) { return hk + e; },
          [&](int i, int e, float acc) { o32[i * hd + e] = acc; });
      __syncthreads();
      emit(0, c0);
      __syncthreads();
      // d_k_h = d_s^T q_h
      gemm_strided<4, 2, T, T>(
          dsd, 1, L, L, L, hd, hd, [&](int e) { return hq + e; },
          [&](int j, int e, float acc) { o32[j * hd + e] = acc; });
      __syncthreads();
      emit(1, c0);
      __syncthreads();
    }
  }
  // dx = d_r1 + dq Wq^T + dk Wk^T + dv Wv^T, in that order
  for (int m = 0; m < 3; ++m) {
    for (int i = tid; i < L * inner; i += nthr) {
      const int j = i / inner, c = i - j * inner;
      A2[i] = dqkv[(long)j * I3 + m * inner + c];
    }
    __syncthreads();
    gemm_rows<8, 4, T, T>(
        A2, inner, L, inner, D, D, [&](int n) { return wqkv_t[m] + n; },
        [&](int i, int n, float acc) { F1[i * D + n] += acc; });
    __syncthreads();
  }
  T* dx = static_cast<T*>(p.dx) + b * LD;
  for (long e = tid; e < LD; e += nthr) dx[e] = from_f<T>(F1[e]);
}

// ——— workspace layout (shared by the size query and the launch) ———

struct Layout {
  size_t off_f1, off_stats, off_r, r_bytes, smem;
  size_t r[kRCount];
  bool r_in_smem;
  // device scratch, byte offsets
  size_t qkv, prob, xhat1, u, dqkv, o, dattn, h1, dz, du, g1m, vec, spill,
      part, vpart, total;
};

size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

Layout layout(int dtype, long B, int L, int D, int inner, int FF, int H) {
  const size_t sz = dtype == kBF16 ? 2 : 4;
  const int hd = inner / H, I3 = 3 * inner, W2 = inner > FF ? inner : FF;
  Layout l;
  l.off_f1 = align16((size_t)L * D * sz);
  l.off_stats = l.off_f1 + align16((size_t)L * D * 4);
  l.off_r = l.off_stats + align16((size_t)2 * L * 4);
  // R: A2 | F2, with the forward heads over F2 and the backward heads over
  // all of it
  const size_t a2 = align16((size_t)L * W2 * sz);
  l.r[kRF2] = a2;
  const size_t f2_end = a2 + align16((size_t)L * FF * 4);
  const size_t lh = align16((size_t)L * hd * sz);
  const size_t ll4 = align16((size_t)L * L * 4), llt = align16((size_t)L * L * sz);
  l.r[kP1Q] = a2;
  l.r[kP1K] = a2 + lh;
  l.r[kP1V] = a2 + 2 * lh;
  l.r[kP1S] = a2 + 3 * lh;
  const size_t p1_end = l.r[kP1S] + ll4;
  l.r[kB5Q] = 0;
  l.r[kB5K] = lh;
  l.r[kB5V] = 2 * lh;
  l.r[kB5P] = 3 * lh;
  l.r[kB5DS] = l.r[kB5P] + ll4;
  l.r[kB5PM] = l.r[kB5DS] + ll4;
  l.r[kB5DSD] = l.r[kB5PM] + llt;
  l.r[kB5DOH] = l.r[kB5DSD] + llt;
  l.r[kB5O32] = l.r[kB5DOH] + lh;
  const size_t b5_end = l.r[kB5O32] + align16((size_t)L * hd * 4);
  size_t r = f2_end > p1_end ? f2_end : p1_end;
  l.r_bytes = align16(r > b5_end ? r : b5_end);
  l.r_in_smem = l.off_r + l.r_bytes <= kMaxSmem;
  l.smem = l.r_in_smem ? l.off_r + l.r_bytes : l.off_r;

  const size_t rows = (size_t)B * L;
  size_t o = 0;
  auto take = [&](size_t bytes) {
    const size_t at = o;
    o += align256(bytes);
    return at;
  };
  l.qkv = take(rows * I3 * sz);
  l.prob = take((size_t)B * H * L * L * 4);
  l.xhat1 = take(rows * D * 4);
  l.u = take(rows * FF * 4);
  l.dqkv = take(rows * I3 * sz);
  l.o = take(rows * inner * sz);
  l.dattn = take(rows * D * sz);
  l.h1 = take(rows * D * sz);
  l.dz = take(rows * D * sz);
  l.du = take(rows * FF * sz);
  l.g1m = take(rows * FF * sz);
  const size_t nv = (size_t)I3 + 6 * D + FF;
  l.vec = take((size_t)B * nv * 4);
  l.spill = take(l.r_in_smem ? 0 : (size_t)B * l.r_bytes);
  const size_t big = (size_t)D * I3;
  const size_t mid = (size_t)inner * D > (size_t)D * FF ? (size_t)inner * D
                                                        : (size_t)D * FF;
  l.part = take((size_t)kChunks * (big > mid ? big : mid) * 4);
  l.vpart = take((size_t)kChunks * nv * 4);
  l.total = o;
  return l;
}

template <typename T>
int launch(const Layout& l, BwdArgs a, long B, unsigned char* ws,
           float* const* out, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      attention_bwd_rows_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  if (e != cudaSuccess) return (int)e;
  attention_bwd_rows_kernel<T><<<(unsigned)B, kThreads, l.smem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long N = B * a.L;
  const int D = a.D, inner = a.inner, FF = a.FF, I3 = 3 * inner;
  float* part = reinterpret_cast<float*>(ws + l.part);
  const T* x = static_cast<const T*>(a.x);
  // dWq|dWk|dWv = x^T [dq|dk|dv];  dWo = o^T d_attn;  dW1 = h1^T d_u;
  // dW2 = g1m^T d_z (the partial buffer is reused in stream order)
  e = atb<T>(x, D, static_cast<const T*>(a.dqkv), I3, D, I3, N, kChunks,
             part, out[0], s);
  if (e == cudaSuccess)
    e = atb<T>(static_cast<const T*>(a.o), inner,
               static_cast<const T*>(a.dattn), D, inner, D, N, kChunks, part,
               out[1], s);
  if (e == cudaSuccess)
    e = atb<T>(static_cast<const T*>(a.h1), D, static_cast<const T*>(a.du),
               FF, D, FF, N, kChunks, part, out[2], s);
  if (e == cudaSuccess)
    e = atb<T>(static_cast<const T*>(a.g1m), FF, static_cast<const T*>(a.dz),
               D, FF, D, N, kChunks, part, out[3], s);
  // bias and LayerNorm gradients: per-sample vectors summed over the batch
  const long nv = (long)I3 + 6 * D + FF;
  float* vpart = reinterpret_cast<float*>(ws + l.vpart);
  if (e == cudaSuccess) e = sum_rows(a.vec, B, nv, kChunks, vpart, s);
  if (e == cudaSuccess) e = sum_rows(vpart, kChunks, nv, 1, out[4], s);
  return (int)e;
}

bool supported(int dtype, int L, int D, int inner, int FF, int H) {
  return (dtype == kBF16 || dtype == kF32) && L > 0 && D > 0 && FF > 0 &&
         H > 0 && inner > 0 && inner % H == 0;
}

// ——— the bfloat16 design on the tensor cores ———

using attn::bf16;
constexpr int kMmaChunks = 32;  // split-K chunks of the dW products

struct MmaBwdArgs {
  attn::Dims d;
  attn::Weights w;
  float scale;
  Dropout drop;
  const bf16* x;
  const bf16* g;
  bf16* dx;
  // device scratch, rows b * L + i (i < L), widths padded
  bf16 *xp, *qkv, *o, *h1, *g1m, *dqkv, *dattn, *du, *dz;
  float *xhat1, *u;
  float* vec;  // (B, NV) per-sample bias and LayerNorm gradients
  size_t off_u, off_f, off_stats, off_vec, off_ring;  // shared memory
};

// 16-byte copies of rows [0, L) of `cols` (a multiple of 8) columns of n
// sources src[k] (row pitch ld) into dst[k] (pitch ps); rows L..63 get
// zeros. Four loads per thread are in flight at a time.
template <int kMax>
__device__ __forceinline__ void load_rows(bf16* const (&dst)[kMax],
                                          const bf16* const (&src)[kMax],
                                          int n, int ps, long ld, int L,
                                          int cols) {
  const int per = cols / 8, per_src = attn::kRows * per;
  const int total = n * per_src;
  for (int base = threadIdx.x; base < total; base += 4 * attn::kThreads) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * attn::kThreads;
      const int k = i / per_src, rc = i - k * per_src;
      const int r = rc / per, c = (rc - r * per) * 8;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total && r < L)
        v[u] = *reinterpret_cast<const uint4*>(src[k] + (long)r * ld + c);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * attn::kThreads;
      if (i < total) {
        const int k = i / per_src, rc = i - k * per_src;
        const int r = rc / per, c = (rc - r * per) * 8;
        *reinterpret_cast<uint4*>(dst[k] + r * ps + c) = v[u];
      }
    }
  }
}

// A head's 16 x hdp result o of rows r0.. (the layout of pv16): rounded
// into dst (row pitch ld) for rows < L, and its fp32 column sums over those
// rows into part[0 .. hdp) (one partial per warp).
__device__ __forceinline__ void store_head(const float (&o)[8][4], int r0,
                                           int L, int hdp, bf16* dst,
                                           long ld, float* part) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    if (nb * 8 < hdp) {
      const int c = nb * 8 + 2 * t;
      const int ra = r0 + g, rb = ra + 8;
      float2 va = make_float2(0.f, 0.f), vb = va;
      if (ra < L) va = make_float2(o[nb][0], o[nb][1]);
      if (rb < L) vb = make_float2(o[nb][2], o[nb][3]);
      if (ra < L) attn::st2(dst + (long)ra * ld + c, va.x, va.y);
      if (rb < L) attn::st2(dst + (long)rb * ld + c, vb.x, vb.y);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float sum = e ? va.y + vb.y : va.x + vb.x;
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        sum += __shfl_xor_sync(0xffffffffu, sum, 8);
        sum += __shfl_xor_sync(0xffffffffu, sum, 16);
        if (g == 0) part[c + e] = sum;
      }
    }
  }
}

// For each column pair (c, c + 1) of F (fp32, pitch Wp): v = F * (the
// factors of `site`), rounded into R (pitch P0) for all 64 rows and into
// the scratch s (pitch Dp) for rows < L; the column sums of v over the rows
// into sum (the bias gradient). Rows >= L and columns >= D come out 0. The
// threads split into G groups of Dp / 2 (one column pair each), group q
// taking rows [q R, q R + R); part (G x Dp floats of shared memory) holds
// the groups' sums, which are added in group order: a fixed order.
__device__ __forceinline__ void masked_rows(
    const attn::Dims& d, const attn::Drop& dr, int site, const float* F,
    bf16* R, bf16* s, float* sum, float* part) {
  const int L = d.L, D = d.D, np = d.Dp / 2;
  const long LD = (long)L * D;
  const int G = attn::kThreads / np, R_ = attn::kRows / G;
  const int q = threadIdx.x / np, c = 2 * (threadIdx.x - q * np);
  if (q < G) {
    float s0 = 0.f, s1 = 0.f;
    for (int r8 = q * R_; r8 < q * R_ + R_; r8 += 8) {
      float2 f[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int r = r8 + u;
        f[u] = r < L && c < D
                   ? dr.at2<false>(site, LD, (long)r * D + c, c + 1 < D)
                   : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int r = r8 + u;
        const float v0 = F[r * d.Wp + c] * f[u].x;
        const float v1 = F[r * d.Wp + c + 1] * f[u].y;
        attn::st2(R + r * d.P0 + c, v0, v1);
        if (r < L) attn::st2(s + (long)r * d.Dp + c, v0, v1);
        s0 += v0;
        s1 += v1;
      }
    }
    part[q * d.Dp + c] = s0;
    part[q * d.Dp + c + 1] = s1;
  }
  __syncthreads();
  for (int cc = threadIdx.x; cc < D; cc += attn::kThreads) {
    float t = 0.f;
    for (int k = 0; k < G; ++k) t += part[k * d.Dp + cc];
    sum[cc] = t;
  }
}

// The LayerNorm backward of rows < L, four rows at a time per warp: gxh =
// gy * s (gy a row buffer of pitch pg), xhat from X (pitch px), 1/sigma in
// inv; F (pitch Wp) gets (gxh - mean(gxh) - xhat mean(gxh xhat)) inv over
// the first D columns. F may be gy or X: each warp reads its four rows
// whole before it writes them.
template <typename TG>
__device__ __forceinline__ void ln_bwd_rows(const TG* gy, int pg,
                                            const float* X, int px,
                                            const float* s, const float* inv,
                                            float* F, int Wp, int L, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int k0 = 0; k0 < 8; k0 += 4) {
    float gx[4][8], xh[4][8], s1[4], s2[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = warp + 8 * (k0 + k);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = lane + 32 * q;
        const bool in = r < L && c < D;
        gx[k][q] = in ? to_f(gy[r * pg + c]) * s[c] : 0.f;
        xh[k][q] = in ? X[r * px + c] : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s1[k] = s2[k] = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        s1[k] += gx[k][q];
        s2[k] += gx[k][q] * xh[k][q];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], o);
        s2[k] += __shfl_xor_sync(0xffffffffu, s2[k], o);
      }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = warp + 8 * (k0 + k);
      if (r >= L) continue;
      const float m1 = s1[k] / (float)D, m2 = s2[k] / (float)D;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = lane + 32 * q;
        if (c < D) F[r * Wp + c] = (gx[k][q] - m1 - xh[k][q] * m2) * inv[r];
      }
    }
  }
}

__global__ void __launch_bounds__(attn::kThreads, 1)
    attention_bwd_mma_rows_kernel(const MmaBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const attn::Dims& d = a.d;
  const int L = d.L, D = d.D, FF = d.FF, H = d.H;
  const int Dp = d.Dp, FFp = d.FFp, P0 = d.P0, Wp = d.Wp, hdp = d.hdp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long b = blockIdx.x;
  const long LD = (long)L * D, LF = (long)L * FF, LLH = (long)H * L * L;
  const long rows = (long)b * L;

  attn::Smem sm{};
  sm.vec = reinterpret_cast<float*>(smem + a.off_vec);
  sm.R0 = reinterpret_cast<bf16*>(smem);
  sm.QKV = reinterpret_cast<bf16*>(smem + a.off_u);
  sm.R1 = sm.QKV;
  sm.F = reinterpret_cast<float*>(smem + a.off_f);
  sm.inv1 = reinterpret_cast<float*>(smem + a.off_stats);
  sm.inv2 = sm.inv1 + attn::kRows;
  sm.ring = reinterpret_cast<bf16*>(smem + a.off_ring);
  float* F = sm.F;
  bf16* R0 = sm.R0;
  bf16* R1 = sm.R1;
  // the softmax backward's row statistics (two heads) and column partials
  float* mrow = sm.inv2 + attn::kRows;
  float* lrow = mrow + 2 * attn::kRows;
  float* drow = lrow + 2 * attn::kRows;
  float* colp = drow + 2 * attn::kRows;  // [3][8 warps][64]
  // the query pass's keep pattern in seed mode, for the key pass: one bit
  // per (head of the pair, query row, key)
  uint32_t* kbits = reinterpret_cast<uint32_t*>(colp + 3 * 512);

  const attn::Weights w = attn::stage_vectors(a.w, Dp, sm.vec);
  const attn::Saved sv{a.xp + rows * Dp, a.qkv + rows * d.N3,
                       a.o + rows * d.innerp, a.h1 + rows * Dp,
                       a.g1m + rows * FFp, a.xhat1 + rows * Dp,
                       a.u + rows * FFp};
  bf16* dqkv = a.dqkv + rows * d.N3;
  const attn::Drop dr{
      a.drop, a.drop.mode == kDropSeed ? (uint32_t)*a.drop.seed : 0u, b};
  const bf16* x = a.x + b * LD;
  const int I3 = 3 * d.inner;
  float* vec = a.vec + b * (I3 + 6 * D + FF);
  float* v_bqkv = vec;
  float* v_bo = v_bqkv + I3;
  float* v_b1 = v_bo + D;
  float* v_b2 = v_b1 + FF;
  float* v_ln1s = v_b2 + D;
  float* v_ln1b = v_ln1s + D;
  float* v_ln2s = v_ln1b + D;
  float* v_ln2b = v_ln2s + D;

  // ——— forward recompute: xhat2 in F ———
  attn::layer_chain<false>(d, w, a.scale, dr, x, sm, nullptr, sv);

  // ——— backward ———
  // g -> R1; LN2: scale and bias gradients (column sums), then d_r2 in F
  attn::load_tile(R1, P0, a.g + b * LD, D, L, D, Dp);
  __syncthreads();
  for (int c = tid; c < D; c += attn::kThreads) {
    float ds = 0.f, db = 0.f;
    for (int i = 0; i < L; ++i) {
      const float gv = to_f(R1[i * P0 + c]);
      ds += gv * F[i * Wp + c];
      db += gv;
    }
    v_ln2s[c] = ds;
    v_ln2b[c] = db;
  }
  __syncthreads();
  ln_bwd_rows(R1, P0, F, Wp, w.ln2_s, sm.inv2, F, Wp, L, D);
  __syncthreads();
  // d_z = d_r2 * m_ffn2: rounded (R1, scratch), fp32 column sums (b2)
  masked_rows(d, dr, 3, F, R1, a.dz + rows * Dp, v_b2, colp);
  // d_u = (d_z W2^T) * m_ffn1 * gelu'(u): fp32 over u (scratch), rounded
  // (R0, scratch)
  attn::rows_gemm<true>(
      R1, P0, w.w2, Dp, Dp, FFp, sm.ring,
      [&](int r, int c) {
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < L && c < FF) {
          const float2 u =
              *reinterpret_cast<const float2*>(sv.u + (long)r * FFp + c);
          const float2 f = dr.at2<false>(2, LF, (long)r * FF + c, c + 1 < FF);
          q = make_float4(u.x, u.y, f.x, f.y);
        }
        return q;
      },
      [&](int r, int c, float2 v, float4 q) {
        const float du0 = r < L && c < FF
                              ? v.x * q.z * gelu_tanh_grad(q.x) : 0.f;
        const float du1 = r < L && c + 1 < FF
                              ? v.y * q.w * gelu_tanh_grad(q.y) : 0.f;
        attn::st2(R0 + r * P0 + c, du0, du1);
        if (r < L) {
          *reinterpret_cast<float2*>(sv.u + (long)r * FFp + c) =
              make_float2(du0, du1);
          attn::st2(a.du + (rows + r) * FFp + c, du0, du1);
        }
      });
  __syncthreads();
  // b1 gradient: column sums of the fp32 d_u, rows in order, eight loads
  // in flight
  for (int c = 2 * tid; c < FF; c += 2 * attn::kThreads) {
    float s0 = 0.f, s1 = 0.f;
    for (int r8 = 0; r8 < L; r8 += 8) {
      float2 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = r8 + u < L ? *reinterpret_cast<const float2*>(
                                sv.u + (long)(r8 + u) * FFp + c)
                          : make_float2(0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        s0 += v[u].x;
        s1 += v[u].y;
      }
    }
    v_b1[c] = s0;
    if (c + 1 < FF) v_b1[c + 1] = s1;
  }
  // d_h1 = d_r2 + d_u W1^T (F)
  attn::rows_gemm<true>(R0, P0, w.w1, FFp, FFp, Dp, sm.ring,
                        attn::NoGather{}, [&](int r, int c, float2 v, float) {
                          F[r * Wp + c] += v.x;
                          F[r * Wp + c + 1] += v.y;
                        });
  __syncthreads();
  // xhat1 (fp32, L x Dp) -> R0 and R1, which are contiguous and free
  float* X1 = reinterpret_cast<float*>(R0);
  {
    const int n4 = L * Dp / 4;
    const float4* src = reinterpret_cast<const float4*>(sv.xhat1);
    float4* dst = reinterpret_cast<float4*>(X1);
    for (int base = tid; base < n4; base += 4 * attn::kThreads) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (base + u * attn::kThreads < n4) v[u] = src[base + u * attn::kThreads];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (base + u * attn::kThreads < n4) dst[base + u * attn::kThreads] = v[u];
    }
  }
  __syncthreads();
  // LN1: scale and bias gradients, then d_r1 in F (the dx accumulator)
  for (int c = tid; c < D; c += attn::kThreads) {
    float ds = 0.f, db = 0.f;
    for (int i = 0; i < L; ++i) {
      const float gv = F[i * Wp + c];
      ds += gv * X1[i * Dp + c];
      db += gv;
    }
    v_ln1s[c] = ds;
    v_ln1b[c] = db;
  }
  __syncthreads();
  ln_bwd_rows(F, Wp, X1, Dp, w.ln1_s, sm.inv1, F, Wp, L, D);
  __syncthreads();
  // d_attn = d_r1 * m_res: rounded (R1, scratch), fp32 column sums (bo)
  masked_rows(d, dr, 1, F, R1, a.dattn + rows * Dp, v_bo, colp);
  // d_o = d_attn Wo^T, rounded, per head in its padded columns (R0)
  attn::rows_gemm<true>(R1, P0, w.wo, Dp, Dp, d.innerp, sm.ring,
                        attn::NoGather{}, [&](int r, int c, float2 v, float) {
                          attn::st2(R0 + r * P0 + c, r < L ? v.x : 0.f,
                                    r < L ? v.y : 0.f);
                        });

  // the softmax backward, two heads at a time; their q, k, v in the ring
  const int Ph = hdp + attn::kPad;
  bf16* Qh = sm.ring;
  bf16* Kh = Qh + 2 * attn::kRows * Ph;
  bf16* Vh = Kh + 2 * attn::kRows * Ph;
  for (int h0 = 0; h0 < H; h0 += 2) {
    const int nh = H - h0 < 2 ? H - h0 : 2;
    __syncthreads();  // d_o is written; the last pair's readers are done
    {
      bf16* const dst[6] = {Qh, Kh, Vh, Qh + attn::kRows * Ph,
                            Kh + attn::kRows * Ph, Vh + attn::kRows * Ph};
      const bf16* const src[6] = {
          sv.qkv + h0 * hdp, sv.qkv + d.innerp + h0 * hdp,
          sv.qkv + 2 * d.innerp + h0 * hdp, sv.qkv + (h0 + 1) * hdp,
          sv.qkv + d.innerp + (h0 + 1) * hdp,
          sv.qkv + 2 * d.innerp + (h0 + 1) * hdp};
      load_rows<6>(dst, src, 3 * nh, Ph, d.N3, L, hdp);
    }
    for (int i = tid; i < 2 * attn::kRows * 2; i += attn::kThreads)
      kbits[i] = 0u;
    __syncthreads();
    const int hl = warp >> 2, h = h0 + hl, r0 = (warp & 3) * 16;
    const bool work = hl < nh;
    const bf16* Q = Qh + hl * attn::kRows * Ph;
    const bf16* K = Kh + hl * attn::kRows * Ph;
    const bf16* V = Vh + hl * attn::kRows * Ph;
    const bf16* DO = R0 + h * hdp;
    const int c0 = h * hdp;
    // query pass: p, d_p = (d_o v^T) * m, the row sums, d_s, d_q = d_s k
    if (work) {
      float s[8][4], dp[8][4], mx[2], z[2], rs[2] = {0.f, 0.f};
      attn::scores16(Q, Ph, K, Ph, r0, hdp, s);
      attn::softmax16(s, L, a.scale, mx, z);
      attn::scores16(DO, P0, V, Ph, r0, hdp, dp);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = r0 + g + hf * 8, j = nb * 8 + 2 * t;
          const bool v0 = i < L && j < L, v1 = i < L && j + 1 < L;
          const float2 f =
              v0 ? dr.at2<false, true>(0, LLH, ((long)h * L + i) * L + j, v1)
                 : make_float2(0.f, 0.f);
          if (a.drop.mode == kDropSeed && (f.x != 0.f || f.y != 0.f))
            atomicOr(kbits + (hl * attn::kRows + i) * 2 + (j >> 5),
                     (f.x != 0.f ? 1u : 0u) << (j & 31) |
                         (f.y != 0.f ? 2u : 0u) << (j & 31));
          const float d0 = v0 ? dp[nb][2 * hf] * f.x : 0.f;
          const float d1 = v1 ? dp[nb][2 * hf + 1] * f.y : 0.f;
          dp[nb][2 * hf] = d0;
          dp[nb][2 * hf + 1] = d1;
          rs[hf] += d0 * s[nb][2 * hf] + d1 * s[nb][2 * hf + 1];
        }
      rs[0] = attn::quad_sum(rs[0]);
      rs[1] = attn::quad_sum(rs[1]);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + g + (e >> 1) * 8, j = nb * 8 + 2 * t + (e & 1);
          dp[nb][e] = i < L && j < L
                          ? rnd<bf16>((dp[nb][e] - rs[e >> 1]) * s[nb][e] *
                                      a.scale)
                          : 0.f;
        }
      if (t == 0)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = hl * attn::kRows + r0 + g + hf * 8;
          mrow[i] = mx[hf];
          lrow[i] = z[hf];
          drow[i] = rs[hf];
        }
      float dq[8][4];
      attn::pv16(dp, K, Ph, hdp, dq);
      store_head(dq, r0, L, hdp, dqkv + c0, d.N3, colp + warp * 64);
    }
    __syncthreads();
    // the query pass's bias sums, in row-block order
    for (int i = tid; i < nh * hdp; i += attn::kThreads) {
      const int q = i / hdp, e = i - q * hdp;
      if (e < d.hd) {
        float s = 0.f;
        for (int rb = 0; rb < 4; ++rb) s += colp[(q * 4 + rb) * 64 + e];
        v_bqkv[(h0 + q) * d.hd + e] = s;
      }
    }
    // key pass (rows are keys): p^T from the row statistics, d_p^T =
    // (v d_o^T) * m, d_s^T, d_k = d_s^T q, d_v = pm^T d_o (in this order,
    // so that at most three 16 x 64 tiles are live)
    if (work) {
      float s[8][4], fk[8][4], dp[8][4];
      attn::scores16(K, Ph, Q, Ph, r0, hdp, s);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = r0 + g + (e >> 1) * 8, i = nb * 8 + 2 * t + (e & 1);
          float p = 0.f, f = 0.f;
          if (i < L && j < L) {
            const int q = hl * attn::kRows + i;
            p = expf(s[nb][e] * a.scale - mrow[q]) / lrow[q];
            if (a.drop.mode == kDropSeed)
              f = kbits[(hl * attn::kRows + i) * 2 + (j >> 5)] >> (j & 31) & 1u
                      ? a.drop.inv_keep
                      : 0.f;
            else
              f = dr.at1(0, LLH, ((long)h * L + i) * L + j);
          }
          s[nb][e] = p;
          fk[nb][e] = f;
        }
      attn::scores16(V, Ph, DO, P0, r0, hdp, dp);  // d_pm^T
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = r0 + g + (e >> 1) * 8, i = nb * 8 + 2 * t + (e & 1);
          dp[nb][e] = i < L && j < L
                          ? rnd<bf16>((dp[nb][e] * fk[nb][e] -
                                       drow[hl * attn::kRows + i]) *
                                      s[nb][e] * a.scale)
                          : 0.f;
          s[nb][e] = rnd<bf16>(s[nb][e] * fk[nb][e]);  // pm^T
        }
      float o[8][4];
      attn::pv16(dp, Q, Ph, hdp, o);  // d_k
      store_head(o, r0, L, hdp, dqkv + d.innerp + c0, d.N3,
                 colp + 512 + warp * 64);
      attn::pv16(s, DO, P0, hdp, o);  // d_v
      store_head(o, r0, L, hdp, dqkv + 2 * d.innerp + c0, d.N3,
                 colp + 2 * 512 + warp * 64);
    }
    __syncthreads();
    for (int i = tid; i < 2 * nh * hdp; i += attn::kThreads) {
      const int m = 1 + i / (nh * hdp), rest = i % (nh * hdp);
      const int q = rest / hdp, e = rest - q * hdp;
      if (e < d.hd) {
        float s = 0.f;
        for (int rb = 0; rb < 4; ++rb)
          s += colp[m * 512 + (q * 4 + rb) * 64 + e];
        v_bqkv[m * d.inner + (h0 + q) * d.hd + e] = s;
      }
    }
  }
  // dx = d_r1 + dq Wq^T + dk Wk^T + dv Wv^T, in that order
  for (int m = 0; m < 3; ++m) {
    __syncthreads();  // R1's last reader is done
    {
      bf16* const dst[1] = {R1};
      const bf16* const src[1] = {dqkv + m * d.innerp};
      load_rows<1>(dst, src, 1, P0, d.N3, L, d.innerp);
    }
    attn::rows_gemm<true>(R1, P0, w.wqkv + m * d.innerp, d.N3, d.innerp, Dp,
                          sm.ring, attn::NoGather{},
                          [&](int r, int c, float2 v, float) {
                            F[r * Wp + c] += v.x;
                            F[r * Wp + c + 1] += v.y;
                          });
  }
  __syncthreads();
  bf16* dx = a.dx + b * LD;
  for (int i = tid; i < L * D; i += attn::kThreads) {
    const int r = i / D, c = i - r * D;
    dx[i] = __float2bfloat16(F[r * Wp + c]);
  }
}

// One dW = A^T Y product of the four: the padded operands (rows b * L + i),
// the padded output size, and its fp32 partials (one M x N tile per chunk).
struct DwProduct {
  const bf16* A;
  const bf16* Y;
  int M, N;  // padded: Ka, Ky
  float* part;
};

struct DwArgs {
  DwProduct p[4];
  int tiles[4];  // output tiles of 64 x 128 of each product
  long rows, chunk;
};

// blockIdx.x: an output tile of one product; blockIdx.y: a chunk of rows
__global__ void __launch_bounds__(mma::kThreads)
    attention_dw_mma_kernel(const DwArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int tile = blockIdx.x, k = 0;
  while (k < 3 && tile >= a.tiles[k]) tile -= a.tiles[k++];
  const DwProduct& p = a.p[k];
  const int col_tiles = (p.N + mma::kBN - 1) / mma::kBN;
  const int m0 = (tile / col_tiles) * mma::kBM;
  const int n0 = (tile % col_tiles) * mma::kBN;
  const long r0 = (long)blockIdx.y * a.chunk;
  const long left = a.rows - r0;
  const int K = left <= 0 ? 0 : (int)(left < a.chunk ? left : a.chunk);
  float* out = p.part + (long)blockIdx.y * p.M * p.N;
  const int N = p.N;
  mma::gemm_tile<false, false>(
      p.A + r0 * p.M, p.M, p.Y + r0 * p.N, p.N, p.M, p.N, K, m0, n0, smem,
      [&](int r, int c, float v) { out[(long)r * N + c] = v; });
}

struct DwReduce {
  const float* part[4];
  float* out[4];
  int M[4], N[4];    // padded
  int Ka[4], Ky[4];  // real
  bool row_heads[4], col_heads[4];  // axes padded per head (hd -> hdp)
  long start[5];     // first real element of each output
  int chunks, hd, hdp;
};

// out (real layout) = the sum of the chunks' partials, in chunk order
__global__ void __launch_bounds__(256)
    attention_dw_reduce_kernel(const DwReduce a) {
  const long idx = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (idx >= a.start[4]) return;
  int k = 0;
  while (idx >= a.start[k + 1]) ++k;
  const long j = idx - a.start[k];
  const int r = (int)(j / a.Ky[k]), c = (int)(j % a.Ky[k]);
  const int pr = a.row_heads[k] ? (r / a.hd) * a.hdp + r % a.hd : r;
  const int pc = a.col_heads[k] ? (c / a.hd) * a.hdp + c % a.hd : c;
  const long stride = (long)a.M[k] * a.N[k];
  const float* p = a.part[k] + (long)pr * a.N[k] + pc;
  float s = 0.f;
  for (int z = 0; z < a.chunks; ++z) s += p[z * stride];
  a.out[k][j] = s;
}

struct MmaLayout {
  attn::Dims d;
  attn::Packed pk;
  size_t off_u, off_f, off_stats, off_vec, off_ring, smem;
  // device workspace, byte offsets
  size_t packed, xp, qkv, o, h1, g1m, dqkv, dattn, du, dz, xhat1, u, vec,
      part[4], vpart, total;
  long chunk;
};

bool mma_layout(long B, int L, int D, int inner, int FF, int H,
                MmaLayout& l) {
  attn::Dims& d = l.d;
  if (!attn::make_dims(L, D, inner, FF, H, d)) return false;
  l.pk = attn::packed_layout(d);
  const size_t r0 = align16((size_t)attn::kRows * d.P0 * 2);
  const size_t f = r0 + align16((size_t)attn::kRows * d.P0 * 2);
  const size_t u_end_qkv = r0 + align16((size_t)attn::kRows * d.Pqkv * 2);
  const size_t u_end_f = f + align16((size_t)attn::kRows * d.Wp * 4);
  l.off_u = r0;
  l.off_f = f;
  l.off_stats = u_end_qkv > u_end_f ? u_end_qkv : u_end_f;
  // inv1, inv2; three rows of statistics for two heads; 3 x 8 x 64
  // partials; the keep bits of two heads (4 words a row)
  l.off_vec = l.off_stats + align16((size_t)(2 + 6 + 24 + 4) * attn::kRows * 4);
  l.off_ring = l.off_vec + align16((size_t)attn::vector_floats(d) * 4);
  l.smem = l.off_ring + attn::kRingBytes;
  const size_t heads = (size_t)6 * attn::kRows * (d.hdp + attn::kPad) * 2;
  if (l.smem > kMaxSmem || heads > (size_t)attn::kRingBytes) return false;

  const size_t rows = (size_t)B * L;
  size_t o = 0;
  auto take = [&](size_t bytes) {
    const size_t at = o;
    o += align256(bytes);
    return at;
  };
  l.packed = take(l.pk.bytes);
  l.xp = take(rows * d.Dp * 2);
  l.qkv = take(rows * d.N3 * 2);
  l.o = take(rows * d.innerp * 2);
  l.h1 = take(rows * d.Dp * 2);
  l.g1m = take(rows * d.FFp * 2);
  l.dqkv = take(rows * d.N3 * 2);
  l.dattn = take(rows * d.Dp * 2);
  l.du = take(rows * d.FFp * 2);
  l.dz = take(rows * d.Dp * 2);
  l.xhat1 = take(rows * d.Dp * 4);
  l.u = take(rows * d.FFp * 4);
  const size_t nv = (size_t)3 * inner + 6 * D + FF;
  l.vec = take((size_t)B * nv * 4);
  const size_t sizes[4] = {(size_t)d.Dp * d.N3, (size_t)d.innerp * d.Dp,
                           (size_t)d.Dp * d.FFp, (size_t)d.FFp * d.Dp};
  for (int k = 0; k < 4; ++k) l.part[k] = take(kMmaChunks * sizes[k] * 4);
  l.vpart = take((size_t)kMmaChunks * nv * 4);
  l.total = o;
  long chunk = ((long)rows + kMmaChunks - 1) / kMmaChunks;
  l.chunk = (chunk + mma::kBK - 1) / mma::kBK * mma::kBK;
  return true;
}

int launch_mma(const MmaLayout& l, const void* x, const void* g,
               const void* const* w, void* dx, float* const* out,
               unsigned char* ws, long B, const Dropout& drop,
               cudaStream_t s) {
  const attn::Dims& d = l.d;
  cudaError_t e = attn::pack_weights(d, w, ws + l.packed, s);
  if (e != cudaSuccess) return (int)e;
  auto at = [&](size_t off) { return reinterpret_cast<bf16*>(ws + off); };
  auto at32 = [&](size_t off) { return reinterpret_cast<float*>(ws + off); };
  MmaBwdArgs a;
  a.d = d;
  a.w = attn::weights_at(ws + l.packed, l.pk);
  a.scale = (float)(1.0 / std::sqrt((double)d.hd));
  a.drop = drop;
  a.x = static_cast<const bf16*>(x);
  a.g = static_cast<const bf16*>(g);
  a.dx = static_cast<bf16*>(dx);
  a.xp = at(l.xp), a.qkv = at(l.qkv), a.o = at(l.o), a.h1 = at(l.h1);
  a.g1m = at(l.g1m), a.dqkv = at(l.dqkv), a.dattn = at(l.dattn);
  a.du = at(l.du), a.dz = at(l.dz);
  a.xhat1 = at32(l.xhat1), a.u = at32(l.u), a.vec = at32(l.vec);
  a.off_u = l.off_u, a.off_f = l.off_f, a.off_stats = l.off_stats;
  a.off_vec = l.off_vec, a.off_ring = l.off_ring;
  e = cudaFuncSetAttribute(attention_bwd_mma_rows_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)l.smem);
  if (e != cudaSuccess) return (int)e;
  attention_bwd_mma_rows_kernel<<<(unsigned)B, attn::kThreads, l.smem, s>>>(
      a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // dWq|dWk|dWv = x^T [dq|dk|dv];  dWo = o^T d_attn;  dW1 = h1^T d_u;
  // dW2 = g1m^T d_z
  DwArgs dw;
  const bf16* A[4] = {a.xp, a.o, a.h1, a.g1m};
  const bf16* Y[4] = {a.dqkv, a.dattn, a.du, a.dz};
  const int M[4] = {d.Dp, d.innerp, d.Dp, d.FFp};
  const int N[4] = {d.N3, d.Dp, d.FFp, d.Dp};
  int n_tiles = 0;
  for (int k = 0; k < 4; ++k) {
    dw.p[k] = {A[k], Y[k], M[k], N[k], at32(l.part[k])};
    dw.tiles[k] = (M[k] / mma::kBM) * ((N[k] + mma::kBN - 1) / mma::kBN);
    n_tiles += dw.tiles[k];
  }
  dw.rows = B * d.L;
  dw.chunk = l.chunk;
  e = cudaFuncSetAttribute(attention_dw_mma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           mma::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  attention_dw_mma_kernel<<<dim3((unsigned)n_tiles, kMmaChunks),
                            mma::kThreads, mma::kSmemBytes, s>>>(dw);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  DwReduce red;
  const int Ka[4] = {d.D, d.inner, d.D, d.FF};
  const int Ky[4] = {3 * d.inner, d.D, d.FF, d.D};
  red.start[0] = 0;
  for (int k = 0; k < 4; ++k) {
    red.part[k] = at32(l.part[k]);
    red.out[k] = out[k];
    red.M[k] = M[k], red.N[k] = N[k], red.Ka[k] = Ka[k], red.Ky[k] = Ky[k];
    red.row_heads[k] = k == 1;
    red.col_heads[k] = k == 0;
    red.start[k + 1] = red.start[k] + (long)Ka[k] * Ky[k];
  }
  red.chunks = kMmaChunks;
  red.hd = d.hd;
  red.hdp = d.hdp;
  attention_dw_reduce_kernel<<<(unsigned)((red.start[4] + 255) / 256), 256,
                               0, s>>>(red);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // bias and LayerNorm gradients: per-sample vectors summed over the batch
  const long nv = (long)3 * d.inner + 6 * d.D + d.FF;
  float* vpart = at32(l.vpart);
  e = sum_rows(a.vec, B, nv, kMmaChunks, vpart, s);
  if (e == cudaSuccess) e = sum_rows(vpart, kMmaChunks, nv, 1, out[4], s);
  return (int)e;
}

}  // namespace

// Which design a dtype takes: "mma_bf16" (tensor cores) or "fma_fp32".
extern "C" const char* eid_attention_bwd_design(int dtype) {
  return dtype == kBF16 ? "mma_bf16" : "fma_fp32";
}

// Bytes of device workspace eid_attention_bwd needs, or -1 for shapes it
// does not take.
extern "C" long long eid_attention_bwd_workspace(int dtype, int B, int L,
                                                 int D, int inner, int FF,
                                                 int H) {
  if (!supported(dtype, L, D, inner, FF, H)) return -1;
  if (dtype == kBF16) {
    MmaLayout l;
    return mma_layout(B, L, D, inner, FF, H, l) ? (long long)l.total : -1;
  }
  return (long long)layout(dtype, B, L, D, inner, FF, H).total;
}

// x, g, dx: (B, L, D) in dtype; w: the 16 parameters in dtype (as
// eid_attention_fwd); wt: wq^T, wk^T, wv^T, wo^T, w1^T, w2^T contiguous in
// dtype, read by the float32 design only (null for bfloat16, which reads
// its packed weights K-major); out (fp32): dWq|dWk|dWv (D, 3 inner), dWo
// (inner, D), dW1 (D, FF), dW2 (FF, D), and the vector [bq bk bv bo b1 b2
// ln1_s ln1_b ln2_s ln2_b]; ws: eid_attention_bwd_workspace bytes. Dropout
// arguments as eid_attention_fwd's; a seeded mask's kept value is inv_keep
// unrounded.
extern "C" int eid_attention_bwd(int dtype, const void* x, const void* g,
                                 const void* const* w, const void* const* wt,
                                 void* dx, float* const* out, void* ws,
                                 int B, int L, int D, int inner, int FF,
                                 int H, int drop_mode,
                                 const void* const* masks, const int* seed,
                                 unsigned thresh, float inv_keep,
                                 unsigned sample0, void* stream) {
  if (B <= 0) return 0;
  if (!supported(dtype, L, D, inner, FF, H)) return (int)cudaErrorInvalidValue;
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
  unsigned char* base = static_cast<unsigned char*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    MmaLayout ml;
    if (!mma_layout(B, L, D, inner, FF, H, ml))
      return (int)cudaErrorInvalidValue;
    return launch_mma(ml, x, g, w, dx, out, base, B, drop, s);
  }
  const Layout l = layout(dtype, B, L, D, inner, FF, H);
  if (l.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.x = x;
  a.g = g;
  for (int i = 0; i < 16; ++i) a.w[i] = w[i];
  for (int i = 0; i < 6; ++i) a.wt[i] = wt[i];
  a.dx = dx;
  a.qkv = base + l.qkv;
  a.prob = reinterpret_cast<float*>(base + l.prob);
  a.xhat1 = reinterpret_cast<float*>(base + l.xhat1);
  a.u = reinterpret_cast<float*>(base + l.u);
  a.dqkv = base + l.dqkv;
  a.o = base + l.o;
  a.dattn = base + l.dattn;
  a.h1 = base + l.h1;
  a.dz = base + l.dz;
  a.du = base + l.du;
  a.g1m = base + l.g1m;
  a.vec = reinterpret_cast<float*>(base + l.vec);
  a.spill = base + l.spill;
  a.L = L;
  a.D = D;
  a.inner = inner;
  a.FF = FF;
  a.H = H;
  a.scale = (float)(1.0 / std::sqrt((double)(inner / H)));
  a.off_f1 = l.off_f1;
  a.off_stats = l.off_stats;
  a.off_r = l.off_r;
  a.r_bytes = l.r_bytes;
  for (int i = 0; i < kRCount; ++i) a.r[i] = l.r[i];
  a.r_in_smem = l.r_in_smem;
  a.drop = drop;
  return launch<float>(l, a, B, base, out, s);
}
