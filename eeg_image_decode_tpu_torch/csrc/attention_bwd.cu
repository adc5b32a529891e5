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
// Design (two passes, no float atomics, so a step is bit-reproducible):
//
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
// Bound on the H100 (ATM-S, B 1024): the recompute and the two products per
// forward product make ~3 x 52 MFLOP per sample, 160 GFLOP, ~0.16 ms at the
// bf16 tensor-core peak; x, g and dx are 98 MB (~0.03 ms). The kernel is
// far from that bound: its products are fp32 FMA loops with the weights
// streamed from L2, one block per SM (194 KB of shared memory in bf16), and
// the second pass moves ~0.6 GB of per-row operands. Tensor-core products
// and fusing the dW products into the first pass are the next steps.
//
// Shared memory per block: A1 (L x D, working type: x, h1, d_z, d_attn), F1
// (L x D fp32: r1, xhat1, r2, xhat2, d_r2, d_h1, d_r1 = dx), two rows of
// LN statistics, and a region R that phases share: A2 (L x max(inner, FF):
// o, g1m, d_u, one of dq/dk/dv) with F2 (L x FF fp32: d_u), or the buffers
// of one head. 194 KB in bf16. In fp32 R does not fit beside the rest, and
// lives in device scratch, one slice per sample (the kernel is otherwise
// the same).

#include <cmath>

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

}  // namespace

// Bytes of device workspace eid_attention_bwd needs, or -1 for shapes it
// does not take.
extern "C" long long eid_attention_bwd_workspace(int dtype, int B, int L,
                                                 int D, int inner, int FF,
                                                 int H) {
  if (!supported(dtype, L, D, inner, FF, H)) return -1;
  return (long long)layout(dtype, B, L, D, inner, FF, H).total;
}

// x, g, dx: (B, L, D) in dtype; w: the 16 parameters in dtype (as
// eid_attention_fwd); wt: wq^T, wk^T, wv^T, wo^T, w1^T, w2^T contiguous in
// dtype; out (fp32): dWq|dWk|dWv (D, 3 inner), dWo (inner, D), dW1 (D, FF),
// dW2 (FF, D), and the vector [bq bk bv bo b1 b2 ln1_s ln1_b ln2_s ln2_b];
// ws: eid_attention_bwd_workspace bytes. Dropout arguments as
// eid_attention_fwd's; a seeded mask's kept value is inv_keep unrounded.
extern "C" int eid_attention_bwd(int dtype, const void* x, const void* g,
                                 const void* const* w, const void* const* wt,
                                 void* dx, float* const* out, void* ws,
                                 int B, int L, int D, int inner, int FF,
                                 int H, int drop_mode,
                                 const void* const* masks, const int* seed,
                                 unsigned thresh, float inv_keep,
                                 void* stream) {
  if (B <= 0) return 0;
  if (!supported(dtype, L, D, inner, FF, H)) return (int)cudaErrorInvalidValue;
  if (drop_mode < kDropNone || drop_mode > kDropSeed ||
      (drop_mode == kDropSeed && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  const Layout l = layout(dtype, B, L, D, inner, FF, H);
  if (l.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(ws);
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
  a.drop.mode = drop_mode;
  for (int i = 0; i < 4; ++i) a.drop.mask[i] = masks[i];
  a.drop.seed = seed;
  a.drop.thresh = thresh;
  a.drop.inv_keep = inv_keep;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch<__nv_bfloat16>(l, a, B, base, out, s);
  return launch<float>(l, a, B, base, out, s);
}
