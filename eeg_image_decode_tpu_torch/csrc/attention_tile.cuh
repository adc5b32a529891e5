// bf16 tensor-core tile code of the attention layer, shared by its forward
// (csrc/attention_fwd.cu) and by its backward's recompute
// (csrc/attention_bwd.cu).
//
// One block of 256 threads owns one sample: its L <= 64 token rows are one
// 64-row tile, and every width is zero-padded to a multiple of 64 (D 250 ->
// 256, FF 256, inner 4 x 62 -> 4 x 64: each head's columns start at h * hdp
// and its padding columns are zero). Zeros add nothing to a product, and the
// LayerNorms and softmaxes run over the real columns only, so the padding is
// exact. Rows L..63 are zero in every operand and masked in the softmax.
//
// The weights are packed once per launch (pack_weights, in attention_fwd.cu)
// into that padded layout, bf16 matrices and fp32 vectors, so every product
// streams its B operand through 16-byte cp.async copies without guards:
// Wq|Wk|Wv as one (Dp, 3 innerp) matrix, Wo (innerp, Dp), W1 (Dp, FFp), W2
// (FFp, Dp). The backward reads the same packed matrices as K-major B
// operands (ldmatrix without .trans) for its products with W^T.
//
// rows_gemm: C (64 x N) = A (64 x K, bf16 in shared memory) B (K x N, bf16
// in device memory), N <= 256, mma.sync.m16n8k16 with fp32 accumulators.
// Eight warps as 2 x 4, each 32 x 64 of C; B goes through a three-stage
// cp.async ring of 32-deep slices; A stays in shared memory, read by
// ldmatrix. The epilogue gets every element of C (all 64 rows, all N
// padded columns), so each product overwrites its target whole.
//
// The heads: one warp per (head, 16 query rows). The 16 x 64 scores stay in
// registers; the fp32 softmax reduces over the four lanes that share a row;
// the rounded probabilities become the A fragments of P V without leaving
// the registers (the accumulator layout of m16n8 is the A layout of m16k16).
// scores16 and pv16 are the two products; the backward's softmax passes use
// them with other operands.
//
// layer_chain runs the whole layer for one sample under one of two
// rounding policies, the template flag kFwd:
// - kFwd (the JAX _kernel): each dense's product is rounded before its bias
//   is added in bf16; the residual stream, h1 and the probabilities are
//   rounded; a seeded mask's kept value is 1/keep rounded to bf16.
// - !kFwd (the recompute of the JAX _bwd_kernel): the bias is added to the
//   fp32 product before one rounding; the output projection, the residuals
//   and h1 stay fp32; the kept value is 1/keep in fp32. It also saves what
//   the backward needs (the padded x copy, q|k|v, o, xhat1, h1, u, g1m) and
//   leaves xhat2 in the fp32 rows F.
// The two kernels follow their JAX kernels point for point, so the policies
// are not merged (ROADMAP.md).
#pragma once

#include <cstdint>

#include "common.cuh"
#include "mma_tile.cuh"
#include "philox.cuh"

namespace eid {
namespace attn {

using mma::bf16;

constexpr int kThreads = 256;
constexpr int kRows = 64;   // one sample's token rows, padded
constexpr int kMaxW = 256;  // the largest padded width
constexpr int kMaxHd = 64;  // the largest padded head width
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kPad = 8;
// one ring stage: a 32-deep slice of B, MN-major s[k][n] (32 x 264) or
// K-major s[n][k] (256 x 40), whichever is larger
constexpr int kStageElems = kMaxW * (kBK + kPad);
constexpr int kRingBytes = kStages * kStageElems * 2;  // 61,440

struct Dims {
  int L, D, inner, FF, H, hd;      // the layer's
  int Dp, FFp, hdp, innerp, N3;    // padded: multiples of 64 (hdp of 16)
  int Wp;                          // max(Dp, FFp, innerp)
  int P0, Pqkv;                    // pitches of the bf16 row buffers
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The padded sizes; false for shapes the design does not take (L > 64, a
// padded width above 256, a padded head above 64).
inline bool make_dims(int L, int D, int inner, int FF, int H, Dims& d) {
  if (L < 1 || L > kRows || D < 1 || FF < 1 || H < 1 || inner < H ||
      inner % H != 0)
    return false;
  d.L = L, d.D = D, d.inner = inner, d.FF = FF, d.H = H, d.hd = inner / H;
  d.Dp = round_up(D, 64);
  d.FFp = round_up(FF, 64);
  int hdp = round_up(d.hd, 16);
  while ((H * hdp) % 64 != 0) hdp += 16;
  d.hdp = hdp;
  d.innerp = H * hdp;
  d.N3 = 3 * d.innerp;
  d.Wp = d.Dp > d.FFp ? d.Dp : d.FFp;
  if (d.innerp > d.Wp) d.Wp = d.innerp;
  // pitches of an odd number of 16-byte units: the eight rows of an
  // ldmatrix phase fall on eight different bank groups
  d.P0 = d.Wp + kPad;
  d.Pqkv = d.N3 + kPad;
  return d.Dp <= kMaxW && d.FFp <= kMaxW && d.innerp <= kMaxW &&
         d.hdp <= kMaxHd;
}

// The packed weights: bf16 matrices, then (at v_off bytes) fp32 vectors.
struct Packed {
  long wqkv, wo, w1, w2, n_w;                            // bf16 elements
  int bqkv, bo, ln1_s, ln1_b, b1, b2, ln2_s, ln2_b, n_v;  // fp32 elements
  size_t v_off, bytes;
};

inline size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

inline Packed packed_layout(const Dims& d) {
  Packed p;
  long o = 0;
  p.wqkv = o, o += (long)d.Dp * d.N3;
  p.wo = o, o += (long)d.innerp * d.Dp;
  p.w1 = o, o += (long)d.Dp * d.FFp;
  p.w2 = o, o += (long)d.FFp * d.Dp;
  p.n_w = o;
  int v = 0;
  p.bqkv = v, v += d.N3;
  p.bo = v, v += d.Dp;
  p.ln1_s = v, v += d.Dp;
  p.ln1_b = v, v += d.Dp;
  p.b1 = v, v += d.FFp;
  p.b2 = v, v += d.Dp;
  p.ln2_s = v, v += d.Dp;
  p.ln2_b = v, v += d.Dp;
  p.n_v = v;
  p.v_off = align256((size_t)o * 2);
  p.bytes = p.v_off + align256((size_t)v * 4);
  return p;
}

// Device view of the packed weights.
struct Weights {
  const bf16 *wqkv, *wo, *w1, *w2;
  const float *bqkv, *bo, *ln1_s, *ln1_b, *b1, *b2, *ln2_s, *ln2_b;
};

inline Weights weights_at(const void* ws, const Packed& p) {
  const bf16* w = static_cast<const bf16*>(ws);
  const float* v = reinterpret_cast<const float*>(
      static_cast<const unsigned char*>(ws) + p.v_off);
  return {w + p.wqkv, w + p.wo, w + p.w1, w + p.w2,
          v + p.bqkv, v + p.bo, v + p.ln1_s, v + p.ln1_b,
          v + p.b1, v + p.b2, v + p.ln2_s, v + p.ln2_b};
}

// Packs the 16 parameters w (bf16, in PARAM_ORDER) into ws
// (packed_layout(d).bytes); defined in attention_fwd.cu.
cudaError_t pack_weights(const Dims& d, const void* const* w, void* ws,
                         cudaStream_t s);

// padded column c of q|k|v (or of one of q, k, v when c < innerp) -> real
// column, or -1 in a head's padding
__device__ __forceinline__ int real_col(const Dims& d, int c) {
  const int g = c / d.hdp, e = c - g * d.hdp;
  return e < d.hd ? g * d.hd + e : -1;
}

// ——— C (64 x N) = A (shared) B (device), N <= 256 ———

// The epilogue. The accumulators of one 32-row half of C go through the
// ring (free once the products are done) as fp32, and all 256 threads then
// walk that half by pairs of neighbouring columns (c even), consecutive
// threads on consecutive pairs of a row: a rolled loop, four pairs at a
// time, first gather(r, c) for the four (device loads issue back to back),
// then epi(r, c, {C(r, c), C(r, c + 1)}, gathered). Unrolled over a warp's
// fragments instead, the epilogues were the larger part of the layer's time
// (one copy of their code per element runs once per sample, from outside
// the instruction cache) and their device accesses were scattered.
struct NoGather {
  __device__ __forceinline__ float operator()(int, int) const { return 0.f; }
};

constexpr int kStagePitch = kMaxW + 8;  // fp32 pitch of the staged half
static_assert(32 * kStagePitch * 4 <= kRingBytes, "a staged half fits");

template <bool B_KMAJOR, typename Gather, typename Epi>
__device__ __forceinline__ void rows_gemm(const bf16* As, int lda,
                                          const bf16* Bg, long ldb, int K,
                                          int N, bf16* ring, Gather gather,
                                          Epi epi) {
  constexpr int kPB = B_KMAJOR ? kBK + kPad : kMaxW + kPad;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 64;
  const bool active = wn < N;
  const int nk = K / kBK;
  // this thread's 16-byte chunks of a slice (at most four): MN-major, 32
  // rows of N / 8 chunks; K-major, N rows of 4 chunks
  const int per_row = B_KMAJOR ? kBK / 8 : N / 8;
  const int n_chunks = B_KMAJOR ? N * (kBK / 8) : kBK * (N / 8);
  int dst[4];
  const bf16* src[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int c = threadIdx.x + u * kThreads;
    const int o = c / per_row, i = (c - o * per_row) * 8;
    dst[u] = o * kPB + i;
    src[u] = Bg + (long)o * ldb + i;
  }
  const long step = B_KMAJOR ? (long)kBK : (long)kBK * ldb;
  auto load = [&](int kt) {
    bf16* s = ring + (kt % kStages) * kStageElems;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (threadIdx.x + u * kThreads < n_chunks)
        mma::cp_async16(s + dst[u], src[u] + kt * step);
  };

  const uint32_t a_lane =
      2 * ((wm + (lane & 15)) * lda + (lane >> 4) * 8);
  const uint32_t b_lane =
      2 * (B_KMAJOR ? (wn + (lane & 7) + ((lane >> 4) << 3)) * kPB +
                          ((lane >> 3) & 1) * 8
                    : ((lane & 7) + ((lane >> 3) & 1) * 8) * kPB + wn +
                          (lane >> 4) * 8);
  const uint32_t a0 = mma::smem_u32(As), r0 = mma::smem_u32(ring);

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  __syncthreads();  // the previous users of the ring and of the target
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    mma::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt has landed; slice kt-1 is consumed
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    mma::cp_async_commit();
    if (active) {
      const uint32_t st = r0 + (kt % kStages) * (kStageElems * 2);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t a[2][4], b[4][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma::ldsm_x4(a[i], a0 + a_lane + 2 * (i * 16 * lda + kt * kBK + kk));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (B_KMAJOR)
            mma::ldsm_x4(b[j], st + b_lane + 2 * (j * 16 * kPB + kk));
          else
            mma::ldsm_x4_trans(b[j], st + b_lane + 2 * (kk * kPB + j * 16));
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            mma::mma_bf16(acc[i][j], a[i], b[j >> 1][(j & 1) * 2],
                          b[j >> 1][(j & 1) * 2 + 1]);
      }
    }
  }
  mma::cp_async_wait<0>();
  float* stage = reinterpret_cast<float*>(ring);
  const int g = lane >> 2, c0 = wn + 2 * (lane & 3);
  const int np = N / 2, half_pairs = 32 * np;
  // this thread's first four pairs (row, pair column) and the step of four
  // pairs' worth of threads, kept by addition: no division per pair
  int sr0[4], cp0[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    sr0[u] = (threadIdx.x + u * kThreads) / np;
    cp0[u] = threadIdx.x + u * kThreads - sr0[u] * np;
  }
  const int step_r = 4 * kThreads / np, step_c = 4 * kThreads - step_r * np;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    __syncthreads();  // the ring's last reader is done
    if (active)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              stage + ((wm >> 1) + g + h * 8) * kStagePitch + c0 + j * 8) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    __syncthreads();
    // stage row sr = q * 16 + x (q: the warp-row group, x < 16) is row
    // q * 32 + i * 16 + x of C
    int sr[4], cp[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) sr[u] = sr0[u], cp[u] = cp0[u];
#pragma unroll 1
    for (int base = threadIdx.x; base < half_pairs; base += 4 * kThreads) {
      using V = decltype(gather(0, 0));
      V pre[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (base + u * kThreads < half_pairs)
          pre[u] = gather((sr[u] >> 4) * 32 + i * 16 + (sr[u] & 15),
                          2 * cp[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (base + u * kThreads < half_pairs)
          epi((sr[u] >> 4) * 32 + i * 16 + (sr[u] & 15), 2 * cp[u],
              *reinterpret_cast<const float2*>(stage + sr[u] * kStagePitch +
                                               2 * cp[u]),
              pre[u]);
        sr[u] += step_r;
        cp[u] += step_c;
        if (cp[u] >= np) cp[u] -= np, ++sr[u];
      }
    }
  }
}

// two neighbouring bf16 values as floats, and back (4-byte aligned)
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// elements e, e + 1 of a bf16 array whose alignment is not known
__device__ __forceinline__ float2 ld2u(const bf16* p, long e) {
  return (e & 1) == 0 ? ld2(p + e)
                      : make_float2(to_f(p[e]), to_f(p[e + 1]));
}

// Copies rows [0, L) x [0, cols) of a row-major bf16 array (row length ld)
// into s (pitch ps), zeros over [0, 64) x [0, width) (width a multiple of
// 64); eight loads per thread are in flight at a time. Optionally a second
// copy of rows < L at pitch `width` into dup.
__device__ __forceinline__ void load_tile(bf16* s, int ps, const bf16* src,
                                          int ld, int L, int cols, int width,
                                          bf16* dup = nullptr) {
  // element i = r * width + c, kept as (r, c) by addition
  const int step_r = kThreads / width, step_c = kThreads - step_r * width;
  int r = threadIdx.x / width, c = threadIdx.x - r * width;
  for (int it = 0; it < kRows * width / kThreads; it += 8) {
    bf16 v[8];
    int rr[8], cc[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      rr[u] = r, cc[u] = c;
      v[u] = it + u < kRows * width / kThreads && r < L && c < cols
                 ? src[(long)r * ld + c]
                 : __float2bfloat16(0.f);
      r += step_r;
      c += step_c;
      if (c >= width) c -= width, ++r;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (it + u < kRows * width / kThreads) {
        s[rr[u] * ps + cc[u]] = v[u];
        if (dup != nullptr && rr[u] < L) dup[(long)rr[u] * width + cc[u]] = v[u];
      }
    }
  }
}

// The packed fp32 vectors (w.bqkv .. w.ln2_b + Dp, contiguous) into s;
// returns w with its vectors there. The epilogues and row passes read them
// on every element.
__device__ __forceinline__ Weights stage_vectors(const Weights& w, int Dp,
                                                 float* s) {
  const int n = (int)(w.ln2_b - w.bqkv) + Dp;
  for (int i = threadIdx.x; i < n; i += kThreads) s[i] = w.bqkv[i];
  Weights o = w;
  o.bqkv = s;
  o.bo = s + (w.bo - w.bqkv);
  o.ln1_s = s + (w.ln1_s - w.bqkv);
  o.ln1_b = s + (w.ln1_b - w.bqkv);
  o.b1 = s + (w.b1 - w.bqkv);
  o.b2 = s + (w.b2 - w.bqkv);
  o.ln2_s = s + (w.ln2_s - w.bqkv);
  o.ln2_b = s + (w.ln2_b - w.bqkv);
  return o;
}

// floats of the staged vectors
inline int vector_floats(const Dims& d) { return d.N3 + 6 * d.Dp + d.FFp; }

// ——— the per-head products of one warp: 16 rows at a time ———

// s (16 x 64) = A[r0 .. r0+15] B^T over kHd-deep rows: A and B hold their
// rows K-contiguous (q and k of a head, or d_o and v, ...) with pitches pa
// and pb; depth hdp (a multiple of 16, at most 64). s[nb][e]: row g
// (e < 2) or g + 8, column nb * 8 + 2t + (e & 1).
__device__ __forceinline__ void scores16(const bf16* A, int pa, const bf16* B,
                                         int pb, int r0, int hdp,
                                         float (&s)[8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
  const bf16* ap = A + (r0 + (lane & 15)) * pa + (lane >> 4) * 8;
  const bf16* bp = B + ((lane & 7) + ((lane >> 4) << 3)) * pb +
                   ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kMaxHd; kk += 16) {
    if (kk < hdp) {
      uint32_t a[4];
      mma::ldsm_x4(a, ap + kk);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        mma::ldsm_x4(b, bp + jp * 16 * pb + kk);
        mma::mma_bf16(s[2 * jp], a, b[0], b[1]);
        mma::mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// o (16 x hdp) = P (16 x 64, the accumulator layout of scores16, values
// already bf16-exact) V (64 rows x hdp, N-contiguous, pitch pv).
// o[nb][e]: row g (e < 2) or g + 8, column nb * 8 + 2t + (e & 1).
__device__ __forceinline__ void pv16(const float (&p)[8][4], const bf16* V,
                                     int pv, int hdp, float (&o)[8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;
  const bf16* vp = V + ((lane & 7) + ((lane >> 3) & 1) * 8) * pv +
                   (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint32_t a[4] = {pack_bf16(p[2 * ks][0], p[2 * ks][1]),
                           pack_bf16(p[2 * ks][2], p[2 * ks][3]),
                           pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]),
                           pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3])};
#pragma unroll
    for (int np = 0; np < kMaxHd / 16; ++np) {
      if (np * 16 < hdp) {
        uint32_t b[4];
        mma::ldsm_x4_trans(b, vp + ks * 16 * pv + np * 16);
        mma::mma_bf16(o[2 * np], a, b[0], b[1]);
        mma::mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// LayerNorm rows, four at a time per warp so that their loads and
// reductions overlap: rows r = warp + 8 (k0 + k), k < 4, columns c = lane +
// 32 q (q < 8; D <= 256) of a row buffer into v (0 outside L x D), and
// each row's mean and 1/sigma (biased variance, eps 1e-6, two passes), in
// the order of common.cuh::row_mean_inv.
template <typename TS>
__device__ __forceinline__ void ln_rows4(const TS* base, int pitch, int L,
                                         int D, int k0, float (&v)[4][8],
                                         float (&mu)[4], float (&inv)[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = warp + 8 * (k0 + k);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = lane + 32 * q;
      v[k][q] = r < L && c < D ? to_f(base[r * pitch + c]) : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s[k] = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) s[k] += v[k][q];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    mu[k] = s[k] / (float)D;
    s[k] = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float dv = v[k][q] - mu[k];
      if (lane + 32 * q < D) s[k] += dv * dv;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
#pragma unroll
  for (int k = 0; k < 4; ++k) inv[k] = rsqrtf(s[k] / (float)D + 1e-6f);
}

// In place: s (scores of rows r0 + g, r0 + g + 8) -> fp32 softmax over the
// columns < L of s * scale (exp(v - max) / sum, as the plain versions);
// columns >= L get 0. mx, sum: each row's max and sum.
__device__ __forceinline__ void softmax16(float (&s)[8][4], int L,
                                          float scale, float (&mx)[2],
                                          float (&sum)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float m = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = nb * 8 + 2 * t + e < L ? s[nb][2 * hf + e] * scale
                                               : -INFINITY;
        s[nb][2 * hf + e] = v;
        m = fmaxf(m, v);
      }
    m = quad_max(m);
    float z = 0.f;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = nb * 8 + 2 * t + e < L
                            ? expf(s[nb][2 * hf + e] - m) : 0.f;
        s[nb][2 * hf + e] = x;
        z += x;
      }
    z = quad_sum(z);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) s[nb][2 * hf + e] /= z;
    mx[hf] = m;
    sum[hf] = z;
  }
}

// ——— one sample's layer ———

// The seeded draws out of line: the heads call them from fully unrolled
// loops, where sixty-odd inlined instructions per element would not stay in
// the instruction cache.
static __device__ __noinline__ uint32_t draw1(uint32_t seed, uint32_t sample,
                                              uint32_t site, uint32_t e) {
  return keep_bits(seed, sample, site, e);
}
static __device__ __noinline__ uint2 draw2(uint32_t seed, uint32_t sample,
                                    uint32_t site, uint32_t e) {
  return keep_bits2(seed, sample, site, e);
}

// What a launch drops out with, and the sample (of the launch; the draws
// key on b + d.sample0).
struct Drop {
  Dropout d;
  uint32_t seed;
  long b;
  // the factor of element e of site `site` (numel per sample): the mask's
  // bf16 value, or the kept value (1/keep rounded to bf16 under kFwd, fp32
  // otherwise) or 0
  // the factor of element e, the generator out of line (the key pass)
  __device__ __forceinline__ float at1(int site, long numel, long e) const {
    if (d.mode == kDropMasks)
      return to_f(static_cast<const bf16*>(d.mask[site])[b * numel + e]);
    if (d.mode == kDropSeed)
      return draw1(seed, (uint32_t)b + d.sample0, (uint32_t)site,
                   (uint32_t)e) < d.thresh
                 ? d.inv_keep
                 : 0.f;
    return 1.f;
  }
  // the factors of elements e and e + 1 (one generator call in seed mode);
  // a mask is read at e + 1 only when `both`. kOutOfLine: the generator
  // through draw2, for fully unrolled callers
  template <bool kFwd, bool kOutOfLine = false>
  __device__ __forceinline__ float2 at2(int site, long numel, long e,
                                        bool both) const {
    if (d.mode == kDropMasks) {
      const bf16* m = static_cast<const bf16*>(d.mask[site]) + b * numel;
      return make_float2(to_f(m[e]), both ? to_f(m[e + 1]) : 0.f);
    }
    if (d.mode == kDropSeed) {
      const float kept = kFwd ? rnd<bf16>(d.inv_keep) : d.inv_keep;
      const uint2 r =
          kOutOfLine
              ? draw2(seed, (uint32_t)b + d.sample0, (uint32_t)site,
                      (uint32_t)e)
              : keep_bits2(seed, (uint32_t)b + d.sample0, (uint32_t)site,
                           (uint32_t)e);
      return make_float2(r.x < d.thresh ? kept : 0.f,
                         r.y < d.thresh ? kept : 0.f);
    }
    return make_float2(1.f, 1.f);
  }
};

// Shared memory of one block, carved by the launchers.
struct Smem {
  float* vec;   // the staged fp32 vectors (vector_floats)
  bf16* R0;     // 64 x P0: x; o; the FFN hidden layer (fwd) / g1m (bwd)
  bf16* QKV;    // 64 x Pqkv: q|k|v. Aliased after the heads by
  bf16* XS;     //   fwd: the bf16 residual stream (pitch Pqkv)
  bf16* R1;     //   bwd: 64 x P0 bf16 rows (h1, d_z, d_attn, dq ...)
  float* F;     //   bwd: 64 x Wp fp32 rows (r1, xhat1, r2, xhat2, ...)
  float* inv1;  // bwd: LayerNorm 1/sigma of each row (64 each)
  float* inv2;
  bf16* ring;   // kRingBytes
};

// The backward's per-sample scratch written by the recompute: rows < L,
// widths padded (their dW products read them as 16-byte chunks).
struct Saved {
  bf16* xp;      // (L, Dp) x
  bf16* qkv;     // (L, N3) q|k|v
  bf16* o;       // (L, innerp) the heads' outputs
  bf16* h1;      // (L, Dp) rounded h1
  bf16* g1m;     // (L, FFp) rounded gelu(u) * m_ffn1
  float* xhat1;  // (L, Dp)
  float* u;      // (L, FFp) h1 W1 + b1
};

// The layer for sample dr.b: x (L, D) in device memory; w with its vectors
// staged in shared memory (stage_vectors). kFwd: writes out (L, D). !kFwd:
// fills sv and leaves xhat2 in F and 1/sigma in inv1, inv2. All 256
// threads call it; it ends after a barrier.
template <bool kFwd>
__device__ __forceinline__ void layer_chain(const Dims& d, const Weights& w,
                                            float scale, const Drop& dr,
                                            const bf16* x, const Smem& sm,
                                            bf16* out, const Saved& sv) {
  const int L = d.L, D = d.D, FF = d.FF, P0 = d.P0, Pq = d.Pqkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long LD = (long)L * D, LF = (long)L * FF, LLH = (long)d.H * L * L;
  const bool drop = dr.d.mode != kDropNone;

  // x -> R0, zero-padded (and its padded copy for the backward's dWqkv)
  load_tile(sm.R0, P0, x, D, L, D, d.Dp, kFwd ? nullptr : sv.xp);
  // q | k | v, each (64, innerp); the padding columns come out zero
  for (int m = 0; m < 3; ++m) {
    rows_gemm<false>(
        sm.R0, P0, w.wqkv + m * d.innerp, d.N3, d.Dp, d.innerp, sm.ring,
        NoGather{}, [&](int r, int c, float2 v, float) {
          const int cc = m * d.innerp + c;
          const float b0 = w.bqkv[cc], b1 = w.bqkv[cc + 1];
          float q0 = kFwd ? rnd<bf16>(rnd<bf16>(v.x) + b0)
                          : rnd<bf16>(v.x + b0);
          float q1 = kFwd ? rnd<bf16>(rnd<bf16>(v.y) + b1)
                          : rnd<bf16>(v.y + b1);
          if (r >= L) q0 = q1 = 0.f;
          st2(sm.QKV + r * Pq + cc, q0, q1);
          if (!kFwd && r < L) st2(sv.qkv + (long)r * d.N3 + cc, q0, q1);
        });
  }
  __syncthreads();
  // the heads: warp -> (head, 16 query rows); o -> R0 (x is consumed)
  for (int job = warp; job < d.H * 4; job += kThreads / 32) {
    const int h = job >> 2, r0 = (job & 3) * 16;
    const int c0 = h * d.hdp;
    float s[8][4], o[8][4], mx[2], z[2];
    if (r0 < L) {
      scores16(sm.QKV + c0, Pq, sm.QKV + d.innerp + c0, Pq, r0, d.hdp, s);
      softmax16(s, L, scale, mx, z);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = r0 + g + hf * 8, j = nb * 8 + 2 * t;
          const bool v0 = i < L && j < L, v1 = i < L && j + 1 < L;
          float p0 = s[nb][2 * hf], p1 = s[nb][2 * hf + 1];
          float2 f = make_float2(1.f, 1.f);
          if (v0 && drop)
            f = dr.at2<kFwd, true>(0, LLH, ((long)h * L + i) * L + j, v1);
          if (kFwd) {
            p0 = rnd<bf16>(p0);
            p1 = rnd<bf16>(p1);
            if (drop) {
              p0 = rnd<bf16>(p0 * f.x);
              p1 = rnd<bf16>(p1 * f.y);
            }
          } else {
            p0 = rnd<bf16>(p0 * f.x);
            p1 = rnd<bf16>(p1 * f.y);
          }
          s[nb][2 * hf] = v0 ? p0 : 0.f;
          s[nb][2 * hf + 1] = v1 ? p1 : 0.f;
        }
      pv16(s, sm.QKV + 2 * d.innerp + c0, Pq, d.hdp, o);
    } else {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      if (nb * 8 < d.hdp) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = r0 + g + hf * 8, c = c0 + nb * 8 + 2 * t;
          const float o0 = i < L ? o[nb][2 * hf] : 0.f;
          const float o1 = i < L ? o[nb][2 * hf + 1] : 0.f;
          st2(sm.R0 + i * P0 + c, o0, o1);
          if (!kFwd && i < L) st2(sv.o + (long)i * d.innerp + c, o0, o1);
        }
      }
    }
  }
  // a = o Wo + bo (x m_res); the residual x + a: fwd rounded into XS,
  // bwd fp32 into F. Gathered: x and the mask factors.
  rows_gemm<false>(
      sm.R0, P0, w.wo, d.Dp, d.innerp, d.Dp, sm.ring,
      [&](int r, int c) {
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < L && c < D) {
          const long e = (long)r * D + c;
          const bool both = c + 1 < D;
          const float2 xv = both ? ld2u(x, e) : make_float2(to_f(x[e]), 0.f);
          const float2 f = dr.at2<kFwd>(1, LD, e, both);
          q = make_float4(xv.x, xv.y, f.x, f.y);
        }
        return q;
      },
      [&](int r, int c, float2 v, float4 q) {
        const bool in0 = r < L && c < D, in1 = r < L && c + 1 < D;
        if (kFwd) {
          float a0 = rnd<bf16>(rnd<bf16>(v.x) + w.bo[c]);
          float a1 = rnd<bf16>(rnd<bf16>(v.y) + w.bo[c + 1]);
          if (drop) {
            a0 = rnd<bf16>(a0 * q.z);
            a1 = rnd<bf16>(a1 * q.w);
          }
          st2(sm.XS + r * Pq + c, in0 ? q.x + a0 : 0.f, in1 ? q.y + a1 : 0.f);
        } else {
          float* f = sm.F + r * d.Wp + c;
          f[0] = in0 ? q.x + (v.x + w.bo[c]) * q.z : 0.f;
          f[1] = in1 ? q.y + (v.y + w.bo[c + 1]) * q.w : 0.f;
        }
      });
  __syncthreads();
  // LN1: fwd h1 rounded in XS; bwd xhat1 in F (and saved), h1 rounded in
  // R1 (and saved)
#pragma unroll 1
  for (int k0 = 0; k0 < 8; k0 += 4) {
    float v[4][8], mu[4], inv[4];
    if (kFwd)
      ln_rows4(sm.XS, Pq, L, D, k0, v, mu, inv);
    else
      ln_rows4(sm.F, d.Wp, L, D, k0, v, mu, inv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = warp + 8 * (k0 + k);
      if (r >= L) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = lane + 32 * q;
        if (kFwd) {
          if (c < D)
            sm.XS[r * Pq + c] = __float2bfloat16(
                (v[k][q] - mu[k]) * inv[k] * w.ln1_s[c] + w.ln1_b[c]);
        } else if (c < d.Dp) {
          const float xh = c < D ? (v[k][q] - mu[k]) * inv[k] : 0.f;
          sm.F[r * d.Wp + c] = xh;
          sv.xhat1[(long)r * d.Dp + c] = xh;
          const bf16 hv = __float2bfloat16(xh * w.ln1_s[c] + w.ln1_b[c]);
          sm.R1[r * P0 + c] = hv;
          sv.h1[(long)r * d.Dp + c] = hv;
        }
      }
      if (!kFwd && lane == 0) sm.inv1[r] = inv[k];
    }
  }
  if (!kFwd)
    for (int i = tid; i < (kRows - L) * d.Dp; i += kThreads) {
      const int r = L + i / d.Dp, c = i % d.Dp;
      sm.R1[r * P0 + c] = __float2bfloat16(0.f);
      sm.F[r * d.Wp + c] = 0.f;
    }
  // u = h1 W1 + b1; the FFN hidden layer gelu(u) (x m_ffn1) -> R0
  rows_gemm<false>(
      kFwd ? sm.XS : sm.R1, kFwd ? Pq : P0, w.w1, d.FFp, d.Dp, d.FFp,
      sm.ring,
      [&](int r, int c) {
        return r < L && c < FF
                   ? dr.at2<kFwd>(2, LF, (long)r * FF + c, c + 1 < FF)
                   : make_float2(0.f, 0.f);
      },
      [&](int r, int c, float2 v, float2 f) {
        const bool in0 = r < L && c < FF, in1 = r < L && c + 1 < FF;
        float y0, y1;
        if (kFwd) {
          y0 = rnd<bf16>(gelu_tanh(rnd<bf16>(rnd<bf16>(v.x) + w.b1[c])));
          y1 = rnd<bf16>(gelu_tanh(rnd<bf16>(rnd<bf16>(v.y) + w.b1[c + 1])));
          if (drop) {
            y0 = rnd<bf16>(y0 * f.x);
            y1 = rnd<bf16>(y1 * f.y);
          }
        } else {
          const float u0 = v.x + w.b1[c], u1 = v.y + w.b1[c + 1];
          y0 = rnd<bf16>(gelu_tanh(u0) * f.x);
          y1 = rnd<bf16>(gelu_tanh(u1) * f.y);
          if (r < L) {
            *reinterpret_cast<float2*>(sv.u + (long)r * d.FFp + c) =
                make_float2(u0, u1);
            st2(sv.g1m + (long)r * d.FFp + c, in0 ? y0 : 0.f,
                in1 ? y1 : 0.f);
          }
        }
        st2(sm.R0 + r * P0 + c, in0 ? y0 : 0.f, in1 ? y1 : 0.f);
      });
  // y = hidden W2 + b2 (x m_ffn2); the residual h1 + y in place
  rows_gemm<false>(
      sm.R0, P0, w.w2, d.Dp, d.FFp, d.Dp, sm.ring,
      [&](int r, int c) {
        return r < L && c < D ? dr.at2<kFwd>(3, LD, (long)r * D + c, c + 1 < D)
                              : make_float2(0.f, 0.f);
      },
      [&](int r, int c, float2 v, float2 f) {
        const bool in0 = r < L && c < D, in1 = r < L && c + 1 < D;
        if (kFwd) {
          float y0 = rnd<bf16>(rnd<bf16>(v.x) + w.b2[c]);
          float y1 = rnd<bf16>(rnd<bf16>(v.y) + w.b2[c + 1]);
          if (drop) {
            y0 = rnd<bf16>(y0 * f.x);
            y1 = rnd<bf16>(y1 * f.y);
          }
          bf16* p = sm.XS + r * Pq + c;
          const float2 h = ld2(p);
          st2(p, in0 ? h.x + y0 : 0.f, in1 ? h.y + y1 : 0.f);
        } else {
          float* p = sm.F + r * d.Wp + c;
          const float h0 = p[0] * w.ln1_s[c] + w.ln1_b[c];
          const float h1 = p[1] * w.ln1_s[c + 1] + w.ln1_b[c + 1];
          p[0] = in0 ? h0 + (v.x + w.b2[c]) * f.x : 0.f;
          p[1] = in1 ? h1 + (v.y + w.b2[c + 1]) * f.y : 0.f;
        }
      });
  __syncthreads();
  // LN2: fwd the output; bwd xhat2 in F
#pragma unroll 1
  for (int k0 = 0; k0 < 8; k0 += 4) {
    float v[4][8], mu[4], inv[4];
    if (kFwd)
      ln_rows4(sm.XS, Pq, L, D, k0, v, mu, inv);
    else
      ln_rows4(sm.F, d.Wp, L, D, k0, v, mu, inv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = warp + 8 * (k0 + k);
      if (r >= L) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = lane + 32 * q;
        if (c >= D) continue;
        const float xh = (v[k][q] - mu[k]) * inv[k];
        if (kFwd)
          out[r * D + c] = __float2bfloat16(xh * w.ln2_s[c] + w.ln2_b[c]);
        else
          sm.F[r * d.Wp + c] = xh;
      }
      if (!kFwd && lane == 0) sm.inv2[r] = inv[k];
    }
  }
  __syncthreads();
}

}  // namespace attn
}  // namespace eid
