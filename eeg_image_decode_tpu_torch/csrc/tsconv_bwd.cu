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
// and fp32 accumulation; dx leaves the kernel in x's type, rounded once from
// the fp32 sums, and dw~ in fp32. Two designs, chosen by dtype in the
// launcher (eid_tsconv_bwd_design names the one a dtype takes).
//
// Bound on the H100 (ATM-S, B 1024: 64,512 rows, T 250, M 75, F 40, P 36):
// g (186 MB) and x (32 MB) read once and dx (32 MB) written once in bf16 move
// 250 MB, 0.075 ms at 3.35 TB/s; the two sums are 28 GFLOP, 0.03 ms at the
// bf16 tensor-core peak but 0.42 ms as fp32 FMAs: memory-bound only on the
// tensor cores.
//
// bfloat16, "mma_bf16" (tsconv_bwd_mma_kernel). One persistent block per SM
// walks tiles of 32 rows. A tile's g rows (92 KB) come through cp.async into
// one of two shared-memory stages, so the next tile's 16-byte copies overlap
// this tile's products, and g is read from device memory once: both sums
// read it from shared memory, as bf16, never widened. Four warps compute dx
// and four dw~ (the two halves meet at two barriers per tile).
// - dx as a banded product. With t = s q + j, the 8 q of a q-tile (8 s
//   samples) are covered by the positions q0 - (ceil(M/s) - 1) .. q0 + 7, a
//   contiguous run of columns of the g row, so dx_tile (32 x 8s) = g[:, run]
//   (32 x K) @ E, with E[(p, f), t] = w~[t - p s, f] inside the band and 0
//   outside. E depends only on t - p s, so it is never stored: a B fragment
//   is two 4-byte loads from the w~ table in shared memory at tap t - p s,
//   and the table has zero rows on both sides for every tap a step can ask
//   for outside [0, M). A fragments are ldmatrix from the g stage (F is
//   padded to a multiple of 8 in shared memory, so every 8-column group
//   lies in one position). Positions outside [0, P) are skipped or meet
//   zero columns; samples past the last window get dx = 0. A dx warp owns
//   whole q-tiles: 2 x s accumulator tiles, 10 products per 16-column step.
// - dw~ as x^T g per position: A(m, r) = x[r, p s + m], whose column offset
//   p s + m is only 2-byte aligned in a row of x. So x is staged transposed,
//   xT[t][r]: the window of position p is then the rows p s .. p s + M - 1 of
//   xT, any offset, and ldmatrix reads it as a K-major operand; B(r, f) is
//   the g stage through ldmatrix.trans. Taps are padded to a multiple of 16
//   (zero rows of xT past T), the results past M dropped. The positions are
//   dealt to the dw warps; each keeps its 5 x 5 accumulator tiles in
//   registers across all the block's row tiles, and at the end the warps'
//   sums are added in warp order through shared memory: one fp32 partial per
//   block, the partials added in block order (reduce.cuh::sum_rows). No
//   atomics: a rerun is bit-equal.
// - x rows are only 4-byte aligned (500 bytes), so x goes through registers
//   (4-byte loads started before the products, transposed 2-byte stores after
//   them), not cp.async: tsconv_tile.cuh, shared with the forward.
// What bounds it (H100, measured by switching parts off): the loads alone
// run at 2.0 TB/s (0.125 ms), and the dx warps' loop, not the tensor cores
// (mma.sync reaches 570 TFLOP/s from four warps with ten accumulators each,
// scripts/bench_torch_mma_sync.py; dx needs 0.03 ms of that). A dx warp is
// alone on its scheduler most of the time and runs in order, so every
// scalar instruction between the products costs its full latency: with
// run-time sizes a step took ~280 clocks for 10 products, whether its 12
// shared-memory loads were there or not. Hence the ATM-S shape (stride 5,
// 40 filters, 65-80 taps) is a template instance of its own (EXACT) whose
// inner loop has constant offsets and no address arithmetic; any other
// shape takes the guarded loops. Sixteen warps with half the accumulators
// each, or all eight warps sharing dx, were no faster: they double the
// scalar work per product.
// It takes strides up to 8, F up to 40, up to 80 taps and T up to 256; the
// launcher refuses anything else.
//
// float32, "fma_fp32" (tsconv_bwd_kernel): the tensor cores would round fp32
// operands to TF32, so fp32 keeps full-fp32 FMA products, the first version
// of this file. The windows overlap (stride 5 < 75 taps), so dx is gathered
// per output sample, never scattered: a thread owns two consecutive q of one
// row, all their residues j (2 x stride accumulators), and per (d, f) loads
// 2 g and `stride` w~ values for 2*stride FMAs. dw~ is summed per block in
// registers over the block's rows, a 3-tap by 4-filter tile per thread,
// written as one fp32 partial per block, and the partials are added in a
// fixed order. Each block walks its rows in slabs of 8: x, g and w~ as fp32
// in shared memory, rows padded to an odd pitch against bank conflicts.

#include "common.cuh"
#include "mma_tile.cuh"
#include "reduce.cuh"
#include "tsconv_tile.cuh"

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

// ——— the bfloat16 design on the tensor cores ———

using mma::bf16;

constexpr int kDxWarps = 4, kDwWarps = 4;  // the block's two halves
using tsconv::kMaxT;      // 256 samples
using tsconv::kTileRows;  // rows of x and g per tile
using tsconv::kXp;        // pitch of xT[t][r]
using tsconv::kXRegs;
static_assert(tsconv::kThreads == kThreads, "one block size");
constexpr int kQTile = 8;      // q per dx tile
constexpr int kMaxMT = 5;      // 16-tap tiles of dw~ (M <= 80)
constexpr int kMaxFT = 5;      // 8-filter tiles (F <= 40)

struct MmaParams {
  const bf16 *x, *g, *w;
  bf16* dx;
  float* part;
  int rows, Tn, M, F, P, s;
  int Fp;       // F padded to a multiple of 8
  int Gp;       // pitch of a g row in shared memory
  int Tx;       // rows of xT
  int n_tiles;
  int g_vec;    // g rows take 16-byte cp.async
  int x_pair;   // x and dx rows take 4-byte accesses
};

struct MmaSmem {
  size_t wt, xt, gs, total;
};

// The w~ table holds zero rows for every tap a dx step can ask for outside
// [0, M): kTapPad * stride below and above.
constexpr int kTapPad = 9;

__host__ __device__ inline MmaSmem mma_smem(int M, int Fp, int Tx, int Gp,
                                            int stride) {
  MmaSmem l;
  l.wt = 0;
  l.xt = align16((size_t)(M + 2 * kTapPad * stride) * Fp * 2);
  l.gs = l.xt + align16((size_t)Tx * kXp * 2);
  // the two g stages; at the end they hold the warps' dw~ sums
  const size_t stages = 2 * (size_t)kTileRows * Gp * 2;
  const size_t red = (size_t)kDwWarps * ((M + 15) / 16) * (Fp / 8) * 4 * 32 * 4;
  l.total = l.gs + (stages > red ? stages : red);
  return l;
}

// All the block's threads meet here. bar.sync counts arrivals at barrier 0
// wherever they come from, so the two halves of the block may wait at
// different places of the code.
__device__ __forceinline__ void block_barrier() {
  asm volatile("bar.sync 0, %0;\n" ::"n"(kThreads) : "memory");
}

// The loops run over NS stride tiles of dx and NF filter tiles (kMaxMT tap tiles) of dw~. EXACT: the shape
// fills them exactly (stride NS, Fp 8 NF, kMaxMT tap tiles), so the guards
// fold away and the offsets become immediates: the ATM-S shape. Otherwise
// every tile is guarded at run time.
template <int NS, int NF, bool EXACT>
__global__ void __launch_bounds__(kThreads, 1)
    tsconv_bwd_mma_kernel(const MmaParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int M = p.M, F = p.F, P = p.P, Tn = p.Tn, Gp = p.Gp;
  const int s = EXACT ? NS : p.s;
  const int Fp = EXACT ? 8 * NF : p.Fp;
  const MmaSmem l = mma_smem(M, Fp, p.Tx, Gp, s);
  // (kTapPad s + M + kTapPad s) x Fp: w~ between zero rows
  bf16* wt = reinterpret_cast<bf16*>(smem_raw + l.wt) + kTapPad * s * Fp;
  bf16* xT = reinterpret_cast<bf16*>(smem_raw + l.xt);   // Tx x kXp
  bf16* gs0 = reinterpret_cast<bf16*>(smem_raw + l.gs);  // 2 x 32 x Gp
  const uint32_t wt_addr = mma::smem_u32(wt);  // of tap 0
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tg = lane & 3;
  const int PF = P * F;
  const int Dt = (M + s - 1) / s;
  const int NQ = ((Tn + s - 1) / s + kQTile - 1) / kQTile;
  const int MT = EXACT ? kMaxMT : (M + 15) / 16, FT = EXACT ? NF : Fp / 8;

  // zeros once: the pad columns of g, the rows of xT past T
  for (size_t i = tid; i < l.total / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(smem_raw)[i] = 0u;
  __syncthreads();
  for (int i = tid; i < M * Fp; i += kThreads) {
    const int m = i / Fp, f = i - m * Fp;
    if (f < F) wt[i] = p.w[m * F + f];  // tap m
  }

  auto load_g = [&](int tile, bf16* stage) {
    const int r0 = tile * kTileRows;
    const int nr = min(kTileRows, p.rows - r0);
    const bf16* src = p.g + (long)r0 * PF;
    if (p.g_vec) {
      const int cpr = PF / 8;
      for (int c = tid; c < nr * cpr; c += kThreads) {
        const int r = c / cpr, k = (c - r * cpr) * 8;
        mma::cp_async16(stage + r * Gp + k, src + (long)r * PF + k);
      }
    } else {
      for (int e = tid; e < nr * PF; e += kThreads) {
        const int r = e / PF, rem = e - r * PF;
        const int pp = rem / F, f = rem - pp * F;
        stage[r * Gp + pp * Fp + f] = src[e];
      }
    }
    // a short last tile: its missing rows must not keep an earlier tile's
    for (int e = tid; e < (kTileRows - nr) * (P * Fp); e += kThreads) {
      const int r = nr + e / (P * Fp), k = e % (P * Fp);
      stage[r * Gp + k] = __float2bfloat16(0.f);
    }
  };
  auto load_x = [&](int tile, uint32_t (&xr)[kXRegs]) {
    tsconv::load_x(xr, p.x, p.rows, Tn, tile * kTileRows, p.x_pair);
  };
  auto store_x = [&](const uint32_t (&xr)[kXRegs]) {
    tsconv::store_x(xr, xT, Tn);
  };

  // One tile after another: the next tile's g goes into the other stage and
  // its x into registers while `compute` runs on this one. Both halves of
  // the block run this loop, each with its own compute, and meet at the two
  // barriers of every tile.
  auto run = [&](auto&& compute) {
    uint32_t xr[kXRegs];
    int tile = blockIdx.x;
    if (tile < p.n_tiles) {
      load_g(tile, gs0);
      load_x(tile, xr);
      store_x(xr);
    }
    mma::cp_async_commit();
    for (int it = 0; tile < p.n_tiles; ++it, tile += gridDim.x) {
      const int next = tile + gridDim.x;
      const bool has_next = next < p.n_tiles;
      if (has_next) {
        load_g(next, gs0 + ((it + 1) & 1) * kTileRows * Gp);
        load_x(next, xr);
      }
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
      block_barrier();  // this tile's g and xT are in shared memory
      compute(tile, gs0 + (it & 1) * kTileRows * Gp);
      block_barrier();  // every warp is done with xT and this g stage
      if (has_next) store_x(xr);
    }
    mma::cp_async_wait<0>();
  };

  float* red = reinterpret_cast<float*>(gs0);  // [dw warp][tile][4][lane]
  const int n_acc = MT * FT * 4;

  if (warp < kDxWarps) {
    // dx[r, t] over the q-tiles, dealt to the dx warps: a banded product
    // along the g row. Fragments of step k + 1 are loaded before the
    // products of step k.
    struct Frag {
      uint32_t a[2][4];
      uint32_t b[NS][2];
    };
    run([&](int tile, const bf16* gs) {
      const int r0 = tile * kTileRows;
      for (int qt = warp; qt < NQ; qt += kDxWarps) {
        const int q0 = qt * kQTile;
        const int p_lo = max(q0 - (Dt - 1), 0);
        const int p_hi = min(q0 + kQTile - 1, P - 1);
        float c[2][NS][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;
        if (p_lo <= p_hi) {
          const int ks = (p_lo * Fp) & ~15;
          const int ke = min(((p_hi + 1) * Fp + 15) & ~15, Gp - 8);
          const int n_k = (ke - ks) >> 4;
          // Running addresses, so a step costs a few adds: the A fragments'
          // (two 16-row tiles of the g stage at column k), and the B word of
          // the 8-column group at k: position pos, filters 8 fg ..; its tap
          // under sample q0 s + n is (q0 - pos) s + n, inside the padded
          // table for every position a step can reach. The next group lies
          // 16 bytes on, or, past the position's last group, at the next
          // position's first: one tap-table stride s lower.
          const int FG = Fp >> 3;
          const int pos0 = ks / Fp;
          int fg = (ks - pos0 * Fp) >> 3;
          uint32_t a_addr0 = mma::smem_u32(gs + (lane & 15) * Gp + ks +
                                           (lane >> 4) * 8);
          uint32_t a_addr1 = a_addr0 + 16 * Gp * 2;
          uint32_t b_addr = wt_addr + 2 * Fp * ((q0 - pos0) * s + gq) +
                            16 * fg + 4 * tg;
          const int wrap = 16 - 16 * FG - 2 * Fp * s;
          auto next_group = [&]() {
            const bool last = ++fg == FG;
            fg = last ? 0 : fg;
            b_addr += last ? wrap : 16;
          };
          auto load = [&](Frag& fr) {  // the step at the running addresses
            mma::ldsm_x4(fr.a[0], a_addr0);
            mma::ldsm_x4(fr.a[1], a_addr1);
            a_addr0 += 32;
            a_addr1 += 32;
            const uint32_t b0 = b_addr;
            next_group();
            const uint32_t b1 = b_addr;
            next_group();
#pragma unroll
            for (int j = 0; j < NS; ++j) {
              if (EXACT || j < s) {
                fr.b[j][0] = mma::lds_u32(b0 + j * 16 * Fp);
                fr.b[j][1] = mma::lds_u32(b1 + j * 16 * Fp);
              }
            }
          };
          auto products = [&](const Frag& fr) {
#pragma unroll
            for (int j = 0; j < NS; ++j) {
              if (EXACT || j < s) {
                mma::mma_bf16(c[0][j], fr.a[0], fr.b[j][0], fr.b[j][1]);
                mma::mma_bf16(c[1][j], fr.a[1], fr.b[j][0], fr.b[j][1]);
              }
            }
          };
          // two fragment sets in turn: the loads of the next step are under
          // way while this step's products run
          Frag f0, f1;
          constexpr int kPeriod = NF;  // steps after which the groups repeat
          if (EXACT && fg == 0 && n_k % kPeriod == 0) {
            // 8 NF columns are NF / 2 steps: every kPeriod = NF steps the
            // groups start a position again, two (NF = 5: 80 columns, 2
            // positions) positions on. Inside a period every address is the
            // period's base plus a constant, so a step is 12 loads and 10
            // products and nothing else: what the scalar address arithmetic
            // of the general loop costs a warp, in order and alone on its
            // scheduler, is several times the products' own time.
            static_assert(!EXACT || NF % 2 == 1, "period of NF steps");
            auto load_at = [&](Frag& fr, int u) {  // step u of the period
              mma::ldsm_x4(fr.a[0], a_addr0 + 32 * u);
              mma::ldsm_x4(fr.a[1], a_addr1 + 32 * u);
              const int g0 = 2 * u, g1 = 2 * u + 1;
              const int o0 = 16 * (g0 % NF) - (g0 / NF) * 2 * (8 * NF) * NS;
              const int o1 = 16 * (g1 % NF) - (g1 / NF) * 2 * (8 * NF) * NS;
#pragma unroll
              for (int j = 0; j < NS; ++j) {
                fr.b[j][0] = mma::lds_u32(b_addr + o0 + j * 16 * (8 * NF));
                fr.b[j][1] = mma::lds_u32(b_addr + o1 + j * 16 * (8 * NF));
              }
            };
            // a holds the period's step 0; at the end b holds the next one's
            auto period = [&](Frag& a, Frag& b, bool more) {
#pragma unroll
              for (int u = 0; u + 2 < kPeriod; u += 2) {
                load_at(b, u + 1);
                products(a);
                load_at(a, u + 2);
                products(b);
              }
              a_addr0 += 32 * kPeriod;
              a_addr1 += 32 * kPeriod;
              b_addr -= 2 * 2 * (8 * NF) * NS;
              if (more) load_at(b, 0);
              products(a);
            };
            load_at(f0, 0);
            for (int n = n_k / kPeriod;;) {
              period(f0, f1, n > 1);
              if (--n == 0) break;
              period(f1, f0, n > 1);
              if (--n == 0) break;
            }
          } else {
            load(f0);
            for (int i = 0;;) {
              if (i + 1 < n_k) load(f1);
              products(f0);
              if (++i >= n_k) break;
              if (i + 1 < n_k) load(f0);
              products(f1);
              if (++i >= n_k) break;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            if (!EXACT && j >= s) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = r0 + i * 16 + gq + h * 8;
              const int t = q0 * s + j * 8 + 2 * tg;
              if (r >= p.rows || t >= Tn) continue;
              bf16* dst = p.dx + (long)r * Tn + t;
              const bf16 v0 = __float2bfloat16(c[i][j][2 * h]);
              const bf16 v1 = __float2bfloat16(c[i][j][2 * h + 1]);
              if (p.x_pair) {  // T even: t + 1 < T, dst is 4-byte aligned
                __nv_bfloat162 v;
                v.x = v0;
                v.y = v1;
                *reinterpret_cast<__nv_bfloat162*>(dst) = v;
              } else {
                dst[0] = v0;
                if (t + 1 < Tn) dst[1] = v1;
              }
            }
          }
      }
    });
  } else {
    // dw~[m, f] += sum_r x[r, p s + m] g[r, p, f]: the positions dealt to
    // the dw warps, each with all (tap tile, filter tile) accumulators in
    // registers across the block's row tiles
    const int wd = warp - kDxWarps;
    float dw[kMaxMT][NF][4];
#pragma unroll
    for (int i = 0; i < kMaxMT; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dw[i][j][e] = 0.f;
    struct Frag {
      uint32_t a[kMaxMT][4];
      uint32_t b[(NF + 1) / 2][4];
    };
    const int n_steps = ((P - wd + kDwWarps - 1) / kDwWarps) * (kTileRows / 16);
    run([&](int, const bf16* gs) {
      // step i: position wd + kDwWarps (i / 2), rows 16 (i % 2) ..
      auto load = [&](Frag& fr, int i) {
        const int pp = wd + kDwWarps * (i >> 1), k0 = (i & 1) * 16;
#pragma unroll
        for (int j = 0; j < (NF + 1) / 2; ++j)
          if (EXACT || 2 * j < FT)
            mma::frag_b_mnmajor(fr.b[j], gs, Gp, k0, pp * Fp + j * 16);
#pragma unroll
        for (int m = 0; m < kMaxMT; ++m)
          if (EXACT || m < MT)
            mma::frag_a_kmajor(fr.a[m], xT, kXp, pp * s + m * 16, k0);
      };
      auto products = [&](const Frag& fr) {
#pragma unroll
        for (int m = 0; m < kMaxMT; ++m)
#pragma unroll
          for (int j = 0; j < NF; ++j)
            if (EXACT || (m < MT && j < FT))
              mma::mma_bf16(dw[m][j], fr.a[m], fr.b[j >> 1][(j & 1) * 2],
                            fr.b[j >> 1][(j & 1) * 2 + 1]);
      };
      if (n_steps == 0) return;
      Frag f0, f1;
      load(f0, 0);
      for (int i = 0;;) {
        if (i + 1 < n_steps) load(f1, i + 1);
        products(f0);
        if (++i >= n_steps) break;
        if (i + 1 < n_steps) load(f0, i + 1);
        products(f1);
        if (++i >= n_steps) break;
      }
    });
#pragma unroll
    for (int i = 0; i < kMaxMT; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (EXACT || (i < MT && j < FT))
            red[((wd * MT * FT + i * FT + j) * 4 + e) * 32 + lane] =
                dw[i][j][e];
  }
  __syncthreads();

  // the dw warps' sums, added in warp order: this block's partial
  float* out = p.part + (long)blockIdx.x * M * F;
  for (int i = tid; i < n_acc * 32; i += kThreads) {
    float sum = 0.f;
    for (int w = 0; w < kDwWarps; ++w) sum += red[w * n_acc * 32 + i];
    const int ln = i & 31, e = (i >> 5) & 3, tl = i >> 7;
    const int m = (tl / FT) * 16 + (ln >> 2) + (e >> 1) * 8;
    const int f = (tl % FT) * 8 + 2 * (ln & 3) + (e & 1);
    if (m < M && f < F) out[m * F + f] = sum;
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

// The bfloat16 design's derived sizes; ok is false for shapes it does not
// take.
struct MmaPlan {
  bool ok;
  int Fp, Gp, Tx, n_tiles, blocks;
  size_t smem;
};

MmaPlan mma_plan(int rows, int Tn, int M, int F, int P, int stride) {
  MmaPlan pl{};
  if (stride < 1 || stride > kMaxStride || F < 1 || F > 8 * kMaxFT || M < 1 ||
      M > 16 * kMaxMT || Tn > kMaxT)
    return pl;
  pl.Fp = (F + 7) / 8 * 8;
  pl.Gp = (P * pl.Fp + 15) / 16 * 16 + 8;
  const int MT = (M + 15) / 16;
  const int reach = (P - 1) * stride + MT * 16;
  pl.Tx = Tn > reach ? Tn : reach;
  pl.n_tiles = (rows + kTileRows - 1) / kTileRows;
  const int sms = sm_count();
  if (sms <= 0) return pl;
  pl.blocks = pl.n_tiles < sms ? pl.n_tiles : sms;
  const MmaSmem l = mma_smem(M, pl.Fp, pl.Tx, pl.Gp, stride);
  pl.smem = l.total;
  pl.ok = pl.smem <= kMaxSmem;
  return pl;
}

template <int NS, int NF, bool EXACT>
int launch_mma_as(const MmaParams& p, const MmaPlan& pl, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      tsconv_bwd_mma_kernel<NS, NF, EXACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return (int)e;
  tsconv_bwd_mma_kernel<NS, NF, EXACT><<<pl.blocks, kThreads, pl.smem, s>>>(p);
  return (int)cudaGetLastError();
}

int launch_mma(const void* x, const void* g, const void* w, void* dx,
               float* dw, float* part, int rows, int Tn, int M, int F, int P,
               int stride, cudaStream_t s) {
  const MmaPlan pl = mma_plan(rows, Tn, M, F, P, stride);
  if (!pl.ok) return (int)cudaErrorInvalidValue;
  MmaParams p;
  p.x = static_cast<const bf16*>(x);
  p.g = static_cast<const bf16*>(g);
  p.w = static_cast<const bf16*>(w);
  p.dx = static_cast<bf16*>(dx);
  p.part = part;
  p.rows = rows;
  p.Tn = Tn;
  p.M = M;
  p.F = F;
  p.P = P;
  p.s = stride;
  p.Fp = pl.Fp;
  p.Gp = pl.Gp;
  p.Tx = pl.Tx;
  p.n_tiles = pl.n_tiles;
  p.g_vec = F == pl.Fp && (P * F) % 8 == 0 &&
            (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  p.x_pair = Tn % 2 == 0 && (reinterpret_cast<uintptr_t>(x) & 3) == 0 &&
             (reinterpret_cast<uintptr_t>(dx) & 3) == 0;
  // the ATM-S shape (stride 5, 40 filters, 65-80 taps) fills the loops
  // exactly; any other takes the largest loops, guarded
  const bool atms = stride == 5 && pl.Fp == 8 * kMaxFT && M > 16 * (kMaxMT - 1);
  const int rc = atms ? launch_mma_as<5, kMaxFT, true>(p, pl, s)
                      : launch_mma_as<kMaxStride, kMaxFT, false>(p, pl, s);
  if (rc != 0) return rc;
  return (int)sum_rows(part, pl.blocks, (long)M * F, 1, dw, s);
}

// ——— the float32 design ———

int n_blocks(int rows) {
  const int slabs = (rows + kSlab - 1) / kSlab;
  return slabs < kMaxBlocks ? slabs : kMaxBlocks;
}

int launch_fma(const void* x, const void* g, const void* w, float* dx,
               float* dw, float* part, int rows, int Tn, int M, int F, int P,
               int stride, cudaStream_t s) {
  const int Dt = (M + stride - 1) / stride;
  const size_t smem = ((size_t)Dt * stride * (F + 1) + (size_t)kSlab * Tn +
                       (size_t)kSlab * P * (F + 1)) *
                      sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      tsconv_bwd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = n_blocks(rows);
  int per = (rows + blocks - 1) / blocks;
  per = (per + kSlab - 1) / kSlab * kSlab;
  tsconv_bwd_kernel<float><<<blocks, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(w), dx, part, rows, Tn, M, F, P, stride, per);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)sum_rows(part, blocks, (long)M * F, 1, dw, s);
}

bool fma_takes(int M, int F, int stride) {
  const int tiles = ((M + kTM - 1) / kTM) * ((F + kTF - 1) / kTF);
  return stride >= 1 && stride <= kMaxStride && tiles <= kThreads;
}

}  // namespace

// Which design a dtype takes: "mma_bf16" (tensor cores) or "fma_fp32".
extern "C" const char* eid_tsconv_bwd_design(int dtype) {
  return dtype == kBF16 ? "mma_bf16" : "fma_fp32";
}

// Bytes of device workspace eid_tsconv_bwd needs (the per-block partials), or
// -1 for a dtype or shapes it does not take.
extern "C" long long eid_tsconv_bwd_workspace(int dtype, int rows, int Tn,
                                              int M, int F, int P,
                                              int stride) {
  if (rows < 0 || P <= 0 || M <= 0 || F <= 0 || stride <= 0 ||
      (P - 1) * stride + M > Tn)
    return -1;
  long long blocks;
  if (dtype == kBF16) {
    const MmaPlan pl = mma_plan(rows, Tn, M, F, P, stride);
    if (!pl.ok) return -1;
    blocks = pl.blocks;
  } else if (dtype == kF32) {
    if (!fma_takes(M, F, stride)) return -1;
    blocks = n_blocks(rows);
  } else {
    return -1;
  }
  return blocks * M * F * (long long)sizeof(float);
}

// x: (rows, Tn), g: (rows, P*F), w: (M, F), all contiguous in dtype; dx:
// (rows, Tn) in dtype; dw: (M, F) fp32; ws: eid_tsconv_bwd_workspace bytes.
extern "C" int eid_tsconv_bwd(int dtype, const void* x, const void* g,
                              const void* w, void* dx, float* dw, void* ws,
                              int rows, int Tn, int M, int F, int P,
                              int stride, void* stream) {
  if (rows <= 0) return 0;
  if (eid_tsconv_bwd_workspace(dtype, rows, Tn, M, F, P, stride) < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(ws);
  if (dtype == kBF16)
    return launch_mma(x, g, w, dx, dw, part, rows, Tn, M, F, P, stride, s);
  return launch_fma(x, g, w, static_cast<float*>(dx), dw, part, rows, Tn, M,
                    F, P, stride, s);
}
