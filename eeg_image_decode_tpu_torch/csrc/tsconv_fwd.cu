// Stage 1 of the ATM-S tsconv stack: a 25-tap temporal conv and a 51-wide,
// stride-5 average pool folded into one 75-tap, stride-5 correlation.
//
// Replaces the TPU kernel eeg_image_decode_tpu/ops/tsconv.py::_tsconv_kernel
// (launched by _tsconv_pallas):
//
//   out[r, p*F + f] = sum_{m < M} x[r, p*stride + m] * w~[m, f]
//
// over rows r of the (B*C, T) input, fp32 accumulation, output rounded once
// to the working type. The TPU kernel ran it as P per-position MXU products.
//
// Bound on the H100 (ATM-S: T 250, M 75, F 40, P 36): at B 1024 (64,512
// rows) 14 GFLOP (0.014 ms at the bf16 tensor-core peak) against 32 MB read
// and 186 MB written in bf16 (0.065 ms at 3.35 TB/s): the stage is bound by
// the bytes of its output, 85% of the traffic. Two designs, chosen by dtype
// in the launcher (eid_tsconv_fwd_design names the one a dtype takes):
//
// bfloat16, "mma_bf16" (tsconv_fwd_mma_kernel). One persistent block per SM
// walks tiles of 32 rows.
// - x goes through registers into xT[t][r] in shared memory
//   (tsconv_tile.cuh, the staging the backward's dw~ uses): the next tile's
//   x loads are under way while this tile's products run.
// - Per position p, out_p (32 x F) = A w~ with A(r, m) = xT[p s + m][r]: the
//   window is a run of rows of xT at any offset, read by ldmatrix.trans as
//   an MN-major operand. The taps are padded to 16 KT (80 for 75) with zero
//   rows of w~ and zero rows of xT past T, F to 8 NT. w~ is staged once per
//   block and held as B fragments in registers (KT x NT blocks). A unit of
//   work is one position's 16 rows: KT ldmatrix and KT NT mma (25 at
//   ATM-S), into NT accumulators; the 2 P units of a tile are dealt to the
//   eight warps (nine each at ATM-S).
// - The output is rounded to bf16 into a shared-memory tile (rows padded by
//   8 elements against bank conflicts) and leaves by TMA bulk copies, one
//   per row (cp.async.bulk, 2,880 bytes at ATM-S), issued by one warp after
//   the tile's barrier. Two output tiles alternate, so the copies of one
//   tile run while the next is computed; before a tile's buffer is written
//   again its copies have finished reading it (cp.async.bulk.wait_group.read).
//   A row whose bytes are no multiple of 16 is copied by the threads
//   instead.
// On an H100 at B 1024 it takes 0.09 ms of device time, 1.4x the bound of
// its output bytes (the first version's FMA loops: 0.65 ms).
// The ATM-S shape (stride 5, 40 filters, 65-80 taps) is a template instance
// with constant offsets; any other shape within the limits (stride <= 8,
// F <= 40, taps <= 80, T <= 256, the two output tiles within the card's
// shared memory) takes the general instance with run-time guards; the
// launcher refuses the rest.
//
// float32, "fma_fp32" (tsconv_fwd_kernel): the tensor cores would round fp32
// operands to TF32, so fp32 keeps the first version of this file: each block
// stages 32 rows of x and all of w~ in shared memory and each thread
// computes a 4-position by 4-filter register tile of one row with FMAs.
//
// Both designs take an optional fp32 epilogue on the accumulator before the
// rounding to the output type: out = elu(acc * scale[f] + shift[f]), each of
// the three parts only where it is asked for (a multiply and an add, not a
// fused multiply-add, as the plain version rounds them; ELU's e^v - 1 to
// about 1e-6 relative in bfloat16, expm1f in float32). The stage-1
// BatchNorm of JAX's TSConv(bn1_impl='gram2d') (scale, shift, ELU) and
// 'gramfold' (shift: the scale is folded into w~) rides there, as it rides
// in the epilogue of JAX's x2 @ E matmul (eeg_image_decode_tpu/models/
// layers.py, TSConv). The vectors are staged in shared memory once per
// block and each lane keeps its filters' factors in registers; with no
// epilogue the stores are those of the kernel without it, bit for bit. The
// epilogue adds no bytes to the bound (2 F floats read).

#include "common.cuh"
#include "mma_tile.cuh"
#include "tsconv_tile.cuh"

namespace {

using namespace eid;

// epilogue parts (the mode word's bits)
constexpr int kEpScale = 1, kEpShift = 2, kEpElu = 4;
constexpr int kEpAny = -1;  // a kernel that reads the parts at run time
constexpr int kEpMax = 40;  // filters the staged epilogue vectors cover

// e^v - 1 for v <= 0 within about 1e-6 relative, for a bf16 result: a
// degree-6 Taylor polynomial above -0.35 (remainder < 5e-7 relative), the
// hardware exp2 less 1 below (|result| >= 0.29, so its 2^-22 relative error
// stays under 1e-6). Both are computed and one is selected: no branch for
// the lanes of a warp to diverge on. expm1f costs several times as many
// instructions and branches, and the bf16 kernel, one block of eight warps
// an SM, feels each of them.
__device__ __forceinline__ float expm1_neg(float v) {
  const float p =
      v * (1.f + v * (0.5f + v * (1.f / 6.f +
                                  v * (1.f / 24.f +
                                       v * (1.f / 120.f + v * (1.f / 720.f))))));
  const float q = __expf(v) - 1.f;
  return v > -0.35f ? p : q;
}

// acc * scale, + shift, ELU: each where its bit is set, rounded apart.
// FAST: ELU's e^v - 1 by expm1_neg (the bf16 design), else expm1f.
template <bool FAST>
__device__ __forceinline__ float epilogue(float v, float sc, float sh,
                                          int mode) {
  if (mode & kEpScale) v = __fmul_rn(v, sc);
  if (mode & kEpShift) v = __fadd_rn(v, sh);
  if (mode & kEpElu) {
    // the negative branch for every lane, then a select
    const float n = FAST ? expm1_neg(fminf(v, 0.f)) : expm1f(fminf(v, 0.f));
    v = v > 0.f ? v : n;
  }
  return v;
}

// ——— float32, the first version ———

constexpr int kThreads = 256;
constexpr int kRows = 32;  // rows of x per block
constexpr int kTP = 4;     // output positions per thread
constexpr int kTF = 4;     // filters per thread (one float4 of w~)

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tsconv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift, int ep,
                      T* __restrict__ out, int rows, int Tn, int M, int F,
                      int P, int stride) {
  extern __shared__ __align__(16) float sm[];
  const int Fp = (F + kTF - 1) / kTF * kTF;  // w~ row padded with zeros
  float* ws = sm;                            // M x Fp
  float* xs = sm + M * Fp;                   // kRows x Tn
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, rows - r0);

  for (int i = threadIdx.x; i < M * Fp; i += blockDim.x) {
    const int m = i / Fp, f = i - m * Fp;
    ws[i] = f < F ? to_f(w[m * F + f]) : 0.f;
  }
  const T* xb = x + (long)r0 * Tn;
  for (int i = threadIdx.x; i < nr * Tn; i += blockDim.x) xs[i] = to_f(xb[i]);
  __syncthreads();

  const int n_pg = (P + kTP - 1) / kTP;
  const int n_fg = Fp / kTF;
  T* ob = out + (long)r0 * P * F;
  for (int item = threadIdx.x; item < nr * n_pg * n_fg; item += blockDim.x) {
    const int fg = item % n_fg;
    const int t = item / n_fg;
    const int pg = t % n_pg;
    const int r = t / n_pg;
    const int p0 = pg * kTP;
    const int np = min(kTP, P - p0);
    const float* xr = xs + r * Tn + p0 * stride;
    const float* wc = ws + fg * kTF;
    float acc[kTP][kTF];
#pragma unroll
    for (int j = 0; j < kTP; ++j)
#pragma unroll
      for (int q = 0; q < kTF; ++q) acc[j][q] = 0.f;
#pragma unroll 5
    for (int m = 0; m < M; ++m) {
      const float4 wv = *reinterpret_cast<const float4*>(wc + m * Fp);
#pragma unroll
      for (int j = 0; j < kTP; ++j) {
        const float xv = j < np ? xr[j * stride + m] : 0.f;
        acc[j][0] = fmaf(xv, wv.x, acc[j][0]);
        acc[j][1] = fmaf(xv, wv.y, acc[j][1]);
        acc[j][2] = fmaf(xv, wv.z, acc[j][2]);
        acc[j][3] = fmaf(xv, wv.w, acc[j][3]);
      }
    }
    T* orow = ob + (long)r * P * F;
#pragma unroll
    for (int j = 0; j < kTP; ++j) {
      if (j >= np) break;
#pragma unroll
      for (int q = 0; q < kTF; ++q) {
        const int f = fg * kTF + q;
        if (f >= F) continue;
        float v = acc[j][q];
        if (ep)
          v = epilogue<false>(v, scale ? scale[f] : 1.f,
                              shift ? shift[f] : 0.f, ep);
        orow[(p0 + j) * F + f] = from_f<T>(v);
      }
    }
  }
}

size_t fma_smem(int Tn, int M, int F) {
  const int Fp = (F + kTF - 1) / kTF * kTF;
  return ((size_t)M * Fp + (size_t)kRows * Tn) * sizeof(float);
}

int launch_fma(const void* x, const void* w, const float* scale,
               const float* shift, int ep, void* out, int rows, int Tn,
               int M, int F, int P, int stride, cudaStream_t s) {
  const size_t smem = fma_smem(Tn, M, F);
  cudaError_t e = cudaFuncSetAttribute(
      tsconv_fwd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (rows + kRows - 1) / kRows;
  tsconv_fwd_kernel<float><<<blocks, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), scale,
      shift, ep, static_cast<float*>(out), rows, Tn, M, F, P, stride);
  return (int)cudaGetLastError();
}

// ——— bfloat16 on the tensor cores ———

using mma::bf16;
using tsconv::kTileRows;
using tsconv::kXp;
using tsconv::kXRegs;
static_assert(tsconv::kThreads == kThreads, "one block size");

constexpr int kMaxStride = 8;
constexpr int kKT = 5;              // 16-tap k steps, at most (taps <= 80)
constexpr int kNT = 5;              // 8-filter blocks, at most (F <= 40)
constexpr int kNP = (kNT + 1) / 2;  // 16-filter ldmatrix pairs
constexpr int kWp = 16 * kNP + 8;   // pitch of the staged w~ (56)
constexpr int kWarps = kThreads / 32;

struct MmaParams {
  const bf16* x;
  const bf16* w;
  const float* scale;  // the epilogue's vectors (F), or null
  const float* shift;
  int ep;              // the epilogue's parts (kEp* bits), 0: none
  bf16* out;
  int rows, Tn, M, F, P, s;
  int Tx;       // rows of xT: T, or past it as far as the padded taps reach
  int Op;       // pitch of an output row in shared memory
  int n_tiles;
  int x_pair;   // x rows take 4-byte loads
  int bulk;     // output rows take cp.async.bulk: P F a multiple of 8, out
                // 16-byte aligned
};

struct MmaSmem {
  size_t xt, out, ep, total;
};

__host__ __device__ inline MmaSmem mma_smem(int Tx, int Op) {
  MmaSmem l;
  l.xt = 0;
  l.out = align16((size_t)Tx * kXp * 2);
  // two output tiles; at the start the first holds the staged w~
  const size_t tiles = 2 * (size_t)kTileRows * Op * 2;
  const size_t wst = (size_t)16 * kKT * kWp * 2;
  // then the epilogue's scale and shift, kEpMax floats each
  l.ep = align16(l.out + (tiles > wst ? tiles : wst));
  l.total = l.ep + 2 * kEpMax * sizeof(float);
  return l;
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bytes (a multiple of 16) from shared memory to global memory by the TMA,
// tracked in this thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(mma::smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until all but the N most recent bulk groups have read their source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// wait until every bulk group of this thread is complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// EXACT: the ATM-S shape (stride 5, F 40, kKT tap steps), whose offsets
// are constants; otherwise every step and block is guarded at run time.
// EP: the epilogue's parts known when compiling (the modes TSConv takes:
// none, shift, scale + shift + ELU), or kEpAny to read p.ep.
template <bool EXACT, int EP>
__global__ void __launch_bounds__(kThreads, 1)
    tsconv_fwd_mma_kernel(const MmaParams p) {
  const int ep = EP == kEpAny ? p.ep : EP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s = EXACT ? 5 : p.s;
  const int F = EXACT ? 40 : p.F;
  const int Tn = p.Tn, P = p.P, Op = p.Op;
  const int PF = P * F;
  const int KT = EXACT ? kKT : (p.M + 15) / 16;
  const int NT = EXACT ? kNT : (F + 7) / 8;
  const MmaSmem l = mma_smem(p.Tx, Op);
  bf16* xT = reinterpret_cast<bf16*>(smem_raw + l.xt);      // Tx x kXp
  bf16* outs = reinterpret_cast<bf16*>(smem_raw + l.out);   // 2 x 32 x Op
  float* eps = reinterpret_cast<float*>(smem_raw + l.ep);   // scale, shift
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tg = lane & 3;

  // zeros once: the rows of xT past T (the padded taps read them)
  for (size_t i = tid; i < l.out / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(smem_raw)[i] = 0u;
  // w~ (M x F) staged as (16 kKT) x kWp, zero past M and F, then into
  // registers as B fragments: b[k][j] for taps 16 k .., filters 16 j ..
  bf16* wst = outs;
  for (int i = tid; i < 16 * kKT * kWp; i += kThreads) {
    const int m = i / kWp, f = i - m * kWp;
    wst[i] = m < p.M && f < F ? p.w[m * F + f] : __float2bfloat16(0.f);
  }
  for (int i = tid; i < kEpMax; i += kThreads) {
    eps[i] = p.scale && i < F ? p.scale[i] : 1.f;
    eps[kEpMax + i] = p.shift && i < F ? p.shift[i] : 0.f;
  }
  __syncthreads();
  uint32_t b[kKT][kNP][4];
#pragma unroll
  for (int k = 0; k < kKT; ++k)
#pragma unroll
    for (int j = 0; j < kNP; ++j)
      mma::frag_b_mnmajor(b[k][j], wst, kWp, 16 * k, 16 * j);
  // this lane's epilogue factors, filters 8 j + 2 tg (+ 1), held in
  // registers: read from shared memory beside the tile's stores, the
  // compiler would order each read after them
  float ep_sc[kNT][2], ep_sh[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      ep_sc[j][q] = eps[8 * j + 2 * tg + q];
      ep_sh[j][q] = eps[kEpMax + 8 * j + 2 * tg + q];
    }

  // this lane's ldmatrix.trans address inside xT for the unit at position 0,
  // rows 0..15: xT row (lane & 7) + 8 (lane >> 4), column 8 ((lane >> 3) & 1)
  const uint32_t xt_lane =
      mma::smem_u32(xT) +
      2 * (((lane & 7) + ((lane >> 4) << 3)) * kXp + ((lane >> 3) & 1) * 8);

  uint32_t xr[kXRegs];
  int tile = blockIdx.x;
  if (tile < p.n_tiles) {
    tsconv::load_x(xr, p.x, p.rows, Tn, tile * kTileRows, p.x_pair);
    tsconv::store_x(xr, xT, Tn);
  }
  for (int it = 0; tile < p.n_tiles; ++it, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    const bool has_next = next < p.n_tiles;
    if (has_next)
      tsconv::load_x(xr, p.x, p.rows, Tn, next * kTileRows, p.x_pair);
    // this tile's output buffer was last copied out two tiles ago
    if (p.bulk && warp == 0) bulk_wait_read<1>();
    __syncthreads();  // xT holds this tile; the buffer is free (and, at the
                      // first tile, every warp holds its w~ fragments)
    bf16* buf = outs + (it & 1) * kTileRows * Op;

    // units: (position, 16-row half), dealt to the warps
    for (int u = warp; u < 2 * P; u += kWarps) {
      const int pos = u >> 1, h = u & 1;
      float c[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
      const uint32_t a_addr = xt_lane + 2 * (pos * s * kXp + h * 16);
#pragma unroll
      for (int k = 0; k < kKT; ++k) {
        if (!EXACT && k >= KT) break;
        uint32_t a[4];
        mma::ldsm_x4_trans(a, a_addr + 2 * 16 * k * kXp);
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          if (EXACT || j < NT)
            mma::mma_bf16(c[j], a, b[k][j >> 1][(j & 1) * 2],
                          b[k][j >> 1][(j & 1) * 2 + 1]);
      }
      // rows h 16 + gq (+ 8), filters 8 j + 2 tg (+ 1)
      bf16* o = buf + (h * 16 + gq) * Op + pos * F + 2 * tg;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          bf16* dst = o + hh * 8 * Op + 8 * j;
          float a0 = c[j][2 * hh], a1 = c[j][2 * hh + 1];
          if (ep) {
            a0 = epilogue<true>(a0, ep_sc[j][0], ep_sh[j][0], ep);
            a1 = epilogue<true>(a1, ep_sc[j][1], ep_sh[j][1], ep);
          }
          const bf16 v0 = __float2bfloat16(a0);
          const bf16 v1 = __float2bfloat16(a1);
          if (EXACT) {
            __nv_bfloat162 v;
            v.x = v0;
            v.y = v1;
            *reinterpret_cast<__nv_bfloat162*>(dst) = v;
          } else {
            const int f = 8 * j + 2 * tg;
            if (f < F) dst[0] = v0;
            if (f + 1 < F) dst[1] = v1;
          }
        }
      }
    }

    const int r0 = tile * kTileRows;
    const int nr = min(kTileRows, p.rows - r0);
    if (p.bulk) fence_proxy_async();  // the tile's stores, before the TMA
    __syncthreads();  // the output tile is complete; xT is consumed
    if (p.bulk) {
      if (warp == 0) {
        if (lane < nr)
          bulk_store(p.out + (long)(r0 + lane) * PF, buf + lane * Op,
                     (uint32_t)PF * 2);
        bulk_commit();
      }
    } else {
      for (int e = tid; e < nr * PF; e += kThreads) {
        const int r = e / PF, col = e - r * PF;
        p.out[(long)(r0 + r) * PF + col] = buf[r * Op + col];
      }
    }
    if (has_next) tsconv::store_x(xr, xT, Tn);
  }
  if (p.bulk && warp == 0) bulk_wait_all();
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
  int Tx, Op, n_tiles, blocks;
  size_t smem;
};

MmaPlan mma_plan(int rows, int Tn, int M, int F, int P, int stride) {
  MmaPlan pl{};
  if (stride < 1 || stride > kMaxStride || F < 1 || F > 8 * kNT || M < 1 ||
      M > 16 * kKT || Tn > tsconv::kMaxT)
    return pl;
  const int reach = (P - 1) * stride + (M + 15) / 16 * 16;
  pl.Tx = Tn > reach ? Tn : reach;
  // rows padded by 8 elements: the fragment stores of one warp fall on
  // different banks
  pl.Op = (P * F + 7) / 8 * 8 + 8;
  pl.n_tiles = (rows + kTileRows - 1) / kTileRows;
  const int sms = sm_count();
  if (sms <= 0) return pl;
  pl.blocks = pl.n_tiles < sms ? pl.n_tiles : sms;
  pl.smem = mma_smem(pl.Tx, pl.Op).total;
  pl.ok = pl.smem <= kMaxSmem;
  return pl;
}

template <bool EXACT, int EP>
int launch_mma_ep(const MmaParams& p, const MmaPlan& pl, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      tsconv_fwd_mma_kernel<EXACT, EP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return (int)e;
  tsconv_fwd_mma_kernel<EXACT, EP><<<pl.blocks, kThreads, pl.smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <bool EXACT>
int launch_mma_as(const MmaParams& p, const MmaPlan& pl, cudaStream_t s) {
  switch (p.ep) {
    case 0:
      return launch_mma_ep<EXACT, 0>(p, pl, s);
    case kEpShift:
      return launch_mma_ep<EXACT, kEpShift>(p, pl, s);
    case kEpScale | kEpShift | kEpElu:
      return launch_mma_ep<EXACT, kEpScale | kEpShift | kEpElu>(p, pl, s);
    default:
      return launch_mma_ep<EXACT, kEpAny>(p, pl, s);
  }
}

int launch_mma(const void* x, const void* w, const float* scale,
               const float* shift, int ep, void* out, int rows, int Tn,
               int M, int F, int P, int stride, cudaStream_t s) {
  const MmaPlan pl = mma_plan(rows, Tn, M, F, P, stride);
  if (!pl.ok) return (int)cudaErrorInvalidValue;
  MmaParams p;
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.scale = scale;
  p.shift = shift;
  p.ep = ep;
  p.out = static_cast<bf16*>(out);
  p.rows = rows;
  p.Tn = Tn;
  p.M = M;
  p.F = F;
  p.P = P;
  p.s = stride;
  p.Tx = pl.Tx;
  p.Op = pl.Op;
  p.n_tiles = pl.n_tiles;
  p.x_pair = Tn % 2 == 0 && (reinterpret_cast<uintptr_t>(x) & 3) == 0;
  p.bulk = (P * F) % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const bool atms = stride == 5 && F == 8 * kNT && M > 16 * (kKT - 1);
  return atms ? launch_mma_as<true>(p, pl, s) : launch_mma_as<false>(p, pl, s);
}

bool shape_ok(int Tn, int M, int P, int stride) {
  return P > 0 && M > 0 && stride > 0 && (P - 1) * stride + M <= Tn;
}

}  // namespace

// Which design a dtype takes: "mma_bf16" (tensor cores) or "fma_fp32".
extern "C" const char* eid_tsconv_fwd_design(int dtype) {
  return dtype == kBF16 ? "mma_bf16" : "fma_fp32";
}

// 1 if the design of `dtype` takes the shape, else 0.
extern "C" int eid_tsconv_fwd_takes(int dtype, int rows, int Tn, int M, int F,
                                    int P, int stride) {
  if (rows < 0 || F <= 0 || !shape_ok(Tn, M, P, stride)) return 0;
  if (dtype == kBF16) return mma_plan(rows, Tn, M, F, P, stride).ok ? 1 : 0;
  if (dtype == kF32) return fma_smem(Tn, M, F) <= kMaxSmem ? 1 : 0;
  return 0;
}

// x: (rows, Tn), w: (M, F), out: (rows, P*F), all contiguous in dtype, with
// P = (Tn - M) / stride + 1. The epilogue: scale and shift, fp32 (F) or
// null, and elu (0 or 1); with neither vector and elu 0, none.
extern "C" int eid_tsconv_fwd(int dtype, const void* x, const void* w,
                              const float* scale, const float* shift,
                              int elu, void* out, int rows, int Tn, int M,
                              int F, int P, int stride, void* stream) {
  if (rows <= 0) return 0;
  if (!eid_tsconv_fwd_takes(dtype, rows, Tn, M, F, P, stride))
    return (int)cudaErrorInvalidValue;
  const int ep = (scale ? kEpScale : 0) | (shift ? kEpShift : 0) |
                 (elu ? kEpElu : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_mma(x, w, scale, shift, ep, out, rows, Tn, M, F, P, stride,
                      s);
  return launch_fma(x, w, scale, shift, ep, out, rows, Tn, M, F, P, stride,
                    s);
}
