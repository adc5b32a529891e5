// bf16 tensor-core tile code shared by the redesigned kernels: the PTX
// wrappers (cp.async, ldmatrix, mma.sync.m16n8k16 with fp32 accumulators)
// and `gemm_tile`, one 64 x BN (128 or 64) output tile of C = A B per
// 256-thread block with an epilogue functor.
//
// A bf16 x bf16 product is exact in fp32, so a tensor-core product with fp32
// accumulators is the arithmetic of the FMA kernels in another order. fp32
// operands never come here: the tensor cores would take them as TF32.
//
// gemm_tile. Either operand may lie in memory with its K index contiguous
// ("K-major": A as (M, K) row-major, B as (N, K) row-major, i.e. B^T) or
// with its M/N index contiguous ("MN-major": A as (K, M), i.e. A^T; B as
// (K, N) row-major). ldmatrix reads the first kind as it lies and the second
// with .trans, so x^T d_a, d_z Wr^T and x Wi all run from the tensors as
// they are stored, without a transposed copy. BK = 32 slices of both
// operands go through a three-stage cp.async ring in shared memory (45 KB),
// so the loads of slice k+2 overlap the products of slice k. Eight warps as
// 2 x 4, each a 32 x (BN / 4) block of the tile: per 16-deep step two
// ldmatrix.x4 for A, BN / 64 for B and BN / 16 mma. One block owns a whole
// output tile and sums over all of K in a fixed order: no split-K partials,
// no atomics, a rerun is bit-equal. An output element's sum runs over the
// same k steps in the same order whatever BN is, so the two widths give the
// same bits; BN = 64 puts twice the blocks on a short M.
//
// Edges. Rows and columns past M, N and K are zero-filled in shared memory
// and masked in the epilogue; the caller pads nothing. The 16-byte cp.async
// path needs a leading dimension that is a multiple of 8 elements and a
// 16-byte aligned base (1440 and 1024 are); any other shape (150, 100)
// takes guarded 2-byte loads beside it, chunk by chunk.
//
// Shared-memory pitches are padded by 8 elements so the eight row addresses
// of one ldmatrix phase fall on different bank groups.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace eid {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64, kBN = 128, kBK = 32;
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kPad = 8;
// elements of one stage: the larger layout of each operand
constexpr int kAElems = kBM * (kBK + kPad);   // 2560 (MN-major: 32 * 72)
constexpr int kBElems = kBN * (kBK + kPad);   // 5120 (MN-major: 32 * 136)
constexpr int kStageElems = kAElems + kBElems;
constexpr int kSmemBytes = kStages * kStageElems * 2;  // 46,080

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 32-bit word of shared memory at a shared-space byte address. Volatile,
// so it keeps its place among the ldmatrix and mma instructions: a plain
// load may be moved down to its first use, where its latency is exposed.
__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, of matrix j, the elements (l / 4, 2 (l % 4) .. +1)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  ldsm_x4(r, smem_u32(p));
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  ldsm_x4_trans(r, smem_u32(p));
}

// c (16 x 8, fp32) += a (16 x 16, bf16) b (16 x 8, bf16). With g = lane / 4
// and t = lane % 4: a0 = A[g][2t..], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
// a3 = A[g+8][2t+8..]; b0 = B[2t..][g], b1 = B[2t+8..][g]; c0, c1 =
// C[g][2t], C[g][2t+1]; c2, c3 = C[g+8][2t], C[g+8][2t+1].
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of the 16 x 16 block at (m0, k0) of a K-major tile s[m][k]
__device__ __forceinline__ void frag_a_kmajor(uint32_t (&a)[4], const bf16* s,
                                              int pitch, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, s + (m0 + (lane & 15)) * pitch + k0 + (lane >> 4) * 8);
}

// B fragments of the two 16 x 8 blocks at (k0, n0) and (k0, n0 + 8) of an
// MN-major tile s[k][n]: b[0], b[1] the first block's, b[2], b[3] the
// second's
__device__ __forceinline__ void frag_b_mnmajor(uint32_t (&b)[4], const bf16* s,
                                               int pitch, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(b, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch +
                       n0 + (lane >> 4) * 8);
}

// Stage a (ROWS x kBK) slice of an operand. K-major: element (mn, k) lies at
// g[mn * ld + k] and goes to s[mn][k] (pitch kBK + 8); MN-major: it lies at
// g[k * ld + mn] and goes to s[k][mn] (pitch ROWS + 8). Out of range is 0.
template <int ROWS, bool KMAJOR>
__device__ __forceinline__ void load_slice(bf16* s, const bf16* g, long ld,
                                           int mn0, int k0, int MN, int K,
                                           bool vec_ok) {
  constexpr int kInner = KMAJOR ? kBK : ROWS;   // contiguous extent
  constexpr int kOuter = KMAJOR ? ROWS : kBK;
  constexpr int kPitch = kInner + kPad;
  constexpr int kChunks = kInner / 8;
  const int o0 = KMAJOR ? mn0 : k0, i0 = KMAJOR ? k0 : mn0;
  const int Eo = KMAJOR ? MN : K, Ei = KMAJOR ? K : MN;
  for (int c = threadIdx.x; c < kOuter * kChunks; c += kThreads) {
    const int o = c / kChunks, i = (c - o * kChunks) * 8;
    bf16* dst = s + o * kPitch + i;
    const int go = o0 + o, gi = i0 + i;
    const bf16* src = g + (long)go * ld + gi;
    if (go < Eo && vec_ok && gi + 8 <= Ei) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (go < Eo && gi + e < Ei) ? src[e] : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ bool vec_ok(const void* p, long ld) {
  return (ld & 7) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One operand's slices of a tile, staged one after the other (kt = 0, 1,
// ...). A tile whose slices lie wholly inside the operand and take the
// 16-byte copies is the common case: each thread's source pointers and
// shared-memory offsets are worked out once and a slice costs one cp.async
// and one add per chunk. The warps run in order and few to a scheduler, so
// address arithmetic inside the k loop costs more than the products. Any
// other tile goes slice by slice through load_slice's guarded path.
template <int ROWS, bool KMAJOR>
struct SliceLoader {
  static constexpr int kInner = KMAJOR ? kBK : ROWS;
  static constexpr int kOuter = KMAJOR ? ROWS : kBK;
  static constexpr int kPitch = kInner + kPad;
  static constexpr int kChunks = kInner / 8;
  static constexpr int kPerThread = kOuter * kChunks / kThreads;  // 1 or 2
  const bf16* g;
  long ld;
  int mn0, MN, K;
  bool vec, fast;
  const bf16* src[kPerThread];
  int dst[kPerThread];  // element offsets inside a stage's tile

  __device__ __forceinline__ void init(const bf16* g_, long ld_, int mn0_,
                                       int MN_, int K_) {
    g = g_, ld = ld_, mn0 = mn0_, MN = MN_, K = K_;
    vec = vec_ok(g, ld);
    fast = vec && mn0 + ROWS <= MN && K % kBK == 0;
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int c = threadIdx.x + u * kThreads;
      const int o = c / kChunks, i = (c - o * kChunks) * 8;
      dst[u] = o * kPitch + i;
      src[u] = KMAJOR ? g + (long)(mn0 + o) * ld + i
                      : g + (long)o * ld + mn0 + i;
    }
  }

  // slice kt into the tile at s; call with kt = 0, 1, 2, ... in order
  __device__ __forceinline__ void load(bf16* s, int kt) {
    if (fast) {
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        cp_async16(s + dst[u], src[u]);
        src[u] += KMAJOR ? (long)kBK : (long)kBK * ld;
      }
    } else {
      load_slice<ROWS, KMAJOR>(s, g, ld, mn0, kt * kBK, MN, K, vec);
    }
  }
};

// The tile of C = A B at (m0, n0), kBM x BN: epi(row, col, sum) for every
// element of it inside M x N. A: M x K, B: K x N, in the layouts the flags
// name; smem: kSmemBytes, 16-byte aligned. All 256 threads of the block
// call it.
template <bool A_KMAJOR, bool B_KMAJOR, int BN = kBN, typename Epi>
__device__ __forceinline__ void gemm_tile(const bf16* A, long lda,
                                          const bf16* B, long ldb, int M,
                                          int N, int K, int m0, int n0,
                                          unsigned char* smem, Epi epi) {
  static_assert(BN == 128 || BN == 64, "BN: 128 or 64 columns");
  constexpr int kNJ = BN / 32;  // 8-column blocks of a warp
  constexpr int kPA = (A_KMAJOR ? kBK : kBM) + kPad;
  constexpr int kPB = (B_KMAJOR ? kBK : BN) + kPad;
  bf16* base = reinterpret_cast<bf16*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * (BN / 4);
  const int nk = (K + kBK - 1) / kBK;

  SliceLoader<kBM, A_KMAJOR> la;
  SliceLoader<BN, B_KMAJOR> lb;
  la.init(A, lda, m0, M, K);
  lb.init(B, ldb, n0, N, K);
  auto load = [&](int kt) {
    bf16* as = base + (kt % kStages) * kStageElems;
    la.load(as, kt);
    lb.load(as + kAElems, kt);
  };

  // This lane's ldmatrix row addresses inside a stage, in bytes; the
  // fragment of 16-row tile i (or column pair j) at step kk adds a constant.
  // K-major A s[m][k]: lanes 0-15 the rows, lanes 16-31 the same rows 8
  // columns on; MN-major A s[k][m] (.trans): the k rows in lanes 0-7 and
  // 16-23, the m + 8 half in lanes 8-15 and 24-31. B alike, with b[0], b[1]
  // the first 8 columns' fragment and b[2], b[3] the next 8 columns'.
  const uint32_t a_lane =
      2 * (A_KMAJOR ? (wm + (lane & 15)) * kPA + (lane >> 4) * 8
                    : ((lane & 7) + ((lane >> 4) << 3)) * kPA + wm +
                          ((lane >> 3) & 1) * 8);
  const uint32_t b_lane =
      2 * (kAElems +
           (B_KMAJOR ? (wn + (lane & 7) + ((lane >> 4) << 3)) * kPB +
                           ((lane >> 3) & 1) * 8
                     : ((lane & 7) + ((lane >> 3) & 1) * 8) * kPB + wn +
                           (lane >> 4) * 8));
  const uint32_t smem0 = smem_u32(base);

  float acc[2][kNJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  __syncthreads();  // the previous user of smem is done
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  int stage = 0;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt has landed; slice kt-1 is consumed
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    cp_async_commit();
    const uint32_t st = smem0 + stage * (kStageElems * 2);
    stage = stage + 1 == kStages ? 0 : stage + 1;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4], b[kNJ / 2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (A_KMAJOR)
          ldsm_x4(a[i], st + a_lane + 2 * (i * 16 * kPA + kk));
        else
          ldsm_x4_trans(a[i], st + a_lane + 2 * (kk * kPA + i * 16));
      }
#pragma unroll
      for (int j = 0; j < kNJ / 2; ++j) {
        if (B_KMAJOR)
          ldsm_x4(b[j], st + b_lane + 2 * (j * 16 * kPB + kk));
        else
          ldsm_x4_trans(b[j], st + b_lane + 2 * (kk * kPB + j * 16));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
          mma_bf16(acc[i][j], a[i], b[j >> 1][(j & 1) * 2],
                   b[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm + i * 16 + g + (e >> 1) * 8;
        const int c = n0 + wn + j * 8 + 2 * t + (e & 1);
        if (r < M && c < N) epi(r, c, acc[i][j][e]);
      }
}

}  // namespace mma
}  // namespace eid
