// The projection head's bfloat16 forward chain on the tensor cores, shared
// by its forward (csrc/projection_fwd.cu) and by its backward's recompute
// (csrc/projection_bwd.cu):
//
//   1. a = x Wi + bi          -> a (fp32), gdt = rnd(gelu_tanh(a)) (bf16)
//   2. z = (gdt Wr + br) * m  -> r = a + z (fp32)
//
// two launches of mma_tile.cuh::gemm_tile with fused epilogues, where m is
// the keep-mask factor: 1 (mode 0), the mask read in bf16 and widened (mode
// 1), or drawn by philox.cuh, site 4, keyed (seed, global row), value 1/keep
// in fp32 (mode 2): the same bits whatever the tiling, so the backward
// redraws the forward's mask.
//
// The two kernels live in projection_fwd.cu, one translation unit; the
// backward calls launch_chain_fwd. What this header defines is inline, so
// both sources may include it.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "mma_tile.cuh"
#include "philox.cuh"

namespace eid {
namespace proj {

using mma::bf16;

// The chain's operands. The backward's arguments extend these.
struct ChainFwd {
  const bf16* x;                  // (B, Din)
  const bf16 *wi, *bi, *wr, *br;  // Wi (Din, Dout), Wr (Dout, Dout)
  bf16* gdt;                      // (B, Dout): rnd(gelu(a))
  float* a32;                     // (B, Dout): a
  float* r32;                     // (B, Dout): r = a + z
  int B, Din, Dout;
  int mode;                       // kDropNone / kDropMasks / kDropSeed
  const bf16* mask;               // (B, Dout), mode 1
  const int* seed;                // one int32 on the device, mode 2
  uint32_t thresh;                // keep iff bits < thresh
  float inv_keep;                 // the kept value, mode 2
  uint32_t sample0;               // mode 2: the global index of row 0
};

__device__ __forceinline__ float mask_factor(const ChainFwd& p, uint32_t seed,
                                             int row, int col) {
  if (p.mode == kDropMasks) return to_f(p.mask[(long)row * p.Dout + col]);
  if (p.mode == kDropSeed)
    return keep_bits(seed, (uint32_t)row + p.sample0, kSiteProjection,
                     (uint32_t)col) <
                   p.thresh
               ? p.inv_keep
               : 0.f;
  return 1.f;
}

// The origin of output tile `tile` of a row-major grid of kBM x BN tiles
// over n_cols columns.
template <int BN = mma::kBN>
__device__ __forceinline__ void tile_origin(int tile, int n_cols, int& m0,
                                            int& n0) {
  const int col_tiles = (n_cols + BN - 1) / BN;
  m0 = (tile / col_tiles) * mma::kBM;
  n0 = (tile % col_tiles) * BN;
}

inline int n_tiles(int rows, int cols, int bn = mma::kBN) {
  return ((rows + mma::kBM - 1) / mma::kBM) * ((cols + bn - 1) / bn);
}

// The column width of the chain's tiles at batch B: 64 up to the largest
// serving bucket (B 256: 32 tiles of 64 x 128 would fill a quarter of the
// 132 SMs), 128 above it. Either width gives the same bits.
inline int chain_bn(int B) { return B <= 256 ? 64 : 128; }

// Launches 1 and 2 on stream s; a CUDA error code, 0 on success.
int launch_chain_fwd(const ChainFwd& p, cudaStream_t s);

}  // namespace proj
}  // namespace eid
