// The row tiles of x that the two tensor-core tsconv kernels
// (csrc/tsconv_fwd.cu, csrc/tsconv_bwd.cu) stage transposed in shared
// memory: xT[t][r], the samples t of the tile's 32 rows r.
//
// A window of position p, x[r, p s + m] for the taps m, is then the run of
// rows p s .. of xT, at any offset, and ldmatrix reads it as a product
// operand with the rows r contiguous. x rows are 500 bytes at ATM-S width,
// only 4-byte aligned, so they cannot take cp.async: x goes through
// registers, two samples to a word, loaded for the next tile before the
// products of this one and stored transposed after them.
#pragma once

#include <cstdint>

#include "mma_tile.cuh"

namespace eid {
namespace tsconv {

using mma::bf16;

constexpr int kThreads = 256;       // threads of a block
constexpr int kTileRows = 32;       // rows of x per tile
constexpr int kXp = kTileRows + 8;  // pitch of xT[t][r]
constexpr int kXRegs = 16;          // 4-byte x loads per thread and tile
constexpr int kMaxT = 2 * kXRegs * kThreads / kTileRows;  // 256 samples

// pair i of a thread's x loads: row r of the tile and sample pair tp. Eight
// rows by four pairs per warp: 16-byte runs of x, and transposed stores that
// fall on different banks.
__device__ __forceinline__ void x_item(int i, int& r, int& tp) {
  const int idx = i * kThreads + threadIdx.x;
  const int rest = idx >> 5;
  r = (rest & 3) * 8 + (idx & 7);
  tp = (rest >> 2) * 4 + ((idx >> 3) & 3);
}

// The tile's rows r0 .. r0 + 31 of x (rows, Tn) into registers; rows past
// `rows` read as 0. x_pair: Tn is even and x 4-byte aligned, so a word is
// one load.
__device__ __forceinline__ void load_x(uint32_t (&xr)[kXRegs], const bf16* x,
                                       int rows, int Tn, int r0,
                                       bool x_pair) {
  const int nr = min(kTileRows, rows - r0);
  const int PR = (Tn + 1) / 2;
#pragma unroll
  for (int i = 0; i < kXRegs; ++i) {
    int r, tp;
    x_item(i, r, tp);
    const bool ok = r < nr && tp < PR;
    const bf16* src = x + (long)(r0 + r) * Tn + 2 * tp;
    uint32_t v = 0u;
    if (ok && x_pair) {
      v = *reinterpret_cast<const uint32_t*>(src);
    } else if (ok) {
      v = __bfloat16_as_ushort(src[0]);
      if (2 * tp + 1 < Tn)
        v |= (uint32_t)__bfloat16_as_ushort(src[1]) << 16;
    }
    xr[i] = v;
  }
}

// The registers of load_x into xT (pitch kXp), rows t < Tn; the rows of xT
// past Tn are left as they are (the kernels zero them once).
__device__ __forceinline__ void store_x(const uint32_t (&xr)[kXRegs],
                                        bf16* xT, int Tn) {
  const int PR = (Tn + 1) / 2;
#pragma unroll
  for (int i = 0; i < kXRegs; ++i) {
    int r, tp;
    x_item(i, r, tp);
    if (tp < PR) {
      xT[(2 * tp) * kXp + r] = __ushort_as_bfloat16(xr[i] & 0xffffu);
      if (2 * tp + 1 < Tn)
        xT[(2 * tp + 1) * kXp + r] = __ushort_as_bfloat16(xr[i] >> 16);
    }
  }
}

}  // namespace tsconv
}  // namespace eid
