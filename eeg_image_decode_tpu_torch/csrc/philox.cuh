// Dropout keep-masks drawn inside the kernels: a Philox-4x32-10 counter
// generator (Salmon et al., SC'11, with Random123's constants).
//
// Replaces the TPU kernels' in-kernel draws, eeg_image_decode_tpu/ops/
// attention.py::_draw_keep_masks and ops/projection.py::_draw_keep_mask,
// which re-seed the TPU hardware PRNG per mask with (seed, grid position,
// salt). Here every mask element is a pure function of (seed, global sample
// index, site, element index):
//
//   key     = (seed, sample)
//   counter = (element / 4, site, 0, 0)   -> four 32-bit words
//   bits    = word (element % 4)
//   keep    = bits < thresh,  thresh = uint32(keep_prob * 0xFFFFFFFF)
//
// Sites: 0 m_attn (H, L, L), 1 m_res (L, D), 2 m_ffn1 (L, FF), 3 m_ffn2
// (L, D) of the attention layer, and 4 the projection head's residual
// branch (d_out), each indexed row-major within one sample. Because the key
// is the sample and not the block, the forward and the backward kernel may
// tile the batch differently and still draw the same masks, and padding
// cannot shift them. A launch over rows sample0 ... sample0 + B - 1 of a
// larger batch (one data-parallel rank's rows) passes sample0, and draws
// what the launch over the whole batch draws for those rows.
// ops/philox.py is the same generator in int64 tensor arithmetic
// (ops/attention.py::draw_keep_masks, ops/projection.py::draw_keep_mask),
// and the two agree bit for bit.
//
// Cost: ten rounds of two 32x32->64 multiplies and a few xors per four
// elements; one draw per element used (the other three words are not
// kept), since neighbouring elements are handled by neighbouring threads.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace eid {

__host__ __device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint64_t p0 = (uint64_t)0xD2511F53u * c.x;
    const uint64_t p1 = (uint64_t)0xCD9E8D57u * c.z;
    const uint32_t hi0 = (uint32_t)(p0 >> 32), lo0 = (uint32_t)p0;
    const uint32_t hi1 = (uint32_t)(p1 >> 32), lo1 = (uint32_t)p1;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__host__ __device__ __forceinline__ uint32_t keep_bits(uint32_t seed,
                                                       uint32_t sample,
                                                       uint32_t site,
                                                       uint32_t element) {
  const uint4 r = philox4x32_10(make_uint4(element >> 2, site, 0u, 0u),
                                make_uint2(seed, sample));
  switch (element & 3u) {
    case 0: return r.x;
    case 1: return r.y;
    case 2: return r.z;
    default: return r.w;
  }
}

// The bits of elements e and e + 1: one generator call when both lie in
// the same group of four (e % 4 != 3), two otherwise.
__host__ __device__ __forceinline__ uint2 keep_bits2(uint32_t seed,
                                                     uint32_t sample,
                                                     uint32_t site,
                                                     uint32_t element) {
  const uint4 r = philox4x32_10(make_uint4(element >> 2, site, 0u, 0u),
                                make_uint2(seed, sample));
  switch (element & 3u) {
    case 0: return make_uint2(r.x, r.y);
    case 1: return make_uint2(r.y, r.z);
    case 2: return make_uint2(r.z, r.w);
    default:
      return make_uint2(r.w, keep_bits(seed, sample, site, element + 1));
  }
}

// the projection head's site id (0-3 are the attention layer's)
constexpr int kSiteProjection = 4;

constexpr int kDropNone = 0;
constexpr int kDropMasks = 1;
constexpr int kDropSeed = 2;

// How one launch drops out. Mask mode reads pre-scaled keep-masks in the
// working type; seed mode draws them. The seed lies on the device, so a
// training step never waits on the host for it.
struct Dropout {
  int mode;
  const void* mask[4];  // m_attn (B,H,L,L), m_res (B,L,D), m_ffn1 (B,L,FF), m_ffn2 (B,L,D)
  const int* seed;
  uint32_t thresh;
  float inv_keep;
  uint32_t sample0;  // the global index of the launch's first sample
};

// The factor of element `e` of site `site` of sample `b` of the launch
// (site_numel elements per sample): 1 without dropout, the mask's value in
// mask mode, `kept` or 0 in seed mode, drawn for global sample b + sample0.
template <typename T>
__device__ __forceinline__ float keep_factor(const Dropout& d, uint32_t seed,
                                             int site, long b, long site_numel,
                                             long e, float kept) {
  if (d.mode == kDropMasks)
    return to_f(static_cast<const T*>(d.mask[site])[b * site_numel + e]);
  if (d.mode == kDropSeed)
    return keep_bits(seed, (uint32_t)b + d.sample0, (uint32_t)site,
                     (uint32_t)e) < d.thresh
               ? kept
               : 0.f;
  return 1.f;
}

}  // namespace eid
