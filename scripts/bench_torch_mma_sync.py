#!/usr/bin/env python3
"""What rate ``mma.sync.m16n8k16`` (bf16 in, fp32 accumulators) reaches on the
card, by warps per SM and independent accumulators per warp.

    python3 scripts/bench_torch_mma_sync.py

The port's tensor-core kernels (``csrc/mma_tile.cuh``) use ``mma.sync``,
not ``wgmma``; this is the ceiling they work under. Compiles a register-only
kernel with ``nvcc`` for ``sm_90a`` into a temporary directory (one block per
SM, every warp a loop of ILP independent products) and prints, per
configuration, the time, the TFLOP/s and the SM clocks one product takes at
the clock ``nvidia-smi`` reports. Needs a CUDA device and the CUDA toolkit.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SOURCE = r"""
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int ILP>
__global__ void k(float* out, int iters, uint32_t seed) {
  float c[ILP][4];
  for (int i = 0; i < ILP; ++i)
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
  uint32_t a[4] = {seed, seed + 1, seed + 2, seed + 3};
  uint32_t b0 = seed * 3, b1 = seed * 5;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < ILP; ++i) mma(c[i], a, b0, b1);
  }
  float s = 0;
  for (int i = 0; i < ILP; ++i)
    for (int e = 0; e < 4; ++e) s += c[i][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int ILP>
void run(int sms, int warps, float* out, double mhz) {
  const int iters = 4096;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  k<ILP><<<sms, warps * 32>>>(out, 16, 0);
  cudaEventRecord(a);
  k<ILP><<<sms, warps * 32>>>(out, iters, 0);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double per_sm = (double)warps * iters * ILP;
  printf("{\"warps_per_sm\": %d, \"ilp\": %d, \"ms\": %.4f, \"tflops\": %.1f, "
         "\"sm_clocks_per_mma\": %.3f}\n",
         warps, ILP, ms, per_sm * sms * 4096 / ms / 1e9,
         ms * 1e-3 * mhz * 1e6 / per_sm);
}
int main(int argc, char** argv) {
  const double mhz = argc > 1 ? atof(argv[1]) : 1980.0;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, (size_t)sms * 1024 * 4);
  run<1>(sms, 4, out, mhz);
  run<4>(sms, 4, out, mhz);
  run<10>(sms, 4, out, mhz);
  run<10>(sms, 8, out, mhz);
  run<25>(sms, 8, out, mhz);
  run<10>(sms, 16, out, mhz);
  run<8>(sms, 32, out, mhz);
  return cudaDeviceSynchronize() == cudaSuccess ? 0 : 1;
}
"""


def main() -> int:
    import torch

    from eeg_image_decode_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("bench_torch_mma_sync: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    mhz = card.split(",")[-1].strip().split()[0]
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "mma_sync.cu"
        src.write_text(SOURCE)
        exe = Path(tmp) / "mma_sync"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:4], "-o", str(exe),
                        str(src)], check=True)
        return subprocess.run([str(exe), mhz]).returncode


if __name__ == "__main__":
    sys.exit(main())
