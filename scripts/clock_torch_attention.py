#!/usr/bin/env python3
"""Clocks of the phases inside the bfloat16 attention kernels, per sample.

    python3 scripts/clock_torch_attention.py

No profiler on the H100 host reaches inside a kernel (``ncu`` does not run
there). This script copies the port's package into the git-ignored
``_checkout/clock/``, inserts ``clock64()`` stamps into that copy's
``csrc/attention_tile.cuh`` and ``csrc/attention_bwd.cu`` (thread 0 of each
block, after a barrier, at each phase boundary of the layer's chain and of
the backward; per ``rows_gemm`` call the clocks of its product loop and of
its epilogue), builds the copy and runs the forward (B 8 and B 256 without
dropout, B 1024 in seed mode) and the backward (B 1024, seed mode) at ATM-S
width (L 64, D 250, 4 heads of 62, FF 256). It prints one JSON line per run:
the median over the blocks of each phase's clocks. The stamps add a barrier
and a store each, so the sum runs a little above the kernel's own time. The
repository's kernels are not touched. Needs a CUDA device.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
COPY = ROOT / "_checkout" / "clock"

_HEAD = """static __device__ long long g_prof[2048 * 32];
#define STAMP(k) do { __syncthreads(); if (threadIdx.x == 0 && blockIdx.x < 2048) ::eid::attn::g_prof[blockIdx.x * 32 + (k)] = clock64(); } while (0)
"""

_READER = """
extern "C" int eid_clock_read{tag}(long long* host, int n) {{
  return (int)cudaMemcpyFromSymbol(host, eid::attn::g_prof, n * sizeof(long long));
}}
extern "C" int eid_clock_zero{tag}() {{
  static long long z[2048 * 32];
  return (int)cudaMemcpyToSymbol(eid::attn::g_prof, z, sizeof(z));
}}
"""

# (anchor, replacement) in csrc/attention_tile.cuh
TILE = [
('''  // x -> R0, zero-padded (and its padded copy for the backward's dWqkv)''','''  STAMP(0);
  // x -> R0, zero-padded (and its padded copy for the backward's dWqkv)'''),
('''  // q | k | v, each (64, innerp); the padding columns come out zero''','''  STAMP(1);
  // q | k | v, each (64, innerp); the padding columns come out zero'''),
('''  __syncthreads();
  // the heads: warp -> (head, 16 query rows); o -> R0 (x is consumed)''','''  __syncthreads();
  STAMP(2);
  // the heads: warp -> (head, 16 query rows); o -> R0 (x is consumed)'''),
('''  // a = o Wo + bo (x m_res); the residual x + a: fwd rounded into XS,''','''  STAMP(3);
  // a = o Wo + bo (x m_res); the residual x + a: fwd rounded into XS,'''),
('''  __syncthreads();
  // LN1: fwd h1 rounded in XS; bwd xhat1 in F (and saved), h1 rounded in''','''  __syncthreads();
  STAMP(4);
  // LN1: fwd h1 rounded in XS; bwd xhat1 in F (and saved), h1 rounded in'''),
('''  // u = h1 W1 + b1; the FFN hidden layer gelu(u) (x m_ffn1) -> R0''','''  STAMP(5);
  // u = h1 W1 + b1; the FFN hidden layer gelu(u) (x m_ffn1) -> R0'''),
('''  // y = hidden W2 + b2 (x m_ffn2); the residual h1 + y in place''','''  STAMP(6);
  // y = hidden W2 + b2 (x m_ffn2); the residual h1 + y in place'''),
('''  __syncthreads();
  // LN2: fwd the output; bwd xhat2 in F''','''  __syncthreads();
  STAMP(7);
  // LN2: fwd the output; bwd xhat2 in F'''),
('''      if (!kFwd && lane == 0) sm.inv2[r] = inv[k];
    }
  }
  __syncthreads();
}''','''      if (!kFwd && lane == 0) sm.inv2[r] = inv[k];
    }
  }
  __syncthreads();
  STAMP(8);
}'''),
('''  mma::cp_async_wait<0>();
  float* stage = reinterpret_cast<float*>(ring);''','''  mma::cp_async_wait<0>();
  long long t_k1 = clock64();
  if (threadIdx.x == 0 && blockIdx.x < 2048) ::eid::attn::g_prof[blockIdx.x * 32 + 28] += t_k1 - t_k0;
  float* stage = reinterpret_cast<float*>(ring);'''),
('''        if (cp[u] >= np) cp[u] -= np, ++sr[u];
      }
    }
  }
}''','''        if (cp[u] >= np) cp[u] -= np, ++sr[u];
      }
    }
  }
  if (threadIdx.x == 0 && blockIdx.x < 2048) ::eid::attn::g_prof[blockIdx.x * 32 + 29] += clock64() - t_k1;
}'''),
('''  __syncthreads();  // the previous users of the ring and of the target
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {''','''  __syncthreads();  // the previous users of the ring and of the target
  long long t_k0 = clock64();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {'''),
]

# (anchor, stamp slot) in csrc/attention_bwd.cu: a stamp before each phase
BWD = [
('''  // ——— backward ———
  // g -> R1; LN2''',10),('''  // d_z = d_r2 * m_ffn2: rounded (R1, scratch), fp32 column sums (b2)''',11),
('''  // d_u = (d_z W2^T) * m_ffn1 * gelu'(u): fp32 over u (scratch), rounded''',12),
('''  // b1 gradient: column sums of the fp32 d_u, rows in order, eight loads''',13),
('''  // d_h1 = d_r2 + d_u W1^T (F)''',14),('''  // xhat1 (fp32, L x Dp) -> R0 and R1, which are contiguous and free''',15),
('''  // LN1: scale and bias gradients, then d_r1 in F (the dx accumulator)''',16),
('''  // d_attn = d_r1 * m_res: rounded (R1, scratch), fp32 column sums (bo)''',17),
('''  // d_o = d_attn Wo^T, rounded, per head in its padded columns (R0)''',18),
('''  // the softmax backward, two heads at a time; their q, k, v in the ring''',19),
('''  // dx = d_r1 + dq Wq^T + dk Wk^T + dv Wv^T, in that order
  for (int m = 0; m < 3; ++m) {
    __syncthreads();  // R1's last reader is done''',25),]


_CHILD = r"""
import ctypes, json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from eeg_image_decode_tpu_torch.ops import _build
from eeg_image_decode_tpu_torch.ops.attention import fused_attention_layer
lib = _build.lib()
for n in ("eid_clock_read", "eid_clock_read_bwd"):
    getattr(lib, n).argtypes = [ctypes.c_void_p, ctypes.c_int]
g = torch.Generator(device="cuda").manual_seed(1)
D, H, FF, L, inner = 250, 4, 256, 64, 248
shapes = {"wq": (D, inner), "bq": (inner,), "wk": (D, inner), "bk": (inner,),
          "wv": (D, inner), "bv": (inner,), "wo": (inner, D), "bo": (D,),
          "ln1_s": (D,), "ln1_b": (D,), "w1": (D, FF), "b1": (FF,),
          "w2": (FF, D), "b2": (D,), "ln2_s": (D,), "ln2_b": (D,)}
p = {k: (torch.randn(*s, generator=g, device="cuda") * 0.05).bfloat16()
     .requires_grad_() for k, s in shapes.items()}
chain = ["x_load", "qkv", "heads", "wo", "ln1", "w1", "w2", "ln2"]
bwd = {10: "ln2_bwd", 11: "d_z", 12: "d_u_product", 13: "b1_sums",
       14: "d_h1_product", 15: "xhat1_load", 16: "ln1_bwd", 17: "d_attn",
       18: "d_o_product", 19: "heads_bwd", 25: "dx_products"}
for B, kw, back in ((8, {}, False), (256, {}, False),
                    (1024, {"dropout_p": 0.25, "seed": 5}, False),
                    (1024, {"dropout_p": 0.25, "seed": 5}, True)):
    x = torch.randn(B, L, D, generator=g, device="cuda").bfloat16()
    x.requires_grad_()
    go = torch.randn(B, L, D, generator=g, device="cuda").bfloat16()
    for _ in range(2):
        out = fused_attention_layer(x, p, H, **kw)
        if back:
            torch.autograd.grad(out, [x], go)
    out = fused_attention_layer(x, p, H, **kw)
    torch.cuda.synchronize()
    (lib.eid_clock_zero_bwd if back else lib.eid_clock_zero)()
    if back:
        torch.autograd.grad(out, [x], go)
    else:
        fused_attention_layer(x, p, H, **kw)
    torch.cuda.synchronize()
    buf = np.zeros(2048 * 32, np.int64)
    (lib.eid_clock_read_bwd if back else lib.eid_clock_read)(
        buf.ctypes.data, buf.size)
    t = buf.reshape(2048, 32)[:B]
    med = lambda a: float(np.median(a))
    row = {"card": torch.cuda.get_device_name(0), "B": B,
           "pass": "backward" if back else "forward",
           "dropout": "seed" if kw else "none",
           "chain": {n: med(t[:, i + 1] - t[:, i]) for i, n in enumerate(chain)},
           "chain_total": med(t[:, 8] - t[:, 0]),
           "product_loops": med(t[:, 28]), "epilogues": med(t[:, 29])}
    if back:
        ks = sorted(bwd)
        row["backward"] = {bwd[k]: med(t[:, n] - t[:, k])
                           for k, n in zip(ks, ks[1:] + [26])}
        row["total"] = med(t[:, 26] - t[:, 0])
    print(json.dumps(row), flush=True)
"""


def instrument(csrc: Path) -> None:
    tile = csrc / "attention_tile.cuh"
    s = tile.read_text()
    s = s.replace("using mma::bf16;\n", "using mma::bf16;\n" + _HEAD, 1)
    for anchor, new in TILE:
        if s.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in {tile.name}: "
                               f"{anchor[:60]!r}")
        s = s.replace(anchor, new)
    tile.write_text(s)
    bwd = csrc / "attention_bwd.cu"
    s = bwd.read_text()
    for anchor, k in BWD:
        if s.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in {bwd.name}: "
                               f"{anchor[:60]!r}")
        s = s.replace(anchor, f"  STAMP({k});\n" + anchor)
    end = """    dx[i] = __float2bfloat16(F[r * Wp + c]);
  }
}"""
    s = s.replace(end, end[:-2] + "  STAMP(26);\n}")
    bwd.write_text(s + _READER.format(tag="_bwd"))
    fwd = csrc / "attention_fwd.cu"
    fwd.write_text(fwd.read_text() + _READER.format(tag=""))


def main() -> int:
    if COPY.exists():
        shutil.rmtree(COPY)
    pkg = COPY / "eeg_image_decode_tpu_torch"
    shutil.copytree(ROOT / "eeg_image_decode_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    instrument(pkg / "csrc")
    return subprocess.run([sys.executable, "-c", _CHILD, str(COPY)]).returncode


if __name__ == "__main__":
    sys.exit(main())
