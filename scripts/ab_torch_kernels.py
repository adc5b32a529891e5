#!/usr/bin/env python3
"""Time the port's CUDA kernels of several checkouts in one run (an A/B).

    python3 scripts/ab_torch_kernels.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout of this repository (unpack the
parent with ``git archive`` into ``_checkout/``, which ``.gitignore``
lists). The roots run in the order given, each in its own process, which
builds that checkout's kernels and times the attention, tsconv and
projection kernels at the serving shapes of ``chip_smoke.py`` (B 256, full
ATM-S width, bf16 and fp32; CUDA events, warm, median of 50 launches)
beside their max |Δ| from the plain version and a SHA-256 of the output's
bytes (two checkouts whose digests agree compute that kernel bit for bit
alike: the inputs come from one seed), then, where the checkout has
them, the training kernels at B 1024 (``chip_smoke.check_training_kernels``:
its checks and rows, median of 25). Compare two versions only within one
run: interleave them, as above. Prints one JSON line per (root, kernel,
dtype).
"""

from __future__ import annotations

import json
import subprocess
import sys

_CHILD = r"""
import hashlib, json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from eeg_image_decode_tpu_torch.ops import _build
from eeg_image_decode_tpu_torch.utils.device import resolve_device
resolve_device("cuda")
_build.lib()
for name, (_, _, make) in cs.kernel_cases(torch).items():
    for dt in (torch.bfloat16, torch.float32):
        kern, plain, _, _, _ = make(dt)
        out = kern()
        err = (out.float() - plain().float()).abs().max().item()
        digest = hashlib.sha256(
            out.contiguous().view(torch.uint8).cpu().numpy().tobytes()
        ).hexdigest()[:16]
        print(json.dumps({"root": sys.argv[1], "name": name,
                          "dtype": str(dt).split(".")[-1], "max_abs_err": err,
                          "sha256": digest,
                          "ms": cs.cuda_ms(torch, kern, 50)}), flush=True)
if hasattr(cs, "check_training_kernels"):
    print(json.dumps({"root": sys.argv[1], "training_kernels": True}),
          flush=True)
    cs.check_training_kernels(torch)
"""


def main(roots: list[str]) -> int:
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots:
        subprocess.run([sys.executable, "-c", _CHILD, root], check=True)
    print(json.dumps({"order": roots}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
