#!/usr/bin/env python3
"""Where the time of one training step goes in the PyTorch/CUDA port.

    python3 scripts/profile_torch_train.py [--steps 10] \\
        [--fused-projection] [--joint] [--encoder atms|nice,eegnetv4,...]

Builds each ``--encoder`` of the registry (default ATM-S) at full width
(bf16, seeded random weights, dropout on; ATM-S at ``ATMSConfig()``, the
others at their defaults; ``--fused-projection``: ATM-S's head through its
CUDA kernels; ``--joint``: ATM-S's per-subject value embeddings, the rows
given seeded subject ids over 0..9) and one subject's synthetic split on
the CUDA card (66,160 × 63 × 250), runs the trainer's epoch function
(``train/contrastive.py::make_epoch_fn``) at batch 1024 and:

- times ``--steps`` steps with CUDA events, after 3 warm-up steps;
- traces as many steps with ``torch.profiler`` and prints the device time
  per step of each kernel name, of the port's own kernels together, of
  cuBLAS products and of everything else, the device-busy time and the
  device's idle share of the traced wall time, and the kernel launches
  per step.

Prints one JSON line per measurement. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SEED = 20200220
#: substrings of the port's kernel names (csrc/*.cu)
OWN = ("attention_fwd_", "attention_bwd_", "attention_pack_kernel",
       "attention_dw_", "atb_partial_kernel", "sum_rows_kernel",
       "tsconv_fwd_", "tsconv_bwd_", "projection_fwd_", "projection_chain_",
       "projection_bwd_")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def group(name: str) -> str:
    if any(k in name for k in OWN):
        return "port_kernels"
    if any(k in name.lower() for k in ("gemm", "xmma", "cutlass", "nvjet")):
        return "cublas_products"
    return "other"


def profile_encoder(args, name: str, cfg, data, perm) -> None:
    """CUDA-event step times, then a traced window, of encoder ``name``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from eeg_image_decode_tpu_torch.core.config import ATMSConfig
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.train.contrastive import (
        create_train_state,
        make_epoch_fn,
    )

    kw = {}
    if name == "atms":
        kw["config"] = ATMSConfig(
            fused_projection=True if args.fused_projection else "auto",
            joint_train=args.joint)
    model = build_encoder(name, dtype=torch.bfloat16, device="cuda",
                          seed=SEED, **kw)
    state = create_train_state(model, cfg)
    epoch_fn = make_epoch_fn(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n = args.steps

    epoch_fn(state, data, perm[:3], gen)  # warm-up
    out = epoch_fn(state, data, perm[3:3 + n], gen)
    emit({"phase": "steps", "encoder": name,
          "card": torch.cuda.get_device_name(0),
          "fused_projection": args.fused_projection, "joint": args.joint,
          "batch": cfg.batch_size, "steps": n,
          "step_ms_p50": float(np.median(out["step_ms"])),
          "step_ms": out["step_ms"]})

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epoch_fn(state, data, perm[3 + n:3 + 2 * n], gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels: dict[str, float] = {}
    spans = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = (kernels.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
            spans.append((e.time_range.start, e.time_range.end))
    busy_us, end = 0.0, -1.0
    for a, b in sorted(spans):  # union of device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    groups: dict[str, float] = {}
    for k, v in kernels.items():
        groups[group(k)] = groups.get(group(k), 0.0) + v / n
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    emit({"phase": "trace", "encoder": name, "steps": n,
          "wall_ms_per_step": wall_ms / n,
          "device_busy_ms_per_step": busy_us / 1e3 / n,
          "device_idle_share": (1.0 - busy_us / 1e3 / wall_ms
                                if spans else None),
          "launches_per_step": len(spans) / n,
          "group_ms_per_step": groups,
          "kernel_ms_per_step": {k[:120]: v / n for k, v in top}})
    del state, model, epoch_fn
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--fused-projection", action="store_true")
    ap.add_argument("--joint", action="store_true")
    ap.add_argument("--encoder", default="atms",
                    help="comma-separated registry names")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    from eeg_image_decode_tpu_torch.core.config import ContrastiveTrainConfig
    from eeg_image_decode_tpu_torch.data.synthetic import (
        make_synthetic_retrieval_data,
    )
    from eeg_image_decode_tpu_torch.train.contrastive import (
        DeviceData,
        epoch_permutation,
    )

    cfg = ContrastiveTrainConfig()
    train, _ = make_synthetic_retrieval_data(n_classes=1654,
                                             n_test_classes=200, seed=SEED,
                                             device="cuda")
    if args.joint:
        train.subject_ids = torch.randint(
            0, 10, (train.n,), device="cuda", dtype=torch.int32,
            generator=torch.Generator(device="cuda").manual_seed(SEED + 30))
    data = DeviceData.from_host(train, "cuda")
    perm = torch.as_tensor(epoch_permutation(train.n, cfg.batch_size,
                                             cfg.seed, 0), device="cuda")
    for name in args.encoder.split(","):
        profile_encoder(args, name, cfg, data, perm)
    return 0


if __name__ == "__main__":
    sys.exit(main())
