#!/usr/bin/env python3
"""Where the time of one retrieval request goes in the PyTorch/CUDA port.

    python3 scripts/profile_torch_serve.py [--batch 256] [--fused-projection]

Builds ``RetrievalService`` at full ATM-S width (bf16, seeded random
weights, a 200 × 1024 gallery) on the CUDA card and, for one bucket:

- times the request's three phases with CUDA events (median of 20): the
  host→device copy of the padded EEG, the model forward, and scoring plus
  top-k, beside the host clock around a whole ``top_k`` call;
- traces 10 ``top_k`` calls with ``torch.profiler`` and prints the device
  time per kernel name (summed over the calls), the device-busy time and
  the device's idle share of the traced wall time.

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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--fused-projection", action="store_true")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2
    from eeg_image_decode_tpu_torch.core.config import ATMSConfig
    from eeg_image_decode_tpu_torch.data.synthetic import (
        make_synthetic_retrieval_data,
    )
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.serve import RetrievalService

    cfg = ATMSConfig(fused_projection=True if args.fused_projection else "auto")
    model = build_encoder("atms", config=cfg, dtype=torch.bfloat16,
                          device="cuda", seed=SEED)
    train, test = make_synthetic_retrieval_data(
        n_classes=200, images_per_class=1, train_reps=2, seed=SEED,
        device="cpu")
    eeg = np.concatenate([test.eeg.numpy(), train.eeg.numpy()])[: args.batch]
    sids = np.ones(args.batch, np.int32)
    svc = RetrievalService(model, test.img_features.numpy(),
                           max_batch=args.batch, device="cuda")
    svc.warmup((cfg.n_channels, cfg.seq_len))
    dev = svc.device

    def ev():
        return torch.cuda.Event(enable_timing=True)

    phases = {"h2d_ms": [], "forward_ms": [], "score_topk_ms": [],
              "top_k_host_ms": []}
    with torch.inference_mode():
        for _ in range(20):
            e0, e1, e2, e3 = ev(), ev(), ev(), ev()
            e0.record()
            x = torch.from_numpy(eeg).to(dev)
            s = torch.from_numpy(sids).to(dev)
            e1.record()
            feats, scale = svc.model(x, s)
            e2.record()
            torch.topk(scale * (feats.float() @ svc.gallery.T), svc.k_cap)
            e3.record()
            e3.synchronize()
            phases["h2d_ms"].append(e0.elapsed_time(e1))
            phases["forward_ms"].append(e1.elapsed_time(e2))
            phases["score_topk_ms"].append(e2.elapsed_time(e3))
            t0 = time.perf_counter()
            svc.top_k(eeg, sids, k=5)
            phases["top_k_host_ms"].append((time.perf_counter() - t0) * 1e3)
    emit({"phase": "request_phases", "batch": args.batch,
          "fused_projection": args.fused_projection,
          "card": torch.cuda.get_device_name(0),
          **{k: float(np.median(v)) for k, v in phases.items()}})

    calls = 10
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            svc.top_k(eeg, sids, k=5)
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
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": "trace", "batch": args.batch, "calls": calls,
          "wall_ms_per_call": wall_ms / calls,
          "device_busy_ms_per_call": busy_us / 1e3 / calls,
          "device_idle_share": (1.0 - busy_us / 1e3 / wall_ms
                                if spans else None),
          "kernel_ms_per_call": {k: v / calls for k, v in top}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
