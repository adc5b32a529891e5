#!/usr/bin/env python3
"""Where the time of one reconstruction request goes in the PyTorch port.

    python3 scripts/profile_torch_reconstruct.py [--batch 16] [--reps 3]

Builds ``ReconstructionService`` at full width: ATM-S (bf16, seeded random
weights, through the attention and tsconv forward kernels), the diffusion
prior (``PriorConfig()``, fp32, random weights; 50 steps at guidance 5.0),
and the SDXL-turbo UNet with the IP-Adapter and the SDXL VAE in bf16
(``Generator4Embeds.init_random``; 4 Euler-ancestral steps, 512 px); one
chunk of ``--batch`` rows, the service's ``max_batch``. Then:

- each stage (the encoder, the prior's sampling, the UNet steps, the VAE
  decode) traced alone with ``torch.profiler`` over ``--reps`` calls: wall
  and device-busy ms, the device's idle share, launches, the largest
  kernels and the largest host operators by self time;
- the request from the thread that warmed the service up against the same
  request from fresh threads (PyTorch keeps cuDNN's execution plans per
  thread);
- the same five rows at offset 0 and at offset 3 of a chunk: each stage's
  largest difference, fed the same input (which stage's output depends on
  a row's position in the batch).

Prints one JSON line per measurement. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from profile_torch_prior_lowlevel import trace  # noqa: E402  (scripts/)

SEED = 20200220


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import subprocess

    from eeg_image_decode_tpu_torch.core.config import (
        ATMSConfig,
        PriorConfig,
    )
    from eeg_image_decode_tpu_torch.gen.sdxl import (
        Generator4Embeds,
        GeneratorConfig,
    )
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.serve import (
        PRIOR_DOMAIN,
        SDXL_DOMAIN,
        ReconstructionService,
        _row_keys,
    )
    from eeg_image_decode_tpu_torch.train.prior import PriorPipe

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build()
    _build.lib()
    b, dev = args.batch, "cuda"
    encoder = build_encoder("atms", config=ATMSConfig(), dtype=torch.bfloat16,
                            device=dev, seed=SEED)
    prior = PriorPipe(PriorConfig(), device=dev)
    prior.init(total_steps=1, seed=SEED % 1000)
    gen = Generator4Embeds(GeneratorConfig(), device=dev)
    gen.init_random(seed=SEED)
    svc = ReconstructionService(encoder, prior, gen, max_batch=b, device=dev)
    eeg = np.random.default_rng(SEED).normal(size=(b, 63, 250)).astype(
        np.float32)
    sids = np.zeros(b, np.int32)
    svc.warmup((63, 250))
    svc.reconstruct(eeg, sids)

    seeds = np.stack([np.full(b, 7, np.uint32),
                      np.arange(b, dtype=np.uint32)], axis=1)
    with torch.inference_mode():
        x = torch.from_numpy(eeg).to(dev)
        s = torch.from_numpy(sids).to(dev)
        feats = encoder(x, s)[0].float()
        keys0 = torch.from_numpy(_row_keys(seeds, PRIOR_DOMAIN)).to(dev)
        keys1 = torch.from_numpy(_row_keys(seeds, SDXL_DOMAIN)).to(dev)
        embeds = prior.generate(feats, row_keys=keys0)
        latents = gen.generate(embeds, decode=False, row_keys=keys1)
        stages = {
            "encoder": lambda: encoder(x, s),
            "prior": lambda: prior.generate(feats, row_keys=keys0),
            "unet_steps": lambda: gen.generate(embeds, decode=False,
                                               row_keys=keys1),
            "vae_decode": lambda: gen.decode(latents),
        }
        for name, fn in stages.items():
            fn()

            def run(fn=fn):
                for _ in range(args.reps):
                    fn()

            row = trace(torch, run, args.reps)
            row.pop("optimizer_kernels_ms_per_step")
            emit({"phase": "stage", "stage": name, "card": card,
                  "batch": b, **row})

    # the warmed-up thread against fresh threads
    times = {}

    def request(key):
        t0 = time.perf_counter()
        svc.reconstruct(eeg, sids)
        times.setdefault(key, []).append(time.perf_counter() - t0)

    for _ in range(args.reps):
        request("warm_thread_s")
        th = threading.Thread(target=request, args=("fresh_thread_s",))
        th.start()
        th.join()
    emit({"phase": "threads", "card": card, "batch": b, **times})

    # the same rows at offset 0 and at offset 3 of a chunk, stage by stage
    rows, off = 5, 3
    with torch.inference_mode():
        def place(t, at):
            out = torch.zeros_like(t)
            out[at:at + rows] = t[:rows]
            return out

        def compare(fn, inputs):
            a = fn(*[place(t, 0) for t in inputs])
            c = fn(*[place(t, off) for t in inputs])
            return float((a[:rows].float()
                          - c[off:off + rows].float()).abs().max())

        tt = torch.full((b,), 999, dtype=torch.int64, device=dev)
        ctx = torch.zeros(b, 77, 2048, device=dev)
        tids = torch.tensor([[512.0, 512, 0, 0, 512, 512]] * b, device=dev)
        noise = torch.randn(b, 4, 64, 64, device=dev)
        diffs = {
            "encoder_features": compare(
                lambda xx: encoder(xx, s)[0], [x]),
            "prior_sample": compare(
                lambda f, k: prior.generate(f, row_keys=k), [feats, keys0]),
            "unet_one_call": compare(
                lambda z, e: gen.unet(z, tt, ctx, None, tids, e),
                [noise, embeds]),
            "unet_steps": compare(
                lambda e, k: gen.generate(e, decode=False, row_keys=k),
                [embeds, keys1]),
            "vae_decode": compare(gen.decode, [latents]),
        }
    emit({"phase": "batch_position", "card": card, "rows": rows,
          "offset": off, "max_abs_diff": diffs})
    return 0


if __name__ == "__main__":
    sys.exit(main())
