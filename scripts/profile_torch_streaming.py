#!/usr/bin/env python3
"""Does host streaming cost the retrieval trainer anything, with and
without the profiler watching?

    python3 scripts/profile_torch_streaming.py [--epochs 3] [--threads 8,2]
        [--gathers pool,index_select] [--rounds 1]

Draws one subject's synthetic split on the CUDA card (66,160 × 63 × 250),
copies it to the host and trains ATM-S (``ATMSConfig()``, bf16, B 1024,
one seed) resident, streamed from an fp32 host copy and streamed from a
bf16 one (``ContrastiveTrainer(streaming=...)``). For each mode, after a
warm-up epoch:

- ``--epochs`` untraced epochs: the host's wall-clock per step of each
  (``train_epoch`` ends in a device read, so it is synced), the
  CUDA-event step p50, and when streamed the loader's mean gather ms a
  batch and the mean ms the training thread waited for a batch
  (``PrefetchLoader.gather_s`` / ``wait_s``);
- one epoch under ``torch.profiler`` (CUDA activity): wall per step, the
  device's busy ms per step (the union of its kernel and copy intervals)
  and its idle share.

The device's busy time is the same work in all three modes, so the
untraced idle share is estimated as 1 − busy / untraced wall. A streamed
mode's untraced epochs run once for each gather route of ``--gathers``:
``pool`` (the shared native pool, cores − 2 threads), ``pool:N`` (a
private pool of N threads) and ``index_select`` (the plain gather, on
PyTorch's intra-op threads); with ``--rounds 2`` or more the routes take
turns, in order and then reversed, so a drift of the host falls on all
alike. For the streamed fp32 mode they are repeated at each intra-op
thread count of ``--threads`` (PyTorch's CPU threads, beside the launching
thread). The traced epoch takes the trainer's own loader (the shared
pool). One JSON line per measurement. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SEED = 20200220


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def busy_ms(torch, prof) -> float:
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for a, b in spans:  # the union of device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def gather_route(route: str) -> dict:
    """``--gathers`` entry → ``PrefetchLoader`` keywords."""
    if route == "pool":
        return {}
    if route.startswith("pool:"):
        return {"gather_threads": int(route[5:])}
    if route == "index_select":
        return {"gather": "index_select"}
    raise ValueError(f"gather route {route!r}: pool, pool:N or index_select")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from eeg_image_decode_tpu_torch.core.config import (
        ATMSConfig,
        ContrastiveTrainConfig,
    )
    from eeg_image_decode_tpu_torch.data.synthetic import (
        make_synthetic_retrieval_data,
    )
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.train.contrastive import (
        ContrastiveTrainer,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--threads", default="8,2")
    ap.add_argument("--gathers", default="pool,index_select")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    routes = args.gathers.split(",")
    for route in routes:
        gather_route(route)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    train, test = make_synthetic_retrieval_data(
        n_classes=1654, n_test_classes=200, seed=SEED, device="cuda")
    train = dataclasses.replace(train, **{
        f: getattr(train, f).cpu() for f in (
            "eeg", "labels", "subject_ids", "img_idx", "text_idx",
            "img_features", "text_features")})
    default_threads = torch.get_num_threads()
    for mode, streaming, host_dtype in (("resident", False, None),
                                        ("streamed_fp32", True, None),
                                        ("streamed_bf16", True, "bfloat16")):
        model = build_encoder("atms", config=ATMSConfig(),
                              dtype=torch.bfloat16, device="cuda", seed=SEED)
        trainer = ContrastiveTrainer(
            model, ContrastiveTrainConfig(host_dtype=host_dtype), train,
            test, device="cuda", streaming=streaming)
        trainer.train_epoch(0)
        n = len(trainer.last_steps["step_loss"])
        emit({"phase": "epoch0", "card": card, "mode": mode,
              "event_p50_ms": float(np.median(
                  trainer.last_steps["step_ms"][3:]))})
        epoch = 1
        threads = ([int(t) for t in args.threads.split(",")]
                   if mode == "streamed_fp32" else [default_threads])
        runs = {}
        for t in threads:
            torch.set_num_threads(t)
            order = []
            for r in range(args.rounds if streaming else 1):
                order += routes[::-1] if r % 2 else routes
            for route in (order if streaming else [None]):
                if streaming:
                    trainer.loader = trainer.loader.rerouted(
                        **gather_route(route))
                walls, p50s, gather, wait = [], [], [], []
                for _ in range(args.epochs):
                    t0 = time.perf_counter()
                    trainer.train_epoch(epoch)
                    walls.append((time.perf_counter() - t0) * 1e3 / n)
                    p50s.append(float(np.median(
                        trainer.last_steps["step_ms"][3:])))
                    if streaming:
                        gather.append(float(np.mean(trainer.loader.gather_s))
                                      * 1e3)
                        wait.append(float(np.mean(trainer.loader.wait_s))
                                    * 1e3)
                    epoch += 1
                runs.setdefault((t, route), []).extend(walls)
                emit({"phase": "untraced", "card": card, "mode": mode,
                      "intra_op_threads": t, "gather": route,
                      "pool_threads": (trainer.loader.pool.n_threads
                                       if streaming and trainer.loader.pool
                                       else None),
                      "wall_ms_per_step": walls, "event_p50_ms": p50s,
                      "gather_ms": gather, "wait_ms": wait})
        if streaming:  # the traced epoch: the trainer's own route
            trainer.loader = trainer.loader.rerouted()
        torch.set_num_threads(default_threads)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_epoch(epoch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        busy = busy_ms(torch, prof) / n
        emit({"phase": "traced", "card": card, "mode": mode,
              "wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
              "device_idle_share": 1.0 - busy / wall,
              "untraced_idle_share_estimate": {
                  f"{t}-{route}": [1.0 - busy / w for w in walls]
                  for (t, route), walls in runs.items()}})
        trainer.close()
        del trainer, model, prof
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
