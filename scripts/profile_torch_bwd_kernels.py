#!/usr/bin/env python3
"""Where the time of the tensor-core ops goes, launch by launch.

    python3 scripts/profile_torch_bwd_kernels.py [--reps 20] [--dtype bfloat16]

    python3 scripts/profile_torch_bwd_kernels.py --ops attention

Runs the tsconv stage-1 backward (64,512 rows, T 250, 75 taps, 40 filters,
stride 5) and the projection head's backward (B 1024, 1440 -> 1024 -> 1024,
seed-mode dropout) of the PyTorch/CUDA port at the training shapes of
``chip_smoke.py``, each through ``torch.autograd.grad`` as a training step
runs it, then the two forwards: tsconv at B 1024 and B 256 (16,128 rows),
the head in seed mode at B 1024 and without dropout at B 256 and B 8 (the
serving buckets' largest and smallest); then the attention layer (ATM-S:
L 64, D 250, 4 heads of 62, FF 256): its backward in seed mode (p 0.25) at
B 1024, its seeded forward at B 1024 and its forward without dropout at
B 256 and B 8, and the plain versions of the backward and the seeded
forward. ``--ops`` picks the groups (tsconv, projection, attention). For
each it prints one JSON line:

- ``event_ms``: CUDA-event time per call (warm, median of ``--reps``), what
  ``chip_smoke.py`` reports as the kernel's time;
- ``host_ms``: host time per call with the device left to run behind (the
  cost of the wrapper and of enqueueing the launches);
- ``device_ms``: device time per call of every kernel name in a
  ``torch.profiler`` trace of ``--reps`` calls, their sum and the device's
  busy time;
- with ``--host-profile``, a cProfile listing of the calls' host side.

Needs a CUDA device.
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


def measure(torch, name: str, fn, reps: int,
            host_profile: bool = False) -> None:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels: dict[str, float] = {}
    spans = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = (kernels.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / reps)
            spans.append((e.time_range.start, e.time_range.end))
    busy_us, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    if host_profile:
        import cProfile
        import io
        import pstats

        pr = cProfile.Profile()
        pr.enable()
        for _ in range(reps):
            fn()
        pr.disable()
        torch.cuda.synchronize()
        buf = io.StringIO()
        pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(30)
        print(buf.getvalue(), flush=True)
    emit({"op": name, "card": torch.cuda.get_device_name(0), "reps": reps,
          "event_ms": float(np.median(times)), "host_ms": host_ms,
          "device_sum_ms": sum(kernels.values()),
          "device_busy_ms": busy_us / 1e3 / reps,
          "device_ms": {k[:100]: v for k, v in
                        sorted(kernels.items(), key=lambda kv: -kv[1])}})


def attention_ops(torch, dtype, randn, args) -> None:
    """The attention layer's kernels at the training and serving shapes,
    and the plain versions of the backward and the seeded forward."""
    from eeg_image_decode_tpu_torch.ops.attention import (
        PARAM_ORDER,
        attention_layer_backward_reference,
        attention_layer_reference,
        draw_keep_masks,
        fused_attention_layer,
    )

    B, L, D, H, FF = 1024, 64, 250, 4, 256
    inner = (D // H) * H
    shapes = {"wq": (D, inner), "bq": (inner,), "wk": (D, inner),
              "bk": (inner,), "wv": (D, inner), "bv": (inner,),
              "wo": (inner, D), "bo": (D,), "ln1_s": (D,), "ln1_b": (D,),
              "w1": (D, FF), "b1": (FF,), "w2": (FF, D), "b2": (D,),
              "ln2_s": (D,), "ln2_b": (D,)}
    p = {k: (randn(*s, scale=s[0] ** -0.5) if len(s) == 2
             else randn(*s, scale=0.1) + (1.0 if k.endswith("_s") else 0.0))
         .to(dtype).requires_grad_() for k, s in shapes.items()}
    x = randn(B, L, D).to(dtype).requires_grad_()
    gout = randn(B, L, D).to(dtype)
    seed = torch.tensor([SEED % (2**31 - 1)], dtype=torch.int32,
                        device="cuda")
    out = fused_attention_layer(x, p, H, dropout_p=0.25, seed=seed)
    inputs = [x, *[p[k] for k in PARAM_ORDER]]
    measure(torch, "attention_bwd",
            lambda: torch.autograd.grad(out, inputs, gout, retain_graph=True),
            args.reps, args.host_profile)
    del out
    drawn = draw_keep_masks(int(seed.item()), B, H, L, D, FF, 0.25,
                            device="cuda")
    with torch.no_grad():
        measure(torch, "attention_bwd_plain",
                lambda: attention_layer_backward_reference(
                    x, p, gout, H, masks=drawn), args.reps)
        measure(torch, "attention_fwd_seed_b1024",
                lambda: fused_attention_layer(x, p, H, dropout_p=0.25,
                                              seed=seed),
                args.reps, args.host_profile)
        measure(torch, "attention_fwd_seed_b1024_plain",
                lambda: attention_layer_reference(x, p, H, masks=drawn),
                args.reps)
        for b in (256, 8):
            xs = x[:b].contiguous()
            measure(torch, f"attention_fwd_b{b}",
                    lambda: fused_attention_layer(xs, p, H), args.reps,
                    args.host_profile)
            measure(torch, f"attention_fwd_b{b}_plain",
                    lambda: attention_layer_reference(xs, p, H), args.reps)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--host-profile", action="store_true",
                    help="also print a cProfile of the host side of the calls")
    ap.add_argument("--ops", default="tsconv,projection,attention",
                    help="comma list of op groups: tsconv, projection, "
                         "attention")
    args = ap.parse_args()
    ops = set(args.ops.split(","))

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_bwd_kernels: no CUDA device", file=sys.stderr)
        return 2
    from eeg_image_decode_tpu_torch.ops.projection import (
        PARAM_ORDER,
        fused_projection_head,
    )
    from eeg_image_decode_tpu_torch.ops.tsconv import (
        fold_pool_into_kernel,
        out_positions,
        tsconv_pool_fused,
    )

    dtype = getattr(torch, args.dtype)
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    B, C, T, K, F, pool, stride = 1024, 63, 250, 25, 40, 51, 5
    if "attention" in ops:
        attention_ops(torch, dtype, randn, args)
    if "tsconv" in ops:
        w = fold_pool_into_kernel(randn(K, F, scale=K ** -0.5), pool).to(dtype)
        P = out_positions(T, w.shape[0], stride)
        x = randn(B, C, T).to(dtype).requires_grad_()
        w = w.requires_grad_()
        gout = randn(B, C, P, F).to(dtype)
        out = tsconv_pool_fused(x, w, stride)
        measure(torch, "tsconv_bwd",
                lambda: torch.autograd.grad(out, [x, w], gout,
                                            retain_graph=True),
                args.reps, args.host_profile)
        del x, gout, out
        with torch.no_grad():
            for rows in (B, 256):
                xt = randn(rows, C, T).to(dtype)
                measure(torch, f"tsconv_fwd_b{rows}",
                        lambda: tsconv_pool_fused(xt, w, stride), args.reps,
                        args.host_profile)
    if "projection" in ops:
        d_in, d_out = 1440, 1024
        p = {"wi": randn(d_in, d_out, scale=d_in ** -0.5),
             "bi": randn(d_out, scale=0.1),
             "wr": randn(d_out, d_out, scale=d_out ** -0.5),
             "br": randn(d_out, scale=0.1),
             "ln_s": randn(d_out, scale=0.1) + 1.0,
             "ln_b": randn(d_out, scale=0.1)}
        p = {k: v.to(dtype).requires_grad_() for k, v in p.items()}
        xh = randn(B, d_in).to(dtype).requires_grad_()
        gh = randn(B, d_out)
        seed = torch.tensor([SEED % (2**31 - 1)], dtype=torch.int32,
                            device="cuda")
        outh = fused_projection_head(xh, p, None, 0.5, seed)
        inputs = [xh, *[p[k] for k in PARAM_ORDER]]
        measure(torch, "projection_bwd",
                lambda: torch.autograd.grad(outh, inputs, gh,
                                            retain_graph=True),
                args.reps, args.host_profile)
        del outh
        with torch.no_grad():
            measure(torch, "projection_fwd_seed_b1024",
                    lambda: fused_projection_head(xh, p, None, 0.5, seed),
                    args.reps, args.host_profile)
            for b in (256, 8):
                xs = xh[:b].contiguous()
                measure(torch, f"projection_fwd_b{b}",
                        lambda: fused_projection_head(xs, p), args.reps,
                        args.host_profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
