#!/usr/bin/env python3
"""Where the time of one training step of the diffusion prior and of the
low-level encoder goes in the PyTorch port.

    python3 scripts/profile_torch_prior_lowlevel.py [--model prior|lowlevel|both]
        [--steps 10]

Builds each model at full width (``PriorConfig()``: 9.7 M parameters, B
1024; ``LowLevelConfig()``: 143 M parameters, B 30; fp32, seeded random
data on the CUDA card), runs the trainer's own epoch function
(``PriorPipe.train_epoch`` / ``LowLevelTrainer.train_epoch``) and:

- times ``--steps`` steps with CUDA events, after 3 warm-up steps;
- traces as many steps with ``torch.profiler`` (CPU and CUDA) and prints
  the wall and device-busy ms per step, the device's idle share, the
  kernel launches per step, the device ms per step of the largest kernels
  and of the optimizer's ``multi_tensor_apply`` kernels, and the host ms
  per step of the largest operators by self CPU time;
- for the low-level encoder, each transposed convolution's forward and
  backward (CUDA events, B 30) under the trainer's cuDNN settings
  (``train/lowlevel.py::CUDNN_FLAGS``: deterministic algorithms) and under
  cuDNN's defaults, and whether two identical steps under the defaults
  give the same bits.

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


def trace(torch, run, n: int) -> dict:
    """``run()`` (n steps) under the profiler: per-step numbers."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels: dict[str, float] = {}
    spans, launches = [], 0
    for e in prof.events():
        # device kernels only: not the optimizer's user-annotation span
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            launches += 1
            kernels[e.name] = (kernels.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
            spans.append((e.time_range.start, e.time_range.end))
    busy_us, end = 0.0, -1.0
    for a, b in sorted(spans):  # union of device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    host = sorted(((a.key, a.self_cpu_time_total / 1e3 / n, a.count / n)
                   for a in prof.key_averages()),
                  key=lambda r: -r[1])[:12]
    return {"wall_ms_per_step": wall_ms / n,
            "device_busy_ms_per_step": busy_us / 1e3 / n,
            "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "launches_per_step": launches / n,
            "optimizer_kernels_ms_per_step": sum(
                v for k, v in kernels.items()
                if "multi_tensor_apply" in k) / n,
            "kernel_ms_per_step": {k[:100]: v / n for k, v in top},
            "host_self_ms_per_step": {k: [ms, calls]
                                      for k, ms, calls in host}}


def profile_prior(torch, steps: int) -> None:
    from eeg_image_decode_tpu_torch.core.config import PriorConfig
    from eeg_image_decode_tpu_torch.train.prior import PriorPipe

    cfg = PriorConfig()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    n = cfg.batch_size * (3 + 2 * steps)
    c = torch.randn((n, cfg.cond_dim), generator=g, device="cuda")
    h = torch.randn((n, cfg.embed_dim), generator=g, device="cuda")
    pipe = PriorPipe(cfg, device="cuda")
    pipe.init(total_steps=10 * (3 + 2 * steps))
    pipe.train_epoch(0, c[:3 * cfg.batch_size], h[:3 * cfg.batch_size],
                     cfg.batch_size)                              # warm-up
    part = slice(0, steps * cfg.batch_size)
    pipe.train_epoch(1, c[part], h[part], cfg.batch_size)
    step_ms = pipe.last_steps["step_ms"]
    emit({"model": "prior", "card": torch.cuda.get_device_name(0),
          "batch": cfg.batch_size, "steps": steps,
          "step_ms_p50": float(np.median(step_ms)), "step_ms": step_ms})
    emit({"model": "prior", "phase": "trace", **trace(
        torch, lambda: pipe.train_epoch(2, c[part], h[part], cfg.batch_size),
        steps)})


def profile_lowlevel(torch, steps: int) -> None:
    from eeg_image_decode_tpu_torch.core.config import LowLevelConfig
    from eeg_image_decode_tpu_torch.train.lowlevel import LowLevelTrainer

    cfg = LowLevelConfig()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    n = cfg.batch_size * steps
    eeg = torch.randn((n, cfg.n_channels, cfg.seq_len), generator=g,
                      device="cuda")
    lat = torch.randn((n, *cfg.latent_shape), generator=g, device="cuda")
    t = LowLevelTrainer(cfg, device="cuda")
    t.init(total_steps=10 * steps, steps_per_epoch=steps, seed=SEED % 1000)
    t.train_epoch(0, eeg[:3 * cfg.batch_size], lat[:3 * cfg.batch_size],
                  cfg.batch_size, 0)                              # warm-up
    t.train_epoch(1, eeg, lat, cfg.batch_size, 0)
    step_ms = t.last_steps["step_ms"]
    emit({"model": "lowlevel", "card": torch.cuda.get_device_name(0),
          "batch": cfg.batch_size, "steps": steps,
          "step_ms_p50": float(np.median(step_ms)), "step_ms": step_ms})
    emit({"model": "lowlevel", "phase": "trace", **trace(
        torch, lambda: t.train_epoch(2, eeg, lat, cfg.batch_size, 0),
        steps)})
    conv_layers(torch, t, eeg[:cfg.batch_size])
    repeat_bits(torch, t, eeg[:cfg.batch_size], lat[:cfg.batch_size])


def _ms(torch, fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def conv_layers(torch, trainer, x) -> None:
    """Forward and forward + backward ms of each ConvTranspose stage at its
    training input, under the trainer's cuDNN flags and cuDNN's defaults."""
    import torch.nn.functional as F

    from eeg_image_decode_tpu_torch.train.lowlevel import CUDNN_FLAGS

    m = trainer.model
    h = m.subject_linear(x).reshape(x.shape[0], -1, 1, 1)
    rows = []
    for i in range(len(m.stage_channels)):
        up = getattr(m, f"up_{i}")
        inp = h.detach().requires_grad_(True)

        def fwd():
            return F.conv_transpose2d(inp, up.kernel, up.bias, stride=2,
                                      padding=1)

        out = fwd()
        g = torch.ones_like(out)

        def fwd_bwd():
            torch.autograd.grad(fwd(), (inp, up.kernel, up.bias), g)

        row = {"stage": i, "in": list(inp.shape), "out": list(out.shape)}
        for name, flags in (("trainer", CUDNN_FLAGS),
                            ("cudnn_default", dict(enabled=True,
                                                   benchmark=False,
                                                   deterministic=False,
                                                   allow_tf32=False))):
            with torch.backends.cudnn.flags(**flags):
                row[f"{name}_fwd_ms"] = _ms(torch, fwd)
                row[f"{name}_fwd_bwd_ms"] = _ms(torch, fwd_bwd)
        rows.append(row)
        with torch.no_grad():
            h = torch.relu(getattr(m, f"bn_{i}")(out.detach()))
    emit({"model": "lowlevel", "phase": "conv_transpose_layers",
          "card": torch.cuda.get_device_name(0), "layers": rows})


def repeat_bits(torch, trainer, x, y) -> None:
    """Two identical steps' gradients under cuDNN's default (not
    deterministic) algorithms: equal bits or not."""
    m = trainer.model
    grads = []
    for _ in range(2):
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            m.zero_grad(set_to_none=True)
            torch.mean(torch.abs(m(x, train=False) - y)).backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    same = all(torch.equal(a, b) for a, b in zip(*grads))
    emit({"model": "lowlevel", "phase": "default_algorithms_repeat",
          "gradients_bit_equal": same})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["prior", "lowlevel", "both"],
                    default="both")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_prior_lowlevel: no CUDA device", file=sys.stderr)
        return 2
    if args.model in ("prior", "both"):
        profile_prior(torch, args.steps)
    if args.model in ("lowlevel", "both"):
        profile_lowlevel(torch, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
