#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``eeg_image_decode_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, the build of every CUDA kernel from ``csrc/`` with its time,
   and how many tensor-core instructions (HMMA/HGMMA) ``cuobjdump -sass``
   finds in the bfloat16 kernels of the attention forward, backward (its
   rows kernel and its dW products), the tsconv forward and backward and
   the projection head's chain and backward: none is a failure.
2. Each kernel against its plain PyTorch version on the same inputs, in
   bfloat16 and float32, with the tolerance stated, and run twice, bit for
   bit: the three forward kernels at the serving shapes (B = 256; the tsconv
   and projection forwards also once, untimed, at ragged shapes: tsconv at
   37 rows and T 253 and at one position, the head at B 1 and B 37 in its
   three modes), and the training kernels at the training shapes (B = 1024,
   full ATM-S width): the attention forward in mask mode and in seed mode
   (the seed-mode forward must equal the mask-mode forward fed the plain
   Philox draw ``draw_keep_masks``, bit for bit, and in fp32 so must the
   backward), the attention backward (dx and all 16 gradients), the tsconv
   backward (dx and dw̃; also once, untimed, at 37 rows and T 253, no
   multiples of its tiles) and the tsconv forward, each backward through
   ``torch.autograd.grad`` as a training step runs it; every backward twice,
   bit for bit. Every row names the design its dtype took (``mma_bf16`` on
   the tensor cores, ``fma_fp32`` in full float32) and, in bfloat16, the
   first version's time and the device time of the op and of its library
   yardstick, or of its plain version where no library call computes the
   function (the attention layer), from a ``torch.profiler`` trace (the
   event times of short ops are mostly the host's). Per kernel: its time,
   the plain version's, a library yardstick's where one PyTorch call
   computes the same function (CUDA events, warm, median of 25 launches),
   and its bound, the least time the card could take for the same work
   (bytes over 3.35 TB/s or operations over the dtype's peak, whichever is
   larger).
3. The serving path at full width (``ATMSConfig()``, bf16, max_batch 256,
   seeded random weights, a 200 × 1024 L2-normalised gallery): the port's
   ``EEGDecodeServer`` on a free port answers ``/v1/retrieve`` requests of 1,
   8, 37 and 256 rows (npz bodies, k = 5, 64, 200, 5) and one JSON request;
   every answer must equal ``RetrievalService.top_k`` called directly, the
   launch counts (set to 0 just before the requests, read just after) must
   show every kernel of the path, and the top-5 must agree on ≥ 99% of 256
   rows with the same service whose kernels are replaced by their plain
   versions. Then requests/s and p50 latency per bucket. It runs twice:
   with the default (exact-erf) projection head, which launches the
   attention and tsconv kernels, and with ``fused_projection=True``, which
   launches all three.
   Phase 2 also holds the projection head's training kernels at B = 1024:
   the forward in mask mode and in seed mode (p = 0.5; the seeded forward
   bit-equal to mask mode fed ``draw_keep_mask``, the kept fraction), and
   the backward (dx and the six gradients) through ``torch.autograd.grad``,
   twice, bit for bit, in fp32 bit-equal to mask mode on the plain draw;
   their library yardstick is two matmuls + ``F.gelu(tanh)`` +
   ``F.dropout`` + ``F.layer_norm`` and autograd of that chain.
4. The training path at full width: one subject's split drawn on the card
   from a seed (``make_synthetic_retrieval_data``: 1654 classes × 10 images
   × 4 repetitions = 66,160 × 63 × 250 fp32, plus 200 test classes), then
   ``ContrastiveTrainer`` at ``ATMSConfig()``, batch 1024, bf16, dropout on,
   for one epoch (64 steps) and ``evaluate()``. The launch counts (set to 0
   before the epoch and before the evaluation) must show the seeded
   attention forward, the attention backward and both tsconv kernels once
   per step; the loss must be finite and the mean of the last 8 steps below
   that of the first 8. One step's gradients through the kernels are held
   against the same step through the plain versions (same batch, the seven
   dropout sites pinned to the same masks). Then the step time (p50 of
   per-step CUDA-event times, the first 3 steps left out), samples/s, the
   epoch and evaluation seconds and the peak device memory.
5. The fused-head joint path at full width: the same split with seeded
   subject ids over 0..9, ``ATMSConfig(fused_projection=True,
   joint_train=True)``, a ``Checkpointer`` in a temporary directory.
   ``fit(1)``: the launch counts must show all six training kernels once
   per step (the seeded projection forward and the projection backward
   among them) and the mode-0 projection forward in the evaluation; the
   loss finite and falling; a checkpoint saved. A fresh model and trainer
   ``resume()`` from it and run epoch 1, whose per-step losses are held
   against epoch 1 of the uninterrupted run (|Δ| ≤ 0.05, and whether they
   are bit-equal). One step's gradients through the kernels against the
   plain versions, in seed mode with the same generator seed on both sides
   (the kernels draw in-kernel, the plain versions draw the same bits with
   ``draw_keep_masks`` / ``draw_keep_mask``). Then the step p50 beside
   phase 4's.
6. The CLI: a small THINGS-EEG-shaped tree (two subjects, 30 train classes,
   20 test concepts) and its feature file written to a temporary directory;
   ``cli train-retrieval`` for two epochs at full model width on the card,
   ``--resume-dir`` for a third, then ``cli evaluate`` on the run
   directory, whose row must equal the trainer's last evaluation. Then
   ``cli export-checkpoint`` on that run; the ``.pth`` loads back through
   ``utils/convert.py::convert_atms_state_dict`` bit-equal to the restored
   run, and serves the same top-5 on the tree's test EEG as ``cli
   serve``'s service of the run.
7. ``cli features`` at the published OpenCLIP ViT-H/14 widths in bf16
   (vision 32 × 1280, text 24 × 1024) from seeded random weights, written
   as the ``--clip-params`` pickle and read back: a 200-concept
   THINGS-layout test tree, one 500 × 500 JPEG per concept, the 49,408-id
   stand-in vocabulary, ``--batch-size 20``. The cache must have the name
   ``clip_cache_path`` gives; its (200, 1024) image and text features must
   be finite and unit-norm, and hold the port's fp32 towers' features on
   the first 20 images and prompts at per-row cosine ≥ 0.99. Then the
   vision tower's rate on device tensors at batch 20 and 256 and its
   largest kernels at batch 20, the host decode ms per image beside the
   device side's, the pickle's write seconds, the command's seconds and
   its peak device memory. No TPU kernel lies on this path (the JAX
   towers are plain XLA), so it adds no row to the kernels line.
8. One JSON line listing the kernels, then the result line
   ``{"ok": true, "device": {...}}`` last. The Philox mask draw is a device
   function inside the seeded forwards and the backwards, not a launch of
   its own, so it has no row there: the bit-equalities of phase 2 hold it.
   The mask-mode forwards are reached through the ops only (a pinned mask
   in the model routes around the fused head), so they are reported in
   phase 2 and not in that line.

Any failure raises before the result line, and the exit code is not 0.
Without a CUDA device it exits with 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from contextlib import ExitStack
from unittest import mock

import numpy as np

SEED = 20200220
BATCH = 256          # serving
TRAIN_BATCH = 1024   # training (ContrastiveTrainConfig().batch_size)
REPS = 25
#: H100 SXM published peaks (NVIDIA data sheet, dense), at a 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = REPS) -> float:
    """Median of ``reps`` warm launches, each between two CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(torch, fn, reps: int = 10) -> float:
    """Device time per call: the sum of the kernels' durations in a
    ``torch.profiler`` trace of ``reps`` warm calls. Unlike :func:`cuda_ms`
    it leaves out the host's time to reach the first launch, which for a
    sub-millisecond op through ``torch.autograd.grad`` is most of the event
    time and moves with the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / 1e3 / reps


def top_kernels(torch, fn, n: int = 8) -> dict:
    """Device ms per call of the ``n`` kernels that take the most of one
    warm call in a ``torch.profiler`` trace, by kernel name, and of all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:n])
    return {"all": sum(by_name.values()), **{k[:80]: v for k, v in top.items()}}


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


# ——— phase 2: each kernel against its plain version ———


def kernel_cases(torch):
    """name → (replaces, source, make(dtype) → (kernel fn, plain fn,
    library fn or None, flops, bytes))."""
    from eeg_image_decode_tpu_torch.ops.attention import (
        PARAM_ORDER as ATTN_PARAMS,
        attention_layer_reference,
        fused_attention_layer,
    )
    from eeg_image_decode_tpu_torch.ops.projection import (
        fused_projection_head,
        projection_head_reference,
    )
    from eeg_image_decode_tpu_torch.ops.tsconv import (
        fold_pool_into_kernel,
        out_positions,
        tsconv_pool_fused,
        tsconv_pool_reference,
    )
    import torch.nn.functional as F

    dev = "cuda"

    def randn(g, *shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device=dev) * scale + shift

    def attention(dtype):
        g = torch.Generator(device=dev).manual_seed(SEED)
        L, D, H, FF = 64, 250, 4, 256
        inner = (D // H) * H
        shapes = {"wq": (D, inner), "bq": (inner,), "wk": (D, inner),
                  "bk": (inner,), "wv": (D, inner), "bv": (inner,),
                  "wo": (inner, D), "bo": (D,), "ln1_s": (D,), "ln1_b": (D,),
                  "w1": (D, FF), "b1": (FF,), "w2": (FF, D), "b2": (D,),
                  "ln2_s": (D,), "ln2_b": (D,)}
        p = {}
        for k in ATTN_PARAMS:
            s = shapes[k]
            if len(s) == 2:
                p[k] = randn(g, *s, scale=s[0] ** -0.5)
            elif k.endswith("_s"):
                p[k] = randn(g, *s, scale=0.1, shift=1.0)
            else:
                p[k] = randn(g, *s, scale=0.1)
        p = {k: v.to(dtype) for k, v in p.items()}
        x = randn(g, BATCH, L, D).to(dtype)
        sz = x.element_size()
        hd = inner // H
        flops = BATCH * 2 * L * (3 * D * inner + 2 * H * L * hd
                                 + inner * D + 2 * D * FF)
        nbytes = 2 * x.numel() * sz + sum(v.numel() for v in p.values()) * sz
        return (lambda: fused_attention_layer(x, p, H),
                lambda: attention_layer_reference(x, p, H),
                None, flops, nbytes)

    def tsconv(dtype):
        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        C, T, K, Fn, pool, stride = 63, 250, 25, 40, 51, 5
        w_tilde = fold_pool_into_kernel(randn(g, K, Fn, scale=K ** -0.5),
                                        pool).to(dtype)
        x = randn(g, BATCH, C, T).to(dtype)
        M = w_tilde.shape[0]
        P = out_positions(T, M, stride)
        # the JAX TPU default: w~ expanded to a dense (T, P*F) operand,
        # the stage as one matmul (ops/tsconv.py::expand_folded_kernel)
        m = torch.arange(T, device=dev)[:, None] - torch.arange(
            P, device=dev)[None, :] * stride
        valid = (m >= 0) & (m < M)
        e = torch.where(valid[..., None], w_tilde[m.clamp(0, M - 1)],
                        torch.zeros((), dtype=dtype, device=dev))
        e = e.reshape(T, P * Fn)
        x2 = x.reshape(BATCH * C, T)
        sz = x.element_size()
        flops = 2 * BATCH * C * P * M * Fn
        nbytes = (x.numel() + w_tilde.numel() + BATCH * C * P * Fn) * sz
        return (lambda: tsconv_pool_fused(x, w_tilde, stride),
                lambda: tsconv_pool_reference(x, w_tilde, stride),
                lambda: torch.matmul(x2, e), flops, nbytes)

    def projection(dtype):
        g = torch.Generator(device=dev).manual_seed(SEED + 2)
        d_in, d_out = 1440, 1024
        p = {"wi": randn(g, d_in, d_out, scale=d_in ** -0.5),
             "bi": randn(g, d_out, scale=0.1),
             "wr": randn(g, d_out, d_out, scale=d_out ** -0.5),
             "br": randn(g, d_out, scale=0.1),
             "ln_s": randn(g, d_out, scale=0.1, shift=1.0),
             "ln_b": randn(g, d_out, scale=0.1)}
        p = {k: v.to(dtype) for k, v in p.items()}
        x = randn(g, BATCH, d_in).to(dtype)
        sz = x.element_size()
        flops = 2 * BATCH * (d_in * d_out + d_out * d_out)
        nbytes = (x.numel() + sum(v.numel() for v in p.values())) * sz \
            + BATCH * d_out * 4

        def library():
            a = torch.matmul(x, p["wi"]) + p["bi"]
            z = torch.matmul(F.gelu(a, approximate="tanh"), p["wr"]) + p["br"]
            return F.layer_norm(a + z, (d_out,), p["ln_s"], p["ln_b"], 1e-6)

        return (lambda: fused_projection_head(x, p),
                lambda: projection_head_reference(x, p),
                library, flops, nbytes)

    return {
        "attention_fwd": ("eeg_image_decode_tpu/ops/attention.py:136",
                          "eeg_image_decode_tpu_torch/csrc/attention_fwd.cu",
                          attention),
        "tsconv_fwd": ("eeg_image_decode_tpu/ops/tsconv.py:84",
                       "eeg_image_decode_tpu_torch/csrc/tsconv_fwd.cu",
                       tsconv),
        "projection_fwd": ("eeg_image_decode_tpu/ops/projection.py:94",
                           "eeg_image_decode_tpu_torch/csrc/projection_fwd.cu",
                           projection),
    }


#: max |kernel − plain| allowed, with its reason. float32: the two differ in
#: summation order only. bfloat16: both round at the same places, so they
#: differ where an fp32 sum lands on the other side of a bf16 rounding
#: boundary — one bf16 ulp (2^-8 relative) of an intermediate. The attention
#: layer's two LayerNorms can carry that to 2 ulps of an output of magnitude
#: < 8 (2^-4); the tsconv output is rounded once, 2 ulps of a value < 2
#: (2^-6); the projection head's output is fp32 and only g is rounded (4e-3,
#: 5x the error measured on an H100).
TOLERANCE = {
    ("attention_fwd", "float32"): 1e-4,
    ("attention_fwd", "bfloat16"): 2.0 ** -4,
    ("tsconv_fwd", "float32"): 1e-4,
    ("tsconv_fwd", "bfloat16"): 2.0 ** -6,
    ("projection_fwd", "float32"): 1e-4,
    ("projection_fwd", "bfloat16"): 4e-3,
}


def forward_design(torch, name: str, dtype, backward: bool = False) -> str:
    """The design the forward (or backward) launcher of ``name`` took for
    ``dtype``: every bfloat16 kernel must be on the tensor cores, every
    float32 one on the FMA code."""
    from eeg_image_decode_tpu_torch.ops import attention, projection, tsconv

    op = {"tsconv": tsconv, "projection": projection,
          "attention": attention}[name.split("_")[0]]
    design = (op.backward_design if backward else op.forward_design)(dtype)
    if design != ("mma_bf16" if dtype == torch.bfloat16 else "fma_fp32"):
        raise RuntimeError(f"{name} {dtype} took design {design}")
    return design


def forward_ragged_check(torch, dtype) -> dict:
    """The tsconv and projection forwards once at small ragged shapes,
    untimed, against their plain versions: tsconv at 37 rows (a short
    second tile) and T 253, and at one position (T 77); the head at B 1 and
    B 37 (no multiple of the 64-row tile) in its three modes."""
    from eeg_image_decode_tpu_torch.ops.projection import (
        draw_keep_mask,
        fused_projection_head,
        projection_head_reference,
    )
    from eeg_image_decode_tpu_torch.ops.tsconv import (
        fold_pool_into_kernel,
        tsconv_pool_fused,
        tsconv_pool_reference,
    )

    dname = str(dtype).split(".")[-1]
    g = torch.Generator(device="cuda").manual_seed(SEED + 15)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    out = {}
    w = fold_pool_into_kernel(randn(25, 40, scale=0.2), 51).to(dtype)
    tol = TOLERANCE[("tsconv_fwd", dname)]
    for rows, t in ((37, 253), (7, 77)):
        x = randn(1, rows, t).to(dtype)
        err = (tsconv_pool_fused(x, w, 5).float()
               - tsconv_pool_reference(x, w, 5).float()).abs().max().item()
        out[f"tsconv_fwd_rows{rows}_T{t}"] = err
        if not err <= tol:
            raise RuntimeError(f"tsconv_fwd {dname}, {rows} rows, T {t}: "
                               f"{err} > {tol}")
    p = {"wi": randn(D_IN, D_OUT, scale=D_IN ** -0.5),
         "bi": randn(D_OUT, scale=0.1),
         "wr": randn(D_OUT, D_OUT, scale=D_OUT ** -0.5),
         "br": randn(D_OUT, scale=0.1),
         "ln_s": randn(D_OUT, scale=0.1, shift=1.0),
         "ln_b": randn(D_OUT, scale=0.1)}
    p = {k: v.to(dtype) for k, v in p.items()}
    for b in (1, 37):
        x = randn(b, D_IN).to(dtype)
        mask = ((torch.rand(b, D_OUT, generator=g, device="cuda") >= 0.5)
                .float() * 2.0).to(dtype)
        drawn = draw_keep_mask(7, b, D_OUT, 0.5, device="cuda")
        for mode, args, plain_mask in (("none", (), None),
                                       ("mask", (mask,), mask),
                                       ("seed", (None, 0.5, 7), drawn)):
            tol = (TOLERANCE[("projection_fwd", dname)] if mode == "none"
                   else PROJ_FWD_TOL[dname])
            with torch.no_grad():
                err = (fused_projection_head(x, p, *args)
                       - projection_head_reference(x, p, plain_mask)
                       ).abs().max().item()
            out[f"projection_fwd_{mode}_B{b}"] = err
            if not err <= tol:
                raise RuntimeError(f"projection_fwd {mode} {dname}, B {b}: "
                                   f"{err} > {tol}")
    return out


def check_kernels(torch) -> dict:
    rows = {}
    for name, (replaces, source, make) in kernel_cases(torch).items():
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            kern, plain, library, flops, nbytes = make(dtype)
            got, again = kern(), kern()
            want = plain()
            torch.cuda.synchronize()
            if not (torch.isfinite(got).all() and torch.equal(got, again)):
                raise RuntimeError(f"{name} {dname}: non-finite output, or "
                                   "a rerun that differs")
            err = (got.float() - want.float()).abs().max().item()
            tol = TOLERANCE[(name, dname)]
            b_ms, b_by = bound(flops, nbytes, dname)
            extra = {"design": forward_design(torch, name, dtype)}
            if dtype == torch.bfloat16:
                extra["first_version_ms"] = FIRST_VERSION_MS[name]
                extra["device_ms"] = device_ms(torch, kern)
                if library:
                    extra["library_device_ms"] = device_ms(torch, library)
                else:
                    extra["plain_device_ms"] = device_ms(torch, plain)
            row = {
                "phase": "kernel", "name": name, "dtype": dname,
                "shape_batch": BATCH, "max_abs_err": err, "tolerance": tol,
                "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
                "library_ms": cuda_ms(torch, library) if library else None,
                "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
                "bytes": nbytes, **extra,
            }
            emit(row)
            if not err <= tol:
                raise RuntimeError(f"{name} {dname}: |kernel - plain| = {err}"
                                   f" > {tol}")
            rows[(name, dname)] = dict(row, replaces=replaces, source=source)
        if name == "projection_fwd":
            for dtype in (torch.bfloat16, torch.float32):
                emit({"phase": "kernel", "check": "forward ragged shapes",
                      "dtype": str(dtype).split(".")[-1],
                      "max_abs_err": forward_ragged_check(torch, dtype)})
    return rows


# ——— phase 2, training kernels: B = 1024, full width ———

L_TOK, D_MODEL, HEADS, D_FF = 64, 250, 4, 256
P_DROP = 0.25
#: backward kernel vs plain, as a share of the largest |plain| value of each
#: output: fp32 differs in summation order only; in bf16 an fp32 sum that
#: lands on the other side of a rounding boundary moves an intermediate by
#: one bf16 ulp (2^-8), and the LayerNorm and softmax backward carry that
#: into their neighbours. The key bias's gradient is zero in exact
#: arithmetic (softmax ignores a shift of the scores), so its error is taken
#: against the largest of the three QKV bias gradients.
BWD_TOL = {"bfloat16": 5e-2, "float32": 1e-4}
#: the reasons printed beside each tolerance
TOL_REASON = {
    "float32": "fp32: the two sum in another order, nothing else",
    "attention_fwd_masks": "one bf16 rounding of an intermediate per site, "
                           "2 ulps of an output < 16",
    "attention_fwd_seed": "one bf16 rounding of an intermediate per site, "
                          "2 ulps of an output < 16",
    "attention_bwd": "share of each output's largest |plain|: a bf16 "
                     "rounding flip (2^-8) spread by the LayerNorm and "
                     "softmax backward",
    "tsconv_bwd": "share of each output's largest |plain|: fp32 sums of "
                  "bf16 products, order only",
    "tsconv_fwd": "one rounding to bf16 of fp32 sums of exact products: 2 "
                  "ulps of an output < 2",
    "projection_fwd_masks": "only g is rounded to bf16 and the output is "
                            "fp32: the no-dropout head's 4e-3, twice, since "
                            "a kept z is doubled",
    "projection_fwd_seed": "as projection_fwd_masks",
    "projection_bwd": "share of each output's largest |plain|: a bf16 "
                      "rounding flip (2^-8) of g, d_z or d_a, and the cast "
                      "of the gradients to bf16",
}
#: the projection head's dropout-mode forward vs plain (fp32 output)
PROJ_FWD_TOL = {"bfloat16": 8e-3, "float32": 1e-4}
P_DROP_PROJ = 0.5
D_IN, D_OUT = 1440, 1024
#: kernel names (substrings) that must hold HMMA/HGMMA instructions: the
#: bfloat16 designs of the attention forward (all three dropout modes are
#: one kernel), the attention backward's rows kernel and its dW products,
#: the tsconv forward and backward, the projection head's chain (its
#: forward's launches 1-2, which its backward recomputes) and the
#: backward's own products
TENSOR_CORE_KERNELS = ("attention_fwd_mma_kernel",
                       "attention_bwd_mma_rows_kernel",
                       "attention_dw_mma_kernel",
                       "tsconv_fwd_mma_kernel", "tsconv_bwd_mma_kernel",
                       "projection_chain_a_kernel",
                       "projection_chain_r_kernel", "projection_bwd_da_kernel",
                       "projection_bwd_out_kernel")
#: bfloat16 event times of the first versions of the seven redesigned
#: kernels (fp32 FMA products; PERF.md, H100 80GB HBM3 at 700 W): the
#: backward ops and the forwards in dropout mode at B 1024, the forwards
#: without dropout at B 256. The tsconv forward's first version at B 1024
#: was never timed in this script and is not in this tree;
#: scripts/ab_torch_kernels.py times it beside the redesign.
FIRST_VERSION_MS = {"tsconv_bwd": 4.718, "projection_bwd": 1.757,
                    "tsconv_fwd": 0.265, "projection_fwd": 0.373,
                    "projection_fwd_masks": 0.718,
                    "projection_fwd_seed": 0.647,
                    "attention_fwd": 1.609, "attention_fwd_seed": 5.472,
                    "attention_fwd_masks": 5.864, "attention_bwd": 21.679}
#: why a kernel has no library yardstick
NO_LIBRARY = {
    "attention_fwd_masks": "none: no one PyTorch call computes the layer",
    "attention_fwd_seed": "none: no one PyTorch call computes the layer",
    "attention_bwd": "none: no one PyTorch call computes the layer's "
                     "backward",
}
#: dropout-mode forward vs plain: as the no-dropout layer, but the kept
#: values 1/keep (4/3) scale what enters the LayerNorms, and each site adds
#: a rounding in bf16: 2 ulps of an output of magnitude < 16 (2^-3)
DROPOUT_FWD_TOL = {"bfloat16": 2.0 ** -3, "float32": 1e-4}


def attention_case(torch, dtype, batch: int, seed: int):
    """x (batch, 64, 250), the 16 parameters, a cotangent; in dtype."""
    from eeg_image_decode_tpu_torch.ops.attention import PARAM_ORDER

    g = torch.Generator(device="cuda").manual_seed(seed)
    inner = (D_MODEL // HEADS) * HEADS
    shapes = {"wq": (D_MODEL, inner), "bq": (inner,), "wk": (D_MODEL, inner),
              "bk": (inner,), "wv": (D_MODEL, inner), "bv": (inner,),
              "wo": (inner, D_MODEL), "bo": (D_MODEL,), "ln1_s": (D_MODEL,),
              "ln1_b": (D_MODEL,), "w1": (D_MODEL, D_FF), "b1": (D_FF,),
              "w2": (D_FF, D_MODEL), "b2": (D_MODEL,), "ln2_s": (D_MODEL,),
              "ln2_b": (D_MODEL,)}

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    p = {}
    for k in PARAM_ORDER:
        s = shapes[k]
        if len(s) == 2:
            p[k] = randn(*s, scale=s[0] ** -0.5)
        elif k.endswith("_s"):
            p[k] = randn(*s, scale=0.1, shift=1.0)
        else:
            p[k] = randn(*s, scale=0.1)
    p = {k: v.to(dtype) for k, v in p.items()}
    x = randn(batch, L_TOK, D_MODEL).to(dtype)
    gout = randn(batch, L_TOK, D_MODEL).to(dtype)
    return x, p, gout


def attention_flops(batch: int) -> float:
    inner = (D_MODEL // HEADS) * HEADS
    hd = inner // HEADS
    return batch * 2 * L_TOK * (3 * D_MODEL * inner + 2 * HEADS * L_TOK * hd
                                + inner * D_MODEL + 2 * D_MODEL * D_FF)


def scaled_errors(torch, got: dict, want: dict) -> dict:
    """max |got − want| per output over the largest |want| (the QKV biases
    share the largest scale of the three)."""
    scale = {k: w.float().abs().max().item() for k, w in want.items()}
    bias = max(scale.get(k, 0.0) for k in ("bq", "bk", "bv"))
    out = {}
    for k, w in want.items():
        s = bias if k in ("bq", "bk", "bv") else scale[k]
        out[k] = (got[k].float() - w.float()).abs().max().item() / max(s, 1e-30)
    return out


def tsconv_bwd_ragged_check(torch, dtype, tol: float) -> dict:
    """The tsconv backward once at a small ragged shape, untimed: T 253 (no
    multiple of the stride: the trailing samples get dx = 0) and 37 rows (no
    multiple of the kernel's 32-row tile), against the plain version."""
    from eeg_image_decode_tpu_torch.ops.tsconv import (
        fold_pool_into_kernel,
        out_positions,
        tsconv_pool_backward_reference,
        tsconv_pool_fused,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    rows, T, K, Fn, pool, stride = 37, 253, 25, 40, 51, 5
    w = fold_pool_into_kernel(
        torch.randn(K, Fn, generator=g, device="cuda") * K ** -0.5,
        pool).to(dtype).requires_grad_()
    P = out_positions(T, w.shape[0], stride)
    x = torch.randn(1, rows, T, generator=g, device="cuda").to(dtype)
    x.requires_grad_()
    gout = torch.randn(1, rows, P, Fn, generator=g, device="cuda").to(dtype)
    dx, dw = torch.autograd.grad(tsconv_pool_fused(x, w, stride), [x, w],
                                 gout)
    dx_p, dw_p = tsconv_pool_backward_reference(x.detach(), w.detach(), gout,
                                                stride)
    torch.cuda.synchronize()
    errs = scaled_errors(torch, {"x": dx, "w_tilde": dw},
                         {"x": dx_p, "w_tilde": dw_p})
    tail_zero = not dx[..., (P - 1) * stride + w.shape[0]:].any().item()
    if not (max(errs.values()) <= tol and tail_zero):
        raise RuntimeError(f"tsconv_bwd {dtype}, 37 rows, T 253: errors "
                           f"{errs}, trailing dx zero {tail_zero}")
    return {"rows": rows, "T": T, "scaled_err": errs,
            "trailing_dx_zero": tail_zero}


def check_training_kernels(torch) -> dict:
    from eeg_image_decode_tpu_torch.ops.attention import (
        MASK_ORDER,
        PARAM_ORDER,
        attention_layer_backward_reference,
        attention_layer_reference,
        draw_keep_masks,
        fused_attention_layer,
    )
    from eeg_image_decode_tpu_torch.ops.tsconv import (
        backward_design as tsconv_backward_design,
        fold_pool_into_kernel,
        out_positions,
        tsconv_pool_backward_reference,
        tsconv_pool_fused,
        tsconv_pool_reference,
    )

    B = TRAIN_BATCH
    rows = {}

    def record(name, dname, replaces, source, kern, plain, library, flops,
               nbytes, err, tol, library_desc="dense g2 @ E^T + x2^T @ g2",
               key=None, **extra):
        b_ms, b_by = bound(flops, nbytes, dname)
        reason = TOL_REASON["float32" if dname == "float32" else name]
        row = {"phase": "kernel", "name": name, "dtype": dname,
               "shape_batch": B, "max_abs_err": err, "tolerance": tol,
               "tolerance_reason": reason,
               "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
               "library_ms": cuda_ms(torch, library) if library else None,
               "library": library_desc if library else NO_LIBRARY[name],
               "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
               "bytes": nbytes, **extra}
        emit(row)
        rows[(key or name, dname)] = dict(row, replaces=replaces,
                                          source=source)
        return row

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        sz = torch.tensor([], dtype=dtype).element_size()
        x, p, gout = attention_case(torch, dtype, B, SEED + 10)
        n_par = sum(v.numel() for v in p.values())
        flops = attention_flops(B)
        g = torch.Generator(device="cuda").manual_seed(SEED + 11)
        shapes = {"m_attn": (B, HEADS, L_TOK, L_TOK),
                  "m_res": (B, L_TOK, D_MODEL), "m_ffn1": (B, L_TOK, D_FF),
                  "m_ffn2": (B, L_TOK, D_MODEL)}
        masks = {k: ((torch.rand(s, generator=g, device="cuda") >= P_DROP)
                     .float() / (1 - P_DROP)).to(dtype)
                 for k, s in shapes.items()}
        n_mask = sum(m.numel() for m in masks.values())
        tol_fwd = DROPOUT_FWD_TOL[dname]

        def attn_extra(name, kern, plain, backward=False):
            """The design and, in bf16, the first version's time and the
            device times of the kernel and of its plain version."""
            out = {"design": forward_design(torch, name, dtype, backward)}
            if dtype == torch.bfloat16:
                out.update(first_version_ms=FIRST_VERSION_MS[name],
                           device_ms=device_ms(torch, kern),
                           plain_device_ms=device_ms(torch, plain))
            return out

        # forward, mask mode
        def kern_masks():
            return fused_attention_layer(x, p, HEADS, masks=masks)

        def plain_masks():
            return attention_layer_reference(x, p, HEADS, masks=masks)

        got, again = kern_masks(), kern_masks()
        want = plain_masks()
        torch.cuda.synchronize()
        repeat = torch.equal(got, again)
        err = (got.float() - want.float()).abs().max().item()
        record("attention_fwd_masks", dname,
               "eeg_image_decode_tpu/ops/attention.py:136",
               "eeg_image_decode_tpu_torch/csrc/attention_fwd.cu",
               kern_masks, plain_masks, None, flops,
               (2 * x.numel() + n_par + n_mask) * sz, err, tol_fwd,
               bit_identical_rerun=repeat,
               **attn_extra("attention_fwd_masks", kern_masks, plain_masks))
        if not (repeat and err <= tol_fwd):
            raise RuntimeError(f"attention_fwd_masks {dname}: rerun "
                               f"bit-equal {repeat}, |Δ| {err}")

        # forward, seed mode: bit-equal to mask mode fed the plain draw
        seed = SEED % (2**31 - 1)
        seed_t = torch.tensor([seed], dtype=torch.int32, device="cuda")
        drawn = draw_keep_masks(seed, B, HEADS, L_TOK, D_MODEL, D_FF, P_DROP,
                                device="cuda")
        kept = {k: float((drawn[k] > 0).float().mean()) for k in MASK_ORDER}
        bad = {k: v for k, v in kept.items() if abs(v - 0.75) > 0.005}
        if bad:
            raise RuntimeError(f"kept fractions off 0.75 ± 0.005: {bad}")
        def kern_seed():
            return fused_attention_layer(x, p, HEADS, dropout_p=P_DROP,
                                         seed=seed_t)

        def plain_seed():
            return attention_layer_reference(x, p, HEADS, masks=drawn)

        got = kern_seed()
        via_masks = fused_attention_layer(x, p, HEADS, masks=drawn)
        want = plain_seed()
        torch.cuda.synchronize()
        same = torch.equal(got, via_masks)
        err = (got.float() - want.float()).abs().max().item()
        record("attention_fwd_seed", dname,
               "eeg_image_decode_tpu/ops/attention.py:136",
               "eeg_image_decode_tpu_torch/csrc/attention_fwd.cu",
               kern_seed, plain_seed, None, flops,
               (2 * x.numel() + n_par) * sz, err, tol_fwd,
               equals_mask_mode_on_plain_draw=same, kept_fraction=kept,
               **attn_extra("attention_fwd_seed", kern_seed, plain_seed))
        if not (same and err <= tol_fwd):
            raise RuntimeError(f"attention_fwd_seed {dname}: bit-equal to "
                               f"mask mode {same}, |Δ| {err}")

        # backward, seed mode (the training path's), through autograd as a
        # step runs it: dx and the 16 gradients, in the parameters' dtype
        xg = x.detach().requires_grad_()
        pg = {k: v.detach().requires_grad_() for k, v in p.items()}
        inputs = [xg, *[pg[k] for k in PARAM_ORDER]]
        out = fused_attention_layer(xg, pg, HEADS, dropout_p=P_DROP,
                                    seed=seed_t)

        def kern_bwd():
            return torch.autograd.grad(out, inputs, gout, retain_graph=True)

        got1, got2 = kern_bwd(), kern_bwd()
        dxp, gp = attention_layer_backward_reference(x, p, gout, HEADS,
                                                     masks=drawn)
        extra = {}
        if dtype == torch.float32:
            # the mask-mode backward reads the same fp32 values that seed
            # mode draws, so the two agree bit for bit
            via = torch.autograd.grad(
                fused_attention_layer(xg, pg, HEADS, masks=drawn), inputs,
                gout)
            extra["equals_mask_mode_on_plain_draw"] = all(
                torch.equal(a, b) for a, b in zip(got1, via))
        torch.cuda.synchronize()
        names = ("x",) + PARAM_ORDER
        got = dict(zip(names, got1))
        want = {"x": dxp, **gp}
        repeat = all(torch.equal(a, b) for a, b in zip(got1, got2))
        finite = all(torch.isfinite(v.float()).all().item()
                     for v in got.values())
        errs = scaled_errors(torch, got, want)
        err = max((got[k].float() - want[k].float()).abs().max().item()
                  for k in want)
        tol = BWD_TOL[dname]

        def plain_bwd():
            return attention_layer_backward_reference(x, p, gout, HEADS,
                                                      masks=drawn)

        extra.update(attn_extra("attention_bwd", kern_bwd, plain_bwd,
                                backward=True))
        record("attention_bwd", dname,
               "eeg_image_decode_tpu/ops/attention.py:368",
               "eeg_image_decode_tpu_torch/csrc/attention_bwd.cu",
               kern_bwd, plain_bwd, None, 3 * flops,
               (3 * x.numel() + 2 * n_par) * sz,
               err, tol, max_scaled_err=max(errs.values()),
               scaled_err=errs, bit_identical_rerun=repeat, **extra)
        if not (repeat and finite and max(errs.values()) <= tol
                and extra.get("equals_mask_mode_on_plain_draw", True)):
            raise RuntimeError(f"attention_bwd {dname}: rerun bit-equal "
                               f"{repeat}, finite {finite}, errors {errs}, "
                               f"{extra}")

        # tsconv backward through autograd: dx and dw~ in dtype (the
        # kernel's fp32 sums, cast as a step casts them)
        gt = torch.Generator(device="cuda").manual_seed(SEED + 12)
        C, T, K, Fn, pool, stride = 63, 250, 25, 40, 51, 5
        w_tilde = fold_pool_into_kernel(
            torch.randn(K, Fn, generator=gt, device="cuda") * K ** -0.5,
            pool).to(dtype)
        M = w_tilde.shape[0]
        P = out_positions(T, M, stride)
        xt = torch.randn(B, C, T, generator=gt, device="cuda").to(dtype)
        gt_out = torch.randn(B, C, P, Fn, generator=gt,
                             device="cuda").to(dtype)
        m_idx = torch.arange(T, device="cuda")[:, None] - torch.arange(
            P, device="cuda")[None, :] * stride
        valid = (m_idx >= 0) & (m_idx < M)
        e = torch.where(valid[..., None], w_tilde[m_idx.clamp(0, M - 1)],
                        torch.zeros((), dtype=dtype, device="cuda"))
        e = e.reshape(T, P * Fn)
        x2 = xt.reshape(B * C, T)
        g2d = gt_out.reshape(B * C, P * Fn)
        xt_g = xt.detach().requires_grad_()
        w_g = w_tilde.detach().requires_grad_()
        out_t = tsconv_pool_fused(xt_g, w_g, stride)

        def kern_ts():
            return torch.autograd.grad(out_t, [xt_g, w_g], gt_out,
                                       retain_graph=True)

        (a1, b1), (a2, b2) = kern_ts(), kern_ts()
        ap, bp = tsconv_pool_backward_reference(xt, w_tilde, gt_out, stride)
        torch.cuda.synchronize()
        repeat = torch.equal(a1, a2) and torch.equal(b1, b2)
        errs = scaled_errors(torch, {"x": a1, "w_tilde": b1},
                             {"x": ap, "w_tilde": bp})
        err = max((a1.float() - ap).abs().max().item(),
                  (b1.float() - bp).abs().max().item())
        rows_n = B * C
        design = tsconv_backward_design(dtype)
        if design != ("mma_bf16" if dtype == torch.bfloat16 else "fma_fp32"):
            raise RuntimeError(f"tsconv_bwd {dname} took design {design}")
        extra = {"design": design,
                 "ragged_case": tsconv_bwd_ragged_check(torch, dtype, tol)}
        if dtype == torch.bfloat16:
            extra["first_version_ms"] = FIRST_VERSION_MS["tsconv_bwd"]
            extra["device_ms"] = device_ms(torch, kern_ts)
            extra["library_device_ms"] = device_ms(
                torch, lambda: (torch.matmul(g2d, e.T),
                                torch.matmul(x2.T, g2d)))
        if a1.dtype != dtype:
            raise RuntimeError(f"tsconv_bwd {dname}: dx arrived as {a1.dtype}")
        record("tsconv_bwd", dname, "eeg_image_decode_tpu/ops/tsconv.py:130",
               "eeg_image_decode_tpu_torch/csrc/tsconv_bwd.cu", kern_ts,
               lambda: tsconv_pool_backward_reference(xt, w_tilde, gt_out,
                                                      stride),
               lambda: (torch.matmul(g2d, e.T), torch.matmul(x2.T, g2d)),
               2 * 2 * rows_n * P * M * Fn,
               (2 * xt.numel() + gt_out.numel() + 2 * w_tilde.numel()) * sz,
               err, tol, max_scaled_err=max(errs.values()), scaled_err=errs,
               bit_identical_rerun=repeat, **extra)
        if not (repeat and max(errs.values()) <= tol):
            raise RuntimeError(f"tsconv_bwd {dname}: rerun bit-equal "
                               f"{repeat}, errors {errs}")

        # tsconv forward at the training shape (64,512 rows)
        def kern_ts_fwd():
            return tsconv_pool_fused(xt, w_tilde, stride)

        got, again = kern_ts_fwd(), kern_ts_fwd()
        want = tsconv_pool_reference(xt, w_tilde, stride)
        torch.cuda.synchronize()
        repeat = torch.equal(got, again)
        err = (got.float() - want.float()).abs().max().item()
        tol_f = TOLERANCE[("tsconv_fwd", dname)]
        extra = {"design": forward_design(torch, "tsconv_fwd", dtype)}
        if dtype == torch.bfloat16:
            extra["first_version_ms"] = None
            extra["first_version_note"] = (
                "the first version's bf16 kernel is not in this tree: "
                "scripts/ab_torch_kernels.py times it against this one")
            extra["device_ms"] = device_ms(torch, kern_ts_fwd)
            extra["library_device_ms"] = device_ms(
                torch, lambda: torch.matmul(x2, e))
        record("tsconv_fwd", dname, "eeg_image_decode_tpu/ops/tsconv.py:84",
               "eeg_image_decode_tpu_torch/csrc/tsconv_fwd.cu", kern_ts_fwd,
               lambda: tsconv_pool_reference(xt, w_tilde, stride),
               lambda: torch.matmul(x2, e), 2 * rows_n * P * M * Fn,
               (xt.numel() + w_tilde.numel() + rows_n * P * Fn) * sz, err,
               tol_f, library_desc="dense x2 @ E (the JAX TPU default)",
               key="tsconv_fwd_train", bit_identical_rerun=repeat, **extra)
        if not (repeat and err <= tol_f):
            raise RuntimeError(f"tsconv_fwd {dname}, B {B}: rerun bit-equal "
                               f"{repeat}, |Δ| {err}")
        check_projection_training_kernels(torch, dtype, record)
    return rows


def check_projection_training_kernels(torch, dtype, record) -> None:
    """The projection head's mask-mode and seed-mode forward and its
    backward at B = 1024, one dtype."""
    import torch.nn.functional as F

    from eeg_image_decode_tpu_torch.ops.projection import (
        PARAM_ORDER,
        backward_design,
        draw_keep_mask,
        fused_projection_head,
        projection_head_backward_reference,
        projection_head_reference,
    )

    B = TRAIN_BATCH
    dname = str(dtype).split(".")[-1]
    sz = torch.tensor([], dtype=dtype).element_size()
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    p = {"wi": randn(D_IN, D_OUT, scale=D_IN ** -0.5),
         "bi": randn(D_OUT, scale=0.1),
         "wr": randn(D_OUT, D_OUT, scale=D_OUT ** -0.5),
         "br": randn(D_OUT, scale=0.1),
         "ln_s": randn(D_OUT, scale=0.1, shift=1.0),
         "ln_b": randn(D_OUT, scale=0.1)}
    p = {k: v.to(dtype) for k, v in p.items()}
    x = randn(B, D_IN).to(dtype)
    gout = randn(B, D_OUT)                               # fp32, as the loss's
    mask = ((torch.rand(B, D_OUT, generator=g, device="cuda") >= P_DROP_PROJ)
            .float() / (1 - P_DROP_PROJ)).to(dtype)
    n_par = sum(v.numel() for v in p.values())
    flops = 2 * B * (D_IN * D_OUT + D_OUT * D_OUT)
    fwd_bytes = (x.numel() + n_par) * sz + B * D_OUT * 4
    replaces_fwd = "eeg_image_decode_tpu/ops/projection.py:94"
    source_fwd = "eeg_image_decode_tpu_torch/csrc/projection_fwd.cu"
    tol_fwd = PROJ_FWD_TOL[dname]
    lib_desc = ("2 matmuls + F.gelu(tanh) + F.dropout + F.layer_norm"
                " (and autograd of it for the backward)")

    def library(xx, pp):
        a = torch.matmul(xx, pp["wi"]) + pp["bi"]
        z = torch.matmul(F.gelu(a, approximate="tanh"), pp["wr"]) + pp["br"]
        z = F.dropout(z, P_DROP_PROJ, training=True)
        return F.layer_norm(a + z, (D_OUT,), pp["ln_s"], pp["ln_b"], 1e-6)

    def fwd_extra(name, kern):
        """The design, and in bf16 the first version's time and the device
        times of the kernel and of the library chain."""
        out = {"design": forward_design(torch, name, dtype)}
        if dtype == torch.bfloat16:
            out["first_version_ms"] = FIRST_VERSION_MS[name]
            out["device_ms"] = device_ms(torch, kern)
            out["library_device_ms"] = device_ms(torch, lambda: library(x, p))
        return out

    def kern_masks():
        return fused_projection_head(x, p, mask)

    def kern_seed():
        return fused_projection_head(x, p, None, P_DROP_PROJ, seed_t)

    # forward, mask mode
    with torch.no_grad():
        got, again = kern_masks(), kern_masks()
        want = projection_head_reference(x, p, mask)
        torch.cuda.synchronize()
        repeat = torch.equal(got, again)
        err = (got - want).abs().max().item()
        record("projection_fwd_masks", dname, replaces_fwd, source_fwd,
               kern_masks, lambda: projection_head_reference(x, p, mask),
               lambda: library(x, p), flops, fwd_bytes + mask.numel() * sz,
               err, tol_fwd, library_desc=lib_desc,
               bit_identical_rerun=repeat,
               **fwd_extra("projection_fwd_masks", kern_masks))
        if not (repeat and err <= tol_fwd and torch.isfinite(got).all()):
            raise RuntimeError(f"projection_fwd_masks {dname}: rerun "
                               f"bit-equal {repeat}, |Δ| {err}")

        # forward, seed mode: bit-equal to mask mode fed the plain draw
        seed = (SEED + 1) % (2**31 - 1)
        seed_t = torch.tensor([seed], dtype=torch.int32, device="cuda")
        drawn = draw_keep_mask(seed, B, D_OUT, P_DROP_PROJ, device="cuda")
        kept = float((drawn > 0).float().mean())
        if abs(kept - (1 - P_DROP_PROJ)) > 0.005:
            raise RuntimeError(f"kept fraction {kept} off 0.5 ± 0.005")
        got, again = kern_seed(), kern_seed()
        via_mask = fused_projection_head(x, p, drawn)
        want = projection_head_reference(x, p, drawn)
        torch.cuda.synchronize()
        same = torch.equal(got, via_mask)
        repeat = torch.equal(got, again)
        err = (got - want).abs().max().item()
        record("projection_fwd_seed", dname, replaces_fwd, source_fwd,
               kern_seed,
               lambda: projection_head_reference(x, p, drawn),
               lambda: library(x, p), flops, fwd_bytes, err, tol_fwd,
               library_desc=lib_desc, equals_mask_mode_on_plain_draw=same,
               kept_fraction=kept, bit_identical_rerun=repeat,
               **fwd_extra("projection_fwd_seed", kern_seed))
        if not (same and repeat and err <= tol_fwd):
            raise RuntimeError(f"projection_fwd_seed {dname}: bit-equal to "
                               f"mask mode {same}, rerun bit-equal {repeat}, "
                               f"|Δ| {err}")

    # backward, seed mode (the training path's), through autograd as a step
    # runs it: dx and the six gradients, in the parameters' dtype
    xg = x.detach().requires_grad_()
    pg = {k: v.detach().requires_grad_() for k, v in p.items()}
    inputs = [xg, *[pg[k] for k in PARAM_ORDER]]
    out = fused_projection_head(xg, pg, None, P_DROP_PROJ, seed_t)

    def kern_bwd():
        return torch.autograd.grad(out, inputs, gout, retain_graph=True)

    got1, got2 = kern_bwd(), kern_bwd()
    via = torch.autograd.grad(fused_projection_head(xg, pg, drawn), inputs,
                              gout)
    dxp, gp = projection_head_backward_reference(x, p, gout, drawn)
    out_lib = library(xg, pg)

    def lib_bwd():
        return torch.autograd.grad(out_lib, inputs, gout, retain_graph=True)

    torch.cuda.synchronize()
    names = ("x",) + PARAM_ORDER
    got = dict(zip(names, got1))
    want = {"x": dxp, **gp}
    repeat = all(torch.equal(a, b) for a, b in zip(got1, got2))
    equals_mask = all(torch.equal(a, b) for a, b in zip(got1, via))
    finite = all(torch.isfinite(v.float()).all().item() for v in got.values())
    errs = {k: (got[k].float() - want[k].float()).abs().max().item()
            / max(want[k].float().abs().max().item(), 1e-30) for k in want}
    err = max((got[k].float() - want[k].float()).abs().max().item()
              for k in want)
    tol = BWD_TOL[dname]
    design = backward_design(dtype)
    if design != ("mma_bf16" if dtype == torch.bfloat16 else "fma_fp32"):
        raise RuntimeError(f"projection_bwd {dname} took design {design}")
    extra = {"design": design}
    if dtype == torch.bfloat16:
        extra["first_version_ms"] = FIRST_VERSION_MS["projection_bwd"]
        extra["device_ms"] = device_ms(torch, kern_bwd)
        extra["library_device_ms"] = device_ms(torch, lib_bwd)
    record("projection_bwd", dname,
           "eeg_image_decode_tpu/ops/projection.py:128",
           "eeg_image_decode_tpu_torch/csrc/projection_bwd.cu", kern_bwd,
           lambda: projection_head_backward_reference(x, p, gout, drawn),
           lib_bwd, 3 * flops,
           (2 * x.numel() + 2 * n_par) * sz + gout.numel() * 4, err, tol,
           library_desc=lib_desc, max_scaled_err=max(errs.values()),
           scaled_err=errs, bit_identical_rerun=repeat,
           equals_mask_mode_on_plain_draw=equals_mask, **extra)
    if not (repeat and finite and max(errs.values()) <= tol
            and (equals_mask or dtype != torch.float32)):
        raise RuntimeError(f"projection_bwd {dname}: rerun bit-equal "
                           f"{repeat}, finite {finite}, equals mask mode "
                           f"{equals_mask}, errors {errs}")


# ——— phase 3: the serving path through the port's HTTP daemon ———


def _post(url: str, body: bytes, ctype: str) -> dict:
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def plain_versions():
    """Patches that swap each kernel wrapper on the serving path for its
    plain version, with the wrapper's own parameter cast."""
    from eeg_image_decode_tpu_torch.ops.attention import (
        attention_layer_reference,
    )
    from eeg_image_decode_tpu_torch.ops.projection import (
        projection_head_reference,
    )
    from eeg_image_decode_tpu_torch.ops.tsconv import tsconv_pool_reference

    def cast(p, x):
        return {k: v.to(x.dtype) for k, v in p.items()}

    return [
        mock.patch("eeg_image_decode_tpu_torch.models.atm_s."
                   "fused_attention_layer",
                   lambda x, p, h=4, **_: attention_layer_reference(
                       x, cast(p, x), h)),
        mock.patch("eeg_image_decode_tpu_torch.models.layers.tsconv_pool_fused",
                   lambda x, w, s=5: tsconv_pool_reference(x, w.to(x.dtype), s)),
        mock.patch("eeg_image_decode_tpu_torch.models.layers."
                   "fused_projection_head",
                   lambda x, p, *_: projection_head_reference(x, cast(p, x))),
    ]


def serve_path(torch, variant: str, fused_projection: bool, eeg, sids,
               gallery) -> dict:
    from eeg_image_decode_tpu_torch.core.config import ATMSConfig
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.serve import RetrievalService
    from eeg_image_decode_tpu_torch.server import EEGDecodeServer

    cfg = ATMSConfig(fused_projection=True if fused_projection else "auto")
    model = build_encoder("atms", config=cfg, dtype=torch.bfloat16,
                          device="cuda", seed=SEED)
    svc = RetrievalService(model, gallery, max_batch=BATCH, device="cuda")
    svc.warmup((cfg.n_channels, cfg.seq_len))
    server = EEGDecodeServer(retrieval=svc)
    port = server.start(port=0)
    url = f"http://127.0.0.1:{port}/v1/retrieve"
    try:
        requests = [(0, 1, 5), (1, 8, 64), (9, 37, 200), (46, BATCH, 5)]
        _build.reset_launches()
        answers = []
        for lo, n, k in requests:
            out = _post(url, _npz(eeg=eeg[lo:lo + n], subject_ids=sids[lo:lo + n],
                                  k=np.int64(k)), "application/octet-stream")
            answers.append((lo, n, k, out))
        out = _post(url, json.dumps({"eeg": eeg[:3].tolist(),
                                     "subject_ids": sids[:3].tolist(),
                                     "k": 5}).encode(), "application/json")
        answers.append((0, 3, 5, out))
        launches = dict(_build.LAUNCHES)
        n_requests = len(answers)
        required = ["attention_fwd", "tsconv_fwd"] + (
            ["projection_fwd"] if fused_projection else [])
        missing = [k for k in required if launches[k] == 0]
        if missing:
            raise RuntimeError(f"{variant}: the serving path launched no "
                               f"{missing} kernel: {launches}")
        for lo, n, k, out in answers:
            s, i = svc.top_k(eeg[lo:lo + n], sids[lo:lo + n], k=k)
            got_i = np.asarray(out["indices"])
            got_s = np.asarray(out["scores"], np.float32)
            if got_i.shape != (n, k) or not np.array_equal(got_i, i):
                raise RuntimeError(f"{variant}: HTTP answer for {n} rows, "
                                   f"k={k} differs from top_k")
            if not np.array_equal(got_s, s) or not np.isfinite(got_s).all():
                raise RuntimeError(f"{variant}: HTTP scores for {n} rows "
                                   "differ from top_k or are not finite")

        _, idx_kernel = svc.top_k(eeg[:BATCH], sids[:BATCH], k=5)
        with ExitStack() as stack:
            for patch in plain_versions():
                stack.enter_context(patch)
            _build.reset_launches()
            _, idx_plain = svc.top_k(eeg[:BATCH], sids[:BATCH], k=5)
            if any(_build.LAUNCHES.values()):
                raise RuntimeError("the plain service launched a kernel")
        overlap = np.mean([len(set(a) & set(b)) / 5.0
                           for a, b in zip(idx_kernel, idx_plain)])
        exact = float(np.mean(np.all(idx_kernel == idx_plain, axis=1)))
        if overlap < 0.99:
            raise RuntimeError(f"{variant}: top-5 overlap with the plain "
                               f"versions {overlap:.4f} < 0.99")

        latency = {}
        for n in (1, 8, 32, BATCH):
            body = _npz(eeg=eeg[:n], subject_ids=sids[:n], k=np.int64(5))
            times = []
            for _ in range(20):
                t0 = time.perf_counter()
                _post(url, body, "application/octet-stream")
                times.append(time.perf_counter() - t0)
            direct = []
            for _ in range(20):
                t0 = time.perf_counter()
                svc.top_k(eeg[:n], sids[:n], k=5)
                direct.append(time.perf_counter() - t0)
            latency[str(n)] = {
                "bucket": next(b for b in svc.buckets if b >= n),
                "http_p50_ms": float(np.median(times)) * 1e3,
                "http_requests_per_s": len(times) / float(np.sum(times)),
                "top_k_p50_ms": float(np.median(direct)) * 1e3,
            }
        row = {"phase": "serve", "variant": variant, "requests": n_requests,
               "launches": launches,
               "launches_per_request": {k: v / n_requests
                                        for k, v in launches.items()},
               "top5_overlap_vs_plain": float(overlap),
               "top5_exact_rows_vs_plain": exact, "latency": latency,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        emit(row)
        return row
    finally:
        server.stop()


# ——— phase 4: the training path ———


def plain_training_ops(torch):
    """The attention layer, tsconv stage 1 and the fused projection head as
    autograd Functions of their plain versions (forward and backward), with
    the wrappers' signatures: the same step without any kernel. In seed mode
    they draw the masks the kernels draw, with ``draw_keep_masks`` and
    ``draw_keep_mask``."""
    from eeg_image_decode_tpu_torch.ops.attention import (
        PARAM_ORDER,
        attention_layer_backward_reference,
        attention_layer_reference,
        draw_keep_masks,
    )
    from eeg_image_decode_tpu_torch.ops.projection import (
        PARAM_ORDER as PROJ_ORDER,
        draw_keep_mask,
        projection_head_backward_reference,
        projection_head_reference,
    )
    from eeg_image_decode_tpu_torch.ops.tsconv import (
        tsconv_pool_backward_reference,
        tsconv_pool_reference,
    )

    class PlainAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, n_heads, masks, *flat):
            ctx.save_for_backward(x, *flat)
            ctx.n_heads, ctx.masks = n_heads, masks
            return attention_layer_reference(
                x, dict(zip(PARAM_ORDER, flat)), n_heads, masks=masks)

        @staticmethod
        def backward(ctx, g):
            x, *flat = ctx.saved_tensors
            dx, grads = attention_layer_backward_reference(
                x, dict(zip(PARAM_ORDER, flat)), g, ctx.n_heads,
                masks=ctx.masks)
            return (dx, None, None,
                    *[grads[k].to(x.dtype) for k in PARAM_ORDER])

    class PlainTSConv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, stride):
            ctx.save_for_backward(x, w)
            ctx.stride = stride
            return tsconv_pool_reference(x, w, stride)

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            dx, dw = tsconv_pool_backward_reference(x, w, g, ctx.stride)
            return dx.to(x.dtype), dw.to(w.dtype), None

    class PlainProjection(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, mask, *flat):
            ctx.save_for_backward(x, *flat)
            ctx.mask = mask
            return projection_head_reference(
                x, dict(zip(PROJ_ORDER, flat)), mask)

        @staticmethod
        def backward(ctx, g):
            x, *flat = ctx.saved_tensors
            dx, grads = projection_head_backward_reference(
                x, dict(zip(PROJ_ORDER, flat)), g, ctx.mask)
            return (dx, None, *[grads[k].to(x.dtype) for k in PROJ_ORDER])

    def attention(x, params, n_heads=4, *, masks=None, dropout_p=0.0,
                  seed=None):
        dt = x.dtype
        flat = [params[k].to(dt) for k in PARAM_ORDER]
        if masks is not None:  # mask mode reads them in x's dtype
            masks = {k: v.to(dt) for k, v in masks.items()}
        elif dropout_p > 0.0 and seed is not None:  # seed mode: the fp32 draw
            B, L, D = x.shape
            masks = draw_keep_masks(int(seed), B, n_heads, L, D,
                                    params["w1"].shape[1], dropout_p,
                                    device=x.device)
        return PlainAttention.apply(x, n_heads, masks, *flat)

    def tsconv(x, w_tilde, stride=5):
        return PlainTSConv.apply(x, w_tilde.to(x.dtype), stride)

    def projection(x, params, mask=None, dropout_p=0.0, seed=None):
        dt = x.dtype
        flat = [params[k].to(dt) for k in PROJ_ORDER]
        if mask is not None:
            mask = mask.to(dt)
        elif dropout_p > 0.0 and seed is not None:
            mask = draw_keep_mask(int(seed), x.shape[0],
                                  params["wi"].shape[1], dropout_p,
                                  device=x.device)
        return PlainProjection.apply(x, mask, *flat)

    return [mock.patch("eeg_image_decode_tpu_torch.models.atm_s."
                       "fused_attention_layer", attention),
            mock.patch("eeg_image_decode_tpu_torch.models.layers."
                       "tsconv_pool_fused", tsconv),
            mock.patch("eeg_image_decode_tpu_torch.models.layers."
                       "fused_projection_head", projection)]


#: one training step's gradients, kernels against plain versions, as the
#: relative L2 error per parameter: both round at the same places in bf16,
#: and an fp32 sum that lands on the other side of a bf16 rounding boundary
#: moves an intermediate by 2^-8; 5e-2 is about ten such flips per value
#: on average across a gradient
GRAD_TOL = 5e-2


def grad_check(torch, trainer, seeded: bool = False) -> dict:
    """The same step through the kernels and through the plain versions:
    the batch and either pinned masks at the seven sites, or (``seeded``)
    the trainer's own seed mode with the same generator seed on both sides.
    A pinned ``proj`` mask routes around the fused head, so the fused-head
    model is checked seeded."""
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.ops.attention import draw_keep_masks
    from eeg_image_decode_tpu_torch.train.contrastive import batch_loss

    model, cfg, data = trainer.model, trainer.cfg, trainer.data
    B = TRAIN_BATCH
    idx = torch.arange(B, device="cuda")
    batch = {"eeg": data.eeg[idx], "subject_ids": data.subject_ids[idx],
             "img_feat": data.img_feat[data.img_idx[idx]],
             "text_feat": data.text_feat[data.text_idx[idx]]}
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)

    def keep(shape, p):
        return (torch.rand(shape, generator=g, device="cuda") >= p).float() \
            / (1.0 - p)

    masks = None if seeded else {
        "emb": keep((B, L_TOK, D_MODEL), 0.25),
        "layer0": draw_keep_masks(SEED + 21, B, HEADS, L_TOK, D_MODEL, D_FF,
                                  0.25, device="cuda"),
        "tsconv": keep((B, 1, 36, 40), 0.5),
        "proj": keep((B, 1024), 0.5)}
    saved = {k: v.clone() for k, v in model.state_dict().items()}

    def step(plain: bool):
        model.load_state_dict(saved)
        model.train()
        model.zero_grad(set_to_none=True)
        with ExitStack() as stack:
            if plain:
                for patch in plain_training_ops(torch):
                    stack.enter_context(patch)
            if seeded:
                gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
                loss, _ = batch_loss(model, cfg, batch, generator=gen)
            else:
                loss, _ = batch_loss(model, cfg, batch, dropout_masks=masks)
            loss.backward()
        return float(loss.detach()), {k: p.grad.detach().float().clone()
                             for k, p in model.named_parameters()}

    _build.reset_launches()
    loss_k, grads_k = step(False)
    launches = dict(_build.LAUNCHES)
    _build.reset_launches()
    loss_p, grads_p = step(True)
    if any(_build.LAUNCHES.values()):
        raise RuntimeError("the plain step launched a kernel")
    model.load_state_dict(saved)
    model.zero_grad(set_to_none=True)
    norms = {k: v.norm().item() for k, v in grads_p.items()}
    qkv = [k for k in norms if k.split(".")[-2] in ("q_proj", "k_proj",
                                                    "v_proj")
           and k.endswith("bias")]
    bias_scale = max(norms[k] for k in qkv)
    rel = {k: (grads_k[k] - grads_p[k]).norm().item()
           / max(bias_scale if k in qkv else norms[k], 1e-30)
           for k in grads_p}
    worst = max(rel, key=rel.get)
    row = {"phase": "train_grad_check", "dtype": "bfloat16",
           "dropout": "seed mode, one generator seed" if seeded
           else "seven pinned masks",
           "loss_kernels": loss_k, "loss_plain": loss_p,
           "launches_kernel_step": launches, "tolerance": GRAD_TOL,
           "worst_param": worst, "worst_rel_l2": rel[worst],
           "rel_l2": rel}
    emit(row)
    if not (rel[worst] <= GRAD_TOL and np.isfinite(loss_k)):
        raise RuntimeError(f"step gradients, kernels vs plain: {worst} "
                           f"{rel[worst]} > {GRAD_TOL}")
    return row


def train_path(torch, card: str, train, test,
               data_s: float) -> tuple[dict, object]:
    from eeg_image_decode_tpu_torch.core.config import (
        ATMSConfig,
        ContrastiveTrainConfig,
    )
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.train.contrastive import (
        ContrastiveTrainer,
    )

    tcfg = ContrastiveTrainConfig()
    if tcfg.batch_size != TRAIN_BATCH:
        raise RuntimeError(f"batch {tcfg.batch_size} != {TRAIN_BATCH}")
    model = build_encoder("atms", config=ATMSConfig(), dtype=torch.bfloat16,
                          device="cuda", seed=SEED)
    trainer = ContrastiveTrainer(model, tcfg, train, test, device="cuda")
    torch.cuda.reset_peak_memory_stats()

    _build.reset_launches()
    metrics = trainer.train_epoch(0)
    train_launches = dict(_build.LAUNCHES)
    losses = trainer.last_steps["step_loss"]
    step_ms = trainer.last_steps["step_ms"]
    n_steps = len(losses)
    wrong = {k: train_launches[k] for k in
             ("attention_fwd_seed", "attention_bwd", "tsconv_fwd",
              "tsconv_bwd") if train_launches[k] != n_steps}
    if n_steps != train.n // TRAIN_BATCH or wrong:
        raise RuntimeError(f"training launches per step are not 1: {wrong} "
                           f"over {n_steps} steps")
    first8, last8 = float(np.mean(losses[:8])), float(np.mean(losses[-8:]))
    if not (np.all(np.isfinite(losses)) and last8 < first8):
        raise RuntimeError(f"loss did not fall: first 8 {first8}, last 8 "
                           f"{last8}")

    _build.reset_launches()
    t0 = time.perf_counter()
    evaluation = trainer.evaluate(0)                 # reads back: synced
    eval_s = time.perf_counter() - t0
    eval_launches = dict(_build.LAUNCHES)
    if not (eval_launches["attention_fwd"] and eval_launches["tsconv_fwd"]):
        raise RuntimeError(f"evaluation launched no forward kernel: "
                           f"{eval_launches}")
    if not all(np.isfinite(v) for v in evaluation.values()):
        raise RuntimeError(f"non-finite evaluation: {evaluation}")
    p50 = float(np.median(step_ms[3:]))
    row = {"phase": "train", "card": card, "dtype": "bfloat16",
           "batch": TRAIN_BATCH, "train_samples": train.n,
           "steps": n_steps, "loss_first8": first8, "loss_last8": last8,
           "epoch_loss": metrics["loss"], "train_acc": metrics["train_acc"],
           "step_ms_p50": p50, "step_ms_min": float(np.min(step_ms[3:])),
           "step_ms_max": float(np.max(step_ms[3:])),
           "samples_per_s": TRAIN_BATCH / (p50 / 1e3),
           "epoch_s": metrics["epoch_time_s"],
           "epoch_samples_per_s": metrics["samples_per_s"],
           "eval_s": eval_s, "data_on_card_s": data_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_train": train_launches,
           "launches_per_step": {k: v / n_steps
                                 for k, v in train_launches.items()},
           "launches_eval": eval_launches, "eval": evaluation,
           "step_loss": losses}
    emit(row)
    return row, trainer


# ——— phase 5: the fused-head joint path, with a checkpoint and a resume ———

TRAIN_KERNELS = ("attention_fwd_seed", "attention_bwd", "tsconv_fwd",
                 "tsconv_bwd", "projection_fwd_seed", "projection_bwd")
#: per-step losses of the resumed epoch against the uninterrupted run's:
#: the restored state is bit-equal, so any difference comes from a
#: PyTorch backward that sums in an order that varies (its index_put);
#: 0.05 is well under one step's change of a loss near 9
RESUME_TOL = 0.05


def add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def fused_joint_path(torch, card: str, train, test, default_p50: float,
                     main_launches: dict) -> dict:
    from eeg_image_decode_tpu_torch.core.checkpoint import Checkpointer
    from eeg_image_decode_tpu_torch.core.config import (
        ATMSConfig,
        ContrastiveTrainConfig,
    )
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.train.contrastive import (
        ContrastiveTrainer,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 30)

    def with_subjects(split):
        ids = torch.randint(0, 10, (split.n,), generator=g, device="cuda",
                            dtype=torch.int32)
        return dataclasses.replace(split, subject_ids=ids)

    train, test = with_subjects(train), with_subjects(test)
    used = int(torch.unique(train.subject_ids).numel())
    acfg = ATMSConfig(fused_projection=True, joint_train=True)
    tcfg = ContrastiveTrainConfig(ckpt_every_epochs=1)

    def trainer_in(run_dir: str, seed: int) -> ContrastiveTrainer:
        model = build_encoder("atms", config=acfg, dtype=torch.bfloat16,
                              device="cuda", seed=seed)
        return ContrastiveTrainer(
            model, tcfg, train, test, device="cuda", output_dir=run_dir,
            checkpointer=Checkpointer(os.path.join(run_dir, "ckpt")))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_run_") as run_dir:
        first = trainer_in(run_dir, SEED)
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        history = first.fit(1, log_fn=None)       # epoch 0, eval, checkpoint
        launches = dict(_build.LAUNCHES)
        add_launches(main_launches, launches)
        losses = first.last_steps["step_loss"]
        step_ms = first.last_steps["step_ms"]
        n_steps = len(losses)
        want = {k: n_steps for k in TRAIN_KERNELS}
        want["tsconv_fwd"] += 1                    # the evaluation's
        wrong = {k: launches[k] for k in want if launches[k] != want[k]}
        if wrong or launches["projection_fwd"] != 1 \
                or launches["attention_fwd"] != 1:
            raise RuntimeError(f"fused joint path: launches {launches} over "
                               f"{n_steps} steps and one evaluation")
        first8, last8 = float(np.mean(losses[:8])), float(np.mean(losses[-8:]))
        if not (np.all(np.isfinite(losses)) and last8 < first8):
            raise RuntimeError(f"fused joint path: loss did not fall: "
                               f"{first8} -> {last8}")
        if first.checkpointer.all_steps() != [1]:
            raise RuntimeError("no checkpoint after the epoch: "
                               f"{first.checkpointer.all_steps()}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        # a fresh model (other weights) and trainer resume and run epoch 1
        resumed = trainer_in(run_dir, SEED + 1)
        t0 = time.perf_counter()
        start = resumed.resume()
        resume_s = time.perf_counter() - t0
        same_state = all(
            torch.equal(a, b) for a, b in zip(
                resumed.model.state_dict().values(),
                first.model.state_dict().values()))
        if start != 1 or not same_state or resumed.state.step != n_steps:
            raise RuntimeError(f"resume: epoch {start}, state restored "
                               f"bit-equal {same_state}, step "
                               f"{resumed.state.step}")
        _build.reset_launches()
        resumed.fit(2, log_fn=None)
        add_launches(main_launches, dict(_build.LAUNCHES))
        if [r["epoch"] for r in resumed.history] != [0, 1]:
            raise RuntimeError(f"resumed history: {resumed.history}")
        got = np.asarray(resumed.last_steps["step_loss"])
        # the uninterrupted run: the first trainer goes on with epoch 1
        first.train_epoch(1)
        ref = np.asarray(first.last_steps["step_loss"])
        delta = float(np.abs(got - ref).max())
        bit_equal = bool(np.array_equal(got, ref))
        if not (np.all(np.isfinite(got)) and delta <= RESUME_TOL):
            raise RuntimeError(f"resumed epoch differs from the "
                               f"uninterrupted one: max |Δloss| {delta}")
        check = grad_check(torch, resumed, seeded=True)
        missing = [k for k in TRAIN_KERNELS
                   if check["launches_kernel_step"][k] != 1]
        if missing:
            raise RuntimeError(f"seeded step launched no {missing}")

    p50 = float(np.median(step_ms[3:]))
    row = {"phase": "train_fused_joint", "card": card, "dtype": "bfloat16",
           "batch": TRAIN_BATCH, "subjects_used": used, "steps": n_steps,
           "loss_first8": first8, "loss_last8": last8,
           "epoch_loss": history[0]["loss"], "eval": {
               k: v for k, v in history[0].items() if k.startswith("top")},
           "step_ms_p50": p50, "step_ms_min": float(np.min(step_ms[3:])),
           "step_ms_max": float(np.max(step_ms[3:])),
           "samples_per_s": TRAIN_BATCH / (p50 / 1e3),
           "default_head_step_ms_p50": default_p50,
           "epoch_s": history[0]["epoch_time_s"], "peak_mem_gb": peak_gb,
           "launches_fit_one_epoch": launches,
           "resume_s": resume_s, "resumed_state_bit_equal": same_state,
           "resumed_epoch_max_abs_dloss": delta,
           "resumed_epoch_bit_equal": bit_equal,
           "resume_tolerance": RESUME_TOL,
           "resumed_epoch_loss": float(got.mean())}
    emit(row)
    return row


# ——— phase 6: the training CLI on a written THINGS-EEG-shaped tree ———


def run_cli(argv: list[str]) -> tuple[dict, str | None]:
    """``cli.main(argv)`` in this process: (the JSON row it prints last,
    the run directory it names)."""
    from eeg_image_decode_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    run_dir = next((ln.split(": ", 1)[1] for ln in lines
                    if ln.startswith("run directory: ")), None)
    return json.loads(lines[-1]), run_dir


def cli_path(torch, main_launches: dict,
             tmp: str) -> tuple[dict, str, str, str]:
    """Phase 6 in the directory ``tmp``: (its row, the run directory, the
    tree's root, its feature file)."""
    from eeg_image_decode_tpu_torch.data.synthetic import (
        write_synthetic_things_tree,
    )
    from eeg_image_decode_tpu_torch.ops import _build

    ks, seed = "2,4,10,20", 7
    t0 = time.perf_counter()
    root = os.path.join(tmp, "things")
    feats = write_synthetic_things_tree(
        root, ("sub-01", "sub-02"), n_classes=30, n_test_classes=20,
        seed=SEED)
    tree_s = time.perf_counter() - t0
    common = ["--data-path", root, "--features", feats, "--eval-ks", ks,
              "--subjects", "sub-01"]
    train_args = [*common, "--batch-size", "256", "--seed", str(seed)]
    _build.reset_launches()
    t0 = time.perf_counter()
    row2, run_dir = run_cli(["train-retrieval", *train_args, "--epochs",
                             "2", "--output-dir",
                             os.path.join(tmp, "runs")])
    row3, _ = run_cli(["train-retrieval", *train_args, "--epochs", "3",
                       "--resume-dir", run_dir])
    # the trainer's evaluation after epoch 2 drew from seed + 104729·2
    scored, _ = run_cli(["evaluate", *common, "--run-dir", run_dir,
                         "--seed", str(seed + 104729 * 2)])
    cli_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    add_launches(main_launches, launches)
    ckpts = sorted(os.listdir(os.path.join(run_dir, "ckpt")))
    with open(os.path.join(run_dir, "results.csv")) as f:
        csv_rows = len(f.read().splitlines()) - 1
    tops = [k for k in row3 if k.startswith("top")]
    differ = {k: (scored.get(k), row3[k]) for k in tops
              if scored.get(k) != row3[k]}
    missing = [k for k in ("attention_fwd", "attention_fwd_seed",
                           "attention_bwd", "tsconv_fwd", "tsconv_bwd")
               if not launches[k]]
    row = {"phase": "cli", "epochs": [row2["epoch"], row3["epoch"]],
           "loss": [row2["loss"], row3["loss"]], "checkpoints": ckpts,
           "csv_rows": csv_rows, "evaluate": scored,
           "evaluate_equals_trainer": not differ, "launches": launches,
           "write_tree_s": tree_s, "cli_s": cli_s}
    emit(row)
    if (differ or missing or row2["epoch"] != 1 or row3["epoch"] != 2
            or ckpts != ["2", "3"] or csv_rows != 3 or scored["step"] != 3
            or not np.isfinite([row2["loss"], row3["loss"]]).all()):
        raise RuntimeError(f"cli path: evaluate differs {differ}, kernels "
                           f"not launched {missing}, row {row}")
    return row, run_dir, root, feats


# ——— phase 7: CLIP ViT-H/14 features through cli features, and the export ———

#: the THINGS-EEG test split: 200 concepts, one image each
FEATURE_IMAGES = 200
#: bf16 ViT-H/14 features against the port's fp32 features on the same
#: images: per-row cosine at least this (random weights, 32 layers)
FEATURE_COSINE = 0.99
_NOUNS = ("aardvark", "abacus", "accordion", "acorn", "airplane", "alligator",
          "anchor", "ant", "apple", "apron", "axe", "backpack", "bagel",
          "ball", "balloon", "banana", "bandage", "banjo", "barrel", "basket",
          "bat", "bathtub", "battery", "beachball", "bean", "bear", "bed",
          "bee", "beetle", "bell", "belt", "bench", "bicycle", "binoculars",
          "bird", "blender", "boat", "bone", "book", "boot")
_KINDS = ("red", "small", "old", "wooden", "toy")


def vit_h_flops(images: int) -> float:
    """Multiply-adds × 2 of the ViT-H/14 vision forward: patch embedding,
    32 blocks at 257 tokens × 1280 (qkv, scores, weights × values, out,
    the 4× MLP), the 1280 → 1024 projection."""
    n, w, layers = 257, 1280, 32
    block = 2 * n * w * (3 * w + w + 8 * w) + 4 * n * n * w
    return images * (2 * 256 * 588 * w + layers * block + 2 * w * 1024)


def write_image_tree(root: str, n: int, seed: int) -> None:
    """A THINGS-layout tree of ``n`` concept folders ``<NNNNN_concept>/``,
    one 500 × 500 JPEG each (THINGS' size: decode, bicubic resize and crop
    on the host as for real images), of smooth random content."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i in range(n):
        concept = f"{_KINDS[i // len(_NOUNS)]}_{_NOUNS[i % len(_NOUNS)]}"
        d = os.path.join(root, f"{i + 1:05d}_{concept}")
        os.makedirs(d)
        low = rng.integers(0, 256, size=(10, 10, 3)).astype(np.float32)
        img = np.kron(low, np.ones((50, 50, 1)))
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(d, f"{concept}_01b.jpg"), quality=90)


def features_path(torch, card: str) -> dict:
    """``cli features`` in this process at ViT-H/14 width in bf16 from
    seeded random weights, on a 200-concept THINGS-layout test tree with the
    49,408-id stand-in vocabulary; then the vision tower's rate at batch 20
    and 256 on device tensors, and the bf16 features against the port's
    fp32 towers on the first 20 images."""
    import pickle

    from eeg_image_decode_tpu_torch import cli
    from eeg_image_decode_tpu_torch.data.features import (
        CLIPFeatureEncoder,
        clip_cache_path,
        load_features,
        load_image,
    )
    from eeg_image_decode_tpu_torch.data.synthetic import (
        write_synthetic_clip_vocab,
    )
    from eeg_image_decode_tpu_torch.data.things_eeg import (
        things_images_and_prompts,
    )
    from eeg_image_decode_tpu_torch.data.tokenizers import CLIPBPETokenizer
    from eeg_image_decode_tpu_torch.models.clip_vit import (
        CLIPTextConfig,
        CLIPTextTower,
        CLIPVisionConfig,
        CLIPVisionTower,
        clip_preprocess,
    )
    from eeg_image_decode_tpu_torch.utils.convert_clip import (
        clip_tree_from_state_dict,
    )

    vcfg, tcfg = CLIPVisionConfig.vit_h_14(), CLIPTextConfig.vit_h_14()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_features_") as tmp:
        t0 = time.perf_counter()
        images = os.path.join(tmp, "test_images")
        write_image_tree(images, FEATURE_IMAGES, SEED)
        paths, prompts = things_images_and_prompts(images)
        vocab, merges = write_synthetic_clip_vocab(tmp, prompts)
        tree_s = time.perf_counter() - t0

        # the fp32 towers, drawn on the card from the seed: the weights of
        # the run (as the --clip-params pickle) and its fp32 reference
        t0 = time.perf_counter()
        with torch.device("cuda"):
            vt32 = CLIPVisionTower(vcfg, seed=SEED).eval()
            tt32 = CLIPTextTower(tcfg, seed=SEED + 1).eval()
        params = {"vision": clip_tree_from_state_dict(
                      vt32.state_dict(), "vision", vcfg.heads),
                  "text": clip_tree_from_state_dict(
                      tt32.state_dict(), "text", tcfg.heads)}
        n_vision = sum(int(p.numel()) for p in vt32.parameters())
        n_params = n_vision + sum(int(p.numel()) for p in tt32.parameters())
        pkl = os.path.join(tmp, "clip_vit_h_14.pkl")
        with open(pkl, "wb") as f:
            pickle.dump(params, f, protocol=pickle.HIGHEST_PROTOCOL)
        del params
        weights_write_s = time.perf_counter() - t0
        pkl_gb = os.path.getsize(pkl) / 1e9

        cache_dir = os.path.join(tmp, "cache")
        argv = ["features", "--images-dir", images, "--clip-params", pkl,
                "--vocab", vocab, "--merges", merges, "--cache-dir",
                cache_dir, "--split", "test", "--batch-size", "20",
                "--device", "cuda"]
        args = cli.build_parser().parse_args(argv)
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            enc = args.fn(args)
        cli_s = time.perf_counter() - t0
        peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
        line = json.loads(buf.getvalue().splitlines()[-1])
        os.remove(pkl)
        stats = dict(enc.stats)
        want_cache = clip_cache_path(cache_dir, "test", paths,
                                     model_name="ViT-H-14", normalize_img=True)
        feats = load_features(line["cache"])
        img, txt = feats["img_features"], feats["text_features"]

        # the rates of the bf16 vision tower on device tensors
        vt = enc.vision_tower
        x20 = clip_preprocess(torch.from_numpy(np.stack(
            [load_image(p, vcfg.image_size) for p in paths[:20]])).cuda())
        x256 = x20.repeat(13, 1, 1, 1)[:256]
        with torch.inference_mode():
            ms20 = cuda_ms(torch, lambda: vt(x20), reps=10)
            ms256 = cuda_ms(torch, lambda: vt(x256), reps=3)
            dev_ms20 = device_ms(torch, lambda: vt(x20), reps=3)
            top20 = top_kernels(torch, lambda: vt(x20))

        # bf16 against the port's fp32 towers, the same weights and images
        ref = CLIPFeatureEncoder(vt32, tt32, CLIPBPETokenizer.from_files(
            vocab, merges), device="cuda")
        img32 = ref.encode_images(paths[:20], batch_size=20)
        txt32 = ref.encode_texts(prompts[:20])
        del ref, vt32, tt32, enc, vt, x20, x256
        torch.cuda.empty_cache()

    def cosines(a, b):
        return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                    * np.linalg.norm(b, axis=-1))

    cos_img, cos_txt = cosines(img[:20], img32), cosines(txt[:20], txt32)
    flops200 = vit_h_flops(FEATURE_IMAGES)
    # bytes: the bf16 weights and the fp32 images read once, the features
    # written once
    bound_ms, bound_by = bound(
        flops200, 2 * n_vision + FEATURE_IMAGES * (224 * 224 * 3 + 1024) * 4,
        "bfloat16")
    row = {"phase": "features", "card": card, "dtype": "bfloat16",
           "model": "ViT-H-14 (seeded random weights)", "params": n_params,
           "images": FEATURE_IMAGES,
           "img_shape": line["img_shape"], "text_shape": line["text_shape"],
           "cache_name_matches": line["cache"] == want_cache,
           "write_tree_s": tree_s, "weights_write_s": weights_write_s,
           "weights_pickle_gb": pkl_gb, "cli_s": cli_s,
           "decode_ms_per_image":
               1e3 * sum(stats["decode_s"]) / stats["images"],
           "decode_s": sum(stats["decode_s"]),
           "device_s": sum(stats["device_s"]),
           # host clock around copy in, tower, copy out: the first batch
           # (first launches of cuBLAS, cuDNN, attention) and the others
           "device_ms_first_batch_host_clock": 1e3 * stats["device_s"][0],
           "device_ms_per_batch_host_clock_p50":
               1e3 * float(np.median(stats["device_s"][1:])),
           "cli_rest_s": (cli_s - sum(stats["decode_s"])
                          - sum(stats["device_s"])),
           "vision_ms_b20": ms20, "vision_device_ms_b20": dev_ms20,
           "vision_top_kernels_b20_device_ms": top20,
           "vision_images_per_s_b20": 20e3 / ms20,
           "vision_ms_b256": ms256, "vision_images_per_s_b256": 256e3 / ms256,
           "vision_tflops_b256": vit_h_flops(256) / ms256 / 1e9,
           "bound_ms_200_images": bound_ms, "bound_by": bound_by,
           "device_ms_200_images_b20": ms20 * FEATURE_IMAGES / 20,
           "peak_device_gb_cli": peak_gb,
           "cosine_bound": FEATURE_COSINE,
           "img_cosine_min": float(cos_img.min()),
           "img_cosine_mean": float(cos_img.mean()),
           "text_cosine_min": float(cos_txt.min()),
           "text_cosine_mean": float(cos_txt.mean())}
    emit(row)
    norms = np.concatenate([np.linalg.norm(img, axis=-1),
                            np.linalg.norm(txt, axis=-1)])
    if not (row["cache_name_matches"]
            and img.shape == (FEATURE_IMAGES, 1024)
            and txt.shape == (FEATURE_IMAGES, 1024)
            and np.isfinite(img).all() and np.isfinite(txt).all()
            and np.abs(norms - 1).max() <= 1e-4
            and cos_img.min() >= FEATURE_COSINE
            and cos_txt.min() >= FEATURE_COSINE):
        raise RuntimeError(f"features path: {row}")
    return row


def export_path(torch, run_dir: str, root: str, feats: str,
                main_launches: dict) -> dict:
    """``cli export-checkpoint`` on phase 6's run, the ``.pth`` back through
    ``convert_atms_state_dict``: the same weights, bit for bit, and the
    same top-5 on the tree's test EEG as the restored run served by
    ``cli serve``'s ``build_retrieval``."""
    from eeg_image_decode_tpu_torch import cli
    from eeg_image_decode_tpu_torch.core.config import ATMSConfig
    from eeg_image_decode_tpu_torch.data.features import load_features
    from eeg_image_decode_tpu_torch.data.things_eeg import (
        build_retrieval_data,
    )
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.serve import RetrievalService
    from eeg_image_decode_tpu_torch.utils.convert import (
        convert_atms_state_dict,
    )

    pth = os.path.join(os.path.dirname(run_dir), "atms_reference.pth")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["export-checkpoint", "--run-dir", run_dir, "--out", pth])
    export_s = time.perf_counter() - t0
    ref_sd = torch.load(pth, weights_only=True)
    served = cli.build_retrieval(cli.build_parser().parse_args(
        ["serve", "--run-dir", run_dir, "--features", feats]))
    model = build_encoder("atms", config=ATMSConfig(), dtype=torch.bfloat16,
                          device="cuda")
    model.load_state_dict(convert_atms_state_dict(ref_sd), strict=True)
    imported = RetrievalService(model, load_features(feats)[
        "img_features_test"], device="cuda")
    same_weights = all(
        torch.equal(a, b) for a, b in zip(
            served.model.state_dict().values(), model.state_dict().values()))
    d = load_features(feats)
    test = build_retrieval_data(
        root, ["sub-01"], train=False, img_features=d["img_features_test"],
        text_features=d["text_features_test"])
    _build.reset_launches()
    _, want = served.top_k(test.eeg, test.subject_ids, k=5)
    _, got = imported.top_k(test.eeg, test.subject_ids, k=5)
    launches = dict(_build.LAUNCHES)
    add_launches(main_launches, launches)
    row = {"phase": "export", "tensors": len(ref_sd), "export_s": export_s,
           "same_weights": same_weights, "rows": int(len(want)),
           "top5_equal": bool(np.array_equal(got, want)),
           "launches": launches}
    emit(row)
    missing = [k for k in ("attention_fwd", "tsconv_fwd") if not launches[k]]
    if not (same_weights and row["top5_equal"]) or missing:
        raise RuntimeError(f"export path: kernels not launched {missing}, "
                           f"row {row}")
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from eeg_image_decode_tpu_torch.data.synthetic import (
        make_synthetic_retrieval_data,
    )
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.utils.device import resolve_device

    card = card_line()
    print(card, flush=True)
    resolve_device("cuda")
    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    build_s = time.perf_counter() - t0
    emit({"phase": "setup", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "library": so.name})
    for line in so.with_suffix(".log").read_text().splitlines():
        if ("registers" in line or "properties for" in line
                or line.startswith("==")):
            print("ptxas:", line.strip(), flush=True)

    # the bfloat16 designs of every kernel must run on the tensor cores
    tensor_core = _build.count_sass(("HMMA", "HGMMA"), TENSOR_CORE_KERNELS)
    emit({"phase": "setup", "check": "cuobjdump -sass: HMMA/HGMMA "
          "instructions in the bfloat16 attention, tsconv and projection "
          "kernels", "tensor_core_instructions": tensor_core})
    if not all(tensor_core.values()):
        raise RuntimeError(f"a bfloat16 kernel holds no tensor-core "
                           f"instruction: {tensor_core}")

    kernels = check_kernels(torch)
    kernels.update(check_training_kernels(torch))

    train, test = make_synthetic_retrieval_data(
        n_classes=200, images_per_class=1, train_reps=2, seed=SEED,
        device="cpu")
    # 600 × 63 × 250 request rows; the gallery: 200 × 1024, unit rows
    eeg = np.concatenate([test.eeg.numpy(), train.eeg.numpy()])
    sids = np.random.default_rng(SEED).integers(0, 10, len(eeg)).astype(
        np.int32)
    gallery = test.img_features.numpy()
    serve_rows = [
        serve_path(torch, "default_head", False, eeg, sids, gallery),
        serve_path(torch, "fused_projection", True, eeg, sids, gallery),
    ]

    del train, test, eeg
    t0 = time.perf_counter()
    train, test = make_synthetic_retrieval_data(
        n_classes=1654, n_test_classes=200, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    train_row, trainer = train_path(torch, card, train, test, data_s)
    grad_check(torch, trainer)
    del trainer

    # launches on the main paths: the serving requests, the training epoch
    # and the evaluation, the fused-head joint run and the CLI (each counted
    # from 0). The seeded mask draws are device functions of the seeded
    # forwards and the backwards, not launches.
    main_path = {k: sum(r["launches"][k] for r in serve_rows)
                 + train_row["launches_train"][k]
                 + train_row["launches_eval"][k]
                 for k in _build.LAUNCHES}
    fused_joint_path(torch, card, train, test, train_row["step_ms_p50"],
                     main_path)
    del train, test
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        _, run_dir, root, feats = cli_path(torch, main_path, tmp)
        export_path(torch, run_dir, root, feats, main_path)
    features_path(torch, card)

    line = []
    for name in ("attention_fwd", "attention_fwd_seed", "attention_bwd",
                 "tsconv_fwd", "tsconv_bwd", "projection_fwd",
                 "projection_fwd_seed", "projection_bwd"):
        k = kernels[(name, "bfloat16")]
        if not main_path[name]:
            raise RuntimeError(f"{name} was not launched on the main path")
        line.append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "launches": main_path[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            **{key: k[key] for key in ("design", "device_ms",
                                       "plain_device_ms") if key in k},
        })
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
