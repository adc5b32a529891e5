#!/usr/bin/env python3
"""Time the port's CUDA kernels of several checkouts in one run (an A/B).

    python3 scripts/ab_torch_kernels.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout of this repository (unpack the
parent with ``git archive`` into ``_checkout/``, which ``.gitignore``
lists). The roots run in the order given, each in its own process, which
builds that checkout's kernels and prints one JSON line per (root, kernel,
dtype):

- the attention, tsconv and projection forwards at the serving shapes of
  ``chip_smoke.py`` (B 256, full ATM-S width, bf16 and fp32; CUDA events,
  warm, median of 50 launches) beside their max |Δ| from the plain version
  and a SHA-256 of the output's bytes;
- the training kernels at B 1024 (``"phase": "train_digest"``): the
  seeded attention forward, the attention backward (dx and the 16
  gradients), the tsconv forward and backward (dx, dw̃), and the projection
  forward in seed and mask mode and its backward (dx and the six
  gradients), each through the wrappers and ``torch.autograd.grad`` as a
  step runs it, with a SHA-256 of each output, the forwards' max |Δ| from
  their plain versions, and the forwards' event and device times
  (``chip_smoke.device_ms``, a ``torch.profiler`` trace).

The inputs come from one seed, so two checkouts whose digests agree compute
that kernel bit for bit alike. Compare two versions only within one run:
interleave them, as above.
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
root = sys.argv[1]


def sha(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def emit(**row):
    print(json.dumps({"root": root, **row}), flush=True)


for name, (_, _, make) in cs.kernel_cases(torch).items():
    for dt in (torch.bfloat16, torch.float32):
        kern, plain, _, _, _ = make(dt)
        out = kern()
        err = (out.float() - plain().float()).abs().max().item()
        emit(name=name, dtype=str(dt).split(".")[-1], max_abs_err=err,
             sha256=sha(out), ms=cs.cuda_ms(torch, kern, 50))

from eeg_image_decode_tpu_torch.ops.attention import (
    PARAM_ORDER as ATTN, fused_attention_layer)
from eeg_image_decode_tpu_torch.ops.projection import (
    PARAM_ORDER as PROJ, draw_keep_mask, fused_projection_head,
    projection_head_reference)
from eeg_image_decode_tpu_torch.ops.tsconv import (
    fold_pool_into_kernel, out_positions, tsconv_pool_fused,
    tsconv_pool_reference)

B = cs.TRAIN_BATCH
for dt in (torch.bfloat16, torch.float32):
    dname = str(dt).split(".")[-1]
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 40)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    def timed(fn):
        return {"ms": cs.cuda_ms(torch, fn), "device_ms": cs.device_ms(torch, fn)}

    seed = torch.tensor([cs.SEED % (2**31 - 1)], dtype=torch.int32,
                        device="cuda")
    x, p, gout = cs.attention_case(torch, dt, B, cs.SEED + 41)
    x.requires_grad_()
    p = {k: v.requires_grad_() for k, v in p.items()}
    out = fused_attention_layer(x, p, cs.HEADS, dropout_p=0.25, seed=seed)
    emit(phase="train_digest", name="attention_fwd_seed", dtype=dname,
         sha256=sha(out))
    grads = torch.autograd.grad(out, [x, *[p[k] for k in ATTN]], gout)
    emit(phase="train_digest", name="attention_bwd", dtype=dname,
         sha256=sha(*grads), sha256_dx=sha(grads[0]))
    del x, p, gout, out, grads

    w = fold_pool_into_kernel(randn(25, 40, scale=0.2), 51).to(dt)
    xt = randn(B, 63, 250).to(dt)
    n_pos = out_positions(250, w.shape[0], 5)
    out = tsconv_pool_fused(xt, w, 5)
    err = (out.float() - tsconv_pool_reference(xt, w, 5).float()).abs().max()
    emit(phase="train_digest", name="tsconv_fwd", dtype=dname,
         sha256=sha(out), max_abs_err=err.item(),
         **timed(lambda: tsconv_pool_fused(xt, w, 5)))
    xg, wg = xt.requires_grad_(), w.requires_grad_()
    gt = randn(B, 63, n_pos, 40).to(dt)
    grads = torch.autograd.grad(tsconv_pool_fused(xg, wg, 5), [xg, wg], gt)
    emit(phase="train_digest", name="tsconv_bwd", dtype=dname,
         sha256=sha(*grads), sha256_dx=sha(grads[0]))
    del xt, xg, gt, out, grads

    p = {"wi": randn(1440, 1024, scale=1440 ** -0.5),
         "bi": randn(1024, scale=0.1),
         "wr": randn(1024, 1024, scale=1024 ** -0.5),
         "br": randn(1024, scale=0.1),
         "ln_s": randn(1024, scale=0.1, shift=1.0),
         "ln_b": randn(1024, scale=0.1)}
    p = {k: v.to(dt).requires_grad_() for k, v in p.items()}
    xh = randn(B, 1440).to(dt).requires_grad_()
    gh = randn(B, 1024)
    mask = ((torch.rand(B, 1024, generator=g, device="cuda") >= 0.5).float()
            * 2.0).to(dt)
    drawn = draw_keep_mask(int(seed), B, 1024, 0.5, device="cuda")
    with torch.no_grad():
        for mode, args, plain_mask in (("seed", (None, 0.5, seed), drawn),
                                       ("masks", (mask,), mask)):
            out = fused_projection_head(xh, p, *args)
            err = (out - projection_head_reference(xh, p, plain_mask)).abs()
            emit(phase="train_digest", name=f"projection_fwd_{mode}",
                 dtype=dname, sha256=sha(out), max_abs_err=err.max().item(),
                 **timed(lambda: fused_projection_head(xh, p, *args)))
    out = fused_projection_head(xh, p, None, 0.5, seed)
    grads = torch.autograd.grad(out, [xh, *[p[k] for k in PROJ]], gh)
    emit(phase="train_digest", name="projection_bwd", dtype=dname,
         sha256=sha(*grads), sha256_dx=sha(grads[0]))
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
