"""Tensor-parallel SDXL UNet over the mesh's ``mp`` group (counterpart of
``eeg_image_decode_tpu/gen/sharding.py``), for inference.

The JAX rule is shape-driven: every kernel whose output-feature axis the mp
size divides is split along it (Megatron-style column parallelism), the rest
is replicated, and the batch splits over ``dp``. Here each rank keeps its
column block of every such ``nn.Linear`` / ``nn.Conv2d`` (the rows of the
weight, and of the bias) and all-gathers the layer's output along the
channel axis (dim 1 of an NCHW convolution, the last of a linear) before
the next layer reads it. So a rank holds 1/mp of those weights, computes
1/mp of each product, and every other op sees the full activations, as the
unsharded forward does.
"""

from __future__ import annotations

import torch
from torch import nn

from eeg_image_decode_tpu_torch.parallel.collectives import all_gather_rows


def param_sharding_rules(mesh, module: nn.Module) -> dict[str, bool]:
    """Module name → whether its weight is split over mp: every
    ``nn.Linear`` / ``nn.Conv2d`` whose output features mp divides (the
    JAX rule: the kernel's last axis divisible and at least mp)."""
    size = mesh.mp
    return {name: m.weight.shape[0] % size == 0 and m.weight.shape[0] >= size
            for name, m in module.named_modules()
            if isinstance(m, (nn.Linear, nn.Conv2d))}


def shard_params(mesh, module: nn.Module) -> nn.Module:
    """Split ``module``'s layers in place by :func:`param_sharding_rules`:
    each keeps block ``mp_rank`` of its output features and gathers its
    output over the mp group. Returns the module."""
    rules = param_sharding_rules(mesh, module)
    modules = dict(module.named_modules())
    for name, split in rules.items():
        if not split:
            continue
        m = modules[name]
        n = m.weight.shape[0] // mesh.mp
        rows = slice(mesh.mp_rank * n, (mesh.mp_rank + 1) * n)
        with torch.no_grad():
            m.weight = nn.Parameter(m.weight[rows].clone(),
                                    requires_grad=False)
            if m.bias is not None:
                m.bias = nn.Parameter(m.bias[rows].clone(),
                                      requires_grad=False)
        if isinstance(m, nn.Linear):
            m.out_features = n
        else:
            m.out_channels = n
        dim = -1 if isinstance(m, nn.Linear) else 1
        m.register_forward_hook(
            lambda _m, _inp, out, dim=dim: all_gather_rows(
                out, mesh.mp_group, dim))
    return module


def sharded_unet_apply(unet: nn.Module, mesh):
    """The forward of a :func:`shard_params` UNet over the global batch:
    each dp row of ranks takes its B/dp rows, runs the tensor-parallel
    forward, and the outputs are gathered over dp, so every rank returns
    the whole (B, C, H, W) batch, as the JAX function returns the global
    array."""

    @torch.no_grad()
    def forward(latents, t, ctx, image_embeds=None):
        rows = mesh.rows(latents.shape[0])
        out = unet(latents[rows], t[rows], ctx[rows], None, None,
                   None if image_embeds is None else image_embeds[rows])
        return all_gather_rows(out, mesh.dp_group)

    return forward
