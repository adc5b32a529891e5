"""Encoder registry and the contrastive wrapper (counterpart of
``eeg_image_decode_tpu/models/registry.py``). Only ATM-S is ported so far."""

from __future__ import annotations

import math

import torch
from torch import nn

from eeg_image_decode_tpu_torch.core.config import ATMSConfig
from eeg_image_decode_tpu_torch.models.atm_s import ATMS
from eeg_image_decode_tpu_torch.models.layers import LogitScale
from eeg_image_decode_tpu_torch.utils.device import resolve_device


class ContrastiveModel(nn.Module):
    """encoder + the raw logit scale (init ln(1/0.07), used without exp).

    ``.train()`` puts the encoder in train mode (dropout, batch statistics);
    ``build_encoder`` returns the model in eval mode."""

    def __init__(self, encoder: nn.Module,
                 logit_scale_init: float = 2.6592600225):
        super().__init__()
        self.encoder = encoder
        self.logit_scale = LogitScale(logit_scale_init)

    def forward(self, x: torch.Tensor,
                subject_ids: torch.Tensor | None = None, *,
                dropout_masks: dict | None = None,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        feats = self.encoder(x, subject_ids, train=self.training,
                             dropout_masks=dropout_masks, generator=generator)
        return feats, self.logit_scale()


@torch.no_grad()
def init_random(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights in place, drawn on the CPU from one
    ``torch.Generator`` in parameter order: dense, conv and per-subject
    value kernels N(0, 1/fan_in), biases N(0, 0.02²), norm scales 1 + N(0, 0.1²), subject
    tokens N(0, 1), BN running means N(0, 0.1²) and variances U(0.5, 1.5).
    Every term of the forward is non-trivial, which a smoke run wants."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("embedding"):
            v = torch.randn(p.shape, generator=g)
        elif leaf in ("kernel", "temporal_conv_kernel"):
            v = torch.randn(p.shape, generator=g) / math.sqrt(p.shape[0])
        elif leaf == "subject_value_w":  # (subjects, d_in, d_out) kernels
            v = torch.randn(p.shape, generator=g) / math.sqrt(p.shape[1])
        elif leaf == "scale":
            v = 1.0 + 0.1 * torch.randn(p.shape, generator=g)
        elif leaf == "logit_scale":
            continue
        else:  # biases
            v = 0.02 * torch.randn(p.shape, generator=g)
        p.copy_(v)
    for name, b in model.named_buffers():
        if name.endswith(".mean"):
            b.copy_(0.1 * torch.randn(b.shape, generator=g))
        elif name.endswith(".var"):
            b.copy_(0.5 + torch.rand(b.shape, generator=g))
    return model


def build_encoder(name: str, *, config: ATMSConfig = ATMSConfig(),
                  dtype: torch.dtype = torch.float32,
                  device: str | torch.device | None = None,
                  seed: int = 0) -> ContrastiveModel:
    """Build an encoder by name, with its logit scale, seeded random weights
    and in eval mode, on ``device`` (default: the CUDA card; raises without
    one — pass ``device="cpu"`` for the CPU)."""
    key = name.lower().replace("-", "").replace("_", "")
    if key != "atms":
        raise NotImplementedError(
            f"encoder '{name}' is not ported yet; only 'atms' is "
            "(see ROADMAP.md)")
    dev = resolve_device(device)
    model = ContrastiveModel(ATMS(config, dtype=dtype))
    return init_random(model, seed).to(dev).eval()
