"""Encoder registry and the contrastive wrapper (counterpart of
``eeg_image_decode_tpu/models/registry.py``): the ten JAX names, each
mapping (B, C, T) [, subject_ids] → (B, 1024) features, with one shared
trainable temperature."""

from __future__ import annotations

import math

import torch
from torch import nn

from eeg_image_decode_tpu_torch.core.config import ATMSConfig
from eeg_image_decode_tpu_torch.models.atm_e import ATME
from eeg_image_decode_tpu_torch.models.atm_s import ATMS
from eeg_image_decode_tpu_torch.models.baselines import (
    ATCNet,
    EEGConformer,
    EEGITNet,
    MetaEEG,
    MLPProjector,
    ShallowFBCSPNet,
)
from eeg_image_decode_tpu_torch.models.eegnetv4 import EEGNetV4
from eeg_image_decode_tpu_torch.models.layers import LogitScale
from eeg_image_decode_tpu_torch.models.nice import NICE
from eeg_image_decode_tpu_torch.utils.device import resolve_device


class ContrastiveModel(nn.Module):
    """encoder + the raw logit scale (init ln(1/0.07), used without exp).

    ``.train()`` puts the encoder in train mode (dropout, batch statistics);
    ``build_encoder`` returns the model in eval mode. ``dropout_masks`` is
    passed on only when it is given: the mask-injection hook is ATM-S's
    (JAX ``registry.py:38-43``), and a zoo encoder given masks raises."""

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
        kw = {} if dropout_masks is None else {"dropout_masks": dropout_masks}
        feats = self.encoder(x, subject_ids, train=self.training,
                             generator=generator, **kw)
        return feats, self.logit_scale()


def _fan_in(name: str, shape: torch.Size) -> int:
    """A ≥ 3-D kernel's fan-in: flax's for a convolution, (k…, in, out) →
    k…·in; for attention, the width d of q / k / v's (d, heads, head_dim)
    and heads·head_dim of out's (heads, head_dim, d)."""
    if name.rsplit(".", 2)[-2] in ("query", "key", "value"):
        return shape[0]
    return math.prod(shape[:-1])


@torch.no_grad()
def init_random(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights in place, drawn on the CPU from one
    ``torch.Generator`` in parameter order: dense and per-subject value
    kernels N(0, 1/fan_in) (fan-in: the first axis of a 2-D kernel), conv
    and attention kernels of ≥ 3 axes N(0, 1/fan_in) with their true fan-in
    (:func:`_fan_in`), biases N(0, 0.02²), norm scales 1 + N(0, 0.1²),
    subject tokens N(0, 1), BN running means N(0, 0.1²) and variances
    U(0.5, 1.5). Every term of the forward is non-trivial, which a smoke
    run wants; unit-variance kernels keep every encoder's activations
    O(1), so a full-width bf16 training step at batch 1024 stays finite."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("embedding"):
            v = torch.randn(p.shape, generator=g)
        elif leaf in ("kernel", "temporal_conv_kernel") and p.ndim == 2:
            v = torch.randn(p.shape, generator=g) / math.sqrt(p.shape[0])
        elif leaf == "subject_value_w":  # (subjects, d_in, d_out) kernels
            v = torch.randn(p.shape, generator=g) / math.sqrt(p.shape[1])
        elif p.ndim >= 3:  # conv (HWIO, 1-D) and attention kernels
            v = torch.randn(p.shape, generator=g) / math.sqrt(
                _fan_in(name, p.shape))
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


#: the JAX package's encoder names; ATM-S is built from its ``ATMSConfig``,
#: the others from their modules' fields
ENCODERS: dict[str, type[nn.Module]] = {
    "atms": ATMS, "nice": NICE, "eegnetv4": EEGNetV4, "atme": ATME,
    "mlp": MLPProjector, "shallowfbcspnet": ShallowFBCSPNet,
    "eegconformer": EEGConformer, "metaeeg": MetaEEG, "atcnet": ATCNet,
    "eegitnet": EEGITNet,
}

#: encoders whose reference counterpart starts the logit scale at
#: ln(1/0.01) (``contrast_retrieval.py:271,410``)
_SCALE_001 = {"mlp", "metaeeg"}


def encoder_key(name: str) -> str:
    """The registry key of ``name`` (JAX's normalisation: lower case, no
    ``-`` or ``_``); ``KeyError`` for an unknown name."""
    key = name.lower().replace("-", "").replace("_", "")
    if key not in ENCODERS:
        raise KeyError(f"unknown encoder '{name}'; have {sorted(ENCODERS)}")
    return key


def build_encoder(name: str, *, config: ATMSConfig | None = None,
                  dtype: torch.dtype = torch.float32,
                  device: str | torch.device | None = None,
                  seed: int = 0, **kwargs) -> ContrastiveModel:
    """Build an encoder by name, with its logit scale, seeded random weights
    and in eval mode, on ``device`` (default: the CUDA card; raises without
    one — pass ``device="cpu"`` for the CPU). ``config`` is ATM-S's
    (``ATMSConfig``); the other names take their JAX module's fields as
    ``kwargs`` (``build_encoder("nice", proj_dim=64)``)."""
    key = encoder_key(name)
    if config is not None and key != "atms":
        raise TypeError(f"config= is ATM-S's; encoder '{name}' takes its "
                        "fields as keyword arguments")
    dev = resolve_device(device)
    if key == "atms":
        enc = ATMS(config or ATMSConfig(**kwargs), dtype=dtype)
    else:
        enc = ENCODERS[key](dtype=dtype, **kwargs)
    init = math.log(1 / 0.01) if key in _SCALE_001 else 2.6592600225
    return init_random(ContrastiveModel(enc, init), seed).to(dev).eval()
