"""EEGNetV4 (counterpart of ``eeg_image_decode_tpu/models/eegnetv4.py``;
EEGNet v4, Lawhern et al. 2018, with the reference's braindecode
hyperparameters F1 = 8, D = 20, F2 = 160, kernel 4, mean pooling, dropout
0.25, ``Retrieval/contrast_retrieval.py:122-147``):

    (B, 63, 250) → (B, 1, 63, 250) NCHW
    → temporal conv (1, 4), padding 2 each side (251 samples) → BN
    → depthwise spatial conv (63, 1), groups 8 → 160, max-norm 1 → BN → ELU
    → avg-pool (1, 4) → dropout
    → separable conv: depthwise (1, 16) padding 8, pointwise → 160 → BN → ELU
    → avg-pool (1, 8) → dropout
    → final conv over the 7 remaining samples → (B, out_dim)

Kernels keep flax's HWIO layout (``layers.conv``); grouped output channels
are group-major in both. The depthwise spatial conv runs as a batched
product over the 63 taps (``layers.electrode_conv``). BatchNorm: momentum 0.99, eps 1e-3, fp32 out
(flax ``BatchNorm(dtype=jnp.float32)``). Plain PyTorch: JAX leaves it to
XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from eeg_image_decode_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    conv,
    dropout,
    electrode_conv,
)


def max_norm(w: torch.Tensor, limit: float, dims: tuple[int, ...]
             ) -> torch.Tensor:
    """The kernel projected onto the L2 ball of radius ``limit`` per output
    filter (JAX ``_max_norm``), inside the forward with the gradient
    flowing through it, not braindecode's in-place renorm."""
    norm = torch.sqrt(torch.sum(w * w, dim=dims, keepdim=True))
    return w * torch.clamp(limit / torch.clamp(norm, min=1e-12), max=1.0)


class EEGNetV4(nn.Module):
    def __init__(self, n_channels: int = 63, n_times: int = 250,
                 out_dim: int = 1024, f1: int = 8, depth_mult: int = 20,
                 f2: int = 160, kernel_length: int = 4,
                 sep_kernel_length: int = 16, pool1: int = 4, pool2: int = 8,
                 dropout: float = 0.25, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.f1, self.pool1, self.pool2 = f1, pool1, pool2
        ch = f1 * depth_mult
        pad = kernel_length // 2
        sep_pad = sep_kernel_length // 2
        self.sep_pad = sep_pad

        def bn(c):
            return BatchNorm(c, momentum=0.99, eps=1e-3)

        self.temporal_conv = Conv(1, f1, (1, kernel_length),
                                  padding=((0, 0), (pad, pad)),
                                  use_bias=False)
        self.bn1 = bn(f1)
        self.spatial_depthwise_kernel = nn.Parameter(
            torch.zeros(n_channels, 1, 1, ch))
        self.bn2 = bn(ch)
        self.sep_depthwise_kernel = nn.Parameter(
            torch.zeros(1, sep_kernel_length, 1, ch))
        self.pointwise_conv = Conv(ch, f2, (1, 1), use_bias=False)
        self.bn3 = bn(f2)
        t = (n_times + 2 * pad - kernel_length + 1) // pool1
        t_rem = (t + 2 * sep_pad - sep_kernel_length + 1) // pool2
        self.final_conv = Conv(f2, out_dim, (1, t_rem))

    def forward(self, x: torch.Tensor,
                subject_ids: torch.Tensor | None = None, *,
                train: bool | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        del subject_ids
        train = self.training if train is None else train
        dt, f32 = self.dtype, torch.float32
        kw = dict(train=train, generator=generator)
        h = x[:, None].to(dt)                                # (B, 1, C, T)
        h = self.temporal_conv(h, dt)
        h = self.bn1(h, train, axis=1, dtype=f32)
        w = max_norm(self.spatial_depthwise_kernel, 1.0, (0, 1, 2))
        h = electrode_conv(h, w, dt)                         # (B, 160, 1, T)
        h = F.elu(self.bn2(h, train, axis=1, dtype=f32))
        h = F.avg_pool2d(h, (1, self.pool1))
        h = dropout(h, self.dropout, **kw)
        ch = self.sep_depthwise_kernel.shape[-1]
        h = conv(h, self.sep_depthwise_kernel, dt,
                 padding=((0, 0), (self.sep_pad, self.sep_pad)), groups=ch)
        h = self.pointwise_conv(h, dt)
        h = F.elu(self.bn3(h, train, axis=1, dtype=f32))
        h = F.avg_pool2d(h, (1, self.pool2))
        h = dropout(h, self.dropout, **kw)
        h = self.final_conv(h, dt)                           # (B, out, 1, 1)
        return h.reshape(h.shape[0], -1)
