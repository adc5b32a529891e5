"""Low-level encoder: EEG → SDXL VAE latents (counterpart of
``eeg_image_decode_tpu/models/lowlevel.py``; ref ``encoder_low_level``,
``Generation/train_vae_latent_512_low_level_no_average.py:219-260``).

A Linear 250 → 128 over the time axis, the (63·128) = 8064 features as a
1 × 1 map, six ConvTranspose k 4 s 2 stages (flax SAME ≡ torch
``padding=1``: exactly 2×) with BatchNorm + ReLU, a 1 × 1 convolution to 16
with BatchNorm + ReLU, and a 1 × 1 to the 4 latent channels: (4, 64, 64).

The port computes in NCHW with PyTorch's convolutions (the JAX module is
NHWC; the first stage, on its 1 × 1 input, is one product with the
kernel's central taps); :meth:`EncoderLowLevel.forward` returns NCHW, and
the trainer's
``predict`` and every file keep the JAX layouts (``utils/convert.py``).
Plain PyTorch, as the JAX module is plain XLA: no TPU kernel lies here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eeg_image_decode_tpu_torch.models.layers import Dense, lecun_normal_
from eeg_image_decode_tpu_torch.parallel.collectives import (
    active_mesh,
    global_mean,
)


class TwoPassBatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5, use_fast_variance=False)``
    over the channel axis of an NCHW tensor, in fp32.

    Train: the batch mean, then the biased variance E[(x − μ)²] (two
    passes, as torch's BatchNorm; the fast E[x²] − μ² loses up to ~1e-4 of
    the variance to cancellation after deep ConvTranspose chains), and the
    running statistics move to 0.9·old + 0.1·batch. Eval: the running
    statistics. Neither ``torch.nn.BatchNorm2d`` (unbiased running
    variance, momentum 0.1 on the new value) nor the ATM-S
    ``models/layers.py::BatchNorm`` (fast variance, last axis) is this.
    In a data-parallel scope both passes are over the global batch
    (``parallel/collectives.py::global_mean``), as flax's are under GSPMD."""

    momentum = 0.9

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            mesh = active_mesh()
            if mesh is None:
                mean = x.mean((0, 2, 3))
                var = torch.square(x - mean[None, :, None, None]).mean(
                    (0, 2, 3))
            else:
                mean = global_mean(x, mesh, (0, 2, 3))
                var = global_mean(torch.square(x - mean[None, :, None, None]),
                                  mesh, (0, 2, 3))
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + 1e-5) * self.scale
        return ((x - mean[None, :, None, None]) * mul[None, :, None, None]
                + self.bias[None, :, None, None])


class _Conv(nn.Module):
    """A convolution's ``kernel`` in PyTorch's layout and its ``bias``."""

    def __init__(self, shape: tuple[int, ...], out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(out))


class EncoderLowLevel(nn.Module):
    def __init__(self, n_channels: int = 63, seq_len: int = 250,
                 time_proj_dim: int = 128, latent_channels: int = 4,
                 stage_channels: tuple[int, ...] = (1024, 512, 256, 128, 64,
                                                    32)):
        super().__init__()
        self.n_channels = n_channels
        self.time_proj_dim = time_proj_dim
        self.stage_channels = tuple(stage_channels)
        self.subject_linear = Dense(seq_len, time_proj_dim)
        ch_in = n_channels * time_proj_dim
        for i, ch in enumerate(self.stage_channels):
            # F.conv_transpose2d's (in, out, kh, kw)
            self.add_module(f"up_{i}", _Conv((ch_in, ch, 4, 4), ch))
            self.add_module(f"bn_{i}", TwoPassBatchNorm(ch))
            ch_in = ch
        self.proj_16 = _Conv((16, ch_in, 1, 1), 16)  # F.conv2d's layout
        self.bn_proj = TwoPassBatchNorm(16)
        self.proj_out = _Conv((latent_channels, 16, 1, 1), latent_channels)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> "EncoderLowLevel":
        """flax's default initialisation, drawn on the CPU from one
        ``torch.Generator`` seeded with ``seed``: kernels ``lecun_normal``
        with flax's fan-in (in · kh · kw), biases 0, BatchNorm scale 1,
        bias 0, statistics 0 and 1."""
        g = torch.Generator().manual_seed(int(seed))
        for name, p in self.named_parameters():
            mod, leaf = name.rsplit(".", 1)
            if leaf == "kernel":
                shape = p.shape
                fan_in = (shape[0] if mod == "subject_linear"
                          else shape[0] * shape[2] * shape[3]
                          if mod.startswith("up_") else shape[1])
                v = lecun_normal_(torch.empty(shape), fan_in, g)
            elif leaf == "scale":
                v = torch.ones(p.shape)
            else:
                v = torch.zeros(p.shape)
            p.copy_(v)
        for name, b in self.named_buffers():
            b.fill_(0.0 if name.endswith(".mean") else 1.0)
        return self

    def forward(self, x: torch.Tensor, subject_ids=None, *,
                train: bool = False) -> torch.Tensor:
        """(B, C, T) EEG → (B, latent_channels, 64, 64) NCHW in the
        parameters' dtype (fp32; a float64 copy is the exact reference of
        the card test). In train mode the BatchNorms use the batch
        statistics and update their running ones. ``subject_ids`` is
        unused: the reference always indexes subject 0 (``:258``)."""
        del subject_ids
        h = self.subject_linear(x.to(self.subject_linear.kernel.dtype))
        b = h.shape[0]
        # up_0 on its 1 × 1 input: output pixel (a, c) of a k 4, s 2, p 1
        # transposed convolution takes tap (a + 1, c + 1) alone, so the stage
        # is one product with the kernel's central 2 × 2 taps (cuDNN's
        # transposed convolution of this shape takes ~15 ms on the H100)
        up = self.up_0
        w = up.kernel[:, :, 1:3, 1:3]
        h = (h.reshape(b, -1) @ w.reshape(w.shape[0], -1)).reshape(
            b, w.shape[1], 2, 2) + up.bias[None, :, None, None]
        h = F.relu(self.bn_0(h, train))
        for i in range(1, len(self.stage_channels)):
            up = getattr(self, f"up_{i}")
            h = F.conv_transpose2d(h, up.kernel, up.bias, stride=2,
                                   padding=1)
            h = F.relu(getattr(self, f"bn_{i}")(h, train))
        h = F.conv2d(h, self.proj_16.kernel, self.proj_16.bias)
        h = F.relu(self.bn_proj(h, train))
        return F.conv2d(h, self.proj_out.kernel, self.proj_out.bias)


# ——— the reference's ``encoder_low_level`` layout ———

_UP_INDEX = (0, 3, 6, 9, 12, 15)


def convert_encoder_low_level(sd: dict) -> dict[str, torch.Tensor]:
    """Reference ``encoder_low_level`` state dict (tensors or numpy) → the
    port's :class:`EncoderLowLevel` ``state_dict`` (fp32), loaded with
    ``strict=True``.

    Torch layout (ref ``train_vae_latent_512_low_level_no_average.py:
    219-251``): ``subject_wise_linear.0`` Linear(250 → 128);
    ``upsampler.{0,3,6,9,12,15}`` ConvTranspose2d(k 4, s 2, p 1) with
    BatchNorm2d at ``{1,4,7,10,13,16}``; ``upsampler.18``
    ConvTranspose2d(32 → 16, k 1) + BN at ``.19``; ``upsampler.21``
    ConvTranspose2d(16 → 4, k 1). The port runs the reference's own
    transposed convolutions, so their weights keep their layout; a 1 × 1
    ConvTranspose2d's (in, out, 1, 1) is the 1 × 1 Conv2d's (out, in, 1, 1)
    transposed."""
    sd = {k: (v.detach().cpu().float().numpy() if torch.is_tensor(v)
              else np.asarray(v, np.float32)) for k, v in sd.items()}
    out = {"subject_linear.kernel": sd["subject_wise_linear.0.weight"].T,
           "subject_linear.bias": sd["subject_wise_linear.0.bias"]}

    def bn(ours, ref):
        out[f"{ours}.scale"] = sd[f"{ref}.weight"]
        out[f"{ours}.bias"] = sd[f"{ref}.bias"]
        out[f"{ours}.mean"] = sd[f"{ref}.running_mean"]
        out[f"{ours}.var"] = sd[f"{ref}.running_var"]

    for i, idx in enumerate(_UP_INDEX):
        out[f"up_{i}.kernel"] = sd[f"upsampler.{idx}.weight"]
        out[f"up_{i}.bias"] = sd[f"upsampler.{idx}.bias"]
        bn(f"bn_{i}", f"upsampler.{idx + 1}")
    for ours, idx in (("proj_16", 18), ("proj_out", 21)):
        out[f"{ours}.kernel"] = np.transpose(sd[f"upsampler.{idx}.weight"],
                                             (1, 0, 2, 3))
        out[f"{ours}.bias"] = sd[f"upsampler.{idx}.bias"]
    bn("bn_proj", "upsampler.19")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}


def export_encoder_low_level(state_dict: dict) -> dict[str, np.ndarray]:
    """The port's :class:`EncoderLowLevel` ``state_dict`` → the reference
    ``encoder_low_level`` layout (numpy values): the exact inverse of
    :func:`convert_encoder_low_level`, so an encoder trained here loads
    into the reference module with ``load_state_dict`` (strict). The
    reference registers a ``logit_scale`` its low-level loss never touches
    (``:224``); it is written at its ln(1/0.07) init, and each BatchNorm's
    ``num_batches_tracked`` as 0."""
    p = {k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
         for k, v in state_dict.items()}
    sd: dict = {"logit_scale": np.asarray(np.log(1.0 / 0.07), np.float32)}
    sd["subject_wise_linear.0.weight"] = np.ascontiguousarray(
        p["subject_linear.kernel"].T)
    sd["subject_wise_linear.0.bias"] = np.asarray(p["subject_linear.bias"])

    def bn(name, ours):
        sd[f"{name}.weight"] = np.asarray(p[f"{ours}.scale"])
        sd[f"{name}.bias"] = np.asarray(p[f"{ours}.bias"])
        sd[f"{name}.running_mean"] = np.asarray(p[f"{ours}.mean"])
        sd[f"{name}.running_var"] = np.asarray(p[f"{ours}.var"])
        sd[f"{name}.num_batches_tracked"] = np.asarray(0, np.int64)

    for i, idx in enumerate(_UP_INDEX):
        sd[f"upsampler.{idx}.weight"] = np.ascontiguousarray(
            p[f"up_{i}.kernel"])
        sd[f"upsampler.{idx}.bias"] = np.asarray(p[f"up_{i}.bias"])
        bn(f"upsampler.{idx + 1}", f"bn_{i}")
    for ours, idx in (("proj_16", 18), ("proj_out", 21)):
        sd[f"upsampler.{idx}.weight"] = np.ascontiguousarray(
            np.transpose(p[f"{ours}.kernel"], (1, 0, 2, 3)))
        sd[f"upsampler.{idx}.bias"] = np.asarray(p[f"{ours}.bias"])
    bn("upsampler.19", "bn_proj")
    return sd
