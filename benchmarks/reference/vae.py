"""The benchmark's frozen plain copy of the port's ``gen/vae.py``.

SDXL VAE, encoder and decoder (counterpart of
``eeg_image_decode_tpu/gen/vae.py``).

The reference uses the frozen diffusers SDXL VAE to decode generated
latents to pixels (``custom_pipeline.py:413-434``), to encode low-level
init images for img2img (``custom_pipeline_low_level.py``), and to make the
cached (4, 64, 64) latent targets of the low-level pipeline
(``Generation/train_vae_latent_512_low_level_no_average.py:309-323``).

NCHW, with diffusers' ``AutoencoderKL`` names (``encoder.down_blocks.{i}
.resnets.{j}``, ``…downsamplers.0.conv``, ``encoder.mid_block.attentions.0
.group_norm``, ``quant_conv``, …), so its state dict loads with
``load_state_dict``. As in the JAX module (flax's default), every GroupNorm
has eps 1e-6 (torch's default is 1e-5); each encoder downsample pads
((0, 1), (0, 1)) and then convolves at stride 2 with no padding; the mid
attention is single-head, its scores fp32 products divided by √C (√512 at
SDXL width, not a power of two), the probabilities cast to the working
dtype for the second product, written out here as the JAX einsums are.
Norms and SiLU in fp32, the cast to the working dtype at each conv or
dense layer, the decoder's output in fp32. Latents are scaled by
``scaling_factor`` (SDXL: 0.13025) as diffusers does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from benchmarks.reference.unet import _norm, group_norm_f32

GN_EPS = 1e-6


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.13025
    use_mid_attention: bool = True

    @staticmethod
    def sdxl() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                         norm_groups=4, use_mid_attention=False)


class _ResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, norm_groups: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm1 = _norm(nn.GroupNorm, norm_groups, in_channels, eps=GN_EPS)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                               dtype=dtype)
        self.norm2 = _norm(nn.GroupNorm, norm_groups, out_channels,
                           eps=GN_EPS)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                               dtype=dtype)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1,
                                           dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = self.conv1(F.silu(group_norm_f32(x, self.norm1)).to(dt))
        h = self.conv2(F.silu(group_norm_f32(h, self.norm2)).to(dt))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class _MidAttention(nn.Module):
    def __init__(self, channels: int, norm_groups: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.group_norm = _norm(nn.GroupNorm, norm_groups, channels,
                                eps=GN_EPS)
        self.to_q = nn.Linear(channels, channels, dtype=dtype)
        self.to_k = nn.Linear(channels, channels, dtype=dtype)
        self.to_v = nn.Linear(channels, channels, dtype=dtype)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels,
                                               dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = group_norm_f32(x, self.group_norm).to(self.dtype)
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        # fp32 products of the working-dtype q and k, as
        # preferred_element_type=float32 computes them
        scores = torch.bmm(q.float(), k.float().transpose(1, 2))
        probs = torch.softmax(scores / torch.sqrt(torch.tensor(
            float(C), dtype=torch.float32)), dim=-1)
        out = torch.bmm(probs.to(self.dtype), v)
        out = self.to_out[0](out)
        return x + out.view(B, H, W, C).permute(0, 3, 1, 2)


class _Resample(nn.Module):
    """``downsamplers.0``: pad (0, 1, 0, 1), 3×3 at stride 2, no padding
    (diffusers ``Downsample2D``); ``upsamplers.0``: nearest 2×, 3×3."""

    def __init__(self, channels: int, up: bool, dtype: torch.dtype):
        super().__init__()
        self.up = up
        self.conv = nn.Conv2d(channels, channels, 3, stride=1 if up else 2,
                              padding=1 if up else 0, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.up:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        else:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class _Stage(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


def _mid_block(ch: int, cfg: VAEConfig, dtype: torch.dtype) -> _Stage:
    mid = _Stage()
    mid.resnets.extend([_ResBlock(ch, ch, cfg.norm_groups, dtype),
                        _ResBlock(ch, ch, cfg.norm_groups, dtype)])
    if cfg.use_mid_attention:
        mid.attentions.append(_MidAttention(ch, cfg.norm_groups, dtype))
    return mid


def _run_mid(mid: _Stage, h: torch.Tensor) -> torch.Tensor:
    h = mid.resnets[0](h)
    if len(mid.attentions):
        h = mid.attentions[0](h)
    return mid.resnets[1](h)


class VAEEncoder(nn.Module):
    def __init__(self, config: VAEConfig, dtype: torch.dtype):
        super().__init__()
        cfg, self.dtype = config, dtype
        chs = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1,
                                 dtype=dtype)
        self.down_blocks = nn.ModuleList()
        ch_in = chs[0]
        for i, ch in enumerate(chs):
            blk = _Stage()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(_ResBlock(ch_in, ch, cfg.norm_groups,
                                             dtype))
                ch_in = ch
            if i < len(chs) - 1:
                blk.downsamplers = nn.ModuleList([_Resample(ch, False, dtype)])
            self.down_blocks.append(blk)
        self.mid_block = _mid_block(chs[-1], cfg, dtype)
        self.conv_norm_out = _norm(nn.GroupNorm, cfg.norm_groups, chs[-1],
                                   eps=GN_EPS)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.latent_channels, 3,
                                  padding=1, dtype=dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) in [-1, 1] → the moments (B, 2·latent, h, w),
        mean ‖ logvar, in the working dtype."""
        h = self.conv_in(images.to(self.dtype))
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        h = _run_mid(self.mid_block, h)
        h = F.silu(group_norm_f32(h, self.conv_norm_out)).to(self.dtype)
        return self.conv_out(h)


class VAEDecoder(nn.Module):
    def __init__(self, config: VAEConfig, dtype: torch.dtype):
        super().__init__()
        cfg, self.dtype = config, dtype
        chs = cfg.block_out_channels
        ch_in = chs[-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch_in, 3, padding=1,
                                 dtype=dtype)
        self.mid_block = _mid_block(ch_in, cfg, dtype)
        self.up_blocks = nn.ModuleList()
        for i, ch in enumerate(reversed(chs)):
            blk = _Stage()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(_ResBlock(ch_in, ch, cfg.norm_groups,
                                             dtype))
                ch_in = ch
            if i < len(chs) - 1:
                blk.upsamplers = nn.ModuleList([_Resample(ch, True, dtype)])
            self.up_blocks.append(blk)
        self.conv_norm_out = _norm(nn.GroupNorm, cfg.norm_groups, chs[0],
                                   eps=GN_EPS)
        self.conv_out = nn.Conv2d(chs[0], cfg.in_channels, 3, padding=1,
                                  dtype=dtype)

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, latent, h, w) → (B, 3, H, W) in [-1, 1], fp32."""
        h = self.conv_in(latents.to(self.dtype))
        h = _run_mid(self.mid_block, h)
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        h = F.silu(group_norm_f32(h, self.conv_norm_out)).to(self.dtype)
        return self.conv_out(h).float()


class VAE(nn.Module):
    """encode/decode pair with diffusers' latent scaling convention."""

    def __init__(self, config: VAEConfig = VAEConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config, self.dtype = config, dtype
        lc = config.latent_channels
        self.encoder = VAEEncoder(config, dtype)
        self.decoder = VAEDecoder(config, dtype)
        self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1, dtype=dtype)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1, dtype=dtype)

    def encode(self, images: torch.Tensor,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, 3, H, W) in [-1, 1] → scaled latents (B, 4, H/f, W/f): the
        distribution's mean × scale, or with ``generator`` a sample drawn
        from it (in the working dtype)."""
        moments = self.quant_conv(self.encoder(images))
        mean, logvar = moments.chunk(2, dim=1)
        if generator is not None:
            eps = torch.randn(mean.shape, generator=generator,
                              device=mean.device)
            mean = mean + torch.exp(0.5 * torch.clamp(logvar, -30, 20)) * eps
        return mean * self.config.scaling_factor

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents → (B, 3, H, W) in [-1, 1], fp32."""
        z = latents / self.config.scaling_factor
        return self.decoder(self.post_quant_conv(z.to(self.dtype)))
