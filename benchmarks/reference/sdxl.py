"""The reconstruction chain in plain PyTorch, float32: the ATM-S eval
forward (:mod:`benchmarks.reference.atms`) → the prior's guided sampling
(:mod:`benchmarks.reference.prior`) → SDXL-turbo's Euler-ancestral steps
through the UNet with the IP-Adapter (:mod:`benchmarks.reference.unet`) →
the VAE decode (:mod:`benchmarks.reference.vae`) → images (B, H, W, 3) in
[0, 1] (ref ``Generation/custom_pipeline.py:319-324,456-492``).

Guidance 0 runs the conditional branch alone; the text conditioning is
zeros, as a run without text towers gives it. Each row's draws are keyed
by its (seed, row) pair, as the program keys them.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmarks.reference import atms
from benchmarks.reference.euler import EulerDiscreteSchedule
from benchmarks.reference.prior import (
    PRIOR_DOMAIN,
    SDXL_DOMAIN,
    DDPMSampler,
    DiffusionPriorUNet,
    row_keys,
    row_noise,
)
from benchmarks.reference.unet import SDXLUNet, SDXLUNetConfig
from benchmarks.reference.vae import VAE, VAEConfig


def as_config(kind, fields: dict):
    return kind(**{k: tuple(v) if isinstance(v, list) else v
                   for k, v in fields.items()})


def build_generator(cfg: dict, device="meta",
                    dtype: torch.dtype = torch.float32) -> nn.ModuleDict:
    """The UNet and the VAE of the configuration in ``dtype`` (their norms
    in float32), on ``device`` (``meta``: shapes only), under the program's
    ``unet.``/``vae.`` names."""
    with torch.device("meta"):
        net = nn.ModuleDict({
            "unet": SDXLUNet(as_config(SDXLUNetConfig, cfg["unet"]),
                             dtype=dtype),
            "vae": VAE(as_config(VAEConfig, cfg["vae"]), dtype=dtype)})
    if str(device) != "meta":
        net.to_empty(device=device)
    return net.eval()


def build_prior(cfg: dict, device="meta") -> DiffusionPriorUNet:
    p = cfg["prior"]
    with torch.device("meta"):
        model = DiffusionPriorUNet(p["embed_dim"], p["cond_dim"],
                                   tuple(p["hidden_dims"]),
                                   p["time_embed_dim"])
    if str(device) != "meta":
        model.to_empty(device=device)
    return model.eval()


class Chain:
    """The reference of one reconstruction configuration on ``device``:
    ``encoder`` (a flat dict under the program's names), ``prior`` and
    ``net`` (modules), all float32."""

    def __init__(self, cfg: dict, encoder: dict, prior: DiffusionPriorUNet,
                 net: nn.ModuleDict):
        self.cfg, self.encoder, self.prior, self.net = cfg, encoder, prior, net
        g = cfg["generation"]
        self.sampler = DDPMSampler(cfg["prior"]["num_inference_steps"],
                                   cfg["prior"]["guidance_scale"],
                                   device=next(prior.parameters()).device)
        self.schedule = EulerDiscreteSchedule(ancestral=True)
        self.steps = g["num_inference_steps"]
        self.latent = tuple(g["latent_size"])
        self.text_len = g["text_len"]

    @torch.no_grad()
    def embeds(self, eeg, sids, row_seeds) -> torch.Tensor:
        feats, _ = atms.forward(self.encoder, self.cfg["encoder"], eeg, sids,
                                train=False)
        keys = row_keys(row_seeds, PRIOR_DOMAIN).to(eeg.device)
        return self.sampler.sample(self.prior, feats, keys,
                                   self.cfg["prior"]["embed_dim"])

    @torch.no_grad()
    def images(self, eeg, sids, row_seeds) -> torch.Tensor:
        emb = self.embeds(eeg, sids, row_seeds)
        dev = emb.device
        b = emb.shape[0]
        unet = self.net["unet"]
        keys = row_keys(row_seeds, SDXL_DOMAIN).to(dev)
        ts, sig_h = self.schedule.timesteps_and_sigmas(self.steps)
        sig = sig_h.to(dev)
        h, w = self.latent
        shape = (unet.config.in_channels, h, w)
        x = row_noise(keys, 0, shape) * self.schedule.init_noise_sigma(sig)
        ctx = torch.zeros(b, self.text_len, unet.config.cross_attention_dim,
                          device=dev)
        px = 2 ** (len(self.net["vae"].config.block_out_channels) - 1)
        tids = torch.tensor([[h * px, w * px, 0, 0, h * px, w * px]],
                            dtype=torch.float32, device=dev).expand(b, -1)
        for i, t in enumerate(ts.tolist()):
            tb = torch.full((b,), t, dtype=torch.int64, device=dev)
            eps = unet(self.schedule.scale_model_input(x, sig[i]), tb, ctx,
                       None, tids, emb)
            noise = row_noise(keys, i + 1, shape) if sig_h[i + 1] > 0 else None
            x = self.schedule.step(eps, sig[i], sig[i + 1], x, noise)
        img = self.net["vae"].decode(x)
        return torch.clamp(img * 0.5 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)
