"""Image generation from CLIP embeddings, the ``Generator4Embeds`` rebuild
(counterpart of ``eeg_image_decode_tpu/gen/sdxl.py``).

Reference flow (``Generation/custom_pipeline.py``): SDXL-turbo + IP-Adapter
``ip-adapter_sdxl_vit-h`` at scale 1.0, guidance 0.0, 4 Euler-ancestral
steps; the pipeline takes the (EEG-predicted) CLIP image embedding
directly, with CFG negatives = zeros (``:319-324,456-492``). The low-level
variant (``custom_pipeline_low_level.py``) starts the latents from a
VAE-encoded init image at an img2img strength instead of pure noise.

The denoise loop is a Python loop over the σ ladder whose σ values live on
the device: nothing in it reads a device value back, so the host only
queues launches. Latents are NCHW; images come back NHWC (B, H, W, 3) in
[0, 1], fp32, the JAX layout and the wire format of ``/v1/reconstruct``.
Plain PyTorch: the JAX UNet, VAE and scheduler are plain XLA.

Weights: :meth:`Generator4Embeds.init_random`, the counterpart of the JAX
``init_abstract``, builds the modules on the ``meta`` device and
materialises them on the target device in the working dtype, filled with a
seeded N(0, 0.02): no fp32 copy of the ≈ 2.6 B UNet parameters is ever made
on the host. Real weights load from the JAX generator's pickle
(:meth:`load_params`) or from diffusers checkpoints
(:meth:`load_state_dicts` with ``gen/convert.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from eeg_image_decode_tpu_torch.gen.unet import SDXLUNet, SDXLUNetConfig
from eeg_image_decode_tpu_torch.gen.vae import VAE, VAEConfig
from eeg_image_decode_tpu_torch.ops.ddpm import row_noise
from eeg_image_decode_tpu_torch.ops.euler import EulerDiscreteSchedule
from eeg_image_decode_tpu_torch.utils.convert import params_from_flax
from eeg_image_decode_tpu_torch.utils.device import resolve_device


@torch.no_grad()
def fill_random_(module: nn.Module, seed: int) -> None:
    """Every parameter of ``module`` N(0, 0.02), drawn where it lies in its
    own dtype from one generator seeded with ``seed``, in parameter
    order."""
    device = next(module.parameters()).device
    g = torch.Generator(device=device).manual_seed(int(seed))
    for p in module.parameters():
        p.normal_(0.0, 0.02, generator=g)


@dataclass(frozen=True)
class GeneratorConfig:
    unet: SDXLUNetConfig = field(default_factory=SDXLUNetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    num_inference_steps: int = 4
    guidance_scale: float = 0.0
    #: latent spatial size; SDXL-turbo at 512 px → 64 × 64 latents
    latent_size: tuple[int, int] = (64, 64)
    #: text context length (77 per CLIP tokenizer; zeros for '' prompts)
    text_len: int = 77

    @property
    def pixel_factor(self) -> int:
        """latent → pixel upsampling of the VAE (SDXL: 8×)."""
        return 2 ** (len(self.vae.block_out_channels) - 1)

    @staticmethod
    def tiny() -> "GeneratorConfig":
        return GeneratorConfig(unet=SDXLUNetConfig.tiny(),
                               vae=VAEConfig.tiny(), latent_size=(8, 8),
                               text_len=4)


class Generator4Embeds:
    """generate(image_embeds) → images in [0, 1] (ref ``:456-492``), on
    ``device`` (default: the CUDA card; raises without one) in ``dtype``
    (bf16 by default, as the JAX generator)."""

    def __init__(self, config: GeneratorConfig = GeneratorConfig(), *,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        with torch.device("meta"):
            self.unet = SDXLUNet(config.unet, dtype=dtype)
            self.vae = VAE(config.vae, dtype=dtype)
        #: both modules under one root: state-dict keys ``unet.…``/``vae.…``
        self.net = nn.ModuleDict({"unet": self.unet, "vae": self.vae})
        self.schedule = EulerDiscreteSchedule(ancestral=True)
        self._materialised = False
        #: the default (context, pooled) of generate() without text args:
        #: the encoded '' prompt (ref ``custom_pipeline.py:239``), set with
        #: set_default_text_conditioning(); zeros otherwise (random-weight
        #: runs only)
        self._default_text: tuple[torch.Tensor, torch.Tensor | None] | None \
            = None

    # — parameters —
    def _materialise(self) -> None:
        if not self._materialised:
            self.net.to_empty(device=self.device)
            self.net.eval()
            self._materialised = True

    def init_random(self, seed: int = 0) -> None:
        """Seeded random weights (:func:`fill_random_`): for latency and
        memory work, and as the target of weight conversion (the JAX
        ``init_abstract``)."""
        self._materialise()
        fill_random_(self.net, seed)

    def load_state_dicts(self, unet: dict | None = None,
                         vae: dict | None = None) -> None:
        """The port's (diffusers-named) state dicts, e.g. from
        ``gen/convert.py``; each given one loads strictly."""
        self._materialise()
        if unet is not None:
            self.unet.load_state_dict(unet, strict=True)
        if vae is not None:
            self.vae.load_state_dict(vae, strict=True)

    def load_params(self, params: dict) -> None:
        """The JAX generator's ``{"unet": tree, "vae": tree}`` of numpy
        arrays (its ``--generator-params`` pickle)."""
        self._materialise()
        self.net.load_state_dict(params_from_flax(params), strict=True)

    def set_default_text_conditioning(self, text_context,
                                      pooled_text_embed=None) -> None:
        """Install the '' -prompt embeddings as the default conditioning:
        ``text_context`` (1, L, ctx_dim) and ``pooled_text_embed``
        (1, pooled), broadcast over the batch at generate() time; compute
        them once with ``gen/text_encoder.py::SDXLTextEncoder``."""
        ctx = torch.as_tensor(text_context, dtype=torch.float32).to(
            self.device)
        if ctx.ndim == 2:
            ctx = ctx[None]
        pooled = None if pooled_text_embed is None else torch.as_tensor(
            pooled_text_embed, dtype=torch.float32).to(self.device).reshape(
                1, -1)
        self._default_text = (ctx, pooled)

    def _batch_text(self, b: int):
        """(context, pooled) of a batch of ``b`` without text arguments."""
        if self._default_text is not None:
            ctx0, pooled0 = self._default_text
            return (ctx0.expand(b, *ctx0.shape[1:]),
                    None if pooled0 is None else pooled0.expand(b, -1))
        cfg = self.config
        return (torch.zeros(b, cfg.text_len, cfg.unet.cross_attention_dim,
                            device=self.device), None)

    # — sampling —
    @torch.no_grad()
    def generate(self, image_embeds, *,
                 generator: torch.Generator | None = None,
                 text_context=None, pooled_text_embed=None,
                 num_inference_steps: int | None = None,
                 guidance_scale: float | None = None, init_latents=None,
                 img2img_strength: float = 1.0, decode: bool = True,
                 row_keys: torch.Tensor | None = None,
                 init_noise=None, step_noises=None) -> torch.Tensor:
        """CLIP image embeddings (B, D) → images (B, H, W, 3) in [0, 1],
        fp32, on the device; ``decode=False`` returns the final latents
        (B, 4, h, w) instead.

        ``init_latents`` (B, 4, h, w) with ``img2img_strength`` < 1 is the
        low-level pipeline: denoising starts from the noised init latents
        at the intermediate σ (ref ``prepare_latents_img2img``).

        Noise: ``init_noise`` (B, 4, h, w) and ``step_noises`` (steps, B,
        4, h, w) replace the draws (the shared-trajectory hook of the
        parity tests); else ``row_keys`` (B,) int64 make each row's draws a
        pure function of its key (``ops/ddpm.py::row_noise``, step 0 the
        initial draw and i + 1 the ancestral draw of step i), independent
        of the batch; else they come from ``generator`` (default: seeded
        with 0) on the device."""
        assert self._materialised, \
            "call init_random(), load_params() or load_state_dicts() first"
        cfg, dev = self.config, self.device
        steps = num_inference_steps or cfg.num_inference_steps
        scale = float(cfg.guidance_scale if guidance_scale is None
                      else guidance_scale)
        emb = torch.as_tensor(image_embeds).to(dev, torch.float32)
        b = emb.shape[0]
        if text_context is None:
            text_context, pooled0 = self._batch_text(b)
            if pooled_text_embed is None:
                pooled_text_embed = pooled0
        ctx = torch.as_tensor(text_context).to(dev, torch.float32)
        pooled = (None if pooled_text_embed is None else
                  torch.as_tensor(pooled_text_embed).to(dev, torch.float32))
        strength = img2img_strength if init_latents is not None else 1.0
        ts, sigmas_h = self.schedule.timesteps_and_sigmas(steps,
                                                          strength=strength)
        sigmas = sigmas_h.to(dev)
        h, w = cfg.latent_size
        row_shape = (cfg.unet.in_channels, h, w)
        if generator is None and row_keys is None:
            generator = torch.Generator(device=dev).manual_seed(0)

        def draw(step: int) -> torch.Tensor:
            if step == 0 and init_noise is not None:
                return torch.as_tensor(init_noise).to(dev, torch.float32)
            if step > 0 and step_noises is not None:
                return torch.as_tensor(step_noises[step - 1]).to(
                    dev, torch.float32)
            if row_keys is not None:
                return row_noise(row_keys.to(dev), step, row_shape)
            return torch.randn((b, *row_shape), generator=generator,
                               device=dev)

        noise = draw(0)
        if init_latents is None:
            x = noise * self.schedule.init_noise_sigma(sigmas)
        else:
            x = self.schedule.add_noise(
                torch.as_tensor(init_latents).to(dev, torch.float32), noise,
                sigmas[0])

        # SDXL micro-conditioning time_ids: (orig_h, orig_w, crop_t,
        # crop_l, h, w)
        px_h, px_w = h * cfg.pixel_factor, w * cfg.pixel_factor
        time_ids = torch.tensor([[px_h, px_w, 0, 0, px_h, px_w]],
                                dtype=torch.float32, device=dev).expand(b, -1)
        use_cfg = scale > 0
        if use_cfg:
            # negative branch: zero image embeds (ref :319-324), zero text
            emb = torch.cat([emb, torch.zeros_like(emb)])
            ctx = torch.cat([ctx, torch.zeros_like(ctx)])
            time_ids = torch.cat([time_ids, time_ids])
            if pooled is not None:
                pooled = torch.cat([pooled, torch.zeros_like(pooled)])

        sigmas_host = sigmas_h.numpy()
        for i, t in enumerate(ts.tolist()):
            scaled = self.schedule.scale_model_input(x, sigmas[i])
            x_in = torch.cat([scaled, scaled]) if use_cfg else scaled
            tb = torch.full((x_in.shape[0],), t, dtype=torch.int64,
                            device=dev)
            eps = self.unet(x_in, tb, ctx, pooled, time_ids, emb)
            if use_cfg:
                eps_c, eps_u = eps[:b], eps[b:]
                eps = eps_u + scale * (eps_c - eps_u)
            # the last step's σ_next is 0: its ancestral noise is scaled
            # by 0, so it is not drawn
            step_noise = draw(i + 1) if sigmas_host[i + 1] > 0 else None
            x = self.schedule.step(eps, sigmas[i], sigmas[i + 1], x,
                                   step_noise)
        if not decode:
            return x
        return self.decode(x)

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, 4, h, w) → images (B, H, W, 3) in [0, 1],
        fp32."""
        img = self.vae.decode(latents)
        return torch.clamp(img * 0.5 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)


@torch.no_grad()
def encode_init_image(gen: Generator4Embeds, images,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
    """Pixels (B, H, W, 3) in [0, 1] → scaled latents (B, 4, h, w) for the
    img2img low-level path (the mean, or a sample with ``generator``)."""
    x = torch.as_tensor(images).to(gen.device, torch.float32)
    return gen.vae.encode((x * 2.0 - 1.0).permute(0, 3, 1, 2), generator)
