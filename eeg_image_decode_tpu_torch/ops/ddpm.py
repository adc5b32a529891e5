"""DDPM schedule tables and steps (counterpart of
``eeg_image_decode_tpu/ops/ddpm.py``): the scheduler the diffusion prior
trains and samples with.

The reference uses diffusers' ``DDPMScheduler()`` with stock settings
(``Generation/diffusion_prior.py:273-275``): 1000 linear betas 1e-4 → 0.02,
ε-prediction, ``fixed_small`` variance, ``clip_sample=True`` (the predicted
x₀ clamped to [-1, 1]). The tables are built in float64 with numpy and cast
to fp32 once, as the JAX package builds them; every step's coefficients are
computed in fp32 from those tables with the JAX formulas.

The sampler is a Python loop over the spaced timesteps whose coefficients
are computed for all steps up front: nothing in the loop reads a device
value back, so the host only queues launches (the reference calls
``.item()`` every denoise step, ``diffusion_prior.py:376``).

:func:`row_noise` is the port's per-row draw. JAX's threefry ``fold_in``
bits cannot be reproduced here, so the port draws its own: Philox-4x32-10
(``ops/philox.py``) keyed by the row's 64-bit key, counter (element group,
site 5, step, 0), then Box–Muller in fp32. Like the JAX draw it is a pure
function of (row key, step), so a row's noise does not depend on the batch
it was sampled in.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from eeg_image_decode_tpu_torch.ops.philox import philox4x32_10

#: Philox counter word 1 of the diffusion noise (sites 0-4: dropout masks)
ROW_NOISE_SITE = 5


class DDPMSchedule:
    """Linear-beta DDPM with ε-prediction and fixed-small variance; its
    tables (fp32) live on ``device``."""

    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 1e-4, beta_end: float = 0.02,
                 clip_sample: bool = True, clip_sample_range: float = 1.0,
                 device: str | torch.device = "cpu"):
        self.num_train_timesteps = num_train_timesteps
        self.clip_sample = clip_sample
        self.clip_sample_range = clip_sample_range
        self.device = torch.device(device)
        betas = np.linspace(beta_start, beta_end, num_train_timesteps,
                            dtype=np.float64)
        alphas = 1.0 - betas

        def table(a):
            return torch.from_numpy(a.astype(np.float32)).to(self.device)

        self.betas = table(betas)
        self.alphas = table(alphas)
        self.alphas_cumprod = table(np.cumprod(alphas))

    # — training —
    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0): √ᾱ_t x₀ + √(1−ᾱ_t) ε (broadcast over trailing dims)."""
        ac = self.alphas_cumprod[timesteps]
        shape = (-1,) + (1,) * (x0.ndim - 1)
        return (torch.sqrt(ac).reshape(shape) * x0
                + torch.sqrt(1.0 - ac).reshape(shape) * noise)

    # — sampling —
    def inference_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Spaced timesteps, descending (diffusers ``set_timesteps``
        layout): arange(0, T, T//n) reversed → [T−r, …, r, 0], int64 on the
        host."""
        ratio = self.num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * ratio).round()[::-1]
        return ts.astype(np.int64)

    def step_coefficients(self, t, *, num_inference_steps: int
                          ) -> dict[str, torch.Tensor]:
        """The fp32 coefficients of the step from timestep(s) ``t`` (an int
        or an int tensor of any shape): x₀ = (x_t − ``sqrt_beta_prod`` ·
        ε) / ``sqrt_alpha_prod``, mean = ``c0`` · x₀ + ``ct`` · x_t, noise
        scale ``add`` (0 at t = 0)."""
        t = torch.as_tensor(t, dtype=torch.int64, device=self.device)
        ratio = self.num_train_timesteps // num_inference_steps
        prev_t = t - ratio
        ac_t = self.alphas_cumprod[t]
        ac_prev = torch.where(prev_t >= 0,
                              self.alphas_cumprod[prev_t.clamp(min=0)], 1.0)
        beta_prod_t = 1.0 - ac_t
        current_alpha = ac_t / ac_prev
        current_beta = 1.0 - current_alpha
        var = torch.clamp((1.0 - ac_prev) / beta_prod_t * current_beta,
                          min=1e-20)
        return {
            "sqrt_beta_prod": torch.sqrt(beta_prod_t),
            "sqrt_alpha_prod": torch.sqrt(ac_t),
            "c0": torch.sqrt(ac_prev) * current_beta / beta_prod_t,
            "ct": torch.sqrt(current_alpha) * (1.0 - ac_prev) / beta_prod_t,
            "add": torch.where(t > 0, torch.sqrt(var), 0.0),
        }

    def apply_step(self, coef: dict, eps: torch.Tensor, x_t: torch.Tensor,
                   noise: torch.Tensor | None) -> torch.Tensor:
        """x_t → x_{t−Δ} with :meth:`step_coefficients`; ``noise`` None
        adds none (the last step, where ``add`` is 0)."""
        shape = (-1,) + (1,) * (x_t.ndim - 1)
        c = {k: (v.reshape(shape) if v.ndim else v) for k, v in coef.items()}
        x0 = (x_t - c["sqrt_beta_prod"] * eps) / c["sqrt_alpha_prod"]
        if self.clip_sample:
            x0 = torch.clamp(x0, -self.clip_sample_range,
                             self.clip_sample_range)
        mean = c["c0"] * x0 + c["ct"] * x_t
        return mean if noise is None else mean + c["add"] * noise

    def step(self, eps: torch.Tensor, t, x_t: torch.Tensor,
             noise: torch.Tensor, *, num_inference_steps: int) -> torch.Tensor:
        """One ancestral step x_t → x_{t−Δ} given the predicted ε;
        ``noise`` (standard normal, x_t's shape) is ignored at t = 0."""
        coef = self.step_coefficients(
            t, num_inference_steps=num_inference_steps)
        return self.apply_step(coef, eps, x_t, noise)


def row_noise(row_keys: torch.Tensor, step: int,
              row_shape: tuple[int, ...]) -> torch.Tensor:
    """(B,) int64 row keys → (B, *row_shape) fp32 standard normals for one
    denoise step: row b's draw is a pure function of (``row_keys[b]``,
    ``step``), independent of the batch and the row's place in it.

    Philox key = the key's low and high 32-bit words, counter = (group,
    :data:`ROW_NOISE_SITE`, step, 0); each group's four words give two
    Box–Muller pairs, u = (2·(w >> 9) + 1) · 2⁻²⁴ ∈ (0, 1) exactly in fp32."""
    n = math.prod(row_shape)
    groups = torch.arange((n + 3) // 4, dtype=torch.int64,
                          device=row_keys.device)
    keys = row_keys.to(torch.int64)[:, None]
    c0 = groups[None, :].expand(len(row_keys), -1)
    zero = torch.zeros_like(c0)
    w = philox4x32_10((c0, zero + ROW_NOISE_SITE, zero + int(step), zero),
                      (keys & 0xFFFFFFFF, (keys >> 32) & 0xFFFFFFFF))

    def uniform(word):
        return ((word >> 9) * 2 + 1).float() * 2.0 ** -24

    pairs = []
    for a, b in ((w[0], w[1]), (w[2], w[3])):
        r = torch.sqrt(-2.0 * torch.log(uniform(a)))
        theta = (2.0 * math.pi) * uniform(b)
        pairs.append((r * torch.cos(theta), r * torch.sin(theta)))
    z = torch.stack([pairs[0][0], pairs[0][1], pairs[1][0], pairs[1][1]],
                    dim=-1)
    return z.reshape(len(row_keys), -1)[:, :n].reshape(len(row_keys),
                                                       *row_shape)


def make_cfg_sampler(denoise_fn: Callable, schedule: DDPMSchedule, *,
                     num_inference_steps: int = 50,
                     guidance_scale: float = 5.0) -> Callable:
    """A classifier-free-guidance sampler.

    ``denoise_fn(x, t, cond, cond_mask) -> eps`` with a per-sample gate.
    The reference runs two forwards per denoise step (cond and uncond,
    ``diffusion_prior.py:364-376``); here both ride one forward with the
    batch doubled and mask [1…1, 0…0]."""
    ts = schedule.inference_timesteps(num_inference_steps)
    coefs = schedule.step_coefficients(
        ts.copy(), num_inference_steps=num_inference_steps)

    def sample(cond: torch.Tensor | None, shape: tuple[int, ...], *,
               generator: torch.Generator | None = None,
               init_noise: torch.Tensor | None = None,
               step_noises: torch.Tensor | None = None,
               row_keys: torch.Tensor | None = None) -> torch.Tensor:
        """``init_noise`` (shape) and ``step_noises`` (steps, *shape)
        replace the draws: the shared-trajectory hook of sampling parity.
        ``row_keys`` (B,) int64 make every draw a pure function of the
        row's key (:func:`row_noise`); otherwise the draws come from
        ``generator`` on the schedule's device."""
        dev = schedule.device
        if init_noise is not None:
            x = init_noise.to(dev, torch.float32)
        elif row_keys is not None:
            x = row_noise(row_keys, 0, tuple(shape[1:]))
        else:
            x = torch.randn(shape, generator=generator, device=dev)
        n = shape[0]
        use_cfg = cond is not None and guidance_scale != 0
        if use_cfg:
            cond2 = torch.cat([cond, cond], dim=0)
            mask2 = torch.cat([torch.ones(n, device=dev),
                               torch.zeros(n, device=dev)])
        for i, t in enumerate(ts.tolist()):
            if use_cfg:
                tb = torch.full((2 * n,), t, dtype=torch.int64, device=dev)
                eps2 = denoise_fn(torch.cat([x, x], dim=0), tb, cond2, mask2)
                eps_c, eps_u = eps2[:n], eps2[n:]
                eps = eps_u + guidance_scale * (eps_c - eps_u)
            else:
                tb = torch.full((n,), t, dtype=torch.int64, device=dev)
                eps = denoise_fn(x, tb, cond, torch.zeros(n, device=dev))
            if t == 0:
                noise = None                      # add is 0 at t = 0
            elif step_noises is not None:
                noise = step_noises[i].to(dev, torch.float32)
            elif row_keys is not None:
                noise = row_noise(row_keys, i + 1, tuple(shape[1:]))
            else:
                noise = torch.randn(shape, generator=generator, device=dev)
            x = schedule.apply_step({k: v[i] for k, v in coefs.items()},
                                    eps, x, noise)
        return x

    return sample
