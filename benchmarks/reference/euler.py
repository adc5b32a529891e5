"""The benchmark's frozen plain copy of the port's ``ops/euler.py``.

Euler / Euler-ancestral discrete scheduler in σ-space (counterpart of
``eeg_image_decode_tpu/ops/euler.py``).

SDXL-turbo samples with the Euler-ancestral scheduler at 4 steps, guidance
0 (the reference's ``Generator4Embeds``, ``Generation/custom_pipeline.py:
456-492``); the img2img low-level variant starts the σ ladder at an
intermediate strength (``custom_pipeline_low_level.py``). The tables are
built in float64 with numpy and cast to fp32 once, as the JAX package
builds them; every step computes in fp32 from those tables with the JAX
formulas. Plain PyTorch: the JAX scheduler is plain XLA.
"""

from __future__ import annotations

import numpy as np
import torch


class EulerDiscreteSchedule:
    """σ-ladder over the DDPM beta schedule, 'trailing' timestep spacing
    (what turbo uses) and scaled-linear betas like Stable Diffusion."""

    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012, *,
                 ancestral: bool = True):
        self.num_train_timesteps = num_train_timesteps
        self.ancestral = ancestral
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps) ** 2
        ac = np.cumprod(1.0 - betas)
        self.alphas_cumprod = torch.from_numpy(ac.astype(np.float32))
        self._sigmas_full = np.sqrt((1 - ac) / ac)

    def timesteps_and_sigmas(self, num_inference_steps: int, *,
                             strength: float = 1.0
                             ) -> tuple[np.ndarray, torch.Tensor]:
        """Trailing spacing: t_i = T − 1 − i·(T/n), int64 on the host, and
        the n + 1 σ (the last 0), fp32 on the CPU. ``strength`` < 1 keeps
        only the final ``round(n·strength)`` steps (img2img init)."""
        step = self.num_train_timesteps / num_inference_steps
        ts = np.round(np.arange(self.num_train_timesteps, 0, -step)
                      ).astype(np.int64) - 1
        ts = ts[:num_inference_steps]
        sigmas = self._sigmas_full[ts]
        if strength < 1.0:
            n_keep = max(int(round(num_inference_steps * strength)), 1)
            ts, sigmas = ts[-n_keep:], sigmas[-n_keep:]
        sigmas = np.concatenate([sigmas, [0.0]])
        return ts.copy(), torch.from_numpy(sigmas.astype(np.float32))

    @staticmethod
    def init_noise_sigma(sigmas: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(sigmas[0] ** 2 + 1)

    @staticmethod
    def scale_model_input(x: torch.Tensor, sigma: torch.Tensor
                          ) -> torch.Tensor:
        return x / torch.sqrt(sigma ** 2 + 1)

    @staticmethod
    def add_noise(x0: torch.Tensor, noise: torch.Tensor,
                  sigma: torch.Tensor) -> torch.Tensor:
        """img2img init: x = x0 + σ·ε (σ-space forward process)."""
        return x0 + sigma * noise

    def step(self, eps: torch.Tensor, sigma: torch.Tensor,
             sigma_next: torch.Tensor, x: torch.Tensor,
             noise: torch.Tensor | None) -> torch.Tensor:
        """One Euler(-ancestral) step. ``eps`` is the ε-prediction on the
        *scaled* model input; ``noise`` ~ N(0, 1) is used only on ancestral
        steps, and may be None where σ_next is 0 (it would be scaled by
        0)."""
        x0 = x - sigma * eps
        d = (x - x0) / sigma
        if not self.ancestral:
            return x + d * (sigma_next - sigma)
        var_up = sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2) / sigma ** 2
        sigma_up = torch.sqrt(torch.clamp(var_up, min=0.0))
        sigma_down = torch.sqrt(torch.clamp(sigma_next ** 2 - sigma_up ** 2,
                                            min=0.0))
        x = x + d * (sigma_down - sigma)
        if noise is None:
            return x
        return x + torch.where(sigma_next > 0, sigma_up, 0.0) * noise
