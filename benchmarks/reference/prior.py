"""Plain float32 diffusion prior and its classifier-free-guidance sampler:
the benchmark's frozen copy of the port's ``models/diffusion_prior.py``
(``DiffusionPriorUNet``), ``ops/ddpm.py`` (the DDPM schedule, the sampler
and the per-row draw) and ``serve.py``'s row keys, in eval mode only
(ref ``Generation/diffusion_prior.py:92-203,268-376``).

Every noise draw is a pure function of a row's 64-bit key and the step
(Philox-4x32-10, counter (group, site 5, step, 0), then Box-Muller in
fp32), and a row's key a pure function of its (seed, row) pair and the
stage's domain (splitmix64), so the reference redraws what the program drew
from the same seeds.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmarks.reference.philox import philox4x32_10
from benchmarks.reference.precision import mm

#: Philox counter word 1 of the diffusion noise
ROW_NOISE_SITE = 5
#: row-key domains of one (seed, row): the prior's draws and SDXL's
PRIOR_DOMAIN, SDXL_DOMAIN = 0, 1


def _mix64(z: np.ndarray) -> np.ndarray:
    z = z + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def row_keys(row_seeds, domain: int) -> torch.Tensor:
    """(B, 2) uint32 (seed, row) pairs → (B,) int64 keys of one domain."""
    rs = np.asarray(row_seeds, np.uint64).reshape(-1, 2)
    with np.errstate(over="ignore"):
        k = _mix64(_mix64(_mix64(rs[:, 0]) ^ rs[:, 1]) ^ np.uint64(domain))
    return torch.from_numpy(k.view(np.int64).copy())


def row_noise(keys: torch.Tensor, step: int,
              row_shape: tuple[int, ...]) -> torch.Tensor:
    """(B,) int64 keys → (B, *row_shape) fp32 standard normals of one step."""
    n = math.prod(row_shape)
    groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=keys.device)
    k = keys.to(torch.int64)[:, None]
    c0 = groups[None, :].expand(len(keys), -1)
    zero = torch.zeros_like(c0)
    w = philox4x32_10((c0, zero + ROW_NOISE_SITE, zero + int(step), zero),
                      (k & 0xFFFFFFFF, (k >> 32) & 0xFFFFFFFF))

    def uniform(word):
        return ((word >> 9) * 2 + 1).float() * 2.0 ** -24

    pairs = []
    for a, b in ((w[0], w[1]), (w[2], w[3])):
        r = torch.sqrt(-2.0 * torch.log(uniform(a)))
        theta = (2.0 * math.pi) * uniform(b)
        pairs.append((r * torch.cos(theta), r * torch.sin(theta)))
    z = torch.stack([pairs[0][0], pairs[0][1], pairs[1][0], pairs[1][1]],
                    dim=-1)
    return z.reshape(len(keys), -1)[:, :n].reshape(len(keys), *row_shape)


def timestep_embedding(t: torch.Tensor, dim: int, *,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal features, diffusers layout: [cos | sin] halves."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class Dense(nn.Module):
    """``kernel`` (d_in, d_out) and ``bias``, the port's names and layout."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return mm(h, self.kernel) + self.bias


class LNParams(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


def layer_norm(h: torch.Tensor, ln: LNParams) -> torch.Tensor:
    return F.layer_norm(h, (h.shape[-1],), ln.scale, ln.bias, eps=1e-6)


class TimestepMLP(nn.Module):
    def __init__(self, d_in: int, out_dim: int):
        super().__init__()
        self.fc1 = Dense(d_in, out_dim)
        self.fc2 = Dense(out_dim, out_dim)

    def forward(self, t_feats: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.silu(self.fc1(t_feats)))


class MLPBlock(nn.Module):
    """Dense → LayerNorm → SiLU (dropout is off in eval)."""

    def __init__(self, d_in: int, features: int):
        super().__init__()
        self.Dense_0 = Dense(d_in, features)
        self.LayerNorm_0 = LNParams(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(layer_norm(self.Dense_0(x), self.LayerNorm_0))


class DiffusionPriorUNet(nn.Module):
    """The prior's ε-network: an MLP U-Net over the 1024-d embedding, each
    stage fed the timestep's MLP and, per row gated by ``cond_mask``, the
    condition's projection."""

    def __init__(self, embed_dim: int = 1024, cond_dim: int = 1024,
                 hidden_dims: tuple[int, ...] = (1024, 512, 256, 128, 64),
                 time_embed_dim: int = 512):
        super().__init__()
        dims = tuple(hidden_dims)
        n = len(dims)
        self.n_stages = n - 1
        self.time_embed_dim = time_embed_dim
        self.input_dense = Dense(embed_dim, dims[0])
        self.input_ln = LNParams(dims[0])
        for i in range(n - 1):
            self.add_module(f"enc_time_{i}", TimestepMLP(time_embed_dim,
                                                         dims[i]))
            self.add_module(f"enc_cond_{i}", Dense(cond_dim, dims[i]))
            self.add_module(f"enc_layer_{i}", MLPBlock(dims[i], dims[i + 1]))
        for j, i in enumerate(range(n - 1, 0, -1)):
            self.add_module(f"dec_time_{j}", TimestepMLP(time_embed_dim,
                                                         dims[i]))
            self.add_module(f"dec_cond_{j}", Dense(cond_dim, dims[i]))
            self.add_module(f"dec_layer_{j}", MLPBlock(dims[i], dims[i - 1]))
        self.output_dense = Dense(dims[0], embed_dim)

    def forward(self, x, t, cond, cond_mask) -> torch.Tensor:
        t_feats = timestep_embedding(t, self.time_embed_dim)
        gate = cond_mask.float()[:, None]

        def inject(h, dense):
            return h + dense(cond) * gate

        h = F.silu(layer_norm(self.input_dense(x), self.input_ln))
        skips = []
        for i in range(self.n_stages):
            skips.append(h)
            h = inject(h + getattr(self, f"enc_time_{i}")(t_feats),
                       getattr(self, f"enc_cond_{i}"))
            h = getattr(self, f"enc_layer_{i}")(h)
        for j in range(self.n_stages):
            h = inject(h + getattr(self, f"dec_time_{j}")(t_feats),
                       getattr(self, f"dec_cond_{j}"))
            h = getattr(self, f"dec_layer_{j}")(h) + skips[-1 - j]
        return self.output_dense(h)


class DDPMSampler:
    """diffusers' stock ``DDPMScheduler()`` (1000 linear betas 1e-4 → 0.02,
    ε-prediction, fixed-small variance, x₀ clipped to [-1, 1]) sampled over
    ``steps`` spaced timesteps with classifier-free guidance: the
    conditional and the unconditional branch in one doubled batch."""

    def __init__(self, steps: int = 50, guidance: float = 5.0,
                 num_train_timesteps: int = 1000, device="cpu"):
        betas = np.linspace(1e-4, 0.02, num_train_timesteps, dtype=np.float64)
        ac = torch.from_numpy(np.cumprod(1.0 - betas).astype(np.float32)
                              ).to(device)
        ratio = num_train_timesteps // steps
        self.ts = (np.arange(0, steps) * ratio).round()[::-1].astype(np.int64)
        self.guidance = guidance
        t = torch.as_tensor(self.ts.copy(), device=device)
        prev = t - ratio
        ac_t = ac[t]
        ac_prev = torch.where(prev >= 0, ac[prev.clamp(min=0)], 1.0)
        beta_prod = 1.0 - ac_t
        cur_alpha = ac_t / ac_prev
        cur_beta = 1.0 - cur_alpha
        var = torch.clamp((1.0 - ac_prev) / beta_prod * cur_beta, min=1e-20)
        self.coef = {
            "sqrt_beta_prod": torch.sqrt(beta_prod),
            "sqrt_alpha_prod": torch.sqrt(ac_t),
            "c0": torch.sqrt(ac_prev) * cur_beta / beta_prod,
            "ct": torch.sqrt(cur_alpha) * (1.0 - ac_prev) / beta_prod,
            "add": torch.where(t > 0, torch.sqrt(var), 0.0),
        }

    @torch.no_grad()
    def sample(self, model: DiffusionPriorUNet, cond: torch.Tensor,
               keys: torch.Tensor, embed_dim: int) -> torch.Tensor:
        dev = cond.device
        n = cond.shape[0]
        x = row_noise(keys, 0, (embed_dim,))
        cond2 = torch.cat([cond, cond])
        mask2 = torch.cat([torch.ones(n, device=dev),
                           torch.zeros(n, device=dev)])
        for i, t in enumerate(self.ts.tolist()):
            tb = torch.full((2 * n,), t, dtype=torch.int64, device=dev)
            eps2 = model(torch.cat([x, x]), tb, cond2, mask2)
            eps = eps2[n:] + self.guidance * (eps2[:n] - eps2[n:])
            c = {k: v[i] for k, v in self.coef.items()}
            x0 = torch.clamp((x - c["sqrt_beta_prod"] * eps)
                             / c["sqrt_alpha_prod"], -1.0, 1.0)
            x = c["c0"] * x0 + c["ct"] * x
            if t > 0:
                x = x + c["add"] * row_noise(keys, i + 1, (embed_dim,))
        return x
