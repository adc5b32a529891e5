"""Diffusion prior: EEG embedding → CLIP image-embedding space (counterpart
of ``eeg_image_decode_tpu/models/diffusion_prior.py``; ref
``Generation/diffusion_prior.py:12-203``).

- :class:`DiffusionPriorUNet`, the one the reference uses (``:92-203``): an
  MLP "U-Net" over widths (1024, 512, 256, 128, 64); every encoder and
  decoder stage adds a stage-specific timestep embedding and a projection
  of the condition, and decoder stages add the U-skips of the encoder.
- :class:`DiffusionPriorMLP`, the flat residual variant (``:12-89``).

The time embedding is diffusers' ``Timesteps(512, flip_sin_to_cos=True,
downscale_freq_shift=0)`` with a per-stage ``TimestepEmbedding`` (Linear →
SiLU → Linear). Parameters keep the JAX package's names and its (d_in,
d_out) dense layout, so a key is the flax path joined with ``.`` and
``utils/convert.py::params_from_flax`` loads a JAX tree as it stands.
Plain PyTorch, as the JAX modules are plain XLA: no TPU kernel lies here.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eeg_image_decode_tpu_torch.models.layers import (
    Dense,
    LNParams,
    MLPBlock,
    layer_norm,
    lecun_normal_,
)


def timestep_embedding(t: torch.Tensor, dim: int, *,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal features, diffusers layout: [cos | sin] halves
    (flip_sin_to_cos=True, downscale_freq_shift=0), frequencies in fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepMLP(nn.Module):
    """diffusers ``TimestepEmbedding``: Linear → SiLU → Linear."""

    def __init__(self, d_in: int, out_dim: int):
        super().__init__()
        self.fc1 = Dense(d_in, out_dim)
        self.fc2 = Dense(out_dim, out_dim)

    def forward(self, t_feats: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.silu(self.fc1(t_feats)))


@torch.no_grad()
def init_flax_defaults(model: nn.Module, seed: int) -> nn.Module:
    """flax's default initialisation in place, drawn on the CPU from one
    ``torch.Generator`` seeded with ``seed``, in parameter order: dense
    kernels ``lecun_normal`` (fan-in = d_in), biases 0, LayerNorm scales 1."""
    g = torch.Generator().manual_seed(int(seed))
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            v = lecun_normal_(torch.empty(p.shape), p.shape[0], g)
        elif leaf == "scale":
            v = torch.ones(p.shape)
        else:
            v = torch.zeros(p.shape)
        p.copy_(v)
    return model


class DiffusionPriorUNet(nn.Module):
    def __init__(self, embed_dim: int = 1024, cond_dim: int = 1024,
                 hidden_dims: tuple[int, ...] = (1024, 512, 256, 128, 64),
                 time_embed_dim: int = 512, dropout: float = 0.0):
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
            self.add_module(f"enc_layer_{i}",
                            MLPBlock(dims[i], dims[i + 1], dropout))
        for j, i in enumerate(range(n - 1, 0, -1)):
            self.add_module(f"dec_time_{j}", TimestepMLP(time_embed_dim,
                                                         dims[i]))
            self.add_module(f"dec_cond_{j}", Dense(cond_dim, dims[i]))
            self.add_module(f"dec_layer_{j}",
                            MLPBlock(dims[i], dims[i - 1], dropout))
        self.output_dense = Dense(dims[0], embed_dim)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond: torch.Tensor | None = None,
                cond_mask: torch.Tensor | None = None, *,
                train: bool = False, dropout_masks: dict | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``cond_mask`` (B,) ∈ {0, 1} gates the conditional injections per
        sample: mask 0 is exactly the reference's ``c=None`` branch (the
        cond Linear, bias included, contributes nothing), so classifier-free
        guidance is one batched forward and the 10% cond-dropout a tensor
        op. ``dropout_masks``: optional pre-scaled keep-masks (keys
        ``enc_{i}`` / ``dec_{j}``) for the Dropout sites after each hidden
        block's activation (ref ``diffusion_prior.py:140,159``)."""
        masks = dropout_masks or {}
        t_feats = timestep_embedding(t, self.time_embed_dim)
        gate = (cond_mask.float()[:, None]
                if cond is not None and cond_mask is not None else None)

        def inject_cond(h, dense):
            if cond is None:
                return h
            proj = dense(cond.float())
            if gate is not None:
                proj = proj * gate
            return h + proj

        h = F.silu(layer_norm(self.input_dense(x.float()), self.input_ln))
        skips = []
        for i in range(self.n_stages):
            skips.append(h)
            t_emb = getattr(self, f"enc_time_{i}")(t_feats)
            h = inject_cond(h + t_emb, getattr(self, f"enc_cond_{i}"))
            h = getattr(self, f"enc_layer_{i}")(
                h, train=train, dropout_mask=masks.get(f"enc_{i}"),
                generator=generator)
        for j in range(self.n_stages):
            t_emb = getattr(self, f"dec_time_{j}")(t_feats)
            h = inject_cond(h + t_emb, getattr(self, f"dec_cond_{j}"))
            h = getattr(self, f"dec_layer_{j}")(
                h, train=train, dropout_mask=masks.get(f"dec_{j}"),
                generator=generator)
            h = h + skips[-1 - j]
        return self.output_dense(h)


class DiffusionPriorMLP(nn.Module):
    """Flat residual-MLP variant (ref ``DiffusionPrior``, ``:12-89``)."""

    def __init__(self, embed_dim: int = 1024, cond_dim: int = 1024,
                 hidden_dim: int = 1024, layers_per_block: int = 4,
                 time_embed_dim: int = 512, dropout: float = 0.0):
        super().__init__()
        self.time_embed_dim = time_embed_dim
        self.layers_per_block = layers_per_block
        self.time_mlp = TimestepMLP(time_embed_dim, hidden_dim)
        self.cond_dense = Dense(cond_dim, hidden_dim)
        self.input_dense = Dense(embed_dim, hidden_dim)
        self.input_ln = LNParams(hidden_dim)
        for i in range(layers_per_block):
            self.add_module(f"block_{i}",
                            MLPBlock(hidden_dim, hidden_dim, dropout))
        self.output_dense = Dense(hidden_dim, embed_dim)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond: torch.Tensor | None = None, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        t_emb = self.time_mlp(timestep_embedding(t, self.time_embed_dim))
        c_emb = self.cond_dense(cond.float()) if cond is not None else 0.0
        h = F.silu(layer_norm(self.input_dense(x.float()), self.input_ln))
        for i in range(self.layers_per_block):
            h = h + t_emb + c_emb
            h = getattr(self, f"block_{i}")(h, train=train,
                                            generator=generator) + h
        return self.output_dense(h)


# ——— the reference's ``diffusion_prior.pt`` layout ———


def convert_diffusion_prior(sd: dict, *, n_stages: int | None = None
                            ) -> dict[str, torch.Tensor]:
    """Reference ``diffusion_prior.pt`` state dict (tensors or numpy) → the
    port's :class:`DiffusionPriorUNet` ``state_dict`` (fp32), loaded with
    ``strict=True``; the JAX converter of the same name, keyed by the JAX
    names.

    Torch layout (ref ``Generation/diffusion_prior.py:92-203``):
    ``input_layer.{0,1}`` Linear + LayerNorm, per stage
    ``encode_time_embedding.{i}.linear_{1,2}``, ``encode_cond_embedding.{i}``
    and ``encode_layers.{i}.{0,1}`` Linear + LayerNorm, the ``decode_*``
    mirrors, and ``output_layer``. ``time_proj`` has no parameters."""
    sd = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
              else np.asarray(v)) for k, v in sd.items()}
    if n_stages is None:
        n_stages = sum(1 for k in sd if k.startswith("encode_layers.")
                       and k.endswith(".0.weight"))
    out: dict = {}

    def linear(ours, ref):
        out[f"{ours}.kernel"] = np.asarray(sd[f"{ref}.weight"], np.float32).T
        out[f"{ours}.bias"] = np.asarray(sd[f"{ref}.bias"], np.float32)

    def ln(ours, ref):
        out[f"{ours}.scale"] = np.asarray(sd[f"{ref}.weight"], np.float32)
        out[f"{ours}.bias"] = np.asarray(sd[f"{ref}.bias"], np.float32)

    linear("input_dense", "input_layer.0")
    ln("input_ln", "input_layer.1")
    linear("output_dense", "output_layer")
    for side, enc in (("enc", "encode"), ("dec", "decode")):
        for i in range(n_stages):
            linear(f"{side}_time_{i}.fc1", f"{enc}_time_embedding.{i}.linear_1")
            linear(f"{side}_time_{i}.fc2", f"{enc}_time_embedding.{i}.linear_2")
            linear(f"{side}_cond_{i}", f"{enc}_cond_embedding.{i}")
            linear(f"{side}_layer_{i}.Dense_0", f"{enc}_layers.{i}.0")
            ln(f"{side}_layer_{i}.LayerNorm_0", f"{enc}_layers.{i}.1")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}


def export_diffusion_prior(state_dict: dict) -> dict[str, np.ndarray]:
    """The port's :class:`DiffusionPriorUNet` ``state_dict`` → the reference
    ``diffusion_prior.pt`` layout (numpy values): the exact inverse of
    :func:`convert_diffusion_prior` (every tensor a transpose or a copy), so
    a prior trained here loads into the reference's
    ``Pipe(diffusion_prior=DiffusionPriorUNet(...))`` with
    ``load_state_dict``."""
    p = {k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
         for k, v in state_dict.items()}
    sd: dict = {}

    def lin(name, ours):
        sd[f"{name}.weight"] = np.ascontiguousarray(p[f"{ours}.kernel"].T)
        sd[f"{name}.bias"] = np.asarray(p[f"{ours}.bias"])

    def ln(name, ours):
        sd[f"{name}.weight"] = np.asarray(p[f"{ours}.scale"])
        sd[f"{name}.bias"] = np.asarray(p[f"{ours}.bias"])

    lin("input_layer.0", "input_dense")
    ln("input_layer.1", "input_ln")
    lin("output_layer", "output_dense")
    n_stages = sum(1 for k in p if k.startswith("enc_layer_")
                   and k.endswith(".Dense_0.kernel"))
    for side, enc in (("enc", "encode"), ("dec", "decode")):
        for i in range(n_stages):
            lin(f"{enc}_time_embedding.{i}.linear_1", f"{side}_time_{i}.fc1")
            lin(f"{enc}_time_embedding.{i}.linear_2", f"{side}_time_{i}.fc2")
            lin(f"{enc}_cond_embedding.{i}", f"{side}_cond_{i}")
            lin(f"{enc}_layers.{i}.0", f"{side}_layer_{i}.Dense_0")
            ln(f"{enc}_layers.{i}.1", f"{side}_layer_{i}.LayerNorm_0")
    return sd
