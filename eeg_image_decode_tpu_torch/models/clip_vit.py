"""CLIP image and text towers (counterpart of
``eeg_image_decode_tpu/models/clip_vit.py``).

The OpenCLIP ViT-H/14 towers that make the retrieval targets (the feature
cache of ``cli features``). The JAX towers are plain XLA, so these are plain
PyTorch: the products go to ``torch.matmul`` / ``F.linear`` and the
attention to ``F.scaled_dot_product_attention``; no TPU kernel lies on this
path.

Layouts at the boundary are the JAX package's: (B, H, W, 3) normalised
images, (B, L) token ids. Parameter names and layouts are OpenCLIP's
(``conv1``, ``transformer.resblocks.{i}.attn.in_proj_weight``, ``proj``,
…), so an OpenCLIP ``state_dict`` loads with its ``visual.`` prefix
stripped (``utils/convert_clip.py``).

Rounding points follow the JAX towers: every LayerNorm in fp32 (eps 1e-5);
the residual stream, the attention and the MLP in the working ``dtype``
(their dense weights are held in it, as flax casts them per call); q scaled
by 1/√head_dim in the working dtype before the product (flax
``MultiHeadDotProductAttention``); ``ln_pre``'s output cast to the working
dtype; ``ln_post`` / ``ln_final`` and the final projection in fp32. One
difference in bf16: ``scaled_dot_product_attention`` keeps the scores and
the softmax in fp32 inside its kernel, where flax rounds the scores to
bf16 first. In fp32 the two agree (``tests/test_torch_clip.py``); in bf16
the features hold the port's fp32 features at per-row cosine ≥ 0.99 over
the 32 layers (``chip_smoke.py`` phase 7).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    embed_dim: int = 1024  # output projection width
    #: "gelu" (OpenCLIP laion checkpoints, e.g. ViT-H/14) or "quick_gelu"
    #: (OpenAI CLIP checkpoints, e.g. the ViT-L/14 grid tower GIT uses)
    act: str = "gelu"

    @staticmethod
    def vit_h_14() -> "CLIPVisionConfig":
        return CLIPVisionConfig()

    @staticmethod
    def vit_l_14() -> "CLIPVisionConfig":
        return CLIPVisionConfig(width=1024, layers=24, heads=16,
                                embed_dim=768, act="quick_gelu")

    @staticmethod
    def git_vit_l_14() -> "CLIPVisionConfig":
        """GIT's ``git.image_encoder`` (no projection head: embed_dim ==
        width, and the converter fills an identity)."""
        return CLIPVisionConfig(width=1024, layers=24, heads=16,
                                embed_dim=1024, act="quick_gelu")

    @staticmethod
    def tiny(act: str = "gelu") -> "CLIPVisionConfig":
        return CLIPVisionConfig(image_size=32, patch_size=8, width=64,
                                layers=2, heads=2, embed_dim=32, act=act)


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 1024
    layers: int = 24
    heads: int = 16
    embed_dim: int = 1024
    #: "quick_gelu" (OpenAI CLIP family) or "gelu" (OpenCLIP bigG family).
    #: ``vit_h_14()`` keeps the JAX package's default, quick-GELU, although
    #: OpenCLIP's ViT-H-14 config asks for exact GELU (ROADMAP.md §3).
    act: str = "quick_gelu"

    @staticmethod
    def vit_h_14() -> "CLIPTextConfig":
        return CLIPTextConfig()

    @staticmethod
    def sdxl_clip_l() -> "CLIPTextConfig":
        """SDXL ``text_encoder`` (OpenAI CLIP ViT-L/14 text tower)."""
        return CLIPTextConfig(width=768, layers=12, heads=12, embed_dim=768,
                              act="quick_gelu")

    @staticmethod
    def sdxl_big_g() -> "CLIPTextConfig":
        """SDXL ``text_encoder_2`` (OpenCLIP ViT-bigG/14 text tower)."""
        return CLIPTextConfig(width=1280, layers=32, heads=20, embed_dim=1280,
                              act="gelu")

    @staticmethod
    def tiny(act: str = "quick_gelu") -> "CLIPTextConfig":
        return CLIPTextConfig(vocab_size=64, context_length=12, width=32,
                              layers=2, heads=2, embed_dim=32, act=act)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm in fp32 (flax ``LayerNorm(dtype=float32)``): fp32 out."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


class _Attention(nn.Module):
    """Multi-head self-attention in OpenCLIP's layout: q, k and v packed in
    ``in_proj_weight`` (3W, W), the output in ``out_proj``."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(
            torch.zeros(3 * width, width, dtype=dtype))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width, dtype=dtype))
        self.out_proj = nn.Linear(width, width, dtype=dtype)

    def forward(self, h: torch.Tensor, causal: bool) -> torch.Tensor:
        B, L, W = h.shape
        hd = W // self.heads
        qkv = F.linear(h, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.view(B, L, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        # flax: q / sqrt(depth), the divisor rounded to the working dtype
        q = q / float(torch.tensor(math.sqrt(hd), dtype=q.dtype))
        a = F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                           scale=1.0)
        return self.out_proj(a.transpose(1, 2).reshape(B, L, W))


class _MLP(nn.Module):
    def __init__(self, width: int, act: str, dtype: torch.dtype):
        super().__init__()
        if act not in ("gelu", "quick_gelu"):
            raise ValueError(f"act must be 'gelu' or 'quick_gelu', not {act!r}")
        self.act = act
        self.c_fc = nn.Linear(width, 4 * width, dtype=dtype)
        self.c_proj = nn.Linear(4 * width, width, dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.c_fc(h)
        if self.act == "quick_gelu":  # CLIP's original activation
            h = h * torch.sigmoid(1.702 * h)
        else:  # exact gelu
            h = F.gelu(h)
        return self.c_proj(h)


class _ResidualAttnBlock(nn.Module):
    """Pre-norm transformer block: x + attn(ln_1(x)), then x + mlp(ln_2(x));
    the LayerNorms in fp32, everything else in ``dtype``."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype = torch.float32,
                 act: str = "quick_gelu"):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _Attention(width, heads, dtype)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width, act, dtype)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        x = x + self.attn(_layer_norm(x, self.ln_1).to(self.dtype), causal)
        return x + self.mlp(_layer_norm(x, self.ln_2).to(self.dtype))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int,
                 dtype: torch.dtype, act: str):
        super().__init__()
        self.resblocks = nn.ModuleList(
            _ResidualAttnBlock(width, heads, dtype, act) for _ in range(layers))


def _init_(module: nn.Module, seed: int) -> None:
    """Seeded random weights, drawn on the device the parameters lie on (a
    smoke run's; real ones come through ``utils/convert_clip.py``):
    LayerNorms at identity, biases 0, dense and conv weights N(0, 1/fan_in),
    embeddings and projections N(0, 0.02²)."""
    device = next(module.parameters()).device
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            for name, p in m.named_parameters(recurse=False):
                draw = torch.randn(p.shape, generator=g, device=device)
                if isinstance(m, nn.LayerNorm):
                    p.fill_(1.0 if name == "weight" else 0.0)
                elif name.endswith("bias"):
                    p.zero_()
                elif isinstance(m, (nn.Linear, nn.Conv2d, _Attention)):
                    p.copy_(draw / math.sqrt(p[0].numel()))
                else:
                    p.copy_(draw * 0.02)


class CLIPVisionTower(nn.Module):
    """(B, H, W, 3) normalised images → (B, embed_dim) fp32 features, or the
    (B, 1 + grid², width) fp32 token grid with ``return_grid``."""

    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig(),
                 dtype: torch.dtype = torch.float32, *, seed: int | None = None):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        n_tokens = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.conv1 = nn.Conv2d(3, cfg.width, cfg.patch_size,
                               stride=cfg.patch_size, bias=False, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width))
        self.positional_embedding = nn.Parameter(
            torch.zeros(n_tokens, cfg.width))
        self.ln_pre = nn.LayerNorm(cfg.width, eps=1e-5)
        self.transformer = _Transformer(cfg.width, cfg.layers, cfg.heads,
                                        dtype, cfg.act)
        self.ln_post = nn.LayerNorm(cfg.width, eps=1e-5)
        self.proj = nn.Parameter(torch.zeros(cfg.width, cfg.embed_dim))
        if seed is not None:
            _init_(self, seed)

    def forward(self, images: torch.Tensor, *,
                return_grid: bool = False) -> torch.Tensor:
        B = images.shape[0]
        x = self.conv1(images.to(self.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # (B, grid², W), row-major patches
        cls = self.class_embedding.to(self.dtype).expand(B, 1, -1)
        x = torch.cat([cls, x], 1) + self.positional_embedding.to(self.dtype)
        x = _layer_norm(x, self.ln_pre).to(self.dtype)
        for block in self.transformer.resblocks:
            x = block(x)
        x = _layer_norm(x, self.ln_post)
        if return_grid:
            return x
        return x[:, 0] @ self.proj


class CLIPTextTower(nn.Module):
    """(B, L) BPE ids (EOT = the largest id of each row) → (B, embed_dim)
    fp32; with ``return_states`` a dict of ``pooled``, ``penultimate`` (the
    input of the last block) and ``final`` (after ``ln_final``), all fp32."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig(),
                 dtype: torch.dtype = torch.float32, *, seed: int | None = None):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.context_length, cfg.width))
        self.transformer = _Transformer(cfg.width, cfg.layers, cfg.heads,
                                        dtype, cfg.act)
        self.ln_final = nn.LayerNorm(cfg.width, eps=1e-5)
        self.text_projection = nn.Parameter(
            torch.zeros(cfg.width, cfg.embed_dim))
        if seed is not None:
            _init_(self, seed)

    def forward(self, token_ids: torch.Tensor, *, return_states: bool = False):
        B, L = token_ids.shape
        x = self.token_embedding(token_ids).to(self.dtype)
        x = x + self.positional_embedding[:L].to(self.dtype)
        blocks = self.transformer.resblocks
        penultimate = x
        for i, block in enumerate(blocks):
            if i == len(blocks) - 1:
                penultimate = x
            x = block(x, causal=True)
        x = _layer_norm(x, self.ln_final)
        # features at the EOT token (the largest id of each row)
        eot = token_ids.argmax(dim=-1)
        pooled = x[torch.arange(B, device=x.device), eot] @ self.text_projection
        if not return_states:
            return pooled
        return {"pooled": pooled, "penultimate": penultimate.float(),
                "final": x}


def clip_preprocess(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB (…, 3) → CLIP normalisation (OpenCLIP mean/std)."""
    mean = images.new_tensor([0.48145466, 0.4578275, 0.40821073])
    std = images.new_tensor([0.26862954, 0.26130258, 0.27577711])
    return (images - mean) / std
