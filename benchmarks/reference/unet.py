"""The benchmark's frozen plain copy of the port's SDXL UNet with the
IP-Adapter image-embedding cross-attention (``gen/unet.py``), the
reference that the reconstruct cell's images are held against.

The graph the reference drives through diffusers (``Generation/
custom_pipeline.py:354-408``): the SDXL-turbo UNet with an IP-Adapter that
adds a 1024-d CLIP image embedding as extra cross-attention keys and values.
Three resolution stages, no attention at the top one, transformer depths
(0, 2, 10), dual text conditioning through ``add_embedding`` (pooled text
embedding + 6 Fourier-embedded ``time_ids``), ε-prediction.

NCHW throughout. Submodules carry diffusers' checkpoint names
(``down_blocks.{i}.resnets.{j}``, ``…attentions.{j}.transformer_blocks.{k}
.attn2.to_k``, ``time_embedding.linear_1``, ``conv_norm_out``, …), so a
diffusers ``UNet2DConditionModel`` state dict loads with
``load_state_dict``; the IP-Adapter weights sit at ``image_proj.{proj,norm}``
(the IP-Adapter file's names) and ``…attn2.to_{k,v}_ip``
(``gen/convert.py`` orders them).

Rounding follows the JAX module: GroupNorm and LayerNorm in fp32 (their
affine parameters are held in fp32), SiLU on the fp32 norm output, and the
cast to the working dtype at each convolution or dense layer, whose weights
are held in that dtype; residual sums in the working dtype; the output cast
to fp32. The attention is code the JAX package leaves to XLA (no Pallas
kernel), so ``F.scaled_dot_product_attention`` computes it: in fp32 it
agrees with the JAX einsums (``tests/test_torch_gen.py``); in bf16 its
kernel keeps the scores and the softmax in fp32 and rounds the
probabilities to bf16 for the second product, as JAX does, but in another
summation order (``chip_smoke.py`` phase 10 holds bf16 against fp32).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from benchmarks.reference.prior import timestep_embedding


@dataclass(frozen=True)
class SDXLUNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280)
    layers_per_block: int = 2
    transformer_layers_per_block: tuple[int, ...] = (0, 2, 10)  # 0: no attn
    attention_head_dim: int = 64
    cross_attention_dim: int = 2048
    addition_time_embed_dim: int = 256
    #: pooled text-embed width for the added-cond path (SDXL: 1280)
    pooled_text_embed_dim: int = 1280
    #: number of micro-conditioning time_ids (SDXL: 6)
    num_time_ids: int = 6
    norm_groups: int = 32
    #: IP-Adapter: CLIP image embedding width → n tokens in cross-attn space
    ip_image_embed_dim: int = 1024
    ip_num_tokens: int = 4
    ip_scale: float = 1.0

    @staticmethod
    def sdxl_turbo() -> "SDXLUNetConfig":
        return SDXLUNetConfig()

    @staticmethod
    def tiny() -> "SDXLUNetConfig":
        return SDXLUNetConfig(
            block_out_channels=(32, 64), layers_per_block=1,
            transformer_layers_per_block=(0, 1), attention_head_dim=16,
            cross_attention_dim=64, addition_time_embed_dim=32,
            pooled_text_embed_dim=64, norm_groups=8, ip_image_embed_dim=64,
            ip_num_tokens=2)


def group_norm_f32(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """flax ``GroupNorm(dtype=float32)``: statistics and output in fp32."""
    return F.group_norm(x.float(), norm.num_groups, norm.weight, norm.bias,
                        norm.eps)


def layer_norm_f32(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps)


def _norm(kind, *args, eps: float):
    """A norm whose affine parameters are fp32 whatever the working dtype."""
    return kind(*args, eps=eps, dtype=torch.float32)


class CrossAttention(nn.Module):
    """Multi-head attention; with ``ip_tokens`` the IP-Adapter
    decomposition out = attn(Q, K_txt, V_txt) + scale·attn(Q, K_ip, V_ip),
    with separate projections ``to_k_ip``/``to_v_ip`` for the image
    tokens."""

    def __init__(self, query_dim: int, context_dim: int | None, head_dim: int,
                 *, ip: bool = False, ip_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = max(query_dim // head_dim, 1)
        self.head_dim = head_dim
        self.ip_scale = ip_scale
        inner = self.heads * head_dim
        ctx = query_dim if context_dim is None else context_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = nn.Linear(ctx, inner, bias=False, dtype=dtype)
        self.to_v = nn.Linear(ctx, inner, bias=False, dtype=dtype)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, dtype=dtype)])
        if ip:
            self.to_k_ip = nn.Linear(ctx, inner, bias=False, dtype=dtype)
            self.to_v_ip = nn.Linear(ctx, inner, bias=False, dtype=dtype)

    def _attend(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        B, N, inner = q.shape
        S = k.shape[1]

        def heads(a, n):
            return a.view(B, n, self.heads, self.head_dim).transpose(1, 2)

        out = F.scaled_dot_product_attention(
            heads(q, N), heads(k, S), heads(v, S),
            scale=self.head_dim ** -0.5)
        return out.transpose(1, 2).reshape(B, N, inner)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None,
                ip_tokens: torch.Tensor | None = None) -> torch.Tensor:
        ctx = x if context is None else context
        q = self.to_q(x)
        out = self._attend(q, self.to_k(ctx), self.to_v(ctx))
        if ip_tokens is not None:
            out = out + self.ip_scale * self._attend(
                q, self.to_k_ip(ip_tokens), self.to_v_ip(ip_tokens))
        return self.to_out[0](out)


class _GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, dtype: torch.dtype):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class GEGLUFeedForward(nn.Module):
    """diffusers ``FeedForward(activation_fn="geglu")``: ``net.0.proj``
    (hidden ‖ gate), the exact GELU of the gate, ``net.2``."""

    def __init__(self, dim: int, mult: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net = nn.ModuleList([_GEGLU(dim, dim * mult, dtype), nn.Identity(),
                                  nn.Linear(dim * mult, dim, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, head_dim: int, *,
                 ip_scale: float = 1.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = _norm(nn.LayerNorm, dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, None, head_dim, dtype=dtype)
        self.norm2 = _norm(nn.LayerNorm, dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, context_dim, head_dim, ip=True,
                                    ip_scale=ip_scale, dtype=dtype)
        self.norm3 = _norm(nn.LayerNorm, dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim, dtype=dtype)

    def forward(self, x, context, ip_tokens):
        dt = self.dtype
        x = x + self.attn1(layer_norm_f32(x, self.norm1).to(dt))
        x = x + self.attn2(layer_norm_f32(x, self.norm2).to(dt), context,
                           ip_tokens)
        return x + self.ff(layer_norm_f32(x, self.norm3).to(dt))


class SpatialTransformer(nn.Module):
    """diffusers ``Transformer2DModel`` with linear projections: GroupNorm
    (eps 1e-6), ``proj_in``, the blocks over the H·W tokens, ``proj_out``,
    and the residual."""

    def __init__(self, channels: int, n_layers: int, context_dim: int,
                 head_dim: int, norm_groups: int, *, ip_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = _norm(nn.GroupNorm, norm_groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels, dtype=dtype)
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(channels, context_dim, head_dim,
                             ip_scale=ip_scale, dtype=dtype)
            for _ in range(n_layers))
        self.proj_out = nn.Linear(channels, channels, dtype=dtype)

    def forward(self, x, context, ip_tokens):
        B, C, H, W = x.shape
        h = group_norm_f32(x, self.norm).to(self.dtype)
        h = self.proj_in(h.permute(0, 2, 3, 1).reshape(B, H * W, C))
        for block in self.transformer_blocks:
            h = block(h, context, ip_tokens)
        h = self.proj_out(h).view(B, H, W, C).permute(0, 3, 1, 2)
        return x + h


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 norm_groups: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = _norm(nn.GroupNorm, norm_groups, in_channels, eps=1e-5)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                               dtype=dtype)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels, dtype=dtype)
        self.norm2 = _norm(nn.GroupNorm, norm_groups, out_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                               dtype=dtype)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1,
                                           dtype=dtype)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = self.conv1(F.silu(group_norm_f32(x, self.norm1)).to(dt))
        h = h + self.time_emb_proj(F.silu(t_emb))[:, :, None, None]
        h = self.conv2(F.silu(group_norm_f32(h, self.norm2)).to(dt))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class _Resample(nn.Module):
    """``downsamplers.0`` (3×3, stride 2, pad 1) or ``upsamplers.0``
    (nearest 2× then 3×3): the conv sits at ``.conv`` as in diffusers."""

    def __init__(self, channels: int, up: bool, dtype: torch.dtype):
        super().__init__()
        self.up = up
        self.conv = nn.Conv2d(channels, channels, 3, stride=1 if up else 2,
                              padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.up:  # jax.image.resize "nearest" at 2×: source index i // 2
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x)


class _Stage(nn.Module):
    """One of diffusers' down/mid/up blocks: ``resnets``, ``attentions``
    (empty where the stage has none) and an optional resampler."""

    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class _TimestepEmbedding(nn.Module):
    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype):
        super().__init__()
        self.linear_1 = nn.Linear(d_in, d_out, dtype=dtype)
        self.linear_2 = nn.Linear(d_out, d_out, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class _ImageProjection(nn.Module):
    """IP-Adapter ``image_proj``: Linear (embed → tokens·dim) + LayerNorm."""

    def __init__(self, embed_dim: int, n_tokens: int, dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.n_tokens, self.dim, self.dtype = n_tokens, dim, dtype
        self.proj = nn.Linear(embed_dim, n_tokens * dim, dtype=dtype)
        self.norm = _norm(nn.LayerNorm, dim, eps=1e-5)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        ip = self.proj(image_embeds.to(self.dtype))
        ip = ip.view(-1, self.n_tokens, self.dim)
        return layer_norm_f32(ip, self.norm).to(self.dtype)


class SDXLUNet(nn.Module):
    """ε-prediction UNet. ``forward`` takes
    - latents (B, in_channels, H, W) NCHW,
    - t (B,) integer timesteps,
    - encoder_hidden_states (B, S, cross_attention_dim), the text tokens,
    - pooled_text_embed (B, pooled) and time_ids (B, 6), the added
      conditioning (zeros when None),
    - image_embeds (B, ip_image_embed_dim), the IP-Adapter conditioning
      (the EEG-predicted CLIP embedding), optional,
    and returns ε (B, out_channels, H, W) in fp32."""

    def __init__(self, config: SDXLUNetConfig = SDXLUNetConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        ch0 = cfg.block_out_channels[0]
        t_dim = ch0 * 4
        g = cfg.norm_groups

        def transformer(ch, depth):
            return SpatialTransformer(
                ch, depth, cfg.cross_attention_dim, cfg.attention_head_dim, g,
                ip_scale=cfg.ip_scale, dtype=dtype)

        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1,
                                 dtype=dtype)
        self.time_embedding = _TimestepEmbedding(ch0, t_dim, dtype)
        self.add_embedding = _TimestepEmbedding(
            cfg.pooled_text_embed_dim
            + cfg.num_time_ids * cfg.addition_time_embed_dim, t_dim, dtype)
        self.image_proj = _ImageProjection(
            cfg.ip_image_embed_dim, cfg.ip_num_tokens,
            cfg.cross_attention_dim, dtype)

        n = len(cfg.block_out_channels)
        skips, ch_in = [ch0], ch0
        self.down_blocks = nn.ModuleList()
        for i, ch in enumerate(cfg.block_out_channels):
            blk = _Stage()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock(ch_in, ch, t_dim, g, dtype))
                ch_in = ch
                if cfg.transformer_layers_per_block[i] > 0:
                    blk.attentions.append(
                        transformer(ch, cfg.transformer_layers_per_block[i]))
                skips.append(ch)
            if i < n - 1:
                blk.downsamplers = nn.ModuleList([_Resample(ch, False, dtype)])
                skips.append(ch)
            self.down_blocks.append(blk)

        mid = cfg.block_out_channels[-1]
        self.mid_block = _Stage()
        self.mid_block.resnets.extend([ResnetBlock(mid, mid, t_dim, g, dtype),
                                       ResnetBlock(mid, mid, t_dim, g, dtype)])
        if cfg.transformer_layers_per_block[-1] > 0:
            self.mid_block.attentions.append(
                transformer(mid, cfg.transformer_layers_per_block[-1]))

        self.up_blocks = nn.ModuleList()
        for i in reversed(range(n)):
            ch = cfg.block_out_channels[i]
            blk = _Stage()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(
                    ResnetBlock(ch_in + skips.pop(), ch, t_dim, g, dtype))
                ch_in = ch
                if cfg.transformer_layers_per_block[i] > 0:
                    blk.attentions.append(
                        transformer(ch, cfg.transformer_layers_per_block[i]))
            if i > 0:
                blk.upsamplers = nn.ModuleList([_Resample(ch, True, dtype)])
            self.up_blocks.append(blk)

        self.conv_norm_out = _norm(nn.GroupNorm, g, ch0, eps=1e-5)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1,
                                  dtype=dtype)

    def forward(self, latents: torch.Tensor, t: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                pooled_text_embed: torch.Tensor | None = None,
                time_ids: torch.Tensor | None = None,
                image_embeds: torch.Tensor | None = None) -> torch.Tensor:
        cfg, dt = self.config, self.dtype
        B = latents.shape[0]
        dev = latents.device
        # time embedding (SDXL: flip_sin_to_cos=True, shift=0)
        t_emb = self.time_embedding(
            timestep_embedding(t, cfg.block_out_channels[0]).to(dt))
        # added conditioning: pooled text embed + fourier(time_ids)
        if pooled_text_embed is None:
            pooled_text_embed = torch.zeros(B, cfg.pooled_text_embed_dim,
                                            device=dev)
        if time_ids is None:
            time_ids = torch.zeros(B, cfg.num_time_ids, device=dev)
        ids_emb = timestep_embedding(
            time_ids.reshape(-1), cfg.addition_time_embed_dim
        ).reshape(B, cfg.num_time_ids * cfg.addition_time_embed_dim)
        add = torch.cat([pooled_text_embed.float(), ids_emb], dim=-1)
        t_emb = t_emb + self.add_embedding(add.to(dt))

        ip_tokens = (None if image_embeds is None
                     else self.image_proj(image_embeds))
        ctx = encoder_hidden_states.to(dt)
        h = self.conv_in(latents.to(dt))

        skips = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, t_emb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, ctx, ip_tokens)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)

        h = self.mid_block.resnets[0](h, t_emb)
        if len(self.mid_block.attentions):
            h = self.mid_block.attentions[0](h, ctx, ip_tokens)
        h = self.mid_block.resnets[1](h, t_emb)

        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), t_emb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, ctx, ip_tokens)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)

        h = F.silu(group_norm_f32(h, self.conv_norm_out)).to(dt)
        return self.conv_out(h).float()

    def cross_attentions(self):
        """Every ``attn2`` in the order diffusers' ``unet.attn_processors``
        enumerates the cross-attentions: ``down_blocks``, ``up_blocks``,
        then ``mid_block`` (module registration order; ``mid_block`` is
        assigned after both lists in ``UNet2DConditionModel.__init__``).
        The IP-Adapter checkpoint's indices follow this order."""
        for blocks in (self.down_blocks, self.up_blocks, [self.mid_block]):
            for blk in blocks:
                for st in blk.attentions:
                    for tb in st.transformer_blocks:
                        yield tb.attn2
