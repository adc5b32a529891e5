"""The published checkpoints' key grammars, as ``{name: shape}``.

Each function below writes out the ``state_dict`` layout of one published
checkpoint, from that checkpoint's own configuration (``PUBLISHED``, the
fields of its ``config.json``) and the module structure of the library
that saved it:

- ``unet_grammar``: diffusers' ``UNet2DConditionModel`` at sdxl-turbo's
  ``unet/config.json``; ``ip_adapter_grammar``: ``ip-adapter_sdxl_vit-h``
  (its ``image_proj`` head and one ``to_{k,v}_ip`` pair per
  cross-attention, at the odd indices of the saved ``ModuleList`` of
  ``unet.attn_processors``);
- ``vae_grammar``: diffusers' ``AutoencoderKL`` at sdxl-turbo's
  ``vae/config.json``;
- ``clip_text_grammar``: transformers' ``CLIPTextModel`` (SDXL's
  ``text_encoder``, CLIP ViT-L/14) and ``CLIPTextModelWithProjection``
  (``text_encoder_2``, OpenCLIP ViT-bigG/14);
- ``openclip_grammar``: OpenCLIP's ViT-H-14 ``state_dict``, both towers
  and ``logit_scale``;
- ``git_grammar``: transformers' ``GitForCausalLM`` at git-large-coco's
  ``config.json``, its ViT-L/14 image encoder (``git.image_encoder.*``)
  included;
- ``prior_grammar``: the reference's ``diffusion_prior.pt``
  (``Generation/diffusion_prior.py:92-203``).

None of it is derived from the port's modules, so a converter that drops a
published key, or a module that lacks one, shows against it. transformers
saved the ``position_ids`` buffers (int64) with the weights before its
4.31 release, so files of that age carry them (``position_ids=True``, the
default); a converter leaves them out.

``synth`` fills a grammar with seeded N(0, 0.02) values, norm scales (the
1-D ``.weight`` entries) set to 1, drawn on ``device`` and handed over as
fp16 host tensors, as a checkpoint reader hands them over.

Imports torch and numpy only: no JAX, transformers, diffusers or
open_clip. ``tests/test_torch_convert_fullsize.py`` holds every grammar to
JAX's enumerators and to transformers' classes, and runs the port's
converters on them; ``scripts/rehearse_fullsize_torch.py`` runs the
converted models on the card.
"""

from __future__ import annotations

import numpy as np
import torch

#: the published configurations, in their config files' field names
PUBLISHED = {
    # stabilityai/sdxl-turbo unet/config.json; its "attention_head_dim"
    # [5, 10, 20] counts heads (diffusers' naming), 64 channels each
    "sdxl_turbo_unet": dict(
        in_channels=4, out_channels=4, block_out_channels=(320, 640, 1280),
        layers_per_block=2,
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D",
                          "CrossAttnDownBlock2D"),
        up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                        "UpBlock2D"),
        transformer_layers_per_block=(1, 2, 10),
        attention_head_dim=(5, 10, 20), cross_attention_dim=2048,
        addition_time_embed_dim=256,
        projection_class_embeddings_input_dim=2816,
        use_linear_projection=True),
    # h94/IP-Adapter sdxl_models/ip-adapter_sdxl_vit-h: ImageProjModel
    # (clip_embeddings_dim 1024 → 4 tokens of 2048)
    "ip_adapter_sdxl_vit_h": dict(clip_embeddings_dim=1024,
                                  clip_extra_context_tokens=4,
                                  cross_attention_dim=2048),
    # stabilityai/sdxl-turbo vae/config.json
    "sdxl_turbo_vae": dict(in_channels=3, out_channels=3, latent_channels=4,
                           block_out_channels=(128, 256, 512, 512),
                           layers_per_block=2,
                           mid_block_add_attention=True),
    # stabilityai/sdxl-turbo text_encoder/config.json (CLIP ViT-L/14)
    "sdxl_clip_l": dict(vocab_size=49408, hidden_size=768,
                        intermediate_size=3072, num_hidden_layers=12,
                        num_attention_heads=12, max_position_embeddings=77,
                        projection_dim=768, hidden_act="quick_gelu"),
    # stabilityai/sdxl-turbo text_encoder_2/config.json (ViT-bigG/14)
    "sdxl_big_g": dict(vocab_size=49408, hidden_size=1280,
                       intermediate_size=5120, num_hidden_layers=32,
                       num_attention_heads=20, max_position_embeddings=77,
                       projection_dim=1280, hidden_act="gelu"),
    # open_clip model_configs/ViT-H-14.json
    "open_clip_vit_h_14": dict(
        embed_dim=1024,
        vision_cfg=dict(image_size=224, layers=32, width=1280,
                        head_width=80, patch_size=14),
        text_cfg=dict(context_length=77, vocab_size=49408, width=1024,
                      heads=16, layers=24)),
    # microsoft/git-large-coco config.json
    "git_large_coco": dict(
        vocab_size=30522, hidden_size=1024, intermediate_size=4096,
        num_hidden_layers=6, num_attention_heads=16,
        max_position_embeddings=1024,
        vision_config=dict(hidden_size=1024, intermediate_size=4096,
                           num_hidden_layers=24, num_attention_heads=16,
                           image_size=224, patch_size=14)),
    # the reference's DiffusionPriorUNet() defaults
    "diffusion_prior": dict(embed_dim=1024, cond_dim=1024,
                            hidden_dim=(1024, 512, 256, 128, 64),
                            time_embed_dim=512),
}


def _linear(d: dict, p: str, out: int, inp: int, bias: bool = True) -> None:
    d[f"{p}.weight"] = (out, inp)
    if bias:
        d[f"{p}.bias"] = (out,)


def _conv(d: dict, p: str, out: int, inp: int, k: int) -> None:
    d[f"{p}.weight"] = (out, inp, k, k)
    d[f"{p}.bias"] = (out,)


def _affine(d: dict, p: str, c: int) -> None:
    """A GroupNorm's or LayerNorm's scale and shift."""
    d[f"{p}.weight"] = (c,)
    d[f"{p}.bias"] = (c,)


# ——— diffusers ———


def _resnet_block(d: dict, p: str, cin: int, cout: int,
                  temb: int | None) -> None:
    """``ResnetBlock2D``: norm1, conv1, [time_emb_proj], norm2, conv2 and a
    1 × 1 ``conv_shortcut`` when the width changes."""
    _affine(d, f"{p}.norm1", cin)
    _conv(d, f"{p}.conv1", cout, cin, 3)
    if temb is not None:
        _linear(d, f"{p}.time_emb_proj", cout, temb)
    _affine(d, f"{p}.norm2", cout)
    _conv(d, f"{p}.conv2", cout, cout, 3)
    if cin != cout:
        _conv(d, f"{p}.conv_shortcut", cout, cin, 1)


def _transformer_2d(d: dict, p: str, ch: int, depth: int, ctx: int) -> None:
    """``Transformer2DModel`` with ``use_linear_projection``: GroupNorm,
    Linear proj_in / proj_out, and ``depth`` ``BasicTransformerBlock``s
    (self-attention, cross-attention to ``ctx``-wide context, GEGLU)."""
    _affine(d, f"{p}.norm", ch)
    _linear(d, f"{p}.proj_in", ch, ch)
    for k in range(depth):
        b = f"{p}.transformer_blocks.{k}"
        for a, kv in (("attn1", ch), ("attn2", ctx)):
            _linear(d, f"{b}.{a}.to_q", ch, ch, bias=False)
            _linear(d, f"{b}.{a}.to_k", ch, kv, bias=False)
            _linear(d, f"{b}.{a}.to_v", ch, kv, bias=False)
            _linear(d, f"{b}.{a}.to_out.0", ch, ch)
        for n in (1, 2, 3):
            _affine(d, f"{b}.norm{n}", ch)
        _linear(d, f"{b}.ff.net.0.proj", 2 * 4 * ch, ch)  # GEGLU: value‖gate
        _linear(d, f"{b}.ff.net.2", ch, 4 * ch)
    _linear(d, f"{p}.proj_out", ch, ch)


def unet_grammar(cfg: dict = PUBLISHED["sdxl_turbo_unet"]) -> dict:
    """``UNet2DConditionModel.state_dict()`` of an SDXL config (the
    ``text_time`` added condition, linear projections)."""
    d: dict = {}
    chans = cfg["block_out_channels"]
    depth = cfg["transformer_layers_per_block"]
    n_res, ctx = cfg["layers_per_block"], cfg["cross_attention_dim"]
    temb = 4 * chans[0]
    _conv(d, "conv_in", chans[0], cfg["in_channels"], 3)
    _linear(d, "time_embedding.linear_1", temb, chans[0])
    _linear(d, "time_embedding.linear_2", temb, temb)
    _linear(d, "add_embedding.linear_1", temb,
            cfg["projection_class_embeddings_input_dim"])
    _linear(d, "add_embedding.linear_2", temb, temb)

    out_ch, skips = chans[0], [chans[0]]
    for i, kind in enumerate(cfg["down_block_types"]):
        for j in range(n_res):
            _resnet_block(d, f"down_blocks.{i}.resnets.{j}", out_ch, chans[i],
                          temb)
            out_ch = chans[i]
            if kind.startswith("CrossAttn"):
                _transformer_2d(d, f"down_blocks.{i}.attentions.{j}",
                                chans[i], depth[i], ctx)
            skips.append(out_ch)
        if i < len(chans) - 1:  # every block but the last halves the grid
            _conv(d, f"down_blocks.{i}.downsamplers.0.conv", out_ch, out_ch, 3)
            skips.append(out_ch)

    _resnet_block(d, "mid_block.resnets.0", out_ch, out_ch, temb)
    _transformer_2d(d, "mid_block.attentions.0", out_ch, depth[-1], ctx)
    _resnet_block(d, "mid_block.resnets.1", out_ch, out_ch, temb)

    rev_chans, rev_depth = chans[::-1], depth[::-1]
    for i, kind in enumerate(cfg["up_block_types"]):
        for j in range(n_res + 1):
            skip = skips.pop()
            _resnet_block(d, f"up_blocks.{i}.resnets.{j}", out_ch + skip,
                          rev_chans[i], temb)
            out_ch = rev_chans[i]
            if kind.startswith("CrossAttn"):
                _transformer_2d(d, f"up_blocks.{i}.attentions.{j}", out_ch,
                                rev_depth[i], ctx)
        if i < len(chans) - 1:
            _conv(d, f"up_blocks.{i}.upsamplers.0.conv", out_ch, out_ch, 3)

    _affine(d, "conv_norm_out", chans[0])
    _conv(d, "conv_out", cfg["out_channels"], chans[0], 3)
    return d


def cross_attention_widths(cfg: dict = PUBLISHED["sdxl_turbo_unet"]
                           ) -> list[int]:
    """The query width of every cross-attention, in the order of
    ``unet.attn_processors``: the modules' registration order, in which
    ``down_blocks`` and ``up_blocks`` come before ``mid_block``."""
    chans = cfg["block_out_channels"]
    depth = cfg["transformer_layers_per_block"]
    n_res, widths = cfg["layers_per_block"], []
    for i, kind in enumerate(cfg["down_block_types"]):
        if kind.startswith("CrossAttn"):
            widths += [chans[i]] * (n_res * depth[i])
    for i, kind in enumerate(cfg["up_block_types"]):
        if kind.startswith("CrossAttn"):
            widths += [chans[::-1][i]] * ((n_res + 1) * depth[::-1][i])
    return widths + [chans[-1]] * depth[-1]


def ip_adapter_grammar(unet_cfg: dict = PUBLISHED["sdxl_turbo_unet"],
                       cfg: dict = PUBLISHED["ip_adapter_sdxl_vit_h"]
                       ) -> dict:
    """``ip-adapter_sdxl_vit-h``: ``image_proj`` (Linear to 4 tokens of
    2048, LayerNorm) and ``ip_adapter.{2n+1}.to_{k,v}_ip.weight`` for the
    n-th cross-attention (the even slots are the parameter-free
    self-attention processors)."""
    ctx, tokens = cfg["cross_attention_dim"], cfg["clip_extra_context_tokens"]
    d: dict = {}
    _linear(d, "image_proj.proj", tokens * ctx, cfg["clip_embeddings_dim"])
    _affine(d, "image_proj.norm", ctx)
    for n, width in enumerate(cross_attention_widths(unet_cfg)):
        for kv in ("k", "v"):
            d[f"ip_adapter.{2 * n + 1}.to_{kv}_ip.weight"] = (width, ctx)
    return d


def _vae_mid(d: dict, p: str, ch: int, attention: bool) -> None:
    _resnet_block(d, f"{p}.mid_block.resnets.0", ch, ch, None)
    if attention:
        a = f"{p}.mid_block.attentions.0"
        _affine(d, f"{a}.group_norm", ch)
        for n in ("to_q", "to_k", "to_v", "to_out.0"):
            _linear(d, f"{a}.{n}", ch, ch)
    _resnet_block(d, f"{p}.mid_block.resnets.1", ch, ch, None)


def vae_grammar(cfg: dict = PUBLISHED["sdxl_turbo_vae"]) -> dict:
    """``AutoencoderKL.state_dict()``: the encoder, the decoder and the two
    1 × 1 quant convolutions."""
    d: dict = {}
    chans, n_res = cfg["block_out_channels"], cfg["layers_per_block"]
    lat, attention = cfg["latent_channels"], cfg["mid_block_add_attention"]
    _conv(d, "encoder.conv_in", chans[0], cfg["in_channels"], 3)
    ch = chans[0]
    for i, out in enumerate(chans):
        for j in range(n_res):
            _resnet_block(d, f"encoder.down_blocks.{i}.resnets.{j}", ch, out,
                          None)
            ch = out
        if i < len(chans) - 1:
            _conv(d, f"encoder.down_blocks.{i}.downsamplers.0.conv", ch, ch,
                  3)
    _vae_mid(d, "encoder", ch, attention)
    _affine(d, "encoder.conv_norm_out", ch)
    _conv(d, "encoder.conv_out", 2 * lat, ch, 3)  # mean ‖ log-variance

    _conv(d, "decoder.conv_in", chans[-1], lat, 3)
    ch = chans[-1]
    _vae_mid(d, "decoder", ch, attention)
    for i, out in enumerate(chans[::-1]):
        for j in range(n_res + 1):
            _resnet_block(d, f"decoder.up_blocks.{i}.resnets.{j}", ch, out,
                          None)
            ch = out
        if i < len(chans) - 1:
            _conv(d, f"decoder.up_blocks.{i}.upsamplers.0.conv", ch, ch, 3)
    _affine(d, "decoder.conv_norm_out", ch)
    _conv(d, "decoder.conv_out", cfg["out_channels"], ch, 3)
    _conv(d, "quant_conv", 2 * lat, 2 * lat, 1)
    _conv(d, "post_quant_conv", lat, lat, 1)
    return d


# ——— transformers ———


def _hf_clip_encoder(d: dict, p: str, width: int, ff: int,
                     layers: int) -> None:
    """``CLIPEncoder``: per layer q, k, v and out projections, two
    LayerNorms and the fc1 / fc2 MLP."""
    for i in range(layers):
        q = f"{p}.layers.{i}"
        for n in ("k_proj", "v_proj", "q_proj", "out_proj"):
            _linear(d, f"{q}.self_attn.{n}", width, width)
        _affine(d, f"{q}.layer_norm1", width)
        _linear(d, f"{q}.mlp.fc1", ff, width)
        _linear(d, f"{q}.mlp.fc2", width, ff)
        _affine(d, f"{q}.layer_norm2", width)


def clip_text_grammar(cfg: dict = PUBLISHED["sdxl_clip_l"], *,
                      projection: bool = False,
                      position_ids: bool = True) -> dict:
    """``CLIPTextModel`` (``projection=False``) or
    ``CLIPTextModelWithProjection`` (``text_projection``, no bias)."""
    w, t = cfg["hidden_size"], "text_model"
    d = {f"{t}.embeddings.token_embedding.weight": (cfg["vocab_size"], w),
         f"{t}.embeddings.position_embedding.weight":
         (cfg["max_position_embeddings"], w)}
    if position_ids:
        d[f"{t}.embeddings.position_ids"] = (1, cfg["max_position_embeddings"])
    _hf_clip_encoder(d, f"{t}.encoder", w, cfg["intermediate_size"],
                     cfg["num_hidden_layers"])
    _affine(d, f"{t}.final_layer_norm", w)
    if projection:
        d["text_projection.weight"] = (cfg["projection_dim"], w)
    return d


def git_grammar(cfg: dict = PUBLISHED["git_large_coco"], *,
                position_ids: bool = True) -> dict:
    """``GitForCausalLM.state_dict()``: the BERT-style decoder with its
    visual projection and untied lm head, and the CLIP vision encoder under
    ``git.image_encoder.vision_model``."""
    w, ff = cfg["hidden_size"], cfg["intermediate_size"]
    v = cfg["vision_config"]
    vw, grid = v["hidden_size"], v["image_size"] // v["patch_size"]
    d: dict = {}
    _linear(d, "git.embeddings.word_embeddings", cfg["vocab_size"], w,
            bias=False)
    _linear(d, "git.embeddings.position_embeddings",
            cfg["max_position_embeddings"], w, bias=False)
    _affine(d, "git.embeddings.LayerNorm", w)
    if position_ids:
        d["git.embeddings.position_ids"] = (1, cfg["max_position_embeddings"])
    e = "git.image_encoder.vision_model"
    d[f"{e}.embeddings.class_embedding"] = (vw,)
    d[f"{e}.embeddings.patch_embedding.weight"] = (vw, 3, v["patch_size"],
                                                   v["patch_size"])
    d[f"{e}.embeddings.position_embedding.weight"] = (grid * grid + 1, vw)
    if position_ids:
        d[f"{e}.embeddings.position_ids"] = (1, grid * grid + 1)
    _affine(d, f"{e}.pre_layrnorm", vw)  # transformers' spelling
    _hf_clip_encoder(d, f"{e}.encoder", vw, v["intermediate_size"],
                     v["num_hidden_layers"])
    _affine(d, f"{e}.post_layernorm", vw)
    for i in range(cfg["num_hidden_layers"]):
        p = f"git.encoder.layer.{i}"
        for n in ("query", "key", "value"):
            _linear(d, f"{p}.attention.self.{n}", w, w)
        _linear(d, f"{p}.attention.output.dense", w, w)
        _affine(d, f"{p}.attention.output.LayerNorm", w)
        _linear(d, f"{p}.intermediate.dense", ff, w)
        _linear(d, f"{p}.output.dense", w, ff)
        _affine(d, f"{p}.output.LayerNorm", w)
    _linear(d, "git.visual_projection.visual_projection.0", w, vw)
    _affine(d, "git.visual_projection.visual_projection.1", w)
    _linear(d, "output", cfg["vocab_size"], w)
    return d


# ——— OpenCLIP ———


def _openclip_blocks(d: dict, p: str, width: int, layers: int) -> None:
    """``Transformer.resblocks``: ``nn.MultiheadAttention`` (packed q/k/v
    rows), two LayerNorms and the c_fc / c_proj MLP (4× wide)."""
    for i in range(layers):
        b = f"{p}.resblocks.{i}"
        _affine(d, f"{b}.ln_1", width)
        d[f"{b}.attn.in_proj_weight"] = (3 * width, width)
        d[f"{b}.attn.in_proj_bias"] = (3 * width,)
        _linear(d, f"{b}.attn.out_proj", width, width)
        _affine(d, f"{b}.ln_2", width)
        _linear(d, f"{b}.mlp.c_fc", 4 * width, width)
        _linear(d, f"{b}.mlp.c_proj", width, 4 * width)


def openclip_grammar(cfg: dict = PUBLISHED["open_clip_vit_h_14"]) -> dict:
    """``open_clip.create_model('ViT-H-14').state_dict()``: the vision
    tower under ``visual.``, the text tower at the top level, and
    ``logit_scale``."""
    v, t, e = cfg["vision_cfg"], cfg["text_cfg"], cfg["embed_dim"]
    grid = v["image_size"] // v["patch_size"]
    d = {"positional_embedding": (t["context_length"], t["width"]),
         "text_projection": (t["width"], e), "logit_scale": (),
         "visual.class_embedding": (v["width"],),
         "visual.positional_embedding": (grid * grid + 1, v["width"]),
         "visual.proj": (v["width"], e),
         "visual.conv1.weight": (v["width"], 3, v["patch_size"],
                                 v["patch_size"])}
    _affine(d, "visual.ln_pre", v["width"])
    _openclip_blocks(d, "visual.transformer", v["width"], v["layers"])
    _affine(d, "visual.ln_post", v["width"])
    d["token_embedding.weight"] = (t["vocab_size"], t["width"])
    _openclip_blocks(d, "transformer", t["width"], t["layers"])
    _affine(d, "ln_final", t["width"])
    return d


# ——— the reference's diffusion prior ———


def prior_grammar(cfg: dict = PUBLISHED["diffusion_prior"]) -> dict:
    """``diffusion_prior.pt``: input Linear + LayerNorm, per stage a
    ``TimestepEmbedding`` (linear_1, linear_2), a cond Linear and a
    Linear + LayerNorm layer, going down and mirrored coming up, and the
    output Linear (``time_proj`` has no parameters)."""
    hd, n = cfg["hidden_dim"], len(cfg["hidden_dim"])
    tdim, cond = cfg["time_embed_dim"], cfg["cond_dim"]
    d: dict = {}
    _linear(d, "input_layer.0", hd[0], cfg["embed_dim"])
    _affine(d, "input_layer.1", hd[0])
    down = [(i, i + 1) for i in range(n - 1)]
    up = [(i, i - 1) for i in range(n - 1, 0, -1)]
    for side, stages in (("encode", down), ("decode", up)):
        for k, (i, j) in enumerate(stages):
            _linear(d, f"{side}_time_embedding.{k}.linear_1", hd[i], tdim)
            _linear(d, f"{side}_time_embedding.{k}.linear_2", hd[i], hd[i])
            _linear(d, f"{side}_cond_embedding.{k}", hd[i], cond)
            _linear(d, f"{side}_layers.{k}.0", hd[j], hd[i])
            _affine(d, f"{side}_layers.{k}.1", hd[j])
    _linear(d, "output_layer", cfg["embed_dim"], hd[0])
    return d


# ——— counting and synthesis ———


def elements(spec: dict) -> int:
    """Total elements of a ``{name: shape}`` map (or a state dict)."""
    return int(sum(int(np.prod(tuple(getattr(s, "shape", s)),
                               dtype=np.int64)) for s in spec.values()))


def is_norm_scale(name: str, shape) -> bool:
    """A GroupNorm's or LayerNorm's scale: the one 1-D ``.weight`` these
    layouts hold."""
    return name.endswith(".weight") and len(tuple(shape)) == 1


def synth(spec: dict, seed: int, device="cpu",
          dtype: torch.dtype = torch.float16) -> dict[str, torch.Tensor]:
    """The checkpoint of ``spec`` as host tensors of ``dtype``: N(0, 0.02)
    drawn on ``device`` from ``seed`` in the spec's order, norm scales 1,
    ``position_ids`` buffers ``arange`` in int64."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in spec.items():
        shape = tuple(shape)
        if name.endswith("position_ids"):
            out[name] = torch.arange(shape[-1]).expand(shape).clone()
        elif is_norm_scale(name, shape):
            out[name] = torch.ones(shape, dtype=dtype)
        else:
            a = torch.randn(shape, generator=g, device=device) * 0.02
            out[name] = a.to(dtype).cpu()
    return out
