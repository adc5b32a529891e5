"""SDXL's two CLIP text towers (counterpart of
``eeg_image_decode_tpu/gen/text_encoder.py``).

The reference conditions SDXL-turbo on ``encode_prompt('')`` — a non-zero
embedding — through two CLIP text towers inside diffusers
(``Generation/custom_pipeline.py:239-254``), and its recombination notebook
feeds caption prompts (``1x1024_reconstruct_sdxl.ipynb``):

- tower 1: OpenAI CLIP ViT-L/14 text model (``text_encoder``, quick-GELU),
- tower 2: OpenCLIP ViT-bigG/14 text model with projection
  (``text_encoder_2``, GELU),
- context = the two PENULTIMATE hidden states concatenated → (B, 77, 2048),
- pooled  = tower 2's projected EOT feature → (B, 1280),

diffusers' ``StableDiffusionXLPipeline.encode_prompt`` semantics
(``clip_skip=None`` ⇒ ``hidden_states[-2]``, no final LayerNorm). The towers
are the port's ``models/clip_vit.py::CLIPTextTower``; weights come from the
JAX package's ``{"te1": …, "te2": …}`` trees or from the transformers
checkpoints (:func:`convert_hf_clip_text`).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from eeg_image_decode_tpu_torch.models.clip_vit import (
    CLIPTextConfig,
    CLIPTextTower,
)
from eeg_image_decode_tpu_torch.utils.convert_clip import (
    clip_state_dict_from_flax,
)
from eeg_image_decode_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class SDXLTextEncoderConfig:
    clip_l: CLIPTextConfig = field(default_factory=CLIPTextConfig.sdxl_clip_l)
    big_g: CLIPTextConfig = field(default_factory=CLIPTextConfig.sdxl_big_g)

    @property
    def context_dim(self) -> int:
        return self.clip_l.width + self.big_g.width

    @property
    def pooled_dim(self) -> int:
        return self.big_g.embed_dim

    @staticmethod
    def tiny() -> "SDXLTextEncoderConfig":
        return SDXLTextEncoderConfig(clip_l=CLIPTextConfig.tiny("quick_gelu"),
                                     big_g=CLIPTextConfig.tiny("gelu"))


class SDXLTextEncoder:
    """encode(prompts) → (context (B, L, 2048), pooled (B, 1280)), fp32, on
    ``device`` (default: the CUDA card; raises without one). The towers
    hold no values until :meth:`load_flax_params` (or ``load_state_dict``
    of :func:`convert_sdxl_text_encoders`' dicts) gives them weights."""

    def __init__(self, config: SDXLTextEncoderConfig = SDXLTextEncoderConfig(),
                 *, dtype: torch.dtype = torch.float32, device=None):
        self.config = config
        self.device = resolve_device(device)
        # built on meta and given memory on the device: the weights always
        # come from a load (no host copy of bigG's 695 M parameters)
        with torch.device("meta"):
            towers = (CLIPTextTower(config.clip_l, dtype),
                      CLIPTextTower(config.big_g, dtype))
        self.tower1, self.tower2 = (
            t.to_empty(device=self.device).eval() for t in towers)

    def load_flax_params(self, params: dict) -> None:
        """The JAX encoder's ``{"te1": tree, "te2": tree}`` (numpy leaves)."""
        self.tower1.load_state_dict(
            clip_state_dict_from_flax(params["te1"], "text"), strict=True)
        self.tower2.load_state_dict(
            clip_state_dict_from_flax(params["te2"], "text"), strict=True)

    @torch.no_grad()
    def encode_tokens(self, ids1, ids2) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, L) token ids per tokenizer → (context, pooled)."""
        out1 = self.tower1(torch.as_tensor(ids1, device=self.device),
                           return_states=True)
        out2 = self.tower2(torch.as_tensor(ids2, device=self.device),
                           return_states=True)
        context = torch.cat([out1["penultimate"], out2["penultimate"]],
                            dim=-1)
        return context, out2["pooled"].float()

    def encode(self, prompts: list[str], tokenizer1, tokenizer2
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Tokenize with both tokenizers and encode. ``tokenizer1`` pads
        with ``<|endoftext|>``, ``tokenizer2`` with ``!`` (the SDXL
        checkpoint convention: ``CLIPBPETokenizer.from_files(...,
        pad_token="!")``)."""
        return self.encode_tokens(np.asarray(tokenizer1(prompts)),
                                  np.asarray(tokenizer2(prompts)))


def tiny_text_encoder_config(unet_cfg, tokenizer_dir: str
                             ) -> SDXLTextEncoderConfig:
    """Tiny dual-tower config matched to a tiny UNet: the two tower widths
    sum to ``cross_attention_dim``, tower 2's projection emits
    ``pooled_text_embed_dim``, and the vocabulary size comes from the
    tokenizer's ``vocab.json`` (the CLI's ``--tiny`` path)."""
    with open(os.path.join(tokenizer_dir, "vocab.json")) as f:
        vocab_size = len(json.load(f))
    xd = unet_cfg.cross_attention_dim
    w1 = xd // 2
    return SDXLTextEncoderConfig(
        clip_l=CLIPTextConfig(vocab_size=vocab_size, context_length=12,
                              width=w1, layers=2, heads=2, embed_dim=w1,
                              act="quick_gelu"),
        big_g=CLIPTextConfig(vocab_size=vocab_size, context_length=12,
                             width=xd - w1, layers=2, heads=2,
                             embed_dim=unet_cfg.pooled_text_embed_dim,
                             act="gelu"))


# ——————————————————— transformers checkpoint conversion ———————————————————


def convert_hf_clip_text(sd: dict, cfg: CLIPTextConfig
                         ) -> dict[str, torch.Tensor]:
    """transformers ``CLIPTextModel(WithProjection)`` state dict → the port
    tower's ``state_dict`` (fp32, OpenCLIP names): q, k and v rows packed
    into ``in_proj_weight``, ``fc1``/``fc2`` → ``c_fc``/``c_proj``.

    ``text_projection.weight`` exists only on the WithProjection variant
    (SDXL's ``text_encoder_2``); the plain model (``text_encoder``) gets an
    identity projection — SDXL never reads tower 1's pooled output."""
    def a(key):
        return np.asarray(sd[key], np.float32)

    t = "text_model"
    out = {
        "token_embedding.weight": a(f"{t}.embeddings.token_embedding.weight"),
        "positional_embedding": a(f"{t}.embeddings.position_embedding.weight"),
        "ln_final.weight": a(f"{t}.final_layer_norm.weight"),
        "ln_final.bias": a(f"{t}.final_layer_norm.bias"),
    }
    if "text_projection.weight" in sd:
        out["text_projection"] = a("text_projection.weight").T
    else:
        if cfg.width != cfg.embed_dim:
            raise ValueError("a checkpoint without text_projection needs "
                             "width == embed_dim")
        out["text_projection"] = np.eye(cfg.width, dtype=np.float32)
    for i in range(cfg.layers):
        p, q = f"{t}.encoder.layers.{i}", f"transformer.resblocks.{i}"
        for hf, oc in (("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"),
                       ("self_attn.out_proj", "attn.out_proj"),
                       ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj")):
            out[f"{q}.{oc}.weight"] = a(f"{p}.{hf}.weight")
            out[f"{q}.{oc}.bias"] = a(f"{p}.{hf}.bias")
        for leaf, name in (("weight", "in_proj_weight"),
                           ("bias", "in_proj_bias")):
            out[f"{q}.attn.{name}"] = np.concatenate(
                [a(f"{p}.self_attn.{n}_proj.{leaf}") for n in "qkv"])
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def convert_sdxl_text_encoders(sd1: dict, sd2: dict,
                               config: SDXLTextEncoderConfig =
                               SDXLTextEncoderConfig()) -> dict:
    """(text_encoder, text_encoder_2) state dicts → ``{"te1": state_dict,
    "te2": state_dict}`` for :class:`SDXLTextEncoder`'s towers."""
    return {"te1": convert_hf_clip_text(sd1, config.clip_l),
            "te2": convert_hf_clip_text(sd2, config.big_g)}
