"""GIT captioner conditioned on CLIP embeddings, the semantic-level pipeline
(counterpart of ``eeg_image_decode_tpu/models/git_caption.py``).

The EEG-predicted ViT-H CLIP embedding is projected to GIT's visual-token
grid by :class:`PixelProjector`, the projected tokens are prepended to the
text tokens, and a causal decoder generates the caption greedily within a
``max_new_tokens`` budget (the reference's ``GIT_caption_batch.ipynb`` with
``microsoft/git-large-coco``).

:class:`GITCaptioner` carries transformers' ``GitForCausalLM`` module names
(``git.embeddings.word_embeddings``, ``git.encoder.layer.{i}.attention.self.
query``, …, ``output``), so the decoder part of a GIT ``state_dict`` loads
with ``strict=True`` (:func:`convert_git_causal_lm` checks it against the
config and leaves the vision tower, ``git.image_encoder.*``, to
``utils/convert_clip.py::convert_hf_clip_vision``). The JAX package's
pickled param tree loads through :meth:`GITCaptioner.load_params`.

The decoder runs in fp32 by default, as the JAX CLI and service run it,
or in ``dtype`` (bfloat16), as JAX's ``GITCaptioner(dtype=…)``. The
arithmetic is the JAX module's, rounding point for rounding point:
BERT-style post-LN blocks (LayerNorm eps 1e-12; exact GELU), flax's
attention (q scaled by 1/√head_dim before the product, masked logits
filled with ``finfo(dtype).min``), the visual projection's LayerNorm at
eps 1e-5, and an untied lm head with no final LayerNorm. Every dense layer
is a product followed by the bias add in ``dtype``, as flax's ``Dense``
computes it; the LayerNorms run in fp32 and are cast back to ``dtype``,
the embeddings are cast to it, and the lm head runs in fp32. Plain
PyTorch: the JAX decoder is plain XLA.

Attention layout (GIT, Wang et al. 2022): image queries attend only to
image tokens; text query i attends to every image token and the text
tokens up to i.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eeg_image_decode_tpu_torch.utils.convert import git_state_dict_from_flax

_F32 = torch.float32


@dataclass(frozen=True)
class GITConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 6
    n_heads: int = 12
    d_ff: int = 3072
    #: size of the learned position table (GIT checkpoints: 1024)
    max_position_embeddings: int = 1024
    #: decode buffer length (caption budget)
    max_text_len: int = 64
    num_visual_tokens: int = 257
    visual_dim: int = 1024  # CLIP ViT-L/14 grid features GIT-large consumes
    bos_token_id: int = 101  # BERT [CLS]
    eos_token_id: int = 102  # BERT [SEP]
    pad_token_id: int = 0
    dropout: float = 0.1

    @staticmethod
    def git_large_coco() -> "GITConfig":
        """microsoft/git-large-coco (the reference's checkpoint): a
        1024-wide 6-layer decoder with 16 heads and a 4096 FFN over CLIP
        ViT-L/14 grids. For a real checkpoint prefer
        :func:`git_config_from_state_dict`, which reads every dimension off
        the weights."""
        return GITConfig(d_model=1024, n_heads=16, d_ff=4096)

    @staticmethod
    def git_base() -> "GITConfig":
        """microsoft/git-base (transformers ``GitConfig()`` defaults)."""
        return GITConfig()

    @staticmethod
    def tiny() -> "GITConfig":
        return GITConfig(
            vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            max_position_embeddings=16, max_text_len=8, num_visual_tokens=3,
            visual_dim=16, bos_token_id=1, eos_token_id=2,
        )


def _dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype
           ) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: the product in ``dtype``, then the bias
    add in ``dtype`` (two roundings, as XLA computes it)."""
    return (torch.matmul(x.to(dtype), lin.weight.to(dtype).t())
            + lin.bias.to(dtype))


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax ``LayerNorm(dtype=float32)``: fp32 in, fp32 out."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps)


class PixelProjector(nn.Module):
    """ViT-H CLIP embedding (B, in_dim) → GIT visual tokens (B, num_tokens,
    out_dim), fp32 (the reference adapter, ``image_adapter.ipynb`` cell 3).

    Each embedding channel is expanded to ``num_tokens`` tokens by a shared
    Linear(1 → num_tokens) and a LayerNorm over the token axis, then each
    token goes through Linear(in_dim → out_dim) and a LayerNorm. Both
    LayerNorms take ``eps``, computed in fp32: by default flax's 1e-6, the
    JAX module's and that of the pickles ``cli train-adapter`` writes; the
    reference's ``torch.nn.LayerNorm`` uses 1e-5, which
    ``utils/convert.py::reference_pixel_projector`` sets for its weights.
    The parameters stay fp32; the products run in ``dtype``, the JAX
    module's rounding points: cast, the expand product on (B, D, 1), the
    fp32 LayerNorm, the transpose and cast back, the projection, the fp32
    LayerNorm. The reference's ``Sequential`` (indices 1, 2, 4, 5) loads
    through ``utils/convert.py::convert_pixel_projector``."""

    def __init__(self, num_tokens: int = 257, in_dim: int = 1024,
                 out_dim: int = 1024, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.expand = nn.Linear(1, num_tokens)
        self.ln_tokens = nn.LayerNorm(num_tokens, eps=eps)
        self.proj = nn.Linear(in_dim, out_dim)
        self.ln = nn.LayerNorm(out_dim, eps=eps)

    def forward(self, clip_embeds: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        """``dtype`` (default: the module's) sets the products' dtype."""
        dt = dtype or self.dtype
        x = _dense(clip_embeds.to(dt)[:, :, None], self.expand, dt)
        x = _layer_norm(x, self.ln_tokens).transpose(1, 2).to(dt)
        return _layer_norm(_dense(x, self.proj, dt), self.ln)

    def init_random(self, seed: int) -> "PixelProjector":
        """flax's default init, drawn from ``seed`` where the parameters
        lie: dense kernels LeCun-normal (a normal of variance 1/fan_in
        truncated at ±2σ, rescaled to keep the variance), biases 0,
        LayerNorms at identity."""
        g = torch.Generator(device=self.expand.weight.device).manual_seed(
            int(seed))
        with torch.no_grad():
            for lin in (self.expand, self.proj):
                std = math.sqrt(1.0 / lin.in_features) / 0.87962566103423978
                w = torch.empty_like(lin.weight)
                # truncated at ±2σ by redrawing what falls outside
                w.normal_(0.0, 1.0, generator=g)
                while bool((w.abs() > 2).any()):
                    bad = w.abs() > 2
                    w[bad] = torch.empty_like(w[bad]).normal_(0.0, 1.0,
                                                              generator=g)
                lin.weight.copy_(w * std)
                lin.bias.zero_()
            for ln in (self.ln_tokens, self.ln):
                ln.weight.fill_(1.0)
                ln.bias.zero_()
        return self


class _SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)


class _DenseLN(nn.Module):
    """A dense layer and the post-LN that follows its residual
    (``GitSelfOutput`` / ``GitOutput``)."""

    def __init__(self, d_in: int, d: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d)
        self.LayerNorm = nn.LayerNorm(d, eps=1e-12)


class _Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.add_module("self", _SelfAttention(d))
        self.output = _DenseLN(d, d)


class _Intermediate(nn.Module):
    def __init__(self, d: int, d_ff: int):
        super().__init__()
        self.dense = nn.Linear(d, d_ff)


class _GITLayer(nn.Module):
    """BERT-style post-LN block (``GitLayer``)."""

    def __init__(self, cfg: GITConfig):
        super().__init__()
        self.n_heads = cfg.n_heads
        self.attention = _Attention(cfg.d_model)
        self.intermediate = _Intermediate(cfg.d_model, cfg.d_ff)
        self.output = _DenseLN(cfg.d_ff, cfg.d_model)

    def _attend(self, x: torch.Tensor, mask: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        """flax ``MultiHeadDotProductAttention(dtype=dtype)`` with a boolean
        mask; below fp32 the softmax's steps (x − max, exp, the row sum,
        the quotient) are each rounded to ``dtype``, as flax computes it
        without ``force_fp32_for_softmax``."""
        B, n, d = x.shape
        hd = d // self.n_heads
        sa = getattr(self.attention, "self")

        def heads(lin):
            return _dense(x, lin, dtype).view(B, n, self.n_heads,
                                            hd).transpose(1, 2)

        q, k, v = heads(sa.query), heads(sa.key), heads(sa.value)
        # flax: q / sqrt(depth), the divisor rounded to fp32, then to dtype
        q = q / float(torch.tensor(math.sqrt(hd), dtype=_F32).to(dtype))
        w = torch.matmul(q, k.transpose(-1, -2))
        w = w.masked_fill(~mask, torch.finfo(dtype).min)
        if dtype == _F32:
            w = torch.softmax(w, dim=-1)
        else:
            e = torch.exp(w - w.amax(-1, keepdim=True))
            w = e / e.sum(-1, keepdim=True)
        a = torch.matmul(w, v).transpose(1, 2).reshape(B, n, d)
        return _dense(a, self.attention.output.dense, dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                dtype: torch.dtype = _F32) -> torch.Tensor:
        x = _layer_norm(x + self._attend(x, mask, dtype),
                        self.attention.output.LayerNorm).to(dtype)
        f = F.gelu(_dense(x, self.intermediate.dense, dtype))
        f = _dense(f, self.output.dense, dtype)
        return _layer_norm(x + f, self.output.LayerNorm).to(dtype)


class _Embeddings(nn.Module):
    def __init__(self, cfg: GITConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.d_model)
        self.LayerNorm = nn.LayerNorm(cfg.d_model, eps=1e-12)


class _Encoder(nn.Module):
    def __init__(self, cfg: GITConfig):
        super().__init__()
        self.layer = nn.ModuleList(_GITLayer(cfg)
                                   for _ in range(cfg.n_layers))


class _VisualProjection(nn.Module):
    """``GitProjection``: Linear + LayerNorm (eps 1e-5); no positions."""

    def __init__(self, cfg: GITConfig):
        super().__init__()
        self.visual_projection = nn.Sequential(
            nn.Linear(cfg.visual_dim, cfg.d_model),
            nn.LayerNorm(cfg.d_model, eps=1e-5))


class _GitModel(nn.Module):
    def __init__(self, cfg: GITConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.visual_projection = _VisualProjection(cfg)


def git_attention_mask(n_visual: int, n_text: int, device=None
                       ) -> torch.Tensor:
    """(n, n) boolean GIT mask, n = visual + text tokens: image queries see
    only image tokens; text query i sees every image token and text ≤ i
    (``GitModel.create_attention_mask``)."""
    n = n_visual + n_text
    q = torch.arange(n, device=device)[:, None]
    k = torch.arange(n, device=device)[None, :]
    return torch.where(q >= n_visual, k <= q, k < n_visual)


class GITCaptioner(nn.Module):
    """The GIT decoder, its products in ``dtype`` (fp32 by default, as the
    JAX CLI and service run it; bfloat16 as JAX's ``GITCaptioner(dtype=
    jnp.bfloat16)``) with fp32 parameters, LayerNorms and lm head; built
    on the current default device."""

    def __init__(self, config: GITConfig = GITConfig(),
                 dtype: torch.dtype = _F32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.git = _GitModel(config)
        # untied lm head (flax ``Dense(dtype=float32)``)
        self.output = nn.Linear(config.d_model, config.vocab_size)

    def forward(self, visual_tokens: torch.Tensor,
                token_ids: torch.Tensor) -> torch.Tensor:
        """(B, V, visual_dim) visual tokens, (B, L) ids → fp32 logits
        (B, L, vocab) at the text positions."""
        g, dt = self.git, self.dtype
        V, L = visual_tokens.shape[1], token_ids.shape[1]
        proj, vis_ln = g.visual_projection.visual_projection
        vis = _layer_norm(_dense(visual_tokens, proj, dt), vis_ln).to(dt)
        emb = g.embeddings
        tok = emb.word_embeddings(token_ids).to(dt)
        pos = emb.position_embeddings.weight[:L].to(dt)
        txt = _layer_norm(tok + pos[None], emb.LayerNorm).to(dt)
        x = torch.cat([vis, txt], dim=1)
        mask = git_attention_mask(V, L, device=x.device)
        for layer in g.encoder.layer:
            x = layer(x, mask, dt)
        return _dense(x[:, V:], self.output, _F32)

    @torch.inference_mode()
    def generate(self, visual_tokens: torch.Tensor, *,
                 max_new_tokens: int = 25) -> torch.Tensor:
        """Greedy decode, the JAX ``_decode_jit`` step for step: a fixed
        buffer of ``min(max_text_len, max_new_tokens + 1)`` ids with BOS at
        0, the whole forward recomputed at every step, the argmax of
        position i − 1 (the first maximum, as ``jnp.argmax``) written at i;
        rows that have emitted EOS are padded with ``pad_token_id``. →
        (B, buffer) int64 on the device, with no readback inside the loop.
        """
        cfg = self.config
        B = visual_tokens.shape[0]
        buf_len = min(cfg.max_text_len, int(max_new_tokens) + 1)
        tokens = torch.full((B, buf_len), cfg.pad_token_id, dtype=torch.long,
                            device=visual_tokens.device)
        tokens[:, 0] = cfg.bos_token_id
        done = torch.zeros(B, dtype=torch.bool, device=tokens.device)
        pad = torch.full_like(done, cfg.pad_token_id, dtype=torch.long)
        for i in range(1, buf_len):
            logits = self(visual_tokens, tokens)[:, i - 1]
            nxt = torch.where(done, pad, logits.argmax(dim=-1))
            tokens[:, i] = nxt
            done = done | (nxt == cfg.eos_token_id)
        return tokens

    def init_random(self, seed: int = 0) -> "GITCaptioner":
        """Seeded random weights where the parameters lie (a smoke run's;
        real ones through :meth:`load_params` or
        :func:`convert_git_causal_lm`): dense and embedding weights
        N(0, 0.02) (transformers' ``initializer_range``), biases 0,
        LayerNorms at identity."""
        g = torch.Generator(device=self.output.weight.device).manual_seed(
            int(seed))
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, (nn.Linear, nn.Embedding)):
                    m.weight.normal_(0.0, 0.02, generator=g)
                    if getattr(m, "bias", None) is not None:
                        m.bias.zero_()
        return self

    def load_params(self, tree: dict) -> "GITCaptioner":
        """The JAX ``GITCaptioner`` param tree (nested dicts of numpy
        arrays: the ``--git-params`` pickle), strict."""
        self.load_state_dict(git_state_dict_from_flax(tree), strict=True)
        return self


def caption_embeddings(captioner: GITCaptioner, projector: PixelProjector,
                       clip_embeds, tokenizer, *,
                       max_new_tokens: int = 25) -> list[str]:
    """EEG-predicted CLIP embeddings → caption strings (``PixelProjector``
    → greedy GIT → WordPiece decode; ``GIT_caption_batch.ipynb`` cell 8).
    With ``tokenizer=None`` each string is the row's raw ids, separated by
    spaces. The projector runs at the captioner's dtype, as JAX builds it
    there."""
    dev = captioner.output.weight.device
    with torch.inference_mode():
        grids = projector(torch.as_tensor(clip_embeds, dtype=torch.float32
                                          ).to(dev), dtype=captioner.dtype)
        tokens = captioner.generate(grids, max_new_tokens=max_new_tokens)
    if tokenizer is None:
        return [" ".join(str(t) for t in row) for row in tokens.cpu().numpy()]
    return [tokenizer.decode(row) for row in tokens.cpu().numpy()]


# ——— the shape of a checkpoint ———


def git_config_from_state_dict(sd: dict, *, n_heads: int | None = None,
                               **overrides) -> GITConfig:
    """A :class:`GITConfig` from a ``GitForCausalLM`` state dict: every
    decoder dimension from the weights (the word and position tables,
    ``intermediate.dense``, the visual projection, the highest
    ``git.encoder.layer.{i}``), so a checkpoint of another size converts
    instead of truncating. Non-contiguous layer indices raise. ``n_heads``
    cannot be read off a state dict: GIT's heads are 64 wide in every
    released size, so it defaults to ``d_model // 64``. Decode-time fields
    keep their defaults unless overridden by keyword."""
    vocab_size, d_model = np.shape(sd["git.embeddings.word_embeddings.weight"])
    max_pos = int(np.shape(
        sd["git.embeddings.position_embeddings.weight"])[0])
    d_ff = int(np.shape(
        sd["git.encoder.layer.0.intermediate.dense.weight"])[0])
    visual_dim = int(np.shape(
        sd["git.visual_projection.visual_projection.0.weight"])[1])
    layer_ids = {int(k.split(".")[3]) for k in sd
                 if k.startswith("git.encoder.layer.")}
    n_layers = max(layer_ids) + 1
    if layer_ids != set(range(n_layers)):
        raise ValueError(
            f"non-contiguous git.encoder.layer indices: {sorted(layer_ids)}")
    if n_heads is None:
        if d_model % 64:
            raise ValueError(
                f"d_model={d_model} is not a multiple of 64; pass n_heads= "
                "explicitly for this checkpoint")
        n_heads = d_model // 64
    fields = dict(
        vocab_size=int(vocab_size), d_model=int(d_model), n_layers=n_layers,
        n_heads=int(n_heads), d_ff=d_ff, max_position_embeddings=max_pos,
        visual_dim=visual_dim,
    )
    fields.update(overrides)
    return GITConfig(**fields)


def git_config_from_params(params: dict, *, n_heads: int | None = None,
                           **overrides) -> GITConfig:
    """A :class:`GITConfig` from the JAX decoder's param tree (the
    ``--git-params`` pickle), so a loader builds a decoder of the weights'
    shape instead of trusting a preset; ``n_heads`` from the q bias's
    (heads, head_dim) shape."""
    vocab_size, d_model = np.shape(params["token_embed"]["embedding"])
    max_pos = int(np.shape(params["pos_embed"]["embedding"])[0])
    d_ff = int(np.shape(params["layer_0"]["ff1"]["kernel"])[1])
    visual_dim = int(np.shape(params["visual_proj"]["kernel"])[0])
    n_layers = 1 + max(
        int(k.split("_")[1]) for k in params if k.startswith("layer_"))
    if n_heads is None:
        n_heads = int(np.shape(params["layer_0"]["attn"]["query"]["bias"])[0])
    fields = dict(
        vocab_size=int(vocab_size), d_model=int(d_model), n_layers=n_layers,
        n_heads=n_heads, d_ff=d_ff, max_position_embeddings=max_pos,
        visual_dim=visual_dim,
    )
    fields.update(overrides)
    return GITConfig(**fields)


def convert_git_causal_lm(sd: dict, cfg: GITConfig | None = None
                          ) -> tuple[GITConfig, dict[str, torch.Tensor]]:
    """A ``GitForCausalLM`` (or the reference's ``GitForCausalLMClipEmb``)
    state dict → (config, the decoder's ``state_dict`` for
    :class:`GITCaptioner`, fp32). The vision tower (``git.image_encoder.*``)
    is left out: the captioner takes precomputed grids. So are the
    ``position_ids`` index buffers that files saved by transformers before
    its 4.31 release carry (int64, not weights).

    With ``cfg=None`` the config is derived from the weights
    (:func:`git_config_from_state_dict`). A config passed in is checked
    against them: a checkpoint with more layers, another width or another
    vocabulary raises instead of truncating."""
    if cfg is None:
        cfg = git_config_from_state_dict(sd)
    else:
        derived = git_config_from_state_dict(sd, n_heads=cfg.n_heads)
        mismatches = [
            f"{f}: cfg={getattr(cfg, f)} checkpoint={getattr(derived, f)}"
            for f in ("vocab_size", "d_model", "n_layers", "d_ff",
                      "max_position_embeddings", "visual_dim")
            if getattr(cfg, f) != getattr(derived, f)
        ]
        if cfg.d_model % cfg.n_heads:
            mismatches.append(
                f"n_heads: {cfg.n_heads} does not divide d_model")
        if mismatches:
            raise ValueError(
                "GITConfig does not match the checkpoint ("
                + "; ".join(mismatches)
                + ") — use git_config_from_state_dict(sd) or fix the config")
    out = {}
    for k, v in sd.items():
        if k.startswith("git.image_encoder.") or k.endswith("position_ids"):
            continue
        out[k] = (v.detach().float() if torch.is_tensor(v)
                  else torch.from_numpy(np.array(v, dtype=np.float32)))
    return cfg, out
