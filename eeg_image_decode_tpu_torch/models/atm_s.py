"""ATM-S, the flagship EEG encoder (counterpart of
``eeg_image_decode_tpu/models/atm_s.py``; ref
``Retrieval/ATMS_retrieval.py:44-191``):

    (B, 63, 250) EEG
      → ChannelTokenEmbedding: Dense(250→250) per channel + positions
        + subject token prepended
      → post-norm attention layer(s) over the 64 tokens, 4 heads of 62,
        FFN 256 (ops/attention.py: one CUDA kernel per layer on the card)
      → encoder_norm (fp32 LayerNorm), keep the first 63 tokens
      → TSConv (stage 1 in ops/tsconv.py) → (B, 36, 40)
      → flatten (1440) → ProjectionHead → (B, 1024) fp32

In train mode dropout is on at the reference's seven sites and BatchNorm
uses batch statistics. ``dropout_masks`` pins every site to pre-scaled
keep-masks in the JAX dict convention (``"emb"``, ``"layer{i}"`` →
{``m_attn``, ``m_res``, ``m_ffn1``, ``m_ffn2``}, ``"tsconv"``, ``"proj"``;
a missing key keeps everything). Without it, each attention layer draws an
int32 seed from ``generator`` on the device (seed mode: the masks are drawn
inside the CUDA kernels, or by ``ops/attention.py::draw_keep_masks`` for the
plain layer), and the other three sites draw ``torch.rand`` masks, which the
JAX package also draws outside any kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from eeg_image_decode_tpu_torch.core.config import ATMSConfig
from eeg_image_decode_tpu_torch.models.layers import (
    Dense,
    LNParams,
    ProjectionHead,
    TSConv,
    check_fused,
    layer_norm_fast,
)
from eeg_image_decode_tpu_torch.models.subject_embed import (
    ChannelTokenEmbedding,
)
from eeg_image_decode_tpu_torch.ops.attention import (
    MASK_ORDER,
    attention_layer_reference,
    draw_keep_masks,
    fused_attention_layer,
)
from eeg_image_decode_tpu_torch.parallel.collectives import sample_offset


class ChannelAttentionLayer(nn.Module):
    """Post-norm transformer encoder layer (ref ``Transformer_EncDec.py:27-51``).

    Faithful quirks: head dim = d_model // n_heads (250//4 = 62, so the QKV
    projections are 250→248), softmax scale 1/√62, FFN as two Dense layers.
    ``fused`` True/'auto' runs ``fused_attention_layer`` (the kernel for a
    CUDA tensor, its plain version on the CPU); ``exact_gelu=True`` needs the
    erf GELU the kernel does not compute, so it forces the plain layer."""

    def __init__(self, d_model: int = 250, n_heads: int = 4, d_ff: int = 256,
                 fused: bool | str = "auto", exact_gelu: bool = False,
                 dropout: float = 0.25):
        super().__init__()
        check_fused(fused, "fused_attention")
        self.n_heads = n_heads
        self.dropout = dropout
        self.exact_gelu = exact_gelu
        self.use_kernel = bool(fused) and not exact_gelu
        inner = (d_model // n_heads) * n_heads
        self.q_proj = Dense(d_model, inner)
        self.k_proj = Dense(d_model, inner)
        self.v_proj = Dense(d_model, inner)
        self.out_proj = Dense(inner, d_model)
        self.norm1 = LNParams(d_model)
        self.ffn_in = Dense(d_model, d_ff)
        self.ffn_out = Dense(d_ff, d_model)
        self.norm2 = LNParams(d_model)

    def params(self) -> dict:
        """The layer's weights under the kernel's parameter names."""
        return {
            "wq": self.q_proj.kernel, "bq": self.q_proj.bias,
            "wk": self.k_proj.kernel, "bk": self.k_proj.bias,
            "wv": self.v_proj.kernel, "bv": self.v_proj.bias,
            "wo": self.out_proj.kernel, "bo": self.out_proj.bias,
            "ln1_s": self.norm1.scale, "ln1_b": self.norm1.bias,
            "w1": self.ffn_in.kernel, "b1": self.ffn_in.bias,
            "w2": self.ffn_out.kernel, "b2": self.ffn_out.bias,
            "ln2_s": self.norm2.scale, "ln2_b": self.norm2.bias,
        }

    def forward(self, x: torch.Tensor, *, train: bool = False,
                dropout_masks: dict | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``dropout_masks``: the layer's pinned keep-masks (mask mode; a
        missing one keeps everything). Otherwise train mode with dropout > 0
        draws the layer's seed from ``generator`` (seed mode)."""
        B, L, D = x.shape
        FF = self.ffn_in.kernel.shape[1]
        masks, seed, p = None, None, 0.0
        if dropout_masks:
            shapes = {"m_attn": (B, self.n_heads, L, L), "m_res": (B, L, D),
                      "m_ffn1": (B, L, FF), "m_ffn2": (B, L, D)}
            masks = {k: dropout_masks[k] if k in dropout_masks
                     else torch.ones(shapes[k], device=x.device)
                     for k in MASK_ORDER}
        elif dropout_masks is None and train and self.dropout > 0.0:
            p = self.dropout
            seed = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                 device=x.device, dtype=torch.int32)
        # in a data-parallel scope: this rank's first global sample
        sample0 = sample_offset(B)
        if self.use_kernel:
            return fused_attention_layer(x, self.params(), self.n_heads,
                                         masks=masks, dropout_p=p, seed=seed,
                                         sample0=sample0)
        if seed is not None:
            masks = draw_keep_masks(seed.item(), B, self.n_heads, L, D, FF,
                                    p, row0=sample0, device=x.device)
        params = {k: v.to(x.dtype) for k, v in self.params().items()}
        return attention_layer_reference(x, params, self.n_heads, masks=masks,
                                         exact_gelu=self.exact_gelu)


class ATMS(nn.Module):
    """ATM-S encoder → (B, proj_dim) fp32 CLIP-space features."""

    def __init__(self, config: ATMSConfig = ATMSConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.embedding = ChannelTokenEmbedding(
            n_channels=cfg.n_channels, seq_len=cfg.seq_len,
            d_model=cfg.d_model, num_subjects=cfg.num_subjects,
            joint_train=cfg.joint_train, dropout=cfg.dropout)
        for i in range(cfg.n_layers):
            self.add_module(f"encoder_layer_{i}", ChannelAttentionLayer(
                d_model=cfg.d_model, n_heads=cfg.n_heads, d_ff=cfg.d_ff,
                fused=cfg.fused_attention, exact_gelu=cfg.exact_gelu,
                dropout=cfg.dropout))
        self.encoder_norm = LNParams(cfg.d_model)
        self.enc_eeg = TSConv(
            filters=cfg.conv_filters, temporal_kernel=cfg.temporal_kernel,
            pool_size=cfg.pool_size, pool_stride=cfg.pool_stride,
            emb_size=cfg.emb_size, spatial_extent=cfg.n_channels,
            dropout=cfg.conv_dropout, fused_stage1=cfg.fused_tsconv,
            bn1_impl=cfg.tsconv_bn1)
        k_fused = cfg.temporal_kernel + cfg.pool_size - 1
        n_pos = (cfg.d_model - k_fused) // cfg.pool_stride + 1
        self.proj_eeg = ProjectionHead(
            n_pos * cfg.emb_size, cfg.proj_dim, fused=cfg.fused_projection,
            dropout=cfg.proj_dropout)

    def forward(self, x: torch.Tensor,
                subject_ids: torch.Tensor | None = None, *,
                train: bool | None = None, dropout_masks: dict | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``train`` defaults to the module's mode (``.train()`` /
        ``.eval()``); ``generator`` draws the dropout masks and seeds (on
        x's device) when ``dropout_masks`` is not given."""
        train = self.training if train is None else train
        pinned = dropout_masks is not None
        dm = dropout_masks or {}
        # pinned masks: a missing site keeps everything, as in the JAX model
        keep_all = torch.ones((), device=x.device) if pinned else None
        kw = dict(train=train, generator=generator)
        h = self.embedding(x, subject_ids, self.dtype,
                           dropout_mask=dm.get("emb", keep_all), **kw)
        for i in range(self.config.n_layers):
            h = getattr(self, f"encoder_layer_{i}")(
                h, dropout_masks=dm.get(f"layer{i}", {}) if pinned else None,
                **kw)
        h = layer_norm_fast(h, self.encoder_norm)
        # keep the first n_channels tokens: with the subject token prepended
        # this keeps [subject, ch_0..ch_61] and drops the last electrode, as
        # the reference does (``ATMS_retrieval.py:91``)
        h = h[:, : self.config.n_channels, :]
        tokens = self.enc_eeg(h, self.dtype,
                              dropout_mask=dm.get("tsconv", keep_all), **kw)
        return self.proj_eeg(tokens, self.dtype,
                             dropout_mask=dm.get("proj", keep_all), **kw)
