"""ATM-E, the time-token attention variant of the ATM encoder (counterpart
of ``eeg_image_decode_tpu/models/atm_e.py``; ref
``Retrieval/ATME_retrieval.py:29-148``):

    (B, 63, 250) → time tokens (B, 250, 63) + the sinusoidal code
    → one post-norm TimeAxisAttention layer (1 head of 63, ReLU FFN 2048,
      dropout 0.1)
    → back to (B, 63, 250) → subject_linear, Dense 250 → 250 on time
    → EEGNetV4(out_dim=1440) → ProjectionHead → (B, 1024) fp32

Plain PyTorch: the JAX module is flax's attention and XLA convolutions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from eeg_image_decode_tpu_torch.models.eegnetv4 import EEGNetV4
from eeg_image_decode_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    MultiHeadDotProductAttention,
    ProjectionHead,
    dropout,
    sinusoidal_position_embedding,
)


class TimeAxisAttention(nn.Module):
    """One post-norm transformer layer over (B, T, d_model) time tokens
    (torch ``nn.TransformerEncoderLayer``'s defaults: ReLU FFN 2048,
    dropout 0.1); the LayerNorms return fp32, as flax's
    ``LayerNorm(dtype=jnp.float32)``."""

    def __init__(self, d_model: int = 63, n_heads: int = 1,
                 d_ff: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadDotProductAttention(d_model, n_heads,
                                                      dropout)
        self.norm1 = LayerNorm(d_model)
        self.ffn_in = Dense(d_model, d_ff)
        self.ffn_out = Dense(d_ff, d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, x: torch.Tensor, dtype: torch.dtype, *,
                train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        kw = dict(train=train, generator=generator)
        a = self.self_attn(x, dtype, **kw)
        x = self.norm1(x + dropout(a, self.dropout, **kw))
        y = F.relu(self.ffn_in(x, dtype))
        y = dropout(y, self.dropout, **kw)
        y = self.ffn_out(y, dtype)
        return self.norm2(x + dropout(y, self.dropout, **kw))


class ATME(nn.Module):
    def __init__(self, n_channels: int = 63, seq_len: int = 250,
                 emb_dim: int = 1440, proj_dim: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("pe", torch.from_numpy(
            sinusoidal_position_embedding(seq_len, n_channels)),
            persistent=False)
        self.attention = TimeAxisAttention(d_model=n_channels)
        self.subject_linear = Dense(seq_len, seq_len)
        self.enc_eeg = EEGNetV4(n_channels=n_channels, n_times=seq_len,
                                out_dim=emb_dim, dtype=dtype)
        self.proj_eeg = ProjectionHead(emb_dim, proj_dim)

    def forward(self, x: torch.Tensor,
                subject_ids: torch.Tensor | None = None, *,
                train: bool | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``subject_ids`` is ignored: the reference always applies its
        first subject-wise linear (JAX ``atm_e.py:63``)."""
        del subject_ids
        train = self.training if train is None else train
        dt = self.dtype
        kw = dict(train=train, generator=generator)
        h = x.transpose(1, 2).to(dt) + self.pe.to(dt)        # (B, T, C)
        h = self.attention(h, dt, **kw)
        h = self.subject_linear(h.transpose(1, 2), dt)       # (B, C, T)
        feats = self.enc_eeg(h, **kw)
        return self.proj_eeg(feats, dt, **kw)
