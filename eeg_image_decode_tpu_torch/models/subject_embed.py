"""Subject-conditioned embedding of EEG channel tokens (counterpart of
``eeg_image_decode_tpu/models/subject_embed.py``; ref
``models/subject_layers/Embed.py:109-162``): each electrode's time course
becomes a token, a sinusoidal positional code is added, and a learned
per-subject token is prepended.
"""

from __future__ import annotations

import torch
from torch import nn

from eeg_image_decode_tpu_torch.models.layers import (
    Dense,
    dropout,
    sinusoidal_position_embedding,
)
from eeg_image_decode_tpu_torch.parallel.collectives import (
    active_mesh,
    global_any,
)


class SubjectToken(nn.Module):
    """Per-subject learned token with a shared fallback (ref
    ``Embed.py:109-121``). Reference quirk reproduced: if *any* id in the
    batch is ≥ ``num_subjects``, the shared token replaces the token of
    every row of the batch: of the global batch in a data-parallel scope,
    as under GSPMD."""

    def __init__(self, num_subjects: int, d_model: int):
        super().__init__()
        self.num_subjects = num_subjects
        self.subject_embedding = nn.Parameter(torch.zeros(num_subjects, d_model))
        self.shared_embedding = nn.Parameter(torch.zeros(1, d_model))

    def forward(self, subject_ids: torch.Tensor) -> torch.Tensor:
        any_oor = (subject_ids >= self.num_subjects).any()
        mesh = active_mesh()
        if mesh is not None:
            any_oor = global_any(any_oor, mesh)
        safe = subject_ids.clamp(0, self.num_subjects - 1).long()
        tok = torch.where(any_oor, self.shared_embedding,
                          self.subject_embedding[safe])
        return tok[:, None, :]  # (B, 1, d_model)


class ChannelTokenEmbedding(nn.Module):
    """(B, C, T) EEG → (B, C+1, d_model) tokens in ``dtype`` (ref
    ``Embed.py:124-162``): a Dense over time shared by all channels, plus the
    positional code over the C channel rows, then the subject token at
    position 0, then one dropout over the whole token sequence, the subject
    token included (``Embed.py:162``).

    ``joint_train=True`` (ref ``Embed.py:127-130,142-144``) replaces the
    shared Dense by per-subject value embeddings ``subject_value_w``
    (num_subjects, seq_len, d_model) and ``subject_value_b`` (num_subjects,
    d_model): one gather of the rows' weights by their clipped subject ids
    and one batched product, accumulated in fp32 and rounded once to the
    working dtype. No ``value_embedding`` parameter exists in this mode."""

    def __init__(self, n_channels: int = 63, seq_len: int = 250,
                 d_model: int = 250, num_subjects: int = 10,
                 joint_train: bool = False, dropout: float = 0.25):
        super().__init__()
        self.dropout = dropout
        self.joint_train = joint_train
        self.num_subjects = num_subjects
        if joint_train:
            self.subject_value_w = nn.Parameter(
                torch.zeros(num_subjects, seq_len, d_model))
            self.subject_value_b = nn.Parameter(
                torch.zeros(num_subjects, d_model))
        else:
            self.value_embedding = Dense(seq_len, d_model)
        self.subject_token = SubjectToken(num_subjects, d_model)
        self.register_buffer(
            "pe", torch.from_numpy(
                sinusoidal_position_embedding(n_channels, d_model)),
            persistent=False)

    def forward(self, x: torch.Tensor, subject_ids: torch.Tensor | None,
                dtype: torch.dtype, *, train: bool = False, dropout_mask=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.to(dtype)
        if self.joint_train:
            if subject_ids is None:
                raise ValueError("joint_train requires subject_ids")
            ids = subject_ids.clamp(0, self.num_subjects - 1).long()
            # torch.bmm accumulates in fp32 and rounds once to dtype
            x = torch.bmm(x, self.subject_value_w[ids].to(dtype)) \
                + self.subject_value_b[ids][:, None, :].to(dtype)
        else:
            x = self.value_embedding(x)
        if x.shape[1] != self.pe.shape[0]:
            raise ValueError(f"expected {self.pe.shape[0]} channels, "
                             f"got {x.shape[1]}")
        x = x + self.pe.to(dtype)
        if subject_ids is not None:
            tok = self.subject_token(subject_ids).to(dtype)
            x = torch.cat([tok, x], dim=1)
        return dropout(x, self.dropout, train=train, mask=dropout_mask,
                       generator=generator)
