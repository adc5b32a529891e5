"""NICE, the baseline encoder (counterpart of
``eeg_image_decode_tpu/models/nice.py``; ref
``Retrieval/contrast_retrieval.py:37-117``): the ShallowNet-derived tsconv
trunk and the projector applied directly to the raw (B, 63, 250) EEG, with
no attention.

    (B, 63, 250) → TSConv (stage 1: the 75-tap stride-5 correlation of
    ``ops/tsconv.py``, the CUDA kernels on the card) → (B, 36, 40)
    → flatten (1440) → ProjectionHead → (B, 1024) fp32
"""

from __future__ import annotations

import torch
from torch import nn

from eeg_image_decode_tpu_torch.models.layers import ProjectionHead, TSConv


class NICE(nn.Module):
    """JAX's fields; ``n_times`` (the port's own, default 250) sizes the
    head's input, which flax infers from the first batch. ``fused_tsconv``
    True / 'auto' runs stage 1 through ``tsconv_pool_fused`` (the kernels
    for CUDA tensors), False through its plain version, as ATM-S's."""

    def __init__(self, n_channels: int = 63, emb_size: int = 40,
                 proj_dim: int = 1024, temporal_kernel: int = 25,
                 pool_size: int = 51, pool_stride: int = 5,
                 fused_tsconv: bool | str = "auto", n_times: int = 250,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.enc_eeg = TSConv(
            filters=40, temporal_kernel=temporal_kernel, pool_size=pool_size,
            pool_stride=pool_stride, emb_size=emb_size,
            spatial_extent=n_channels, fused_stage1=fused_tsconv)
        n_pos = (n_times - (temporal_kernel + pool_size - 1)) // pool_stride + 1
        self.proj_eeg = ProjectionHead(n_pos * emb_size, proj_dim)

    def forward(self, x: torch.Tensor,
                subject_ids: torch.Tensor | None = None, *,
                train: bool | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``subject_ids`` is ignored: NICE is subject-agnostic (JAX
        ``nice.py:35``)."""
        del subject_ids
        train = self.training if train is None else train
        kw = dict(train=train, generator=generator)
        tokens = self.enc_eeg(x, self.dtype, **kw)
        return self.proj_eeg(tokens, self.dtype, **kw)
