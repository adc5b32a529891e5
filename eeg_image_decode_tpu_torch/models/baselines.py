"""The baseline encoder zoo (counterpart of
``eeg_image_decode_tpu/models/baselines.py``; ref
``Retrieval/contrast_retrieval.py:210-491``): MLPProjector,
ShallowFBCSPNet, EEGConformer, EEGITNet, ATCNet and MetaEEG, each at the
reference's hyperparameters (the JAX defaults). All map (B, 63, 250) →
(B, 1024).

Plain PyTorch, as the JAX modules are plain XLA. Convolutions run
channels-first (NCHW, or (B, C, L) for 1-D) with flax's kernel layouts
(``layers.conv``); BatchNorm normalises the channel axis and returns fp32,
as flax's ``BatchNorm(dtype=jnp.float32)``; LayerNorm is flax's (eps 1e-6,
fp32 out). A Dense or Conv casts its input to the working dtype, as flax's
``dtype=`` does, so the rounding points are JAX's. The depthwise
convolutions over all 63 electrodes run as batched products
(``layers.electrode_conv``). Where JAX flattens an
NHWC map, the map is put back into NHWC order first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from eeg_image_decode_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
    LayerNorm,
    MultiHeadDotProductAttention,
    dropout,
    electrode_conv,
    same_padding,
    sinusoidal_position_embedding,
)

F32 = torch.float32


def _safe_log(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=eps))


def _mode(module: nn.Module, train: bool | None) -> bool:
    return module.training if train is None else train


class MLPProjector(nn.Module):
    """The pure-MLP ``Projector`` (ref ``contrast_retrieval.py:210-281``):
    alternating per-time and per-channel Dense blocks with LayerNorm, exact
    GELU and dropout; the (B, 1024) output L2-normalised."""

    def __init__(self, n_channels: int = 63, seq_len: int = 250,
                 h_c: int = 64, h_l: int = 1024, n_hidden: int = 2,
                 out_dim: int = 1024, dropout: float = 0.25,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.dropout, self.n_hidden = dtype, dropout, n_hidden
        dims = [("input", n_channels, seq_len, h_c, h_l)]
        dims += [(f"hidden_{i}", h_c, h_l, h_c, h_l) for i in range(n_hidden)]
        dims += [("output", h_c, h_l, 1, out_dim)]
        self.blocks = [name for name, *_ in dims]
        for name, c_in, l_in, c_out, l_out in dims:
            self.add_module(f"{name}_ln_l", LayerNorm(l_in))
            self.add_module(f"{name}_fc_l", Dense(l_in, l_out))
            self.add_module(f"{name}_ln_c", LayerNorm(c_in))
            self.add_module(f"{name}_fc_c", Dense(c_in, c_out))

    def _block(self, x, name, kw):
        dt = self.dtype
        x = getattr(self, f"{name}_ln_l")(x)
        x = F.gelu(getattr(self, f"{name}_fc_l")(x, dt))
        x = dropout(x, self.dropout, **kw).transpose(1, 2)
        x = getattr(self, f"{name}_ln_c")(x)
        x = F.gelu(getattr(self, f"{name}_fc_c")(x, dt))
        return dropout(x, self.dropout, **kw).transpose(1, 2)

    def forward(self, x, subject_ids=None, *, train=None, generator=None):
        del subject_ids
        kw = dict(train=_mode(self, train), generator=generator)
        h = x.to(self.dtype)
        for name in self.blocks:
            h = self._block(h, name, kw)
        h = h.reshape(h.shape[0], -1)
        norm = torch.linalg.vector_norm(h, dim=-1, keepdim=True)
        return h / torch.clamp(norm, min=1e-12)


class ShallowFBCSPNet(nn.Module):
    """Shallow ConvNet (Schirrmeister 2017) at the reference's parameters
    (``contrast_retrieval.py:286-313``): 20 temporal filters k = 20, 20
    spatial filters, BN, square → mean-pool 25 / 5 → log (eps 1e-6), all in
    fp32 after the BN, dropout 0.5, the final conv over the rest → 1024."""

    def __init__(self, n_channels: int = 63, n_times: int = 250,
                 out_dim: int = 1024, n_filters: int = 20,
                 filter_time_length: int = 20, pool_len: int = 25,
                 pool_stride: int = 5, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.pool_len, self.pool_stride = pool_len, pool_stride
        self.conv_time = Conv(1, n_filters, (1, filter_time_length))
        self.conv_spat = Conv(n_filters, n_filters, (n_channels, 1),
                              use_bias=False)
        self.bn = BatchNorm(n_filters)
        t = n_times - filter_time_length + 1
        t_rem = (t - pool_len) // pool_stride + 1
        self.conv_classifier = Conv(n_filters, out_dim, (1, t_rem))

    def forward(self, x, subject_ids=None, *, train=None, generator=None):
        del subject_ids
        train, dt = _mode(self, train), self.dtype
        h = self.conv_spat(self.conv_time(x[:, None].to(dt), dt), dt)
        h = self.bn(h, train, axis=1, dtype=F32)
        h = F.avg_pool2d(torch.square(h), (1, self.pool_len),
                         (1, self.pool_stride))
        h = dropout(_safe_log(h), self.dropout, train=train,
                    generator=generator)
        h = self.conv_classifier(h, dt)
        return h.reshape(h.shape[0], -1)


class _ConformerBlock(nn.Module):
    """Pre-norm: x + Dropout(MHA(LN(x))), then x + Dropout(FFN(LN(x)))
    with a 4× exact-GELU FFN; flax's auto names."""

    def __init__(self, d_model: int = 40, n_heads: int = 1,
                 dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.LayerNorm_0 = LayerNorm(d_model)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            d_model, n_heads, dropout)
        self.LayerNorm_1 = LayerNorm(d_model)
        self.Dense_0 = Dense(d_model, 4 * d_model)
        self.Dense_1 = Dense(4 * d_model, d_model)

    def forward(self, x, dtype, *, train, generator):
        kw = dict(train=train, generator=generator)
        a = self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x), dtype,
                                                **kw)
        x = x + dropout(a, self.dropout, **kw)
        y = F.gelu(self.Dense_0(self.LayerNorm_1(x), dtype))
        y = self.Dense_1(dropout(y, self.dropout, **kw), dtype)
        return x + dropout(y, self.dropout, **kw)


class EEGConformer(nn.Module):
    """EEG-Conformer (Song 2022) at the reference's parameters
    (``contrast_retrieval.py:152-182``): 40 temporal filters k = 10, pool
    25 / 5, two 1-head attention blocks, fc head 1760 → 256 → 32 → 1024
    (its dropouts 0.5 and 0.3 fixed, as in JAX)."""

    def __init__(self, n_channels: int = 63, n_times: int = 250,
                 out_dim: int = 1024, n_filters: int = 40,
                 filter_time_length: int = 10, pool_len: int = 25,
                 pool_stride: int = 5, att_depth: int = 2,
                 att_heads: int = 1, dropout: float = 0.25,
                 att_dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.dropout, self.att_depth = dtype, dropout, att_depth
        self.pool_len, self.pool_stride = pool_len, pool_stride
        self.conv_time = Conv(1, n_filters, (1, filter_time_length))
        self.conv_spat = Conv(n_filters, n_filters, (n_channels, 1))
        self.bn = BatchNorm(n_filters)
        self.proj_conv = Conv(n_filters, n_filters, (1, 1))
        for i in range(att_depth):
            self.add_module(f"block_{i}", _ConformerBlock(
                n_filters, att_heads, att_dropout))
        t = (n_times - filter_time_length + 1 - pool_len) // pool_stride + 1
        self.fc1 = Dense(t * n_filters, 256)
        self.fc2 = Dense(256, 32)
        self.fc_out = Dense(32, out_dim)

    def forward(self, x, subject_ids=None, *, train=None, generator=None):
        del subject_ids
        train, dt = _mode(self, train), self.dtype
        kw = dict(train=train, generator=generator)
        h = self.conv_spat(self.conv_time(x[:, None].to(dt), dt), dt)
        h = F.elu(self.bn(h, train, axis=1, dtype=F32))
        h = F.avg_pool2d(h, (1, self.pool_len), (1, self.pool_stride))
        h = self.proj_conv(dropout(h, self.dropout, **kw), dt)
        tokens = h.flatten(2).transpose(1, 2)                # (B, T', 40)
        for i in range(self.att_depth):
            tokens = getattr(self, f"block_{i}")(tokens, dt, **kw)
        h = F.elu(self.fc1(tokens.reshape(tokens.shape[0], -1), dt))
        h = F.elu(self.fc2(dropout(h, 0.5, **kw), dt))
        return self.fc_out(dropout(h, 0.3, **kw), dt)


class EEGITNet(nn.Module):
    """EEG-ITNet (Salami 2022) at the reference's parameters
    (``contrast_retrieval.py:187-205``): three inception branches (temporal
    conv k = 16 / 32 / 64 padded k // 2 both sides, 2 filters, BN, a
    depthwise spatial conv, BN, ELU), cropped to the shortest and
    concatenated, pooled; four dilated (1, 2, 4, 8) residual temporal
    blocks with XLA's ``"SAME"`` padding (⌊total/2⌋ low); a 1 × 1 conv to
    14, pooled; dense to 1024."""

    KERNELS = (16, 32, 64)
    DILATIONS = (1, 2, 4, 8)

    def __init__(self, n_channels: int = 63, n_times: int = 250,
                 out_dim: int = 1024, dropout: float = 0.4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        for i, k in enumerate(self.KERNELS):
            self.add_module(f"branch{i}_time", Conv(
                1, 2, (1, k), padding=((0, 0), (k // 2, k // 2)),
                use_bias=False))
            self.add_module(f"branch{i}_bn1", BatchNorm(2))
            self.register_parameter(f"branch{i}_dw", nn.Parameter(
                torch.zeros(n_channels, 1, 1, 2)))
            self.add_module(f"branch{i}_bn2", BatchNorm(2))
        ch = 2 * len(self.KERNELS)
        for i, d in enumerate(self.DILATIONS):
            pad = ((0, 0), same_padding(4, d))
            for j in (1, 2):
                self.add_module(f"tc{i}_conv{j}", Conv(
                    ch, ch, (1, 4), padding=pad, dilation=(1, d),
                    use_bias=False))
                self.add_module(f"tc{i}_bn{j}", BatchNorm(ch))
        self.reduce = Conv(ch, 14, (1, 1))
        t = min(n_times + 2 * (k // 2) - k + 1 for k in self.KERNELS) // 4
        self.fc_out = Dense(14 * (t // 4), out_dim)

    def forward(self, x, subject_ids=None, *, train=None, generator=None):
        del subject_ids
        train, dt = _mode(self, train), self.dtype
        kw = dict(train=train, generator=generator)
        x = x[:, None].to(dt)                                # (B, 1, C, T)
        branches = []
        for i in range(len(self.KERNELS)):
            b = getattr(self, f"branch{i}_time")(x, dt)
            b = getattr(self, f"branch{i}_bn1")(b, train, axis=1, dtype=F32)
            b = electrode_conv(b, getattr(self, f"branch{i}_dw"), dt)
            b = getattr(self, f"branch{i}_bn2")(b, train, axis=1, dtype=F32)
            branches.append(F.elu(b))                        # (B, 2, 1, T_i)
        t_min = min(b.shape[-1] for b in branches)
        h = torch.cat([b[..., :t_min] for b in branches], dim=1)
        h = dropout(F.avg_pool2d(h, (1, 4)), self.dropout, **kw)
        for i in range(len(self.DILATIONS)):
            y = h
            for j in (1, 2):
                y = getattr(self, f"tc{i}_conv{j}")(y, dt)
                y = F.elu(getattr(self, f"tc{i}_bn{j}")(y, train, axis=1,
                                                        dtype=F32))
            h = h + y
        h = F.avg_pool2d(self.reduce(h, dt), (1, 4))
        h = dropout(h, self.dropout, **kw)
        # JAX flattens its NHWC map: (1, T, 14), time-major
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return self.fc_out(h, dt)


class _TCNBlock(nn.Module):
    """Two causal dilated 1-D convs (left padding (k − 1)·dilation), each
    with BN, ELU and dropout, and a residual (through ``res_proj`` when the
    widths differ), ELU; on (B, T, F) tokens."""

    def __init__(self, in_features: int, filters: int = 16, kernel: int = 4,
                 dilation: int = 1, dropout: float = 0.3):
        super().__init__()
        self.dropout = dropout
        pad = [((kernel - 1) * dilation, 0)]
        self.conv1 = Conv(in_features, filters, (kernel,), padding=pad,
                          dilation=dilation)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv(filters, filters, (kernel,), padding=pad,
                          dilation=dilation)
        self.bn2 = BatchNorm(filters)
        if in_features != filters:
            self.res_proj = Dense(in_features, filters)

    def forward(self, x, dtype, *, train, generator):
        kw = dict(train=train, generator=generator)
        y = x.transpose(1, 2)                                # (B, F, T)
        for c, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            y = F.elu(bn(c(y, dtype), train, axis=1, dtype=F32))
            y = dropout(y, self.dropout, **kw)
        if hasattr(self, "res_proj"):
            x = self.res_proj(x, dtype)
        return F.elu(x + y.transpose(1, 2))


class ATCNet(nn.Module):
    """ATCNet (Altaheri 2022) at the reference's parameters
    (``contrast_retrieval.py:318-357``): an EEGNet-style conv block (8
    filters k = 32, depth multiplier 2, pools 4 and 3) → 21 tokens of 16;
    five sliding windows of 17, each through its own 2-head attention
    (``attn_i``), LayerNorm and two causal dilated TCN blocks; the last
    step of each averaged over the windows → dense 1024."""

    def __init__(self, n_channels: int = 63, n_times: int = 250,
                 out_dim: int = 1024, conv_filters: int = 8,
                 conv_kernel: int = 32, depth_mult: int = 2, pool1: int = 4,
                 pool2: int = 3, conv_dropout: float = 0.3,
                 n_windows: int = 5, att_heads: int = 2,
                 att_dropout: float = 0.5, tcn_depth: int = 2,
                 tcn_kernel: int = 4, tcn_filters: int = 16,
                 tcn_dropout: float = 0.3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.conv_dropout = dtype, conv_dropout
        self.pool1, self.pool2 = pool1, pool2
        self.n_windows, self.tcn_depth = n_windows, tcn_depth
        k = conv_kernel
        ch = conv_filters * depth_mult
        self.conv_time = Conv(1, conv_filters, (1, k),
                              padding=((0, 0), (k // 2, k // 2)),
                              use_bias=False)
        self.bn1 = BatchNorm(conv_filters)
        self.spatial_dw = nn.Parameter(torch.zeros(n_channels, 1, 1, ch))
        self.bn2 = BatchNorm(ch)
        self.conv2 = Conv(ch, ch, (1, 16), padding=((0, 0), (8, 8)),
                          use_bias=False)
        self.bn3 = BatchNorm(ch)
        for i in range(n_windows):
            self.add_module(f"attn_{i}", MultiHeadDotProductAttention(
                ch, att_heads, att_dropout))
            self.add_module(f"attn_ln_{i}", LayerNorm(ch))
            for d in range(tcn_depth):
                self.add_module(f"tcn_{i}_{d}", _TCNBlock(
                    ch if d == 0 else tcn_filters, tcn_filters, tcn_kernel,
                    2 ** d, tcn_dropout))
        self.fc_out = Dense(tcn_filters, out_dim)

    def forward(self, x, subject_ids=None, *, train=None, generator=None):
        del subject_ids
        train, dt = _mode(self, train), self.dtype
        kw = dict(train=train, generator=generator)
        h = self.conv_time(x[:, None].to(dt), dt)
        h = self.bn1(h, train, axis=1, dtype=F32)
        h = electrode_conv(h, self.spatial_dw, dt)
        h = F.elu(self.bn2(h, train, axis=1, dtype=F32))
        h = F.avg_pool2d(h, (1, self.pool1))
        h = self.conv2(dropout(h, self.conv_dropout, **kw), dt)
        h = F.elu(self.bn3(h, train, axis=1, dtype=F32))
        h = dropout(F.avg_pool2d(h, (1, self.pool2)), self.conv_dropout,
                    **kw)
        seq = h.flatten(2).transpose(1, 2)                   # (B, Tc, ch)
        win_len = seq.shape[1] - self.n_windows + 1
        outs = []
        for i in range(self.n_windows):
            wnd = seq[:, i:i + win_len]
            a = getattr(self, f"attn_{i}")(wnd, dt, **kw)
            t = getattr(self, f"attn_ln_{i}")(wnd + a)
            for d in range(self.tcn_depth):
                t = getattr(self, f"tcn_{i}_{d}")(t, dt, **kw)
            outs.append(t[:, -1, :])
        return self.fc_out(torch.stack(outs).mean(0), dt)


class _MetaConvBlock(nn.Module):
    """(B, C, L) → three 1-D convs k = 3 (``"SAME"``) over the L axis,
    each with exact GELU and LayerNorm, plus a 1 × 1 residual conv; the
    result comes back swapped, as JAX returns it."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.res = Conv(in_features, features, (1,))
        for i in range(3):
            self.add_module(f"conv{i + 1}", Conv(
                in_features if i == 0 else features, features, (3,),
                padding=[same_padding(3)]))
            self.add_module(f"ln{i + 1}", LayerNorm(features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        # JAX swaps x to (B, L, C) for flax's channels-last convolutions
        res = self.res(x, dtype)                             # (B, F, L)
        h = x
        for i in range(3):
            h = F.gelu(getattr(self, f"conv{i + 1}")(h, dtype))
            h = getattr(self, f"ln{i + 1}")(h.transpose(1, 2)).transpose(1, 2)
        return h + res                  # (B, F, L): JAX's swapped result


class MetaEEG(nn.Module):
    """MetaEEG (ref ``contrast_retrieval.py:362-491``): a 1-head time-axis
    attention layer (post-norm, no dropout), the subject-wise linear over
    time, a conv block over the 250-long axis (63 in-features), a
    projection to ``num_latents``, a linear aggregation over the 250 block
    features, LayerNorm and an exact-GELU clip head with dropout."""

    def __init__(self, n_channels: int = 63, seq_len: int = 250,
                 num_latents: int = 1024, num_blocks: int = 1,
                 dropout: float = 0.25, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.dropout, self.num_blocks = dtype, dropout, num_blocks
        self.register_buffer("pe", torch.from_numpy(
            sinusoidal_position_embedding(seq_len, n_channels)),
            persistent=False)
        self.attn = MultiHeadDotProductAttention(n_channels, 1)
        self.attn_ln = LayerNorm(n_channels)
        self.subject_linear = Dense(seq_len, seq_len)
        for i in range(num_blocks):
            self.add_module(f"conv_block_{i}", _MetaConvBlock(
                n_channels if i == 0 else seq_len, seq_len))
        self.projection = Dense(seq_len, num_latents)
        self.temporal_agg = Dense(seq_len, 1)
        self.head_ln = LayerNorm(num_latents)
        self.clip_head = Dense(num_latents, num_latents)

    def forward(self, x, subject_ids=None, *, train=None, generator=None):
        del subject_ids
        train, dt = _mode(self, train), self.dtype
        h = x.transpose(1, 2).to(dt) + self.pe.to(dt)       # (B, T, C)
        h = self.attn_ln(h + self.attn(h, dt))
        # (B, C, T) is channels-first for the blocks' convolutions, which
        # run over the 250-long T axis with C = 63 in-features
        h = self.subject_linear(h.transpose(1, 2), dt)
        for i in range(self.num_blocks):
            h = getattr(self, f"conv_block_{i}")(h, dt)
        h = self.projection(h, dt)                           # (B, 250, 1024)
        h = self.temporal_agg(h.transpose(1, 2), dt)         # (B, 1024, 1)
        h = self.head_ln(h.transpose(1, 2))                  # (B, 1, 1024)
        h = F.gelu(self.clip_head(h, dt))
        h = dropout(h, self.dropout, train=train, generator=generator)
        return h.reshape(h.shape[0], -1)
