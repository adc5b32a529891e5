"""Shared building blocks (counterpart of
``eeg_image_decode_tpu/models/layers.py``): the ATM-S tsconv stack,
projection head and raw logit scale, the diffusion prior's
:class:`MLPBlock`, and what flax gives the encoder zoo (``models/nice.py``,
``eegnetv4.py``, ``atm_e.py``, ``baselines.py``): :class:`Conv` (flax
``nn.Conv``'s kernel layout run by ``F.conv1d`` / ``F.conv2d``),
:class:`LayerNorm`, :class:`BatchNorm` over any feature axis, and
:class:`MultiHeadDotProductAttention`.

Parameters keep the JAX package's names and layouts (dense kernels are
(d_in, d_out)); ``utils/convert.py`` maps a JAX variable tree onto them.
Each module's ``forward`` takes ``train``: in train mode BatchNorm uses the
batch statistics and updates its running ones, and dropout is on. A dropout
site takes either a pre-scaled keep-mask (the JAX ``dropout_mask``
convention) or draws one from a ``torch.Generator`` (:func:`dropout`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eeg_image_decode_tpu_torch.ops.projection import fused_projection_head
from eeg_image_decode_tpu_torch.ops.tsconv import (
    fold_pool_into_kernel,
    tsconv_pool_fused,
    tsconv_pool_reference,
)


def sinusoidal_position_embedding(n_positions: int, d_model: int) -> np.ndarray:
    """Interleaved sin/cos table (ref ``models/subject_layers/Embed.py:8-26``)."""
    position = np.arange(n_positions, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * -(np.log(10000.0) / d_model)
    )
    pe = np.zeros((n_positions, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term[: d_model // 2])
    return pe.astype(np.float32)


def dropout(h: torch.Tensor, p: float, *, train: bool, mask=None,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """One dropout site. ``mask`` (a pre-scaled keep-mask, broadcastable to
    h) is applied in h's dtype whenever it is given, as the JAX modules'
    ``dropout_mask``; otherwise, in train mode with p > 0, a keep
    pattern is drawn from ``generator`` on h's device and the kept values
    are divided by 1−p in h's dtype, as flax's ``nn.Dropout`` divides by
    ``keep_prob`` (in bfloat16, multiplying by a rounded 1/(1−p) would not
    give the same bits at p = 0.25)."""
    if mask is not None:
        return h * mask.to(h.device, h.dtype)
    if not train or p == 0.0:
        return h
    keep = torch.rand(h.shape, generator=generator, device=h.device) >= p
    return torch.where(keep, h / (1.0 - p), torch.zeros((), dtype=h.dtype,
                                                        device=h.device))


def check_fused(value, name: str) -> None:
    if value not in (True, False, "auto"):
        raise ValueError(f"{name} must be True, False or 'auto'; got {value!r}")


class Dense(nn.Module):
    """``kernel`` (d_in, d_out) and ``bias`` at the paths flax's Dense uses;
    ``h @ kernel`` in h's dtype (fp32 accumulation) plus the bias in it.
    ``dtype`` casts h first, as flax's ``Dense(dtype=…)`` casts its input."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, h: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        if dtype is not None:
            h = h.to(dtype)
        return torch.matmul(h, self.kernel.to(h.dtype)) + self.bias.to(h.dtype)


class LNParams(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


def layer_norm_fast(h: torch.Tensor, ln: LNParams) -> torch.Tensor:
    """flax ``LayerNorm(dtype=float32)``: fp32 stats with the fast variance
    max(E[h²] − μ², 0), eps 1e-6; fp32 out."""
    h32 = h.float()
    mu = h32.mean(-1, keepdim=True)
    var = torch.clamp(h32.square().mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (h32 - mu) * (torch.rsqrt(var + 1e-6) * ln.scale) + ln.bias


class LayerNorm(LNParams):
    """flax ``nn.LayerNorm(dtype=jnp.float32)`` over the last axis: eps
    1e-6 (not torch's 1e-5), the fast variance of :func:`layer_norm_fast`,
    fp32 out."""

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return layer_norm_fast(h, self)


def layer_norm(h: torch.Tensor, ln: LNParams) -> torch.Tensor:
    """flax ``LayerNorm(dtype=float32)`` through ``F.layer_norm`` (eps
    1e-6, fp32 out): one launch each way where :func:`layer_norm_fast`
    takes a dozen. Its variance sums in another order than flax's fast
    E[h²] − μ², the same function to fp32 rounding."""
    return F.layer_norm(h.float(), (h.shape[-1],), ln.scale, ln.bias,
                        eps=1e-6)


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum, epsilon)`` (defaults 0.9 and 1e-5) over
    the feature ``axis`` (the last by default; ``axis=1`` for an NCHW
    tensor), normalised in fp32 and returned in ``dtype`` (default: the
    input's; flax's ``BatchNorm(dtype=jnp.float32)`` returns fp32).

    Eval: the running statistics. Train: the batch statistics over every
    other axis in fp32 with the fast variance max(E[x²] − E[x]², 0) (flax
    ``_compute_stats``), and the running statistics move to
    ``momentum·old + (1 − momentum)·batch`` with the biased batch variance.
    This is not ``torch.nn.BatchNorm``, whose running variance is the
    unbiased one, with momentum 0.1 on the new value."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False, *,
                axis: int = -1,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        axis = axis % x.ndim
        if train:
            x32 = x.float().movedim(axis, -1).reshape(-1, x.shape[axis])
            mean = x32.mean(0)
            var = torch.clamp((x32 * x32).mean(0) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        bias = self.bias
        if axis != x.ndim - 1:
            shape = [1] * x.ndim
            shape[axis] = -1
            mean, mul, bias = (v.reshape(shape) for v in (mean, mul, bias))
        return ((x - mean) * mul + bias).to(dtype or x.dtype)


class TSConv(nn.Module):
    """Temporal→spatial conv stack (ShallowNet-style ``tsconv``).

    (B, C, T) → (B, P, emb_size). Stage 1: the folded 75-tap stride-5
    correlation (``ops/tsconv.py``) + BN + ELU. Stage 2: the spatial conv
    over all C electrodes + BN + ELU + dropout. Stage 3: a 1x1 conv to
    ``emb_size``. Ref ``Retrieval/ATMS_retrieval.py:97-125``.

    The JAX module is NHWC: stage 1 gives (B, C, P, F), the spatial conv is
    a (C, 1) HWIO kernel contracting C and F, and the tokens come out
    p-major, f-minor. Here the spatial kernel is stored as (C·F, F_out) with
    c-major rows, which is the HWIO kernel reshaped."""

    def __init__(self, filters: int = 40, temporal_kernel: int = 25,
                 pool_size: int = 51, pool_stride: int = 5,
                 emb_size: int = 40, spatial_extent: int = 63,
                 dropout: float = 0.5, fused_stage1: bool | str = "auto"):
        super().__init__()
        check_fused(fused_stage1, "fused_tsconv")
        self.dropout = dropout
        self.pool_size = pool_size
        self.pool_stride = pool_stride
        self.spatial_extent = spatial_extent
        self.use_kernel = bool(fused_stage1)  # True and 'auto'
        # no conv bias ahead of BatchNorm, as in the JAX package
        self.temporal_conv_kernel = nn.Parameter(
            torch.zeros(temporal_kernel, filters))
        self.bn1 = BatchNorm(filters)
        self.spatial_conv = nn.Module()
        self.spatial_conv.kernel = nn.Parameter(
            torch.zeros(spatial_extent * filters, filters))
        self.bn2 = BatchNorm(filters)
        self.proj_conv = Dense(filters, emb_size)

    def forward(self, x: torch.Tensor, dtype: torch.dtype, *,
                train: bool = False, dropout_mask=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``dropout_mask``: the pre-scaled keep-mask of the site after the
        second ELU, broadcastable to the JAX (B, 1, P, F) activation."""
        x = x.to(dtype)
        b, c, _ = x.shape
        if c != self.spatial_extent:
            raise ValueError(f"expected {self.spatial_extent} channel rows, "
                             f"got {c}")
        # fold in fp32, then round the taps to the working dtype
        w_tilde = fold_pool_into_kernel(
            self.temporal_conv_kernel, self.pool_size).to(dtype)
        if self.use_kernel:  # the kernel on CUDA, its plain version on CPU
            y = tsconv_pool_fused(x, w_tilde, self.pool_stride)
        else:
            y = tsconv_pool_reference(x, w_tilde, self.pool_stride)
        y = F.elu(self.bn1(y, train))                        # (B, C, P, F)
        p, f = y.shape[2], y.shape[3]
        y = y.permute(0, 2, 1, 3).reshape(b * p, c * f)    # (B·P, C·F)
        y = torch.matmul(y, self.spatial_conv.kernel.to(dtype))
        y = F.elu(self.bn2(y, train))                        # (B·P, F)
        y = dropout(y.reshape(b, 1, p, -1), self.dropout, train=train,
                    mask=dropout_mask, generator=generator).reshape(b * p, -1)
        y = self.proj_conv(y)                                # (B·P, emb)
        return y.reshape(b, p, -1)


class ProjectionHead(nn.Module):
    """Flatten → Dense → residual(GELU→Dense→Dropout) → LayerNorm (ref
    ``Proj_eeg``, ``Retrieval/ATMS_retrieval.py:157-167``), fp32 out.

    ``fused=True`` runs ``ops/projection.py::fused_projection_head`` (the
    kernels on CUDA, their plain versions on the CPU: tanh GELU, |Δ| ≲ 1e-3
    from the default) whenever no ``dropout_mask`` is pinned: in eval mode
    without dropout, in train mode with the head's int32 seed drawn from
    ``generator`` on x's device (seed mode: the mask is drawn inside the
    forward and the backward kernel). With a pinned ``dropout_mask`` the
    head takes the exact-erf chain even under ``fused=True``, as the JAX
    module does. ``False`` and ``'auto'`` keep the exact-erf head with the
    fast-variance LayerNorm, as the JAX package's ``'auto'`` does."""

    def __init__(self, d_in: int, proj_dim: int = 1024,
                 fused: bool | str = "auto", dropout: float = 0.5):
        super().__init__()
        check_fused(fused, "fused_projection")
        self.use_kernel = fused != "auto" and bool(fused)
        self.dropout = dropout
        self.in_proj = Dense(d_in, proj_dim)
        self.res_proj = Dense(proj_dim, proj_dim)
        self.ln = LNParams(proj_dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype, *,
                train: bool = False, dropout_mask=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(dtype)
        if self.use_kernel and dropout_mask is None:
            seed, p = None, 0.0
            if train and self.dropout > 0.0:
                p = self.dropout
                seed = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                     device=x.device, dtype=torch.int32)
            return fused_projection_head(x, {
                "wi": self.in_proj.kernel, "bi": self.in_proj.bias,
                "wr": self.res_proj.kernel, "br": self.res_proj.bias,
                "ln_s": self.ln.scale, "ln_b": self.ln.bias,
            }, None, p, seed)
        a = self.in_proj(x)
        h = self.res_proj(F.gelu(a, approximate="none"))
        h = dropout(h, self.dropout, train=train, mask=dropout_mask,
                    generator=generator)
        return layer_norm_fast(a + h, self.ln)


class LogitScale(nn.Module):
    """The raw trainable temperature (init ln(1/0.07) ≈ 2.659). Reference
    quirk preserved: it multiplies the logits directly and is never
    exponentiated (``Retrieval/ATMS_retrieval.py:179,227-229``)."""

    def __init__(self, init_value: float = float(np.log(1 / 0.07))):
        super().__init__()
        self.logit_scale = nn.Parameter(torch.tensor(init_value))

    def forward(self) -> torch.Tensor:
        return self.logit_scale


class MLPBlock(nn.Module):
    """Dense → LayerNorm (fp32, :func:`layer_norm`) → SiLU → Dropout, the
    recurring hidden block of the diffusion prior (ref
    ``Generation/diffusion_prior.py:135-161``). ``dropout_mask``, a
    pre-scaled keep-mask, replaces the draw whenever it is given (the
    placement-parity hook of the JAX block)."""

    def __init__(self, d_in: int, features: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.Dense_0 = Dense(d_in, features)
        self.LayerNorm_0 = LNParams(features)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                dropout_mask=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = F.silu(layer_norm(self.Dense_0(x), self.LayerNorm_0))
        return dropout(x, self.dropout, train=train, mask=dropout_mask,
                       generator=generator)


def same_padding(kernel: int, dilation: int = 1) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one axis at stride 1: the total
    (k − 1)·dilation, ⌊total/2⌋ low and the rest high."""
    total = (kernel - 1) * dilation
    return total // 2, total - total // 2


def conv(x: torch.Tensor, kernel: torch.Tensor, dtype: torch.dtype, *,
         padding=None, dilation=1, groups: int = 1) -> torch.Tensor:
    """flax's convolution on a channels-first tensor: ``x`` (B, C, W) or
    (B, C, H, W); ``kernel`` in flax's layout, (k, C/groups, out) or HWIO
    (kh, kw, C/groups, out); ``padding`` one (low, high) pair per spatial
    axis (default none: ``"VALID"``). Both operands are cast to ``dtype``
    and the product is rounded to it once, as ``nn.Conv(dtype=…)`` and
    ``conv_general_dilated(preferred_element_type=float32).astype(dtype)``
    give it; output channel o belongs to group o // (out/groups) in both
    (group-major)."""
    nd = kernel.ndim - 2
    x = x.to(dtype)
    if padding is not None:
        x = F.pad(x, [p for pair in reversed(padding) for p in pair])
    w = kernel.to(dtype).permute(nd + 1, nd, *range(nd))   # → (out, in, …)
    fn = F.conv1d if nd == 1 else F.conv2d
    return fn(x, w, None, 1, 0, dilation, groups)


def electrode_conv(x: torch.Tensor, kernel: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """The depthwise (C, 1) ``"VALID"`` convolution over the whole
    electrode axis of EEGNetV4, ATCNet and EEGITNet: ``x`` (B, G, C, T)
    with ``feature_group_count`` G = in-channels, HWIO ``kernel`` (C, 1, 1,
    G·m) → (B, G·m, 1, T), output channel g·m + j from input channel g, as
    :func:`conv` gives it. Computed as one batched product over the C taps
    (cuBLAS: bf16 products, fp32 sums, rounded to ``dtype`` once, the same
    function and rounding) because PyTorch's depthwise kernel takes
    ≈ 0.2 s for this backward at B 1024 on the H100."""
    b, g, c, t = x.shape
    w = kernel.to(dtype).reshape(c, g, -1)                 # (C, G, m)
    y = torch.einsum("bgct,cgm->bgmt", x.to(dtype), w)
    return y.reshape(b, -1, 1, t)


class Conv(nn.Module):
    """flax ``nn.Conv``: ``kernel`` (k, in, out) for a 1-D and HWIO
    (kh, kw, in, out) for a 2-D convolution, and ``bias`` (out,),
    added in ``dtype`` after the product's rounding, as flax adds it. The
    tensors are channels-first (:func:`conv`)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: tuple[int, ...], *, padding=None, dilation=1,
                 use_bias: bool = True):
        super().__init__()
        self.padding, self.dilation = padding, dilation
        self.kernel = nn.Parameter(
            torch.zeros(*kernel_size, in_features, features))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = conv(x, self.kernel, dtype, padding=self.padding,
                 dilation=self.dilation)
        if self.bias is not None:
            y = y + self.bias.to(dtype).reshape(-1, *[1] * (y.ndim - 2))
        return y


class DenseGeneral(nn.Module):
    """One of flax ``MultiHeadDotProductAttention``'s projections:
    ``kernel`` (d, heads, head_dim) and ``bias`` (heads, head_dim) for
    q / k / v, or (heads, head_dim, d) and (d,) for ``out``."""

    def __init__(self, kernel_shape: tuple[int, ...],
                 bias_shape: tuple[int, ...]):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kernel_shape))
        self.bias = nn.Parameter(torch.zeros(bias_shape))


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` for self-attention over
    (B, L, d) tokens (ATM-E, EEGConformer, ATCNet, MetaEEG), written as its
    products and softmax: plain XLA in JAX, plain PyTorch here.

    head_dim = d // heads. Each projection casts its input and weights to
    ``dtype`` and rounds the product, then the bias sum, to it. The query
    is divided by √head_dim (rounded to ``dtype``) before the product, and
    the softmax runs in ``dtype`` as flax computes it (no
    ``force_fp32_for_softmax``): the logits, x − max, its exp, the row sum
    and the quotient are each rounded to ``dtype``. Dropout falls on the
    attention weights with ``broadcast_dropout``: one (L, L) keep pattern
    shared by every sample and head of the call, times keep/(1 − p), both
    factors in ``dtype`` (flax's multiplier)."""

    def __init__(self, d: int, heads: int, dropout: float = 0.0):
        super().__init__()
        self.heads, self.head_dim, self.dropout = heads, d // heads, dropout
        qkv = ((d, heads, d // heads), (heads, d // heads))
        self.query = DenseGeneral(*qkv)
        self.key = DenseGeneral(*qkv)
        self.value = DenseGeneral(*qkv)
        self.out = DenseGeneral((heads, d // heads, d), (d,))

    def forward(self, x: torch.Tensor, dtype: torch.dtype, *,
                train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        b, length, d = x.shape
        h, hd = self.heads, self.head_dim
        x = x.to(dtype)

        def project(p):  # (B, L, d) → (B, heads, L, head_dim)
            y = torch.matmul(x, p.kernel.to(dtype).reshape(d, h * hd))
            y = y.reshape(b, length, h, hd) + p.bias.to(dtype)
            return y.transpose(1, 2)

        q, k, v = project(self.query), project(self.key), project(self.value)
        depth = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dtype)
        logits = torch.matmul(q / depth, k.transpose(-1, -2))
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        w = e / e.sum(-1, keepdim=True)
        if train and self.dropout > 0.0:
            keep_prob = 1.0 - self.dropout
            keep = torch.rand((length, length), generator=generator,
                              device=x.device) < keep_prob
            w = w * (keep.to(dtype) / torch.tensor(keep_prob, dtype=dtype,
                                                   device=x.device))
        o = torch.matmul(w, v).transpose(1, 2).reshape(b, length, h * hd)
        return (torch.matmul(o, self.out.kernel.to(dtype).reshape(h * hd, d))
                + self.out.bias.to(dtype))


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init, ``lecun_normal``: a normal truncated to
    ±2 standard units, scaled to variance 1/fan_in."""
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(math.sqrt(1.0 / fan_in) / 0.87962566103423978)
