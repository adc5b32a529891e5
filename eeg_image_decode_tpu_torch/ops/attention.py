"""Fused post-norm channel-attention layer (counterpart of
``eeg_image_decode_tpu/ops/attention.py``).

One whole ATM-S encoder layer (ref ``Transformer_EncDec.py:27-51``):

    QKV projections → 4-head softmax attention over the 64 channel tokens
    → output projection → residual → LayerNorm → FFN (tanh GELU)
    → residual → LayerNorm

``fused_attention_layer`` runs it as one CUDA kernel per sample
(``csrc/attention_fwd.cu``) for a CUDA tensor, and as its plain PyTorch
version, ``attention_layer_reference``, for a CPU tensor. Forward only, no
dropout: this is the serving path. The dropout modes and the backward kernel
belong to training (see ROADMAP.md).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from eeg_image_decode_tpu_torch.ops import _build

PARAM_ORDER = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
               "ln1_s", "ln1_b", "w1", "b1", "w2", "b2", "ln2_s", "ln2_b")


def _dense(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32-accumulated product rounded to h's dtype, plus the bias in that
    dtype (the JAX layer's ``dense``)."""
    dt = h.dtype
    return torch.matmul(h, w.to(dt)) + b.to(dt)


def _ln(h: torch.Tensor, s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 LayerNorm, biased variance, eps 1e-6, back to h's dtype."""
    h32 = h.float()
    mu = h32.mean(-1, keepdim=True)
    var = h32.var(-1, keepdim=True, correction=0)
    return ((h32 - mu) * torch.rsqrt(var + 1e-6) * s + b).to(h.dtype)


def attention_layer_reference(x: torch.Tensor, params: dict,
                              n_heads: int = 4, *,
                              exact_gelu: bool = False) -> torch.Tensor:
    """Plain PyTorch layer: (B, L, D) → (B, L, D) in x's dtype.

    Matmuls in x's dtype with fp32 accumulation, fp32 softmax and LayerNorm,
    tanh GELU in the FFN — the math of the kernel. ``exact_gelu=True`` is the
    module's erf-GELU path, which the kernel does not compute."""
    B, L, D = x.shape
    inner = params["wq"].shape[1]
    hd = inner // n_heads
    dt = x.dtype
    q = _dense(x, params["wq"], params["bq"]).reshape(B, L, n_heads, hd)
    k = _dense(x, params["wk"], params["bk"]).reshape(B, L, n_heads, hd)
    v = _dense(x, params["wv"], params["bv"]).reshape(B, L, n_heads, hd)
    # fp32 scores: bf16 products are exact in fp32, so this is the kernel's
    # fp32-accumulated q k^T
    scores = torch.einsum("blhe,bshe->bhls", q.float(), k.float())
    probs = torch.softmax(scores * (1.0 / math.sqrt(hd)), dim=-1).to(dt)
    out = torch.einsum("bhls,bshd->blhd", probs, v)
    out = _dense(out.reshape(B, L, inner), params["wo"], params["bo"])
    h = _ln(x + out, params["ln1_s"], params["ln1_b"])
    y = _dense(h, params["w1"], params["b1"])
    y = F.gelu(y.float(), approximate="none" if exact_gelu else "tanh")
    y = _dense(y.to(dt), params["w2"], params["b2"])
    return _ln(h + y, params["ln2_s"], params["ln2_b"])


def fused_attention_layer(x: torch.Tensor, params: dict,
                          n_heads: int = 4) -> torch.Tensor:
    """Fused post-norm attention layer: (B, L, D) → (B, L, D), no dropout.

    ``params``: wq,bq,wk,bk,wv,bv (D, H·hd), wo (H·hd, D), bo, ln1_s, ln1_b,
    w1 (D, FF), b1, w2 (FF, D), b2, ln2_s, ln2_b, in the JAX layout. They are
    cast to x's dtype, as the JAX launcher does. A CPU tensor runs
    :func:`attention_layer_reference`; a CUDA tensor launches the kernel
    (float32 or bfloat16) or raises."""
    p = {k: params[k].to(x.dtype).contiguous() for k in PARAM_ORDER}
    if x.device.type == "cpu":
        return attention_layer_reference(x, p, n_heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention_layer: no kernel for {x.device}")
    x = x.contiguous()
    B, L, D = x.shape
    inner, FF = p["wq"].shape[1], p["w1"].shape[1]
    if inner % n_heads:
        raise ValueError(f"inner width {inner} not divisible by {n_heads}")
    shapes = {"wq": (D, inner), "bq": (inner,), "wk": (D, inner),
              "bk": (inner,), "wv": (D, inner), "bv": (inner,),
              "wo": (inner, D), "bo": (D,), "ln1_s": (D,), "ln1_b": (D,),
              "w1": (D, FF), "b1": (FF,), "w2": (FF, D), "b2": (D,),
              "ln2_s": (D,), "ln2_b": (D,)}
    for k, shape in shapes.items():
        if tuple(p[k].shape) != shape:
            raise ValueError(f"{k} has shape {tuple(p[k].shape)}, "
                             f"expected {shape}")
    _build.check_cuda_args("fused_attention_layer", x, p)
    out = torch.empty_like(x)
    weights = _build.pointer_array([p[k] for k in PARAM_ORDER])
    rc = _build.lib().eid_attention_fwd(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), weights, out.data_ptr(),
        B, L, D, inner, FF, n_heads, _build.stream_of(x))
    _build.check(rc, "attention_fwd")
    _build.LAUNCHES["attention_fwd"] += 1
    return out
