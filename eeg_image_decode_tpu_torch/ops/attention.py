"""Fused post-norm channel-attention layer (counterpart of
``eeg_image_decode_tpu/ops/attention.py``).

One whole ATM-S encoder layer (ref ``Transformer_EncDec.py:27-51``):

    QKV projections → 4-head softmax attention over the 64 channel tokens
    → output projection → residual → LayerNorm → FFN (tanh GELU)
    → residual → LayerNorm

with dropout at four sites: ``m_attn`` (B, H, L, L) on the rounded softmax
probabilities, ``m_res`` (B, L, D) on the output projection, ``m_ffn1``
(B, L, FF) after the GELU and ``m_ffn2`` (B, L, D) after the second dense.

``fused_attention_layer`` is a ``torch.autograd.Function``. For a CUDA
tensor its forward is ``csrc/attention_fwd.cu`` and its backward
``csrc/attention_bwd.cu`` (recompute on chip, dx per sample, fp32 parameter
gradients reduced in a fixed order, so two runs agree bit for bit): in
bfloat16 on the tensor cores over operands zero-padded to multiples of 64
(``csrc/attention_tile.cuh``; design ``mma_bf16``), in float32 as FMA loops
(``fma_fp32``); :func:`forward_design` and :func:`backward_design` name the
one a dtype takes. For a CPU tensor it runs the plain versions:
``attention_layer_reference`` and ``attention_layer_backward_reference``,
which follows the rounding points of the JAX backward kernel line by line.
``attention_layer_backward_tiled`` is the bfloat16 backward's tiling and
index math in plain PyTorch (padding, head slicing, the two softmax passes,
the split-K chunks), for the CPU tests.

Dropout, three modes (as in the JAX kernel):

- none;
- ``masks``: explicit pre-scaled keep-masks, cast to x's dtype;
- ``dropout_p`` + ``seed``: the masks are drawn inside both kernels by a
  Philox-4x32-10 counter generator (``csrc/philox.cuh``;
  :func:`draw_keep_masks` is the same generator in int64 tensor arithmetic,
  ``ops/philox.py``).
  Each mask element is a pure function of (seed, global sample index, site,
  element index): key (seed, sample), counter (element // 4, site, 0, 0),
  word element % 4. The global index of a call's first sample is
  ``sample0`` (a data-parallel rank's offset in the global batch, 0
  otherwise), so a rank draws the whole batch's masks for its rows. Keep iff ``bits < uint32(keep · 0xFFFFFFFF)``, value
  ``1/keep`` (rounded to x's dtype in the forward, fp32 in the backward, as
  the JAX kernels do). The bits differ from the TPU hardware generator's;
  only the keep rule and the purity are shared with it.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from eeg_image_decode_tpu_torch.ops import _build
from eeg_image_decode_tpu_torch.ops.philox import (  # noqa: F401 (re-exported)
    keep_mask,
    keep_rule,
    philox4x32_10,
)

PARAM_ORDER = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
               "ln1_s", "ln1_b", "w1", "b1", "w2", "b2", "ln2_s", "ln2_b")
MASK_ORDER = ("m_attn", "m_res", "m_ffn1", "m_ffn2")
_MODES = {"none": 0, "masks": 1, "seed": 2}


def draw_keep_masks(seed, batch: int, n_heads: int, length: int, d_model: int,
                    d_ff: int, dropout_p: float, *, row0: int = 0,
                    device=None) -> dict[str, torch.Tensor]:
    """The four fp32 keep-masks (values 0 or 1/keep) that the seed-mode
    kernels draw for samples ``row0 … row0+batch−1``: the plain version of
    ``csrc/philox.cuh``."""
    rows = torch.arange(row0, row0 + batch, dtype=torch.int64, device=device)
    shapes = {"m_attn": (n_heads, length, length),
              "m_res": (length, d_model),
              "m_ffn1": (length, d_ff),
              "m_ffn2": (length, d_model)}
    out = {}
    for site, (name, shape) in enumerate(shapes.items()):
        out[name] = keep_mask(seed, rows, site, math.prod(shape),
                              dropout_p).reshape(batch, *shape)
    return out


# ——— plain versions ———


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
                              n_heads: int = 4, *, masks: dict | None = None,
                              exact_gelu: bool = False) -> torch.Tensor:
    """Plain PyTorch layer: (B, L, D) → (B, L, D) in x's dtype.

    Matmuls in x's dtype with fp32 accumulation, fp32 softmax and LayerNorm,
    tanh GELU in the FFN — the math of the kernel. ``masks``: the four
    pre-scaled keep-masks, applied in x's dtype where the JAX kernel applies
    them. ``exact_gelu=True`` is the module's erf-GELU path, which the kernel
    does not compute."""
    B, L, D = x.shape
    inner = params["wq"].shape[1]
    hd = inner // n_heads
    dt = x.dtype
    m = {k: v.to(dt) for k, v in masks.items()} if masks is not None else None
    q = _dense(x, params["wq"], params["bq"]).reshape(B, L, n_heads, hd)
    k = _dense(x, params["wk"], params["bk"]).reshape(B, L, n_heads, hd)
    v = _dense(x, params["wv"], params["bv"]).reshape(B, L, n_heads, hd)
    # fp32 scores: bf16 products are exact in fp32, so this is the kernel's
    # fp32-accumulated q k^T
    scores = torch.einsum("blhe,bshe->bhls", q.float(), k.float())
    probs = torch.softmax(scores * (1.0 / math.sqrt(hd)), dim=-1).to(dt)
    if m is not None:
        probs = probs * m["m_attn"]
    out = torch.einsum("bhls,bshd->blhd", probs, v)
    out = _dense(out.reshape(B, L, inner), params["wo"], params["bo"])
    if m is not None:
        out = out * m["m_res"]
    h = _ln(x + out, params["ln1_s"], params["ln1_b"])
    y = _dense(h, params["w1"], params["b1"])
    y = F.gelu(y.float(), approximate="none" if exact_gelu else "tanh").to(dt)
    if m is not None:
        y = y * m["m_ffn1"]
    y = _dense(y, params["w2"], params["b2"])
    if m is not None:
        y = y * m["m_ffn2"]
    return _ln(h + y, params["ln2_s"], params["ln2_b"])


def _gelu_tanh_and_grad(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    c = float(np.float32(np.sqrt(2.0 / np.pi)))
    a = float(np.float32(0.044715))
    t = torch.tanh(c * (u + a * u * u * u))
    g = 0.5 * u * (1.0 + t)
    dg = 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * c * (1.0 + 3.0 * a * u * u)
    return g, dg


def attention_layer_backward_reference(
        x: torch.Tensor, params: dict, g: torch.Tensor, n_heads: int = 4, *,
        masks: dict | None = None) -> tuple[torch.Tensor, dict]:
    """Plain backward of the layer, following the JAX ``_bwd_kernel`` line
    by line: recompute the forward (fp32 softmax, LN and residuals; the
    operands of every product rounded to x's dtype, fp32 accumulation), then
    backprop through LN2, the FFN, LN1, the output projection, the per-head
    softmax and QKV. ``masks`` are used as given, in fp32 (the JAX launcher
    hands mask mode the x-dtype masks, seed mode the fp32 draw).

    Returns dx in x's dtype and the 16 parameter gradients in fp32."""
    B, L, D = x.shape
    dt = x.dtype
    inner = params["wq"].shape[1]
    hd = inner // n_heads
    N = B * L
    p = {k: params[k].to(dt).float() for k in PARAM_ORDER}
    use_drop = masks is not None
    if use_drop:
        m_attn = masks["m_attn"].float()
        mres = masks["m_res"].reshape(N, D).float()
        mf1 = masks["m_ffn1"].reshape(N, -1).float()
        mf2 = masks["m_ffn2"].reshape(N, D).float()

    def mm(a, b):  # operands in dt, fp32 accumulation
        return torch.matmul(a.to(dt).float(), b.to(dt).float())

    xf = x.reshape(N, D)
    g_out = g.reshape(N, D).float()

    # ——— forward recompute ———
    q = (mm(xf, p["wq"]) + p["bq"]).to(dt)
    k = (mm(xf, p["wk"]) + p["bk"]).to(dt)
    v = (mm(xf, p["wv"]) + p["bv"]).to(dt)
    scale = float(np.float32(1.0 / np.sqrt(hd)))

    def head(t, h):
        return t[:, h * hd:(h + 1) * hd].reshape(B, L, hd).float()

    probs, probsm, heads = [], [], []
    for h in range(n_heads):
        s = torch.einsum("ble,bme->blm", head(q, h), head(k, h))
        pr = torch.softmax(s * scale, dim=-1)
        pm = pr * m_attn[:, h] if use_drop else pr
        oh = torch.einsum("blm,bme->ble", pm.to(dt).float(), head(v, h))
        probs.append(pr)
        probsm.append(pm)
        heads.append(oh.to(dt).reshape(N, hd))
    concat_o = torch.cat(heads, dim=1)
    attn = mm(concat_o, p["wo"]) + p["bo"]
    if use_drop:
        attn = attn * mres
    r1 = xf.float() + attn

    def ln_fwd(h32, s_p, b_p):
        mu = h32.mean(-1, keepdim=True)
        var = (h32 - mu).square().mean(-1, keepdim=True)
        inv = torch.rsqrt(var + 1e-6)
        xhat = (h32 - mu) * inv
        return xhat * s_p + b_p, xhat, inv

    h1, xhat1, inv1 = ln_fwd(r1, p["ln1_s"], p["ln1_b"])
    h1dt = h1.to(dt)
    u = mm(h1dt, p["w1"]) + p["b1"]
    g1, dgelu = _gelu_tanh_and_grad(u)
    g1m = g1 * mf1 if use_drop else g1
    z = mm(g1m.to(dt), p["w2"]) + p["b2"]
    if use_drop:
        z = z * mf2
    r2 = h1 + z
    _, xhat2, inv2 = ln_fwd(r2, p["ln2_s"], p["ln2_b"])

    # ——— backward ———
    def ln_bwd(gy, xhat, inv, s_p):
        gxh = gy * s_p
        gx = (gxh - gxh.mean(-1, keepdim=True)
              - xhat * (gxh * xhat).mean(-1, keepdim=True)) * inv
        return gx, (gy * xhat).sum(0), gy.sum(0)

    grads = {}
    d_r2, grads["ln2_s"], grads["ln2_b"] = ln_bwd(g_out, xhat2, inv2,
                                                  p["ln2_s"])
    d_z = d_r2 * mf2 if use_drop else d_r2
    grads["w2"] = mm(g1m.to(dt).T, d_z)
    grads["b2"] = d_z.sum(0)
    d_g1m = mm(d_z, p["w2"].T)
    d_g1 = d_g1m * mf1 if use_drop else d_g1m
    d_u = d_g1 * dgelu
    grads["w1"] = mm(h1dt.T, d_u)
    grads["b1"] = d_u.sum(0)
    d_h1 = d_r2 + mm(d_u, p["w1"].T)
    d_r1, grads["ln1_s"], grads["ln1_b"] = ln_bwd(d_h1, xhat1, inv1,
                                                  p["ln1_s"])
    dx = d_r1
    d_attn = d_r1 * mres if use_drop else d_r1
    grads["wo"] = mm(concat_o.T, d_attn)
    grads["bo"] = d_attn.sum(0)
    d_concat = mm(d_attn, p["wo"].T)

    d_parts = {"q": [], "k": [], "v": []}
    for h in range(n_heads):
        d_oh = head(d_concat, h).to(dt).float()
        pm, pr = probsm[h], probs[h]
        d_pm = torch.einsum("ble,bme->blm", d_oh, head(v, h))
        d_vh = torch.einsum("blm,ble->bme", pm.to(dt).float(), d_oh)
        d_p = d_pm * m_attn[:, h] if use_drop else d_pm
        d_s = (d_p - (d_p * pr).sum(-1, keepdim=True)) * pr * scale
        d_s = d_s.to(dt).float()
        d_parts["q"].append(torch.einsum("blm,bme->ble", d_s, head(k, h)))
        d_parts["k"].append(torch.einsum("blm,ble->bme", d_s, head(q, h)))
        d_parts["v"].append(d_vh)
    for name in ("q", "k", "v"):
        d = torch.cat([t.reshape(N, hd) for t in d_parts[name]], dim=1)
        grads["w" + name] = mm(xf.T, d)
        grads["b" + name] = d.sum(0)
        dx = dx + mm(d, p["w" + name].T)
    return dx.to(dt).reshape(B, L, D), grads


# ——— the bfloat16 tensor-core design's tiling, in plain PyTorch ———

#: one sample's token rows are one tile of this many rows
TILE_ROWS = 64
#: split-K chunks of the backward's dW products
DW_CHUNKS = 32


def padded_dims(length: int, d_model: int, inner: int, d_ff: int,
                n_heads: int) -> dict | None:
    """The padded widths of ``csrc/attention_tile.cuh::make_dims``: D and FF
    to multiples of 64, each head to a multiple of 16 such that the heads
    together fill a multiple of 64; None for shapes the design does not take
    (L > 64, a padded width above 256, a padded head above 64)."""
    if not (1 <= length <= TILE_ROWS and inner % n_heads == 0):
        return None
    hd = inner // n_heads
    hdp = _ceil_to(hd, 16)
    while (n_heads * hdp) % 64:
        hdp += 16
    d = {"hd": hd, "hdp": hdp, "Dp": _ceil_to(d_model, 64),
         "FFp": _ceil_to(d_ff, 64), "innerp": n_heads * hdp}
    ok = (max(d["Dp"], d["FFp"], d["innerp"]) <= 256 and hdp <= 64)
    return d if ok else None


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad_heads(t: torch.Tensor, dim: int, groups: int, hd: int,
               hdp: int) -> torch.Tensor:
    """Axis ``dim`` of ``groups`` blocks of ``hd`` → blocks of ``hdp``, the
    new columns zero."""
    t = t.movedim(dim, -1)
    t = t.reshape(*t.shape[:-1], groups, hd)
    t = F.pad(t, (0, hdp - hd)).reshape(*t.shape[:-2], groups * hdp)
    return t.movedim(-1, dim)


def _pad_to(t: torch.Tensor, *sizes: int) -> torch.Tensor:
    """Zero-pad the trailing dims of t up to ``sizes``."""
    pad = []
    for have, want in zip(reversed(t.shape[-len(sizes):]), reversed(sizes)):
        pad += [0, want - have]
    return F.pad(t, pad)


def pack_attention_params(params: dict, n_heads: int, length: int) -> dict:
    """The packed weights of ``csrc/attention_fwd.cu::attention_pack_kernel``
    as fp32 tensors: ``wqkv`` (Dp, 3 innerp) with each head's columns at
    h · hdp, ``wo`` (innerp, Dp), ``w1`` (Dp, FFp), ``w2`` (FFp, Dp), and the
    vectors, zeros in every padding."""
    D, inner = params["wq"].shape
    FF = params["w1"].shape[1]
    dm = padded_dims(length, D, inner, FF, n_heads)
    H, hd, hdp = n_heads, dm["hd"], dm["hdp"]
    Dp, FFp = dm["Dp"], dm["FFp"]
    f = {k: v.float() for k, v in params.items()}
    heads = [_pad_heads(_pad_to(f[k], Dp, inner), 1, H, hd, hdp)
             for k in ("wq", "wk", "wv")]
    return {
        "wqkv": torch.cat(heads, dim=1),
        "bqkv": torch.cat([_pad_heads(f[k], 0, H, hd, hdp)
                           for k in ("bq", "bk", "bv")]),
        "wo": _pad_heads(_pad_to(f["wo"], inner, Dp), 0, H, hd, hdp),
        "w1": _pad_to(f["w1"], Dp, FFp), "w2": _pad_to(f["w2"], FFp, Dp),
        "b1": _pad_to(f["b1"], FFp),
        **{k: _pad_to(f[k], Dp) for k in ("bo", "ln1_s", "ln1_b", "b2",
                                           "ln2_s", "ln2_b")},
    }


def attention_layer_backward_tiled(
        x: torch.Tensor, params: dict, g: torch.Tensor, n_heads: int = 4, *,
        masks: dict | None = None) -> tuple[torch.Tensor, dict]:
    """The bfloat16 design of ``csrc/attention_bwd.cu`` in plain PyTorch,
    with the arithmetic of :func:`attention_layer_backward_reference`: each
    sample a 64-row tile (rows ≥ L zero), D, FF and the heads zero-padded as
    :func:`pack_attention_params` lays the weights out, the heads sliced
    from padded columns; the softmax backward in the kernel's two passes (a
    query pass that keeps each row's max, sum and Σ d_p p, and a key pass
    that rebuilds pᵀ from them); dx as d_r1 + dq Wqᵀ + dk Wkᵀ + dv Wvᵀ from
    the packed weights; the dW products over the B·L rows as 32 split-K
    chunks of a multiple of 32 rows summed in order, then unpadded; the
    bias and LayerNorm vectors as per-sample sums added over the batch in
    32 chunks. Returns what the plain backward returns."""
    B, L, D = x.shape
    dt = x.dtype
    inner, FF = params["wq"].shape[1], params["w1"].shape[1]
    H = n_heads
    dm = padded_dims(L, D, inner, FF, H)
    if dm is None:
        raise ValueError(f"shapes (L {L}, D {D}, inner {inner}, FF {FF}, "
                         f"{H} heads) do not fit the design")
    hd, hdp, Dp, FFp, ip = (dm[k] for k in ("hd", "hdp", "Dp", "FFp",
                                            "innerp"))
    R = TILE_ROWS
    pk = pack_attention_params({k: params[k].to(dt) for k in PARAM_ORDER},
                               H, L)
    scale = float(np.float32(1.0 / np.sqrt(hd)))

    def rnd(t):
        return t.to(dt).float()

    def mm(a, b):  # operands in dt, fp32 accumulation
        return torch.matmul(rnd(a), rnd(b))

    rows = (torch.arange(R) < L).float()[:, None]  # real rows
    cols_d = (torch.arange(Dp) < D).float()
    cols_f = (torch.arange(FFp) < FF).float()
    valid = rows * rows.T                           # (query, key) < L
    xp = _pad_to(x.float(), R, Dp)
    gp = _pad_to(g.float(), R, Dp)
    if masks is not None:
        m_attn = _pad_to(masks["m_attn"].float(), R, R)
        mres = _pad_to(masks["m_res"].float(), R, Dp)
        mf1 = _pad_to(masks["m_ffn1"].float(), R, FFp)
        mf2 = _pad_to(masks["m_ffn2"].float(), R, Dp)
    else:
        m_attn = valid.expand(B, H, R, R)
        mres, mf2 = rows * cols_d, rows * cols_d
        mf1 = rows * cols_f

    # ——— recompute, the backward's rounding policy ———
    qkv = rnd(mm(xp, pk["wqkv"]) + pk["bqkv"]) * rows
    q, k, v = (qkv[..., i * ip:(i + 1) * ip].reshape(B, R, H, hdp)
               .transpose(1, 2) for i in range(3))   # (B, H, 64, hdp)

    keys = (torch.arange(R) >= L)[None, :]  # padded key columns

    def softmax_rows(s):
        """fp32 softmax over keys < L (every row, padded ones too); returns
        p, each row's max and sum."""
        s = (s * scale).masked_fill(keys, -torch.inf)
        mx = s.amax(-1, keepdim=True)
        e = torch.exp(s - mx).masked_fill(keys, 0.0)
        z = e.sum(-1, keepdim=True)
        return e / z, mx, z

    pr, mx, z = softmax_rows(q @ k.transpose(-1, -2))
    pm = rnd(pr * m_attn)
    o = rnd(pm @ v).transpose(1, 2).reshape(B, R, ip) * rows
    r1 = xp + (mm(o, pk["wo"]) + pk["bo"]) * mres

    def ln_fwd(h):
        hd_ = h[..., :D]
        mu = hd_.mean(-1, keepdim=True)
        var = (hd_ - mu).square().mean(-1, keepdim=True)
        inv = torch.rsqrt(var + 1e-6)
        return (h - mu) * inv * cols_d * rows, inv

    xhat1, inv1 = ln_fwd(r1)
    h1 = xhat1 * pk["ln1_s"] + pk["ln1_b"]
    h1dt = rnd(h1) * rows
    u = mm(h1dt, pk["w1"]) + pk["b1"]
    g1, dgelu = _gelu_tanh_and_grad(u)
    g1m = rnd(g1 * mf1)
    r2 = h1 + (mm(g1m, pk["w2"]) + pk["b2"]) * mf2
    xhat2, inv2 = ln_fwd(r2 * rows * cols_d)

    # ——— backward ———
    def ln_bwd(gy, xhat, inv, s_p):
        gxh = gy * s_p
        m1 = gxh[..., :D].mean(-1, keepdim=True)
        m2 = (gxh * xhat)[..., :D].mean(-1, keepdim=True)
        return (gxh - m1 - xhat * m2) * inv * cols_d * rows

    vec = {"ln2_s": (gp * xhat2).sum(1), "ln2_b": gp.sum(1)}
    d_r2 = ln_bwd(gp, xhat2, inv2, pk["ln2_s"])
    d_z = d_r2 * mf2
    vec["b2"] = d_z.sum(1)
    dz = rnd(d_z)
    d_u = mm(dz, pk["w2"].T) * mf1 * dgelu
    vec["b1"] = d_u.sum(1)
    du = rnd(d_u)
    d_h1 = d_r2 + mm(du, pk["w1"].T)
    vec["ln1_s"], vec["ln1_b"] = (d_h1 * xhat1).sum(1), d_h1.sum(1)
    d_r1 = ln_bwd(d_h1, xhat1, inv1, pk["ln1_s"])
    d_attn = d_r1 * mres
    vec["bo"] = d_attn.sum(1)
    da = rnd(d_attn)
    d_o = rnd(mm(da, pk["wo"].T)).reshape(B, R, H, hdp).transpose(1, 2)

    # query pass: d_p, the row sums Σ d_p p, d_s, d_q = d_s k
    d_p = (d_o @ v.transpose(-1, -2)) * m_attn
    rsum = (d_p * pr).sum(-1, keepdim=True)
    d_s = rnd((d_p - rsum) * pr * scale) * valid
    d_q = d_s @ k
    # key pass (rows are keys): pᵀ from the query pass's row statistics
    sT = (k @ q.transpose(-1, -2)) * scale
    prT = torch.exp(sT - mx.transpose(-1, -2)) / z.transpose(-1, -2)
    prT = prT * valid
    mT = m_attn.transpose(-1, -2)
    d_v = rnd(prT * mT) @ d_o
    d_pT = (v @ d_o.transpose(-1, -2)) * mT
    d_sT = rnd((d_pT - rsum.transpose(-1, -2)) * prT * scale) * valid
    d_k = d_sT @ q
    parts = [t.transpose(1, 2).reshape(B, R, ip) * rows
             for t in (d_q, d_k, d_v)]
    vec["bqkv"] = torch.cat([t.sum(1) for t in parts], dim=1)
    dqkv = [rnd(t) for t in parts]
    dx = d_r1
    for i, t in enumerate(dqkv):
        dx = dx + mm(t, pk["wqkv"][:, i * ip:(i + 1) * ip].T)
    dx = dx[:, :L, :D].to(dt)

    # ——— dW = Aᵀ Y over the B·L rows: split-K chunks summed in order ———
    N = B * L
    chunk = _ceil_to(_ceil_to(N, DW_CHUNKS) // DW_CHUNKS, 32)

    def dw(a, y):
        a = a[:, :L].reshape(N, -1)
        y = y[:, :L].reshape(N, -1)
        out = torch.zeros(a.shape[1], y.shape[1])
        for c in range(DW_CHUNKS):
            out = out + mm(a[c * chunk:(c + 1) * chunk].T,
                           y[c * chunk:(c + 1) * chunk])
        return out

    # real index of each padded head column
    heads = (torch.arange(H)[:, None] * hdp + torch.arange(hd)).reshape(-1)
    qkv_cols = torch.cat([heads + i * ip for i in range(3)])
    d_wqkv = dw(xp, torch.cat(dqkv, dim=2))[:D][:, qkv_cols]
    grads = {"wq": d_wqkv[:, :inner], "wk": d_wqkv[:, inner:2 * inner],
             "wv": d_wqkv[:, 2 * inner:],
             "wo": dw(o, da)[heads][:, :D], "w1": dw(h1dt, du)[:D, :FF],
             "w2": dw(g1m, dz)[:FF, :D]}

    # per-sample vectors summed over the batch: 32 chunks in order, then
    # the chunks (reduce.cuh::sum_rows twice)
    per = _ceil_to(B, DW_CHUNKS) // DW_CHUNKS

    def batch_sum(t):
        return sum(t[c * per:(c + 1) * per].sum(0) for c in range(DW_CHUNKS)
                   if c * per < B)

    b_qkv = batch_sum(vec.pop("bqkv"))[qkv_cols]
    grads.update(bq=b_qkv[:inner], bk=b_qkv[inner:2 * inner],
                 bv=b_qkv[2 * inner:])
    for key, n in (("bo", D), ("b1", FF), ("b2", D), ("ln1_s", D),
                   ("ln1_b", D), ("ln2_s", D), ("ln2_b", D)):
        grads[key] = batch_sum(vec[key])[:n]
    return dx, grads


# ——— the kernels ———


class _Dropout:
    """How a call drops out: mode "none", "masks" (four tensors in x's
    dtype) or "seed" (an int32 seed, a Python int or a one-element tensor,
    the rate, and ``sample0``, the global index of the call's first
    sample)."""

    def __init__(self, masks=None, dropout_p: float = 0.0, seed=None,
                 sample0: int = 0):
        self.masks = masks
        self.p = dropout_p
        self.seed = seed
        self.sample0 = int(sample0)
        if masks is not None:
            self.mode = "masks"
        elif dropout_p > 0.0 and seed is not None:
            self.mode = "seed"
        else:
            self.mode = "none"

    def plain_masks(self, x, n_heads, d_ff):
        """The masks the plain versions apply: as given, or drawn."""
        if self.mode == "masks":
            return self.masks
        if self.mode == "seed":
            B, L, D = x.shape
            return draw_keep_masks(self.seed, B, n_heads, L, D, d_ff, self.p,
                                   row0=self.sample0, device=x.device)
        return None

    def c_args(self, x: torch.Tensor):
        """(mode, mask pointer array, seed pointer, threshold, keep value,
        sample0) for the launchers; keeps the device seed alive on
        ``self``."""
        ptrs = [0, 0, 0, 0]
        seed_ptr, thresh, value = 0, 0, 0.0
        if self.mode == "masks":
            ptrs = [self.masks[k].data_ptr() for k in MASK_ORDER]
        elif self.mode == "seed":
            if not torch.is_tensor(self.seed):
                self.seed = torch.tensor([int(self.seed)], dtype=torch.int32)
            self.seed = self.seed.to(x.device, torch.int32).reshape(1)
            seed_ptr = self.seed.data_ptr()
            thresh, value = keep_rule(self.p)
        return (_MODES[self.mode], (ctypes.c_void_p * 4)(*ptrs), seed_ptr,
                ctypes.c_uint(thresh), ctypes.c_float(value),
                ctypes.c_uint(self.sample0))


def _check_shapes(x, p, n_heads, masks):
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
    if masks is not None:
        want = {"m_attn": (B, n_heads, L, L), "m_res": (B, L, D),
                "m_ffn1": (B, L, FF), "m_ffn2": (B, L, D)}
        for k, shape in want.items():
            if tuple(masks[k].shape) != shape:
                raise ValueError(f"mask {k} has shape "
                                 f"{tuple(masks[k].shape)}, expected {shape}")
    return B, L, D, inner, FF


def _forward(x, p, n_heads, drop: _Dropout) -> torch.Tensor:
    FF = p["w1"].shape[1]
    if x.device.type == "cpu":
        masks = drop.plain_masks(x, n_heads, FF)
        return attention_layer_reference(x, p, n_heads, masks=masks)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention_layer: no kernel for {x.device}")
    B, L, D, inner, FF = _check_shapes(x, p, n_heads, drop.masks)
    _build.check_cuda_args("fused_attention_layer", x,
                           {**p, **(drop.masks or {})})
    code = _build.DTYPE_CODES[x.dtype]
    lib = _build.lib()
    ws_bytes = lib.eid_attention_fwd_workspace(code, L, D, inner, FF,
                                               n_heads)
    if ws_bytes < 0:
        raise ValueError(f"attention_fwd ({forward_design(x.dtype)}): shapes "
                         f"(L {L}, D {D}, inner {inner}, FF {FF}, {n_heads} "
                         "heads) do not fit the kernel")
    # the bfloat16 design's packed, zero-padded weights
    ws = torch.empty(max(ws_bytes, 1), dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    weights = _build.pointer_array([p[k] for k in PARAM_ORDER])
    rc = lib.eid_attention_fwd(
        code, x.data_ptr(), weights, out.data_ptr(), ws.data_ptr(), B, L, D,
        inner, FF, n_heads, *drop.c_args(x), _build.stream_of(x))
    name = {"none": "attention_fwd", "masks": "attention_fwd_masks",
            "seed": "attention_fwd_seed"}[drop.mode]
    _build.check(rc, name)
    _build.LAUNCHES[name] += 1
    return out


def _backward(x, p, g, n_heads, drop: _Dropout):
    """(dx, fp32 gradients); p in x's dtype."""
    FF = p["w1"].shape[1]
    if x.device.type == "cpu":
        masks = drop.plain_masks(x, n_heads, FF)
        return attention_layer_backward_reference(x, p, g, n_heads,
                                                  masks=masks)
    B, L, D, inner, FF = _check_shapes(x, p, n_heads, drop.masks)
    if g.shape != x.shape:
        raise ValueError(f"g has shape {tuple(g.shape)}, expected "
                         f"{tuple(x.shape)}")
    g = g.to(x.dtype).contiguous()
    _build.check_cuda_args("fused_attention_layer backward", x,
                           {**p, **(drop.masks or {}), "g": g})
    code = _build.DTYPE_CODES[x.dtype]
    lib = _build.lib()
    ws_bytes = lib.eid_attention_bwd_workspace(code, B, L, D, inner, FF,
                                               n_heads)
    if ws_bytes < 0:
        raise ValueError(f"attention_bwd ({backward_design(x.dtype)}): shapes "
                         f"(L {L}, D {D}, inner {inner}, FF {FF}, {n_heads} "
                         "heads) do not fit the kernel")
    ws = torch.empty(max(ws_bytes, 1), dtype=torch.uint8, device=x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    d_wqkv = torch.empty((D, 3 * inner), **f32)
    d_wo = torch.empty((inner, D), **f32)
    d_w1 = torch.empty((D, FF), **f32)
    d_w2 = torch.empty((FF, D), **f32)
    d_vec = torch.empty((3 * inner + 6 * D + FF,), **f32)
    # the float32 design reads transposed copies of the six weights for its
    # products with Wᵀ; the bfloat16 design reads its packed weights K-major
    wt = ([p[k].t().contiguous() for k in ("wq", "wk", "wv", "wo", "w1", "w2")]
          if x.dtype == torch.float32 else [])
    weights = _build.pointer_array([p[k] for k in PARAM_ORDER])
    wt_ptrs = _build.pointer_array(wt) if wt else (ctypes.c_void_p * 6)()
    outs = _build.pointer_array([d_wqkv, d_wo, d_w1, d_w2, d_vec])
    rc = lib.eid_attention_bwd(
        code, x.data_ptr(), g.data_ptr(), weights, wt_ptrs, dx.data_ptr(),
        outs, ws.data_ptr(), B, L, D, inner, FF, n_heads, *drop.c_args(x),
        _build.stream_of(x))
    _build.check(rc, "attention_bwd")
    _build.LAUNCHES["attention_bwd"] += 1
    grads = {"wq": d_wqkv[:, :inner], "wk": d_wqkv[:, inner:2 * inner],
             "wv": d_wqkv[:, 2 * inner:], "wo": d_wo, "w1": d_w1, "w2": d_w2}
    off = 0
    for k, n in (("bq", inner), ("bk", inner), ("bv", inner), ("bo", D),
                 ("b1", FF), ("b2", D), ("ln1_s", D), ("ln1_b", D),
                 ("ln2_s", D), ("ln2_b", D)):
        grads[k] = d_vec[off:off + n]
        off += n
    return dx, grads


def forward_design(dtype: torch.dtype) -> str:
    """The design the forward launcher takes for ``dtype``: ``"mma_bf16"``
    (tensor cores) or ``"fma_fp32"`` (full-fp32 FMA products)."""
    return _build.lib().eid_attention_fwd_design(
        _build.DTYPE_CODES[dtype]).decode()


def backward_design(dtype: torch.dtype) -> str:
    """The design the backward launcher takes for ``dtype``: ``"mma_bf16"``
    (tensor cores) or ``"fma_fp32"`` (full-fp32 FMA products)."""
    return _build.lib().eid_attention_bwd_design(
        _build.DTYPE_CODES[dtype]).decode()


class _AttentionLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n_heads, drop, *flat):
        p = dict(zip(PARAM_ORDER, flat))
        ctx.n_heads, ctx.drop = n_heads, drop
        ctx.save_for_backward(x, *flat)
        return _forward(x, p, n_heads, drop)

    @staticmethod
    def backward(ctx, g):
        x, *flat = ctx.saved_tensors
        p = dict(zip(PARAM_ORDER, flat))
        dx, grads = _backward(x, p, g, ctx.n_heads, ctx.drop)
        # each gradient in the dtype of the parameter passed in (x's dtype),
        # as the JAX launcher returns them
        return (dx, None, None,
                *[grads[k].to(p[k].dtype).contiguous() for k in PARAM_ORDER])


def fused_attention_layer(x: torch.Tensor, params: dict, n_heads: int = 4, *,
                          masks: dict | None = None, dropout_p: float = 0.0,
                          seed=None, sample0: int = 0) -> torch.Tensor:
    """Fused post-norm attention layer: (B, L, D) → (B, L, D), differentiable.

    ``params``: wq,bq,wk,bk,wv,bv (D, H·hd), wo (H·hd, D), bo, ln1_s, ln1_b,
    w1 (D, FF), b1, w2 (FF, D), b2, ln2_s, ln2_b, in the JAX layout. They are
    cast to x's dtype, as the JAX launcher does, and their gradients come
    back through that cast. ``masks`` (dict of the four keep-masks) selects
    mask mode; ``dropout_p > 0`` with ``seed`` (int32, an int or a
    one-element tensor, which may lie on the card) selects seed mode;
    ``sample0`` is then the global index of x's first sample, so a
    data-parallel rank holding rows r·B … r·B + B − 1 of the batch draws
    what one call over the whole batch draws for them. A CPU tensor runs the
    plain versions; a CUDA tensor launches the kernels (float32 or
    bfloat16) or raises."""
    dt = x.dtype
    flat = [params[k].to(dt).contiguous() for k in PARAM_ORDER]
    if masks is not None:
        masks = {k: masks[k].to(x.device, dt).contiguous() for k in MASK_ORDER}
    drop = _Dropout(masks, dropout_p, seed, sample0)
    return _AttentionLayer.apply(x.contiguous(), n_heads, drop, *flat)
