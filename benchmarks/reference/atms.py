"""Plain float32 ATM-S (arXiv 2403.07721; ``Retrieval/ATMS_retrieval.py:
44-191``) with its contrastive loss and AdamW, written from the published
layer equations; the reference the training and the reconstruct cells are
held against. It imports nothing of the port.

    (B, 63, 250) EEG
      → Dense(250→250) per channel + sinusoidal positions (interleaved
        sin/cos), a learned subject token prepended, dropout
      → a post-norm attention layer over the 64 tokens: 4 heads of 62
        (QKV 250→248), softmax scale 1/√62, FFN 250→256→250 with the
        configuration's GELU, dropout at four sites
      → LayerNorm (eps 1e-6), the first 63 tokens
      → temporal conv (25 taps, valid) + average pool (51, stride 5)
        → BatchNorm → ELU → spatial conv over the 63 rows → BatchNorm → ELU
        → dropout → 1×1 conv 40→40 → flatten (1440)
      → Dense(1440→1024) a; LayerNorm(a + dropout(Dense(GELU_erf(a))))

Dropout draws what the program draws from the same seeds: the embedding,
tsconv and projection sites ``torch.rand`` from the step's generator (keep
iff u ≥ p, kept values ×1/(1−p)); the attention layer an int32 seed from
it, whose four masks are Philox draws keyed by (seed, sample)
(:mod:`benchmarks.reference.philox`). BatchNorm uses the batch statistics
in training (biased variance, eps 1e-5) and the running ones in eval.

Parameters are a flat dict under the program's state-dict names
(:func:`param_shapes`); :func:`forward` is a pure function of them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmarks.reference.philox import keep_mask
from benchmarks.reference.precision import mm, operand, product

E = "encoder."


def param_shapes(m: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every parameter and BatchNorm statistic, in the
    order the weights are drawn; ``m`` is the configuration's ``model``."""
    d, t, c = m["d_model"], m["seq_len"], m["n_channels"]
    inner = (d // m["n_heads"]) * m["n_heads"]
    ff, f, s = m["d_ff"], m["conv_filters"], m["num_subjects"]
    k_fused = m["temporal_kernel"] + m["pool_size"] - 1
    n_pos = (d - k_fused) // m["pool_stride"] + 1
    emb = E + "embedding."
    out = []
    if m["joint_train"]:
        out += [(emb + "subject_value_w", (s, t, d)),
                (emb + "subject_value_b", (s, d))]
    else:
        out += [(emb + "value_embedding.kernel", (t, d)),
                (emb + "value_embedding.bias", (d,))]
    out += [(emb + "subject_token.subject_embedding", (s, d)),
            (emb + "subject_token.shared_embedding", (1, d))]
    for i in range(m["n_layers"]):
        lay = f"{E}encoder_layer_{i}."
        for name, shape in (("q_proj", (d, inner)), ("k_proj", (d, inner)),
                            ("v_proj", (d, inner)), ("out_proj", (inner, d)),
                            ("ffn_in", (d, ff)), ("ffn_out", (ff, d))):
            out += [(lay + name + ".kernel", shape),
                    (lay + name + ".bias", (shape[1],))]
        for ln in ("norm1", "norm2"):
            out += [(lay + ln + ".scale", (d,)), (lay + ln + ".bias", (d,))]
    out += [(E + "encoder_norm.scale", (d,)), (E + "encoder_norm.bias", (d,))]
    ts = E + "enc_eeg."
    out += [(ts + "temporal_conv_kernel", (m["temporal_kernel"], f)),
            (ts + "spatial_conv.kernel", (c * f, f)),
            (ts + "proj_conv.kernel", (f, m["emb_size"])),
            (ts + "proj_conv.bias", (m["emb_size"],))]
    for bn in ("bn1", "bn2"):
        out += [(ts + bn + ".scale", (f,)), (ts + bn + ".bias", (f,)),
                (ts + bn + ".mean", (f,)), (ts + bn + ".var", (f,))]
    pj = E + "proj_eeg."
    p = m["proj_dim"]
    out += [(pj + "in_proj.kernel", (n_pos * m["emb_size"], p)),
            (pj + "in_proj.bias", (p,)),
            (pj + "res_proj.kernel", (p, p)), (pj + "res_proj.bias", (p,)),
            (pj + "ln.scale", (p,)), (pj + "ln.bias", (p,)),
            ("logit_scale.logit_scale", ())]
    return out


def is_statistic(name: str) -> bool:
    """A BatchNorm running statistic (a buffer, not a parameter)."""
    return name.endswith((".mean", ".var"))


def positions(n: int, d: int, device) -> torch.Tensor:
    """Interleaved sin/cos table (ref ``Embed.py:8-26``), in float64 then
    float32."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(np.log(1e4) / d))
    pe = np.zeros((n, d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: d // 2])
    return torch.from_numpy(pe.astype(np.float32)).to(device)


def _dropout(h, p, gen):
    u = torch.rand(h.shape, generator=gen, device=h.device)
    return torch.where(u >= p, h / (1.0 - p), torch.zeros((), device=h.device))


def _ln(h, s, b, eps=1e-6):
    return F.layer_norm(h, (h.shape[-1],), s, b, eps=eps)


def _bn(y, prm, name, train):
    """BatchNorm over the last axis: batch statistics in training."""
    if train:
        flat = y.reshape(-1, y.shape[-1])
        mean = flat.mean(0)
        var = torch.clamp((flat * flat).mean(0) - mean * mean, min=0.0)
    else:
        mean, var = prm[name + ".mean"], prm[name + ".var"]
    return ((y - mean) * torch.rsqrt(var + 1e-5) * prm[name + ".scale"]
            + prm[name + ".bias"])


def _attention_layer(x, prm, pre, m, masks):
    b, length, d = x.shape
    h = m["n_heads"]
    hd = d // h

    def dense(t, name):
        return mm(t, prm[pre + name + ".kernel"]) + prm[pre + name + ".bias"]

    q, k, v = (dense(x, n).reshape(b, length, h, hd)
               for n in ("q_proj", "k_proj", "v_proj"))
    scores = product(torch.einsum("blhe,bshe->bhls", operand(q),
                                  operand(k)))
    probs = torch.softmax(scores / math.sqrt(hd), dim=-1)
    if masks:
        probs = probs * masks["m_attn"]
    out = product(torch.einsum("bhls,bshd->blhd", operand(probs),
                               operand(v)))
    out = dense(out.reshape(b, length, h * hd), "out_proj")
    if masks:
        out = out * masks["m_res"]
    hid = _ln(x + out, prm[pre + "norm1.scale"], prm[pre + "norm1.bias"])
    y = F.gelu(dense(hid, "ffn_in"),
               approximate="none" if m["exact_gelu"] else "tanh")
    if masks:
        y = y * masks["m_ffn1"]
    y = dense(y, "ffn_out")
    if masks:
        y = y * masks["m_ffn2"]
    return _ln(hid + y, prm[pre + "norm2.scale"], prm[pre + "norm2.bias"])


def attention_masks(seed: int, b: int, m: dict, device) -> dict:
    """The four fp32 keep-masks (0 or 1/keep) of an attention layer's seed:
    sites 0-3 (probabilities, residual, FFN hidden, FFN out)."""
    d = m["d_model"]
    length = m["n_channels"] + 1
    shapes = {"m_attn": (m["n_heads"], length, length),
              "m_res": (length, d), "m_ffn1": (length, m["d_ff"]),
              "m_ffn2": (length, d)}
    rows = torch.arange(b, dtype=torch.int64, device=device)
    return {name: keep_mask(seed, rows, site, math.prod(shape),
                            m["dropout"]).reshape(b, *shape)
            for site, (name, shape) in enumerate(shapes.items())}


def forward(prm: dict, m: dict, x: torch.Tensor, sids: torch.Tensor, *,
            train: bool, gen: torch.Generator | None = None):
    """(features (B, proj_dim), logit scale) of EEG ``x`` (B, C, T)."""
    b, c, _ = x.shape
    d = m["d_model"]
    ns = m["num_subjects"]
    safe = sids.clamp(0, ns - 1).long()
    emb = E + "embedding."
    if m["joint_train"]:
        h = (product(torch.bmm(operand(x),
                               operand(prm[emb + "subject_value_w"][safe])))
             + prm[emb + "subject_value_b"][safe][:, None, :])
    else:
        h = (mm(x, prm[emb + "value_embedding.kernel"])
             + prm[emb + "value_embedding.bias"])
    h = h + positions(c, d, x.device)
    # an id out of range anywhere in the batch: every row takes the shared
    # token (the reference's quirk, ``Embed.py:109-121``)
    tok = torch.where((sids >= ns).any(),
                      prm[emb + "subject_token.shared_embedding"],
                      prm[emb + "subject_token.subject_embedding"][safe])
    h = torch.cat([tok[:, None, :], h], dim=1)
    drop = train and m["dropout"] > 0
    if drop:
        h = _dropout(h, m["dropout"], gen)
    for i in range(m["n_layers"]):
        masks = None
        if drop:
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen,
                                     device=x.device, dtype=torch.int32))
            masks = attention_masks(seed, b, m, x.device)
        h = _attention_layer(h, prm, f"{E}encoder_layer_{i}.", m, masks)
    h = _ln(h, prm[E + "encoder_norm.scale"], prm[E + "encoder_norm.bias"])
    h = h[:, :c, :]
    # temporal conv then average pool, per electrode row
    ts = E + "enc_eeg."
    f = m["conv_filters"]
    w = prm[ts + "temporal_conv_kernel"].t()[:, None, :]        # (F, 1, K)
    y = product(F.conv1d(operand(h.reshape(b * c, 1, d)), operand(w)))
    y = F.avg_pool1d(y, m["pool_size"], m["pool_stride"])      # (B·C, F, P)
    p = y.shape[-1]
    y = y.reshape(b, c, f, p).permute(0, 1, 3, 2)               # (B, C, P, F)
    y = F.elu(_bn(y, prm, ts + "bn1", train))
    y = mm(y.permute(0, 2, 1, 3).reshape(b * p, c * f),
           prm[ts + "spatial_conv.kernel"])
    y = F.elu(_bn(y, prm, ts + "bn2", train))
    if train and m["conv_dropout"] > 0:
        y = _dropout(y.reshape(b, 1, p, f), m["conv_dropout"], gen)
    y = (mm(y.reshape(b * p, f), prm[ts + "proj_conv.kernel"])
         + prm[ts + "proj_conv.bias"])
    x2 = y.reshape(b, -1)
    pj = E + "proj_eeg."
    a = mm(x2, prm[pj + "in_proj.kernel"]) + prm[pj + "in_proj.bias"]
    r = (mm(F.gelu(a, approximate="none"), prm[pj + "res_proj.kernel"])
         + prm[pj + "res_proj.bias"])
    if train and m["proj_dropout"] > 0:
        r = _dropout(r, m["proj_dropout"], gen)
    feats = _ln(a + r, prm[pj + "ln.scale"], prm[pj + "ln.bias"])
    return feats, prm["logit_scale.logit_scale"]


def infonce(a: torch.Tensor, b: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric InfoNCE with labels arange(N); the scale multiplies the
    logits as it is (ref ``models/loss.py:122-140``)."""
    logits = scale * mm(a, b.t())
    n = torch.arange(a.shape[0], device=a.device)
    return 0.5 * (F.cross_entropy(logits, n) + F.cross_entropy(logits.t(), n))


def retrieval_loss(feats, img, text, scale, alpha: float) -> torch.Tensor:
    """alpha·InfoNCE(eeg, image) + (1 − alpha)·InfoNCE(eeg, text)."""
    return (alpha * infonce(feats, img, scale)
            + (1.0 - alpha) * infonce(feats, text, scale))


class AdamW:
    """Decoupled AdamW over a dict of float32 leaves (lr, weight decay,
    β (0.9, 0.999), ε 1e-8), with the bias corrections."""

    def __init__(self, prm: dict, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in prm.items()}
        self.v = {k: torch.zeros_like(v) for k, v in prm.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, prm: dict, grads: dict) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            prm[k].mul_(1 - self.lr * self.wd)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            prm[k].addcdiv_(self.m[k], denom, value=-self.lr / c1)
