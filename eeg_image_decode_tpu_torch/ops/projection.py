"""Fused projection head (counterpart of
``eeg_image_decode_tpu/ops/projection.py``, the ``Proj_eeg`` MLP):

    y = LayerNorm(a + res_proj(GELU(a))),   a = in_proj(x)

with ``a`` kept in fp32, tanh GELU and a biased-variance fp32 LayerNorm
(eps 1e-6); the output is fp32. ``fused_projection_head`` launches
``csrc/projection_fwd.cu`` for a CUDA tensor and runs
``projection_head_reference`` for a CPU tensor. Forward only, no dropout;
the dropout modes and the backward kernel belong to training (ROADMAP.md).

The model's default head (``models/layers.py::ProjectionHead`` with
``fused=False``/``'auto'``) is a different function: exact-erf GELU and the
fast-variance LayerNorm, |Δ| ≲ 1e-3 from this one, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from eeg_image_decode_tpu_torch.ops import _build

PARAM_ORDER = ("wi", "bi", "wr", "br", "ln_s", "ln_b")


def projection_head_reference(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Plain PyTorch head: (B, d_in) → (B, d_out) fp32, the kernel's math."""
    dt = x.dtype
    # products of dtype values, accumulated in fp32 (exact for bf16 inputs)
    a = x.float() @ params["wi"].to(dt).float() + params["bi"].float()
    g = F.gelu(a, approximate="tanh").to(dt)
    z = g.float() @ params["wr"].to(dt).float() + params["br"].float()
    r = a + z
    mu = r.mean(-1, keepdim=True)
    var = r.var(-1, keepdim=True, correction=0)
    xhat = (r - mu) * torch.rsqrt(var + 1e-6)
    return xhat * params["ln_s"].float() + params["ln_b"].float()


def fused_projection_head(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Fused head: (B, d_in) → (B, d_out) float32, no dropout.

    ``params``: wi (d_in, d_out), bi, wr (d_out, d_out), br, ln_s, ln_b in
    the JAX layout, cast to x's dtype as the JAX launcher does. A CPU tensor
    runs :func:`projection_head_reference`; a CUDA tensor launches the
    kernel (float32 or bfloat16) or raises."""
    p = {k: params[k].to(x.dtype).contiguous() for k in PARAM_ORDER}
    if x.device.type == "cpu":
        return projection_head_reference(x, p)
    if x.device.type != "cuda":
        raise ValueError(f"fused_projection_head: no kernel for {x.device}")
    x = x.contiguous()
    B, d_in = x.shape
    d_out = p["wi"].shape[1]
    shapes = {"wi": (d_in, d_out), "bi": (d_out,), "wr": (d_out, d_out),
              "br": (d_out,), "ln_s": (d_out,), "ln_b": (d_out,)}
    for k, shape in shapes.items():
        if tuple(p[k].shape) != shape:
            raise ValueError(f"{k} has shape {tuple(p[k].shape)}, "
                             f"expected {shape}")
    _build.check_cuda_args("fused_projection_head", x, p)
    out = torch.empty((B, d_out), dtype=torch.float32, device=x.device)
    weights = _build.pointer_array([p[k] for k in PARAM_ORDER])
    rc = _build.lib().eid_projection_fwd(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), weights, out.data_ptr(),
        B, d_in, d_out, _build.stream_of(x))
    _build.check(rc, "projection_fwd")
    _build.LAUNCHES["projection_fwd"] += 1
    return out
