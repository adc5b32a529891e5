"""Folded temporal conv + average pool, stage 1 of the tsconv stack
(counterpart of ``eeg_image_decode_tpu/ops/tsconv.py``).

``Conv2d(1→40, (1,25)) → AvgPool((1,51), stride (1,5))`` is linear in its
input, so the pool folds into the conv: one 75-tap correlation at stride 5
with ``w̃ = box₅₁ ⋆ w / 51`` (:func:`fold_pool_into_kernel`). In eval mode
every stage-1 formulation of the JAX package (conv + pool, the dense
``x2 @ E`` matmul, the Pallas kernel) computes this same function; the port
computes it with a hand port of the Pallas kernel, the formulation with the
fewest FLOPs.

``tsconv_pool_fused`` launches ``csrc/tsconv_fwd.cu`` for a CUDA tensor and
runs ``tsconv_pool_reference`` (a strided unfold and one matmul) for a CPU
tensor.
"""

from __future__ import annotations

import torch

from eeg_image_decode_tpu_torch.ops import _build


def fold_pool_into_kernel(w: torch.Tensor, pool_size: int = 51) -> torch.Tensor:
    """(K, F) conv taps → (K+pool−1, F) pooled-conv taps (box correlation)."""
    k, _ = w.shape
    out_len = k + pool_size - 1
    idx = (torch.arange(out_len, device=w.device)[:, None]
           - torch.arange(pool_size, device=w.device)[None, :])  # (M, pool)
    valid = (idx >= 0) & (idx < k)
    gathered = torch.where(valid[..., None], w[idx.clamp(0, k - 1)],
                           torch.zeros((), dtype=w.dtype, device=w.device))
    return gathered.sum(dim=1) / pool_size


def out_positions(t: int, k_fused: int, stride: int) -> int:
    return (t - k_fused) // stride + 1


def tsconv_pool_reference(x: torch.Tensor, w_tilde: torch.Tensor,
                          stride: int = 5) -> torch.Tensor:
    """Plain PyTorch stage 1: (B, C, T) × (M, F) → (B, C, P, F) in x's dtype,
    fp32 accumulation."""
    b, c, t = x.shape
    m, f = w_tilde.shape
    windows = x.reshape(b * c, t).unfold(1, m, stride)  # (B·C, P, M) view
    out = torch.matmul(windows, w_tilde.to(x.dtype))    # (B·C, P, F)
    return out.reshape(b, c, -1, f)


def tsconv_pool_fused(x: torch.Tensor, w_tilde: torch.Tensor,
                      stride: int = 5) -> torch.Tensor:
    """Folded conv + pool: (B, C, T) × (M, F) → (B, C, P, F) in x's dtype.

    w̃ is cast to x's dtype, as the JAX launcher does. A CPU tensor runs
    :func:`tsconv_pool_reference`; a CUDA tensor launches the kernel
    (float32 or bfloat16) or raises."""
    w_tilde = w_tilde.to(x.dtype).contiguous()
    if x.device.type == "cpu":
        return tsconv_pool_reference(x, w_tilde, stride)
    if x.device.type != "cuda":
        raise ValueError(f"tsconv_pool_fused: no kernel for {x.device}")
    x = x.contiguous()
    b, c, t = x.shape
    m, f = w_tilde.shape
    n_pos = out_positions(t, m, stride)
    if n_pos <= 0:
        raise ValueError(f"{m} taps do not fit in {t} samples")
    _build.check_cuda_args("tsconv_pool_fused", x, {"w_tilde": w_tilde})
    out = torch.empty((b, c, n_pos, f), dtype=x.dtype, device=x.device)
    rc = _build.lib().eid_tsconv_fwd(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), w_tilde.data_ptr(),
        out.data_ptr(), b * c, t, m, f, n_pos, stride, _build.stream_of(x))
    _build.check(rc, "tsconv_fwd")
    _build.LAUNCHES["tsconv_fwd"] += 1
    return out
