"""Folded temporal conv + average pool, stage 1 of the tsconv stack
(counterpart of ``eeg_image_decode_tpu/ops/tsconv.py``).

``Conv2d(1→40, (1,25)) → AvgPool((1,51), stride (1,5))`` is linear in its
input, so the pool folds into the conv: one 75-tap correlation at stride 5
with ``w̃ = box₅₁ ⋆ w / 51`` (:func:`fold_pool_into_kernel`). In eval mode
every stage-1 formulation of the JAX package (conv + pool, the dense
``x2 @ E`` matmul, the Pallas kernel) computes this same function; the port
computes it with a hand port of the Pallas kernel, the formulation with the
fewest FLOPs.

``tsconv_pool_fused`` is a ``torch.autograd.Function``. For a CUDA tensor
it launches ``csrc/tsconv_fwd.cu`` forward and ``csrc/tsconv_bwd.cu``
backward; for a CPU tensor it runs the plain versions,
``tsconv_pool_reference`` (a strided unfold and one matmul) and
``tsconv_pool_backward_reference``. ``fold_pool_into_kernel`` stays plain
PyTorch, so autograd carries dw̃ back to the 25-tap kernel.
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


def tsconv_pool_backward_reference(x: torch.Tensor, w_tilde: torch.Tensor,
                                   g: torch.Tensor, stride: int = 5
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain backward of stage 1, the two sums of the JAX backward kernel:
    ``dx[r, p·s+m] += Σ_f g[r, p·F+f]·w̃[m, f]`` and
    ``dw̃[m, f] = Σ_r Σ_p x[r, p·s+m]·g[r, p·F+f]``, with g and w̃ in x's
    dtype and fp32 accumulation, positions added in order. Returns
    (dx (B, C, T), dw̃ (M, F)), both fp32."""
    b, c, t = x.shape
    m, f = w_tilde.shape
    x2 = x.reshape(b * c, t)
    g3 = g.to(x.dtype).reshape(b * c, -1, f).float()          # (rows, P, F)
    w32 = w_tilde.to(x.dtype).float()
    d_win = torch.matmul(g3, w32.T)                           # (rows, P, M)
    dx = torch.zeros((b * c, t), dtype=torch.float32, device=x.device)
    for p in range(g3.shape[1]):
        dx[:, p * stride:p * stride + m] += d_win[:, p]
    windows = x2.unfold(1, m, stride).float()                 # (rows, P, M)
    dw = torch.matmul(windows.reshape(-1, m).T, g3.reshape(-1, f))
    return dx.reshape(b, c, t), dw


def _forward(x: torch.Tensor, w_tilde: torch.Tensor,
             stride: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return tsconv_pool_reference(x, w_tilde, stride)
    if x.device.type != "cuda":
        raise ValueError(f"tsconv_pool_fused: no kernel for {x.device}")
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


def _backward(x: torch.Tensor, w_tilde: torch.Tensor, g: torch.Tensor,
              stride: int) -> tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return tsconv_pool_backward_reference(x, w_tilde, g, stride)
    b, c, t = x.shape
    m, f = w_tilde.shape
    n_pos = out_positions(t, m, stride)
    g = g.to(x.dtype).contiguous()
    _build.check_cuda_args("tsconv_pool_fused backward", x,
                           {"w_tilde": w_tilde, "g": g})
    if tuple(g.shape) != (b, c, n_pos, f):
        raise ValueError(f"g has shape {tuple(g.shape)}, expected "
                         f"{(b, c, n_pos, f)}")
    lib = _build.lib()
    ws = torch.empty(max(lib.eid_tsconv_bwd_workspace(b * c, m, f), 1),
                     dtype=torch.uint8, device=x.device)
    dx = torch.empty((b, c, t), dtype=torch.float32, device=x.device)
    dw = torch.empty((m, f), dtype=torch.float32, device=x.device)
    rc = lib.eid_tsconv_bwd(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), g.data_ptr(),
        w_tilde.data_ptr(), dx.data_ptr(), dw.data_ptr(), ws.data_ptr(),
        b * c, t, m, f, n_pos, stride, _build.stream_of(x))
    _build.check(rc, "tsconv_bwd")
    _build.LAUNCHES["tsconv_bwd"] += 1
    return dx, dw


class _TSConvPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_tilde, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, w_tilde)
        return _forward(x, w_tilde, stride)

    @staticmethod
    def backward(ctx, g):
        x, w_tilde = ctx.saved_tensors
        dx, dw = _backward(x, w_tilde, g, ctx.stride)
        return dx.to(x.dtype), dw.to(w_tilde.dtype), None


def tsconv_pool_fused(x: torch.Tensor, w_tilde: torch.Tensor,
                      stride: int = 5) -> torch.Tensor:
    """Folded conv + pool: (B, C, T) × (M, F) → (B, C, P, F) in x's dtype,
    differentiable in x and w̃.

    w̃ is cast to x's dtype, as the JAX launcher does. A CPU tensor runs
    the plain versions; a CUDA tensor launches the kernels (float32 or
    bfloat16) or raises."""
    return _TSConvPool.apply(x.contiguous(), w_tilde.to(x.dtype).contiguous(),
                             stride)
