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
PyTorch, so autograd carries dw̃ back to the 25-tap kernel. Both kernels
run on the tensor cores in bfloat16 and as full-fp32 FMA loops in float32;
``tsconv_pool_forward_tiled`` and ``tsconv_pool_backward_tiled`` are the
bfloat16 designs' tiling and index math in plain PyTorch, for the CPU
tests.
"""

from __future__ import annotations

import torch

from eeg_image_decode_tpu_torch.ops import _build


class _FoldPool(torch.autograd.Function):
    """The box correlation of :func:`fold_pool_into_kernel`, with a
    backward that sums each tap's ``pool_size`` outputs in one reduction:
    autograd of the gather would accumulate them with ``index_put_``,
    whose CPU threads add in a varying order, so two identical training
    steps could differ in the last bit."""

    @staticmethod
    def forward(ctx, w, pool_size):
        ctx.pool_size = pool_size
        k, _ = w.shape
        out_len = k + pool_size - 1
        idx = (torch.arange(out_len, device=w.device)[:, None]
               - torch.arange(pool_size, device=w.device)[None, :])
        valid = (idx >= 0) & (idx < k)                        # (M, pool)
        gathered = torch.where(valid[..., None], w[idx.clamp(0, k - 1)],
                               torch.zeros((), dtype=w.dtype,
                                           device=w.device))
        return gathered.sum(dim=1) / pool_size

    @staticmethod
    def backward(ctx, g):
        # tap k feeds the outputs m = k … k + pool − 1: one window of g each
        return (g / ctx.pool_size).unfold(0, ctx.pool_size, 1).sum(-1), None


def fold_pool_into_kernel(w: torch.Tensor, pool_size: int = 51) -> torch.Tensor:
    """(K, F) conv taps → (K+pool−1, F) pooled-conv taps (box correlation)."""
    return _FoldPool.apply(w, pool_size)


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


# ——— the index math of the bfloat16 kernels, in plain PyTorch ———

#: rows of x and g per tile (kTileRows of ``csrc/tsconv_tile.cuh``), and, of
#: the backward (``csrc/tsconv_bwd.cu``), samples-per-stride groups (q) per
#: dx tile and zero rows (in strides) on either side of the tap table
ROW_TILE, Q_TILE, TAP_PAD = 32, 8, 9


def tsconv_pool_forward_tiled(x: torch.Tensor, w_tilde: torch.Tensor,
                              stride: int = 5) -> torch.Tensor:
    """The forward the way ``csrc/tsconv_fwd.cu`` runs it in bfloat16, tile
    by tile, in plain PyTorch: rows in tiles of ROW_TILE (a short last tile
    zero-filled), x transposed per tile (``xT[t][r]``) with zero rows past
    T, the taps padded to a multiple of 16 with zero rows of w̃, and per
    position one product of the window ``xT[p·s : p·s + taps16]ᵀ`` with the
    padded w̃; operands in x's dtype, fp32 sums, one rounding to x's dtype.
    Returns (B, C, P, F) in x's dtype, as the kernel does."""
    b, c, t = x.shape
    m, f = w_tilde.shape
    rows = b * c
    n_pos = out_positions(t, m, stride)
    taps16 = -(-m // 16) * 16
    w_pad = torch.zeros((taps16, f), dtype=torch.float32, device=x.device)
    w_pad[:m] = w_tilde.to(x.dtype).float()
    x2 = x.reshape(rows, t).float()
    x_t = torch.zeros((max(t, (n_pos - 1) * stride + taps16), ROW_TILE),
                      dtype=torch.float32, device=x.device)
    out = torch.empty((rows, n_pos * f), dtype=x.dtype, device=x.device)
    for r0 in range(0, rows, ROW_TILE):
        nr = min(ROW_TILE, rows - r0)
        x_t.zero_()
        x_t[:t, :nr] = x2[r0:r0 + nr].T
        for p in range(n_pos):
            window = x_t[p * stride:p * stride + taps16].T     # (32, taps16)
            out[r0:r0 + nr, p * f:(p + 1) * f] = (window @ w_pad)[:nr].to(
                x.dtype)
    return out.reshape(b, c, n_pos, f)


def pad_filters(f: int) -> int:
    """F rounded up to a multiple of 8: one 8-column group of the g row in
    shared memory then lies inside one position."""
    return -(-f // 8) * 8


def padded_taps(w_tilde: torch.Tensor, stride: int) -> torch.Tensor:
    """The kernel's tap table: (TAP_PAD·s + M + TAP_PAD·s, Fp), w̃ between
    zero rows, the filters F..Fp zero. Row ``TAP_PAD·s + tap`` answers every
    tap a dx step can ask for, inside [0, M) or not."""
    m, f = w_tilde.shape
    pad = TAP_PAD * stride
    table = torch.zeros((m + 2 * pad, pad_filters(f)), dtype=w_tilde.dtype,
                        device=w_tilde.device)
    table[pad:pad + m, :f] = w_tilde
    return table


def band_operand(w_tilde: torch.Tensor, stride: int, q0: int, k_lo: int,
                 k_hi: int) -> torch.Tensor:
    """The B operand of the banded dx product: E (k_hi − k_lo, Q_TILE·s) with
    ``E[k, n] = w̃[t − p·s, f]`` for the g-row column ``k_lo + k = p·Fp + f``
    and the sample ``t = q0·s + n``, 0 where the tap lies outside [0, M),
    read from :func:`padded_taps` as the kernel reads it. It depends on
    ``t − p·s`` only: shifting q0 by Q_TILE and the columns by Q_TILE·Fp
    gives the same operand."""
    f_pad = pad_filters(w_tilde.shape[1])
    table = padded_taps(w_tilde, stride)
    cols = torch.arange(k_lo, k_hi, device=w_tilde.device)
    pos, filt = cols // f_pad, cols % f_pad
    t = q0 * stride + torch.arange(Q_TILE * stride, device=w_tilde.device)
    row = TAP_PAD * stride + t[None, :] - pos[:, None] * stride
    if row.numel() and not (0 <= int(row.min())
                            and int(row.max()) < table.shape[0]):
        raise ValueError("a dx step reaches past the padded tap table")
    return table[row, filt[:, None]]


def tsconv_pool_backward_tiled(x: torch.Tensor, w_tilde: torch.Tensor,
                               g: torch.Tensor, stride: int = 5
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward the way ``csrc/tsconv_bwd.cu`` runs it in bfloat16, tile
    by tile, in plain PyTorch: rows in tiles of ROW_TILE (a short last tile
    zero-filled); g with F padded to Fp; dx per q-tile as one banded product
    of the g columns of the positions that cover it (clamped to [0, P),
    widened to multiples of 16 columns) with :func:`band_operand`; dw̃ per
    position from the window of x with the taps padded to a multiple of 16,
    the rows past M dropped. Operands in x's dtype, fp32 sums. Returns dx in
    x's dtype and dw̃ in fp32, as the kernel does."""
    b, c, t = x.shape
    m, f = w_tilde.shape
    rows, n_pos = b * c, g.shape[2]
    f_pad = pad_filters(f)
    depth = -(-m // stride)                       # positions covering one t
    taps16 = -(-m // 16) * 16
    g_cols = -(-n_pos * f_pad // 16) * 16
    w_dt = w_tilde.to(x.dtype)
    g_row = torch.zeros((rows, g_cols), dtype=torch.float32, device=x.device)
    g_row[:, :n_pos * f_pad].view(rows, n_pos, f_pad)[..., :f] = (
        g.to(x.dtype).reshape(rows, n_pos, f).float())
    x_row = torch.zeros((rows, max(t, (n_pos - 1) * stride + taps16)),
                        dtype=torch.float32, device=x.device)
    x_row[:, :t] = x.reshape(rows, t).float()
    dx = torch.zeros((rows, t), dtype=torch.float32, device=x.device)
    dw = torch.zeros((taps16, f_pad), dtype=torch.float32, device=x.device)
    n_q_tiles = -(-(-(-t // stride)) // Q_TILE)
    for r0 in range(0, rows, ROW_TILE):
        g_t, x_t = g_row[r0:r0 + ROW_TILE], x_row[r0:r0 + ROW_TILE]
        for p in range(n_pos):
            window = x_t[:, p * stride:p * stride + taps16]
            dw += window.T @ g_t[:, p * f_pad:(p + 1) * f_pad]
        for q0 in range(0, n_q_tiles * Q_TILE, Q_TILE):
            p_lo, p_hi = max(q0 - (depth - 1), 0), min(q0 + Q_TILE - 1,
                                                       n_pos - 1)
            if p_lo > p_hi:
                continue                          # dx stays 0 there
            k_lo = p_lo * f_pad // 16 * 16
            k_hi = min(-(-(p_hi + 1) * f_pad // 16) * 16, g_cols)
            band = band_operand(w_dt, stride, q0, k_lo, k_hi).float()
            tile = g_t[:, k_lo:k_hi] @ band
            t0 = q0 * stride
            width = min(Q_TILE * stride, t - t0)
            dx[r0:r0 + ROW_TILE, t0:t0 + width] = tile[:, :width]
    return dx.to(x.dtype).reshape(b, c, t), dw[:m, :f]


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
    lib = _build.lib()
    code = _build.DTYPE_CODES[x.dtype]
    if not lib.eid_tsconv_fwd_takes(code, b * c, t, m, f, n_pos, stride):
        raise ValueError(
            f"tsconv_fwd ({forward_design(x.dtype)}): shape not taken: T {t}, "
            f"{m} taps, {f} filters, stride {stride} (bfloat16 takes stride "
            "<= 8, T <= 256, taps <= 80, filters <= 40, and two 32-row "
            "output tiles within the card's shared memory)")
    out = torch.empty((b, c, n_pos, f), dtype=x.dtype, device=x.device)
    rc = lib.eid_tsconv_fwd(
        code, x.data_ptr(), w_tilde.data_ptr(), out.data_ptr(), b * c, t, m,
        f, n_pos, stride, _build.stream_of(x))
    _build.check(rc, "tsconv_fwd")
    _build.LAUNCHES["tsconv_fwd"] += 1
    return out


def forward_design(dtype: torch.dtype) -> str:
    """The design the forward launcher takes for ``dtype``: ``"mma_bf16"``
    (tensor cores) or ``"fma_fp32"`` (full-fp32 FMA products)."""
    return _build.lib().eid_tsconv_fwd_design(
        _build.DTYPE_CODES[dtype]).decode()


def backward_design(dtype: torch.dtype) -> str:
    """The design the backward launcher takes for ``dtype``: ``"mma_bf16"``
    (tensor cores) or ``"fma_fp32"`` (full-fp32 FMA products)."""
    return _build.lib().eid_tsconv_bwd_design(
        _build.DTYPE_CODES[dtype]).decode()


def _backward(x: torch.Tensor, w_tilde: torch.Tensor, g: torch.Tensor,
              stride: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw̃): dx fp32 from the plain version, in x's dtype from the
    kernel (the value ``dx.to(x.dtype)`` of the fp32 sums); dw̃ fp32."""
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
    code = _build.DTYPE_CODES[x.dtype]
    ws_bytes = lib.eid_tsconv_bwd_workspace(code, b * c, t, m, f, n_pos,
                                            stride)
    if ws_bytes < 0:
        raise ValueError(
            f"tsconv_bwd ({backward_design(x.dtype)}): shape not taken: T {t}, "
            f"{m} taps, {f} filters, stride {stride} (stride <= 8; bfloat16 "
            "also needs T <= 256, taps <= 80, filters <= 40)")
    ws = torch.empty(max(ws_bytes, 1), dtype=torch.uint8, device=x.device)
    # dx leaves the kernel in x's dtype, rounded once from the fp32 sums
    dx = torch.empty_like(x)
    dw = torch.empty((m, f), dtype=torch.float32, device=x.device)
    rc = lib.eid_tsconv_bwd(
        code, x.data_ptr(), g.data_ptr(),
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
