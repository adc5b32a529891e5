"""The host-side index math of the tensor-core tsconv backward.

``csrc/tsconv_bwd.cu`` computes dx as a banded product per q-tile against an
operand it reads from a zero-padded tap table, and dw̃ per position from
windows of x with the taps padded to a multiple of 16. The same tiling in
plain PyTorch (``tsconv_pool_backward_tiled`` with ``band_operand`` and
``padded_taps``) is held here, on the CPU, against the plain backward
(``tsconv_pool_backward_reference``, the kernel's specification) and against
the JAX package's backward kernel in Pallas interpret mode, on numpy inputs
from a seed. Tolerance, as a share of each output's largest value: float32
1e-5 (summation order only); bfloat16 3e-2 (dx is rounded once to bf16 from
fp32 sums of exact products, 2^-9 relative at most; dw̃ stays fp32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_image_decode_tpu.ops import tsconv as jax_tsconv
from eeg_image_decode_tpu_torch.ops.tsconv import (
    Q_TILE,
    TAP_PAD,
    band_operand,
    fold_pool_into_kernel,
    out_positions,
    pad_filters,
    padded_taps,
    tsconv_pool_backward_reference,
    tsconv_pool_backward_tiled,
)
from torch_port_case import two_threads  # noqa: F401 (autouse)

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# (B, C, T, conv taps, filters, pool, stride)
SHAPES = {
    "small_ragged": (3, 8, 100, 9, 6, 16, 4),
    "atms_width": (2, 63, 250, 25, 40, 51, 5),
    "t_not_multiple_of_stride": (1, 5, 253, 25, 40, 51, 5),
    "one_position": (1, 7, 77, 25, 40, 51, 5),
    "rows_not_multiple_of_tile": (1, 37, 250, 25, 40, 51, 5),
}


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_tiled_backward_matches_plain_and_jax(shape, dtype):
    b, c, t, k, f, pool, stride = SHAPES[shape]
    rng = np.random.default_rng(40)
    x = rng.normal(size=(b, c, t)).astype(np.float32)
    w = (rng.normal(size=(k, f)) / np.sqrt(k)).astype(np.float32)
    w_tilde = fold_pool_into_kernel(torch.from_numpy(w), pool)
    m = w_tilde.shape[0]
    n_pos = out_positions(t, m, stride)
    g = rng.normal(size=(b, c, n_pos, f)).astype(np.float32)

    xt = torch.from_numpy(x).to(dtype)
    wt = w_tilde.to(dtype)
    gt = torch.from_numpy(g).to(dtype)
    dx, dw = tsconv_pool_backward_tiled(xt, wt, gt, stride)
    assert dx.dtype == dtype and dw.dtype == torch.float32
    assert dx.shape == (b, c, t) and dw.shape == (m, f)
    # samples past the last window get no gradient
    assert not dx[..., (n_pos - 1) * stride + m:].any()

    dx_p, dw_p = tsconv_pool_backward_reference(xt, wt, gt, stride)
    tol = TOL[dtype]
    assert _rel(dx.float(), dx_p.to(dtype).float()) <= tol
    assert _rel(dw, dw_p) <= tol

    bwd = jax.jit(jax_tsconv._tsconv_bwd_pallas, static_argnums=(3, 4, 5))
    jdt = JNP[dtype]
    dx_j, dw_j = bwd(jnp.asarray(x.reshape(b * c, t)).astype(jdt),
                     jnp.asarray(g.reshape(b * c, -1)).astype(jdt),
                     jnp.asarray(w_tilde.numpy()).astype(jdt), stride, n_pos,
                     True)
    dx_j = np.asarray(dx_j.astype(jdt).astype(jnp.float32)).reshape(b, c, t)
    assert _rel(dx.float(), dx_j) <= tol
    assert _rel(dw, np.asarray(dw_j)) <= tol


@pytest.mark.parametrize("f,stride,m", [(40, 5, 75), (6, 4, 24)])
def test_band_operand_is_shift_invariant_and_banded(f, stride, m):
    rng = np.random.default_rng(41)
    w = torch.from_numpy(rng.normal(size=(m, f)).astype(np.float32))
    f_pad = pad_filters(f)
    depth = -(-m // stride)
    # the columns a q-tile at q0 = 2 Q_TILE reads: its covering positions,
    # widened to multiples of 16 as the kernel widens them
    k_lo = (2 * Q_TILE - (depth - 1)) * f_pad // 16 * 16
    k_hi = -(-(3 * Q_TILE) * f_pad // 16) * 16
    first = band_operand(w, stride, 2 * Q_TILE, k_lo, k_hi)
    later = band_operand(w, stride, 3 * Q_TILE, k_lo + Q_TILE * f_pad,
                         k_hi + Q_TILE * f_pad)
    assert torch.equal(first, later)
    # element by element against the definition
    table = padded_taps(w, stride)
    assert table.shape == (m + 2 * TAP_PAD * stride, f_pad)
    for k in range(0, k_hi - k_lo, 7):
        p, ff = divmod(k_lo + k, f_pad)
        for n in range(0, Q_TILE * stride, 3):
            tap = 2 * Q_TILE * stride + n - p * stride
            want = w[tap, ff] if 0 <= tap < m and ff < f else 0.0
            assert first[k, n] == want
