"""The host-side arithmetic of the two tensor-core forward kernels.

``csrc/tsconv_fwd.cu`` computes stage 1 per 32-row tile from x staged
transposed, one product per position against w̃ with the taps padded to a
multiple of 16; ``csrc/projection_fwd.cu`` runs the head as three launches
(a and gdt, then r, then a LayerNorm row pass). The same arithmetic in plain
PyTorch (``tsconv_pool_forward_tiled``, ``projection_head_forward_chain``)
is held here, on the CPU, against the plain versions the wrappers run
(``tsconv_pool_reference``, ``projection_head_reference``) and against the
JAX package's Pallas kernels in interpret mode, on numpy inputs from a seed.

Tolerances:
- float32: 1e-5 relative (the sides differ in summation order only);
- bfloat16 tsconv: 2^-6 of the largest output (one rounding to bf16 of fp32
  sums of exact products: two ulps at most where a sum lands on the other
  side of a rounding boundary);
- bfloat16 head: 4e-3 absolute, or 8e-3 with a mask (only g is rounded to
  bf16 and the output is fp32; a kept z is doubled), as ``chip_smoke.py``
  phase 2 holds the kernels.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_image_decode_tpu.ops import projection as jax_projection
from eeg_image_decode_tpu.ops import tsconv as jax_tsconv
from eeg_image_decode_tpu_torch.ops.projection import (
    projection_head_forward_chain,
    projection_head_reference,
)
from eeg_image_decode_tpu_torch.ops.tsconv import (
    fold_pool_into_kernel,
    out_positions,
    tsconv_pool_forward_tiled,
    tsconv_pool_reference,
)
from torch_port_case import projection_params
from torch_port_case import two_threads  # noqa: F401 (autouse)

DTYPES = [torch.float32, torch.bfloat16]
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
TSCONV_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
# the shapes of tests/test_torch_tsconv_band.py: (B, C, T, conv taps,
# filters, pool, stride)
TSCONV_SHAPES = {
    "small_ragged": (3, 8, 100, 9, 6, 16, 4),
    "atms_width": (2, 63, 250, 25, 40, 51, 5),
    "t_not_multiple_of_stride": (1, 5, 253, 25, 40, 51, 5),
    "one_position": (1, 7, 77, 25, 40, 51, 5),
    "rows_not_multiple_of_tile": (1, 37, 250, 25, 40, 51, 5),
}


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(TSCONV_SHAPES), ids=list(TSCONV_SHAPES))
def test_tiled_tsconv_forward_matches_plain_and_jax(shape, dtype):
    b, c, t, k, f, pool, stride = TSCONV_SHAPES[shape]
    rng = np.random.default_rng(50)
    x = rng.normal(size=(b, c, t)).astype(np.float32)
    w = (rng.normal(size=(k, f)) / np.sqrt(k)).astype(np.float32)
    w_tilde = fold_pool_into_kernel(torch.from_numpy(w), pool)
    n_pos = out_positions(t, w_tilde.shape[0], stride)

    xt = torch.from_numpy(x).to(dtype)
    wt = w_tilde.to(dtype)
    got = tsconv_pool_forward_tiled(xt, wt, stride)
    assert got.dtype == dtype and got.shape == (b, c, n_pos, f)
    tol = TSCONV_TOL[dtype]
    assert _rel(got.float(), tsconv_pool_reference(xt, wt, stride).float()) \
        <= tol

    run = jax.jit(lambda a, ww: jax_tsconv.tsconv_pool_fused(
        a, ww, stride, True))
    jdt = JNP[dtype]
    want = run(jnp.asarray(x).astype(jdt), jnp.asarray(wt.float().numpy())
               .astype(jdt))
    assert _rel(got.float(), np.asarray(want.astype(jnp.float32))) <= tol


# (B, d_in, d_out): no multiple of the 64-row tile, the JAX kernel's
# 256-row tile, or 16 bytes of width; and the full ATM-S head at B 5
HEAD_SHAPES = [(5, 48, 32), (37, 48, 32), (5, 1440, 1024)]
HEAD_TOL = {(torch.float32, False): 1e-5, (torch.float32, True): 1e-5,
            (torch.bfloat16, False): 4e-3, (torch.bfloat16, True): 8e-3}


@pytest.mark.parametrize("masked", [False, True], ids=["none", "mask"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b,d_in,d_out", HEAD_SHAPES)
def test_forward_chain_matches_plain_and_jax(b, d_in, d_out, dtype, masked):
    rng = np.random.default_rng(51)
    x = rng.normal(size=(b, d_in)).astype(np.float32)
    params = projection_params(rng, d_in, d_out)
    mask = (((rng.random((b, d_out)) >= 0.5) / 0.5).astype(np.float32)
            if masked else None)

    xt = torch.from_numpy(x).to(dtype)
    # the parameters in x's dtype, as the wrapper hands them to the kernels
    pt = {k: torch.from_numpy(v).to(dtype) for k, v in params.items()}
    # mask mode hands the kernels the mask in x's dtype
    mt = None if mask is None else torch.from_numpy(mask).to(dtype)
    got = projection_head_forward_chain(xt, pt, mt)
    assert got.dtype == torch.float32 and got.shape == (b, d_out)
    tol = HEAD_TOL[(dtype, masked)]

    def err(want):  # bf16: absolute; fp32: relative to the largest output
        want = np.asarray(want, np.float32)
        d = float(np.abs(got.numpy() - want).max())
        return d if dtype == torch.bfloat16 else d / np.abs(want).max()

    assert err(projection_head_reference(xt, pt, mt).numpy()) <= tol

    jdt = JNP[dtype]
    pj = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    mj = None if mask is None else jnp.asarray(mask, jdt)
    run = jax.jit(lambda a, pp: jax_projection.fused_projection_head(
        a, pp, mj, 0.0, True))
    assert err(run(jnp.asarray(x, jdt), pj)) <= tol
