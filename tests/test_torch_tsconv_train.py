"""The tsconv stage-1 backward against the JAX package.

The plain backward (``tsconv_pool_backward_reference``, which the CUDA
kernel is held to on the card) against the JAX backward kernel in Pallas
interpret mode and against ``jax.vjp`` of the JAX reference; the
``autograd.Function`` on the CPU against autograd of the plain forward, down
to the 25-tap kernel through ``fold_pool_into_kernel``. Tolerance: fp32,
atol = rtol = 1e-4 (summation order only).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_image_decode_tpu.ops import tsconv as jax_tsconv
from eeg_image_decode_tpu_torch.ops.tsconv import (
    fold_pool_into_kernel,
    out_positions,
    tsconv_pool_backward_reference,
    tsconv_pool_fused,
    tsconv_pool_reference,
)
from torch_port_case import two_threads  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
# (B, C, T, taps, filters, pool, stride): a small case and ATM-S's stage 1
SHAPES = [(2, 8, 100, 9, 6, 16, 4), (1, 3, 250, 25, 40, 51, 5)]


def _case(seed, b, c, t, k, f, pool, stride):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, c, t)).astype(np.float32)
    w = (rng.normal(size=(k, f)) / np.sqrt(k)).astype(np.float32)
    w_tilde = np.array(jax_tsconv.fold_pool_into_kernel(jnp.asarray(w),
                                                         pool))
    n_pos = out_positions(t, w_tilde.shape[0], stride)
    g = rng.normal(size=(b, c, n_pos, f)).astype(np.float32)
    return x, w, w_tilde, g, n_pos


@pytest.mark.parametrize("b,c,t,k,f,pool,stride", SHAPES)
def test_plain_backward_matches_jax(b, c, t, k, f, pool, stride):
    x, _, w_tilde, g, n_pos = _case(30, b, c, t, k, f, pool, stride)
    dx_k, dw_k = jax_tsconv._tsconv_bwd_pallas(
        jnp.asarray(x.reshape(b * c, t)), jnp.asarray(g.reshape(b * c, -1)),
        jnp.asarray(w_tilde), stride, n_pos, True)
    _, vjp = jax.vjp(
        lambda xx, ww: jax_tsconv.tsconv_pool_reference(xx, ww, stride),
        jnp.asarray(x), jnp.asarray(w_tilde))
    dx_v, dw_v = vjp(jnp.asarray(g))
    dx, dw = tsconv_pool_backward_reference(
        torch.from_numpy(x), torch.from_numpy(w_tilde), torch.from_numpy(g),
        stride)
    assert dx.dtype == dw.dtype == torch.float32
    for want_dx, want_dw in ((np.asarray(dx_k).reshape(b, c, t), dw_k),
                             (dx_v, dw_v)):
        np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **TOL)
        np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), **TOL)


@pytest.mark.parametrize("b,c,t,k,f,pool,stride", SHAPES)
def test_autograd_function_matches_autograd_of_plain_forward(
        b, c, t, k, f, pool, stride):
    """Gradients reach x and the 25-tap kernel w, through the fold."""
    x, w, _, g, _ = _case(31, b, c, t, k, f, pool, stride)

    def grads(op):
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        out = op(xt, fold_pool_into_kernel(wt, pool), stride)
        return torch.autograd.grad(out, [xt, wt], torch.from_numpy(g))

    for a, b_ in zip(grads(tsconv_pool_fused), grads(tsconv_pool_reference)):
        torch.testing.assert_close(a, b_, **TOL)
