"""The tiling and index math of the tensor-core attention backward.

``csrc/attention_bwd.cu`` (design ``mma_bf16``) runs each sample as one
64-row tile over operands zero-padded to multiples of 64 (each head's 62
columns padded to 64), splits the softmax backward into a query pass and a
key pass that rebuilds the transposed probabilities from the query pass's
row statistics, and sums its dW products over 32 split-K row chunks in
order. The same tiling in plain PyTorch (``attention_layer_backward_tiled``
with ``pack_attention_params`` and ``padded_dims``) is held here, on the
CPU, against the plain backward (``attention_layer_backward_reference``, the
kernel's specification) and against the JAX package's backward kernel in
Pallas interpret mode, on numpy inputs from a seed, at a small ragged shape
(D 32, 4 heads of 8, FF 64, L 9) and at ATM-S's widths (D 250, 4 heads of
62, FF 256, L 64), batch 2.

Tolerance, as a share of each output's largest value (the three QKV bias
gradients share the largest of their scales: the key bias's gradient is
rounding noise around zero): float32 1e-4 (summation order only); bfloat16
5e-2 against JAX, as the card tests hold the kernel (an fp32 sum that lands
on the other side of a bf16 rounding boundary moves an intermediate by
2^-8, which the LayerNorm and softmax backward spread), and 1e-2 against
the plain backward, which rounds at the same points.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_image_decode_tpu.ops import attention as jax_attention
from eeg_image_decode_tpu_torch.ops.attention import (
    PARAM_ORDER,
    attention_layer_backward_reference,
    attention_layer_backward_tiled,
    pack_attention_params,
    padded_dims,
)
from torch_port_case import attention_params, keep_masks
from torch_port_case import two_threads  # noqa: F401 (autouse)

TOL_JAX = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
TOL_PLAIN = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# (d_model, heads, d_ff, L)
SHAPES = {"small_ragged": (32, 4, 64, 9), "atms_width": (250, 4, 256, 64)}
B = 2


def _scaled_errors(got_dx, got, want_dx, want):
    def scale(k):
        if k in ("bq", "bk", "bv"):
            return max(np.abs(want[b]).max() for b in ("bq", "bk", "bv"))
        return np.abs(want[k]).max()

    out = {"x": np.abs(got_dx - want_dx).max() / np.abs(want_dx).max()}
    for k in PARAM_ORDER:
        out[k] = np.abs(got[k] - want[k]).max() / max(scale(k), 1e-30)
    return out


def _np(t):
    return np.asarray(t, np.float32) if not torch.is_tensor(t) \
        else t.float().numpy()


@pytest.mark.parametrize("with_masks", [False, True],
                         ids=["no_dropout", "masks"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_tiled_backward_matches_plain_and_jax(shape, dtype, with_masks):
    d, heads, ff, length = SHAPES[shape]
    rng = np.random.default_rng(50)
    inner = (d // heads) * heads
    x = rng.normal(size=(B, length, d)).astype(np.float32)
    g = rng.normal(size=(B, length, d)).astype(np.float32)
    params = attention_params(rng, d, inner, ff)
    masks = keep_masks(rng, B, heads, length, d, ff) if with_masks else None

    def t(a):
        return torch.from_numpy(a).to(dtype)

    tp = {k: t(v) for k, v in params.items()}
    tm = {k: t(v) for k, v in masks.items()} if masks else None
    dx, grads = attention_layer_backward_tiled(t(x), tp, t(g), heads,
                                               masks=tm)
    assert dx.dtype == dtype and dx.shape == (B, length, d)
    dx_p, grads_p = attention_layer_backward_reference(t(x), tp, t(g), heads,
                                                       masks=tm)

    jt = JNP[dtype]
    jbwd = jax.jit(partial(jax_attention._attention_pallas_bwd,
                           n_heads=heads, interpret=True))
    dx_j, grads_j = jbwd(
        jnp.asarray(x, jt), {k: jnp.asarray(v, jt) for k, v in params.items()},
        {k: jnp.asarray(v, jt) for k, v in masks.items()} if masks else None,
        jnp.asarray(g, jt))

    got = {k: _np(v) for k, v in grads.items()}
    for want_dx, want, tol in (
            (_np(dx_p), {k: _np(v) for k, v in grads_p.items()},
             TOL_PLAIN[dtype]),
            (_np(dx_j), {k: _np(v) for k, v in grads_j.items()},
             TOL_JAX[dtype])):
        errs = _scaled_errors(_np(dx), got, want_dx, want)
        assert max(errs.values()) <= tol, errs


def test_padded_dims_and_packed_layout():
    """ATM-S pads to 256 / 4 × 64 / 256; the small shape's 4 heads of 8 to
    4 × 16; L > 64 or a padded width above 256 is refused. In the packed
    weights each head's columns start at h · hdp, and every padding entry
    is zero."""
    assert padded_dims(64, 250, 248, 256, 4) == {
        "hd": 62, "hdp": 64, "Dp": 256, "FFp": 256, "innerp": 256}
    assert padded_dims(9, 32, 32, 64, 4) == {
        "hd": 8, "hdp": 16, "Dp": 64, "FFp": 64, "innerp": 64}
    assert padded_dims(9, 30, 30, 40, 3)["innerp"] % 64 == 0
    assert padded_dims(65, 250, 248, 256, 4) is None
    assert padded_dims(64, 300, 248, 256, 4) is None

    rng = np.random.default_rng(51)
    p = {k: torch.from_numpy(v)
         for k, v in attention_params(rng, 250, 248, 256).items()}
    pk = pack_attention_params(p, 4, 64)
    assert pk["wqkv"].shape == (256, 768) and pk["wo"].shape == (256, 256)
    assert pk["w1"].shape == (256, 256) and pk["w2"].shape == (256, 256)
    for m, name in enumerate(("wq", "wk", "wv")):
        for h in range(4):
            block = pk["wqkv"][:, m * 256 + h * 64:m * 256 + (h + 1) * 64]
            assert torch.equal(block[:250, :62],
                               p[name][:, h * 62:(h + 1) * 62])
            assert not block[:, 62:].any() and not block[250:].any()
        bias = pk["bqkv"][m * 256:(m + 1) * 256].reshape(4, 64)
        assert torch.equal(bias[:, :62], p["b" + name[1]].reshape(4, 62))
        assert not bias[:, 62:].any()
    wo = pk["wo"].reshape(4, 64, 256)
    assert torch.equal(wo[:, :62, :250], p["wo"].reshape(4, 62, 250))
    assert not wo[:, 62:].any() and not wo[..., 250:].any()
    assert not pk["w2"][:, 250:].any() and not pk["ln1_s"][250:].any()
