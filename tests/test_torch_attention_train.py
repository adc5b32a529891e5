"""The attention layer's training ops against the JAX package.

- The mask-mode forward against the JAX kernel (Pallas interpret mode).
- The plain backward (``attention_layer_backward_reference``, which the
  CUDA backward kernel is held to on the card) against the JAX backward
  kernel in interpret mode and against ``jax.vjp`` of the JAX reference.
- The ``autograd.Function`` on the CPU against autograd of the plain
  forward, in all three dropout modes.
- The Philox generator of the seed mode: Random123's known-answer vectors,
  the keep rate, and the purity of each mask element.

Tolerance: fp32, JAX at 'highest' matmul precision (conftest.py), atol =
rtol = 1e-4 per op: the two sides differ in fp32 summation order only.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_image_decode_tpu.ops import attention as jax_attention
from eeg_image_decode_tpu_torch.ops.attention import (
    MASK_ORDER,
    PARAM_ORDER,
    attention_layer_backward_reference,
    attention_layer_reference,
    draw_keep_masks,
    fused_attention_layer,
    keep_rule,
    philox4x32_10,
)
from torch_port_case import attention_params, keep_masks
from torch_port_case import two_threads  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
B, L = 3, 9
# (d_model, heads, d_ff): the second truncates the heads like ATM-S's
# 250 → 4 × 62 = 248
SHAPES = [(32, 4, 64), (30, 4, 40)]


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _case(seed, d, heads, ff):
    rng = np.random.default_rng(seed)
    inner = (d // heads) * heads
    x = rng.normal(size=(B, L, d)).astype(np.float32)
    params = attention_params(rng, d, inner, ff)
    masks = keep_masks(rng, B, heads, L, d, ff)
    g = rng.normal(size=(B, L, d)).astype(np.float32)
    return x, params, masks, g


@pytest.mark.parametrize("d,heads,ff", SHAPES)
def test_mask_mode_forward_matches_jax_kernel(d, heads, ff):
    x, params, masks, _ = _case(20, d, heads, ff)
    want = np.asarray(jax_attention.fused_attention_layer(
        jnp.asarray(x), _j(params), _j(masks), heads, True))
    with torch.no_grad():
        got = fused_attention_layer(torch.from_numpy(x), _t(params), heads,
                                    masks=_t(masks))
        plain = attention_layer_reference(torch.from_numpy(x), _t(params),
                                          heads, masks=_t(masks))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)


@pytest.mark.parametrize("with_masks", [False, True],
                         ids=["no_dropout", "masks"])
@pytest.mark.parametrize("d,heads,ff", SHAPES)
def test_plain_backward_matches_jax(d, heads, ff, with_masks):
    """dx and all 16 gradients against the JAX backward kernel (interpret)
    and against jax.vjp of the JAX reference forward."""
    x, params, masks, g = _case(21, d, heads, ff)
    m = masks if with_masks else None
    dx_k, gp_k = jax_attention._attention_pallas_bwd(
        jnp.asarray(x), _j(params), _j(m) if m else None, jnp.asarray(g),
        heads, True)
    _, vjp = jax.vjp(
        lambda xx, pp: jax_attention.attention_layer_reference(
            xx, pp, _j(m) if m else None, n_heads=heads),
        jnp.asarray(x), _j(params))
    dx_v, gp_v = vjp(jnp.asarray(g))
    dx, grads = attention_layer_backward_reference(
        torch.from_numpy(x), _t(params), torch.from_numpy(g), heads,
        masks=_t(m) if m else None)
    for want_dx, want_g in ((dx_k, gp_k), (dx_v, gp_v)):
        np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **TOL)
        for k in PARAM_ORDER:
            np.testing.assert_allclose(grads[k].numpy(),
                                       np.asarray(want_g[k]), **TOL,
                                       err_msg=k)


@pytest.mark.parametrize("mode", ["none", "masks", "seed"])
def test_autograd_function_matches_autograd_of_plain_forward(mode):
    """On the CPU the Function's forward is the plain layer and its backward
    the plain backward: together they equal autograd through the plain
    forward, with the same masks."""
    d, heads, ff = SHAPES[1]
    x, params, masks, g = _case(22, d, heads, ff)
    kw, plain_masks = {}, None
    if mode == "masks":
        kw = {"masks": _t(masks)}
        plain_masks = _t(masks)
    elif mode == "seed":
        kw = {"dropout_p": 0.25, "seed": 1234}
        plain_masks = draw_keep_masks(1234, B, heads, L, d, ff, 0.25)

    def grads(fn):
        xt = torch.from_numpy(x).requires_grad_()
        pt = {k: v.requires_grad_() for k, v in _t(params).items()}
        out = fn(xt, pt)
        gr = torch.autograd.grad(out, [xt, *[pt[k] for k in PARAM_ORDER]],
                                 torch.from_numpy(g))
        return out.detach(), gr

    out_f, g_f = grads(lambda xt, pt: fused_attention_layer(xt, pt, heads,
                                                            **kw))
    out_p, g_p = grads(lambda xt, pt: attention_layer_reference(
        xt, pt, heads, masks=plain_masks))
    torch.testing.assert_close(out_f, out_p, rtol=0, atol=0)
    for name, a, b in zip(("x",) + PARAM_ORDER, g_f, g_p):
        torch.testing.assert_close(a, b, **TOL, msg=name)


def test_philox_matches_random123_known_answers():
    """Philox-4x32-10 known-answer vectors of Random123 (kat_vectors)."""
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
        got = tuple(int(w) for w in philox4x32_10(c, key))
        assert got == want


def test_keep_rule_and_rate():
    """The JAX kernel's threshold and kept value; 75% kept at p = 0.25
    over one ATM-S-sized sample set (±0.005, > 10 standard deviations)."""
    thresh, value = keep_rule(0.25)
    assert thresh == int(np.uint32(int(0.75 * 0xFFFFFFFF)))
    assert value == float(np.float32(1.0 / 0.75))
    masks = draw_keep_masks(7, 16, 4, 64, 250, 256, 0.25)
    for k in MASK_ORDER:
        vals = torch.unique(masks[k])
        assert set(vals.tolist()) <= {0.0, value}
        assert abs(float((masks[k] > 0).float().mean()) - 0.75) < 0.005, k


def test_masks_are_pure_functions_of_seed_sample_site_element():
    """The masks of samples 0..B equal those drawn for any sub-range on its
    own; another seed or sample draws other masks; and the forward and the
    backward of the seed mode use exactly the masks ``draw_keep_masks``
    gives (CPU: the plain versions fed those masks)."""
    d, heads, ff = SHAPES[0]
    full = draw_keep_masks(5, 6, heads, L, d, ff, 0.25)
    for lo, hi in ((0, 2), (2, 5), (5, 6)):
        part = draw_keep_masks(5, hi - lo, heads, L, d, ff, 0.25, row0=lo)
        for k in MASK_ORDER:
            torch.testing.assert_close(part[k], full[k][lo:hi], rtol=0, atol=0)
    other = draw_keep_masks(6, 6, heads, L, d, ff, 0.25)
    assert not torch.equal(other["m_res"], full["m_res"])
    assert not torch.equal(full["m_res"][0], full["m_res"][1])

    x, params, _, g = _case(23, d, heads, ff)
    masks = draw_keep_masks(77, B, heads, L, d, ff, 0.25)
    xt = torch.from_numpy(x).requires_grad_()
    pt = {k: v.requires_grad_() for k, v in _t(params).items()}
    out = fused_attention_layer(xt, pt, heads, dropout_p=0.25, seed=77)
    want = attention_layer_reference(xt.detach(), _t(params), heads,
                                     masks=masks)
    torch.testing.assert_close(out.detach(), want, rtol=0, atol=0)
    got = torch.autograd.grad(out, [xt, *[pt[k] for k in PARAM_ORDER]],
                              torch.from_numpy(g))
    dx, grads = attention_layer_backward_reference(
        torch.from_numpy(x), _t(params), torch.from_numpy(g), heads,
        masks=masks)
    torch.testing.assert_close(got[0], dx, rtol=0, atol=0)
    for k, a in zip(PARAM_ORDER, got[1:]):
        torch.testing.assert_close(a, grads[k], rtol=0, atol=0, msg=k)
