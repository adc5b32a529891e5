"""The projection head's training op against the JAX package, on the CPU.

- ``fused_projection_head`` (forward, and dx with the six parameter
  gradients through autograd) against the JAX op in Pallas interpret mode
  and its ``jax.vjp``: without a mask and with an explicit one (p = 0.25, so
  the kept value 4/3 is not a bf16 number), at a batch that is no multiple
  of the JAX kernel's 256-row tile, in fp32 and bf16.
- ``ProjectionHead(fused=True)`` against the JAX module: eval mode, train
  mode with a pinned mask (both take the exact-erf chain), and the seed
  mode's keep rate and forward/backward mask identity.

Tolerances. fp32: atol = rtol = 1e-5, the two sides differ in fp32 summation
order only (the parameter gradients sum over the batch, so at 260 rows
their atol scales with batch / 16). bf16: both round at the same places, so
they differ where an fp32 sum lands on the other side of a bf16 rounding
boundary (2^-8 relative) of g, d_z or d_a; the fp32 output is held to 2e-2
absolute, dx and the parameter gradients (rounded to bf16 on both sides) to
3e-2 of each one's largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_image_decode_tpu.models.layers import ProjectionHead as JaxHead
from eeg_image_decode_tpu.ops import projection as jax_projection
from eeg_image_decode_tpu_torch.models.layers import ProjectionHead
from eeg_image_decode_tpu_torch.ops.projection import (
    PARAM_ORDER,
    draw_keep_mask,
    fused_projection_head,
    projection_head_backward_reference,
    projection_head_reference,
)
from torch_port_case import projection_params
from torch_port_case import two_threads  # noqa: F401 (autouse)

D_IN, D_OUT = 40, 24
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(seed, batch, p_drop=0.25):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, D_IN)).astype(np.float32)
    params = projection_params(rng, D_IN, D_OUT)
    mask = ((rng.random((batch, D_OUT)) >= p_drop)
            / (1.0 - p_drop)).astype(np.float32)
    g = rng.normal(size=(batch, D_OUT)).astype(np.float32)
    return x, params, mask, g


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _jax_op(x, params, mask, g, dtype):
    """(out, dx, grads) of the JAX op in interpret mode, params handed in
    the working dtype as the JAX model hands them."""
    dt = JNP[dtype]
    pj = {k: jnp.asarray(v, dt) for k, v in params.items()}
    mj = None if mask is None else jnp.asarray(mask)

    @jax.jit
    def run(xx, pp, gg):
        out, vjp = jax.vjp(
            lambda a, b: jax_projection.fused_projection_head(
                a, b, mj, 0.0, True), xx, pp)
        return (out,) + vjp(gg)

    out, dx, grads = run(jnp.asarray(x, dt), pj, jnp.asarray(g))
    return _f32(out), _f32(dx), {k: _f32(v) for k, v in grads.items()}


def _port_op(x, params, mask, g, dtype):
    dt = TORCH[dtype]
    xt = torch.from_numpy(x).to(dt).requires_grad_()
    # fp32 leaves cast outside the op, so autograd widens the gradients
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    cast = {k: v.to(dt) for k, v in pt.items()}
    for v in cast.values():
        v.retain_grad()
    out = fused_projection_head(
        xt, cast, None if mask is None else torch.from_numpy(mask))
    out.backward(torch.from_numpy(g))
    grads = {k: cast[k].grad for k in PARAM_ORDER}
    assert all(v.dtype == dt for v in grads.values())
    assert out.dtype == torch.float32 and xt.grad.dtype == dt
    return (out.detach().numpy(), xt.grad.float().numpy(),
            {k: v.float().numpy() for k, v in grads.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mask", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("batch", [11, 260], ids=["b11", "b260_ragged_tile"])
def test_op_forward_and_vjp_match_jax_kernel(batch, with_mask, dtype):
    x, params, mask, g = _case(50, batch)
    mask = mask if with_mask else None
    out_j, dx_j, grads_j = _jax_op(x, params, mask, g, dtype)
    out_t, dx_t, grads_t = _port_op(x, params, mask, g, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dx_t, dx_j, rtol=1e-5, atol=1e-5)
        for k in PARAM_ORDER:
            np.testing.assert_allclose(grads_t[k], grads_j[k], rtol=1e-5,
                                       atol=1e-5 * max(1.0, batch / 16),
                                       err_msg=k)
        return
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=2e-2)
    for name, a, b in [("x", dx_t, dx_j)] + [
            (k, grads_t[k], grads_j[k]) for k in PARAM_ORDER]:
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= 3e-2 * scale, (name, scale)


def test_plain_backward_is_the_kernels_arithmetic_not_autograd():
    """In bf16 the plain backward rounds d_z and d_a for the four products
    but sums the fp32 values for the two bias gradients, as the JAX kernel:
    it equals the JAX kernel's fp32 gradients (before their cast), and in
    fp32 it equals autograd of the plain forward."""
    x, params, mask, g = _case(51, 19)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    pt = {k: torch.from_numpy(v).to(torch.bfloat16)
          for k, v in params.items()}
    dx, grads = projection_head_backward_reference(
        xt, pt, torch.from_numpy(g), torch.from_numpy(mask))
    assert dx.dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in grads.values())
    # the bias gradients keep bits below bf16 precision
    assert not torch.equal(grads["br"], grads["br"].bfloat16().float())

    x32 = torch.from_numpy(x).requires_grad_()
    p32 = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    out = projection_head_reference(x32, p32, torch.from_numpy(mask))
    want = torch.autograd.grad(out, [x32, *[p32[k] for k in PARAM_ORDER]],
                               torch.from_numpy(g))
    dx, grads = projection_head_backward_reference(
        x32.detach(), {k: v.detach() for k, v in p32.items()},
        torch.from_numpy(g), torch.from_numpy(mask))
    torch.testing.assert_close(dx, want[0], rtol=1e-5, atol=1e-5)
    for k, w in zip(PARAM_ORDER, want[1:]):
        torch.testing.assert_close(grads[k], w, rtol=1e-5, atol=1e-5, msg=k)


@pytest.mark.parametrize("p_drop", [0.5, 0.2])
def test_seed_mode_keep_rate_and_mask_identity(p_drop):
    """Seed mode on the CPU: forward and backward use exactly the mask
    ``draw_keep_mask`` gives for that seed; the mask is a pure function of
    (seed, row, column); the keep rate is 1 − p (±0.01 over 64k draws,
    > 5 standard deviations)."""
    x, params, _, g = _case(52, 13)
    seed = 31337
    mask = draw_keep_mask(seed, 13, D_OUT, p_drop)
    keep_value = float(np.float32(1.0 / (1.0 - p_drop)))
    assert set(torch.unique(mask).tolist()) <= {0.0, keep_value}
    big = draw_keep_mask(seed, 64, 1024, p_drop)
    assert abs(float((big > 0).float().mean()) - (1.0 - p_drop)) < 0.01
    torch.testing.assert_close(
        draw_keep_mask(seed, 5, 1024, p_drop, row0=20), big[20:25],
        rtol=0, atol=0)
    assert not torch.equal(draw_keep_mask(seed + 1, 64, 1024, p_drop), big)

    xt = torch.from_numpy(x).requires_grad_()
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    out = fused_projection_head(xt, pt, None, p_drop,
                                torch.tensor([seed], dtype=torch.int32))
    want = projection_head_reference(xt.detach(), pt, mask).detach()
    torch.testing.assert_close(out.detach(), want, rtol=0, atol=0)
    got = torch.autograd.grad(out, [xt, *[pt[k] for k in PARAM_ORDER]],
                              torch.from_numpy(g))
    dx, grads = projection_head_backward_reference(
        xt.detach(), {k: v.detach() for k, v in pt.items()},
        torch.from_numpy(g), mask)
    torch.testing.assert_close(got[0], dx, rtol=0, atol=0)
    for k, a in zip(PARAM_ORDER, got[1:]):
        torch.testing.assert_close(a, grads[k], rtol=0, atol=0, msg=k)


# ——— the module ———


def _jax_head(x, params, **kw):
    head = JaxHead(proj_dim=D_OUT, fused=True)
    variables = {"params": {
        "in_proj": {"kernel": params["wi"], "bias": params["bi"]},
        "res_proj": {"kernel": params["wr"], "bias": params["br"]},
        "ln": {"scale": params["ln_s"], "bias": params["ln_b"]}}}
    return head, jax.tree_util.tree_map(jnp.asarray, variables)


def _port_head(params):
    head = ProjectionHead(D_IN, D_OUT, fused=True)
    head.load_state_dict({
        "in_proj.kernel": torch.from_numpy(params["wi"]),
        "in_proj.bias": torch.from_numpy(params["bi"]),
        "res_proj.kernel": torch.from_numpy(params["wr"]),
        "res_proj.bias": torch.from_numpy(params["br"]),
        "ln.scale": torch.from_numpy(params["ln_s"]),
        "ln.bias": torch.from_numpy(params["ln_b"])}, strict=True)
    return head


def test_fused_module_eval_matches_jax_module():
    x, params, _, _ = _case(53, 9)
    jhead, variables = _jax_head(x, params)
    want = jax.jit(lambda v, xx: jhead.apply(v, xx, deterministic=True))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = _port_head(params)(torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_fused_module_with_pinned_mask_takes_the_erf_chain_like_jax():
    """With a pinned mask both modules route around the fused op: forward
    and every gradient agree, and differ from the tanh-GELU op's."""
    x, params, mask, g = _case(54, 9, p_drop=0.5)
    jhead, variables = _jax_head(x, params)

    def loss(v, xx):
        out = jhead.apply(v, xx, deterministic=False,
                          dropout_mask=jnp.asarray(mask))
        return jnp.sum(out * jnp.asarray(g)), out

    (_, want), (gv, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables, jnp.asarray(x))
    head = _port_head(params)
    xt = torch.from_numpy(x).requires_grad_()
    got = head(xt, torch.float32, train=True,
               dropout_mask=torch.from_numpy(mask))
    (got * torch.from_numpy(g)).sum().backward()
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **tol)
    for mod, leaf, k in (("in_proj", "kernel", "wi"), ("in_proj", "bias", "bi"),
                         ("res_proj", "kernel", "wr"),
                         ("res_proj", "bias", "br"), ("ln", "scale", "ln_s"),
                         ("ln", "bias", "ln_b")):
        np.testing.assert_allclose(
            getattr(getattr(head, mod), leaf).grad.numpy(),
            np.asarray(gv["params"][mod][leaf]), **tol, err_msg=k)
    with torch.no_grad():
        tanh_op = projection_head_reference(
            torch.from_numpy(x), {k: torch.from_numpy(v)
                                  for k, v in params.items()},
            torch.from_numpy(mask))
    assert (tanh_op - got.detach()).abs().max() > 1e-5


def test_fused_module_train_mode_draws_its_seed_from_the_generator():
    """Train mode without a pinned mask is seed mode: the seed is the next
    int32 of the generator, the forward is the op with that seed, the
    parameters get gradients, and eval mode drops nothing."""
    x, params, _, _ = _case(55, 9)
    head = _port_head(params)
    gen = torch.Generator().manual_seed(5)
    seed = torch.randint(0, 2**31 - 1, (1,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(5))
    out = head(torch.from_numpy(x), torch.float32, train=True, generator=gen)
    pt = {k: torch.from_numpy(v) for k, v in params.items()}
    want = projection_head_reference(
        torch.from_numpy(x), pt, draw_keep_mask(int(seed), 9, D_OUT, 0.5))
    torch.testing.assert_close(out.detach(), want, rtol=0, atol=0)
    out.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in head.parameters())
    with torch.no_grad():
        plain = head(torch.from_numpy(x), torch.float32, train=False)
    torch.testing.assert_close(
        plain, projection_head_reference(torch.from_numpy(x), pt),
        rtol=0, atol=0)
