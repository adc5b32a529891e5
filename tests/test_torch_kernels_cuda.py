"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each skips on a host without a CUDA device. The file imports
no JAX, so it runs on a GPU host without JAX or the test suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Shapes: a small one with ragged widths (not multiples of 4, 16 or 32) and
the full ATM-S serving width; float32 and bfloat16. At the end, the CLIP
towers of ``cli features`` (plain PyTorch, no kernel of the port) in
bfloat16 against float32, and the command itself, on the card; the prior
and low-level steps against the CPU; the tiny SDXL generator against the
CPU, and a bfloat16 reconstruct through the encoder's kernels; the tiny GIT
captioner against the CPU, and a caption service through the encoder's
kernels; the reconstruction metric table with all four backbones and a tiny
CLIP tower against the CPU; NICE's bf16 training step through the tsconv
kernels against their plain versions, and each zoo encoder's eval forward
on the card against the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from eeg_image_decode_tpu_torch.ops.attention import (
    attention_layer_reference,
    fused_attention_layer,
)
from eeg_image_decode_tpu_torch.ops.projection import (
    PARAM_ORDER as PROJ_PARAMS,
    draw_keep_mask,
    fused_projection_head,
    projection_head_backward_reference,
    projection_head_reference,
)
from eeg_image_decode_tpu_torch.ops.tsconv import (
    fold_pool_into_kernel,
    tsconv_pool_fused,
    tsconv_pool_reference,
)
from torch_port_case import attention_params, keep_masks, projection_params


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels run only there")
    from eeg_image_decode_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


# kernel vs plain on the card: fp32 differs in summation order only;
# bf16 may differ by one rounding of an intermediate (2^-8 relative),
# which the LayerNorms can carry to a few bf16 ulps of the output
CUDA_TOL = {torch.float32: 1e-4, torch.bfloat16: 6e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,heads,ff,length", [(32, 4, 64, 9),
                                               (250, 4, 256, 64)])
def test_attention_kernel_on_card(cuda, dtype, d, heads, ff, length):
    rng = np.random.default_rng(5)
    inner = (d // heads) * heads
    x = torch.from_numpy(rng.normal(size=(5, length, d)).astype(np.float32))
    params = {k: v.to(cuda, dtype) for k, v in
              _t(attention_params(rng, d, inner, ff)).items()}
    x = x.to(cuda, dtype)
    got = fused_attention_layer(x, params, heads)
    want = attention_layer_reference(x, params, heads)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= CUDA_TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,t,k,f,pool,stride", [
    (3 * 8, 100, 9, 6, 16, 4), (4 * 63, 250, 25, 40, 51, 5)])
def test_tsconv_kernel_on_card(cuda, dtype, rows, t, k, f, pool, stride):
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(rows // 8, 8, t)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(k, f)) / np.sqrt(k)).astype(np.float32))
    w_tilde = fold_pool_into_kernel(w, pool).to(cuda, dtype)
    x = x.to(cuda, dtype)
    got = tsconv_pool_fused(x, w_tilde, stride)
    want = tsconv_pool_reference(x, w_tilde, stride)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= CUDA_TOL[dtype] * max(1.0, want.abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d_in,d_out", [(5, 48, 32), (9, 1440, 1024)])
def test_projection_kernel_on_card(cuda, dtype, b, d_in, d_out):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(b, d_in)).astype(np.float32))
    params = {k: v.to(cuda, dtype) for k, v in
              _t(projection_params(rng, d_in, d_out)).items()}
    x = x.to(cuda, dtype)
    got = fused_projection_head(x, params)
    want = projection_head_reference(x, params)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= CUDA_TOL[dtype], err


# ——— training kernels: the attention forward's dropout modes, its
# backward, the seeded mask draw and the tsconv backward ———

# backward kernel vs plain on the card, as a share of the largest |plain|
# value of each output: fp32 differs in summation order only; in bf16 an
# fp32 sum that lands on the other side of a rounding boundary moves an
# intermediate by one bf16 ulp (2^-8), and the LayerNorm and softmax
# backward carry that into their neighbours
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _rel_err(got, want, scale=None):
    if scale is None:
        scale = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() / max(scale, 1e-30)


def _bias_scale(want: dict) -> float:
    """The key bias's gradient is zero in exact arithmetic (softmax ignores
    a shift of the scores), so what both sides compute there is rounding
    noise: its error is measured against the largest of the three QKV bias
    gradients, whose summands have the same size."""
    return max(want[k].float().abs().max().item() for k in ("bq", "bk", "bv"))


ATTN_SHAPES = [(32, 4, 64, 9), (250, 4, 256, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,heads,ff,length", ATTN_SHAPES)
def test_attention_fwd_masks_kernel_on_card(cuda, dtype, d, heads, ff,
                                            length):
    rng = np.random.default_rng(8)
    inner = (d // heads) * heads
    x = torch.from_numpy(rng.normal(size=(5, length, d)).astype(np.float32))
    params = {k: v.to(cuda, dtype) for k, v in
              _t(attention_params(rng, d, inner, ff)).items()}
    masks = {k: v.to(cuda, dtype) for k, v in
             _t(keep_masks(rng, 5, heads, length, d, ff)).items()}
    x = x.to(cuda, dtype)
    got = fused_attention_layer(x, params, heads, masks=masks)
    want = attention_layer_reference(x, params, heads, masks=masks)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= CUDA_TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,heads,ff,length", ATTN_SHAPES)
def test_attention_fwd_seed_kernel_on_card(cuda, dtype, d, heads, ff,
                                           length):
    """The seed-mode forward equals the mask-mode forward fed the plain
    Philox draw bit for bit, and the plain layer within tolerance; in fp32,
    where mask mode reads the very values seed mode draws, so does the
    backward."""
    from eeg_image_decode_tpu_torch.ops.attention import (
        PARAM_ORDER,
        draw_keep_masks,
    )

    rng = np.random.default_rng(9)
    inner = (d // heads) * heads
    b, seed = 7, 123457
    x = torch.from_numpy(rng.normal(size=(b, length, d)).astype(np.float32))
    gout = torch.from_numpy(rng.normal(size=(b, length, d)).astype(np.float32))
    params = {k: v.to(cuda, dtype).requires_grad_() for k, v in
              _t(attention_params(rng, d, inner, ff)).items()}
    x = x.to(cuda, dtype).requires_grad_()
    gout = gout.to(cuda, dtype)
    seed_t = torch.tensor([seed], dtype=torch.int32, device=cuda)
    plain = draw_keep_masks(seed, b, heads, length, d, ff, 0.25, device=cuda)
    got = fused_attention_layer(x, params, heads, dropout_p=0.25, seed=seed_t)
    via_masks = fused_attention_layer(x, params, heads, masks=plain)
    with torch.no_grad():
        want = attention_layer_reference(x, params, heads, masks=plain)
    torch.cuda.synchronize()
    assert torch.equal(got, via_masks)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= CUDA_TOL[dtype], err
    if dtype == torch.float32:
        inputs = [x, *[params[k] for k in PARAM_ORDER]]
        for name, a, w in zip(("x",) + PARAM_ORDER,
                              torch.autograd.grad(got, inputs, gout),
                              torch.autograd.grad(via_masks, inputs, gout)):
            assert torch.equal(a, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "masks", "seed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,heads,ff,length", ATTN_SHAPES)
def test_attention_bwd_kernel_on_card(cuda, dtype, d, heads, ff, length,
                                      mode):
    """dx and the 16 parameter gradients against the plain backward, and
    two runs of the kernel bit-identical. B = 5 is no multiple of the
    reduction's 32-row slabs."""
    from eeg_image_decode_tpu_torch.ops.attention import (
        PARAM_ORDER,
        attention_layer_backward_reference,
        draw_keep_masks,
    )

    rng = np.random.default_rng(10)
    inner = (d // heads) * heads
    b = 5
    x = torch.from_numpy(rng.normal(size=(b, length, d)).astype(np.float32))
    gout = torch.from_numpy(rng.normal(size=(b, length, d)).astype(np.float32))
    params = {k: v.to(cuda, dtype).requires_grad_() for k, v in
              _t(attention_params(rng, d, inner, ff)).items()}
    x = x.to(cuda, dtype).requires_grad_()
    gout = gout.to(cuda, dtype)
    kw, plain_masks = {}, None
    if mode == "masks":
        kw["masks"] = {k: v.to(cuda, dtype) for k, v in
                       _t(keep_masks(rng, b, heads, length, d, ff)).items()}
        plain_masks = kw["masks"]
    elif mode == "seed":
        kw = {"dropout_p": 0.25, "seed": 99}
        plain_masks = draw_keep_masks(99, b, heads, length, d, ff, 0.25,
                                      device=cuda)

    def kernel_grads():
        out = fused_attention_layer(x, params, heads, **kw)
        return torch.autograd.grad(out, [x, *[params[k] for k in PARAM_ORDER]],
                                   gout)

    got = kernel_grads()
    again = kernel_grads()
    with torch.no_grad():
        dx, grads = attention_layer_backward_reference(
            x, params, gout, heads, masks=plain_masks)
    torch.cuda.synchronize()
    want = [dx] + [grads[k] for k in PARAM_ORDER]
    for name, a, a2, w in zip(("x",) + PARAM_ORDER, got, again, want):
        assert torch.equal(a, a2), f"{name}: two runs differ"
        assert torch.isfinite(a.float()).all(), name
        scale = _bias_scale(grads) if name in ("bq", "bk", "bv") else None
        err = _rel_err(a, w, scale)
        assert err <= BWD_TOL[dtype], (name, err)


# (rows, T, conv taps, filters, pool, stride): a small ragged shape; ATM-S
# width at 315 rows (no multiple of the 32-row tile); T 253 (no multiple of
# the stride: the trailing samples get dx = 0); one position only (T 77);
# 37 rows (two row tiles, the second of 5 rows)
TSCONV_BWD_SHAPES = [
    (3 * 8, 100, 9, 6, 16, 4), (5 * 63, 250, 25, 40, 51, 5),
    (2 * 63, 253, 25, 40, 51, 5), (2 * 63, 77, 25, 40, 51, 5),
    (37, 250, 25, 40, 51, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,t,k,f,pool,stride", TSCONV_BWD_SHAPES)
def test_tsconv_bwd_kernel_on_card(cuda, dtype, rows, t, k, f, pool, stride):
    from eeg_image_decode_tpu_torch.ops.tsconv import (
        _backward,
        tsconv_pool_backward_reference,
    )

    rng = np.random.default_rng(11)
    c = 63 if rows % 63 == 0 else (8 if rows % 8 == 0 else rows)
    x = torch.from_numpy(rng.normal(size=(rows // c, c, t)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(k, f)) / np.sqrt(k)).astype(np.float32))
    w_tilde = fold_pool_into_kernel(w, pool).to(cuda, dtype).requires_grad_()
    x = x.to(cuda, dtype).requires_grad_()
    n_pos = (t - w_tilde.shape[0]) // stride + 1
    gout = torch.from_numpy(rng.normal(size=(rows // c, c, n_pos, f))
                            .astype(np.float32)).to(cuda, dtype)

    def kernel_grads():
        out = tsconv_pool_fused(x, w_tilde, stride)
        return torch.autograd.grad(out, [x, w_tilde], gout)

    got = kernel_grads()
    again = kernel_grads()
    with torch.no_grad():
        dx, dw = tsconv_pool_backward_reference(x, w_tilde, gout, stride)
        # the kernel itself hands dx over in x's dtype and dw~ in fp32
        dx_k, dw_k = _backward(x.detach(), w_tilde.detach(), gout, stride)
    torch.cuda.synchronize()
    assert dx_k.dtype == dtype and dw_k.dtype == torch.float32
    assert torch.equal(dx_k, got[0])
    tail = n_pos * stride - stride + w_tilde.shape[0]   # past the last window
    assert not got[0][..., tail:].any()
    for name, a, a2, want in (("x", got[0], again[0], dx),
                              ("w_tilde", got[1], again[1], dw)):
        assert torch.equal(a, a2), f"{name}: two runs differ"
        err = _rel_err(a, want.to(a.dtype))
        assert err <= BWD_TOL[dtype], (name, err)


# ——— the projection head's dropout modes and its backward ———

# (B, d_in, d_out): ragged widths (no multiple of the 16-byte copies or of
# the mma tile) and batches that are no multiple of the rows per block, and
# the full ATM-S head at an odd batch
PROJ_SHAPES = [(5, 48, 32), (9, 1440, 1024), (70, 150, 100)]


def _proj_case(rng, cuda, dtype, b, d_in, d_out):
    x = torch.from_numpy(rng.normal(size=(b, d_in)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(b, d_out)).astype(np.float32))
    params = {k: v.to(cuda, dtype).requires_grad_() for k, v in
              _t(projection_params(rng, d_in, d_out)).items()}
    return x.to(cuda, dtype).requires_grad_(), params, g.to(cuda)


def _proj_mask(rng, b, d_out, p):
    return torch.from_numpy(((rng.random((b, d_out)) >= p) / (1.0 - p))
                            .astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("p_drop", [0.5, 0.25])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d_in,d_out", PROJ_SHAPES)
def test_projection_fwd_masks_kernel_on_card(cuda, dtype, b, d_in, d_out,
                                             p_drop):
    rng = np.random.default_rng(12)
    x, params, _ = _proj_case(rng, cuda, dtype, b, d_in, d_out)
    mask = _proj_mask(rng, b, d_out, p_drop).to(cuda, dtype)
    with torch.no_grad():
        got = fused_projection_head(x, params, mask)
        want = projection_head_reference(x, params, mask)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= CUDA_TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("p_drop", [0.5, 0.25])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d_in,d_out", PROJ_SHAPES)
def test_projection_fwd_seed_kernel_on_card(cuda, dtype, b, d_in, d_out,
                                            p_drop):
    """The seed-mode forward equals the mask-mode forward fed the plain
    Philox draw bit for bit wherever the mask's value survives the cast to
    x's dtype (fp32 always; bf16 at p = 0.5, where 1/keep = 2), and the
    plain head within tolerance; there the backward is bit-equal too."""
    rng = np.random.default_rng(13)
    seed = 424243
    x, params, g = _proj_case(rng, cuda, dtype, b, d_in, d_out)
    seed_t = torch.tensor([seed], dtype=torch.int32, device=cuda)
    plain = draw_keep_mask(seed, b, d_out, p_drop, device=cuda)
    got = fused_projection_head(x, params, None, p_drop, seed_t)
    via_mask = fused_projection_head(x, params, plain)
    with torch.no_grad():
        want = projection_head_reference(x, params, plain)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= CUDA_TOL[dtype], err
    if dtype == torch.float32 or p_drop == 0.5:
        assert torch.equal(got, via_mask)
        inputs = [x, *[params[k] for k in PROJ_PARAMS]]
        for name, a, w in zip(("x",) + PROJ_PARAMS,
                              torch.autograd.grad(got, inputs, g),
                              torch.autograd.grad(via_mask, inputs, g)):
            assert torch.equal(a, w), name


# the backward also at the training batch and at B 130 (full width: three
# 64-row tiles of the bfloat16 design, the last of two rows)
PROJ_BWD_SHAPES = PROJ_SHAPES + [(1024, 1440, 1024), (130, 1440, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "mask", "seed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d_in,d_out", PROJ_BWD_SHAPES)
def test_projection_bwd_kernel_on_card(cuda, dtype, b, d_in, d_out, mode):
    """dx and the six parameter gradients (in x's dtype, as a step gets
    them) against the plain backward, and two runs bit-identical."""
    rng = np.random.default_rng(14)
    x, params, g = _proj_case(rng, cuda, dtype, b, d_in, d_out)
    args, plain_mask = (), None
    if mode == "mask":
        plain_mask = _proj_mask(rng, b, d_out, 0.25).to(cuda, dtype)
        args = (plain_mask,)
    elif mode == "seed":
        args = (None, 0.25, 77)
        plain_mask = draw_keep_mask(77, b, d_out, 0.25, device=cuda)

    def kernel_grads():
        out = fused_projection_head(x, params, *args)
        return torch.autograd.grad(out, [x, *[params[k] for k in PROJ_PARAMS]],
                                   g)

    got = kernel_grads()
    again = kernel_grads()
    with torch.no_grad():
        dx, grads = projection_head_backward_reference(x, params, g,
                                                       plain_mask)
    torch.cuda.synchronize()
    want = [dx] + [grads[k] for k in PROJ_PARAMS]
    for name, a, a2, w in zip(("x",) + PROJ_PARAMS, got, again, want):
        assert torch.equal(a, a2), f"{name}: two runs differ"
        assert a.dtype == dtype and torch.isfinite(a.float()).all(), name
        err = _rel_err(a, w.to(dtype))
        assert err <= BWD_TOL[dtype], (name, err)


# ——— the bfloat16 forwards on the tensor cores (design "mma_bf16") ———

# (rows, T): 37 rows (a short second tile) at T 253 (no multiple of the
# stride); one position (T 77); the training batch, B 1024 x 63 channels
TSCONV_FWD_MMA_SHAPES = [(37, 253), (2 * 63, 77), (1024 * 63, 250)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,t", TSCONV_FWD_MMA_SHAPES)
def test_tsconv_fwd_mma_kernel_on_card(cuda, rows, t):
    """Against the plain stage 1 within 2^-6 of the largest output (one
    rounding of fp32 sums of exact products, as ``chip_smoke.py`` holds it),
    and a rerun bit-equal."""
    rng = np.random.default_rng(15)
    w = torch.from_numpy((rng.normal(size=(25, 40)) / 5.0).astype(np.float32))
    w_tilde = fold_pool_into_kernel(w, 51).to(cuda, torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(1, rows, t)).astype(np.float32))
    x = x.to(cuda, torch.bfloat16)
    got = tsconv_pool_fused(x, w_tilde, 5)
    again = tsconv_pool_fused(x, w_tilde, 5)
    want = tsconv_pool_reference(x, w_tilde, 5)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got, again)
    err = _rel_err(got, want)
    assert err <= 2.0 ** -6, err


# the serving buckets' batches (1, 8), no multiple of the 64-row tile (37,
# 130: B <= 256 takes 64-column tiles, above it 128) and the training batch
PROJ_FWD_MMA_BATCHES = [1, 8, 37, 130, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "mask", "seed"])
@pytest.mark.parametrize("b", PROJ_FWD_MMA_BATCHES)
def test_projection_fwd_mma_kernel_on_card(cuda, b, mode):
    """The full ATM-S head in bf16 against the plain head (4e-3, or 8e-3
    with dropout, as ``chip_smoke.py`` holds it), a rerun bit-equal, and seed
    mode bit-equal to mask mode fed the plain draw (p = 0.5: 1/keep = 2 is a
    bf16 number)."""
    rng = np.random.default_rng(16)
    x, params, _ = _proj_case(rng, cuda, torch.bfloat16, b, 1440, 1024)
    x = x.detach()
    params = {k: v.detach() for k, v in params.items()}
    args, plain_mask = (), None
    if mode == "mask":
        plain_mask = _proj_mask(rng, b, 1024, 0.5).to(cuda, torch.bfloat16)
        args = (plain_mask,)
    elif mode == "seed":
        args = (None, 0.5, 31)
        plain_mask = draw_keep_mask(31, b, 1024, 0.5, device=cuda)
    got = fused_projection_head(x, params, *args)
    again = fused_projection_head(x, params, *args)
    want = projection_head_reference(x, params, plain_mask)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if mode == "seed":
        assert torch.equal(got, fused_projection_head(x, params, plain_mask))
    err = (got - want).abs().max().item()
    assert err <= (4e-3 if mode == "none" else 8e-3), err


@pytest.mark.cuda
def test_forward_designs_by_dtype(cuda):
    from eeg_image_decode_tpu_torch.ops import projection, tsconv

    for op in (projection, tsconv):
        assert op.forward_design(torch.bfloat16) == "mma_bf16"
        assert op.forward_design(torch.float32) == "fma_fp32"


@pytest.mark.cuda
def test_tsconv_fwd_mma_refuses_shapes_past_its_limits(cuda):
    """T 300 is past the 256 samples a tile stages: the bf16 design raises
    with its name; fp32 takes the shape."""
    w_tilde = torch.zeros(75, 40, device=cuda)
    x = torch.zeros(1, 2, 300, device=cuda)
    assert tsconv_pool_fused(x, w_tilde, 5).shape == (1, 2, 46, 40)
    with pytest.raises(ValueError, match="mma_bf16"):
        tsconv_pool_fused(x.bfloat16(), w_tilde.bfloat16(), 5)


# ——— the attention layer on the tensor cores (design "mma_bf16") ———


@pytest.mark.cuda
def test_attention_designs_by_dtype(cuda):
    from eeg_image_decode_tpu_torch.ops import attention

    assert attention.forward_design(torch.bfloat16) == "mma_bf16"
    assert attention.backward_design(torch.bfloat16) == "mma_bf16"
    assert attention.forward_design(torch.float32) == "fma_fp32"
    assert attention.backward_design(torch.float32) == "fma_fp32"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "masks", "seed"])
@pytest.mark.parametrize("d,heads,ff,length", ATTN_SHAPES)
def test_attention_mma_reruns_are_bit_equal(cuda, d, heads, ff, length,
                                            mode):
    """In bfloat16 the forward and the backward (dx and all 16 gradients:
    split-K chunks summed in a fixed order, no atomics) give the same bits
    on a rerun, in each dropout mode; B = 37 fills no whole chunk of 32
    rows."""
    from eeg_image_decode_tpu_torch.ops.attention import PARAM_ORDER

    rng = np.random.default_rng(17)
    inner = (d // heads) * heads
    b = 37
    x = torch.from_numpy(rng.normal(size=(b, length, d)).astype(np.float32))
    gout = torch.from_numpy(rng.normal(size=(b, length, d)).astype(np.float32))
    params = {k: v.to(cuda, torch.bfloat16).requires_grad_() for k, v in
              _t(attention_params(rng, d, inner, ff)).items()}
    x = x.to(cuda, torch.bfloat16).requires_grad_()
    gout = gout.to(cuda, torch.bfloat16)
    kw = {}
    if mode == "masks":
        kw["masks"] = {k: v.to(cuda, torch.bfloat16) for k, v in
                       _t(keep_masks(rng, b, heads, length, d, ff)).items()}
    elif mode == "seed":
        kw = {"dropout_p": 0.25, "seed": 7}
    inputs = [x, *[params[k] for k in PARAM_ORDER]]
    outs = [fused_attention_layer(x, params, heads, **kw) for _ in range(2)]
    grads = [torch.autograd.grad(o, inputs, gout) for o in outs]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert torch.isfinite(outs[0].float()).all()
    for name, a, a2 in zip(("x",) + PARAM_ORDER, *grads):
        assert torch.equal(a, a2), name


@pytest.mark.cuda
def test_attention_mma_refuses_shapes_past_its_limits(cuda):
    """L 65 is past the 64-row tile: the bf16 designs raise with their
    name; fp32 takes the shape."""
    rng = np.random.default_rng(18)
    params = {k: v.to(cuda) for k, v in
              _t(attention_params(rng, 32, 32, 64)).items()}
    x = torch.zeros(1, 65, 32, device=cuda)
    assert fused_attention_layer(x, params, 4).shape == (1, 65, 32)
    with pytest.raises(ValueError, match="mma_bf16"):
        fused_attention_layer(x.bfloat16(),
                              {k: v.bfloat16() for k, v in params.items()}, 4)


# ——— the CLIP towers of cli features (plain PyTorch: no TPU kernel) ———


def _cosines(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1)


@pytest.mark.cuda
def test_clip_towers_bf16_against_fp32_on_card(cuda):
    """ViT-H/14 widths at 4 layers (the full 32 run in chip_smoke.py), the
    same seeded weights: bf16 holds fp32 at per-row cosine ≥ 0.999 (pooled
    features, the vision grid, the text states); fp32 on the card holds
    fp32 on the CPU at 1e-4 (no TF32)."""
    from eeg_image_decode_tpu_torch.models.clip_vit import (
        CLIPTextConfig,
        CLIPTextTower,
        CLIPVisionConfig,
        CLIPVisionTower,
        clip_preprocess,
    )

    vcfg = dataclasses.replace(CLIPVisionConfig.vit_h_14(), layers=4)
    tcfg = dataclasses.replace(CLIPTextConfig.vit_h_14(), layers=4)
    rng = np.random.default_rng(21)
    imgs = clip_preprocess(torch.from_numpy(
        rng.random((4, 224, 224, 3)).astype(np.float32)))
    ids = torch.from_numpy(rng.integers(1, 49000, (4, 77)).astype(np.int32))
    ids[torch.arange(4), torch.tensor([5, 9, 30, 76])] = 49407
    towers = {}
    for name, cls, cfg in (("vision", CLIPVisionTower, vcfg),
                           ("text", CLIPTextTower, tcfg)):
        cpu = cls(cfg, seed=3).eval()
        with torch.device(cuda):
            fp32 = cls(cfg).eval()
            bf16 = cls(cfg, dtype=torch.bfloat16).eval()
        fp32.load_state_dict(cpu.state_dict())
        bf16.load_state_dict(cpu.state_dict())
        towers[name] = (cpu, fp32, bf16)
    with torch.inference_mode():
        cpu, fp32, bf16 = towers["vision"]
        want = cpu(imgs)
        got32, got16 = fp32(imgs.to(cuda)), bf16(imgs.to(cuda))
        grid32 = fp32(imgs.to(cuda), return_grid=True)
        grid16 = bf16(imgs.to(cuda), return_grid=True)
        cpu, fp32, bf16 = towers["text"]
        t_want = cpu(ids, return_states=True)
        t32 = fp32(ids.to(cuda), return_states=True)
        t16 = bf16(ids.to(cuda), return_states=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got32.cpu(), want, rtol=1e-4, atol=1e-4)
    for k in t_want:
        torch.testing.assert_close(t32[k].cpu(), t_want[k], rtol=1e-4,
                                   atol=1e-4, msg=k)
    assert got16.dtype == torch.float32 and got16.shape == (4, 1024)
    for name, a, b in (("vision", got16, got32), ("grid", grid16, grid32),
                       *((f"text {k}", t16[k], t32[k]) for k in t32)):
        cos = _cosines(a, b).min().item()
        assert cos >= 0.999, (name, cos)


@pytest.mark.cuda
def test_cli_features_tiny_on_card(cuda, tmp_path):
    """``cli features --tiny`` on the card against the same command on the
    CPU: the same cache file name, features within 1e-4."""
    import contextlib
    import io
    import json
    import pickle

    from eeg_image_decode_tpu_torch import cli
    from eeg_image_decode_tpu_torch.data.features import load_features
    from PIL import Image
    from eeg_image_decode_tpu_torch.data.synthetic import (
        write_synthetic_clip_vocab,
    )
    from eeg_image_decode_tpu_torch.models.clip_vit import (
        CLIPTextConfig,
        CLIPTextTower,
        CLIPVisionConfig,
        CLIPVisionTower,
    )
    from eeg_image_decode_tpu_torch.utils.convert_clip import (
        clip_tree_from_state_dict,
    )

    rng = np.random.default_rng(22)
    images = tmp_path / "images"
    for name in ("00001_aardvark", "00002_ice_cream", "00003_abacus"):
        (images / name).mkdir(parents=True)
        Image.fromarray(rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)
                        ).save(images / name / "a.png")
    vocab, merges = write_synthetic_clip_vocab(
        str(tmp_path), ["This picture is aardvark", "This picture is "
                        "ice_cream", "This picture is abacus"],
        vocab_size=600)
    vcfg = CLIPVisionConfig.tiny()
    tcfg = CLIPTextConfig(vocab_size=600, context_length=16, width=32,
                          layers=2, heads=2, embed_dim=vcfg.embed_dim)
    params = {"vision": clip_tree_from_state_dict(
                  CLIPVisionTower(vcfg, seed=1).state_dict(), "vision", 2),
              "text": clip_tree_from_state_dict(
                  CLIPTextTower(tcfg, seed=2).state_dict(), "text", 2)}
    with open(tmp_path / "clip.pkl", "wb") as f:
        pickle.dump(params, f)
    lines = {}
    for device in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["features", "--images-dir", str(images),
                      "--clip-params", str(tmp_path / "clip.pkl"),
                      "--vocab", vocab, "--merges", merges, "--cache-dir",
                      str(tmp_path / device), "--tiny", "--device", device])
        lines[device] = json.loads(buf.getvalue().splitlines()[-1])
    got, want = lines["cuda"], lines["cpu"]
    assert got["cache"].rsplit("/", 1)[1] == want["cache"].rsplit("/", 1)[1]
    g, w = load_features(got["cache"]), load_features(want["cache"])
    for k in ("img_features", "text_features"):
        assert g[k].shape == (3, vcfg.embed_dim)
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-4, err_msg=k)


# ——— the diffusion prior and the low-level encoder: plain PyTorch on the
# card (no kernel of the port), one training step against the CPU ———


def _rel(a, b):
    return (torch.linalg.vector_norm(a.double().cpu() - b.double().cpu())
            / torch.linalg.vector_norm(b.double().cpu()).clamp_min(1e-30)
            ).item()


def _step_on(device, model_state, build, step):
    """``build(device)`` → (trainer, its model) loaded with ``model_state``;
    ``step(trainer)`` → the loss. Returns (loss, gradients, trainer)."""
    trainer, model = build(device)
    model.load_state_dict(model_state, strict=True)
    loss = step(trainer)
    grads = {n: p.grad.detach().cpu().clone()
             for n, p in model.named_parameters()}
    return loss, grads, trainer


@pytest.mark.cuda
def test_prior_step_on_card_matches_cpu(cuda):
    """One full-width prior step (B 64, fp32) on the card against the CPU:
    the loss at 1e-5, each gradient at 1e-4 relative; then the optimizer
    fed the CPU's gradients on both sides moves the weights alike (1e-6)."""
    from eeg_image_decode_tpu_torch.core.config import PriorConfig
    from eeg_image_decode_tpu_torch.train.prior import PriorPipe

    cfg = PriorConfig(batch_size=64)
    rng = np.random.default_rng(41)
    c = torch.from_numpy(rng.normal(size=(64, 1024)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(64, 1024)).astype(np.float32))
    noise = torch.from_numpy(rng.normal(size=(64, 1024)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 1000, 64))
    keep = torch.ones(64)
    ref = PriorPipe(cfg, device="cpu")
    ref.init(total_steps=10)
    state = {k: v.clone() for k, v in ref.model.state_dict().items()}

    def build(device):
        pipe = PriorPipe(cfg, device=device)
        pipe.init(total_steps=10)
        return pipe, pipe.model

    def step(pipe):
        dev = pipe.device
        pipe.model.eval()
        loss = pipe._loss(h.to(dev), c.to(dev), t.to(dev), noise.to(dev),
                          keep.to(dev), train=False)
        pipe.state.optimizer.zero_grad()
        loss.backward()
        return loss.item()

    results = {d: _step_on(d, state, build, step) for d in ("cpu", cuda)}
    (l_cpu, g_cpu, p_cpu), (l_gpu, g_gpu, p_gpu) = results.values()
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu), (l_gpu, l_cpu)
    errs = {n: _rel(g_gpu[n], g_cpu[n]) for n in g_cpu}
    assert max(errs.values()) <= 1e-4, errs
    for pipe in (p_cpu, p_gpu):
        for n, p in pipe.model.named_parameters():
            p.grad = g_cpu[n].to(p.device)
        pipe.state.optimizer.step()
    want = p_cpu.model.state_dict()
    for n, v in p_gpu.model.state_dict().items():
        assert _rel(v, want[n]) <= 1e-6, n


@pytest.mark.cuda
def test_lowlevel_step_on_card_matches_cpu(cuda):
    """One low-level training step (B 8, fp32, no TF32) on the card against
    the same step on the CPU in float64, the exact reference (the card
    host's CPU convolution backward in fp32 is itself off by far more than
    the card's): the L1 loss at 1e-5; the backward from the reference's
    output gradient, sign(pred − latents)/N (a rounding-level pred −
    latents can flip a sign: the L1 loss is not smooth), at 1e-4 relative
    for every gradient but the conv biases ahead of a train-mode BatchNorm,
    whose gradient is zero up to rounding; the BatchNorm statistics at
    1e-4; then AdamW fed the same gradients on the card and on the CPU, both
    fp32, moves the weights alike (1e-6)."""
    from eeg_image_decode_tpu_torch.core.config import LowLevelConfig
    from eeg_image_decode_tpu_torch.models.lowlevel import EncoderLowLevel
    from eeg_image_decode_tpu_torch.train.lowlevel import LowLevelTrainer

    cfg = LowLevelConfig(time_proj_dim=16)
    rng = np.random.default_rng(42)
    eeg = torch.from_numpy(rng.normal(size=(8, 63, 250)))
    lat = torch.from_numpy(0.1 * rng.normal(size=(8, 4, 64, 64)))

    def build(device):
        t = LowLevelTrainer(cfg, device=device, model=EncoderLowLevel(
            time_proj_dim=16, stage_channels=(64, 32, 16, 16, 8, 8)))
        t.init(total_steps=10, steps_per_epoch=1, seed=3)
        return t

    ref, card, cpu32 = build("cpu"), build(cuda), build("cpu")
    ref.model.double()
    out = {}
    for t, dt in ((ref, torch.float64), (card, torch.float32)):
        t.model.train()
        pred = t.model(eeg.to(t.device, dt), train=True)
        out[dt] = torch.mean(torch.abs(pred - lat.to(t.device, dt))).item()
        if "dy" not in out:  # the reference's, the first side run
            out["dy"] = torch.sign(pred - lat).detach() / pred.numel()
        t.state.optimizer.zero_grad()
        pred.backward(out["dy"].to(t.device, dt))
    assert abs(out[torch.float32] - out[torch.float64]) <= 1e-5 * out[
        torch.float64], out
    pre_bn = {f"up_{i}.bias" for i in range(6)} | {"proj_16.bias"}
    want = {n: p.grad for n, p in ref.model.named_parameters()}
    errs = {n: _rel(p.grad, want[n]) for n, p in card.model.named_parameters()
            if n not in pre_bn}
    assert max(errs.values()) <= 1e-4, errs
    ref_sd = ref.model.state_dict()
    stats = {n: _rel(v, ref_sd[n]) for n, v in card.model.state_dict().items()
             if n.endswith((".mean", ".var"))}
    assert max(stats.values()) <= 1e-4, stats
    # AdamW on the card against AdamW on the CPU, fed the same gradients
    cpu32.model.load_state_dict(card.model.state_dict())
    for t in (cpu32, card):
        for n, p in t.model.named_parameters():
            p.grad = want[n].to(p.device, torch.float32)
        t.state.optimizer.step()
    moved = cpu32.model.state_dict()
    for n, v in card.model.state_dict().items():
        assert _rel(v, moved[n]) <= 1e-6, n


def _tiny_generator(device, dtype, seed=0):
    from eeg_image_decode_tpu_torch.gen.sdxl import (
        Generator4Embeds,
        GeneratorConfig,
    )

    gen = Generator4Embeds(GeneratorConfig.tiny(), dtype=dtype, device=device)
    gen.init_random(seed=seed)
    return gen


@pytest.mark.cuda
def test_tiny_generator_on_card_matches_cpu(cuda):
    """The tiny UNet, VAE and the 4-step generation in fp32 (no TF32) on the
    card against the same weights and draws on the CPU: ε and the decoded
    images at 1e-4 of their scale, the generated images at 1e-4."""
    cpu = _tiny_generator("cpu", torch.float32, seed=5)
    card = _tiny_generator(cuda, torch.float32)
    card.load_state_dicts(unet=cpu.unet.state_dict(),
                          vae=cpu.vae.state_dict())
    rng = np.random.default_rng(6)
    lat = torch.from_numpy(rng.normal(size=(3, 4, 8, 8)).astype(np.float32))
    t = torch.tensor([999, 500, 1])
    ctx = torch.from_numpy(rng.normal(size=(3, 4, 64)).astype(np.float32))
    emb = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    tids = torch.tensor([[64.0, 64, 0, 0, 64, 64]] * 3)
    with torch.no_grad():
        want = cpu.unet(lat, t, ctx, None, tids, emb)
        got = card.unet(lat.to(cuda), t.to(cuda), ctx.to(cuda), None,
                        tids.to(cuda), emb.to(cuda)).cpu()
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
        want = cpu.vae.decode(lat)
        got = card.vae.decode(lat.to(cuda)).cpu()
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    noise = torch.from_numpy(rng.normal(size=(5, 3, 4, 8, 8)).astype(
        np.float32))
    kw = dict(init_noise=noise[0], step_noises=noise[1:], guidance_scale=2.0)
    want = cpu.generate(emb, **kw)
    got = card.generate(emb.to(cuda), **kw).cpu()
    assert got.shape == (3, 16, 16, 3)
    assert (got - want).abs().max() <= 1e-4


@pytest.mark.cuda
def test_reconstruct_bf16_on_card(cuda):
    """``ReconstructionService`` in bf16 on the card (the full-width ATM-S
    encoder through its forward kernels, a small prior, the tiny generator):
    images finite in [0, 1], a row alone against the same row in a padded
    batch ≤ 2/255, and the attention and tsconv kernels launched."""
    from eeg_image_decode_tpu_torch.core.config import ATMSConfig, PriorConfig
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.serve import ReconstructionService
    from eeg_image_decode_tpu_torch.train.prior import PriorPipe

    model = build_encoder("atms", config=ATMSConfig(), dtype=torch.bfloat16,
                          device=cuda, seed=0)
    pipe = PriorPipe(PriorConfig(embed_dim=64, cond_dim=1024,
                                 hidden_dims=(64, 32), time_embed_dim=32,
                                 num_inference_steps=4), device=cuda)
    pipe.init(total_steps=1, seed=0)
    svc = ReconstructionService(model, pipe,
                                _tiny_generator(cuda, torch.bfloat16),
                                max_batch=4, device=cuda)
    eeg = np.random.default_rng(7).normal(size=(5, 63, 250)).astype(
        np.float32)
    _build.reset_launches()
    out = svc.reconstruct(eeg, 0, seed=3)
    assert _build.LAUNCHES["attention_fwd"] and _build.LAUNCHES["tsconv_fwd"]
    assert out.shape == (5, 16, 16, 3) and np.isfinite(out).all()
    assert out.min() >= 0 and out.max() <= 1
    alone = svc.reconstruct(eeg[4:5], 0, row_seeds=[[3, 4]])
    assert np.abs(alone - out[4:5]).max() <= 2 / 255
    assert set(svc.stage_ms) == set(svc.STAGES)
    assert all(v > 0 for v in svc.stage_ms.values())


def _tiny_captioner(device):
    from eeg_image_decode_tpu_torch.models.git_caption import (
        GITCaptioner,
        GITConfig,
        PixelProjector,
    )

    torch.manual_seed(0)
    git = GITCaptioner(GITConfig.tiny()).init_random(3)
    # larger weights than N(0, 0.02): the logits' gaps well above fp32
    # rounding, so the greedy ids must agree
    with torch.no_grad():
        for p in git.parameters():
            if p.ndim == 2:
                p.mul_(10)
    proj = PixelProjector(3, 64, 16).init_random(4)
    return git.to(device), proj.to(device)


@pytest.mark.cuda
def test_tiny_captioner_on_card_matches_cpu(cuda):
    """GIT's fp32 logits on the card against the CPU (≤ 1e-4 of max|logit|:
    the products' summation order), the greedy ids equal."""
    git, proj = _tiny_captioner(cuda)
    emb = torch.from_numpy(np.random.default_rng(8).normal(
        size=(4, 64)).astype(np.float32))
    ids = torch.from_numpy(np.random.default_rng(9).integers(
        0, 64, size=(4, 6)))
    with torch.no_grad():
        vis = proj(emb.to(cuda))
        got = git(vis, ids.to(cuda)).cpu()
        tokens = git.generate(vis, max_new_tokens=6).cpu()
    git_cpu, proj_cpu = git.cpu(), proj.cpu()
    with torch.no_grad():
        vis_cpu = proj_cpu(emb)
        want = git_cpu(vis_cpu, ids)
        want_tokens = git_cpu.generate(vis_cpu, max_new_tokens=6)
    torch.testing.assert_close(vis.cpu(), vis_cpu, atol=1e-5, rtol=0)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    assert torch.equal(tokens, want_tokens)


@pytest.mark.cuda
def test_caption_service_on_card(cuda, tmp_path):
    """``CaptionService`` on the card (the full-width bf16 ATM-S encoder
    through its forward kernels, a small prior, the tiny GIT): a row alone
    and in a padded batch give the same ids at the same offset, the
    attention and tsconv kernels are launched, and the stage split is
    recorded."""
    from eeg_image_decode_tpu_torch.core.config import ATMSConfig, PriorConfig
    from eeg_image_decode_tpu_torch.data.synthetic import (
        write_synthetic_wordpiece_vocab,
    )
    from eeg_image_decode_tpu_torch.data.tokenizers import WordPieceTokenizer
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.serve import CaptionService
    from eeg_image_decode_tpu_torch.train.prior import PriorPipe

    model = build_encoder("atms", config=ATMSConfig(), dtype=torch.bfloat16,
                          device=cuda, seed=0)
    pipe = PriorPipe(PriorConfig(embed_dim=64, cond_dim=1024,
                                 hidden_dims=(64, 32), time_embed_dim=32,
                                 num_inference_steps=4), device=cuda)
    pipe.init(total_steps=1, seed=0)
    tok = WordPieceTokenizer.from_file(write_synthetic_wordpiece_vocab(
        str(tmp_path), vocab_size=64, cls_id=1, sep_id=2))
    svc = CaptionService(model, pipe, *_tiny_captioner(cuda), tok,
                         max_batch=4, max_new_tokens=6, device=cuda)
    eeg = np.random.default_rng(7).normal(size=(5, 63, 250)).astype(
        np.float32)
    _build.reset_launches()
    tokens = svc.tokens(eeg, 0, seed=3)
    assert _build.LAUNCHES["attention_fwd"] and _build.LAUNCHES["tsconv_fwd"]
    assert tokens.shape == (5, 7) and (tokens[:, 0] == 1).all()
    # row 4 rides at offset 0 of the second chunk: alone it does too
    alone = svc.tokens(eeg[4:5], 0, row_seeds=[[3, 4]])
    np.testing.assert_array_equal(alone, tokens[4:5])
    assert svc.caption(eeg[:2], 0, seed=3) == [tok.decode(r)
                                               for r in tokens[:2]]
    assert set(svc.stage_ms) == set(svc.STAGES)
    assert all(v > 0 for v in svc.stage_ms.values())


@pytest.mark.cuda
def test_metric_table_on_card_matches_cpu(cuda):
    """``reconstruction_metrics`` on 8 small pairs with the four seeded
    backbones (resized to 64-96 px here, not their published sizes) and a
    tiny ViT-L-style CLIP tower: every feature within 1e-4 of its largest
    CPU value, PixCorr and SSIM within 1e-5, the 2-way rows equal, the
    distances within 1e-5."""
    from eeg_image_decode_tpu_torch.eval import backbones as bb
    from eeg_image_decode_tpu_torch.eval.recon_metrics import (
        make_clip_extractor,
        reconstruction_metrics,
    )
    from eeg_image_decode_tpu_torch.models.clip_vit import (
        CLIPVisionConfig,
        CLIPVisionTower,
    )

    sizes = {"alexnet": 64, "inception": 96, "effnet": 80, "swav": 72}

    def extractors(device):
        out = {}
        for kind, size in sizes.items():
            model = bb.init_random(bb.BACKBONES[kind](), 0).to(device).eval()

            def extract(images, model=model, size=size, kind=kind):
                with torch.no_grad():
                    x = bb.imagenet_preprocess(images, size).permute(
                        0, 3, 1, 2).contiguous()
                    y = model(x)
                y = y["f11"] if kind == "alexnet" else y
                return y.reshape(len(images), -1)
            out[kind] = extract
        tower = CLIPVisionTower(CLIPVisionConfig.tiny("quick_gelu"), seed=1)
        out["clip"] = make_clip_extractor(tower.to(device).eval())
        return out

    rng = np.random.default_rng(11)
    gen = rng.uniform(size=(8, 64, 64, 3)).astype(np.float32)
    gt = np.clip(gen + 0.05 * rng.normal(size=gen.shape), 0, 1).astype(
        np.float32)
    on_card, on_cpu = extractors(cuda), extractors("cpu")
    for name in on_cpu:
        got = on_card[name](torch.from_numpy(gen).to(cuda)).cpu()
        want = on_cpu[name](torch.from_numpy(gen))
        assert float((got - want).abs().max()) <= (
            1e-4 * float(want.abs().max())), name
    got = reconstruction_metrics(torch.from_numpy(gen).to(cuda),
                                 torch.from_numpy(gt).to(cuda), on_card)
    want = reconstruction_metrics(torch.from_numpy(gen),
                                  torch.from_numpy(gt), on_cpu)
    assert list(got) == list(want) and len(got) == 12
    for k in want:
        if k.startswith("2way"):
            assert got[k] == want[k], k
        else:
            assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])


# ——— the encoder zoo: NICE's step through the tsconv kernels, and every
# zoo encoder's eval forward on the card against the CPU ———

ZOO = ("nice", "eegnetv4", "atme", "mlp", "shallowfbcspnet", "eegconformer",
       "metaeeg", "atcnet", "eegitnet")


@pytest.mark.cuda
def test_nice_bf16_step_through_tsconv_kernels_matches_plain(cuda):
    """One NICE training step (B 256, bf16, dropout drawn from one seed on
    both sides) through the tsconv forward and backward kernels against
    the same step through their plain versions: every gradient within
    5e-2 relative L2, as ``chip_smoke.py`` holds ATM-S's step; the kernels
    launched once each."""
    from unittest import mock

    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.ops.tsconv import (
        tsconv_pool_backward_reference,
    )

    class PlainTSConv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, stride):
            ctx.save_for_backward(x, w)
            ctx.stride = stride
            return tsconv_pool_reference(x, w, stride)

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            dx, dw = tsconv_pool_backward_reference(x, w, g, ctx.stride)
            return dx.to(x.dtype), dw.to(w.dtype), None

    model = build_encoder("nice", dtype=torch.bfloat16, device=cuda, seed=4)
    x = torch.from_numpy(np.random.default_rng(40).normal(
        size=(256, 63, 250)).astype(np.float32)).to(cuda)

    def step():
        model.train().zero_grad(set_to_none=True)
        gen = torch.Generator(device=cuda).manual_seed(9)
        feats, scale = model(x, generator=gen)
        (scale * feats.float().square().mean()).backward()
        return {n: p.grad.detach().float().clone()
                for n, p in model.named_parameters()}

    _build.reset_launches()
    got = step()
    assert _build.LAUNCHES["tsconv_fwd"] == 1
    assert _build.LAUNCHES["tsconv_bwd"] == 1
    with mock.patch("eeg_image_decode_tpu_torch.models.layers."
                    "tsconv_pool_fused",
                    lambda x, w, stride=5: PlainTSConv.apply(
                        x, w.to(x.dtype), stride)):
        _build.reset_launches()
        want = step()
    assert not any(_build.LAUNCHES.values())
    errs = {n: _rel(got[n], want[n]) for n in want}
    assert max(errs.values()) <= 5e-2, errs


@pytest.mark.cuda
@pytest.mark.parametrize("name", ZOO)
def test_zoo_eval_forward_on_card_matches_cpu(cuda, name):
    """Each zoo encoder at its defaults, the same seeded weights, 4 rows:
    fp32 on the card (TF32 off) within 1e-4 · max|CPU|; bf16 on the card
    against fp32 at per-row cosine ≥ 0.99."""
    from eeg_image_decode_tpu_torch.models.registry import build_encoder

    x = torch.from_numpy(np.random.default_rng(42).normal(
        size=(4, 63, 250)).astype(np.float32))
    with torch.no_grad():
        want, _ = build_encoder(name, device="cpu", seed=6)(x)
        tf32 = torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            got, _ = build_encoder(name, device=cuda, seed=6)(x.to(cuda))
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = tf32
        half, _ = build_encoder(name, dtype=torch.bfloat16, device=cuda,
                                seed=6)(x.to(cuda))
    got, half = got.cpu(), half.float().cpu()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    cos = torch.nn.functional.cosine_similarity(half, got, dim=1)
    assert torch.isfinite(half).all() and cos.min().item() >= 0.99, cos
