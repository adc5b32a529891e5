"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each skips on a host without a CUDA device. The file imports
no JAX, so it runs on a GPU host without JAX or the test suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Shapes: a small one with ragged widths (not multiples of 4, 16 or 32) and
the full ATM-S serving width; float32 and bfloat16.
"""

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
