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
    fused_projection_head,
    projection_head_reference,
)
from eeg_image_decode_tpu_torch.ops.tsconv import (
    fold_pool_into_kernel,
    tsconv_pool_fused,
    tsconv_pool_reference,
)
from torch_port_case import attention_params, projection_params


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
