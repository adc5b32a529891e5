"""``PixelProjector``'s LayerNorm eps: the reference's weights run in the
reference's function.

The reference adapter (``image_adapter.ipynb`` cell 3) is a torch
``Sequential`` whose two LayerNorms take torch's default eps, 1e-5; the JAX
module, and the port's default, take flax's 1e-6. The port's
``utils/convert.py::reference_pixel_projector`` builds the module at 1e-5
for weights that ``convert_pixel_projector`` reads from the reference
layout. Here a plain ``torch.nn`` statement of the reference module, at
torch's default eps, is held against it at full width (1024-d embeddings →
257 × 1024 tokens) on unit-norm inputs, where the eps shows
(``scripts/projector_layernorm_eps.py``); the default module stays at
1e-6, whose JAX parity ``tests/test_torch_caption.py`` holds.
"""

import numpy as np
import pytest
import torch
from torch import nn

from eeg_image_decode_tpu_torch.models.git_caption import PixelProjector
from eeg_image_decode_tpu_torch.utils.convert import (
    convert_pixel_projector,
    reference_pixel_projector,
)
from torch_port_case import two_threads  # noqa: F401 (autouse)

TOKENS, DIM = 257, 1024


class _Transpose(nn.Module):
    """The reference's parameter-free rearrange ``b d t -> b t d``."""

    def forward(self, x):
        return x.transpose(1, 2)


def _reference_sequential() -> nn.Sequential:
    """The reference ``PixelProjector``: 0 ``b d -> b d 1``,
    1 Linear(1, 257), 2 LayerNorm(257), 3 ``b d t -> b t d``,
    4 Linear(1024, 1024), 5 LayerNorm(1024), torch's default eps."""
    return nn.Sequential(nn.Unflatten(1, (DIM, 1)), nn.Linear(1, TOKENS),
                         nn.LayerNorm(TOKENS), _Transpose(),
                         nn.Linear(DIM, DIM), nn.LayerNorm(DIM))


@pytest.fixture(scope="module")
def case():
    """flax-init weights (the setting where the eps shows) with LayerNorm
    affines off identity, as a reference ``state_dict``; 8 unit-norm
    embeddings."""
    port = PixelProjector(TOKENS, DIM, DIM).init_random(0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for ln in (port.ln_tokens, port.ln):
            ln.weight.add_(0.1 * torch.randn(ln.weight.shape, generator=g))
            ln.bias.add_(0.1 * torch.randn(ln.bias.shape, generator=g))
    names = {"expand": "1", "ln_tokens": "2", "proj": "4", "ln": "5"}
    sd = {f"{names[k.split('.')[0]]}.{k.split('.')[1]}": v.numpy().copy()
          for k, v in port.state_dict().items()}
    x = torch.randn(8, DIM, generator=g)
    return sd, x / x.norm(dim=1, keepdim=True)


def test_reference_projector_matches_the_reference_module(case):
    sd, x = case
    ref = _reference_sequential()
    ref.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                        strict=True)
    assert ref[2].eps == ref[5].eps == 1e-5
    port = reference_pixel_projector(num_tokens=TOKENS, in_dim=DIM,
                                     out_dim=DIM)
    port.load_state_dict(convert_pixel_projector(sd), strict=True)
    assert port.ln_tokens.eps == port.ln.eps == 1e-5
    default = PixelProjector(TOKENS, DIM, DIM)
    default.load_state_dict(convert_pixel_projector(sd), strict=True)
    assert default.ln_tokens.eps == default.ln.eps == 1e-6
    with torch.no_grad():
        want, got, at_1e6 = ref(x), port(x), default(x)
    assert got.shape == want.shape == (8, TOKENS, DIM)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    # the eps shows on these inputs: the default module is another function
    assert float((at_1e6 - want).abs().max()) > 1e-2
