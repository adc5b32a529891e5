#!/usr/bin/env python3
"""How far ``PixelProjector``'s LayerNorm eps moves its output.

The JAX package's (and the port's) ``PixelProjector`` builds both its
LayerNorms with flax's default eps 1e-6; the reference's
``torch.nn.LayerNorm`` uses 1e-5. This script runs the port's projector at
full width (1024-d embeddings → 257 × 1024 tokens) twice on the same weights
and inputs, once with eps 1e-6 and once with 1e-5, and prints one JSON row
per case: the largest absolute output difference, the output's scale and
the relative change of the token LayerNorm's normaliser.

Cases: unit-norm 1024-d embeddings (what the EEG encoder predicts and what
CLIP's image features are) under flax's default init (expand kernel
LeCun-normal, biases 0) and with a bias of N(0, 0.02²); and the N(0, 1)
inputs and N(0, 1) expand weights and bias of
``tests/test_git_parity.py::test_pixel_projector_converts_from_reference_layout``.
A numerics fact of the function, the same on any device; it runs on the CPU:

    python scripts/projector_layernorm_eps.py
"""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from eeg_image_decode_tpu_torch.models.git_caption import (  # noqa: E402
    PixelProjector,
)


def run(name: str, x: torch.Tensor, fill) -> dict:
    proj = PixelProjector(257, x.shape[1], 1024).init_random(0)
    with torch.no_grad():
        fill(proj)
        y6 = proj(x)
        var = torch.var(proj.expand(x[:, :, None]), dim=-1, unbiased=False)
        for ln in (proj.ln_tokens, proj.ln):
            ln.eps = 1e-5
        y5 = proj(x)
    return {"case": name, "max_abs_diff": float((y5 - y6).abs().max()),
            "mean_abs_diff": float((y5 - y6).abs().mean()),
            "output_std": float(y6.std()),
            "token_var_median": float(var.median()),
            "normaliser_rel_change_median": float(
                (torch.sqrt((var + 1e-5) / (var + 1e-6)) - 1).median())}


def main() -> None:
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 1024, generator=g)
    unit = x / x.norm(dim=1, keepdim=True)

    def flax_init(proj):
        pass

    def small_bias(proj):
        proj.expand.bias.copy_(0.02 * torch.randn(257, generator=g))

    def test_like(proj):
        proj.expand.weight.copy_(torch.randn(257, 1, generator=g))
        proj.expand.bias.copy_(torch.randn(257, generator=g))

    for row in (run("unit-norm embeddings, flax init", unit, flax_init),
                run("unit-norm embeddings, bias N(0, 0.02^2)", unit,
                    small_bias),
                run("N(0, 1) inputs and expand weights (the parity test)",
                    x, test_like)):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
