"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU. With
no card they raise: a measurement or a served answer that silently ran on
the CPU would be mistaken for one from the card.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None``/``"cuda"`` → the current CUDA device, or raise without one;
    an explicit ``"cpu"`` (what the CPU tests pass) is honoured as given.

    Also pins float32 matmuls and convolutions to full fp32 (no TF32) and
    bf16 matmuls to fp32 reductions, so runs on the card round where the
    reference rounds."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev
