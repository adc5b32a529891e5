"""PyTorch + CUDA port of ``eeg_image_decode_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here mirrors
its counterpart's path and is held against it on the same weights and inputs
(``tests/test_torch_*.py``). The port imports ``torch`` and numpy only; it
keeps its own copy of every host-side module it needs.

Entry points (``build_encoder``, ``RetrievalService``, the CLI ``serve``)
run on the CUDA card unless the caller passes ``device="cpu"``; with no card
they raise instead of falling back.
"""

from eeg_image_decode_tpu_torch.core.config import ATMSConfig, DataConfig

__all__ = ["ATMSConfig", "DataConfig"]
