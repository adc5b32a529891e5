"""PixelProjector adapter training, the GIT captioning bridge (counterpart
of ``eeg_image_decode_tpu/train/adapters.py``).

The reference trains a small adapter with MSE from the ViT-H CLIP embedding
(what the EEG encoder predicts) to the GIT ViT-L/14 visual-token grid
(``Generation/image_adapter.ipynb`` cell 3: AdamW lr 1e-3, batch 32, 30
epochs, bf16, MSELoss). As in JAX, the whole split stays resident on the
device (16,540 × 257 × 1024 fp32 grids are 17.4 GB), the per-epoch
permutations are drawn up front from ``np.random.default_rng(seed)`` and the
last partial batch is dropped; the products run in bf16 over fp32
parameters, the loss is the fp32 MSE, and the optimizer is optax's
``adamw`` arithmetic (``train/optim.py``). Nothing in an epoch reads a
device value back.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from eeg_image_decode_tpu_torch.models.git_caption import PixelProjector
from eeg_image_decode_tpu_torch.train.optim import OptaxAdam
from eeg_image_decode_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class AdapterTrainConfig:
    epochs: int = 30
    batch_size: int = 32
    lr: float = 1e-3
    weight_decay: float = 1e-2  # torch AdamW default
    seed: int = 0


def init_pixel_projector(num_tokens: int, in_dim: int, out_dim: int, *,
                         seed: int, dtype: torch.dtype,
                         device: torch.device) -> PixelProjector:
    """A fresh projector on ``device`` with flax's default init from
    ``seed`` (:meth:`PixelProjector.init_random`)."""
    with torch.device(device):
        model = PixelProjector(num_tokens, in_dim, out_dim, dtype=dtype)
    return model.init_random(seed)


def train_pixel_projector(
    clip_embeds,  # (N, D) ViT-H image embeddings: numpy or a tensor
    git_grids,  # (N, T, D_out) GIT vision-tower grids
    config: AdapterTrainConfig = AdapterTrainConfig(),
    *,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device | None = None,
) -> tuple[PixelProjector, list[float]]:
    """→ (the trained projector, per-epoch mean losses). MSE, AdamW,
    drop-last batching, on ``device`` (default: the CUDA card; raises
    without one). Tensors already on the device are used in place."""
    dev = resolve_device(device)
    x = torch.as_tensor(clip_embeds, dtype=torch.float32).to(dev)
    y = torch.as_tensor(git_grids, dtype=torch.float32).to(dev)
    n, d = x.shape
    _, t, d_out = y.shape
    if y.shape[0] != n:
        raise ValueError(f"embeddings ({n}) and grids ({y.shape[0]}) counts "
                         "differ")
    bs = config.batch_size
    steps = n // bs  # drop_last=True like the reference
    if steps == 0:
        raise ValueError(f"need ≥{bs} samples, have {n}")
    model = init_pixel_projector(t, d, d_out, seed=config.seed, dtype=dtype,
                                 device=dev).train()
    opt = OptaxAdam(model.parameters(), lambda k: config.lr,
                    weight_decay=config.weight_decay)
    rng = np.random.default_rng(config.seed)
    perms = np.stack([rng.permutation(n) for _ in range(config.epochs)])
    idx = torch.from_numpy(perms[:, :steps * bs].reshape(
        config.epochs, steps, bs)).to(dev)
    step_losses = []
    for epoch in range(config.epochs):
        losses = torch.empty(steps, device=dev)
        for s in range(steps):
            b = idx[epoch, s]
            loss = torch.mean((model(x[b]).float() - y[b]) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses[s] = loss.detach()
        step_losses.append(losses)
    epoch_losses = torch.stack(step_losses).mean(dim=1).cpu()
    return model.eval(), [float(v) for v in epoch_losses]


@torch.inference_mode()
def evaluate_pixel_projector(projector: PixelProjector, clip_embeds,
                             git_grids, *, batch_size: int = 32) -> float:
    """Held-out MSE, the mean of per-batch means (the reference's test
    loop), on the projector's device and in its dtype."""
    dev = projector.proj.weight.device
    losses = []
    for i in range(0, len(clip_embeds), batch_size):
        x = torch.as_tensor(clip_embeds[i:i + batch_size],
                            dtype=torch.float32).to(dev)
        y = torch.as_tensor(git_grids[i:i + batch_size],
                            dtype=torch.float32).to(dev)
        losses.append(torch.mean((projector(x).float() - y) ** 2))
    return float(np.mean(torch.stack(losses).cpu().numpy(), dtype=np.float64))
