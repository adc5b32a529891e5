"""Low-level (VAE-latent) trainer (counterpart of
``eeg_image_decode_tpu/train/lowlevel.py``; ref
``Generation/train_vae_latent_512_low_level_no_average.py:265-344,490-545``).

L1 regression from EEG epochs to cached SDXL VAE latents, one latent per
EEG trial; AdamW 1e-3 with weight decay 0.01 (torch's default, which the
reference inherits; applied as optax does, ``train/optim.py``); batch 30.
The learning rate is the reference's ``CosineAnnealingLR(T_max=epochs,
eta_min=1e-6)`` stepped once per epoch, a staircase, always (the JAX
trainer's ``init()`` without ``steps_per_epoch`` falls back to a smooth
per-step cosine; the port has no such fork). The EEG and the latents stay
on the card; each epoch is a permutation (``default_rng(seed·7907 +
epoch)``, the JAX formula) and one gather per step, and the loss is read
back once per epoch.

The products run in full fp32: the trainer sets
``torch.backends.cuda.matmul.allow_tf32`` to False and runs its steps
under cuDNN's ``allow_tf32=False`` (PyTorch's defaults are False and
True), so the transposed convolutions round where the JAX reference does;
and under cuDNN's ``deterministic=True``, so a run and its resumed copy
take the same algorithms and give the same bits. Plain PyTorch: no TPU
kernel lies on this path.

Under a ``mesh`` (``core/mesh.py``) training is data parallel as the JAX
trainer's GSPMD epoch is: the EEG and the latents stay whole on every rank,
each rank takes its B/dp columns of the permutation, BatchNorm's two passes
run over the global batch (``models/lowlevel.py``), and the gradients are
averaged over the dp group before AdamW; the loss read back is the dp mean.
Rank 0 writes the checkpoints and the previews.

With :meth:`LowLevelTrainer.set_preview_decoder` the trainer decodes a few
predicted latents through a frozen SDXL VAE (``gen/vae.py``) to PNGs every
``preview_every`` epochs and after the last, as the reference does during
training (``:309-323,375-397``): ``preview_dir/epoch_%04d/%02d.png``.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from eeg_image_decode_tpu_torch.core.checkpoint import (
    TrainState,
    load_history,
    save_history,
)
from eeg_image_decode_tpu_torch.core.config import LowLevelConfig
from eeg_image_decode_tpu_torch.core.mesh import validate_dp_batch
from eeg_image_decode_tpu_torch.models.lowlevel import EncoderLowLevel
from eeg_image_decode_tpu_torch.parallel.collectives import (
    data_parallel,
    mean_over_ranks,
    pmean_tree,
)
from eeg_image_decode_tpu_torch.train.optim import OptaxAdam
from eeg_image_decode_tpu_torch.utils.device import resolve_device

#: the reference's CosineAnnealingLR floor (``:407``)
ETA_MIN = 1e-6
#: cuDNN settings of every step and prediction: full fp32, fixed algorithms
CUDNN_FLAGS = dict(enabled=True, benchmark=False, deterministic=True,
                   allow_tf32=False)


def cosine_staircase(lr: float, epoch: int, t_max: int) -> float:
    """η_min + (lr − η_min)(1 + cos(π·epoch/T))/2: ``CosineAnnealingLR``
    stepped once per epoch."""
    return ETA_MIN + (lr - ETA_MIN) * 0.5 * (
        1.0 + math.cos(math.pi * epoch / t_max))


class LowLevelTrainer:
    """The trainer on ``device`` (default: the CUDA card; raises without
    one; ``device="cpu"`` for the CPU). ``model``: an
    :class:`EncoderLowLevel` (default: the published widths of ``cfg``).
    ``mesh``: data parallel over its dp group, on its device."""

    def __init__(self, cfg: LowLevelConfig = LowLevelConfig(), *,
                 model: EncoderLowLevel | None = None, device=None,
                 mesh=None):
        self.mesh = mesh
        self.is_writer = mesh is None or mesh.rank == 0
        self.device = resolve_device(mesh.device if mesh is not None
                                     and device is None else device)
        # full fp32 products: no TF32 in matmuls (cuDNN: CUDNN_FLAGS)
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.model = (model or EncoderLowLevel(
            n_channels=cfg.n_channels, seq_len=cfg.seq_len,
            time_proj_dim=cfg.time_proj_dim,
            latent_channels=cfg.latent_shape[0])).to(self.device)
        self.state: TrainState | None = None
        self._preview: dict | None = None
        #: the last epoch's per-step losses and, on a CUDA device,
        #: CUDA-event step times (ms)
        self.last_steps: dict = {}

    def init(self, total_steps: int, steps_per_epoch: int,
             seed: int = 0) -> TrainState:
        """Fresh weights (flax's default init from ``seed``) and AdamW on
        the per-epoch staircase over total_steps // steps_per_epoch
        epochs."""
        self.model.reset_parameters(seed)
        t_max = max(total_steps // steps_per_epoch, 1)
        lr = self.cfg.lr
        opt = OptaxAdam(
            self.model.parameters(),
            lambda k: cosine_staircase(lr, k // steps_per_epoch, t_max),
            weight_decay=0.01)
        self.state = TrainState(model=self.model, optimizer=opt)
        return self.state

    def set_preview_decoder(self, vae, *, preview_dir: str,
                            preview_every: int = 10, n_previews: int = 4
                            ) -> None:
        """Install a frozen VAE (``gen/vae.py::VAE`` with weights, moved to
        the trainer's device) so ``train()`` decodes the predictions of the
        first ``n_previews`` training trials to PNGs every
        ``preview_every`` epochs and after the last (the reference's
        training-time sample decode)."""
        self._preview = {"vae": vae.to(self.device).eval(),
                         "dir": preview_dir, "every": max(1, preview_every),
                         "n": n_previews}

    @torch.no_grad()
    def _write_previews(self, epoch: int, eeg: torch.Tensor) -> None:
        from PIL import Image

        p = self._preview
        self.model.eval()
        with torch.backends.cudnn.flags(**CUDNN_FLAGS):
            lat = self.model(eeg[: p["n"]])
        img = p["vae"].decode(lat.float())
        imgs = torch.clamp(img * 0.5 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)
        out = os.path.join(p["dir"], f"epoch_{epoch:04d}")
        os.makedirs(out, exist_ok=True)
        for i, im in enumerate(imgs.cpu().numpy()):
            Image.fromarray((im * 255).astype(np.uint8)).save(
                os.path.join(out, f"{i:02d}.png"))

    def _as_nchw(self, latents: torch.Tensor) -> torch.Tensor:
        """NCHW (the cached torch layout) as it is; NHWC transposed."""
        c = self.cfg.latent_shape[0]
        if latents.ndim == 4 and latents.shape[1] == c:
            return latents
        if latents.ndim == 4 and latents.shape[-1] == c:
            return latents.permute(0, 3, 1, 2).contiguous()
        raise ValueError(f"latents of shape {tuple(latents.shape)}: want "
                         f"(N, {c}, H, W) or (N, H, W, {c})")

    def train_epoch(self, epoch: int, eeg: torch.Tensor, lat: torch.Tensor,
                    batch_size: int, seed: int) -> torch.Tensor:
        """One epoch over the device-resident EEG and NCHW latents; returns
        the per-step L1 losses (device)."""
        model, dev = self.model, self.device
        n = eeg.shape[0]
        n_steps = max(n // batch_size, 1)
        rng = np.random.default_rng(seed * 7907 + epoch)
        perm = rng.permutation(n)[: n_steps * batch_size].reshape(
            n_steps, batch_size)
        if self.mesh is not None:  # this rank's columns
            perm = perm[:, self.mesh.rows(batch_size)]
        perm = torch.as_tensor(np.ascontiguousarray(perm), device=dev)
        losses = torch.empty(n_steps, device=dev)
        timed = dev.type == "cuda"
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(n_steps + 1)] if timed else []
        if timed:
            events[0].record()
        model.train()
        with torch.backends.cudnn.flags(**CUDNN_FLAGS):
            self._steps(perm, eeg, lat, losses, events)
        model.eval()
        self.last_steps = {"step_loss": losses, "step_ms": None}
        if timed:
            events[-1].synchronize()
            self.last_steps["step_ms"] = [
                a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
        return losses

    def _steps(self, perm, eeg, lat, losses, events) -> None:
        model, opt = self.model, self.state.optimizer
        for s in range(perm.shape[0]):
            idx = perm[s]
            with data_parallel(self.mesh):
                pred = model(eeg.index_select(0, idx), train=True)
            loss = torch.mean(torch.abs(pred - lat.index_select(0, idx)))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if self.mesh is not None:
                pmean_tree(model.parameters(), self.mesh)
            opt.step()
            self.state.step += 1
            losses[s] = (loss.detach() if self.mesh is None
                         else mean_over_ranks(loss, self.mesh))
            if events:
                events[s + 1].record()

    def train(self, eeg, latents, *, epochs: int | None = None,
              batch_size: int | None = None, seed: int = 0, log_fn=print,
              checkpointer=None, ckpt_every_epochs: int = 10,
              resume: bool = False) -> list[dict]:
        """``eeg`` (N, C, T) and ``latents`` (N, 4, 64, 64) NCHW or
        (N, 64, 64, 4) NHWC, one latent per EEG trial (numpy or tensors; put
        on the device once). A count mismatch raises before training. With
        a ``checkpointer`` the full state (weights, BatchNorm statistics,
        AdamW moments and count, step) is saved every ``ckpt_every_epochs``
        epochs and after the last; ``resume=True`` restores the latest and
        continues: epoch-keyed permutations make the resumed run repeat the
        uninterrupted one."""
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        n = int(eeg.shape[0])
        if int(latents.shape[0]) != n:
            raise ValueError(
                f"{n} EEG trials against {int(latents.shape[0])} latents: the "
                "low-level trainer pairs trial i with latent i, so the "
                "latents file needs one latent per trial (per-image latents "
                "repeated over the repetitions)")
        batch_size = min(batch_size or cfg.batch_size, n)
        validate_dp_batch(self.mesh, batch_size)
        n_steps = max(n // batch_size, 1)
        if self.state is None:
            self.init(total_steps=n_steps * epochs, steps_per_epoch=n_steps,
                      seed=seed)
        start_epoch, history = 0, []
        if resume:
            if checkpointer is None:
                raise ValueError("resume=True needs a checkpointer")
            step = checkpointer.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {checkpointer.directory}")
            checkpointer.restore(step, self.state)
            start_epoch = int(step)
            history = load_history(checkpointer, start_epoch)
        eeg_all = torch.as_tensor(eeg).to(self.device, torch.float32)
        lat_all = self._as_nchw(
            torch.as_tensor(latents).to(self.device, torch.float32))
        for epoch in range(start_epoch, epochs):
            t0 = time.perf_counter()
            loss = float(self.train_epoch(epoch, eeg_all, lat_all, batch_size,
                                          seed).mean())  # the epoch's sync
            if not np.isfinite(loss):
                raise FloatingPointError(
                    f"non-finite low-level loss {loss} at epoch {epoch}")
            history.append({"epoch": epoch, "loss": loss,
                            "epoch_time_s": time.perf_counter() - t0})
            if log_fn and self.is_writer and epoch % max(1, epochs // 10) == 0:
                log_fn(f"lowlevel epoch {epoch}: L1={loss:.4f}")
            if (self._preview and self.is_writer
                    and (epoch + 1) % self._preview["every"] == 0):
                self._write_previews(epoch, eeg_all)
            if (checkpointer is not None and self.is_writer
                    and (epoch + 1) % ckpt_every_epochs == 0):
                checkpointer.save(epoch + 1, self.state)
                save_history(checkpointer, history)
        if (checkpointer is not None and self.is_writer
                and epochs > start_epoch):
            if checkpointer.latest_step() != epochs:
                checkpointer.save(epochs, self.state)
            save_history(checkpointer, history)
        if (self._preview and self.is_writer and epochs > start_epoch
                and epochs % self._preview["every"] != 0):
            self._write_previews(epochs - 1, eeg_all)  # final previews
        return history

    @torch.no_grad()
    def predict(self, eeg) -> torch.Tensor:
        """EEG → predicted VAE latents, NHWC (N, 64, 64, 4) as the JAX
        trainer returns them, on the device."""
        assert self.state is not None, "train or init the trainer first"
        self.model.eval()
        x = torch.as_tensor(eeg).to(self.device, torch.float32)
        with torch.backends.cudnn.flags(**CUDNN_FLAGS):
            return self.model(x).permute(0, 2, 3, 1)
