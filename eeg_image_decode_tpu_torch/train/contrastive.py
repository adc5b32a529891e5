"""Contrastive retrieval/reconstruction trainer (counterpart of
``eeg_image_decode_tpu/train/contrastive.py``; ref
``Retrieval/ATMS_retrieval.py:199-512``).

- **The split stays on the card.** One subject's train split (66,160 × 63 ×
  250 fp32, 4.2 GB) is resident (:class:`DeviceData`); each epoch is a
  permutation (:func:`epoch_permutation`, the JAX package's numpy formula,
  so both trainers see the same batches) and one index gather per step: no
  host↔device traffic per step and no per-step sync. The loss is read back
  once per epoch.
- **bf16 compute, fp32 state.** Parameters, AdamW state, BatchNorm
  statistics and the loss are fp32; the model computes in the dtype it was
  built with (``build_encoder(dtype=torch.bfloat16)``).
- **AdamW over every parameter**, the logit scale included (``optax.adamw``
  with no mask: lr 3e-4, weight decay 0.01, β (0.9, 0.999), ε 1e-8).
  PyTorch updates the parameters in place.
- **Train-time probe**: 1654-way class accuracy against one image feature
  per class (``ATMS_retrieval.py:202,241-250``).

- **Checkpoints and resume.** With a ``checkpointer``
  (``core/checkpoint.py``) the full train state is saved every
  ``ckpt_every_epochs`` epochs and after the last; ``resume()`` restores it
  and the completed rows of ``results.csv``. Each epoch's permutation and
  generator derive from (seed, epoch), so a resumed run reproduces the
  uninterrupted one.

On the card an ATM-S step runs the attention layer's forward and backward
kernels (seed-mode dropout drawn in the kernels), the tsconv kernels and,
under ``ATMSConfig(fused_projection=True)``, the projection head's; a NICE
step runs the tsconv kernels, and the zoo's other encoders are plain
PyTorch; there is no fallback. The mesh, ``streaming`` and ``shard_samples`` are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import csv
import math
import os
import time
import warnings
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from eeg_image_decode_tpu_torch.core.checkpoint import TrainState
from eeg_image_decode_tpu_torch.core.config import ContrastiveTrainConfig
from eeg_image_decode_tpu_torch.data.things_eeg import EEGRetrievalData
from eeg_image_decode_tpu_torch.losses import (
    reconstruction_loss,
    retrieval_loss,
)
from eeg_image_decode_tpu_torch.train.evaluator import retrieval_eval
from eeg_image_decode_tpu_torch.utils.device import resolve_device


def create_train_state(model: torch.nn.Module,
                       cfg: ContrastiveTrainConfig) -> TrainState:
    """AdamW over every parameter of ``model``, as ``optax.adamw(cfg.lr,
    weight_decay=cfg.weight_decay)``. BatchNorm statistics are buffers."""
    opt = torch.optim.AdamW(model.parameters(), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    return TrainState(model=model, optimizer=opt)


@dataclass
class DeviceData:
    """Device-resident training arrays."""

    eeg: torch.Tensor             # (N, C, T) fp32
    labels: torch.Tensor          # (N,)
    subject_ids: torch.Tensor     # (N,)
    img_feat: torch.Tensor        # (n_imgs, D) per-image targets
    text_feat: torch.Tensor       # (n_cls, D)
    img_idx: torch.Tensor         # (N,)
    text_idx: torch.Tensor        # (N,)
    class_img_feat: torch.Tensor  # (n_cls, D) probe features

    @staticmethod
    def from_host(data: EEGRetrievalData, device) -> "DeviceData":
        """The split on ``device``; arrays already there are not copied."""
        def put(a, dtype):
            return torch.as_tensor(a).to(device=device, dtype=dtype)

        f32, i64 = torch.float32, torch.int64
        return DeviceData(
            eeg=put(data.eeg, f32), labels=put(data.labels, i64),
            subject_ids=put(data.subject_ids, i64),
            img_feat=put(data.img_features, f32),
            text_feat=put(data.text_features, f32),
            img_idx=put(data.img_idx, i64), text_idx=put(data.text_idx, i64),
            class_img_feat=put(data.class_img_features(), f32))


def epoch_permutation(n: int, batch: int, seed: int, epoch: int) -> np.ndarray:
    """The (seed, epoch) → (n_steps, batch) shuffled batch-index schedule of
    the JAX trainer (the same numpy formula, so both see the same batches)."""
    n_steps = n // batch
    rng = np.random.default_rng(seed * 100003 + epoch)
    return (rng.permutation(n)[: n_steps * batch]
            .reshape(n_steps, batch).astype(np.int32))


def _batch(data: DeviceData, idx: torch.Tensor) -> dict:
    return {
        "eeg": data.eeg.index_select(0, idx),
        "subject_ids": data.subject_ids.index_select(0, idx),
        "img_feat": data.img_feat.index_select(
            0, data.img_idx.index_select(0, idx)),
        "text_feat": data.text_feat.index_select(
            0, data.text_idx.index_select(0, idx)),
        "labels": data.labels.index_select(0, idx),
    }


def batch_loss(model: torch.nn.Module, cfg: ContrastiveTrainConfig,
               batch: dict, *, generator=None, dropout_masks=None):
    """(loss, fp32 features) of one batch through the model's current mode:
    the trainer's objective (retrieval, or reconstruction)."""
    feats, scale = model(batch["eeg"], batch["subject_ids"],
                         generator=generator, dropout_masks=dropout_masks)
    feats = feats.float()
    if cfg.recon_loss:
        loss = reconstruction_loss(feats, batch["img_feat"], scale,
                                   alpha=cfg.recon_alpha)
    else:
        loss = retrieval_loss(feats, batch["img_feat"], batch["text_feat"],
                              scale, alpha=cfg.alpha)
    return loss, feats


def make_epoch_fn(cfg: ContrastiveTrainConfig) -> Callable:
    """The one-epoch function ``(state, data, perm (n_steps, B) on the
    device, generator) → metrics``. It trains ``state.model`` in place.

    Metrics: ``loss`` and ``train_acc`` (epoch means, device tensors),
    ``step_loss`` (n_steps,), and on a CUDA device ``step_ms``, each step's
    time between CUDA events (read after the epoch's one sync)."""

    def epoch_fn(state: TrainState, data: DeviceData, perm: torch.Tensor,
                 generator: torch.Generator | None) -> dict:
        model, opt = state.model, state.optimizer
        model.train()
        n_steps = perm.shape[0]
        dev = data.eeg.device
        losses = torch.empty(n_steps, device=dev)
        accs = torch.empty(n_steps, device=dev)
        timed = dev.type == "cuda"
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(n_steps + 1)] if timed else []
        if timed:
            events[0].record()
        for s in range(n_steps):
            batch = _batch(data, perm[s].to(dev, torch.int64))
            loss, feats = batch_loss(model, cfg, batch, generator=generator)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            state.step += 1
            with torch.no_grad():
                # train-time class-accuracy probe (ref :241-250)
                pred = torch.matmul(feats, data.class_img_feat.T).argmax(1)
                accs[s] = (pred == batch["labels"]).float().mean()
                losses[s] = loss.detach()
            if timed:
                events[s + 1].record()
        out = {"loss": losses.mean(), "train_acc": accs.mean(),
               "step_loss": losses}
        if timed:
            events[-1].synchronize()
            out["step_ms"] = [a.elapsed_time(b)
                              for a, b in zip(events[:-1], events[1:])]
        return out

    return epoch_fn


def make_eval_features_fn(model: torch.nn.Module,
                          batch_size: int = 200) -> Callable:
    """Eval-mode feature extractor: ``(eeg, subject_ids)`` tensors on the
    model's device → (fp32 features, logit scale), in chunks of
    ``batch_size``."""

    @torch.no_grad()
    def eval_features(eeg: torch.Tensor, subject_ids: torch.Tensor):
        model.eval()
        feats, scale = [], None
        for lo in range(0, eeg.shape[0], batch_size):
            f, scale = model(eeg[lo:lo + batch_size],
                             subject_ids[lo:lo + batch_size])
            feats.append(f.float())
        return torch.cat(feats), scale

    return eval_features


class ContrastiveTrainer:
    """Epochs → eval → CSV metrics, mirroring ``main_train_loop``
    (``ATMS_retrieval.py:364-512``).

    ``model``: a ``ContrastiveModel`` (``build_encoder``), moved to
    ``device`` (default: the CUDA card, raising without one;
    ``device="cpu"`` runs the plain versions on the CPU). ``train_data`` and
    ``test_data``: :class:`EEGRetrievalData` with numpy arrays or tensors
    already on the device. ``checkpointer``: a
    ``core/checkpoint.py::Checkpointer``; see :meth:`fit` and
    :meth:`resume`."""

    def __init__(self, model: torch.nn.Module, cfg: ContrastiveTrainConfig,
                 train_data: EEGRetrievalData, test_data: EEGRetrievalData,
                 *, output_dir: str | None = None, checkpointer=None,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.output_dir = output_dir
        self.checkpointer = checkpointer
        self.train_host = train_data
        self.data = DeviceData.from_host(train_data, self.device)
        test = DeviceData.from_host(test_data, self.device)
        self.test_eeg = test.eeg
        self.test_subject_ids = test.subject_ids
        self.test_labels = test.labels
        self.test_class_img_feat = test.class_img_feat
        self.state = create_train_state(self.model, cfg)
        self.epoch_fn = make_epoch_fn(cfg)
        self.eval_fn = make_eval_features_fn(self.model)
        self.history: list[dict] = []
        self.start_epoch = 0
        #: per-step losses (and CUDA-event times) of the last epoch
        self.last_steps: dict = {}

    def resume(self, step: int | None = None) -> int:
        """Restore the full train state (parameters, BatchNorm statistics,
        optimizer state, step) from the checkpointer and reload the
        completed rows of ``results.csv``, so ``fit()`` continues with the
        next epoch. Returns the epoch training continues from."""
        if self.checkpointer is None:
            raise ValueError("resume needs a checkpointer")
        step = self.checkpointer.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no checkpoints under {self.checkpointer.directory}")
        self.checkpointer.restore(step, self.state)
        self.start_epoch = int(step)  # save key = completed epoch count
        if self.output_dir:
            path = os.path.join(self.output_dir, "results.csv")
            if os.path.exists(path):
                with open(path, newline="") as f:
                    rows = list(csv.DictReader(f))
                self.history = [
                    {k: (int(v) if k == "epoch" else float(v))
                     for k, v in row.items() if v != ""}
                    for row in rows
                    if row.get("epoch", "") != ""
                    and int(row["epoch"]) < self.start_epoch
                ]
        return self.start_epoch

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def train_epoch(self, epoch: int) -> dict:
        n, bs = int(self.data.eeg.shape[0]), self.cfg.batch_size
        perm = torch.as_tensor(
            epoch_permutation(n, bs, self.cfg.seed, epoch),
            device=self.device)
        t0 = time.perf_counter()
        out = self.epoch_fn(self.state, self.data, perm,
                            self._generator(self.cfg.seed + 7919 * epoch))
        metrics = {"loss": float(out["loss"]),  # the epoch's one sync
                   "train_acc": float(out["train_acc"])}
        metrics["epoch_time_s"] = time.perf_counter() - t0
        metrics["samples_per_s"] = perm.numel() / metrics["epoch_time_s"]
        self.last_steps = {"step_loss": out["step_loss"].tolist(),
                           "step_ms": out.get("step_ms")}
        return metrics

    def evaluate(self, epoch: int = 0) -> dict:
        feats, scale = self.eval_fn(self.test_eeg, self.test_subject_ids)
        out = retrieval_eval(
            feats, self.test_class_img_feat, self.test_labels, scale,
            ks=self.cfg.eval_ks,
            generator=self._generator(self.cfg.seed + 104729 * epoch))
        return {k: float(v) for k, v in out.items()}

    def fit(self, epochs: int | None = None, log_fn=print) -> list[dict]:
        """Epochs ``start_epoch … epochs−1``: train, evaluate, append the
        row, save a checkpoint every ``ckpt_every_epochs`` epochs (and after
        the last), rewrite ``results.csv``; at the end, with an
        ``output_dir``, draw ``summary.png``."""
        epochs = epochs or self.cfg.epochs
        for epoch in range(self.start_epoch, epochs):
            train_metrics = self.train_epoch(epoch)
            if not math.isfinite(train_metrics["loss"]):
                # abort before the checkpointer persists a poisoned state
                # (the reference's finite-loss guard, models/util.py:92-94)
                raise FloatingPointError(
                    f"non-finite training loss {train_metrics['loss']} at "
                    f"epoch {epoch}; the last checkpoint is still clean")
            eval_metrics = self.evaluate(epoch)
            row = {"epoch": epoch, **train_metrics, **eval_metrics}
            self.history.append(row)
            if log_fn:
                k200 = eval_metrics.get("top1_k200",
                                        eval_metrics.get("top1_k2", 0))
                log_fn(f"epoch {epoch}: loss={train_metrics['loss']:.4f} "
                       f"train_acc={train_metrics['train_acc']:.4f} "
                       f"test_top1={k200:.4f} "
                       f"({train_metrics['samples_per_s']:.0f} samples/s)")
            if (self.checkpointer is not None
                    and (epoch + 1) % self.cfg.ckpt_every_epochs == 0):
                self.checkpointer.save(epoch + 1, self.state)
            if self.output_dir:
                self._write_csv()  # kept current so a killed run can resume
        if (self.checkpointer is not None and epochs > self.start_epoch
                and self.checkpointer.latest_step() != epochs):
            self.checkpointer.save(epochs, self.state)  # final state
        if self.output_dir:
            self._plot_summary()
        return self.history

    def _plot_summary(self) -> None:
        """``summary.png``, the reference's ``pos_img_text.png`` panel
        (``ATMS_retrieval.py:462-510``). Best-effort, as in the JAX
        trainer: a finished run does not fail on its plot (matplotlib may
        be absent), it warns."""
        path = os.path.join(self.output_dir, "summary.png")
        try:
            from eeg_image_decode_tpu_torch.utils.plotting import (
                plot_training_summary,
            )
            plot_training_summary(self.history, path)
        except Exception as e:  # the run itself succeeded
            warnings.warn(f"{path} not written: {e!r}", stacklevel=2)

    def extract_features(self, eeg, subject_ids,
                         batch_size: int = 2048) -> np.ndarray:
        """EEG epochs → encoder features (the reference's
        ``get_eegfeatures`` export), as numpy."""
        eeg = torch.as_tensor(eeg).to(self.device, torch.float32)
        sids = torch.as_tensor(subject_ids).to(self.device, torch.int64)
        chunks = []
        for lo in range(0, eeg.shape[0], batch_size):
            f, _ = self.eval_fn(eeg[lo:lo + batch_size],
                                sids[lo:lo + batch_size])
            chunks.append(f.cpu().numpy())
        return np.concatenate(chunks, axis=0)

    def export_features(self, path: str) -> str:
        """Save train and test EEG features with the aligned CLIP targets as
        one ``.npz``: the artifact the diffusion-prior trainer consumes (the
        reference's ``ATM_S_eeg_features_sub-08{,_test}.pt`` pair)."""
        def host(a):
            return (a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a))

        train_feats = self.extract_features(self.data.eeg,
                                            self.data.subject_ids)
        test_feats = self.extract_features(self.test_eeg,
                                           self.test_subject_ids)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(
            path, eeg_features=train_feats, eeg_features_test=test_feats,
            img_features=host(self.train_host.img_features)[
                host(self.train_host.img_idx)],
            labels_test=host(self.test_labels))
        return path

    def _write_csv(self) -> None:
        os.makedirs(self.output_dir, exist_ok=True)
        path = os.path.join(self.output_dir, "results.csv")
        if not self.history:
            return
        keys = sorted({k for row in self.history for k in row})
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(self.history)
