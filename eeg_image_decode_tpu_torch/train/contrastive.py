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
PyTorch; there is no fallback.

- **Streaming** (``streaming=True``): the EEG stays in host RAM and
  ``data/loader.py::PrefetchLoader`` gathers each batch into pinned memory
  and copies it to the card while the previous step computes
  (``cfg.host_dtype="bfloat16"`` keeps the host copy in bf16, half the bytes
  a batch); the CLIP feature tables and the test split stay on the card.
  The batches, the generator and the step are the resident mode's, so the
  two modes train the same run.
- **Data parallel** (``mesh=``, ``core/mesh.py``): the step of the global
  batch, as the JAX trainer's GSPMD program computes it. Each rank takes its
  B/dp columns of the epoch's permutation, runs the model on its rows inside
  ``parallel/collectives.py::data_parallel`` (BatchNorm's statistics over
  the global batch, the dropout masks drawn for it, the kernels' seeded
  masks at the rank's global sample offset), gathers the features and the
  batch's target indices from every rank, and computes the global loss and
  probe on the gathered batch; the parameter gradients are averaged over
  the dp group before AdamW. ``shard_samples=True`` keeps only the rank's
  N/dp rows of the split on its card, batches drawn shard-locally
  (:func:`sharded_epoch_perm`, the JAX arrays); ``streaming`` streams the
  rank's B/dp rows a step. Only rank 0 writes ``results.csv``, checkpoints,
  ``summary.png`` and exported features; every rank can ``resume()`` from
  the same checkpoint.
"""

from __future__ import annotations

import csv
import math
import os
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np
import torch

from eeg_image_decode_tpu_torch.core.checkpoint import TrainState
from eeg_image_decode_tpu_torch.core.config import ContrastiveTrainConfig
from eeg_image_decode_tpu_torch.core.mesh import validate_dp_batch
from eeg_image_decode_tpu_torch.data.loader import PrefetchLoader
from eeg_image_decode_tpu_torch.data.things_eeg import EEGRetrievalData
from eeg_image_decode_tpu_torch.losses import (
    reconstruction_loss,
    retrieval_loss,
)
from eeg_image_decode_tpu_torch.parallel.collectives import (
    all_gather_rows,
    data_parallel,
    gather_rows,
    pmean_tree,
)
from eeg_image_decode_tpu_torch.parallel.multihost import process_local_slice
from eeg_image_decode_tpu_torch.train.evaluator import retrieval_eval
from eeg_image_decode_tpu_torch.utils import profiling
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
    def from_host(data: EEGRetrievalData, device, *,
                  rows: slice = slice(None)) -> "DeviceData":
        """The split on ``device``; arrays already there are not copied.
        ``rows``: the per-sample arrays' rows to keep (a rank's shard in
        ``shard_samples`` mode); the feature tables are kept whole."""
        def put(a, dtype, sl=slice(None)):
            return torch.as_tensor(a)[sl].to(device=device, dtype=dtype)

        f32, i64 = torch.float32, torch.int64
        return DeviceData(
            eeg=put(data.eeg, f32, rows), labels=put(data.labels, i64, rows),
            subject_ids=put(data.subject_ids, i64, rows),
            img_feat=put(data.img_features, f32),
            text_feat=put(data.text_features, f32),
            img_idx=put(data.img_idx, i64, rows),
            text_idx=put(data.text_idx, i64, rows),
            class_img_feat=put(data.class_img_features(), f32))


def epoch_permutation(n: int, batch: int, seed: int, epoch: int) -> np.ndarray:
    """The (seed, epoch) → (n_steps, batch) shuffled batch-index schedule of
    the JAX trainer (the same numpy formula, so both see the same batches)."""
    n_steps = n // batch
    rng = np.random.default_rng(seed * 100003 + epoch)
    return (rng.permutation(n)[: n_steps * batch]
            .reshape(n_steps, batch).astype(np.int32))


def sharded_epoch_perm(n: int, batch: int, dp: int, seed: int,
                       epoch: int) -> np.ndarray:
    """The shard-local (n_steps, batch) schedule of ``shard_samples``
    mode (the JAX trainer's formula): column block d (width batch/dp) holds
    indices into rank d's shard [0, n/dp), each rank an independent
    permutation of its own shard per epoch, so every sample is visited once
    an epoch."""
    if n % dp or batch % dp:
        raise ValueError(
            f"n={n} and batch={batch} must both be divisible by the "
            f"data-parallel axis (dp={dp})")
    n_local, b_local = n // dp, batch // dp
    n_steps = n // batch
    cols = []
    for d in range(dp):
        rng = np.random.default_rng(seed * 100003 + epoch * 1009 + d)
        cols.append(rng.permutation(n_local)[: n_steps * b_local]
                    .reshape(n_steps, b_local))
    return np.concatenate(cols, axis=1).astype(np.int32)


def sharded_perm_rows(perm: np.ndarray, n: int, dp: int) -> np.ndarray:
    """The global rows of a :func:`sharded_epoch_perm` schedule: column
    block d's local index i is row d·n/dp + i of the split."""
    b_local = perm.shape[1] // dp
    shard = np.arange(perm.shape[1]) // b_local
    return (perm + shard[None, :] * (n // dp)).astype(np.int32)


#: the per-sample arrays of a batch; the feature rows come from the tables
SAMPLE_FIELDS = ("eeg", "subject_ids", "img_idx", "text_idx", "labels")


def with_features(rows: dict, img_feat: torch.Tensor,
                  text_feat: torch.Tensor, mesh=None) -> dict:
    """A step's batch from its per-sample rows (on the device): the EEG in
    fp32 (a bf16 host copy is upcast here), the subject ids and labels, and
    the two feature rows gathered from the tables by ``img_idx`` and
    ``text_idx``. Under a ``mesh`` the rows are the rank's; the labels and
    the feature rows are the global batch's (one all-gather of the three
    index columns), what the loss and the probe take."""
    idx = torch.stack([rows["img_idx"], rows["text_idx"], rows["labels"]],
                      dim=1)
    if mesh is not None:
        idx = all_gather_rows(idx, mesh.dp_group)
    return {
        "eeg": rows["eeg"].float(),
        "subject_ids": rows["subject_ids"],
        "img_feat": img_feat.index_select(0, idx[:, 0]),
        "text_feat": text_feat.index_select(0, idx[:, 1]),
        "labels": idx[:, 2],
    }


def _batch(data: DeviceData, idx: torch.Tensor, mesh=None) -> dict:
    return with_features(
        {k: getattr(data, k).index_select(0, idx) for k in SAMPLE_FIELDS},
        data.img_feat, data.text_feat, mesh)


def batch_loss(model: torch.nn.Module, cfg: ContrastiveTrainConfig,
               batch: dict, *, generator=None, dropout_masks=None,
               mesh=None):
    """(loss, fp32 features) of one batch through the model's current mode:
    the trainer's objective (retrieval, or reconstruction). Under a
    ``mesh`` the model runs on the rank's rows in a data-parallel scope and
    the loss on the gathered features of the global batch (the batch's
    feature rows are global already: :func:`with_features`)."""
    with data_parallel(mesh):
        feats, scale = model(batch["eeg"], batch["subject_ids"],
                             generator=generator,
                             dropout_masks=dropout_masks)
    feats = feats.float()
    if mesh is not None:
        feats = gather_rows(feats, mesh)
    if cfg.recon_loss:
        loss = reconstruction_loss(feats, batch["img_feat"], scale,
                                   alpha=cfg.recon_alpha)
    else:
        loss = retrieval_loss(feats, batch["img_feat"], batch["text_feat"],
                              scale, alpha=cfg.alpha)
    return loss, feats


def train_steps(state: TrainState, cfg: ContrastiveTrainConfig,
                batches: Iterable[dict], n_steps: int,
                class_img_feat: torch.Tensor,
                generator: torch.Generator | None, mesh=None) -> dict:
    """The training step over ``n_steps`` batches (:func:`with_features`
    dicts on the device), resident or streamed: AdamW on ``state`` in place,
    the loss and the probe accuracy kept on the device. Under a ``mesh``
    the gradients are averaged over the dp group before the update, and the
    loss and the probe are the global batch's (the same on every rank).

    Returns ``loss`` and ``train_acc`` (epoch means, device tensors),
    ``step_loss`` (n_steps,), and on a CUDA device ``step_ms``, each step's
    time between CUDA events (read after the epoch's one sync). Each step
    is a ``train.step`` span (``utils/profiling.py``) holding
    ``train.forward`` (:func:`batch_loss`), ``train.backward`` (the
    gradients, averaged over the dp group under a mesh) and
    ``train.optimizer`` (AdamW's step), host time each; the gradients are
    cleared between the forward and the backward, outside any of them."""
    model, opt = state.model, state.optimizer
    model.train()
    dev = class_img_feat.device
    losses = torch.empty(n_steps, device=dev)
    accs = torch.empty(n_steps, device=dev)
    timed = dev.type == "cuda"
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(n_steps + 1)] if timed else []
    if timed:
        events[0].record()
    s = -1
    for s, batch in enumerate(batches):
        with profiling.span("train.step"):
            with profiling.span("train.forward"):
                loss, feats = batch_loss(model, cfg, batch,
                                         generator=generator, mesh=mesh)
            opt.zero_grad(set_to_none=True)
            with profiling.span("train.backward"):
                loss.backward()
                if mesh is not None:
                    pmean_tree(model.parameters(), mesh)
            with profiling.span("train.optimizer"):
                opt.step()
            state.step += 1
            with torch.no_grad():
                # train-time class-accuracy probe (ref :241-250)
                pred = torch.matmul(feats, class_img_feat.T).argmax(1)
                accs[s] = (pred == batch["labels"]).float().mean()
                losses[s] = loss.detach()
            if timed:
                events[s + 1].record()
    if s + 1 != n_steps:
        raise RuntimeError(f"{s + 1} batches for {n_steps} steps")
    out = {"loss": losses.mean(), "train_acc": accs.mean(),
           "step_loss": losses}
    if timed:
        events[-1].synchronize()
        out["step_ms"] = [a.elapsed_time(b)
                          for a, b in zip(events[:-1], events[1:])]
    return out


def make_epoch_fn(cfg: ContrastiveTrainConfig, mesh=None) -> Callable:
    """The resident one-epoch function ``(state, data, perm (n_steps, B) on
    the device, generator) →`` :func:`train_steps`' metrics, each batch
    gathered from ``data`` on the device. It trains ``state.model`` in
    place. Under a ``mesh`` ``perm`` holds the rank's B/dp columns (of
    ``epoch_permutation``, or of ``sharded_epoch_perm`` over a shard)."""

    def epoch_fn(state: TrainState, data: DeviceData, perm: torch.Tensor,
                 generator: torch.Generator | None) -> dict:
        dev = data.eeg.device
        batches = (_batch(data, perm[s].to(dev, torch.int64), mesh)
                   for s in range(perm.shape[0]))
        return train_steps(state, cfg, batches, perm.shape[0],
                           data.class_img_feat, generator, mesh)

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
    :meth:`resume`.

    ``streaming=True`` keeps the training EEG in host RAM and streams its
    batches through a :class:`PrefetchLoader` (``cfg.host_dtype``, the host
    copy's dtype); the feature tables and the test split stay on the
    device. The batch order, the generator and the step are the resident
    mode's, so both train the same run. :meth:`close` stops the loader.

    ``mesh`` (``core/mesh.py::create_mesh``): data-parallel training of the
    global batch over the mesh's dp group, on the mesh's device (every rank
    builds the trainer from the same model, seed and data).
    ``shard_samples=True`` (needs a mesh) keeps only the rank's N/dp rows of
    the split on its device; it and ``streaming`` exclude each other."""

    def __init__(self, model: torch.nn.Module, cfg: ContrastiveTrainConfig,
                 train_data: EEGRetrievalData, test_data: EEGRetrievalData,
                 *, output_dir: str | None = None, checkpointer=None,
                 device=None, streaming: bool = False, mesh=None,
                 shard_samples: bool = False):
        if streaming and shard_samples:
            raise ValueError(
                "streaming and shard_samples are mutually exclusive "
                "residency modes (host-streamed vs device-sharded)")
        if shard_samples and mesh is None:
            raise ValueError("shard_samples=True requires a mesh")
        validate_dp_batch(mesh, cfg.batch_size)
        self.mesh = mesh
        self.shard_samples = shard_samples
        #: rank 0 (or the one process) writes the run's files
        self.is_writer = mesh is None or mesh.rank == 0
        self.device = resolve_device(mesh.device if mesh is not None
                                     and device is None else device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.output_dir = output_dir
        self.checkpointer = checkpointer
        self.train_host = train_data
        self.streaming = streaming
        self.loader: PrefetchLoader | None = None
        if streaming:
            if train_data.n < cfg.batch_size:
                raise ValueError(
                    f"streaming mode drops the ragged final batch, so a "
                    f"dataset of n={train_data.n} samples yields ZERO "
                    f"batches at batch_size={cfg.batch_size}; lower "
                    f"batch_size to at most n")

            self.loader = PrefetchLoader(
                {k: torch.as_tensor(getattr(train_data, k)).to(
                    "cpu", torch.float32 if k == "eeg" else torch.int64)
                 for k in SAMPLE_FIELDS},
                cfg.batch_size, seed=cfg.seed, host_dtype=cfg.host_dtype,
                device=self.device,
                shard=(0, 1) if mesh is None else (mesh.dp_rank, mesh.dp))
            self.data = None
            self.img_feat, self.text_feat, self.class_img_feat = (
                torch.as_tensor(a).to(self.device, torch.float32)
                for a in (train_data.img_features, train_data.text_features,
                          train_data.class_img_features()))
        elif shard_samples:
            self.data = DeviceData.from_host(
                train_data, self.device,
                rows=process_local_slice(train_data.n, mesh))
        else:
            self.data = DeviceData.from_host(train_data, self.device)
        test = DeviceData.from_host(test_data, self.device)
        self.test_eeg = test.eeg
        self.test_subject_ids = test.subject_ids
        self.test_labels = test.labels
        self.test_class_img_feat = test.class_img_feat
        self.state = create_train_state(self.model, cfg)
        self.epoch_fn = make_epoch_fn(cfg, mesh)
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

    def close(self) -> None:
        """Stop the streaming loader: wait out its gathers and copies and
        end its thread. A resident trainer holds nothing to stop."""
        if self.loader is not None:
            self.loader.close()

    def epoch_perm(self, epoch: int) -> np.ndarray:
        """The epoch's (n_steps, B) schedule over the global batch:
        :func:`epoch_permutation`, or in ``shard_samples`` mode
        :func:`sharded_epoch_perm` (shard-local indices)."""
        n, bs = self.train_host.n, self.cfg.batch_size
        if self.shard_samples:
            return sharded_epoch_perm(n, bs, self.mesh.dp, self.cfg.seed,
                                      epoch)
        return epoch_permutation(n, bs, self.cfg.seed, epoch)

    def train_epoch(self, epoch: int, perm: np.ndarray | None = None
                    ) -> dict:
        """One epoch: the schedule of :meth:`epoch_perm`, or ``perm``
        (n_steps, B) given (resident modes), each rank taking its B/dp
        columns under a mesh. A ``train.epoch`` span, its sync included."""
        with profiling.span("train.epoch", epoch=epoch):
            return self._train_epoch(epoch, perm)

    def _train_epoch(self, epoch: int, perm: np.ndarray | None) -> dict:
        bs = self.cfg.batch_size
        generator = self._generator(self.cfg.seed + 7919 * epoch)
        t0 = time.perf_counter()
        if self.streaming:
            # the loader permutes with epoch_permutation's formula, so both
            # modes see the same batches in the same order
            if perm is not None:
                raise ValueError("a streamed epoch takes the loader's order")
            n_steps = len(self.loader)
            batches = (with_features(rows, self.img_feat, self.text_feat,
                                     self.mesh)
                       for rows in self.loader.epoch(epoch))
            out = train_steps(self.state, self.cfg, batches, n_steps,
                              self.class_img_feat, generator, self.mesh)
        else:
            perm = self.epoch_perm(epoch) if perm is None else perm
            if self.mesh is not None:
                perm = perm[:, self.mesh.rows(perm.shape[1])]
            perm = torch.as_tensor(np.ascontiguousarray(perm),
                                   device=self.device)
            n_steps = perm.shape[0]
            out = self.epoch_fn(self.state, self.data, perm, generator)
        metrics = {"loss": float(out["loss"]),  # the epoch's one sync
                   "train_acc": float(out["train_acc"])}
        metrics["epoch_time_s"] = time.perf_counter() - t0
        metrics["samples_per_s"] = n_steps * bs / metrics["epoch_time_s"]
        self.last_steps = {"step_loss": out["step_loss"].tolist(),
                           "step_ms": out.get("step_ms")}
        return metrics

    def evaluate(self, epoch: int = 0) -> dict:
        """The test split's retrieval metrics: a ``train.evaluate`` span,
        its read of the device included."""
        with profiling.span("train.evaluate", epoch=epoch):
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
            if log_fn and self.is_writer:
                k200 = eval_metrics.get("top1_k200",
                                        eval_metrics.get("top1_k2", 0))
                log_fn(f"epoch {epoch}: loss={train_metrics['loss']:.4f} "
                       f"train_acc={train_metrics['train_acc']:.4f} "
                       f"test_top1={k200:.4f} "
                       f"({train_metrics['samples_per_s']:.0f} samples/s)")
            if (self.checkpointer is not None and self.is_writer
                    and (epoch + 1) % self.cfg.ckpt_every_epochs == 0):
                self.checkpointer.save(epoch + 1, self.state)
            if self.output_dir and self.is_writer:
                self._write_csv()  # kept current so a killed run can resume
        if (self.checkpointer is not None and self.is_writer
                and epochs > self.start_epoch
                and self.checkpointer.latest_step() != epochs):
            self.checkpointer.save(epochs, self.state)  # final state
        if self.output_dir and self.is_writer:
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
        eeg, sids = torch.as_tensor(eeg), torch.as_tensor(subject_ids)
        chunks = []
        for lo in range(0, eeg.shape[0], batch_size):  # host rows per chunk
            f, _ = self.eval_fn(
                eeg[lo:lo + batch_size].to(self.device, torch.float32),
                sids[lo:lo + batch_size].to(self.device, torch.int64))
            chunks.append(f.cpu().numpy())
        return np.concatenate(chunks, axis=0)

    def export_features(self, path: str) -> str | None:
        """Save train and test EEG features with the aligned CLIP targets as
        one ``.npz``: the artifact the diffusion-prior trainer consumes (the
        reference's ``ATM_S_eeg_features_sub-08{,_test}.pt`` pair). Under a
        mesh rank 0 writes it (the others return None)."""
        if not self.is_writer:
            return None

        def host(a):
            return (a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a))

        # the whole split: on the device unless it is streamed or sharded
        src = (self.train_host if self.streaming or self.shard_samples
               else self.data)
        train_feats = self.extract_features(src.eeg, src.subject_ids)
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
