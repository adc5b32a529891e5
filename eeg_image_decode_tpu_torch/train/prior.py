"""Diffusion-prior trainer and sampling pipe (counterpart of
``eeg_image_decode_tpu/train/prior.py``; ref ``Pipe``,
``Generation/diffusion_prior.py:268-378``).

- **Train**: ε-prediction MSE on DDPM-noised CLIP image embeddings
  conditioned on EEG features; Adam with the reference's warmup(500)-cosine
  schedule over the whole run, the global gradient norm clipped to 1.0, and
  the condition dropped for a whole batch with p = 0.1 (``:282-338``). The
  pairs stay on the card; each epoch is a permutation
  (``default_rng(seed·9176 + epoch)``, the JAX formula) and one gather per
  step, and every per-step draw (the cond-dropout decision, ε, t) comes from
  one ``torch.Generator`` on the device keyed by (seed, epoch), so a resumed
  run repeats the uninterrupted one. The loss is read back once per epoch.
- **Sample**: 50-step classifier-free guidance at scale 5.0 (``:340-378``),
  cond and uncond in one doubled batch (``ops/ddpm.py``).
- **Files**: the JAX package's ``prior-v1`` pickle (``{"format",
  "config", "params"}``, params a flax-layout tree of numpy arrays), read
  without importing JAX; each package reads the other's.

Under a ``mesh`` (``core/mesh.py``) training is data parallel as the JAX
pipe's GSPMD epoch is: the pairs stay whole on every rank, each rank takes
its B/dp columns of the permutation, draws ε and t for the global batch and
keeps its rows (the same generator on every rank), and the gradients are
averaged over the dp group before the clip and the update; the loss read
back is the dp mean. Rank 0 writes the checkpoints.

Plain PyTorch: the prior is plain XLA in the JAX package, so no TPU kernel
lies on this path.
"""

from __future__ import annotations

import dataclasses
import math
import os
import pickle
import time

import numpy as np
import torch

from eeg_image_decode_tpu_torch.core.checkpoint import (
    TrainState,
    load_history,
    save_history,
)
from eeg_image_decode_tpu_torch.core.config import PriorConfig
from eeg_image_decode_tpu_torch.core.mesh import validate_dp_batch
from eeg_image_decode_tpu_torch.models.diffusion_prior import (
    DiffusionPriorUNet,
    init_flax_defaults,
)
from eeg_image_decode_tpu_torch.ops.ddpm import DDPMSchedule, make_cfg_sampler
from eeg_image_decode_tpu_torch.parallel.collectives import (
    data_parallel,
    draw_rows,
    mean_over_ranks,
    pmean_tree,
)
from eeg_image_decode_tpu_torch.train.optim import OptaxAdam
from eeg_image_decode_tpu_torch.utils.convert import (
    flax_from_params,
    params_from_flax,
)
from eeg_image_decode_tpu_torch.utils.convert_clip import load_numpy_pickle
from eeg_image_decode_tpu_torch.utils.device import resolve_device

PRIOR_FORMAT = "eeg_image_decode_tpu/prior-v1"


def warmup_cosine(count: int, peak: float, warmup: int, total: int) -> float:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup, total, 0)`` at
    ``count``: a linear rise to ``peak`` over ``warmup`` steps, then a
    cosine to 0 at ``total``."""
    if count < warmup:
        return peak * (count / warmup)
    span = total - warmup
    c = min(count - warmup, span)
    return peak * 0.5 * (1.0 + math.cos(math.pi * c / span))


def make_prior_optimizer(params, cfg: PriorConfig,
                         total_steps: int) -> OptaxAdam:
    """Adam + warmup-cosine + global-norm clip, the reference ``Pipe.train``
    optimizer (``Generation/diffusion_prior.py:285-293``). The reference
    steps its scheduler before its optimizer (``:328-330``), so its k-th
    update (from 0) runs at λ(k + 1): the schedule is read at count + 1."""
    total = max(total_steps, cfg.warmup_steps + 1)
    return OptaxAdam(
        params,
        lambda k: warmup_cosine(k + 1, cfg.lr, cfg.warmup_steps, total),
        max_norm=cfg.grad_clip_norm)


class PriorPipe:
    """Train and sample wrapper around :class:`DiffusionPriorUNet` (the
    reference's ``Pipe``), on ``device`` (default: the CUDA card; raises
    without one; ``device="cpu"`` for the CPU), data parallel over
    ``mesh`` when one is given (on the mesh's device)."""

    #: config fields that determine the parameter tree's architecture
    ARCH_FIELDS = ("embed_dim", "cond_dim", "hidden_dims", "time_embed_dim")

    def __init__(self, cfg: PriorConfig = PriorConfig(), *,
                 model: DiffusionPriorUNet | None = None, device=None,
                 mesh=None):
        self.mesh = mesh
        self.is_writer = mesh is None or mesh.rank == 0
        self.device = resolve_device(mesh.device if mesh is not None
                                     and device is None else device)
        self.cfg = cfg
        self.model = (model or DiffusionPriorUNet(
            embed_dim=cfg.embed_dim, cond_dim=cfg.cond_dim,
            hidden_dims=tuple(cfg.hidden_dims),
            time_embed_dim=cfg.time_embed_dim, dropout=cfg.dropout,
        )).to(self.device)
        self.schedule = DDPMSchedule(cfg.num_train_timesteps,
                                     device=self.device)
        self.state: TrainState | None = None
        self._schedule_total_steps: int | None = None
        self._loaded_params = False
        #: the last epoch's per-step losses, global gradient norms and, on a
        #: CUDA device, CUDA-event step times (ms)
        self.last_steps: dict = {}

    # — initialization —
    def init(self, total_steps: int, seed: int | None = None) -> TrainState:
        """Fresh weights (flax's default init, drawn from ``seed``, default
        ``cfg.seed``) and an optimizer whose schedule spans
        ``total_steps``."""
        init_flax_defaults(self.model, self.cfg.seed if seed is None
                           else seed)
        self._new_optimizer(total_steps)
        self._loaded_params = False  # explicit init: the caller owns it
        return self.state

    def _new_optimizer(self, total_steps: int) -> None:
        opt = make_prior_optimizer(self.model.parameters(), self.cfg,
                                   total_steps)
        self.state = TrainState(model=self.model, optimizer=opt)
        self._schedule_total_steps = total_steps

    def _rebuild_optimizer(self, total_steps: int) -> None:
        """A new warmup-cosine schedule for a new run length, keeping the
        current weights: used when training starts from weights that were
        ``load``ed (initialised with total_steps = 1), which would otherwise
        warm up and decay to zero almost at once."""
        self._new_optimizer(total_steps)
        self._loaded_params = False

    # — training —
    def _loss(self, h, c, t, noise, cond_mask, *, train, generator=None):
        noisy = self.schedule.add_noise(h, noise, t)
        eps = self.model(noisy, t, c, cond_mask, train=train,
                         generator=generator)
        return torch.mean((eps.float() - noise) ** 2)

    def _update(self, loss: torch.Tensor) -> None:
        opt = self.state.optimizer
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if self.mesh is not None:
            pmean_tree(self.model.parameters(), self.mesh)
        opt.step()
        self.state.step += 1

    def _run_epoch(self, n_steps: int, batch_fn) -> torch.Tensor:
        """``n_steps`` updates, ``batch_fn(s)`` giving step s's (h, c, t,
        noise, cond_mask, train, generator); per-step losses (device)."""
        dev = self.device
        losses = torch.empty(n_steps, device=dev)
        norms = torch.empty(n_steps, device=dev)
        timed = dev.type == "cuda"
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(n_steps + 1)] if timed else []
        if timed:
            events[0].record()
        for s in range(n_steps):
            h, c, t, noise, mask, train, gen = batch_fn(s)
            self.model.train(train)
            with data_parallel(self.mesh):
                loss = self._loss(h, c, t, noise, mask, train=train,
                                  generator=gen)
            self._update(loss)
            losses[s] = (loss.detach() if self.mesh is None
                         else mean_over_ranks(loss, self.mesh))
            norms[s] = self.state.optimizer.last_grad_norm
            if timed:
                events[s + 1].record()
        self.model.eval()
        self.last_steps = {"step_loss": losses, "grad_norm": norms,
                           "step_ms": None}
        if timed:
            events[-1].synchronize()
            self.last_steps["step_ms"] = [
                a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
        return losses

    def train_epoch(self, epoch: int, c_all: torch.Tensor,
                    h_all: torch.Tensor, batch_size: int) -> torch.Tensor:
        """One epoch over the device-resident pairs: the permutation and the
        generator derive from (seed, epoch). Returns the per-step losses.
        Under a mesh each rank takes its B/dp columns of the permutation and
        its rows of the global batch's ε and t."""
        cfg, dev = self.cfg, self.device
        n = c_all.shape[0]
        n_steps = max(n // batch_size, 1)
        rng = np.random.default_rng(cfg.seed * 9176 + epoch)
        perm = rng.permutation(n)[: n_steps * batch_size].reshape(
            n_steps, batch_size)
        if self.mesh is not None:
            perm = perm[:, self.mesh.rows(batch_size)]
        perm = torch.as_tensor(np.ascontiguousarray(perm), device=dev)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed * 9176 + epoch)

        def batch(s):
            idx = perm[s]
            h, c = h_all.index_select(0, idx), c_all.index_select(0, idx)
            # whole-batch cond dropout with p = 0.1 (ref :303-305)
            keep = (torch.rand((), generator=gen, device=dev)
                    >= cfg.cond_dropout_prob).float()
            with data_parallel(self.mesh):  # the global batch's draws
                noise = draw_rows(lambda shape: torch.randn(
                    shape, generator=gen, device=dev), h.shape)
                t = draw_rows(lambda shape: torch.randint(
                    0, cfg.num_train_timesteps, shape, generator=gen,
                    device=dev), (h.shape[0],))
            return h, c, t, noise, keep.expand(h.shape[0]), True, gen

        return self._run_epoch(n_steps, batch)

    def train_epoch_injected(self, c_all, h_all, perm, noise, timesteps,
                             keep) -> np.ndarray:
        """One epoch with every stochastic input given: ``perm`` (n_steps,
        B), ``noise`` (n_steps, B, embed_dim), ``timesteps`` (n_steps, B),
        ``keep`` (n_steps,) per-batch cond keep flags; a deterministic
        forward. The trajectory-parity hook of the JAX pipe: fed the same
        draws, the two walk the same loss curve. Returns the per-step
        losses."""
        assert self.state is not None, "init() the pipe first"
        dev = self.device

        def put(a, dtype):
            return torch.as_tensor(np.asarray(a)).to(dev, dtype)

        c_all, h_all = put(c_all, torch.float32), put(h_all, torch.float32)
        perm, noise = put(perm, torch.int64), put(noise, torch.float32)
        timesteps, keep = put(timesteps, torch.int64), put(keep, torch.float32)

        def batch(s):
            idx = perm[s]
            return (h_all.index_select(0, idx), c_all.index_select(0, idx),
                    timesteps[s], noise[s], keep[s].expand(idx.shape[0]),
                    False, None)

        return self._run_epoch(perm.shape[0], batch).cpu().numpy()

    def train(self, c_embeddings, h_embeddings, *, epochs: int | None = None,
              batch_size: int | None = None, log_fn=print,
              checkpointer=None, ckpt_every_epochs: int = 10,
              resume: bool = False) -> list[dict]:
        """Epochs over the (EEG feature, image embedding) pairs (numpy or
        tensors; put on the device once). With a ``checkpointer``
        (``core/checkpoint.py``) the full state (weights, Adam moments and
        count, step) is saved every ``ckpt_every_epochs`` epochs and after
        the last; ``resume=True`` restores the latest and continues."""
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        n = int(c_embeddings.shape[0])
        if int(h_embeddings.shape[0]) != n:
            raise ValueError(f"{n} EEG features against "
                             f"{int(h_embeddings.shape[0])} image embeddings")
        batch_size = min(batch_size or cfg.batch_size, n)
        validate_dp_batch(self.mesh, batch_size)
        n_steps = max(n // batch_size, 1)
        if self.state is None:
            self.init(total_steps=n_steps * epochs)
        elif (self._loaded_params and self.state.step == 0
              and self._schedule_total_steps != n_steps * epochs):
            # weights from load()/from_checkpoint() and no step taken yet:
            # fine-tuning gets this run's schedule. An init()'d pipe keeps
            # its own (kill-and-resume launches with the full job's total)
            self._rebuild_optimizer(n_steps * epochs)

        start_epoch, history = 0, []
        if resume:
            if checkpointer is None:
                raise ValueError("resume=True needs a checkpointer")
            step = checkpointer.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {checkpointer.directory}")
            checkpointer.restore(step, self.state)
            start_epoch = int(step)  # save key = completed epoch count
            history = load_history(checkpointer, start_epoch)

        c_all = torch.as_tensor(c_embeddings).to(self.device, torch.float32)
        h_all = torch.as_tensor(h_embeddings).to(self.device, torch.float32)
        for epoch in range(start_epoch, epochs):
            t0 = time.perf_counter()
            loss = float(self.train_epoch(epoch, c_all, h_all,
                                          batch_size).mean())  # one sync
            if not np.isfinite(loss):
                raise FloatingPointError(
                    f"non-finite prior loss {loss} at epoch {epoch}")
            dt = time.perf_counter() - t0
            history.append({"epoch": epoch, "loss": loss, "epoch_time_s": dt})
            if log_fn and self.is_writer and (
                    epoch % max(1, epochs // 20) == 0 or epoch == epochs - 1):
                log_fn(f"prior epoch {epoch}: loss={loss:.4f} ({dt:.2f}s)")
            if (checkpointer is not None and self.is_writer
                    and (epoch + 1) % ckpt_every_epochs == 0):
                checkpointer.save(epoch + 1, self.state)
                save_history(checkpointer, history)
        if (checkpointer is not None and self.is_writer
                and epochs > start_epoch):
            if checkpointer.latest_step() != epochs:
                checkpointer.save(epochs, self.state)
            save_history(checkpointer, history)
        return history

    # — files (the reference pickles the prior's state_dict) —
    def params_tree(self) -> dict:
        """The weights as the JAX pipe's flax param tree of numpy arrays."""
        return flax_from_params(self.model.state_dict())["params"]

    def save(self, path: str) -> str:
        """Pickle the bare param tree (the JAX pipe's legacy format)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(self.params_tree(), f)
        return path

    def save_with_config(self, path: str) -> str:
        """Pickle ``{"format": "…/prior-v1", "config", "params"}``, which
        the JAX ``PriorPipe.from_checkpoint`` reads too."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({"format": PRIOR_FORMAT,
                         "config": dataclasses.asdict(self.cfg),
                         "params": self.params_tree()}, f)
        return path

    def _set_params(self, params: dict) -> None:
        if self.state is None:
            self.init(total_steps=1)
        self.model.load_state_dict(params_from_flax({"params": params}),
                                   strict=True)
        self._loaded_params = True  # train() rebuilds the schedule

    def load(self, path: str) -> None:
        """Load a pickled prior (``prior-v1`` or a bare param tree). A
        ``prior-v1`` file whose architecture differs from this pipe's
        raises a one-line diff."""
        self._set_params(self._validate_payload(load_numpy_pickle(path)))

    def _validate_payload(self, obj) -> dict:
        if isinstance(obj, dict) and "params" in obj and "config" in obj:
            mine = dataclasses.asdict(self.cfg)
            theirs = obj["config"]

            def norm(v):
                return tuple(v) if isinstance(v, (list, tuple)) else v

            diffs = {k: {"pipe": mine[k], "checkpoint": theirs.get(k)}
                     for k in self.ARCH_FIELDS
                     if norm(mine[k]) != norm(theirs.get(k))}
            if diffs:
                raise ValueError(
                    f"prior checkpoint config does not match this pipe: "
                    f"{diffs}")
            return obj["params"]
        return obj  # a bare param tree

    @classmethod
    def from_checkpoint(cls, path: str, *,
                        default_cfg: PriorConfig | None = None,
                        device=None) -> "PriorPipe":
        """A pipe built from a pickle: a ``prior-v1`` file brings its own
        ``PriorConfig``; a bare tree uses ``default_cfg``."""
        obj = load_numpy_pickle(path)
        if isinstance(obj, dict) and "params" in obj and "config" in obj:
            stored = {k: tuple(v) if isinstance(v, list) else v
                      for k, v in obj["config"].items()}
            cfg, params = PriorConfig(**stored), obj["params"]
        else:
            cfg, params = default_cfg or PriorConfig(), obj
        pipe = cls(cfg, device=device)
        pipe._set_params(params)
        return pipe

    # — sampling —
    @torch.no_grad()
    def generate(self, c_embeds, *, num_inference_steps: int | None = None,
                 guidance_scale: float | None = None,
                 generator: torch.Generator | None = None,
                 row_keys: torch.Tensor | None = None,
                 init_noise=None, step_noises=None) -> torch.Tensor:
        """EEG features → sampled CLIP image embeddings (N, embed_dim) on
        the device. The draws come from ``generator`` (default: one seeded
        with ``cfg.seed``), or per row from ``row_keys`` (N,) int64, which
        makes each row's sample independent of its batch; ``init_noise``
        and ``step_noises`` replace them (``ops/ddpm.py``)."""
        assert self.state is not None, "train or load the prior first"
        cfg = self.cfg
        steps = num_inference_steps or cfg.num_inference_steps
        scale = cfg.guidance_scale if guidance_scale is None else guidance_scale
        self.model.eval()
        c = torch.as_tensor(c_embeds).to(self.device, torch.float32)
        if generator is None and row_keys is None:
            generator = torch.Generator(device=self.device).manual_seed(
                cfg.seed)
        sample = make_cfg_sampler(
            lambda x, t, cond, mask: self.model(x, t, cond, mask),
            self.schedule, num_inference_steps=steps, guidance_scale=scale)
        return sample(c, (c.shape[0], cfg.embed_dim), generator=generator,
                      row_keys=row_keys, init_noise=init_noise,
                      step_noises=step_noises)


def expand_image_embeddings(img_embeddings: np.ndarray, n_classes: int,
                            images_per_class: int, reps: int) -> np.ndarray:
    """(n_cls·ipc, D) → (n_cls·ipc·reps, D): one CLIP embedding per EEG
    repetition (ref ``emb_img_train.view(1654,10,1,1024).repeat(1,1,4,1)``,
    Generation_metrics_sub8.ipynb cell 5)."""
    d = img_embeddings.shape[-1]
    x = img_embeddings.reshape(n_classes, images_per_class, 1, d)
    return np.broadcast_to(
        x, (n_classes, images_per_class, reps, d)).reshape(-1, d)
