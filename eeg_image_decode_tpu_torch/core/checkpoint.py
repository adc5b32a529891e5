"""Checkpoint / resume (counterpart of
``eeg_image_decode_tpu/core/checkpoint.py``, which wraps orbax).

The full train state of every trainer round-trips (:class:`TrainState`:
the contrastive trainer's, the diffusion prior's and the low-level
trainer's): the model's ``state_dict`` (parameters and BatchNorm
statistics), the optimizer's ``state_dict`` (its moments and, for the
prior's and the low-level trainer's optimizer, its update count) and the
step count, stored with ``torch.save`` as ``<directory>/<step>/state.pt``. A
checkpoint is written under a temporary name and renamed into place, so a
run killed mid-save never leaves a half-written checkpoint that
``latest_step`` would return. The directory layout mirrors the reference's
``<root>/<encoder>/<subject>/<run>/<epoch>`` convention
(:func:`run_directory`).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from dataclasses import dataclass

import torch

_STATE_FILE = "state.pt"


@dataclass
class TrainState:
    """What a trainer checkpoints: the model (parameters and BatchNorm
    buffers), its optimizer and the number of steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


class Checkpointer:
    """Checkpoints of a :class:`TrainState`, keyed by integer step (the
    trainers save the completed-epoch count)."""

    def __init__(self, directory: str, *, max_to_keep: int | None = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state) -> None:
        """Write ``state`` (its model, optimizer and step) as checkpoint
        ``step``, replacing one of the same step; then drop the oldest
        beyond ``max_to_keep``. The write is synchronous."""
        payload = {"model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
                   "step": int(state.step)}
        tmp = tempfile.mkdtemp(prefix=f".tmp-{int(step)}-", dir=self.directory)
        try:
            torch.save(payload, os.path.join(tmp, _STATE_FILE))
            final = self._step_dir(step)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def restore(self, step: int | None, state):
        """Load checkpoint ``step`` (default: the latest) into ``state`` in
        place, tensors mapped to the device the state's model lies on, and
        return it. Raises ``FileNotFoundError`` when there is none."""
        if step is None:
            step = self.latest_step()
        path = (os.path.join(self._step_dir(step), _STATE_FILE)
                if step is not None else None)
        if path is None or not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoints under {self.directory}"
                                    + ("" if step is None
                                       else f" for step {step}"))
        # the file holds tensors, ints and floats only
        payload = torch.load(
            path, map_location=next(state.model.parameters()).device,
            weights_only=True)
        state.model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state

    def all_steps(self) -> list[int]:
        """Steps of the complete checkpoints, ascending. A directory still
        under its temporary name, or without its state file, is none."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(
                    os.path.join(self.directory, name, _STATE_FILE)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        """Nothing is pending: saves are synchronous. Kept for callers
        written against the JAX class."""


def save_history(checkpointer: Checkpointer, history: list[dict]) -> None:
    """Persist the epoch-metric history next to the checkpoints (atomic
    write), so a resumed run can reproduce the uninterrupted run's full
    history."""
    path = os.path.join(checkpointer.directory, "history.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(history, f)
    os.replace(tmp, path)


def load_history(checkpointer: Checkpointer, before_epoch: int) -> list[dict]:
    """Completed history rows (epoch < ``before_epoch``) from a prior run."""
    path = os.path.join(checkpointer.directory, "history.json")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        rows = json.load(f)
    return [r for r in rows if r.get("epoch", -1) < before_epoch]


def run_directory(root: str, encoder: str, subject: str, run_id: str) -> str:
    """``<root>/contrast/<encoder>/<subject>/<run_id>`` — the reference's
    path convention (``ATMS_retrieval.py:384-385``)."""
    return os.path.join(root, "contrast", encoder, subject, run_id)
