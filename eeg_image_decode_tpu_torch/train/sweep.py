"""Subject-parallel sweep (counterpart of
``eeg_image_decode_tpu/train/sweep.py``): the reference's 10-subject
protocol (``Retrieval/ATMS_retrieval.py:516-586``), a loop of independent
per-subject runs, trained on all the mesh's ranks at once.

JAX stacks the lanes and vmaps the single-subject epoch over the dp axis.
Here lane i runs on rank i mod dp, the lanes of a rank in order, each lane
the single-subject :class:`ContrastiveTrainer` (no mesh: the lanes share no
collective), so each lane reproduces the sequential run of its subject: the
same seeded model, ``epoch_permutation`` order, generators and evaluator
draws. After each epoch the ranks exchange their lanes' rows, so every rank
holds the whole history.

Unlike the JAX sweep, a lane's seed is used whole (as the sequential
trainer uses it: no uint32 wrap), an empty subject list raises, each row
carries its own lane's epoch time and rate, and a lane whose loss is not
finite stops alone: its row records the loss and ``"failed": 1``, its
trainer is dropped, and the other lanes go on (the JAX sweep loses every
lane's progress).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.distributed as dist

from eeg_image_decode_tpu_torch.core.config import ContrastiveTrainConfig
from eeg_image_decode_tpu_torch.data.things_eeg import EEGRetrievalData
from eeg_image_decode_tpu_torch.train.contrastive import ContrastiveTrainer


class SubjectParallelSweep:
    """Train ``S = len(train_datas)`` independent per-subject models, lane i
    on rank ``i % mesh.dp`` of ``mesh``'s dp group.

    ``build_model(seed)``: a fresh encoder for a lane (the reference's ``for
    sub: model = ATMS()``), built from the lane's seed as the sequential
    run builds it. ``seeds``: per-lane seeds (default ``cfg.seed`` for
    every lane, as the sequential sweep)."""

    def __init__(self, build_model: Callable[[int], torch.nn.Module],
                 cfg: ContrastiveTrainConfig,
                 train_datas: list[EEGRetrievalData],
                 test_datas: list[EEGRetrievalData], *, mesh,
                 seeds: list[int] | None = None):
        s = len(train_datas)
        if s == 0:
            raise ValueError("a sweep needs at least one subject")
        if len(test_datas) != s:
            raise ValueError(f"{s} train splits vs {len(test_datas)} test")
        self.seeds = [int(x) for x in (seeds if seeds is not None
                                       else [cfg.seed] * s)]
        if len(self.seeds) != s:
            raise ValueError(f"{len(self.seeds)} seeds for {s} subjects")
        self.cfg = cfg
        self.mesh = mesh
        self.n_subjects = s
        #: the lanes this rank trains, in order
        self.lanes = [i for i in range(s) if i % mesh.dp == mesh.dp_rank]
        self.trainers: dict[int, ContrastiveTrainer] = {}
        for i in self.lanes:
            seed = self.seeds[i]
            self.trainers[i] = ContrastiveTrainer(
                build_model(seed), dataclasses.replace(cfg, seed=seed),
                train_datas[i], test_datas[i], device=mesh.device)
        self.failed: set[int] = set()
        self.history: list[list[dict]] = [[] for _ in range(s)]

    def train_epoch(self, epoch: int) -> dict[int, dict]:
        """One epoch and its evaluation for each live lane of this rank;
        returns their rows (the sequential trainer's keys, the lane's own
        ``epoch_time_s`` and ``samples_per_s``)."""
        rows = {}
        for i in self.lanes:
            if i in self.failed:
                continue
            tr = self.trainers[i]
            m = tr.train_epoch(epoch)
            if not math.isfinite(m["loss"]):
                self.failed.add(i)
                del self.trainers[i]
                rows[i] = {"epoch": epoch, **m, "failed": 1}
                continue
            rows[i] = {"epoch": epoch, **m, **tr.evaluate(epoch)}
        return rows

    def fit(self, epochs: int | None = None,
            log_fn=print) -> list[list[dict]]:
        """The sweep: per-lane histories (one row an epoch, the sequential
        trainer's schema), the same on every rank."""
        epochs = epochs or self.cfg.epochs
        for epoch in range(epochs):
            mine = self.train_epoch(epoch)
            every = [None] * self.mesh.dp
            dist.all_gather_object(every, mine, group=self.mesh.dp_group)
            for rows in every:
                for i, row in rows.items():
                    self.history[i].append(row)
                    if row.get("failed"):
                        self.failed.add(i)
            if log_fn and self.mesh.rank == 0:
                losses = " ".join(
                    f"{self.history[i][-1]['loss']:.4f}"
                    if self.history[i] and self.history[i][-1]["epoch"]
                    == epoch else "-" for i in range(self.n_subjects))
                log_fn(f"epoch {epoch}: per-subject losses [{losses}]")
        for i in self.lanes:
            tr = self.trainers.get(i)
            if tr is not None:
                tr.close()
        return self.history

    def subject_trainer(self, i: int) -> ContrastiveTrainer:
        """Lane ``i``'s trainer (on the rank that trains it): its model,
        state, checkpoint and export surfaces, as the sequential run's."""
        if i not in self.trainers:
            raise KeyError(f"lane {i} is not trained on this rank "
                           f"({self.lanes}) or has failed")
        return self.trainers[i]
