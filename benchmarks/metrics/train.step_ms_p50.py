"""The median of the trainer's per-step CUDA-event times (``train_steps``'
``step_ms``) over every step of the window."""

import statistics

UNIT = "ms"
LAYER = "trainer (train/contrastive.py)"
MOVES = "train_samples_per_s"
SOURCE = "program_span"


def read(rec: dict):
    ms = rec.get("step_ms")
    return statistics.median(ms) if ms else None
