"""The median of the program's ``train.optimizer`` spans: the host's
time in AdamW's step and the clearing of the gradients a step, over every
step outside the traced epoch."""

import statistics

from benchmarks.harness import spans

UNIT = "ms"
LAYER = "trainer (train/contrastive.py)"
MOVES = "train_samples_per_s"
SOURCE = "program_span"


def read(rec: dict):
    ms = spans.training(rec, "train.optimizer")
    return statistics.median(ms) if ms else None
