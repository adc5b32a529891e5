"""The median of the program's ``train.evaluate`` spans: each evaluation
between the window's epochs, its read of the device included, outside the
traced epoch."""

import statistics

from benchmarks.harness import spans

UNIT = "ms"
LAYER = "trainer (train/contrastive.py)"
MOVES = "train_samples_per_s"
SOURCE = "program_span"


def read(rec: dict):
    ms = spans.training(rec, "train.evaluate")
    return statistics.median(ms) if ms else None
