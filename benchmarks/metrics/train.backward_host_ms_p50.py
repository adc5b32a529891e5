"""The median of the program's ``train.backward`` spans: the host's time
in the backward (``loss.backward``) a step, over every step outside the
traced epoch."""

import statistics

from benchmarks.harness import spans

UNIT = "ms"
LAYER = "trainer (train/contrastive.py)"
MOVES = "train_samples_per_s"
SOURCE = "program_span"


def read(rec: dict):
    ms = spans.training(rec, "train.backward")
    return statistics.median(ms) if ms else None
