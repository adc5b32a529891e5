"""The median of the program's ``train.forward`` spans: the host's time
in the loss's forward (``batch_loss``) a step, over every step outside
the traced epoch."""

import statistics

from benchmarks.harness import spans

UNIT = "ms"
LAYER = "trainer (train/contrastive.py)"
MOVES = "train_samples_per_s"
SOURCE = "program_span"


def read(rec: dict):
    ms = spans.training(rec, "train.forward")
    return statistics.median(ms) if ms else None
