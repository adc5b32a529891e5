"""The streamed job's training rate, read from the traced run: samples of
every step completed in the window over its wall time, as
``train_samples_per_s`` reads it. The host's speed moves it too much
between runs to hold it to a bound end to end, so it stands here beside
the loader's spans."""

from benchmarks.harness import stats

UNIT = "samples/s"
LAYER = "trainer (train/contrastive.py)"
MOVES = "train_memory_peak_gb"
SOURCE = "host_clock"


def read(rec: dict):
    if not rec.get("samples"):
        return None
    return stats.rate(rec["samples"], rec["window_s"])
