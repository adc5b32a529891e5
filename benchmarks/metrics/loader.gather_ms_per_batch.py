"""The mean time the sequencing thread gathers one batch into its pinned
slot (``PrefetchLoader.gather_s``) over the window."""

UNIT = "ms"
LAYER = "data on-ramp (data/loader.py, data/native_loader.py)"
MOVES = "train_memory_peak_gb"
SOURCE = "program_span"


def read(rec: dict):
    g = rec.get("loader_gather_s")
    return 1e3 * sum(g) / len(g) if g else None
