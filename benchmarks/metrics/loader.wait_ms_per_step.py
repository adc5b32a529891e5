"""The training thread's wait for each batch (``PrefetchLoader.wait_s``),
summed over the window's epochs, per step."""

UNIT = "ms"
LAYER = "data on-ramp (data/loader.py, data/native_loader.py)"
MOVES = "train_memory_peak_gb"
SOURCE = "program_span"


def read(rec: dict):
    w = rec.get("loader_wait_s")
    return 1e3 * sum(w) / rec["steps"] if w else None
