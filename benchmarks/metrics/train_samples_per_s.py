"""Training samples of every step completed in the window, over all ranks,
divided by the window's wall time (its start to the sync that ends its last
step; evaluations run between epochs)."""

from benchmarks.harness import stats

UNIT = "samples/s"
LAYER = None
MOVES = None
SOURCE = "host_clock"


def read(rec: dict):
    if not rec.get("samples"):
        return None
    return stats.rate(rec["samples"], rec["window_s"])
