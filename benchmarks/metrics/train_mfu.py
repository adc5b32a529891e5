"""The window's training operations (steps × the reference's count of one
step: forward, loss and backward at the cell's batch) over its wall time,
as a share of the cell's cards' bf16 peak."""

from benchmarks.harness import stats

UNIT = "%"
LAYER = "model step"
MOVES = "train_samples_per_s"
SOURCE = "host_clock"


def read(rec: dict):
    if not rec.get("steps") or "flops_per_step" not in rec:
        return None
    peak = stats.PEAK_FLOPS[rec["peak_dtype"]] * rec["chips"]
    return 100.0 * rec["steps"] * rec["flops_per_step"] / rec["window_s"] \
        / peak
