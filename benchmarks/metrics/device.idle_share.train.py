"""1 − (the union of every kernel's interval) / the traced epoch."""

UNIT = "%"
LAYER = "device"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(rec: dict):
    if "kernels" not in rec:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["trace_window_s"])
