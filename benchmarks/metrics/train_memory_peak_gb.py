"""The card's peak of allocated memory over set-up and the window
(``torch.cuda.max_memory_allocated``, read by the benchmark once the window
has closed), in GB. A streamed job's peak leaves out the split, which
lives in host RAM: what streaming saves is what this reads."""

UNIT = "GB"
LAYER = None
MOVES = None
SOURCE = "host_clock"


def read(rec: dict):
    peak = rec.get("memory_peak_bytes")
    return peak / 1e9 if peak else None
