"""The 95th percentile over every request completed in the window, each
timed from its submission to its result."""

from benchmarks.harness import stats

UNIT = "ms"
LAYER = None
MOVES = None
SOURCE = "host_clock"


def read(rec: dict):
    lat = rec.get("latencies_ms")
    return stats.p95(lat) if lat else None
