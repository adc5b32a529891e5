"""The median wall time of the service's ``reconstruct`` calls in the
window, timed by the benchmark's proxy of the service: below the knee a
request waits for the call in flight and then its own."""

import statistics

UNIT = "ms"
LAYER = "server (server.py _Coalescer)"
MOVES = "recon_latency_p95_ms"
SOURCE = "host_clock"


def read(rec: dict):
    ms = rec.get("call_ms")
    return statistics.median(ms) if ms else None
