"""The 95th percentile of the program's ``server.return_wait`` spans: each
request from its answer being set until its thread leaves the coalescer,
which first takes the device lock (a call that wins the lock first
holds an answered request), over the window's requests."""

from benchmarks.harness import spans, stats

UNIT = "ms"
LAYER = "server (server.py _Coalescer)"
MOVES = "recon_latency_p95_ms"
SOURCE = "program_span"


def read(rec: dict):
    ms = spans.serving("server.return_wait")
    return stats.p95(ms) if ms else None
