"""The 95th percentile of the program's ``server.queue`` spans: each
request from its submission until a leader takes it into a call
(``server.py::_Coalescer``), over the window's requests."""

from benchmarks.harness import spans, stats

UNIT = "ms"
LAYER = "server (server.py _Coalescer)"
MOVES = "recon_latency_p95_ms"
SOURCE = "program_span"


def read(rec: dict):
    ms = spans.serving("server.queue")
    return stats.p95(ms) if ms else None
