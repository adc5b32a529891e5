"""Rows in each ``reconstruct`` call the daemon's coalescer makes, counted
by the benchmark's proxy of the service, mean over the window's calls.
Below the knee a call takes the requests that arrived during the one
before it, so fewer rows mean shorter calls."""

UNIT = "rows"
LAYER = "server (server.py _Coalescer)"
MOVES = "recon_latency_p95_ms"
SOURCE = "program_counter"


def read(rec: dict):
    rows = rec.get("rows_per_call")
    return sum(rows) / len(rows) if rows else None
