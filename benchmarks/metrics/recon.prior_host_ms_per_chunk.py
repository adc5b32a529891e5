"""The host's milliseconds of the prior's stage a chunk: the program's
``recon.prior`` spans (one a chunk, under the window's calls) summed over
the chunks; ``recon.prior_ms_per_chunk`` is its device-event twin."""

from benchmarks.harness import spans

UNIT = "ms"
LAYER = "model: prior (train/prior.py, models/diffusion_prior.py)"
MOVES = "recon_latency_p95_ms"
SOURCE = "program_span"


def read(rec: dict):
    ms = spans.serving("recon.prior")
    return sum(ms) / len(ms) if ms else None
