"""The host's wait for a call's images: the program's ``recon.readback``
span (the service's one read of the device after its chunks), the mean
over the window's calls."""

from benchmarks.harness import spans

UNIT = "ms"
LAYER = "service (serve.py ReconstructionService)"
MOVES = "recon_latency_p95_ms"
SOURCE = "program_span"


def read(rec: dict):
    ms = spans.serving("recon.readback")
    return sum(ms) / len(ms) if ms else None
