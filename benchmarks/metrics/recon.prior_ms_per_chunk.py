"""The service's CUDA-event milliseconds of the ``prior`` stage
(``ReconstructionService.stage_ms``, read by the proxy after each call),
over the window's 16-row chunks."""

UNIT = "ms"
LAYER = "model: prior (train/prior.py, models/diffusion_prior.py)"
MOVES = "recon_latency_p95_ms"
SOURCE = "program_span"


def read(rec: dict):
    calls = rec.get("stage_ms")
    if not calls or not all("prior" in c for c in calls):
        return None
    return sum(c["prior"] for c in calls) / sum(rec["chunks"])
