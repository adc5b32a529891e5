"""The service's CUDA-event milliseconds of the ``unet_steps`` stage
(``ReconstructionService.stage_ms``, read by the proxy after each call),
over the window's 16-row chunks."""

UNIT = "ms"
LAYER = "generator (gen/sdxl.py, gen/unet.py, gen/vae.py)"
MOVES = "recon_latency_p95_ms"
SOURCE = "program_span"


def read(rec: dict):
    calls = rec.get("stage_ms")
    if not calls or not all("unet_steps" in c for c in calls):
        return None
    return sum(c["unet_steps"] for c in calls) / sum(rec["chunks"])
