"""The service's CUDA-event milliseconds of the ``vae_decode`` stage
(``ReconstructionService.stage_ms``, read by the proxy after each call),
over the window's 16-row chunks."""

UNIT = "ms"
LAYER = "generator (gen/sdxl.py, gen/unet.py, gen/vae.py)"
MOVES = "recon_latency_p95_ms"
SOURCE = "program_span"


def read(rec: dict):
    calls = rec.get("stage_ms")
    if not calls or not all("vae_decode" in c for c in calls):
        return None
    return sum(c["vae_decode"] for c in calls) / sum(rec["chunks"])
