"""The chain's operations for the real rows of the window's calls (the
reference's count of one image: the encoder's forward, the prior's guided
steps, the UNet's steps and the VAE's decode) over the calls' wall time,
as a share of the card's bf16 peak: the chain's share of the card while it
serves, whatever the offered rate; padded rows count as waste."""

from benchmarks.harness import stats

UNIT = "%"
LAYER = "model step"
MOVES = "recon_latency_p95_ms"
SOURCE = "host_clock"


def read(rec: dict):
    if not rec.get("call_ms") or "flops_per_image" not in rec:
        return None
    peak = stats.PEAK_FLOPS[rec["peak_dtype"]] * rec["chips"]
    return 100.0 * rec["rows_in_calls"] * rec["flops_per_image"] \
        / (sum(rec["call_ms"]) / 1e3) / peak
