"""Set-up: process start to the first timed step or request (imports, the
kernel library, data and weights made on the card, the warm-up)."""

UNIT = "s"
LAYER = None
MOVES = None
SOURCE = "host_clock"


def read(rec: dict):
    return rec.get("setup_s")
