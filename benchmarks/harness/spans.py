"""The program's own spans (``utils/profiling.py``'s recorder in the port)
as the metric readers take them, after the driver has returned.

Both windows leave out what a profiler saw (it slows the launching thread)
and what set-up ran. A program without the recorder gives None, and so
does a window part of which the recorder's bound dropped: it drops the
oldest records first, so a window is whole when the oldest record kept
ended before the window began."""

from __future__ import annotations

import math


def _recorder():
    try:
        from eeg_image_decode_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):  # a program without the recorder
        return None
    return profiling


def _whole(prof, recs: list, start_ns: int) -> bool:
    if not prof.counts().get(prof.DROPPED):
        return True
    return bool(recs) and recs[0].t1 <= start_ns


def serving(name: str) -> list | None:
    """The milliseconds of each span ``name`` of the serving window: the
    records that ended before the first one a profiler saw began (a traced
    run's slice; all of them in an untraced run). The service's spans
    (``recon.*``) count under a ``server.call`` that ended there, so the
    warm-up's are left out."""
    prof = _recorder()
    if prof is None:
        return None
    recs = prof.spans()
    requests = [r for r in recs if r.name == "server.request"]
    if not requests or not _whole(prof, recs, min(r.t0 for r in requests)):
        return None
    cut = min((r.t0 for r in recs if r.profiled), default=math.inf)
    by_id = {r.id: r for r in recs}

    def in_window(r) -> bool:
        if r.t1 >= cut:
            return False
        if r.name.startswith("server."):
            return True
        while r.parent in by_id:
            r = by_id[r.parent]
            if r.name == "server.call":
                return r.t1 < cut
        return False

    got = [(r.t1 - r.t0) / 1e6 for r in recs
           if r.name == name and in_window(r)]
    return got or None


def training(rec: dict, name: str) -> list | None:
    """The milliseconds of each span ``name`` of the training window: the
    window's epochs are the last ``len(rec["epoch_s"])`` ``train.epoch``
    spans; a step's spans count under those a profiler did not see, and a
    ``train.evaluate`` from the window's first epoch on, where no
    profiler saw it."""
    prof = _recorder()
    n = len(rec.get("epoch_s") or ())
    if prof is None or not n:
        return None
    recs = prof.spans()
    epochs = [r for r in recs if r.name == "train.epoch"]
    if len(epochs) < n:
        return None
    window = epochs[-n:]
    start = window[0].t0
    if not _whole(prof, recs, start):
        return None
    if name == "train.evaluate":
        got = [r for r in recs if r.name == name and r.t0 >= start
               and not r.profiled]
    else:
        plain = {e.id for e in window if not e.profiled}
        steps = {r.id for r in recs
                 if r.name == "train.step" and r.parent in plain}
        got = [r for r in recs if r.name == name and r.parent in steps]
    return [(r.t1 - r.t0) / 1e6 for r in got] or None
