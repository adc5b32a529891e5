"""Profiling and tracing hooks (counterpart of
``eeg_image_decode_tpu/utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` window over the wrapped steps,
  written as a Chrome trace (``<logdir>/trace.json``; CUDA activity too
  when a card is present).
- ``StepTimer``: host wall-clock per step; ``stop(value)`` first waits for
  the device ``value`` lives on, so the time covers the work, not its
  enqueue.
- ``assert_finite``: the NaN/Inf guard of the reference's finite-loss abort
  (``models/util.py:92-94``).
- ``PeakRSS``: the process's peak resident memory over a ``with`` block
  (the full-size rehearsals' host column).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    def __init__(self):
        self.times: list[float] = []
        self._t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None) -> float:
        if torch.is_tensor(sync_value) and sync_value.is_cuda:
            torch.cuda.synchronize(sync_value.device)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def best(self) -> float:
        return min(self.times)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times)


def assert_finite(x: torch.Tensor, name: str = "loss") -> torch.Tensor:
    """``x`` unchanged, or ``FloatingPointError`` if any of it is NaN or
    infinite (a read of the device for a CUDA tensor)."""
    if not bool(torch.isfinite(x).all()):
        v = x.detach().cpu()
        if v.dtype == torch.bfloat16:  # numpy has no bfloat16
            v = v.float()
        raise FloatingPointError(f"non-finite {name}: {v.numpy()}")
    return x


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class PeakRSS:
    """The process's peak resident set over a ``with`` block, in bytes
    (``peak``): ``/proc/self/statm`` read every ``interval`` seconds on a
    thread, and once more at the end."""

    def __init__(self, interval: float = 0.02):
        self.interval = interval
        self.peak = 0

    def __enter__(self) -> "PeakRSS":
        self.peak = _rss_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def _poll(self) -> None:
        while not self._stop.wait(self.interval):
            self.peak = max(self.peak, _rss_bytes())

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_bytes())
