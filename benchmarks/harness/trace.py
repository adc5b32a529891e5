"""A traced slice of the window: ``torch.profiler`` over the CPU and the
card, reduced to the device's kernel intervals inside the slice, its busy
and idle time, and the breakdown the result line carries."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

from benchmarks.harness import stats

#: the span that marks the slice in the trace
SPAN = "benchmark.traced_slice"
#: entries in each list of the breakdown
TOP = 10


class Slice:
    """``start()`` … ``stop()`` around the traced part of the window, both
    on the thread that launches the device's work (the profiler records
    that thread's host operations); ``stop`` synchronises the device."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.span = None

    def start(self) -> None:
        self.prof.start()
        self.span = torch.autograd.profiler.record_function(SPAN)
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.span.__exit__(None, None, None)
        self.prof.stop()

    def reduce(self) -> dict:
        """``kernels`` [(name, start µs, end µs)] inside the slice,
        ``trace_window_s``, ``busy_s``, ``breakdown``."""
        events = self.prof.events()
        kernels, host = [], []
        window = None
        for e in events:
            tr = e.time_range
            if e.name == SPAN and e.device_type != torch.autograd.DeviceType.CUDA:
                window = (tr.start, tr.end)
            elif e.device_type == torch.autograd.DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    kernels.append((e.name, tr.start, tr.end))
            else:
                host.append((tr.start, tr.end, e.name))
        if window is None:
            raise RuntimeError("the traced slice's span is not in the trace")
        lo, hi = window
        kernels = [(n, max(a, lo), min(b, hi)) for n, a, b in kernels
                   if b > lo and a < hi]
        intervals = [(a, b) for _, a, b in kernels]
        busy_us = stats.union_length(intervals)
        by_name: dict = defaultdict(float)
        for n, a, b in kernels:
            by_name[n] += (b - a) / 1e6
        return {
            "kernels": kernels, "trace_window_s": (hi - lo) / 1e6,
            "busy_s": busy_us / 1e6,
            "breakdown": {
                "device_ops": [[n, s] for n, s in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:TOP]],
                "idle_gaps": idle_by_host(intervals, window, host),
            },
        }


def idle_by_host(intervals, window, host) -> list:
    """The device's idle time inside ``window`` summed by what the host was
    doing at each gap's midpoint (the shortest host event spanning it),
    the ``TOP`` largest: [[name, seconds]]."""
    host = sorted(host)
    starts = [h[0] for h in host]
    total: dict = defaultdict(float)
    for a, b in stats.gaps(intervals, window):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        best = None
        for j in range(i, max(i - 400, -1), -1):
            s, e, n = host[j]
            if e >= mid and n != SPAN and (best is None
                                           or e - s < best[1] - best[0]):
                best = (s, e, n)
        total[best[2] if best else "host outside any traced op"] += (
            b - a) / 1e6
    return [[n, s] for n, s in sorted(total.items(),
                                      key=lambda kv: -kv[1])[:TOP]]
