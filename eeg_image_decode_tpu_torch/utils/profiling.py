"""Profiling and tracing hooks (counterpart of
``eeg_image_decode_tpu/utils/profiling.py``), and the port's one recorder
of spans and counters.

- ``span(name, **attrs)``: a ``with`` block timed on the host
  (``time.perf_counter_ns``) and kept as a :class:`Span` record: its name,
  an id, the id of the span that caused it (``parent``: the thread's
  enclosing span, or the one handed over by :func:`under`), its start and
  end, the thread that recorded it, its attrs, and ``profiled``, whether a
  ``torch.profiler`` was recording when it began. While one is recording,
  the span is also a ``torch.profiler.record_function`` of the same name,
  so it sits in the profiler's trace on the profiler's own clock (the
  profiler keeps those of the thread that started it only).
- ``record(name, t0_ns, t1_ns, ...)``: a span whose clock readings a site
  took itself, or that starts on one thread and ends on another; it is
  kept in memory only.
- ``count(name, n)``: a counter. ``current()`` and ``under(parent)``:
  carry a parent from one thread to another.
- Read-outs: ``spans(name=None)``, ``counts()``, ``clear()``. The records
  are kept in a bounded buffer of ``MAX_RECORDS``, the oldest dropped
  first; the counter ``profiling.dropped`` says how many were.
- ``trace(logdir)``: a ``torch.profiler`` window over the wrapped steps,
  written as a Chrome trace (``<logdir>/trace.json``; CUDA activity too
  when a card is present), the spans of its thread included.
- ``assert_finite``: the NaN/Inf guard of the reference's finite-loss abort
  (``models/util.py:92-94``).
- ``PeakRSS``: the process's peak resident memory over a ``with`` block
  (the full-size rehearsals' host column).

With no profiler recording, a span costs two clock reads, a flag read, a
thread-local read and an append, a microsecond or two of the host's
(``scripts/bench_torch_spans.py`` measures it); while one records, the
``record_function`` comes on top.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

#: records kept in memory, the oldest dropped first: room for the
#: benchmark's longest window many times over (a training step makes 4
#: records, a streamed one 6)
MAX_RECORDS = 1 << 17
#: the counter of records the bound dropped
DROPPED = "profiling.dropped"

_perf_ns = time.perf_counter_ns
_lock = threading.Lock()
_buffer: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_counts: dict[str, int] = {}
_ids = itertools.count(1)
#: one number per record kept since ``clear``, taken after its append, and
#: one per read of the total (``next`` on it is atomic; a lock would double
#: a span's cost)
_appended = itertools.count()
_reads = 0


class _Context(threading.local):
    def __init__(self):
        #: the thread's open spans (and parents handed over), its name
        self.state = ([], threading.current_thread().name)


_ctx = _Context()


def recording() -> bool:
    """Whether a ``torch.profiler`` is recording now."""
    return _autograd_profiler._is_profiler_enabled


class Span:
    """One record: ``name``, ``id``, ``parent`` (an id or None), ``t0`` and
    ``t1`` (``time.perf_counter_ns``), ``thread`` (the recording thread's
    name), ``attrs`` and ``profiled``. ``span(name, **attrs)`` makes one
    to time a ``with`` block; it is kept when the block ends."""

    __slots__ = ("name", "attrs", "id", "parent", "t0", "t1", "thread",
                 "profiled", "_rf", "_state")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.id = next(_ids)
        self.parent = None

    def __enter__(self) -> "Span":
        self._state = state = _ctx.state
        stack = state[0]
        if stack:
            self.parent = stack[-1].id
        stack.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self.profiled = True
            self._rf = _autograd_profiler.record_function(self.name)
            self._rf.__enter__()
        else:
            self.profiled = False
        self.t0 = _perf_ns()
        return self

    def __exit__(self, et, ev, tb) -> None:
        self.t1 = _perf_ns()
        if self.profiled:
            self._rf.__exit__(None, None, None)
            self._rf = None
        stack, self.thread = self._state
        stack.pop()
        _buffer.append(self)
        next(_appended)

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"t0={self.t0}, t1={self.t1}, thread={self.thread!r}, "
                f"profiled={self.profiled}, attrs={self.attrs})")


#: ``with span("train.step"): ...`` times the block
span = Span


def record(name: str, t0_ns: int, t1_ns: int, *, parent=None,
           profiled: bool | None = None, **attrs) -> Span:
    """Keep a span whose readings were taken already (``perf_counter_ns``).
    ``parent``: the span that caused it (default: the thread's current
    one); ``profiled``: whether a profiler was recording at ``t0_ns``
    (default: whether one is now)."""
    rec = Span(name, **attrs)
    if parent is None:
        parent = current()
    if parent is not None:
        rec.parent = parent.id
    rec.t0, rec.t1 = t0_ns, t1_ns
    rec.profiled = recording() if profiled is None else profiled
    rec.thread = _ctx.state[1]
    _buffer.append(rec)
    next(_appended)
    return rec


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def current() -> Span | None:
    """The thread's innermost open span (or the parent :func:`under`
    handed it), or None."""
    stack = _ctx.state[0]
    return stack[-1] if stack else None


@contextlib.contextmanager
def under(parent: Span | None):
    """Spans begun in the block take ``parent`` (a span of another thread,
    from :func:`current`) as theirs; ``None`` changes nothing."""
    if parent is None:
        yield
        return
    stack = _ctx.state[0]
    stack.append(parent)
    try:
        yield
    finally:
        stack.pop()


def spans(name: str | None = None) -> list[Span]:
    """The kept records in the order they ended, or those named ``name``."""
    with _lock:
        out = list(_buffer)
    return out if name is None else [r for r in out if r.name == name]


def counts() -> dict[str, int]:
    """The counters, and ``profiling.dropped`` once the bound has dropped
    a record. An append still under way on another thread is not counted
    yet: the drops read may lag, never lead, the records dropped."""
    global _reads
    with _lock:
        out = dict(_counts)
        kept = len(_buffer)
        appended = next(_appended) - _reads
        _reads += 1
    if appended > kept:
        out[DROPPED] = appended - kept
    return out


def clear(bound: int | None = None) -> None:
    """Drop every record and counter; ``bound``: a new bound of the
    buffer."""
    global _buffer, _appended, _reads
    with _lock:
        _buffer = collections.deque(maxlen=bound or _buffer.maxlen)
        _appended, _reads = itertools.count(), 0
        _counts.clear()


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
