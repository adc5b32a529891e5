"""The price of the port's spans (``utils/profiling.py``): the host time of
one ``with span(...)`` block and of one ``record(...)``, with no profiler
recording, and while a ``torch.profiler`` records (CPU activity, and the
card's where there is one), on the thread that started it and on another.

    python3 scripts/bench_torch_spans.py [--n 20000] [--repeat 7]

Prints one JSON line: nanoseconds a span, the least of ``--repeat``
timings of ``--n`` spans each, with room for every record (a window the
bound does not cut, as the benchmark's)."""

import argparse
import json
import os
import sys
import threading
import timeit

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from eeg_image_decode_tpu_torch.utils import profiling  # noqa: E402


def ns_each(stmt: str, n: int, repeat: int) -> float:
    g = {"span": profiling.span, "record": profiling.record}
    return 1e9 * min(timeit.repeat(stmt, number=n, repeat=repeat,
                                   globals=g)) / n


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--repeat", type=int, default=7)
    a = ap.parse_args(argv)
    span, rec = "with span('x'): pass", "record('x', 0, 1)"
    profiling.clear(bound=2 * a.n * a.repeat)
    out = {"device": torch.cuda.get_device_name(0)
           if torch.cuda.is_available() else "cpu",
           "span_off_ns": ns_each(span, a.n, a.repeat),
           "record_off_ns": ns_each(rec, a.n, a.repeat)}
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    n_on = max(1, a.n // 10)  # the profiler keeps every event it sees
    with profile(activities=acts):
        out["span_on_ns"] = ns_each(span, n_on, a.repeat)
        out["record_on_ns"] = ns_each(rec, n_on, a.repeat)
        got = {}
        th = threading.Thread(target=lambda: got.update(
            ns=ns_each(span, n_on, a.repeat)))
        th.start()
        th.join()
        out["span_on_other_thread_ns"] = got["ns"]
    profiling.clear(bound=profiling.MAX_RECORDS)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
