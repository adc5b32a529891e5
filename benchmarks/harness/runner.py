"""One run of one cell: find the cell, run its driver on the card, read
its metrics and print the result line.

The driver returns an :class:`Outcome`: the run's records (``rec``, what
the metric readers read), the checks against the reference, the requests
or steps attempted and failed, the peak memory, and for a traced run the
reduced trace. The last line of standard output is the result; standard
error ends with each compared number beside its limit."""

from __future__ import annotations

import json
import math
import sys
from dataclasses import dataclass, field

from benchmarks.harness import guard, spec


@dataclass
class Outcome:
    rec: dict
    #: (short name, value, limit): correct iff every value ≤ its limit
    checks: list
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: dict | None = None
    notes: dict = field(default_factory=dict)


def read_metrics(cell: spec.Cell, entries: list, rec: dict) -> dict:
    out = {}
    for m in entries:
        value = spec.reader(cell, m).read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def checks_pass(checks) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def result_line(cell: spec.Cell, out: Outcome, trace: bool,
                device: dict) -> dict:
    entries = cell.per_layer if trace else cell.end_to_end
    line = {
        "correct": checks_pass(out.checks) and out.failed == 0,
        "attempted": int(out.attempted), "failed": int(out.failed),
        "metrics": read_metrics(cell, entries, out.rec),
        "device": device,
    }
    if trace and out.trace is not None:
        line["breakdown"] = out.trace["breakdown"]
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in out.checks}
    return line


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: str, t_start: float) -> tuple[dict, Outcome]:
    """The cell's driver, then its result line (``device`` "cuda", or
    "cpu" for the tests, which skip the look for a card)."""
    drv = spec.driver(cell)
    out = drv.run(cell, seed=seed, seconds=seconds, trace=trace,
                  device=device, t_start=t_start)
    info = {"platform": "gpu" if device == "cuda" else "cpu",
            "kind": "cpu", "count": cell.chips,
            "memory_peak_bytes": int(out.memory_peak_bytes)}
    if device == "cuda":
        import torch

        info["kind"] = torch.cuda.get_device_name(0)
    if trace and out.trace is not None:
        info["busy_s"] = out.trace["busy_s"]
        info["window_s"] = out.trace["trace_window_s"]
    return result_line(cell, out, trace, info), out


def main(argv: list[str], t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="benchmarks/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    line, out = run(cell, args.seed, args.seconds, bool(args.trace),
                    "cuda", t_start)
    guard.check("once the window had closed")
    for k, v in out.notes.items():
        print(f"note {k}: {v}", file=sys.stderr)
    for name, v, lim in out.checks:
        print(f"check {name}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0
