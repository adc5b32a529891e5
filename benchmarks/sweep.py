"""The knee of a serving cell's open loop: set-up once, then one short
window at each rate for each seed, in one process, printing the images
returned a second, the latency's median and 95th percentile, the rows a
call and the requests still waiting at the close.

    python benchmarks/sweep.py --workload <cell> --rates 8 10 12 \\
        [--seeds 1 2 3] [--seconds 20]
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks.harness import spec, stats  # noqa: E402


def main(argv) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the sweep runs on the card", file=sys.stderr)
        return 2
    from benchmarks.drivers.train_contrastive import Phases

    cell = spec.load_cell(args.workload)
    drv = spec.driver(cell)
    dev = torch.device("cuda")
    srv = drv.Serving(cell.config, args.seeds[0], dev, cell.mix["eeg_pool"],
                      Phases(time.perf_counter(), dev))
    for rate in args.rates:
        mix = dict(cell.mix, rate_per_s=rate)
        for seed in args.seeds:
            w = drv.window(srv, mix, args.seconds, seed, trace=False)
            lat = [1e3 * (r["t_done"] - r["t_due"]) for r in w["done"]]
            back = sum(r["t_done"] > w["stop_at"] for r in w["done"])
            rows = [c["rows"] for c in w["calls"]]
            print(json.dumps({
                "rate_per_s": rate, "seed": seed,
                "requests": len(w["reqs"]),
                "images_per_s": sum(r["t_done"] <= w["stop_at"]
                                    for r in w["done"]) / args.seconds,
                "latency_p50_ms": statistics.median(lat),
                "latency_p95_ms": stats.p95(lat),
                "rows_per_call": sum(rows) / len(rows),
                "calls_over_one_chunk": sum(
                    r > cell.config["max_batch"] for r in rows),
                "waiting_at_close": back, "stuck": w["stuck"],
                "generator_late_ms_max": 1e3 * max(w["late"])}),
                flush=True)
    srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
