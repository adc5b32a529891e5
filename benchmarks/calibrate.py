"""The readings a cell's limits are set from, on the card at the cell's
own size, in one process: for each seed one run with a short window, the
program's compared numbers, the control's (the reference computed in fp8
in the program's place) and, for a training cell, the half-batch fault's.
One JSON line a seed.

    python benchmarks/calibrate.py --workload <cell> --seeds <s1> <s2> … \
        [--seconds 4]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks.harness import spec  # noqa: E402


def main(argv) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration runs on the card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    drv = spec.driver(cell)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = drv.run(cell, seed=seed, seconds=args.seconds, trace=False,
                      device="cuda", t_start=t0, control=True)
        print(json.dumps({"seed": seed, "failed": out.failed,
                          "wall_s": time.perf_counter() - t0,
                          **{k: v for k, v in out.notes.items()
                             if k.startswith(("program", "control",
                                              "half_batch", "saturated",
                                              "setup"))}}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
