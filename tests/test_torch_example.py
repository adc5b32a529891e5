"""``examples/end_to_end_torch.py`` runs on the CPU at its own size, in a
child process that imports no JAX (the card host has none), with two
intra-op threads: every stage ends, every printed number is finite and in
its range, and the walkthrough's stages are those of
``examples/end_to_end.py``."""

import json
import math
import os
import subprocess
import sys

from test_torch_acceptance import NO_JAX
from torch_port_case import two_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_end_to_end_example_runs_on_the_cpu_without_jax():
    code = (
        "import runpy, sys, torch\n"
        "torch.set_num_threads(2)\n"
        "sys.argv = ['end_to_end_torch.py', '--device', 'cpu']\n"
        "runpy.run_path('examples/end_to_end_torch.py', "
        "run_name='__main__')\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {NO_JAX}]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    for stage in ("retrieval eval:", "prior saved:",
                  "generated-embedding retrieval:", "generated images:",
                  "metrics:", "captions:"):
        assert any(ln.startswith(stage) for ln in lines), stage
    res = json.loads(lines[-1])
    assert res["device"] == "cpu"
    for table in ("retrieval", "generated_retrieval"):
        assert set(res[table]) == {"top1_k2", "top1_k16"}
        assert all(0.0 <= v <= 1.0 for v in res[table].values()), res
    # the trained encoder and the prior's samples rank above chance
    assert res["retrieval"]["top1_k2"] > 0.5
    assert res["generated_retrieval"]["top1_k2"] > 0.5
    assert math.isfinite(res["prior_loss"]) and res["prior_loss"] > 0
    assert res["images"] == [4, 16, 16, 3]
    lo, hi = res["image_range"]
    assert 0.0 <= lo <= hi <= 1.0
    # images scored against themselves: PixCorr and SSIM are 1
    assert set(res["metrics"]) == {"pixcorr", "ssim"}
    for v in res["metrics"].values():
        assert math.isfinite(v) and abs(v - 1.0) <= 1e-4, res["metrics"]
    assert len(res["captions"]) == 4
    assert all(isinstance(c, str) and c for c in res["captions"])
