"""The benchmark's command:

    python benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root, on a machine with as many NVIDIA cards as the
cell asks for. Prints one JSON line last: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` with ``--trace 1``),
then ``checks``, each compared number beside its limit."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache of the run at a fixed path in the checkout
_CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(_CACHE, "inductor")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "nv_compute")
# a library that would load JAX by itself does not
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
os.environ["USE_TF"] = "0"
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from benchmarks.harness.runner import main

    sys.exit(main(sys.argv[1:], T_START))
