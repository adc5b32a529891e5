"""Shared inputs of the port's tests (tests/test_torch_*.py). Imports no
JAX at module level: tests/test_torch_kernels_cuda.py runs without it."""

import numpy as np
import pytest

#: small ATM-S: 8 channels of T 100, d_model 32, 4 heads, d_ff 64, a 5-tap
#: temporal kernel and a 12-wide, stride-2 pool (P = 6), 8 filters, 16-d out
SMALL = dict(n_channels=8, seq_len=100, d_model=32, n_heads=4, d_ff=64,
             num_subjects=3, conv_filters=8, temporal_kernel=5, pool_size=12,
             pool_stride=2, emb_size=8, proj_dim=16)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on the host's
    cores, and each PyTorch process would otherwise take them all. A test
    module takes it with ``from torch_port_case import two_threads``."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def randomize(variables, seed):
    """Every leaf of a JAX variable tree redrawn from a numpy seed, as
    nested dicts of numpy arrays."""
    import jax

    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        if "'var'" in name:
            v = rng.uniform(0.5, 1.5, size=shape)
        elif "'mean'" in name or "'bias'" in name:
            v = 0.1 * rng.normal(size=shape)
        elif "'scale'" in name:
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif "'logit_scale'" in name:
            v = np.asarray(2.6592600225)
        elif "kernel" in name:
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(size=shape) / np.sqrt(fan_in)
        else:  # subject tokens
            v = rng.normal(size=shape)
        return np.asarray(v, np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, variables)
    return jax.tree_util.tree_map(np.asarray, tree)


def attention_params(rng, d, inner, ff):
    shapes = {"wq": (d, inner), "bq": (inner,), "wk": (d, inner),
              "bk": (inner,), "wv": (d, inner), "bv": (inner,),
              "wo": (inner, d), "bo": (d,), "ln1_s": (d,), "ln1_b": (d,),
              "w1": (d, ff), "b1": (ff,), "w2": (ff, d), "b2": (d,),
              "ln2_s": (d,), "ln2_b": (d,)}
    out = {}
    for k, s in shapes.items():
        if len(s) == 2:
            v = rng.normal(size=s) / np.sqrt(s[0])
        elif k.endswith("_s"):
            v = 1.0 + 0.1 * rng.normal(size=s)
        else:
            v = 0.1 * rng.normal(size=s)
        out[k] = v.astype(np.float32)
    return out


def projection_params(rng, d_in, d_out):
    return {
        "wi": (rng.normal(size=(d_in, d_out)) / np.sqrt(d_in)).astype(np.float32),
        "bi": (0.1 * rng.normal(size=d_out)).astype(np.float32),
        "wr": (rng.normal(size=(d_out, d_out)) / np.sqrt(d_out)).astype(np.float32),
        "br": (0.1 * rng.normal(size=d_out)).astype(np.float32),
        "ln_s": (1.0 + 0.1 * rng.normal(size=d_out)).astype(np.float32),
        "ln_b": (0.1 * rng.normal(size=d_out)).astype(np.float32),
    }


def keep_masks(rng, b, heads, length, d, ff, p=0.25):
    """Pre-scaled keep-masks (0 or 1/(1−p)) of the attention layer's four
    dropout sites, as numpy fp32."""
    def keep(*shape):
        return ((rng.random(shape) >= p) / (1.0 - p)).astype(np.float32)

    return {"m_attn": keep(b, heads, length, length),
            "m_res": keep(b, length, d), "m_ffn1": keep(b, length, ff),
            "m_ffn2": keep(b, length, d)}


def launch_ranks(world: int, directory: str, cases: list[str],
                 timeout: float = 240.0) -> dict:
    """Run ``tests/_torch_dist_worker.py`` as ``world`` gloo ranks over a
    ``file://`` rendezvous in ``directory`` on the cases whose inputs lie
    in ``directory/<case>.pt``; returns {case: [output of rank r, …]}. A
    rank that fails or outlives ``timeout`` fails the launch (the others
    are killed)."""
    import os
    import subprocess
    import sys
    import time

    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    rdv = os.path.join(directory, "rendezvous")
    env = {**os.environ, "OMP_NUM_THREADS": "2", "CUDA_VISIBLE_DEVICES": ""}
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "_torch_dist_worker.py"),
         str(r), str(world), rdv, directory, *cases],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0,
                                               deadline - time.monotonic()))
            logs.append(out)
            if p.returncode != 0:
                raise RuntimeError(f"rank {len(logs) - 1} exited "
                                   f"{p.returncode}:\n{out}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {c: [torch.load(os.path.join(directory, f"{c}_r{r}.pt"),
                           weights_only=False) for r in range(world)]
            for c in cases}


def run_cli_child(argv: list[str], timeout: float = 300.0) -> list[str]:
    """``python -m eeg_image_decode_tpu_torch.cli argv`` in a child process
    without a launcher's variables (a ``--mesh`` run there is one rank, and
    its process group dies with it); returns its stdout lines. A nonzero
    exit fails with its stderr."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # two threads, as the test process that launches it keeps
    env = {**os.environ, "PYTHONPATH": repo, "OMP_NUM_THREADS": "2"}
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    done = subprocess.run(
        [sys.executable, "-m", "eeg_image_decode_tpu_torch.cli", *argv],
        env=env, capture_output=True, text=True, timeout=timeout)
    assert done.returncode == 0, done.stderr
    return done.stdout.strip().splitlines()
