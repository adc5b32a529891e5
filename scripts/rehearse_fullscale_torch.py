"""``train-retrieval`` at THINGS-EEG's full size through the port's CLI
(the port's counterpart of ``scripts/rehearse_fullscale_cli.py``).

    python3 scripts/rehearse_fullscale_torch.py [--device cuda]
        [--work-dir PARENT] [--epochs 2] [--resume-epochs 4] [--tiny]

Writes one subject at the stored size of the published preprocessing
(``preprocessing_utils.py:241-258``: a dict pickled into the ``.npy`` by
``np.save``): ``sub-01/preprocessed_eeg_training.npy`` with 16,540
conditions × 4 repetitions × 63 channels × 300 samples in fp32 (5.00 GB),
``preprocessed_eeg_test.npy`` with 200 × 80 × 63 × 300 (1.21 GB), and one
feature file of unit-norm 1024-d image and text features for both splits.
The EEG is a seeded rank-16 class signature plus unit noise, drawn on the
device. Then, in this process, through ``cli.main`` at the CLI's defaults
(bf16, batch 1024, ATM-S with ``tsconv_bn1='auto'``, which is ``'gram'`` on
the card):

1. ``train-retrieval --epochs E`` from cold: the pickles are read and the
   sidecar ``.npy`` caches written, the 250-sample window cut, the
   repetitions flattened, the split made resident, the epochs trained
   with the 1654-way probe, each evaluated, checkpointed and rowed in
   ``results.csv``;
2. the same trainer, held from step 1, trains epoch E once more: the
   uninterrupted run;
3. ``train-retrieval --resume-dir RUN --epochs R --export-features F``:
   the sidecars are mapped, and its first epoch's step losses must equal
   the uninterrupted epoch's within ``RESUME_TOL``;
4. ``evaluate --run-dir RUN --seed 104729·(R − 1)``, whose row must equal
   the trainer's last.

``results.csv`` must hold epochs 0 … R − 1. The report (one JSON line per
stage, then the whole as the last line) gives seconds for the pickle
write, each ingest (cold, then from the sidecars), each epoch, evaluation,
checkpoint write and the export; the step p50 (CUDA events, the first 3
steps of each epoch left out) and samples/s; the resident split's device
memory, each command's peak device memory and host peak RSS; the bytes on
disk; and the sidecar read alone, warm (the files were just written or
read): each sidecar mapped through ``data/native_loader.py::NpyMmap``
with its ``willneed`` readahead and every byte read once, beside the same
read through ``np.load(mmap_mode="r")``. Everything is written under a
temporary directory (≈ 12.5 GB with the sidecars) that is deleted at the
end.

``--tiny`` writes 4 training concepts × 10 images × 2 repetitions and 3
test concepts × 4 repetitions at the same widths and runs the same
commands in fp32 at batch 8 (a check of this script on the CPU).
``chip_smoke.py`` phase 18 runs it at full size on the card. Imports no
JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import gc
import io
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from eeg_image_decode_tpu_torch import cli  # noqa: E402
from eeg_image_decode_tpu_torch.core.checkpoint import (  # noqa: E402
    Checkpointer,
)
from eeg_image_decode_tpu_torch.data import things_eeg  # noqa: E402
from eeg_image_decode_tpu_torch.train.contrastive import (  # noqa: E402
    ContrastiveTrainer,
)
from eeg_image_decode_tpu_torch.utils.device import (  # noqa: E402
    resolve_device,
)
from eeg_image_decode_tpu_torch.utils.profiling import PeakRSS  # noqa: E402

#: THINGS-EEG's stored layout: 1654 training concepts × 10 images × 4
#: repetitions, 200 test concepts × 80 repetitions, 63 channels, 300
#: samples (50 of them before the stimulus), 1024-d CLIP features
FULL = dict(n_cls=1654, ipc=10, train_reps=4, n_test=200, test_reps=80,
            batch=1024, dtype="bfloat16", eval_ks=None)
TINY = dict(n_cls=4, ipc=10, train_reps=2, n_test=3, test_reps=4, batch=8,
            dtype="float32", eval_ks="2,3")
CHANNELS, STORED, PRE, DIM = 63, 300, 50, 1024
SEED = 20200220
#: a resumed epoch against the uninterrupted one (``chip_smoke.py``'s)
RESUME_TOL = 0.05
#: the trainer's evaluation after epoch e draws its distractors from
#: ``seed + EVAL_SEED_STRIDE · e`` (``train/contrastive.py``)
EVAL_SEED_STRIDE = 104729


def emit(row: dict) -> None:
    print(json.dumps(row, default=str), flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


# ——— the subject ———


def _unit(a: torch.Tensor) -> torch.Tensor:
    return a / a.norm(dim=-1, keepdim=True)


def write_subject(root: str, size: dict, device: torch.device) -> dict:
    """``root/sub-01/preprocessed_eeg_{training,test}.npy`` and
    ``root/features.npz``; returns the seconds and bytes of each file."""
    g = torch.Generator(device=device).manual_seed(SEED)
    n_train, n_test = size["n_cls"] * size["ipc"], size["n_test"]
    latent = torch.randn((size["n_cls"] + n_test, 16), generator=g,
                         device=device)
    mix = torch.randn((16, CHANNELS * STORED), generator=g,
                      device=device) / 4.0
    anchors = _unit(torch.randn((size["n_cls"] + n_test, DIM), generator=g,
                                device=device))
    times = np.concatenate([np.linspace(-0.2, 0.0, PRE, endpoint=False),
                            np.linspace(0.0, 1.0, STORED - PRE)])
    sub = os.path.join(root, "sub-01")
    os.makedirs(sub, exist_ok=True)
    out = {}
    for split, n_cond, reps, classes in (
            ("training", n_train, size["train_reps"],
             torch.arange(n_train, device=device) // size["ipc"]),
            ("test", n_test, size["test_reps"],
             size["n_cls"] + torch.arange(n_test, device=device))):
        t0 = time.perf_counter()
        data = np.empty((n_cond, reps, CHANNELS, STORED), np.float32)
        for lo in range(0, n_cond, 512):
            c = classes[lo:lo + 512]
            signal = (latent[c] @ mix).reshape(len(c), 1, CHANNELS, STORED)
            noise = torch.randn((len(c), reps, CHANNELS, STORED),
                                generator=g, device=device)
            data[lo:lo + len(c)] = (signal + noise).cpu().numpy()
        draw_s = time.perf_counter() - t0
        path = os.path.join(sub, f"preprocessed_eeg_{split}.npy")
        t0 = time.perf_counter()
        # the published layout: np.save of the dict (a pickle in the .npy)
        np.save(path, {"preprocessed_eeg_data": data,
                       "ch_names": [f"ch{i}" for i in range(CHANNELS)],
                       "times": times}, allow_pickle=True)
        out[split] = {"shape": list(data.shape), "draw_s": draw_s,
                      "write_s": time.perf_counter() - t0,
                      "bytes": os.path.getsize(path)}
        del data
    img = _unit(anchors[:size["n_cls"], None] + 0.1 * torch.randn(
        (size["n_cls"], size["ipc"], DIM), generator=g, device=device))
    feats = {
        "img_features": img.reshape(-1, DIM),
        "text_features": _unit(anchors[:size["n_cls"]] + 0.05 * torch.randn(
            (size["n_cls"], DIM), generator=g, device=device)),
        "img_features_test": _unit(anchors[size["n_cls"]:] + 0.1 * torch.randn(
            (n_test, DIM), generator=g, device=device)),
        "text_features_test": _unit(anchors[size["n_cls"]:] + 0.05
                                    * torch.randn((n_test, DIM), generator=g,
                                                  device=device))}
    path = os.path.join(root, "features.npz")
    np.savez(path, **{k: v.cpu().numpy() for k, v in feats.items()})
    out["features"] = {"path": path, "bytes": os.path.getsize(path)}
    return out


# ——— what the commands do, recorded from inside ———


class Recorder:
    """Wraps the trainer's epoch, evaluation and export, the checkpoint
    write, the split build and the subject-file read for the duration of a
    ``with`` block, recording each call's seconds (the device drained
    before the clock stops) and what it returned."""

    def __init__(self, device: torch.device):
        self.device = device
        self.epochs: list[dict] = []
        self.calls: dict[str, list[float]] = {}
        self.reads: list[dict] = []
        self.trainer: ContrastiveTrainer | None = None
        self.resident_gb: float | None = None

    def _timed(self, name: str, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            _sync(self.device)
            self.calls.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return wrapper

    def __enter__(self) -> "Recorder":
        rec = self
        train_epoch = ContrastiveTrainer.train_epoch
        load = things_eeg._load_subject_file

        def epoch(trainer, e, *a, **k):
            if rec.resident_gb is None and rec.device.type == "cuda":
                rec.resident_gb = torch.cuda.memory_allocated() / 1e9
            rec.trainer = trainer
            t0 = time.perf_counter()
            metrics = train_epoch(trainer, e, *a, **k)
            rec.epochs.append({
                "epoch": int(e), "s": time.perf_counter() - t0,
                "loss": metrics["loss"],
                "step_loss": list(trainer.last_steps["step_loss"]),
                "step_ms": trainer.last_steps.get("step_ms")})
            return metrics

        def read(data_path, subject, train):
            cache = os.path.join(data_path, subject, (
                "preprocessed_eeg_training.npy" if train
                else "preprocessed_eeg_test.npy") + ".raw.npy")
            cached = os.path.exists(cache)
            t0 = time.perf_counter()
            out = load(data_path, subject, train)
            rec.reads.append({"train": bool(train), "sidecar": cached,
                              "s": time.perf_counter() - t0})
            return out

        self._saved = [
            (ContrastiveTrainer, "train_epoch", epoch),
            (ContrastiveTrainer, "evaluate",
             self._timed("evaluate", ContrastiveTrainer.evaluate)),
            (ContrastiveTrainer, "export_features",
             self._timed("export", ContrastiveTrainer.export_features)),
            (Checkpointer, "save", self._timed("checkpoint",
                                               Checkpointer.save)),
            (cli, "_build_retrieval_splits",
             self._timed("ingest", cli._build_retrieval_splits)),
            (things_eeg, "_load_subject_file", read)]
        self._orig = [(o, n, getattr(o, n)) for o, n, _ in self._saved]
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        return self

    def __exit__(self, *exc) -> None:
        for owner, name, fn in self._orig:
            setattr(owner, name, fn)


def run_cli(argv: list[str], device: torch.device) -> dict:
    """``cli.main(argv)`` in this process: its last JSON row, the run
    directory it names, seconds, peak device memory, host peak RSS."""
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with PeakRSS() as host, contextlib.redirect_stdout(buf):
        cli.main(argv)
    _sync(device)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    out = {"row": json.loads(lines[-1]), "s": time.perf_counter() - t0,
           "run_dir": next((ln.split(": ", 1)[1] for ln in lines
                            if ln.startswith("run directory: ")), None),
           "host_peak_rss_gb": host.peak / 1e9}
    if device.type == "cuda":
        out["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _epoch_rows(rec: Recorder) -> list[dict]:
    rows = []
    for e in rec.epochs:
        ms = e["step_ms"]
        p50 = float(np.median(ms[3:])) if ms and len(ms) > 3 else None
        rows.append({"epoch": e["epoch"], "s": e["s"], "loss": e["loss"],
                     "steps": len(e["step_loss"]), "step_ms_p50": p50})
    return rows


def _tree_bytes(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            kind = ("sidecar" if f.endswith((".raw.npy", ".meta.npz"))
                    else "pickle" if f.startswith("preprocessed_eeg")
                    else "run" if os.path.relpath(d, root).startswith("runs")
                    else "other")
            out[kind] = out.get(kind, 0) + os.path.getsize(os.path.join(d, f))
    return out


# ——— the rehearsal ———


def _read_all(a: np.ndarray, rows: int = 1024) -> float:
    """Every byte of a mapped array read once, in row chunks."""
    total = 0.0
    for r0 in range(0, len(a), rows):
        total += float(a[r0:r0 + rows].sum(dtype=np.float64))
    return total


def sidecar_reads(root: str) -> list[dict]:
    """Seconds to map each sidecar under ``root`` through ``NpyMmap`` (with
    its readahead) and to read it whole, and the same read through numpy's
    ``mmap_mode``; warm (the page cache is left as it is)."""
    from eeg_image_decode_tpu_torch.data.native_loader import NpyMmap

    rows = []
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            if not f.endswith(".raw.npy"):
                continue
            path = os.path.join(dirpath, f)
            t0 = time.perf_counter()
            m = NpyMmap(path)
            m.willneed()
            t1 = time.perf_counter()
            got = _read_all(m.array)
            t2 = time.perf_counter()
            a = np.load(path, mmap_mode="r")
            want = _read_all(a)
            t3 = time.perf_counter()
            rows.append({"file": f, "gb": m.array.nbytes / 1e9,
                         "native": m.is_native, "map_s": t1 - t0,
                         "read_s": t2 - t1, "numpy_read_s": t3 - t2,
                         "read_gb_per_s": m.array.nbytes / 1e9 / (t2 - t1),
                         "sums_equal": got == want})
            del a
            m.close()
    return rows


def rehearse(work: str, size: dict, device: torch.device, epochs: int,
             resume_epochs: int) -> dict:
    report: dict = {"size": {k: size[k] for k in ("n_cls", "ipc",
                                                   "train_reps", "n_test",
                                                   "test_reps", "batch")}}
    t0 = time.perf_counter()
    report["write"] = write_subject(work, size, device)
    report["write"]["s"] = time.perf_counter() - t0
    emit({"stage": "write", **report["write"]})
    feats = report["write"]["features"]["path"]
    common = ["--data-path", work, "--features", feats, "--subjects",
              "sub-01", "--device", device.type, "--dtype", size["dtype"]]
    if size["eval_ks"]:
        common += ["--eval-ks", size["eval_ks"]]
    train_args = [*common, "--batch-size", str(size["batch"]),
                  "--train-reps", str(size["train_reps"]),
                  "--output-dir", os.path.join(work, "runs")]

    # 1. from cold, then the uninterrupted epoch on the same trainer
    with Recorder(device) as cold:
        first = run_cli(["train-retrieval", *train_args, "--epochs",
                         str(epochs)], device)
    run_dir = first["run_dir"]
    trainer = cold.trainer
    trainer.train_epoch(epochs)
    uninterrupted = list(trainer.last_steps["step_loss"])
    del trainer, cold.trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    report["cold"] = {
        "s": first["s"], "ingest_s": cold.calls["ingest"],
        "reads": cold.reads, "epochs": _epoch_rows(cold),
        "evaluate_s": cold.calls.get("evaluate"),
        "checkpoint_s": cold.calls.get("checkpoint"),
        "resident_gb": cold.resident_gb,
        "peak_device_gb": first.get("peak_device_gb"),
        "host_peak_rss_gb": first["host_peak_rss_gb"]}
    emit({"stage": "train_cold", **report["cold"]})

    # 2. resumed from the sidecars, with the export
    export = os.path.join(work, "eeg_features.npz")
    with Recorder(device) as warm:
        second = run_cli(["train-retrieval", *train_args, "--epochs",
                          str(resume_epochs), "--resume-dir", run_dir,
                          "--export-features", export], device)
    resumed = warm.epochs[0]["step_loss"]
    delta = float(np.max(np.abs(np.subtract(resumed, uninterrupted))))
    report["resumed"] = {
        "s": second["s"], "ingest_s": warm.calls["ingest"],
        "reads": warm.reads, "epochs": _epoch_rows(warm),
        "evaluate_s": warm.calls.get("evaluate"),
        "checkpoint_s": warm.calls.get("checkpoint"),
        "export_s": warm.calls.get("export"),
        "resident_gb": warm.resident_gb,
        "peak_device_gb": second.get("peak_device_gb"),
        "host_peak_rss_gb": second["host_peak_rss_gb"],
        "first_loss": resumed[0], "uninterrupted_first_loss":
        uninterrupted[0], "max_abs_dloss": delta,
        "bit_equal": resumed == uninterrupted, "resume_tol": RESUME_TOL}
    emit({"stage": "train_resumed", **report["resumed"]})
    warm.trainer = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    report["sidecar_reads"] = sidecar_reads(work)
    emit({"stage": "sidecar_reads", "rows": report["sidecar_reads"]})

    # 3. evaluate on the run directory with the last evaluation's seed
    scored = run_cli(["evaluate", *common, "--run-dir", run_dir, "--seed",
                      str(EVAL_SEED_STRIDE * (resume_epochs - 1))], device)
    last = second["row"]
    tops = sorted(k for k in last if k.startswith("top"))
    differ = {k: (scored["row"].get(k), last[k]) for k in tops
              if scored["row"].get(k) != last[k]}
    report["evaluate"] = {"s": scored["s"], "row": scored["row"],
                          "trainer_row": {k: last[k] for k in tops},
                          "equal": not differ}
    emit({"stage": "evaluate", **report["evaluate"]})

    with open(os.path.join(run_dir, "results.csv"), newline="") as f:
        csv_epochs = [int(r["epoch"]) for r in csv.DictReader(f)]
    with np.load(export) as z:
        exported = {k: list(z[k].shape) for k in z.files}
        exported_finite = all(bool(np.isfinite(z[k]).all()) for k in z.files)
    steps = [e["step_ms"] for e in warm.epochs + cold.epochs
             if e["step_ms"] and len(e["step_ms"]) > 3]
    p50 = float(np.median(np.concatenate([s[3:] for s in steps]))) \
        if steps else None
    n_train = size["n_cls"] * size["ipc"] * size["train_reps"]
    report.update({
        "results_csv_epochs": csv_epochs, "exported": exported,
        "bytes": _tree_bytes(work), "step_ms_p50": p50,
        "samples_per_s": size["batch"] / (p50 / 1e3) if p50 else None,
        "training_steps": sum(len(e["step_loss"]) for e in
                              cold.epochs + warm.epochs) + len(uninterrupted),
        "ok": bool(csv_epochs == list(range(resume_epochs))
               and delta <= RESUME_TOL and not differ and exported_finite
               and exported.get("eeg_features", [0])[0] == n_train
               and cold.reads and all(not r["sidecar"] for r in cold.reads)
               and all(r["sidecar"] for r in warm.reads)
               and all(r["native"] and r["sums_equal"]
                       for r in report["sidecar_reads"]))})
    return report


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--work-dir", default=None,
                   help="parent of the temporary tree (default: the "
                        "system's temporary directory)")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--resume-epochs", type=int, default=4)
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.resume_epochs <= args.epochs:
        p.error("--resume-epochs must exceed --epochs")
    with tempfile.TemporaryDirectory(prefix="rehearse_fullscale_",
                                     dir=args.work_dir) as work:
        try:
            report = rehearse(work, TINY if args.tiny else FULL, device,
                              args.epochs, args.resume_epochs)
        finally:
            things_eeg.drop_sidecar_maps(work)
    emit(report)
    if not report["ok"]:
        raise RuntimeError(f"full-scale rehearsal failed: {report}")
    return report


if __name__ == "__main__":
    main()
