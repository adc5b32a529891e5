"""The encoder zoo through the port's CLI, on the CPU.

On a tree written by ``data/synthetic.py::write_synthetic_things_tree``,
all with ``--device cpu --dtype float32``: ``train-retrieval --encoder
nice`` for 2 epochs and ``--resume-dir`` to 3 (exporting its features),
bit-equal to an uninterrupted 3-epoch run (rows and weights); ``evaluate --run-dir`` equal
to the trainer's row; ``serve --run-dir --encoder nice`` through
``cli.build_retrieval``; ``--encoder eegnetv4`` for one epoch, evaluated
and served; ``export-checkpoint`` on a NICE run exits naming the cause;
``cli smoke`` prints JAX ``cmd_smoke``'s keys with values in [0, 1].
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_image_decode_tpu.train.evaluator import (
    retrieval_eval as jax_retrieval_eval,
)
from eeg_image_decode_tpu_torch import cli
from eeg_image_decode_tpu_torch.core.checkpoint import Checkpointer
from eeg_image_decode_tpu_torch.core.config import ContrastiveTrainConfig
from eeg_image_decode_tpu_torch.data.features import load_features
from eeg_image_decode_tpu_torch.data.synthetic import (
    write_synthetic_things_tree,
)
from eeg_image_decode_tpu_torch.models.registry import build_encoder
from eeg_image_decode_tpu_torch.train.contrastive import create_train_state


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's
    cores, and each PyTorch process would otherwise take them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One subject, 4 train classes × 10 images × 1 repetition and 3 test
    concepts × 3 repetitions, at the real 63 × 250 epoch shape."""
    root = tmp_path_factory.mktemp("things")
    feats = write_synthetic_things_tree(
        str(root), ("sub-01",), n_classes=4, n_test_classes=3,
        train_reps=1, test_reps=3, seed=81)
    return str(root), feats


def _common(tree):
    root, feats = tree
    return ["--data-path", root, "--features", feats, "--device", "cpu",
            "--dtype", "float32", "--eval-ks", "2,3", "--subjects", "sub-01"]


def _last_json(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    run_dir = next((ln.split(": ", 1)[1] for ln in lines
                    if ln.startswith("run directory: ")), None)
    return json.loads(lines[-1]), run_dir


def _rows(run_dir):
    with open(os.path.join(run_dir, "results.csv"), newline="") as f:
        return list(csv.DictReader(f))


def _weights(run_dir, encoder):
    model = build_encoder(encoder, device="cpu")
    Checkpointer(os.path.join(run_dir, "ckpt")).restore(
        None, create_train_state(model, ContrastiveTrainConfig()))
    return model


def _served_top_k_is_the_models(tree, run_dir, encoder):
    """``serve --run-dir --encoder`` gives the ranking of the restored
    model's own features against the gallery."""
    _, feats = tree
    args = cli.build_parser().parse_args([
        "serve", "--run-dir", run_dir, "--encoder", encoder, "--features",
        feats, "--dtype", "float32", "--max-batch", "8", "--device", "cpu"])
    svc = cli.build_retrieval(args)
    model = _weights(run_dir, encoder).eval()
    eeg = np.random.default_rng(82).normal(size=(5, 63, 250)).astype(
        np.float32)
    sids = np.zeros(5, np.int32)
    with torch.no_grad():
        f, scale = model(torch.from_numpy(eeg), torch.from_numpy(sids))
    gallery = load_features(feats)["img_features_test"]
    logits = scale.item() * f.numpy() @ gallery.T
    _, got = svc.top_k(eeg, sids, k=3)
    np.testing.assert_array_equal(got, np.argsort(-logits, axis=1)[:, :3])


def test_nice_train_resume_evaluate_serve_and_export(tree, tmp_path, capsys):
    train = [*_common(tree), "--encoder", "nice", "--batch-size", "4",
             "--train-reps", "1", "--seed", "5"]
    cli.main(["train-retrieval", *train, "--epochs", "2", "--output-dir",
              str(tmp_path / "a")])
    row2, run_dir = _last_json(capsys)
    assert row2["epoch"] == 1 and np.isfinite(row2["loss"])
    assert os.sep.join(("contrast", "nice", "sub-01")) in run_dir
    export = str(tmp_path / "pairs.npz")
    cli.main(["train-retrieval", *train, "--epochs", "3", "--resume-dir",
              run_dir, "--export-features", export])
    row3, _ = _last_json(capsys)
    assert row3["epoch"] == 2
    with np.load(export) as z:
        assert z["eeg_features"].shape == (4 * 10, 1024)
        assert z["eeg_features_test"].shape == (3, 1024)

    cli.main(["train-retrieval", *train, "--epochs", "3", "--output-dir",
              str(tmp_path / "b")])
    whole, whole_dir = _last_json(capsys)
    skip = ("epoch_time_s", "samples_per_s")
    for got, want in zip(_rows(run_dir), _rows(whole_dir), strict=True):
        assert {k: v for k, v in got.items() if k not in skip} == \
            {k: v for k, v in want.items() if k not in skip}
    resumed = _weights(run_dir, "nice").state_dict()
    for k, v in _weights(whole_dir, "nice").state_dict().items():
        torch.testing.assert_close(resumed[k], v, rtol=0, atol=0)

    # the trainer's evaluation after epoch e draws from seed + 104729·e
    cli.main(["evaluate", *_common(tree), "--encoder", "nice", "--run-dir",
              run_dir, "--seed", str(5 + 104729 * 2)])
    scored, _ = _last_json(capsys)
    assert scored["step"] == 3
    for k in ("top1_k2", "top1_k3"):
        assert scored[k] == row3[k], k

    _served_top_k_is_the_models(tree, run_dir, "nice")
    with pytest.raises(SystemExit, match="not ATM-S's"):
        cli.main(["export-checkpoint", "--run-dir", run_dir, "--out",
                  str(tmp_path / "nice.pth"), "--device", "cpu"])


def test_eegnetv4_train_evaluate_and_serve(tree, tmp_path, capsys):
    cli.main(["train-retrieval", *_common(tree), "--encoder", "eegnetv4",
              "--batch-size", "8", "--train-reps", "1", "--seed", "3",
              "--epochs", "1", "--output-dir", str(tmp_path)])
    row, run_dir = _last_json(capsys)
    assert row["epoch"] == 0 and np.isfinite(row["loss"])
    assert os.sep.join(("contrast", "eegnetv4", "sub-01")) in run_dir
    cli.main(["evaluate", *_common(tree), "--encoder", "eegnetv4",
              "--run-dir", run_dir, "--seed", "3"])
    scored, _ = _last_json(capsys)
    assert scored["step"] == 1
    for k in ("top1_k2", "top1_k3"):
        assert scored[k] == row[k], k
    _served_top_k_is_the_models(tree, run_dir, "eegnetv4")
    with pytest.raises(SystemExit, match="does not match encoder 'nice'"):
        cli.main(["evaluate", *_common(tree), "--encoder", "nice",
                  "--run-dir", run_dir])


def test_cli_smoke_prints_jax_keys(capsys):
    """JAX's ``cmd_smoke`` prints ``retrieval_eval`` at ks (2, 16) over its
    16 test classes: the same keys, each an accuracy in [0, 1]."""
    cli.main(["smoke", "--device", "cpu"])
    printed, _ = _last_json(capsys)
    rng = np.random.default_rng(0)
    want = jax_retrieval_eval(
        jnp.asarray(rng.normal(size=(16, 8))),
        jnp.asarray(rng.normal(size=(16, 8))), jnp.arange(16), ks=(2, 16),
        key=jax.random.key(1))
    assert sorted(printed) == sorted(want) == ["top1_k16", "top1_k2"]
    assert all(0.0 <= v <= 1.0 for v in printed.values())
