"""``cli preprocess`` and ``cli preprocess-meg`` of the port against the JAX
CLI, on the CPU.

- ``preprocess --device cpu`` and JAX's ``preprocess`` on one written raw
  tree (``data/synthetic.py::write_synthetic_raw_tree``: two sessions, the
  first saved as a 0-d object array, the second pickled): the same files,
  equal ``ch_names`` and ``times``, the data within 1e-5 of the largest
  value; the port's ``train-retrieval`` and ``evaluate --device cpu`` then
  read the output (251 samples a trial), and ``serve --timepoints 251``
  serves the run. Without CUDA the default device raises.
- ``preprocess-meg`` on an epochs npz shaped as ``tests/test_utils_meg.py``
  builds it, with and without ``--image-concept-csv``: equal arrays and the
  same summary; the port's loader reads the pickles back.
  ``_load_concept_index`` exits on JAX's error cases with JAX's messages.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from eeg_image_decode_tpu import cli as jax_cli
from eeg_image_decode_tpu_torch import cli
from eeg_image_decode_tpu_torch.data.synthetic import write_synthetic_raw_tree
from eeg_image_decode_tpu_torch.data.things_eeg import build_retrieval_data

N_TRAIN_COND, N_TEST_COND = 20, 3   # 2 classes of 10 images; 3 concepts


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _raw(project):
    return write_synthetic_raw_tree(
        str(project), sub=1, n_ses=2, n_train_conditions=N_TRAIN_COND,
        n_test_conditions=N_TEST_COND, seed=31)


def test_cli_preprocess_matches_jax_and_feeds_training(tmp_path, capsys):
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    _raw(mine)
    _raw(theirs)
    argv = ["preprocess", "--sub", "1", "--n-ses", "2", "--seed", "11"]
    cli.main([*argv, "--project-dir", str(mine), "--device", "cpu"])
    jax_cli.main([*argv, "--project-dir", str(theirs)])
    rel = os.path.join("Preprocessed_data_250Hz", "sub-01")
    assert sorted(os.listdir(mine / rel)) == sorted(os.listdir(theirs / rel))
    shapes = {}
    for name in ("preprocessed_eeg_test.npy",
                 "preprocessed_eeg_training.npy"):
        got, want = _load(mine / rel / name), _load(theirs / rel / name)
        assert got.keys() == want.keys()
        assert got["ch_names"] == want["ch_names"]
        np.testing.assert_array_equal(got["times"], want["times"])
        a, b = got["preprocessed_eeg_data"], want["preprocessed_eeg_data"]
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())
        shapes[name] = a.shape
    assert shapes["preprocessed_eeg_training.npy"] == (N_TRAIN_COND, 4, 63,
                                                       251)
    assert shapes["preprocessed_eeg_test.npy"] == (N_TEST_COND, 40, 63, 251)

    # the port trains and scores on what it wrote
    rng = np.random.default_rng(3)

    def unit(n):
        a = rng.normal(size=(n, 1024))
        return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(
            np.float32)

    feats = str(tmp_path / "features.npz")
    np.savez(feats, img_features=unit(N_TRAIN_COND),
             text_features=unit(N_TRAIN_COND // 10),
             img_features_test=unit(N_TEST_COND),
             text_features_test=unit(N_TEST_COND))
    common = ["--data-path", str(mine / "Preprocessed_data_250Hz"),
              "--features", feats, "--device", "cpu", "--dtype", "float32",
              "--eval-ks", "2,3", "--subjects", "sub-01"]
    cli.main(["train-retrieval", *common, "--batch-size", "16", "--epochs",
              "1", "--output-dir", str(tmp_path / "runs")])
    out = capsys.readouterr().out.strip().splitlines()
    row = json.loads(out[-1])
    run_dir = next(ln.split(": ", 1)[1] for ln in out
                   if ln.startswith("run directory: "))
    assert row["epoch"] == 0 and np.isfinite(row["loss"])
    cli.main(["evaluate", *common, "--run-dir", run_dir])
    scored = _last_json(capsys)
    assert {k: scored[k] for k in ("top1_k2", "top1_k3")} == {
        k: row[k] for k in ("top1_k2", "top1_k3")}
    svc = cli.build_retrieval(cli.build_parser().parse_args([
        "serve", "--run-dir", run_dir, "--features", feats, "--timepoints",
        "251", "--dtype", "float32", "--device", "cpu"]))
    eeg = _load(mine / rel / "preprocessed_eeg_test.npy")[
        "preprocessed_eeg_data"].mean(axis=1)
    _, idx = svc.top_k(eeg, np.full(len(eeg), 1, np.int32), k=2)
    assert idx.shape == (N_TEST_COND, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([*argv, "--project-dir", str(mine)])


C, T = 6, 40
TIMES = np.linspace(-0.1, 1.1, T)


def _meg_npz(path, events, seed):
    rng = np.random.default_rng(seed)
    events = np.asarray(events)[rng.permutation(len(events))]
    # each epoch's value is its event id, so grouping shows in the values
    data = (np.zeros((len(events), C, T), np.float32)
            + events[:, None, None].astype(np.float32)
            + rng.normal(size=(len(events), C, T)).astype(np.float32) * 0.01)
    np.savez(path, epochs=data, event_ids=events, times=TIMES,
             ch_names=np.asarray([f"MEG{i:03d}" for i in range(C)]))
    return path


@pytest.mark.parametrize("level", ["image", "concept"])
def test_cli_preprocess_meg_matches_jax(tmp_path, capsys, level):
    if level == "image":
        # concepts 1..5 × 3 images (ids 1..15); image 13 is zero-shot
        # (4 repetitions), 14-15 overlap its concept and drop; catch trials
        events = (list(range(1, 13)) + [13] * 4 + [14, 15] + [999999] * 3)
        csv = tmp_path / "image_concept_index.csv"
        csv.write_text("concept\n" + "\n".join(
            f"{c},x" for c in [1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5]))
        extra = ["--image-concept-csv", str(csv)]
    else:
        events = [c for c in (1, 2, 3, 4) for _ in range(3)] + [100] * 4 \
            + [999999] * 2
        extra = []
    npz = _meg_npz(str(tmp_path / "meg.npz"), events, seed=4)
    argv = ["preprocess-meg", "--epochs", npz, "--test-reps", "4",
            "--train-reps", "3", *extra]
    mine, theirs = str(tmp_path / "port" / "sub-01"), str(tmp_path / "jax")
    cli.main([*argv, "--out", mine])
    got = _last_json(capsys)
    jax_cli.main([*argv, "--out", theirs])
    want = _last_json(capsys)
    assert {k: v for k, v in got.items() if k != "out"} == {
        k: v for k, v in want.items() if k != "out"}
    assert got["train_shape"] == [4, 3, 1, C, int(((TIMES >= 0)
                                                   & (TIMES <= 1)).sum())]
    for name in ("preprocessed_meg_train.npy", "preprocessed_meg_test.npy"):
        a, b = _load(os.path.join(mine, name)), _load(
            os.path.join(theirs, name))
        assert a["ch_names"] == b["ch_names"]
        np.testing.assert_array_equal(a["times"], b["times"])
        np.testing.assert_array_equal(a["meg_data"], b["meg_data"])
    # the port's loader reads them: 4 concepts × 3 images × 1 repetition
    d = build_retrieval_data(
        str(tmp_path / "port"), ["sub-01"], train=True,
        img_features=np.zeros((12, 8), np.float32),
        text_features=np.zeros((4, 8), np.float32), images_per_class=3,
        train_reps=1)
    assert d.eeg.shape == (12, C, got["train_shape"][-1])
    np.testing.assert_array_equal(d.labels, np.repeat(np.arange(4), 3))


@pytest.mark.parametrize("text", [
    "1\n2\n3\n", "image_concept\n4 9\n5,1\n\n6\n", "NaN\n1\n", "1.5\n2\n",
    "1\nabc\n", "", "0\n2\n", "concept\n"])
def test_load_concept_index_matches_jax(tmp_path, text):
    path = tmp_path / "c.csv"
    path.write_text(text)
    try:
        want = jax_cli._load_concept_index(str(path))
    except SystemExit as e:
        with pytest.raises(SystemExit) as got:
            cli._load_concept_index(str(path))
        assert str(got.value) == str(e)
        return
    np.testing.assert_array_equal(cli._load_concept_index(str(path)), want)
