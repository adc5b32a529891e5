"""The port's THINGS-EEG ingestion and training CLI, on the CPU.

- ``build_retrieval_data`` against the JAX function on one written tree:
  in-subject, joint (two subjects), leave-one-out, the un-averaged test
  split, and the THINGS-MEG 12 × 1 layout with the error its default 10 × 4
  reading must raise. Equal arrays: both sides are numpy.
- ``cli train-retrieval`` → ``--resume-dir`` → ``evaluate`` → ``--sweep``
  with ``--device cpu`` on a tree written by
  ``data/synthetic.py::write_synthetic_things_tree``; ``evaluate`` returns
  the trainer's own last evaluation; the scale-out flags (``--mesh``,
  ``--multihost``, ``--shard-data``) run or name what they need.
"""

import csv
import dataclasses
import json
import os
import pickle

import numpy as np
import pytest

from eeg_image_decode_tpu.data import things_eeg as jax_things
from eeg_image_decode_tpu_torch import cli
from eeg_image_decode_tpu_torch.data import things_eeg
from eeg_image_decode_tpu_torch.data.features import (
    cache_path,
    clip_cache_path,
    load_features,
    save_features,
)
from eeg_image_decode_tpu_torch.data.synthetic import (
    write_synthetic_things_tree,
)
from torch_port_case import run_cli_child
from torch_port_case import two_threads  # noqa: F401 (autouse)


SUBJECTS = ("sub-01", "sub-02")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two subjects, 4 train classes × 10 images (the EEG layout's fixed
    count) × 1 repetition and 3 test concepts × 3 repetitions, at the real
    63 × 250 epoch shape."""
    root = tmp_path_factory.mktemp("things")
    feats = write_synthetic_things_tree(
        str(root), SUBJECTS, n_classes=4, n_test_classes=3,
        train_reps=1, test_reps=3, seed=80)
    return str(root), feats


def _same(a, b):
    for f in dataclasses.fields(things_eeg.EEGRetrievalData):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("case", ["in_subject", "joint", "leave_one_out",
                                  "test_not_averaged"])
def test_build_retrieval_data_matches_jax(tree, case):
    root, feats_path = tree
    feats = load_features(feats_path)
    kw = {"in_subject": dict(subjects=["sub-01"]),
          "joint": dict(subjects=list(SUBJECTS)),
          "leave_one_out": dict(subjects=list(SUBJECTS),
                                exclude_subject="sub-02"),
          "test_not_averaged": dict(subjects=list(SUBJECTS),
                                    average_test_reps=False)}[case]
    for train in (True, False):
        img = feats["img_features" if train else "img_features_test"]
        txt = feats["text_features" if train else "text_features_test"]
        extra = dict(train_reps=1) if train else {}
        args = dict(train=train, img_features=img, text_features=txt, **kw,
                    **extra)
        subjects = args.pop("subjects")
        want = jax_things.build_retrieval_data(root, subjects, **args)
        got = things_eeg.build_retrieval_data(root, subjects, **args)
        _same(got, want)
    assert got.eeg.shape[1:] == (63, 250)
    assert things_eeg.extract_subject_id("sub-08") == 8
    assert things_eeg.extract_subject_id("pilot") == -1


def test_meg_layout_and_its_error(tmp_path):
    """THINGS-MEG: 'meg' file names, a 'meg_data' key, (classes, 12 images,
    1 repetition, C, T). Read as 12 × 1 it equals the JAX loader; read with
    the EEG default 10 × 4 it must raise, not pair rows with wrong images."""
    rng = np.random.default_rng(81)
    n_cls, C, T = 5, 6, 40
    sub = tmp_path / "sub-01"
    os.makedirs(sub)
    data = rng.normal(size=(n_cls, 12, 1, C, T)).astype(np.float32)
    with open(sub / "preprocessed_meg_train.npy", "wb") as f:
        pickle.dump({"meg_data": data, "times": np.linspace(0, 1, T),
                     "ch_names": []}, f, protocol=4)
    img = rng.normal(size=(n_cls * 12, 8)).astype(np.float32)
    txt = rng.normal(size=(n_cls, 8)).astype(np.float32)
    kw = dict(train=True, img_features=img, text_features=txt)
    want = jax_things.build_retrieval_data(
        str(tmp_path), ["sub-01"], images_per_class=12, train_reps=1, **kw)
    got = things_eeg.build_retrieval_data(
        str(tmp_path), ["sub-01"], images_per_class=12, train_reps=1, **kw)
    _same(got, want)
    assert got.n == n_cls * 12 and got.images_per_class == 12
    # the second read goes through the sidecar cache numpy maps
    assert (sub / "preprocessed_meg_train.npy.raw.npy").exists()
    with pytest.raises(ValueError, match="images-per-class 12"):
        things_eeg.build_retrieval_data(str(tmp_path), ["sub-01"], **kw)


def test_time_window_is_cut_as_one_slice(tree):
    """The window of a monotone time grid is one run of samples, taken as
    a slice (a view; a boolean index gathers every element); a mask with a
    gap stays a mask. The split read back through the mapped sidecar
    cache is the JAX loader's, in a writable array of its own."""
    mask = np.zeros(300, bool)
    mask[50:] = True
    assert things_eeg._window_index(mask) == slice(50, 300)
    mask[100] = False
    assert things_eeg._window_index(mask) is mask
    assert things_eeg._window_index(np.zeros(4, bool)).dtype == bool
    root, _ = tree
    for _ in range(2):  # the first read may write the sidecar; the second maps it
        eeg, labels = things_eeg.load_things_eeg_subject(root, "sub-01",
                                                         train=True)
    want, want_labels = jax_things.load_things_eeg_subject(root, "sub-01",
                                                           train=True)
    np.testing.assert_array_equal(eeg, want)
    np.testing.assert_array_equal(labels, want_labels)
    assert eeg.flags.c_contiguous and eeg.flags.writeable
    assert eeg.flags.owndata


def test_feature_cache_paths_and_round_trip(tmp_path):
    from eeg_image_decode_tpu.data import features as jax_features

    paths = ["a/1.jpg", "b/2.jpg"]
    assert cache_path("c", "ViT-H/14", "train", paths) == \
        jax_features.cache_path("c", "ViT-H/14", "train", paths)
    assert clip_cache_path("c", "test", paths, normalize_img=False) == \
        jax_features.clip_cache_path("c", "test", paths, normalize_img=False)
    dest = str(tmp_path / "sub" / "f.npz")
    save_features(dest, img_features=np.ones((2, 3)),
                  text_features=np.zeros((1, 3)), extra=np.arange(2))
    back = load_features(dest)
    assert back["img_features"].dtype == np.float32
    assert set(back) == {"img_features", "text_features", "extra"}


def _last_json(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    run_dir = next((ln.split(": ", 1)[1] for ln in lines
                    if ln.startswith("run directory: ")), None)
    return json.loads(lines[-1]), run_dir


def test_cli_train_resume_evaluate_and_sweep(tree, tmp_path, capsys):
    root, feats = tree
    common = ["--data-path", root, "--features", feats, "--device", "cpu",
              "--dtype", "float32", "--eval-ks", "2,3", "--batch-size", "4",
              "--train-reps", "1"]
    out = str(tmp_path / "runs")
    seed = 5
    cli.main(["train-retrieval", *common, "--output-dir", out, "--seed",
              str(seed), "--epochs", "2", "--joint", "--subjects", "all",
              "--test-subject", "sub-02"])
    row2, run_dir = _last_json(capsys)
    assert row2["epoch"] == 1 and np.isfinite(row2["loss"])
    assert run_dir.startswith(os.path.join(out, "contrast", "atms", "sub-02"))
    assert sorted(os.listdir(os.path.join(run_dir, "ckpt"))) == ["2"]

    export = str(tmp_path / "feats.npz")
    cli.main(["train-retrieval", *common, "--resume-dir", run_dir, "--seed",
              str(seed), "--epochs", "3", "--joint", "--subjects", "all",
              "--test-subject", "sub-02", "--export-features", export])
    row3, _ = _last_json(capsys)
    assert row3["epoch"] == 2
    with open(os.path.join(run_dir, "results.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["epoch"]) for r in rows] == [0, 1, 2]
    assert float(rows[1]["loss"]) == row2["loss"]
    with np.load(export) as z:
        assert z["eeg_features"].shape == (2 * 4 * 10, 1024)
        assert z["eeg_features_test"].shape == (3, 1024)

    # the trainer's evaluation after epoch e draws from seed + 104729·e
    csv_path = str(tmp_path / "eval" / "row.csv")
    cli.main(["evaluate", *common[:10], "--run-dir", run_dir, "--joint",
              "--subjects", "all", "--test-subject", "sub-02", "--seed",
              str(seed + 104729 * 2), "--csv", csv_path])
    scored, _ = _last_json(capsys)
    assert scored["step"] == 3 and scored["n_test"] == 3
    for k in ("top1_k2", "top1_k3"):
        assert scored[k] == row3[k], k
    assert os.path.exists(csv_path)
    with pytest.raises(SystemExit, match="does not match"):
        cli.main(["evaluate", *common[:10], "--run-dir", run_dir,
                  "--subjects", "sub-02"])     # not --joint: other parameters

    sweep = str(tmp_path / "sweep")
    cli.main(["train-retrieval", *common, "--output-dir", sweep, "--epochs",
              "1", "--sweep", "--subjects", ",".join(SUBJECTS)])
    rows, _ = _last_json(capsys)
    assert [r["subject"] for r in rows] == list(SUBJECTS)
    with open(os.path.join(sweep, "sweep_summary.csv"), newline="") as f:
        assert [r["subject"] for r in csv.DictReader(f)] == list(SUBJECTS)
    for sub in SUBJECTS:
        assert os.listdir(os.path.join(sweep, "contrast", "atms", sub))


@pytest.mark.parametrize("flag", ["--mesh", "--multihost", "--shard-data"])
def test_cli_refuses_scale_out_flags_naming_the_roadmap(tree, flag, tmp_path,
                                                       monkeypatch):
    """The scale-out flags are ported (ROADMAP.md §1 item 3): each runs, or
    exits naming what it needs. ``--mesh`` without a launcher on the CPU is
    one rank (in a child process: the group outlives the call);
    ``--multihost`` needs the launcher's variables and ``--shard-data`` a
    mesh."""
    root, feats = tree
    argv = ["train-retrieval", "--data-path", root, "--features", feats,
            "--device", "cpu", "--dtype", "float32", "--eval-ks", "2,3",
            "--batch-size", "4", "--train-reps", "1", "--epochs", "1",
            "--output-dir", str(tmp_path), flag]
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    if flag == "--mesh":
        lines = run_cli_child(argv)
        assert "mesh: 1 rank(s), backend gloo" in lines
        assert np.isfinite(json.loads(lines[-1])["loss"])
        return
    want = {"--multihost": "RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT",
            "--shard-data": "--shard-data needs --mesh"}[flag]
    with pytest.raises(SystemExit, match=want):
        cli.main(argv)


def test_cli_other_encoders_and_missing_inputs_raise(tree):
    root, feats = tree
    with pytest.raises(KeyError, match="unknown encoder"):
        cli.main(["train-retrieval", "--data-path", root, "--features", feats,
                  "--device", "cpu", "--encoder", "nicer"])
    with pytest.raises(SystemExit, match="--data-path"):
        cli.main(["train-retrieval", "--features", feats, "--device", "cpu"])
    with pytest.raises(SystemExit, match="--sweep"):
        cli.main(["train-retrieval", "--data-path", root, "--features", feats,
                  "--device", "cpu", "--sweep", "--joint"])


@pytest.mark.parametrize("joint", [False, True])
def test_cli_serve_restores_a_trained_run(tree, tmp_path, capsys, joint):
    """``serve --run-dir`` restores what ``train-retrieval`` wrote (in-subject
    and joint): the service's top-k equals the ranking of the restored
    model's own features against the gallery. A joint run served without
    ``--joint`` (or the other way round) exits naming the flag, and
    ``--weights`` with ``--run-dir`` is refused."""
    import torch

    from eeg_image_decode_tpu_torch.core.checkpoint import Checkpointer
    from eeg_image_decode_tpu_torch.core.config import (
        ATMSConfig,
        ContrastiveTrainConfig,
    )
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.train.contrastive import (
        create_train_state,
    )

    root, feats = tree
    subjects = ["--joint", "--subjects", "all", "--test-subject",
                "sub-02"] if joint else ["--subjects", "sub-01"]
    cli.main(["train-retrieval", "--data-path", root, "--features", feats,
              "--device", "cpu", "--dtype", "float32", "--eval-ks", "2,3",
              "--batch-size", "4", "--train-reps", "1", "--epochs", "2",
              "--output-dir", str(tmp_path / "runs"), *subjects])
    _, run_dir = _last_json(capsys)

    serve = ["serve", "--run-dir", run_dir, "--features", feats,
             "--dtype", "float32", "--max-batch", "8", "--device", "cpu"]
    args = cli.build_parser().parse_args(serve + (["--joint"] if joint
                                                  else []))
    svc = cli.build_retrieval(args)
    model = build_encoder("atms", config=ATMSConfig(joint_train=joint),
                          device="cpu", seed=99)
    Checkpointer(os.path.join(run_dir, "ckpt")).restore(
        None, create_train_state(model, ContrastiveTrainConfig()))
    rng = np.random.default_rng(82)
    eeg = rng.normal(size=(5, 63, 250)).astype(np.float32)
    sids = np.asarray([0, 1, 0, 1, 1], np.int32)
    with torch.no_grad():
        f, scale = model.eval()(torch.from_numpy(eeg), torch.from_numpy(sids))
    gallery = load_features(feats)["img_features_test"]
    logits = float(scale) * f.numpy() @ gallery.T
    _, got = svc.top_k(eeg, sids, k=3)
    np.testing.assert_array_equal(got, np.argsort(-logits, axis=1)[:, :3])

    other = cli.build_parser().parse_args(serve + ([] if joint
                                                   else ["--joint"]))
    with pytest.raises(SystemExit, match=f"joint={not joint}"):
        cli.build_retrieval(other)
    both = cli.build_parser().parse_args(serve + ["--weights", "w.npz"])
    with pytest.raises(SystemExit, match="not both"):
        cli.build_retrieval(both)
