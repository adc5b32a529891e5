"""Checkpoints and resume of the port's trainer, on the CPU.

- ``Checkpointer``: round trip of the full train state (parameters,
  BatchNorm statistics, AdamW moments, step), ``latest_step`` /
  ``all_steps``, ``max_to_keep``, a half-written directory ignored, and
  ``FileNotFoundError`` on an empty directory.
- Kill and resume: a run stopped after two of four epochs and continued by a
  fresh model and trainer reproduces the uninterrupted run's history and
  final parameters bit for bit (every epoch's permutation and generator
  derive from (seed, epoch)).
- ``save_history`` / ``load_history``, ``run_directory``,
  ``export_features``.
"""

import os

import numpy as np
import pytest
import torch

from eeg_image_decode_tpu_torch.core.checkpoint import (
    Checkpointer,
    load_history,
    run_directory,
    save_history,
)
from eeg_image_decode_tpu_torch.core.config import (
    ATMSConfig,
    ContrastiveTrainConfig,
)
from eeg_image_decode_tpu_torch.data.synthetic import (
    make_synthetic_retrieval_data,
)
from eeg_image_decode_tpu_torch.models.registry import build_encoder
from eeg_image_decode_tpu_torch.train.contrastive import (
    ContrastiveTrainer,
    create_train_state,
)
from torch_port_case import SMALL
from torch_port_case import two_threads  # noqa: F401 (autouse)

C, T = SMALL["n_channels"], SMALL["seq_len"]
TIMING = ("epoch_time_s", "samples_per_s")


def _data():
    return make_synthetic_retrieval_data(
        n_classes=12, images_per_class=2, train_reps=2, n_channels=C,
        n_timepoints=T, clip_dim=SMALL["proj_dim"], seed=70, device="cpu")


def _trainer(out, *, every=1, seed=3, **cfg_kw):
    train, test = _data()
    cfg = ContrastiveTrainConfig(batch_size=8, eval_ks=(2, 4, 12), seed=seed,
                                 ckpt_every_epochs=every)
    model = build_encoder(
        "atms", device="cpu", seed=seed,
        config=ATMSConfig(**SMALL, joint_train=True, fused_projection=True,
                          **cfg_kw))
    return ContrastiveTrainer(
        model, cfg, train, test, device="cpu", output_dir=str(out),
        checkpointer=Checkpointer(os.path.join(out, "ckpt")))


def _one_step(state):
    """One optimizer step, so AdamW has moments to save."""
    loss = sum((p * p).sum() for p in state.model.parameters())
    loss.backward()
    state.optimizer.step()
    state.optimizer.zero_grad()
    state.step += 1


def test_round_trip_latest_step_and_max_to_keep(tmp_path):
    cfg = ContrastiveTrainConfig()
    state = create_train_state(
        build_encoder("atms", config=ATMSConfig(**SMALL), device="cpu"), cfg)
    ckpt = Checkpointer(str(tmp_path / "ckpt"), max_to_keep=2)
    assert ckpt.latest_step() is None and ckpt.all_steps() == []
    with pytest.raises(FileNotFoundError):
        ckpt.restore(None, state)
    _one_step(state)
    state.model.encoder.enc_eeg.bn1.mean.add_(0.25)  # a buffer that moved
    ckpt.save(1, state)
    one = Checkpointer(str(tmp_path / "one"))
    one.save(1, state)
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    exp_avg = {i: s["exp_avg"].clone()
               for i, s in state.optimizer.state_dict()["state"].items()}
    for step in (2, 3):
        _one_step(state)
        ckpt.save(step, state)
    assert ckpt.all_steps() == [2, 3] and ckpt.latest_step() == 3
    ckpt.save(1, state)  # an old step again: the two newest stay
    assert ckpt.all_steps() == [2, 3]
    ckpt.close()

    ckpt = one
    fresh = create_train_state(
        build_encoder("atms", config=ATMSConfig(**SMALL), device="cpu",
                      seed=9), cfg)
    assert ckpt.restore(None, fresh) is fresh and fresh.step == 1
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    got = fresh.optimizer.state_dict()["state"]
    assert len(got) == len(exp_avg) > 20
    for i, m in exp_avg.items():
        assert torch.equal(got[i]["exp_avg"], m)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(7, fresh)


def test_half_written_checkpoint_is_ignored(tmp_path):
    state = create_train_state(
        build_encoder("atms", config=ATMSConfig(**SMALL), device="cpu"),
        ContrastiveTrainConfig())
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(2, state)
    # a run killed mid-save leaves its temporary directory, and a step
    # directory without its state file is no checkpoint either
    os.makedirs(tmp_path / ".tmp-4-killed")
    (tmp_path / ".tmp-4-killed" / "state.pt").write_bytes(b"half")
    os.makedirs(tmp_path / "5")
    assert ckpt.all_steps() == [2] and ckpt.latest_step() == 2
    assert ckpt.restore(None, state).step == 0


def test_kill_and_resume_reproduces_history_bit_for_bit(tmp_path):
    full = _trainer(tmp_path / "full")
    want = full.fit(4, log_fn=None)
    assert full.checkpointer.all_steps() == [1, 2, 3, 4]

    first = _trainer(tmp_path / "run")
    first.fit(2, log_fn=None)
    del first                                    # the run is killed here
    resumed = _trainer(tmp_path / "run", seed=3)  # a fresh model and trainer
    assert resumed.resume() == 2 and resumed.state.step == 2 * 6
    assert [r["epoch"] for r in resumed.history] == [0, 1]
    got = resumed.fit(4, log_fn=None)
    assert [r["epoch"] for r in got] == [0, 1, 2, 3]
    for a, b in zip(got, want):
        for k in b:
            if k not in TIMING:
                assert a[k] == b[k], (b["epoch"], k)
    for (k, p), (_, q) in zip(resumed.model.state_dict().items(),
                              full.model.state_dict().items()):
        assert torch.equal(p, q), k
    rows = (tmp_path / "run" / "results.csv").read_text().splitlines()
    assert len(rows) == 5


def test_checkpoint_cadence_final_save_and_resume_without_checkpoint(tmp_path):
    t = _trainer(tmp_path / "a", every=2)
    t.fit(3, log_fn=None)
    assert t.checkpointer.all_steps() == [2, 3]   # every 2, and the last
    fresh = _trainer(tmp_path / "b")
    with pytest.raises(FileNotFoundError):
        fresh.resume()
    train, test = _data()
    bare = ContrastiveTrainer(fresh.model, fresh.cfg, train, test,
                              device="cpu")
    with pytest.raises(ValueError, match="checkpointer"):
        bare.resume()


def test_history_files_run_directory_and_export_features(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    rows = [{"epoch": 0, "loss": 2.0}, {"epoch": 1, "loss": 1.5}]
    assert load_history(ckpt, 5) == []
    save_history(ckpt, rows)
    assert load_history(ckpt, 1) == rows[:1] and load_history(ckpt, 2) == rows
    assert run_directory("r", "atms", "sub-01", "x") == os.path.join(
        "r", "contrast", "atms", "sub-01", "x")

    t = _trainer(tmp_path / "run")
    path = t.export_features(str(tmp_path / "out" / "feats.npz"))
    with np.load(path) as z:
        assert z["eeg_features"].shape == (48, SMALL["proj_dim"])
        assert z["eeg_features_test"].shape == (12, SMALL["proj_dim"])
        assert z["img_features"].shape == (48, SMALL["proj_dim"])
        np.testing.assert_array_equal(z["labels_test"], np.arange(12))
