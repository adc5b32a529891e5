"""The port's data-parallel trainers on two gloo ranks on the CPU
(``tests/_torch_dist_worker.py``), each against the port's one-process run.

- ``PriorPipe(mesh=…)`` and ``LowLevelTrainer(mesh=…)``: two epochs of the
  global batch (the losses within 1e-5 relative of the one-process run; the
  low-level trainer's second epoch within its 1e-4), the ranks' parameters
  bit-equal.
- ``SubjectParallelSweep``: three lanes on two ranks (lanes 0 and 2 on rank
  0), each lane bit-equal to its sequential ``ContrastiveTrainer`` run, and
  a lane whose loss is not finite stops alone.
- ``cli train-retrieval --mesh`` on a written tree: the two-rank run writes
  the one-process run's ``results.csv`` (losses within 1e-5 relative), and
  only rank 0 writes.
"""

import csv
import dataclasses
import glob
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from eeg_image_decode_tpu_torch import cli
from eeg_image_decode_tpu_torch.core.config import (
    ATMSConfig,
    ContrastiveTrainConfig,
    LowLevelConfig,
    PriorConfig,
)
from eeg_image_decode_tpu_torch.data.synthetic import (
    make_synthetic_retrieval_data,
    write_synthetic_things_tree,
)
from eeg_image_decode_tpu_torch.models.lowlevel import EncoderLowLevel
from eeg_image_decode_tpu_torch.models.registry import build_encoder
from eeg_image_decode_tpu_torch.train.contrastive import ContrastiveTrainer
from eeg_image_decode_tpu_torch.train.lowlevel import LowLevelTrainer
from eeg_image_decode_tpu_torch.train.prior import PriorPipe
from eeg_image_decode_tpu_torch.train.sweep import SubjectParallelSweep
from torch_port_case import SMALL, launch_ranks
from torch_port_case import two_threads  # noqa: F401 (autouse)

W = 2
LOWLEVEL_MODEL = dict(n_channels=8, seq_len=40, time_proj_dim=8,
                      stage_channels=(32, 16, 8, 8, 8, 8))
CLI_ARGS = ["--device", "cpu", "--dtype", "float32", "--eval-ks", "2,3",
            "--batch-size", "4", "--train-reps", "1", "--epochs", "2"]


def _sweep_inputs():
    trains, tests = [], []
    for lane in range(3):
        tr, te = make_synthetic_retrieval_data(
            n_classes=8, images_per_class=2, train_reps=2, n_channels=8,
            n_timepoints=100, clip_dim=SMALL["proj_dim"], seed=150 + lane,
            device="cpu")
        if lane == 2:  # a lane whose loss is not finite
            tr = dataclasses.replace(tr, eeg=torch.full_like(tr.eeg, np.nan))
        trains.append(tr)
        tests.append(te)
    return {"cfg": SMALL, "seeds": [4, 5, 6], "trains": trains,
            "tests": tests,
            "tcfg": ContrastiveTrainConfig(batch_size=8, eval_ks=(2, 4))}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("world2"))
    rng = np.random.default_rng(151)
    prior = {"cfg": PriorConfig.tiny(),
             "c": rng.normal(size=(32, 64)).astype(np.float32),
             "h": rng.normal(size=(32, 64)).astype(np.float32)}
    torch.save(prior, os.path.join(d, "prior.pt"))
    low = {"cfg": LowLevelConfig(n_channels=8, seq_len=40, time_proj_dim=8,
                                 batch_size=4),
           "model": LOWLEVEL_MODEL,
           "eeg": rng.normal(size=(16, 8, 40)).astype(np.float32),
           "lat": rng.normal(size=(16, 4, 64, 64)).astype(np.float32)}
    torch.save(low, os.path.join(d, "lowlevel.pt"))
    sweep = _sweep_inputs()
    torch.save(sweep, os.path.join(d, "sweep.pt"))
    root = os.path.join(d, "things")
    feats = write_synthetic_things_tree(root, ("sub-01",), n_classes=4,
                                        n_test_classes=3, train_reps=1,
                                        test_reps=3, seed=152)
    argv = ["train-retrieval", "--data-path", root, "--features", feats,
            *CLI_ARGS]
    torch.save({"dir": d, "argv": argv}, os.path.join(d, "cli.pt"))
    out = launch_ranks(W, d, ["prior", "lowlevel", "sweep", "cli"])
    out["inputs"] = {"prior": prior, "lowlevel": low, "sweep": sweep,
                     "cli": argv, "dir": d}
    return out


def _bit_equal_across_ranks(ranks):
    for k, v in ranks[0]["params"].items():
        for r in ranks[1:]:
            assert torch.equal(r["params"][k], v), k


def test_prior_dp_matches_one_process(world2):
    inp = world2["inputs"]["prior"]
    pipe = PriorPipe(inp["cfg"], device="cpu")
    want = [r["loss"] for r in pipe.train(inp["c"], inp["h"], epochs=2,
                                          log_fn=None)]
    for r in world2["prior"]:
        np.testing.assert_allclose(r["loss"], want, rtol=1e-5)
    _bit_equal_across_ranks(world2["prior"])


def test_lowlevel_dp_matches_one_process(world2):
    inp = world2["inputs"]["lowlevel"]
    tr = LowLevelTrainer(inp["cfg"], device="cpu",
                         model=EncoderLowLevel(**inp["model"]))
    want = [r["loss"] for r in tr.train(inp["eeg"], inp["lat"], epochs=2,
                                        log_fn=None)]
    # the low-level trainer's trajectory tolerance (tests/
    # test_torch_lowlevel.py): 1e-5 for the first epoch, 1e-4 after, since
    # Adam turns the sign of rounding-level gradients (the conv biases ahead
    # of a train-mode BatchNorm) into ±lr steps
    for r in world2["lowlevel"]:
        np.testing.assert_allclose(r["loss"][0], want[0], rtol=1e-5)
        np.testing.assert_allclose(r["loss"][1], want[1], rtol=1e-4)
    _bit_equal_across_ranks(world2["lowlevel"])


def test_sweep_lanes_equal_their_sequential_runs(world2):
    """Lane i on rank i mod 2; every rank ends with every lane's rows."""
    inp = world2["inputs"]["sweep"]
    ranks = world2["sweep"]
    assert [r["lanes"] for r in ranks] == [[0, 2], [1]]
    for lane in (0, 1):
        seed = inp["seeds"][lane]
        model = build_encoder("atms", config=ATMSConfig(**inp["cfg"]),
                              device="cpu", seed=seed)
        tr = ContrastiveTrainer(
            model, dataclasses.replace(inp["tcfg"], seed=seed),
            inp["trains"][lane], inp["tests"][lane], device="cpu")
        want = tr.fit(2, log_fn=None)
        for r in ranks:
            got = r["history"][lane]
            assert [row["epoch"] for row in got] == [0, 1]
            for g, w in zip(got, want):
                for k in ("loss", "train_acc", "top1_k2", "top1_k4"):
                    assert g[k] == w[k], (lane, k)
        params = ranks[lane % W]["params"][lane]
        for k, v in model.state_dict().items():
            assert torch.equal(params[k], v), (lane, k)


def test_sweep_lane_with_a_non_finite_loss_stops_alone(world2):
    for r in world2["sweep"]:
        failed = r["history"][2]
        assert len(failed) == 1 and failed[0]["failed"] == 1
        assert not np.isfinite(failed[0]["loss"])
        assert all(len(r["history"][i]) == 2 for i in (0, 1))
    assert 2 not in world2["sweep"][0]["params"]


def test_sweep_refuses_an_empty_subject_list_and_keeps_seeds_whole():
    """Two faults of the JAX sweep (ADVICE.md) not carried over: an empty
    subject list raises a readable error, and a lane's seed is its own
    Python int (no uint32 wrap), the sequential trainer's."""
    with pytest.raises(ValueError, match="at least one subject"):
        SubjectParallelSweep(lambda s: None, ContrastiveTrainConfig(), [], [],
                             mesh=SimpleNamespace(dp=1, dp_rank=0))
    inp = _sweep_inputs()
    seed = 2**32 + 5
    sweep = SubjectParallelSweep(
        lambda s: build_encoder("atms", config=ATMSConfig(**SMALL),
                                device="cpu", seed=s % 2**31),
        inp["tcfg"], inp["trains"][:1], inp["tests"][:1],
        mesh=SimpleNamespace(dp=1, dp_rank=0, device=torch.device("cpu")),
        seeds=[seed])
    assert sweep.subject_trainer(0).cfg.seed == seed


def _results(run_root: str) -> list[dict]:
    paths = glob.glob(os.path.join(run_root, "contrast", "atms", "*", "*",
                                   "results.csv"))
    assert len(paths) == 1, paths
    with open(paths[0], newline="") as f:
        return list(csv.DictReader(f))


def test_cli_mesh_two_ranks_writes_the_one_process_results(world2,
                                                            capsys):
    d = world2["inputs"]["dir"]
    one = os.path.join(d, "one_process")
    cli.main([*world2["inputs"]["cli"], "--output-dir", one])
    want = _results(one)
    got = _results(world2["cli"][0]["out"])
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want]
    np.testing.assert_allclose([float(r["loss"]) for r in got],
                               [float(r["loss"]) for r in want], rtol=1e-5)
    # rank 1 made its run's directories (every rank can resume from
    # them) and wrote no file
    written = [f for _, _, files in os.walk(world2["cli"][1]["out"])
               for f in files]
    assert written == []


def test_cli_mesh_without_a_launcher_starts_one_rank_per_card(world2,
                                                             monkeypatch):
    """What ``--mesh`` does without torchrun on a host with two cards: run
    the command as two local ranks (torchrun's variables set for each) and
    wait for them; here as two gloo ranks of ``--device cpu``. The run
    writes the one-process run's results."""
    d = world2["inputs"]["dir"]
    out = os.path.join(d, "spawned")
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # two threads a rank
    cli._spawn_workers(2, [*world2["inputs"]["cli"], "--output-dir", out,
                           "--mesh"])
    got = _results(out)
    want = _results(world2["cli"][0]["out"])
    np.testing.assert_allclose([float(r["loss"]) for r in got],
                               [float(r["loss"]) for r in want], rtol=1e-5)
    with pytest.raises(SystemExit, match="exited"):
        cli._spawn_workers(2, ["train-retrieval", "--data-path",
                               os.path.join(d, "missing"), "--device", "cpu",
                               "--mesh"])
