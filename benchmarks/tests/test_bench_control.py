"""The control, the reference computed in fp8 in the program's place,
comes out not correct: on the CPU at a size a test run holds, and on the
card at the cell's own size (``cuda``)."""

import time

import pytest
import torch

from benchmarks.drivers import reconstruct as rc
from benchmarks.drivers import train_contrastive as tc
from benchmarks.harness import eegdata, runner, spec
from benchmarks.tests import small


def _training_control(cell, seed, device):
    split = eegdata.make_split(cell.config["data"], seed, device)
    with tc.no_tf32():
        ref = tc.reference_steps(cell, split, seed, device)
        ctl = tc.reference_steps(cell, split, seed, device, control=True)
    lim = cell.config["limits"]
    return [(n, v, lim[n]) for n, v in tc.compare(ctl, ref)]


def _recon_control(cfg, seed, reqs, device):
    with tc.no_tf32():
        want = rc.reference_images(rc.reference_chain(cfg, seed, device),
                                   reqs, device)
        got = rc.reference_images(
            rc.reference_chain(cfg, seed, device, control=True), reqs,
            device, control=True)
    gap = max(rc.image_gap(g, w) for g, w in zip(got, want))
    return [("image", gap, cfg["limits"]["image"])]


def _requests(cell, seed, n, device):
    m = cell.config["encoder"]
    pool = eegdata.eeg_pool(64, m["n_channels"], m["seq_len"], seed,
                            device).cpu().numpy()
    return rc.requests(cell.mix, seed, n, pool)


def test_training_control_is_not_correct_on_the_cpu():
    cell = small.training_cell(classes=64, batch=128)
    assert not runner.checks_pass(_training_control(cell, 2**31 + 41,
                                                    "cpu"))


def test_reconstruction_control_is_not_correct_on_the_cpu():
    cell = small.recon_cell()
    checks = _recon_control(cell.config, 2**31 + 42,
                            _requests(cell, 2**31 + 42, 4, "cpu"), "cpu")
    assert not runner.checks_pass(checks)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["atms_train_resident",
                                      "recon_poisson_rows1"])
def test_control_is_not_correct_at_the_cells_size(cuda, workload):
    cell = spec.load_cell(workload)
    for seed in (3000000501, 3000000502, 3000000503):
        if cell.config["driver"] == "train_contrastive":
            checks = _training_control(cell, seed, cuda)
        else:
            checks = _recon_control(cell.config, seed,
                                    _requests(cell, seed, 16, cuda), cuda)
        assert not runner.checks_pass(checks), (seed, checks)
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["atms_train_resident",
                                      "recon_poisson_rows1"])
def test_sound_run_is_correct_at_the_cells_size(cuda, workload):
    cell = spec.load_cell(workload)
    line, _ = runner.run(cell, seed=3000000504, seconds=3, trace=False,
                         device=cuda, t_start=time.perf_counter())
    assert line["correct"] is True, line["checks"]
