"""The port's ATM-S trainer over many updates against the JAX trainer
(shortened configuration of ``scripts/parity_torch_trajectory.py``).

From one JAX initialisation carried into the port, on one learnable
synthetic split with one batch order, at full ``ATMSConfig()`` width in fp32
on the CPU, dropout off: the per-epoch losses track, the set trains, the
final k-way tables agree under one shared draw of distractors (through the
port's evaluator with one numpy draw, and through JAX's under one key) and
the per-sample decisions agree — the limits of
``tests/test_trajectory_parity.py``. This holds Adam's state, BatchNorm's
running statistics, the trained logit scale and eval mode after 40 updates,
where ``tests/test_torch_train.py`` holds 3 steps.

Then the seeded-dropout path at a narrow width, 2 seeds a side: the band
machinery runs (the top-1 band, the loss band and its dropout-off control), and the port's keep rate at every dropout site is 0.75 or
0.5 within 3 binomial standard errors, each kept element scaled by 1/keep.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (tests/conftest.py pins the CPU platform)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

from parity_torch_trajectory import trajectory_parity_torch  # noqa: E402
from torch_port_case import SMALL  # noqa: E402


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_multi_epoch_trajectory_and_kway_table_match_jax():
    res = trajectory_parity_torch(
        n_classes=40, ipc=1, reps=2, epochs=8, batch=16, seed=3,
        log=lambda *a: None)
    # loss curves track within accumulated-fp-drift tolerance
    assert max(res["rel_loss_dev"]) < 0.02, res["rel_loss_dev"]
    # the learnable set actually trains (not parity-of-garbage)
    assert res["jax_losses"][-1] < 0.5 * res["jax_losses"][0]
    # one near-tie flip per row at most, under either evaluator
    tol = 1.5 / res["n_test"]
    for which in ("", "_jaxeval"):
        want, got = res["jax_table" + which], res["torch_table" + which]
        assert set(want) == set(got) == {"top1_k2", "top1_k4", "top1_k10"}
        for k in want:
            assert abs(want[k] - got[k]) <= tol, (which, k, want, got)
    assert res["decision_agreement"] >= 1.0 - 2.0 / res["n_test"], (
        res["decision_agreement"])
    # the trained scale and BatchNorm's four running buffers are reported
    assert np.isfinite(res["torch_logit_scale"])
    assert len(res["bn_rel_l2"]) == 4
    assert all(np.isfinite(v) for v in res["bn_rel_l2"].values())


def test_seeded_dropout_band_runs_and_keep_rates_hold():
    res = trajectory_parity_torch(
        n_classes=24, ipc=1, reps=2, epochs=3, batch=16, seed=5,
        model_kw=SMALL, deterministic=False, stochastic=2, log=lambda *a: None)
    st = res["stochastic"]
    assert st["key"] == "top1_k10" and st["epochs"] == 3
    assert len(st["jax_acc"]) == len(st["port_acc"]) == 2
    lo, hi = st["band"]
    assert np.isfinite(lo) and np.isfinite(hi) and lo < hi
    assert 0.0 <= st["port_mean"] <= 1.0 and st["se"] > 0.0
    # the loss band and the dropout-off control are computed and reported
    lo, hi = st["loss_band"]
    assert np.isfinite(lo) and np.isfinite(hi) and lo <= hi
    assert np.isfinite(st["control"]["loss"])
    assert set(st["control"]["table"]) == set(st["mean_tables"]["port"])
    assert set(res["keep_rates"]) == {"m_attn", "m_res", "m_ffn1", "m_ffn2",
                                      "emb", "tsconv", "proj"}
    for site, (frac, keep, se, value, inv) in res["keep_rates"].items():
        assert keep == (0.75 if site not in ("tsconv", "proj") else 0.5)
        assert abs(frac - keep) <= 3 * se, (site, frac, keep, se)
        assert value == pytest.approx(inv, rel=1e-6), (site, value)
