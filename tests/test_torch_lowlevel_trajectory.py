"""The port's low-level trainer against the JAX package's
(``scripts/parity_torch_lowlevel_trajectory.py`` at stages (32, 16, 8, 8,
8, 8) and ``time_proj_dim`` 8, on the CPU, fp32).

- The trajectory: 8 epochs × 4 steps from one converted init, each side's
  own ``train()`` on the per-epoch staircase, at seed 0 (the script's
  default seed and the JAX package's own test's). The first epoch's
  relative L1 deviation < 1e-4, every epoch's < 1e-3, the trained
  predictors' cross PSNR > 30 dB on held-out trials and their L1s to the
  targets within 5e-3 of each other. These are JAX's bands against the
  reference, and at this size they hold at seed 0, not at every seed: at
  seed 2 an epoch deviates 1.3e-3. Each fp32 trainer drifts as far from
  the port's float64 trajectory, which the script reports beside them,
  because Adam turns rounding-level gradient signs into steps of the
  rate's size.
- The first batch at seeds 0-4, against the port's model in float64:
  each side's BatchNorm outputs within 1e-5, and each side's fp32
  gradient against the float64 gradient taken along that side's own
  branches (the ReLU sides and L1 residual signs it chose), the port's
  within 5e-5 and JAX's within 5e-4. This holds the port's function to
  JAX's at every seed, with the rounding-level branch choices set
  apart.
- JAX's bands at JAX's own size (``tests/test_lowlevel_trajectory_
  parity.py``: the published widths, 143 M parameters, ``n=32, batch=16,
  epochs=2``, two steps an epoch) at seeds 1-4: the trajectories alone,
  without the float64 run (≈ 1 min a seed on two threads). At that size
  every seed 0-4 holds them (the script, four threads: largest epoch
  deviation 1.41e-4, first epoch 1.35e-5)."""

import os
import sys

import numpy as np
import pytest

from torch_port_case import two_threads  # noqa: F401 (autouse)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import parity_torch_lowlevel_trajectory as plt  # noqa: E402
import parity_torch_prior_trajectory as ppt  # noqa: E402

STAGES, TIME_PROJ, N, BATCH = (32, 16, 8, 8, 8, 8), 8, 64, 16


def test_lowlevel_trajectory_holds_the_bands():
    res = plt.lowlevel_trajectory_parity_torch(
        n=N, batch=BATCH, epochs=8, stages=STAGES, time_proj=TIME_PROJ,
        log=lambda *a: None)
    assert len(res["jax_losses"]) == len(res["port_losses"]) == 8
    assert len(res["float64_losses"]) == 8
    assert plt.failures(res["rel_loss_dev"], res["agreement"],
                        res["first_gradients"]) == [], res
    assert res["port_losses"][-1] < 0.8 * res["port_losses"][0]
    assert np.isfinite(res["max_param_diff"])
    assert np.isfinite(res["max_stat_rel_diff"])


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_first_gradients_follow_float64_along_their_branches(seed):
    """Seed 0's check runs in the trajectory test above."""
    eeg, lat = plt.make_data(N, seed)
    jt = plt.jax_trainer(STAGES, TIME_PROJ, 1e-3, N // BATCH, 8, seed)
    from eeg_image_decode_tpu_torch.utils.convert import params_from_flax

    init = params_from_flax(plt.jax_variables(jt))
    grads = plt.first_gradients(jt, init, eeg, lat, BATCH, seed, STAGES,
                                TIME_PROJ)
    for side, band in plt.GRAD_BANDS.items():
        g = grads[side]
        assert g["branched"] < band, grads
        assert max(g["bn_error"]) < plt.FORWARD_BAND, grads
        # a side that takes float64's branches has nothing to set apart
        if g["relu_flips"] == g["sign_flips"] == 0:
            assert g["free"] == g["branched"], grads


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_jax_bands_hold_at_jax_size(seed):
    """Seed 0 at this size is JAX's own test's (against the reference)."""
    import jax.numpy as jnp

    from eeg_image_decode_tpu_torch.utils.convert import params_from_flax

    n, batch, epochs = 32, 16, 2
    eeg, lat = plt.make_data(n, seed)
    jt = plt.jax_trainer(plt.FULL_STAGES, plt.FULL_TIME_PROJ, 1e-3,
                         n // batch, epochs, seed)
    init = params_from_flax(plt.jax_variables(jt))
    want = [r["loss"] for r in jt.train(eeg, lat, epochs=epochs,
                                        batch_size=batch, seed=seed,
                                        log_fn=None)]
    got, _, pt = plt.run_port(init, eeg, lat, epochs=epochs, batch=batch,
                              lr=1e-3, seed=seed, stages=plt.FULL_STAGES,
                              time_proj=plt.FULL_TIME_PROJ)
    held, held_lat = plt.make_data(32, seed + 99)
    agree = plt.prediction_agreement(
        plt.predict_port(pt, held), np.asarray(jt.predict(jnp.asarray(held))),
        np.moveaxis(held_lat, 1, -1))
    rel = ppt.deviations(got, want)
    assert len(rel) == epochs
    assert plt.failures(rel, agree) == [], (rel, agree)
