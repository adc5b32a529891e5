"""The port's diffusion prior against the JAX package's over a run that
leaves the warmup for the cosine (``scripts/parity_torch_prior_trajectory.py``
at narrow widths, on the CPU, fp32).

- Injected draws: 12 epochs × 8 steps at B 32 from one converted init, the
  warmup 5 of the 96 steps (the published 500 of 9,600). The per-epoch
  ε-MSE within 1e-4 relative, the trained pipes' CFG samples (each its own
  weights, and both on JAX's) within 1e-3 of their scale at guidance 5.0
  and 0, the clip active on some step, the rate past its peak.
- The port's own draws, 4 seeds × 12 epochs × 8 batches through its
  ``train()``: its dropped-condition share within 3 binomial SE of 0.1 and
  its t over ``[0, 1000)`` by a χ² at p > 1e-3. The loss band against the
  JAX seeds and its controls need the script's 10 seeds a side (``python3
  scripts/parity_torch_prior_trajectory.py --stochastic 10``): two seeds a
  side make no sound interval.
"""

import os
import sys

import numpy as np
import pytest

from torch_port_case import two_threads  # noqa: F401 (autouse)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import parity_torch_prior_trajectory as ppt  # noqa: E402


@pytest.fixture(scope="module")
def res():
    return ppt.prior_trajectory_parity_torch(
        n=256, batch=32, epochs=12, log=lambda *a: None)


def test_injected_trajectory_holds_the_bands_past_the_warmup(res):
    from eeg_image_decode_tpu_torch.train.prior import warmup_cosine

    assert res["warmup_steps"] == 5 and res["total_steps"] == 96
    # update k runs at λ(k + 1): the peak at update 4, then 91 updates on
    # the cosine down to 0
    cfg = ppt.prior_config(ppt.NARROW, 96)
    rates = [warmup_cosine(k + 1, cfg.lr, cfg.warmup_steps, 96)
             for k in range(96)]
    assert int(np.argmax(rates)) == 4 and rates[4] == cfg.lr
    assert all(a > b for a, b in zip(rates[4:], rates[5:]))
    assert ppt.loss_failures(res["rel_loss_dev"]) == []
    assert max(res["rel_loss_dev"]) < 1e-4
    assert res["port_losses"][-1] < 0.75 * res["port_losses"][0]
    assert 0 < res["clip_steps"] < res["total_steps"]
    for name in ("samples_trained", "samples_shared_weights"):
        assert set(res[name]) == {"g5.0", "g0.0"}
        assert ppt.sample_failures(res[name]) == [], res[name]
    assert np.isfinite(res["max_param_diff"])


def test_seeded_draws_follow_their_laws():
    from eeg_image_decode_tpu_torch.utils.convert import params_from_flax

    n, batch, epochs, seeds = 256, 32, 12, 4
    cfg = ppt.prior_config(ppt.NARROW, (n // batch) * epochs)
    c, h = ppt.make_data(n, cfg.embed_dim, cfg.cond_dim, 0)
    state_dict = params_from_flax({"params": ppt.jax_init(ppt.NARROW, 0)})
    keep, ts = [], []
    for s in range(seeds):
        loss, k, t = ppt.port_train(state_dict, ppt.dataclasses.replace(
            cfg, seed=s), c, h, epochs, batch)
        assert np.isfinite(loss)
        keep.append(k)
        ts.append(t)
    rates = ppt.draw_rates(keep, ts, cfg)
    assert rates["batches"] == seeds * epochs * (n // batch)
    assert rates["drop_ok"], (rates["drop_share"], rates["drop_se"])
    assert rates["t_ok"] and rates["t_range"] == [0, 999], rates["t_counts"]
