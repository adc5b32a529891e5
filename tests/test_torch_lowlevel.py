"""The port's low-level (EEG → VAE-latent) encoder against the JAX package,
on the CPU, fp32, at stages (32, 16, 8, 8, 8, 8) with ``time_proj_dim`` 8
(the output is still (4, 64, 64)).

- ``models/lowlevel.py``: the forward in eval and train mode and the
  BatchNorm running statistics after a train-mode pass (≤ 1e-5); the
  reference-layout converters against the JAX ones, bit for bit.
- ``train/lowlevel.py``: three epochs from one converted init against the
  JAX ``LowLevelTrainer.train`` (per-step losses ≤ 1e-5 relative: the
  per-epoch cosine staircase), NCHW and NHWC latents, a bit-equal
  kill-and-resume (the case the JAX trainer's ``init()`` fallback fails),
  the latents-count check, and ``cli train-lowlevel --device cpu`` on a
  written THINGS-EEG tree, also under ``--mesh`` (one CPU rank in a child
  process).
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_image_decode_tpu.core.config import (
    LowLevelConfig as JaxLowLevelConfig,
)
from eeg_image_decode_tpu.models import lowlevel as jll
from eeg_image_decode_tpu.train.lowlevel import (
    LowLevelTrainer as JaxLowLevelTrainer,
)
from eeg_image_decode_tpu_torch import cli
from eeg_image_decode_tpu_torch.core.checkpoint import Checkpointer
from eeg_image_decode_tpu_torch.core.config import LowLevelConfig
from eeg_image_decode_tpu_torch.data.synthetic import (
    write_synthetic_things_tree,
)
from eeg_image_decode_tpu_torch.models import lowlevel as pll
from eeg_image_decode_tpu_torch.train.lowlevel import LowLevelTrainer
from eeg_image_decode_tpu_torch.utils.convert import (
    flax_from_params,
    params_from_flax,
)
from torch_port_case import randomize, run_cli_child

STAGES, TP = cli.TINY_STAGES, cli.TINY_TIME_PROJ  # (32, 16, 8, 8, 8, 8), 8



@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's
    cores, and each PyTorch process would otherwise take them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

def _np(t):
    return t.detach().cpu().numpy()


def _variables(seed):
    m = jll.EncoderLowLevel(stage_channels=STAGES, time_proj_dim=TP)
    v = jax.jit(lambda k: m.init(k, jnp.zeros((2, 63, 250)),
                                 deterministic=True))(jax.random.key(0))
    return m, randomize(v, seed)


def _port_model(variables):
    m = pll.EncoderLowLevel(stage_channels=STAGES, time_proj_dim=TP)
    m.load_state_dict(params_from_flax(variables), strict=True)
    return m


def test_lowlevel_forward_and_batch_stats_match_jax():
    rng = np.random.default_rng(31)
    jm, v = _variables(32)
    pm = _port_model(v)
    x = rng.normal(size=(3, 63, 250)).astype(np.float32)
    apply = jax.jit(jm.apply, static_argnames=("deterministic", "mutable"))
    want = np.asarray(apply(v, jnp.asarray(x), deterministic=True))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.shape == (3, 4, 64, 64)
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), want,
                               rtol=1e-5, atol=1e-5)
    want, upd = apply(v, jnp.asarray(x), deterministic=False,
                      mutable=("batch_stats",))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    stats = flax_from_params(pm.state_dict())["batch_stats"]
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                                atol=1e-6),
        stats, upd["batch_stats"])


def test_lowlevel_converters_match_jax_bit_for_bit():
    _, v = _variables(33)
    ref_sd = jll.export_encoder_low_level(v)
    got = pll.convert_encoder_low_level(ref_sd)
    want = params_from_flax(jll.convert_encoder_low_level(ref_sd))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    pll.EncoderLowLevel(stage_channels=STAGES,
                        time_proj_dim=TP).load_state_dict(got, strict=True)
    back = pll.export_encoder_low_level(got)
    assert back.keys() == ref_sd.keys()
    for k in ref_sd:
        np.testing.assert_array_equal(back[k], ref_sd[k], err_msg=k)
        assert back[k].dtype == ref_sd[k].dtype, k
    # the flax tree back from the port, layouts and flips undone
    tree = flax_from_params(got)
    for part in ("params", "batch_stats"):
        jax.tree_util.tree_map(np.testing.assert_array_equal, tree[part],
                               v[part])


def _data(n, seed):
    rng = np.random.default_rng(seed)
    eeg = rng.normal(size=(n, 63, 250)).astype(np.float32)
    lat = (0.1 * rng.normal(size=(n, 4, 64, 64))).astype(np.float32)
    return eeg, lat


def _cfg(**kw):
    return LowLevelConfig(batch_size=8, epochs=3, lr=2e-3,
                          time_proj_dim=TP, **kw)


def _port_trainer(cfg):
    return LowLevelTrainer(cfg, device="cpu", model=pll.EncoderLowLevel(
        stage_channels=STAGES, time_proj_dim=TP))


def test_lowlevel_trajectory_matches_jax():
    """Three epochs from one converted init.

    The first epoch holds 1e-5 relative. Later epochs hold 1e-4: the
    gradients agree to ~1e-7, but a few elements of ``up_0``'s kernel (and
    every conv bias ahead of a train-mode BatchNorm, whose gradient is zero
    up to rounding) sum to values at the rounding level, whose sign differs
    between XLA's and PyTorch's summation orders, and Adam's update maps a
    sign to ±lr whatever the magnitude; the L1 loss's sign gradient carries
    that on (measured: 9e-7, 1.6e-5, 3.4e-5 over the three epochs; the JAX
    package's own L1 trajectory check against the reference allows 1e-4
    and 1e-3, ``tests/test_lowlevel_trajectory_parity.py``). The staircase
    itself is held exactly: a smooth per-step cosine would move the second
    epoch's rate by a quarter, far outside the band."""
    eeg, lat = _data(16, 34)
    cfg = _cfg()
    _, v = _variables(35)
    jt = JaxLowLevelTrainer(
        JaxLowLevelConfig(**dataclasses.asdict(cfg)),
        model=jll.EncoderLowLevel(stage_channels=STAGES, time_proj_dim=TP))
    jt.init(total_steps=2 * 3, seed=7, steps_per_epoch=2)
    jt.state = jt.state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, v["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]))
    pt = _port_trainer(cfg)
    pt.init(total_steps=2 * 3, steps_per_epoch=2, seed=7)
    pt.model.load_state_dict(params_from_flax(v), strict=True)
    want = [r["loss"] for r in jt.train(eeg, lat, seed=7, log_fn=None)]
    got_rows = pt.train(eeg, lat, seed=7, log_fn=None)
    got = [r["loss"] for r in got_rows]
    assert [r["epoch"] for r in got_rows] == [0, 1, 2]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    # the schedule, step by step: the rate of each epoch, on both sides
    eta, lr = 1e-6, cfg.lr
    stair = [eta + (lr - eta) * 0.5 * (1 + np.cos(np.pi * (k // 2) / 3))
             for k in range(6)]
    opt = pt.state.optimizer
    np.testing.assert_allclose([opt.schedule(k) for k in range(6)], stair,
                               rtol=1e-12)
    assert opt.param_groups[0]["count"] == 6 == int(jt.state.step)
    # predict: NHWC, eval mode, on the trained weights. The two runs'
    # running means are not compared: the conv biases ahead of each
    # BatchNorm walk by ±lr per step on rounding-level gradients (above)
    trained = flax_from_params(pt.model.state_dict())
    np.testing.assert_allclose(
        _np(pt.predict(eeg[:2])),
        np.asarray(jax.jit(jt.model.apply)(trained, jnp.asarray(eeg[:2]))),
        rtol=1e-5, atol=1e-5)


def test_lowlevel_takes_nhwc_latents_as_nchw():
    eeg, lat = _data(8, 36)
    runs = []
    for latents in (lat, np.moveaxis(lat, 1, -1)):
        t = _port_trainer(_cfg())
        runs.append([r["loss"] for r in t.train(eeg, latents, epochs=1,
                                                seed=3, log_fn=None)])
    assert runs[0] == runs[1]


def test_lowlevel_kill_and_resume_is_bit_equal(tmp_path):
    eeg, lat = _data(16, 37)
    cfg = dataclasses.replace(_cfg(), epochs=4)
    full = _port_trainer(cfg)
    h_full = full.train(eeg, lat, seed=7, log_fn=None)
    part = _port_trainer(cfg)
    part.init(total_steps=2 * 4, steps_per_epoch=2, seed=7)  # a 4-epoch job
    part.train(eeg, lat, seed=7, epochs=2, log_fn=None,
               checkpointer=Checkpointer(str(tmp_path / "ckpt")),
               ckpt_every_epochs=1)
    resumed = _port_trainer(cfg)
    h_res = resumed.train(eeg, lat, seed=7, log_fn=None, resume=True,
                          checkpointer=Checkpointer(str(tmp_path / "ckpt")))
    assert [r["epoch"] for r in h_res] == [0, 1, 2, 3]
    assert [r["loss"] for r in h_res] == [r["loss"] for r in h_full]
    for k, want in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], want), k


def test_lowlevel_refuses_a_latent_count_that_is_not_per_trial():
    eeg, lat = _data(8, 38)
    t = _port_trainer(_cfg())
    with pytest.raises(ValueError, match="8 EEG trials against 2 latents"):
        t.train(eeg, lat[:2], log_fn=None)
    assert t.state is None  # refused before training


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads([ln for ln in buf.getvalue().splitlines()
                       if ln.strip()][-1])


def test_cli_train_lowlevel_resumes_and_refuses(tmp_path):
    root = str(tmp_path / "things")
    write_synthetic_things_tree(root, ("sub-01",), n_classes=2,
                                n_test_classes=1, train_reps=1, test_reps=1,
                                seed=39)
    n = 2 * 10  # trials: 2 classes × 10 images × 1 repetition
    lat = (0.1 * np.random.default_rng(40).normal(size=(n, 4, 64, 64))
           ).astype(np.float32)
    latents = str(tmp_path / "latents.npz")
    np.savez(latents, latents=lat)
    out = str(tmp_path / "ll")
    common = ["train-lowlevel", "--data-path", root, "--subjects", "sub-01",
              "--latents", latents, "--device", "cpu", "--batch-size", "10",
              "--tiny"]
    row = _run([*common, "--epochs", "2", "--output-dir", out])
    assert row["epoch"] == 1 and np.isfinite(row["loss"])
    row3 = _run([*common, "--epochs", "3", "--resume-dir", out])
    assert row3["epoch"] == 2 and np.isfinite(row3["loss"])
    assert Checkpointer(os.path.join(out, "ckpt")).all_steps() == [2, 3]
    per_image = str(tmp_path / "per_image.npz")
    np.savez(per_image, latents=lat[:2])
    with pytest.raises(ValueError, match="20 EEG trials against 2 latents"):
        cli.main([*common, "--latents", per_image, "--output-dir", out])
    # --mesh (ported): one CPU rank in a child process, the same two epochs
    # (the second epoch within the trajectory's 1e-4)
    mesh = json.loads(run_cli_child(
        [*common, "--epochs", "2", "--mesh", "--output-dir",
         str(tmp_path / "ll_mesh")])[-1])
    assert mesh["epoch"] == 1
    np.testing.assert_allclose(mesh["loss"], row["loss"], rtol=1e-4)
    for flag, match in ((["--preview-dir", str(tmp_path / "p")],
                         "needs --vae-params"),
                        (["--vae-params", "vae.pkl"],
                         "read only with --preview-dir")):
        with pytest.raises(SystemExit, match=match):
            cli.main([*common, *flag, "--output-dir", out])
