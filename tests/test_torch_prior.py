"""The port's diffusion prior against the JAX package, on the CPU, fp32.

- ``ops/ddpm.py``: the schedule tables, ``add_noise``, the spaced
  timesteps and the ancestral step with clipping on and off (≤ 1e-6);
  ``row_noise`` by its properties (the port draws Philox bits, JAX threefry).
- ``models/diffusion_prior.py``: the timestep features, the U-Net at the
  ``tiny()`` widths (the condition, the ``cond_mask`` 0 path, pinned
  dropout masks) and once at the published widths, the flat MLP variant
  (≤ 1e-5); both reference-layout converters bit for bit.
- ``train/prior.py``: two epochs of injected training from one converted
  init (per-step losses and final weights ≤ 1e-5 relative, the global-norm
  clip active on some step), injected CFG sampling (≤ 1e-4), the
  ``prior-v1`` pickle read by both packages, a bit-equal kill-and-resume,
  the architecture guard, and ``cli train-prior --device cpu`` on the file
  ``train-retrieval --export-features`` writes, also under ``--mesh`` (one
  CPU rank in a child process).

JAX weights are the JAX init with every leaf redrawn from a numpy seed,
carried into the port by ``utils/convert.py::params_from_flax``.
"""

import contextlib
import dataclasses
import io
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_image_decode_tpu.core.config import PriorConfig as JaxPriorConfig
from eeg_image_decode_tpu.models import diffusion_prior as jdp
from eeg_image_decode_tpu.ops import ddpm as jddpm
from eeg_image_decode_tpu.train import prior as jprior
from eeg_image_decode_tpu_torch import cli
from eeg_image_decode_tpu_torch.core.checkpoint import Checkpointer
from eeg_image_decode_tpu_torch.core.config import PriorConfig
from eeg_image_decode_tpu_torch.data.synthetic import (
    write_synthetic_things_tree,
)
from eeg_image_decode_tpu_torch.models import diffusion_prior as pdp
from eeg_image_decode_tpu_torch.ops import ddpm
from eeg_image_decode_tpu_torch.train.prior import (
    PriorPipe,
    expand_image_embeddings,
)
from eeg_image_decode_tpu_torch.utils.convert import (
    flax_from_params,
    params_from_flax,
)
from torch_port_case import randomize, run_cli_child

TINY = PriorConfig.tiny()
ARCH = dict(embed_dim=64, cond_dim=64, hidden_dims=(64, 32),
            time_embed_dim=32)
FULL = dict(embed_dim=1024, cond_dim=1024, hidden_dims=(1024, 512, 256, 128,
                                                         64),
            time_embed_dim=512)



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


def _jax_unet(arch, seed=0):
    """A JAX U-Net and its variables, every leaf redrawn from ``seed``."""
    m = jdp.DiffusionPriorUNet(**arch)
    x = jnp.zeros((2, arch["embed_dim"]))
    v = jax.jit(m.init)(jax.random.key(0), x, jnp.zeros((2,), jnp.int32),
                        jnp.zeros((2, arch["cond_dim"])), jnp.ones((2,)))
    return m, randomize(v, seed)


def _port_unet(arch, variables):
    m = pdp.DiffusionPriorUNet(**arch)
    m.load_state_dict(params_from_flax(variables), strict=True)
    return m


# ——— ops/ddpm.py ———


@pytest.mark.parametrize("clip", [True, False])
def test_ddpm_schedule_and_step_match_jax(clip):
    rng = np.random.default_rng(3)
    js, ps = (jddpm.DDPMSchedule(clip_sample=clip),
              ddpm.DDPMSchedule(clip_sample=clip))
    for name in ("betas", "alphas", "alphas_cumprod"):
        np.testing.assert_array_equal(_np(getattr(ps, name)),
                                      np.asarray(getattr(js, name)))
    for n in (50, 4, 7):
        np.testing.assert_array_equal(ps.inference_timesteps(n),
                                      np.asarray(js.inference_timesteps(n)))
    x0 = (2.0 * rng.normal(size=(5, 16))).astype(np.float32)
    noise = rng.normal(size=(5, 16)).astype(np.float32)
    t = np.array([0, 1, 499, 998, 999])
    np.testing.assert_allclose(
        _np(ps.add_noise(torch.from_numpy(x0), torch.from_numpy(noise),
                         torch.from_numpy(t))),
        np.asarray(js.add_noise(jnp.asarray(x0), jnp.asarray(noise),
                                jnp.asarray(t))), rtol=1e-6, atol=1e-6)
    eps = (3.0 * rng.normal(size=(5, 16))).astype(np.float32)
    for steps in (50, 7):
        for ts in (980, 500, 20, 3, 0):
            want = js.step(jnp.asarray(eps), jnp.asarray(ts), jnp.asarray(x0),
                           jnp.asarray(noise), num_inference_steps=steps)
            got = ps.step(torch.from_numpy(eps), ts, torch.from_numpy(x0),
                          torch.from_numpy(noise), num_inference_steps=steps)
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                                       atol=1e-6, err_msg=f"t {ts}")


def test_row_noise_is_a_pure_function_of_row_key_and_step():
    keys = torch.tensor([7, 2**40 + 3, -5, 123456789012, 0, 99],
                        dtype=torch.int64)
    full = ddpm.row_noise(keys, 3, (5, 7))
    assert full.shape == (6, 5, 7) and full.dtype == torch.float32
    # another batch, another order: the same rows
    order = torch.tensor([4, 1, 3])
    torch.testing.assert_close(ddpm.row_noise(keys[order], 3, (5, 7)),
                               full[order], rtol=0, atol=0)
    assert not torch.equal(ddpm.row_noise(keys, 4, (5, 7)), full)
    assert not torch.equal(full[0], full[5])
    # 10⁴ draws: standard normal moments within 5σ
    z = ddpm.row_noise(torch.arange(10, dtype=torch.int64) * 977 + 11, 1,
                       (1000,)).double().flatten()
    n = z.numel()
    assert abs(z.mean().item()) < 5 / np.sqrt(n)
    assert abs(z.var().item() - 1.0) < 5 * np.sqrt(2.0 / n)
    assert torch.isfinite(z).all()


# ——— models/diffusion_prior.py ———


def test_timestep_embedding_matches_jax():
    """XLA's fp32 ``exp`` is not correctly rounded (25 of 256 frequencies
    differ from PyTorch's by one ulp), and cos/sin of t·f carry that ulp
    times t: the bound is 1e-6 + 3e-7·t, and the frequencies agree to two
    ulps."""
    t = np.array([0, 1, 17, 500, 999], np.int32)
    for dim in (32, 512):
        got = _np(pdp.timestep_embedding(torch.from_numpy(t), dim))
        want = np.asarray(jdp.timestep_embedding(jnp.asarray(t), dim))
        assert got.shape == want.shape == (5, dim)
        bound = 1e-6 + 3e-7 * t[:, None].astype(np.float64)
        assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()
        # t = 1: the features are the frequencies themselves
        np.testing.assert_allclose(got[1], want[1], rtol=2.5e-7, atol=0)


@pytest.mark.parametrize("case", ["cond", "cond_mask_zero", "dropout_masks",
                                  "published_widths"])
def test_prior_unet_matches_jax(case):
    arch = FULL if case == "published_widths" else ARCH
    rng = np.random.default_rng(11)
    jm, v = _jax_unet(arch, seed=12)
    pm = _port_unet(arch, v)
    b = 4
    x = rng.normal(size=(b, arch["embed_dim"])).astype(np.float32)
    c = rng.normal(size=(b, arch["cond_dim"])).astype(np.float32)
    t = np.array([0, 3, 500, 999], np.int32)
    mask = (np.zeros(b) if case == "cond_mask_zero"
            else np.array([1.0, 0.0, 1.0, 1.0])).astype(np.float32)
    masks = None
    if case == "dropout_masks":
        dims = arch["hidden_dims"]
        masks = {f"enc_{i}": (rng.random((b, dims[i + 1])) > 0.3) / 0.7
                 for i in range(len(dims) - 1)}
        masks.update({f"dec_{j}": (rng.random((b, dims[i - 1])) > 0.3) / 0.7
                      for j, i in enumerate(range(len(dims) - 1, 0, -1))})
        masks = {k: m.astype(np.float32) for k, m in masks.items()}
    want = np.asarray(jax.jit(jm.apply)(
        v, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c), jnp.asarray(mask),
        dropout_masks=None if masks is None else
        {k: jnp.asarray(m) for k, m in masks.items()}))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(t).long(),
                 torch.from_numpy(c), torch.from_numpy(mask),
                 dropout_masks=None if masks is None else
                 {k: torch.from_numpy(m) for k, m in masks.items()})
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
        if case == "cond_mask_zero":  # exactly the unconditional branch
            uncond = pm(torch.from_numpy(x), torch.from_numpy(t).long())
            assert torch.equal(got, uncond)


def test_prior_mlp_matches_jax():
    rng = np.random.default_rng(13)
    arch = dict(embed_dim=24, cond_dim=20, hidden_dim=32, layers_per_block=3,
                time_embed_dim=16)
    jm = jdp.DiffusionPriorMLP(**arch)
    x = rng.normal(size=(3, 24)).astype(np.float32)
    c = rng.normal(size=(3, 20)).astype(np.float32)
    t = np.array([5, 250, 990], np.int32)
    v = randomize(jm.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(t),
                          jnp.asarray(c)), 14)
    pm = pdp.DiffusionPriorMLP(**arch)
    pm.load_state_dict(params_from_flax(v), strict=True)
    with torch.no_grad():
        for cond_np in (c, None):
            want = np.asarray(jm.apply(
                v, jnp.asarray(x), jnp.asarray(t),
                None if cond_np is None else jnp.asarray(cond_np)))
            got = pm(torch.from_numpy(x), torch.from_numpy(t).long(),
                     None if cond_np is None else torch.from_numpy(cond_np))
            np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


def test_prior_converters_match_jax_bit_for_bit():
    _, v = _jax_unet(ARCH, seed=15)
    ref_sd = jdp.export_diffusion_prior(v["params"])
    # reference layout → the port: the JAX converter's tree, bit for bit
    got = pdp.convert_diffusion_prior(ref_sd)
    want = params_from_flax({"params": jdp.convert_diffusion_prior(ref_sd)})
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    pdp.DiffusionPriorUNet(**ARCH).load_state_dict(got, strict=True)
    # the port → reference layout: the JAX export, bit for bit
    back = pdp.export_diffusion_prior(got)
    assert back.keys() == ref_sd.keys()
    for k in ref_sd:
        np.testing.assert_array_equal(back[k], ref_sd[k], err_msg=k)
        assert back[k].dtype == ref_sd[k].dtype
    # and the flax tree the port pickles is the JAX tree
    tree = flax_from_params(got)["params"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, tree, v["params"])


# ——— train/prior.py ———


def _pipes(cfg, total_steps, seed=16):
    """A JAX pipe and a port pipe from one converted init."""
    jcfg = JaxPriorConfig(**dataclasses.asdict(cfg))
    jp = jprior.PriorPipe(jcfg)
    jp.init(total_steps=total_steps)
    params = randomize({"params": jax.device_get(jp.state.params)},
                       seed)["params"]
    jp.state = jp.state.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                              params))
    pp = PriorPipe(cfg, device="cpu")
    pp.init(total_steps=total_steps)
    pp.model.load_state_dict(params_from_flax({"params": params}),
                             strict=True)
    return jp, pp


def test_prior_trajectory_matches_jax():
    """Two epochs of injected training: the same batches, ε, t and
    per-batch cond-keep flags on both sides."""
    cfg = dataclasses.replace(TINY, lr=3e-3, warmup_steps=3)
    n, b, epochs = 40, 8, 2
    steps = n // b
    rng = np.random.default_rng(17)
    c_all = rng.normal(size=(n, 64)).astype(np.float32)
    h_all = (0.5 * rng.normal(size=(n, 64))).astype(np.float32)
    jp, pp = _pipes(cfg, steps * epochs)
    norms = []
    for epoch in range(epochs):
        perm = np.stack([rng.permutation(n)[:b] for _ in range(steps)])
        noise = rng.normal(size=(steps, b, 64)).astype(np.float32)
        t = rng.integers(0, 1000, size=(steps, b)).astype(np.int32)
        keep = np.ones(steps, np.float32)
        keep[1] = 0.0  # one batch drops its condition
        want = jp.train_epoch_injected(c_all, h_all, perm, noise, t, keep)
        got = pp.train_epoch_injected(c_all, h_all, perm, noise, t, keep)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0,
                                   err_msg=f"epoch {epoch}")
        norms.extend(_np(pp.last_steps["grad_norm"]).tolist())
    # the clip must have acted on some step for the test to hold it
    assert max(norms) > cfg.grad_clip_norm, norms
    want_p = params_from_flax({"params": jax.device_get(jp.state.params)})
    got_p = pp.model.state_dict()
    for k, w in want_p.items():
        rel = (torch.linalg.vector_norm(got_p[k] - w)
               / torch.linalg.vector_norm(w)).item()
        assert rel <= 1e-5, (k, rel)
    assert pp.state.step == int(jp.state.step) == steps * epochs


def test_generate_matches_jax_sampler():
    cfg = TINY
    jp, pp = _pipes(cfg, 1, seed=18)
    rng = np.random.default_rng(19)
    n, steps = 3, cfg.num_inference_steps
    cond = rng.normal(size=(n, 64)).astype(np.float32)
    init = rng.normal(size=(n, 64)).astype(np.float32)
    step_noises = rng.normal(size=(steps, n, 64)).astype(np.float32)
    params = jp.state.params

    def denoise(x, t, c, m):
        return jp.model.apply({"params": params}, x, t, c, m)

    for scale in (cfg.guidance_scale, 0.0):
        sample = jddpm.make_cfg_sampler(
            denoise, jp.schedule, num_inference_steps=steps,
            guidance_scale=scale)
        want = np.asarray(sample(jax.random.key(0), jnp.asarray(cond),
                                 (n, 64), init_noise=jnp.asarray(init),
                                 step_noises=jnp.asarray(step_noises)))
        got = pp.generate(cond, guidance_scale=scale,
                          init_noise=torch.from_numpy(init),
                          step_noises=torch.from_numpy(step_noises))
        np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"guidance {scale}")
    # per-row keys: a row's sample does not depend on its batch
    keys = torch.tensor([5, 6, 7], dtype=torch.int64)
    rows = pp.generate(cond, row_keys=keys)
    alone = pp.generate(cond[1:2], row_keys=keys[1:2])
    torch.testing.assert_close(alone, rows[1:2], rtol=1e-5, atol=1e-5)
    assert torch.isfinite(rows).all()


def test_prior_pickle_is_read_by_both_packages(tmp_path):
    cfg = TINY
    jp, pp = _pipes(cfg, 1, seed=20)
    rng = np.random.default_rng(21)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    c = rng.normal(size=(4, 64)).astype(np.float32)
    t = np.array([1, 100, 600, 999], np.int32)
    m = np.array([1.0, 0.0, 1.0, 1.0], np.float32)

    def eps_jax(pipe):
        return np.asarray(pipe.model.apply(
            {"params": pipe.state.params}, jnp.asarray(x), jnp.asarray(t),
            jnp.asarray(c), jnp.asarray(m)))

    def eps_port(pipe):
        with torch.no_grad():
            return _np(pipe.model(torch.from_numpy(x),
                                  torch.from_numpy(t).long(),
                                  torch.from_numpy(c), torch.from_numpy(m)))

    port_path = pp.save_with_config(str(tmp_path / "port" / "prior.pkl"))
    with open(port_path, "rb") as f:
        assert pickle.load(f)["format"] == "eeg_image_decode_tpu/prior-v1"
    from_port = jprior.PriorPipe.from_checkpoint(port_path)
    assert from_port.cfg == JaxPriorConfig(**dataclasses.asdict(cfg))
    np.testing.assert_allclose(eps_jax(from_port), eps_port(pp), rtol=1e-5,
                               atol=1e-5)
    jax_path = str(tmp_path / "jax" / "prior.pkl")
    jp.save_with_config(jax_path)
    from_jax = PriorPipe.from_checkpoint(jax_path, device="cpu")
    assert from_jax.cfg == cfg
    np.testing.assert_allclose(eps_port(from_jax), eps_jax(jp), rtol=1e-5,
                               atol=1e-5)
    # the JAX pipe's bare-tree file into a port pipe
    jp.save(str(tmp_path / "bare.pkl"))
    bare = PriorPipe(cfg, device="cpu")
    bare.load(str(tmp_path / "bare.pkl"))
    np.testing.assert_allclose(eps_port(bare), eps_jax(jp), rtol=1e-5,
                               atol=1e-5)


def test_prior_checkpoint_config_guard(tmp_path):
    pp = PriorPipe(TINY, device="cpu")
    pp.init(total_steps=1)
    path = pp.save_with_config(str(tmp_path / "prior.pkl"))
    wrong = PriorPipe(dataclasses.replace(TINY, hidden_dims=(64, 16)),
                      device="cpu")
    with pytest.raises(ValueError, match="hidden_dims"):
        wrong.load(path)
    back = PriorPipe.from_checkpoint(path, device="cpu")
    assert back.cfg == TINY
    for k, v in pp.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k


def test_prior_kill_and_resume_is_bit_equal(tmp_path):
    cfg = dataclasses.replace(TINY, dropout=0.1)
    rng = np.random.default_rng(22)
    c = rng.normal(size=(24, 64)).astype(np.float32)
    h = rng.normal(size=(24, 64)).astype(np.float32)
    full = PriorPipe(cfg, device="cpu")
    h_full = full.train(c, h, epochs=3, log_fn=None)

    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    part = PriorPipe(cfg, device="cpu")
    part.init(total_steps=(24 // 8) * 3)  # launched as 3 epochs
    part.train(c, h, epochs=2, log_fn=None, checkpointer=ckpt,
               ckpt_every_epochs=1)
    resumed = PriorPipe(cfg, device="cpu")
    h_res = resumed.train(c, h, epochs=3, log_fn=None,
                          checkpointer=Checkpointer(str(tmp_path / "ckpt")),
                          resume=True)
    assert [r["epoch"] for r in h_res] == [0, 1, 2]
    assert [r["loss"] for r in h_res] == [r["loss"] for r in h_full]
    for k, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    assert resumed.state.step == full.state.step == 9


def test_expand_image_embeddings_matches_jax():
    e = np.arange(6 * 3, dtype=np.float32).reshape(6, 3)
    np.testing.assert_array_equal(
        expand_image_embeddings(e, 3, 2, 4),
        jprior.expand_image_embeddings(e, 3, 2, 4))


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads([ln for ln in buf.getvalue().splitlines()
                       if ln.strip()][-1])


def test_cli_train_prior_on_exported_features(tmp_path):
    """``train-retrieval --export-features`` writes the pairs, ``train-prior``
    trains on them, a resume continues, and both packages read the file."""
    root = str(tmp_path / "things")
    feats = write_synthetic_things_tree(root, ("sub-01",), n_classes=3,
                                        n_test_classes=2, train_reps=1,
                                        test_reps=2, seed=23)
    export = str(tmp_path / "pairs.npz")
    _run(["train-retrieval", "--data-path", root, "--features", feats,
          "--device", "cpu", "--dtype", "float32", "--eval-ks", "2",
          "--batch-size", "10", "--train-reps", "1", "--epochs", "1",
          "--output-dir", str(tmp_path / "runs"), "--export-features",
          export])
    out = str(tmp_path / "prior")
    common = ["train-prior", "--eeg-features", export, "--device", "cpu",
              "--batch-size", "10", "--seed", "3"]
    row = _run([*common, "--epochs", "2", "--output-dir", out])
    assert row["epoch"] == 1 and np.isfinite(row["loss"])
    row3 = _run([*common, "--epochs", "3", "--resume-dir", out])
    assert row3["epoch"] == 2
    assert Checkpointer(os.path.join(out, "ckpt")).all_steps() == [2, 3]
    # the prior-v1 file (both packages read it: the pickle test above)
    port = PriorPipe.from_checkpoint(os.path.join(out, "diffusion_prior.pkl"),
                                     device="cpu")
    assert port.cfg == PriorConfig(epochs=3, batch_size=10, seed=3)
    with np.load(export) as z:
        c = torch.from_numpy(z["eeg_features_test"])
    sample = port.generate(c, num_inference_steps=5)
    assert sample.shape == (2, 1024) and torch.isfinite(sample).all()
    # --mesh (ported): one CPU rank in a child process, the same two epochs
    mesh = json.loads(run_cli_child(
        [*common, "--epochs", "2", "--mesh", "--output-dir",
         str(tmp_path / "prior_mesh")])[-1])
    assert mesh["epoch"] == 1
    np.testing.assert_allclose(mesh["loss"], row["loss"], rtol=1e-5)


def test_prior_pipe_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PriorPipe(TINY)
