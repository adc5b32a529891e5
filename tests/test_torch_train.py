"""The port's training slice against the JAX package, on the CPU, fp32.

- The ATM-S train-mode forward, the gradients of every parameter and the
  updated BatchNorm statistics with all seven dropout sites pinned to the
  same numpy masks (the recipe and tolerances of
  ``tests/test_dropout_placement_parity.py``: atol 3e-3, rtol 2e-3).
- The losses, the k-way evaluator with JAX's own Gumbel draws handed to both
  sides (exact), and a 3-step trainer trajectory from one initialisation
  with dropout off (the recipe and tolerances of
  ``tests/test_train_torch_parity.py``).
- ``ContrastiveTrainer(device="cpu")`` fits; without ``device="cpu"`` it
  needs a CUDA device.

Weights: the JAX variables, every leaf redrawn from a numpy seed
(``torch_port_case.randomize``), carried into the port by
``utils/convert.py::params_from_flax``.
"""

import copy
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from eeg_image_decode_tpu.core.config import ATMSConfig as JaxATMSConfig
from eeg_image_decode_tpu.core.config import (
    ContrastiveTrainConfig as JaxTrainConfig,
)
from eeg_image_decode_tpu.models import build_encoder as jax_build_encoder
from eeg_image_decode_tpu.train import contrastive as jax_contrastive
from eeg_image_decode_tpu.train.evaluator import (
    retrieval_eval as jax_retrieval_eval,
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
    DeviceData,
    batch_loss,
    create_train_state,
    epoch_permutation,
    make_epoch_fn,
)
from eeg_image_decode_tpu_torch.train.evaluator import retrieval_eval
from eeg_image_decode_tpu_torch.utils.convert import params_from_flax
from torch_port_case import SMALL, keep_masks, randomize
from torch_port_case import two_threads  # noqa: F401 (autouse)

# the modules (each package's ``clip_loss`` name is the function)
jax_losses = importlib.import_module("eeg_image_decode_tpu.losses.clip_loss")
port_losses = importlib.import_module(
    "eeg_image_decode_tpu_torch.losses.clip_loss")

C, T = SMALL["n_channels"], SMALL["seq_len"]
K_FUSED = SMALL["temporal_kernel"] + SMALL["pool_size"] - 1
N_POS = (SMALL["d_model"] - K_FUSED) // SMALL["pool_stride"] + 1


def _port_config(**kw):
    names = {f.name for f in dataclasses.fields(ATMSConfig)}
    return ATMSConfig(**{k: v for k, v in kw.items() if k in names})


def _init(cfg_kw, eeg, sids, seed):
    """The JAX model and its randomised variables (numpy tree)."""
    model = jax_build_encoder("atms", config=JaxATMSConfig(**cfg_kw))
    # jitted: one compile instead of one per op
    variables = jax.jit(lambda x, s: model.init(
        jax.random.key(0), x, s, deterministic=True))(
        jnp.asarray(eeg[:2]), jnp.asarray(sids[:2]))
    return model, randomize(variables, seed)


def _port_model(cfg_kw, variables):
    model = build_encoder("atms", config=_port_config(**cfg_kw), device="cpu")
    model.load_state_dict(params_from_flax(variables), strict=True)
    return model


def _seven_masks(rng, b):
    d, heads, ff = SMALL["d_model"], SMALL["n_heads"], SMALL["d_ff"]

    def keep(shape, p):
        return ((rng.random(shape) >= p) / (1.0 - p)).astype(np.float32)

    return {"emb": keep((b, C + 1, d), 0.25),
            "layer0": keep_masks(rng, b, heads, C + 1, d, ff),
            "tsconv": keep((b, 1, N_POS, SMALL["conv_filters"]), 0.5),
            "proj": keep((b, SMALL["proj_dim"]), 0.5)}


@pytest.mark.parametrize("cfg_kw", [
    {}, {"fused_attention": False}, {"exact_gelu": True}],
    ids=["default", "plain_attention", "exact_gelu"])
def test_train_forward_grads_and_batch_stats_match_jax(cfg_kw):
    """All seven dropout sites pinned: features, every parameter gradient
    and the updated running statistics. The default runs the attention
    layer's autograd.Function (mask mode) and the tsconv Function."""
    rng = np.random.default_rng(40)
    b = 4
    cfg_kw = {**SMALL, **cfg_kw}
    eeg = (rng.normal(size=(b, C, T)) * 0.5).astype(np.float32)
    sids = np.asarray([0, 1, 2, 1], np.int32)
    masks = _seven_masks(rng, b)
    probe = rng.normal(size=(b, SMALL["proj_dim"])).astype(np.float32)
    jmodel, variables = _init(cfg_kw, eeg, sids, seed=41)
    jm = jax.tree_util.tree_map(jnp.asarray, masks)

    def loss_fn(params):
        (feats, _), upd = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(eeg), jnp.asarray(sids), deterministic=False,
            dropout_masks=jm, mutable=["batch_stats"])
        return jnp.sum(feats * jnp.asarray(probe)), (feats, upd)

    (_, (feats_j, upd)), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))

    model = _port_model(cfg_kw, variables).train()
    tm = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else torch.from_numpy(v))
          for k, v in masks.items()}
    feats_t, _ = model(torch.from_numpy(eeg), torch.from_numpy(sids),
                       dropout_masks=tm)
    (feats_t * torch.from_numpy(probe)).sum().backward()

    tol = dict(atol=3e-3, rtol=2e-3)
    np.testing.assert_allclose(feats_t.detach().numpy(), np.asarray(feats_j),
                               **tol)
    want = params_from_flax({"params": jax.tree_util.tree_map(np.asarray,
                                                              grads_j)})
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want) and len(got) >= 25
    for k, g in want.items():
        gt = got[k] if got[k] is not None else torch.zeros_like(g)
        np.testing.assert_allclose(gt.numpy(), g.numpy(), **tol, err_msg=k)
    stats = params_from_flax({"batch_stats": jax.tree_util.tree_map(
        np.asarray, upd["batch_stats"])})
    buffers = dict(model.named_buffers())
    assert len(stats) == 4
    for k, v in stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), v.numpy(), **tol,
                                   err_msg=k)


@pytest.mark.parametrize("which", ["clip", "retrieval", "reconstruction"])
def test_losses_match_jax(which):
    """Values and gradients (features and the raw scale) in fp32."""
    rng = np.random.default_rng(42)
    a, bm, c = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(3))
    scale = np.float32(2.6592600225)
    fns = {
        "clip": (lambda m, x, y, z, s: m.clip_loss(x, y, s)),
        "retrieval": (lambda m, x, y, z, s: m.retrieval_loss(x, y, z, s)),
        "reconstruction": (lambda m, x, y, z, s: m.reconstruction_loss(x, y,
                                                                       s)),
    }
    fn = fns[which]
    want, (ga_j, gs_j) = jax.value_and_grad(
        lambda x, s: fn(jax_losses, x, jnp.asarray(bm), jnp.asarray(c), s),
        argnums=(0, 1))(jnp.asarray(a), jnp.asarray(scale))
    at = torch.from_numpy(a).requires_grad_()
    st = torch.tensor(scale, requires_grad=True)
    got = fn(port_losses, at, torch.from_numpy(bm), torch.from_numpy(c), st)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ga_j), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(float(st.grad), float(gs_j), rtol=1e-4)


def test_evaluator_matches_jax_with_shared_gumbel_noise():
    """Every k of the protocol, with the Gumbel draw JAX's retrieval_eval
    makes for that k handed to the port: the accuracies are equal."""
    rng = np.random.default_rng(43)
    n, n_cls, ks = 40, 64, (2, 4, 10, 50, 64, 100)
    feats = rng.normal(size=(n, 16)).astype(np.float32)
    cls = rng.normal(size=(n_cls, 16)).astype(np.float32)
    labels = rng.integers(0, n_cls, n).astype(np.int32)
    key = jax.random.key(7)
    want = jax_retrieval_eval(jnp.asarray(feats), jnp.asarray(cls),
                              jnp.asarray(labels), 2.0, ks=ks, key=key)
    noise = {k: torch.from_numpy(np.array(jax.random.gumbel(
        jax.random.fold_in(key, i), (n, n_cls))))
        for i, k in enumerate(ks) if k < n_cls}
    got = retrieval_eval(torch.from_numpy(feats), torch.from_numpy(cls),
                         torch.from_numpy(labels), 2.0, ks=ks, noise=noise)
    assert set(got) == set(want)
    assert {"top5_k50", "top5_k64", "top1_k2"} <= set(got)
    for k in want:
        assert float(got[k]) == float(want[k]), k


def test_three_step_trajectory_matches_jax():
    """Dropout off, one initialisation: the first step's gradients
    (atol 2e-4, rtol 1e-3), the losses of 3 steps (rtol 2e-3) and the
    parameters after them (within 3 · lr · 2: Adam's early updates are about
    sign(g) · lr, so gradient elements near 0 may move the other way)."""
    rng = np.random.default_rng(44)
    b, n_steps, lr, wd = 8, 3, 3e-4, 1e-2
    n, d = b * n_steps, SMALL["proj_dim"]
    cfg_kw = {**SMALL, "dropout": 0.0, "conv_dropout": 0.0,
              "proj_dropout": 0.0}
    eeg = (rng.normal(size=(n, C, T)) * 0.5).astype(np.float32)
    sids = np.full((n,), 1, np.int32)
    img = rng.normal(size=(n, d)).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    text = rng.normal(size=(n, d)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)

    # ——— JAX ———
    jmodel, variables = _init(cfg_kw, eeg, sids, seed=45)
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    tcfg = JaxTrainConfig(batch_size=b, lr=lr, weight_decay=wd)
    # what create_train_state builds, from the randomised variables
    tx = optax.adamw(lr, weight_decay=wd)
    state = jax_contrastive.TrainState(
        step=jnp.zeros((), jnp.int32), params=jv["params"],
        batch_stats=jv["batch_stats"], opt_state=tx.init(jv["params"]))
    jdata = jax_contrastive.DeviceData(
        eeg=jnp.asarray(eeg), labels=jnp.zeros((n,), jnp.int32),
        subject_ids=jnp.asarray(sids), img_feat=jnp.asarray(img),
        text_feat=jnp.asarray(text), img_idx=jnp.arange(n, dtype=jnp.int32),
        text_idx=jnp.arange(n, dtype=jnp.int32),
        class_img_feat=jnp.asarray(img[:1]))

    def jloss(params):
        (feats, scale), _ = jmodel.apply(
            {"params": params, "batch_stats": state.batch_stats},
            jdata.eeg[:b], jdata.subject_ids[:b], deterministic=False,
            mutable=["batch_stats"])
        return jax_losses.retrieval_loss(feats.astype(jnp.float32),
                                         jdata.img_feat[:b],
                                         jdata.text_feat[:b], scale)

    loss0_j, grads_j = jax.jit(jax.value_and_grad(jloss))(state.params)
    epoch_j = jax_contrastive.make_epoch_fn(jmodel, tx, tcfg)
    losses_j = []
    for s in range(n_steps):
        perm = jnp.arange(s * b, (s + 1) * b, dtype=jnp.int32)[None]
        state, m = epoch_j(state, jdata, perm, jax.random.key(0))
        losses_j.append(float(m["loss"]))

    # ——— the port ———
    model = _port_model(cfg_kw, variables)
    pcfg = ContrastiveTrainConfig(batch_size=b, lr=lr, weight_decay=wd)
    pdata = DeviceData(
        eeg=torch.from_numpy(eeg), labels=torch.zeros(n, dtype=torch.int64),
        subject_ids=torch.from_numpy(sids).long(),
        img_feat=torch.from_numpy(img), text_feat=torch.from_numpy(text),
        img_idx=torch.arange(n), text_idx=torch.arange(n),
        class_img_feat=torch.from_numpy(img[:1]))
    first = copy.deepcopy(model).train()
    batch = {"eeg": pdata.eeg[:b], "subject_ids": pdata.subject_ids[:b],
             "img_feat": pdata.img_feat[:b], "text_feat": pdata.text_feat[:b]}
    loss0, _ = batch_loss(first, pcfg, batch)
    loss0.backward()
    np.testing.assert_allclose(float(loss0.detach()), float(loss0_j), rtol=1e-5)
    want = params_from_flax({"params": jax.tree_util.tree_map(np.asarray,
                                                              grads_j)})
    for k, p in first.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=2e-4,
                                   rtol=1e-3, err_msg=k)

    state_t = create_train_state(model, pcfg)
    epoch_t = make_epoch_fn(pcfg)
    losses_t = []
    for s in range(n_steps):
        perm = torch.arange(s * b, (s + 1) * b)[None]
        losses_t.append(float(epoch_t(state_t, pdata, perm, None)["loss"]))
    assert state_t.step == n_steps
    np.testing.assert_allclose(losses_t, losses_j, rtol=2e-3)
    want = params_from_flax({"params": jax.tree_util.tree_map(np.asarray,
                                                              state.params)})
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   atol=n_steps * lr * 2, rtol=0.1, err_msg=k)


def test_epoch_permutation_is_the_jax_formula():
    for seed, epoch in ((0, 0), (3, 7)):
        np.testing.assert_array_equal(
            epoch_permutation(100, 16, seed, epoch),
            jax_contrastive.epoch_permutation(100, 16, seed, epoch))


def test_trainer_fits_on_cpu_and_needs_a_device(tmp_path):
    """Two small epochs on the CPU: finite losses, the eval protocol and the
    CSV log. Without device="cpu" the trainer wants the CUDA card."""
    train, test = make_synthetic_retrieval_data(
        n_classes=12, images_per_class=2, train_reps=2, n_channels=C,
        n_timepoints=T, clip_dim=SMALL["proj_dim"], seed=46, device="cpu")
    cfg = ContrastiveTrainConfig(batch_size=8, eval_ks=(2, 4, 12))
    model = build_encoder("atms", config=ATMSConfig(**SMALL), device="cpu")
    trainer = ContrastiveTrainer(model, cfg, train, test, device="cpu",
                                 output_dir=str(tmp_path))
    history = trainer.fit(2, log_fn=None)
    assert [row["epoch"] for row in history] == [0, 1]
    for row in history:
        assert np.isfinite(row["loss"])
        assert {"top1_k2", "top1_k4", "top1_k12", "train_acc"} <= set(row)
    assert len(trainer.last_steps["step_loss"]) == 48 // 8
    assert (tmp_path / "results.csv").read_text().count("\n") == 3
    feats = trainer.extract_features(test.eeg, test.subject_ids)
    assert feats.shape == (12, SMALL["proj_dim"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ContrastiveTrainer(model, cfg, train, test)
