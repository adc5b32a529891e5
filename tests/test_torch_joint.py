"""Joint-subject training (``ATMSConfig(joint_train=True)``: per-subject
value embeddings) against the JAX package, on the CPU, fp32.

- ``ChannelTokenEmbedding(joint_train=True)`` forward and gradients against
  the JAX module, with subject ids inside and outside the table (clipped for
  the value embedding; the shared-token fallback for the subject token).
- The whole joint ATM-S in train mode with the seven dropout sites pinned:
  features and every parameter gradient, the weights carried over by
  ``params_from_flax`` (strict). The fused head is on, so a pinned ``proj``
  mask must route both models through the exact-erf chain.
- A joint model trains through ``ContrastiveTrainer`` on mixed-subject
  batches with the fused head in seed mode.

Tolerances: the embedding alone differs in fp32 summation order only (1e-5);
the whole model as ``tests/test_torch_train.py`` (atol 3e-3, rtol 2e-3).
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from eeg_image_decode_tpu.core.config import ATMSConfig as JaxATMSConfig
from eeg_image_decode_tpu.models import build_encoder as jax_build_encoder
from eeg_image_decode_tpu.models.subject_embed import (
    ChannelTokenEmbedding as JaxEmbedding,
)
from eeg_image_decode_tpu_torch.core.config import (
    ATMSConfig,
    ContrastiveTrainConfig,
)
from eeg_image_decode_tpu_torch.data.synthetic import (
    make_synthetic_retrieval_data,
)
from eeg_image_decode_tpu_torch.models.registry import build_encoder
from eeg_image_decode_tpu_torch.models.subject_embed import (
    ChannelTokenEmbedding,
)
from eeg_image_decode_tpu_torch.train.contrastive import ContrastiveTrainer
from eeg_image_decode_tpu_torch.utils.convert import params_from_flax
from torch_port_case import SMALL, keep_masks, randomize
from torch_port_case import two_threads  # noqa: F401 (autouse)

C, T, D = SMALL["n_channels"], SMALL["seq_len"], SMALL["d_model"]
N_SUB = SMALL["num_subjects"]


def test_joint_embedding_matches_jax_module():
    rng = np.random.default_rng(60)
    b = 5
    x = rng.normal(size=(b, C, T)).astype(np.float32)
    g = rng.normal(size=(b, C + 1, D)).astype(np.float32)
    jmod = JaxEmbedding(seq_len=T, d_model=D, num_subjects=N_SUB,
                        joint_train=True)
    for sids in (np.asarray([0, 2, 1, 2, 0], np.int32),
                 np.asarray([0, 5, 1, 2, 7], np.int32)):  # out of the table
        variables = randomize(jax.jit(lambda a, s: jmod.init(
            jax.random.key(0), a, s, deterministic=True))(
            jnp.asarray(x), jnp.asarray(sids)), 61)
        assert set(variables["params"]) == {
            "subject_value_w", "subject_value_b", "subject_token"}

        def loss(params):
            out = jmod.apply({"params": params}, jnp.asarray(x),
                             jnp.asarray(sids), deterministic=True)
            return jnp.sum(out * jnp.asarray(g)), out

        (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, variables["params"]))
        mod = ChannelTokenEmbedding(n_channels=C, seq_len=T, d_model=D,
                                    num_subjects=N_SUB, joint_train=True)
        assert "value_embedding.kernel" not in mod.state_dict()
        mod.load_state_dict(params_from_flax(variables), strict=True)
        out = mod(torch.from_numpy(x), torch.from_numpy(sids), torch.float32)
        (out * torch.from_numpy(g)).sum().backward()
        tol = dict(rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   **tol)
        want_g = params_from_flax({"params": jax.tree_util.tree_map(
            np.asarray, grads)})
        for k, p in mod.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(),
                                       **tol, err_msg=k)


def _port_config(**kw):
    names = {f.name for f in dataclasses.fields(ATMSConfig)}
    return ATMSConfig(**{k: v for k, v in kw.items() if k in names})


def test_joint_atms_train_forward_and_grads_match_jax():
    rng = np.random.default_rng(62)
    b = 4
    cfg_kw = {**SMALL, "joint_train": True, "fused_projection": True}
    eeg = (rng.normal(size=(b, C, T)) * 0.5).astype(np.float32)
    sids = np.asarray([0, 1, 2, 1], np.int32)
    heads, ff = SMALL["n_heads"], SMALL["d_ff"]
    k_fused = SMALL["temporal_kernel"] + SMALL["pool_size"] - 1
    n_pos = (D - k_fused) // SMALL["pool_stride"] + 1

    def keep(shape, p):
        return ((rng.random(shape) >= p) / (1.0 - p)).astype(np.float32)

    masks = {"emb": keep((b, C + 1, D), 0.25),
             "layer0": keep_masks(rng, b, heads, C + 1, D, ff),
             "tsconv": keep((b, 1, n_pos, SMALL["conv_filters"]), 0.5),
             "proj": keep((b, SMALL["proj_dim"]), 0.5)}
    probe = rng.normal(size=(b, SMALL["proj_dim"])).astype(np.float32)

    jmodel = jax_build_encoder("atms", config=JaxATMSConfig(**cfg_kw))
    variables = randomize(jax.jit(lambda x, s: jmodel.init(
        jax.random.key(0), x, s, deterministic=True))(
        jnp.asarray(eeg[:2]), jnp.asarray(sids[:2])), 63)
    jm = jax.tree_util.tree_map(jnp.asarray, masks)

    def loss_fn(params):
        (feats, _), _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(eeg), jnp.asarray(sids), deterministic=False,
            dropout_masks=jm, mutable=["batch_stats"])
        return jnp.sum(feats * jnp.asarray(probe)), feats

    (_, feats_j), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))

    model = build_encoder("atms", config=_port_config(**cfg_kw), device="cpu")
    sd = params_from_flax(variables)
    assert "encoder.embedding.subject_value_w" in sd
    model.load_state_dict(sd, strict=True)
    model.train()
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
    assert set(got) == set(want)
    for k, g in want.items():
        gt = got[k] if got[k] is not None else torch.zeros_like(g)
        np.testing.assert_allclose(gt.numpy(), g.numpy(), **tol, err_msg=k)


def test_joint_model_with_fused_head_trains_on_mixed_subject_batches():
    """Two epochs on the CPU over rows of three subjects: the losses are
    finite and every per-subject embedding moves."""
    train, test = make_synthetic_retrieval_data(
        n_classes=12, images_per_class=2, train_reps=2, n_channels=C,
        n_timepoints=T, clip_dim=SMALL["proj_dim"], seed=64, device="cpu")
    gen = torch.Generator().manual_seed(65)
    train.subject_ids = torch.randint(0, N_SUB, (train.n,), generator=gen,
                                      dtype=torch.int32)
    cfg = ContrastiveTrainConfig(batch_size=8, eval_ks=(2, 4))
    model = build_encoder(
        "atms", device="cpu",
        config=ATMSConfig(**SMALL, joint_train=True, fused_projection=True))
    before = model.encoder.embedding.subject_value_w.detach().clone()
    trainer = ContrastiveTrainer(model, cfg, train, test, device="cpu")
    history = trainer.fit(2, log_fn=None)
    assert all(np.isfinite(r["loss"]) for r in history)
    assert len(history) == 2
    moved = (model.encoder.embedding.subject_value_w.detach() - before
             ).abs().amax(dim=(1, 2))
    assert (moved > 0).all()
