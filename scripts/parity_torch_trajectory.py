"""Multi-epoch training trajectory of the port's ATM-S trainer against the
JAX package's, on the CPU.

The port's counterpart of ``scripts/parity_trajectory.py``: there the flax
trainer is held against a torch trainer written from the reference's spec;
here the torch side is the port's own trainer
(``eeg_image_decode_tpu_torch/train/contrastive.py``: ``create_train_state``,
``make_epoch_fn``, ``make_eval_features_fn``). Both start from one
initialisation on one learnable synthetic split with one batch order:

- the split: the class-template set of the JAX package's
  ``make_synthetic_retrieval_data`` (a numpy copy of its draws, so both
  sides read the same arrays);
- the weights: the JAX model's ``init``, carried into the port strictly by
  ``utils/convert.py::params_from_flax``;
- the batches: ``epoch_permutation``, the one formula both trainers share.

Deterministic mode (dropout, conv and projection dropout 0) reports:

1. the per-epoch losses and their relative deviation;
2. the final k-way tables (k ∈ {2, 4, 10, 50, 100}) with both feature sets
   scored by one evaluator under one draw of distractors, twice: through
   the port's ``train/evaluator.py::retrieval_eval`` with one ``noise=``
   dict drawn once in numpy, and through JAX's ``retrieval_eval`` under one
   key, as ``scripts/parity_trajectory.py`` scores;
3. per-sample decision agreement over the full gallery;
4. the trained logit scales;
5. BatchNorm's running mean and variance, as relative L2 per buffer (XLA's
   and PyTorch's reductions add in other orders, so these drift in their
   last bits; they are reported, not asserted).

``--stochastic N`` then turns dropout on at ATM-S's rates (0.25 attention,
0.5 conv and projection) and trains N seeds per side over the first third
of the epochs (at least 10). JAX draws its masks with its own PRNG; the
port draws its seed mode (Philox-4x32-10, ``ops/philox.py`` on the CPU, the
plain version of ``csrc/philox.cuh``; ``torch.rand`` at the other sites),
so the sides can only be held statistically: the port's mean final top-1
at the hardest k must fall inside the JAX seeds' band, widened by the
binomial standard error as ``scripts/parity_trajectory.py`` widens its
band. That top-1 sits near chance and cannot tell dropout on from off, so
the port's mean last-epoch loss must also fall inside the JAX seeds' loss
band (their extremes widened by two sd), and one port run with dropout off
must fall outside it. The spread of every k's top-1 over the seeds is
compared by an F test. The port's keep rate at every dropout site and the
value a kept element takes (1/keep) are reported beside it.

fp32 on the CPU on both sides (JAX's TPU matmuls would run bf16 passes).
Needs JAX and the JAX package, so it does not run on the card host.

    python3 scripts/parity_torch_trajectory.py [--epochs 30] [--stochastic 10]

``tests/test_torch_trajectory.py`` runs a shortened configuration through
:func:`trajectory_parity_torch`.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KS = (2, 4, 10, 50, 100)
NOISE_SEED = 1234
#: ATM-S's dropout rates (``ATMSConfig``): attention, conv, projection
RATES = {"dropout": 0.25, "conv_dropout": 0.5, "proj_dropout": 0.5}
NO_DROPOUT = {k: 0.0 for k in RATES}


def build_data(n_classes, ipc, reps, seed, *, n_channels=63,
               n_timepoints=250, clip_dim=1024, snr=1.0, subject_id=1):
    """(train, test) :class:`EEGRetrievalData` of numpy arrays: the draws of
    the JAX package's ``data/synthetic.py::make_synthetic_retrieval_data``
    (class anchors in CLIP space, a rank-16 class signature mixed into
    channel × time, unit-variance noise; the test split at a quarter of it),
    copied here so the split is one set of arrays for both sides."""
    from eeg_image_decode_tpu_torch.data.things_eeg import EEGRetrievalData

    rng = np.random.default_rng(seed)
    anchors = rng.normal(size=(n_classes, clip_dim)).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=1, keepdims=True)
    img = anchors[:, None, :] + 0.1 * rng.normal(
        size=(n_classes, ipc, clip_dim)).astype(np.float32)
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    img = img.reshape(n_classes * ipc, clip_dim)
    text = anchors + 0.05 * rng.normal(size=anchors.shape).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    rank = 16
    class_latent = rng.normal(size=(n_classes, rank)).astype(np.float32)
    mix = rng.normal(size=(rank, n_channels, n_timepoints)).astype(np.float32)
    mix /= np.sqrt(rank)

    def epochs(labels, noise_scale):
        signal = np.einsum("nr,rct->nct", class_latent[labels], mix)
        noise = rng.normal(size=signal.shape).astype(np.float32)
        return (snr * signal + noise_scale * noise).astype(np.float32)

    n_train = n_classes * ipc * reps
    labels = np.repeat(np.arange(n_classes, dtype=np.int32), ipc * reps)
    train_eeg = epochs(labels, 1.0)
    local = np.arange(n_train)
    train = EEGRetrievalData(
        eeg=train_eeg, labels=labels,
        subject_ids=np.full(n_train, subject_id, np.int32),
        img_idx=(local // reps).astype(np.int32),
        text_idx=(local // (ipc * reps)).astype(np.int32),
        img_features=img, text_features=text, n_classes=n_classes,
        images_per_class=ipc)
    test_labels = np.arange(n_classes, dtype=np.int32)
    test_img = anchors + 0.1 * rng.normal(size=anchors.shape).astype(
        np.float32)
    test_img /= np.linalg.norm(test_img, axis=-1, keepdims=True)
    test = EEGRetrievalData(
        eeg=epochs(test_labels, 0.25), labels=test_labels,
        subject_ids=np.full(n_classes, subject_id, np.int32),
        img_idx=np.arange(n_classes, dtype=np.int32),
        text_idx=np.arange(n_classes, dtype=np.int32),
        img_features=test_img, text_features=text, n_classes=n_classes,
        images_per_class=1)
    return train, test


def shared_noise(n_test, n_cls, ks=KS, seed=NOISE_SEED):
    """One Gumbel draw (n_test, n_cls) per sampled k, in numpy: the
    distractor sets both feature sets are scored under."""
    rng = np.random.default_rng(seed)
    tiny = np.finfo(np.float32).tiny
    out = {}
    for k in ks:
        if k < n_cls:
            u = rng.random((n_test, n_cls)).astype(np.float32)
            out[k] = -np.log(-np.log(np.clip(u, tiny, 1.0 - 2.0**-24)))
    return out


def port_table(feats, test, scale, noise):
    """The port's evaluator on ``feats`` under the shared ``noise``."""
    import torch

    from eeg_image_decode_tpu_torch.train.evaluator import retrieval_eval

    table = retrieval_eval(
        torch.from_numpy(np.array(feats, np.float32)),
        torch.as_tensor(test.class_img_features()),
        torch.as_tensor(test.labels), float(scale), ks=KS,
        noise={k: torch.from_numpy(v) for k, v in noise.items()})
    return {k: float(v) for k, v in table.items()}


def jax_table(feats, test, scale):
    """JAX's evaluator on ``feats`` under key 1234, as
    ``scripts/parity_trajectory.py`` scores both sides."""
    import jax
    import jax.numpy as jnp

    from eeg_image_decode_tpu.train.evaluator import retrieval_eval

    table = retrieval_eval(
        jnp.asarray(np.asarray(feats)),
        jnp.asarray(test.class_img_features()), jnp.asarray(test.labels),
        float(scale), ks=KS, key=jax.random.key(NOISE_SEED))
    return {k: float(v) for k, v in table.items()}


def jax_init(model_kw, train, batch, lr, wd, seed):
    """The JAX model's initial variables at ``model_kw`` as numpy trees
    (``create_train_state``, dropout off: the initialisation does not
    depend on the rates)."""
    import jax
    import jax.numpy as jnp

    from eeg_image_decode_tpu.core.config import (
        ATMSConfig,
        ContrastiveTrainConfig,
    )
    from eeg_image_decode_tpu.models import build_encoder
    from eeg_image_decode_tpu.train.contrastive import create_train_state

    model = build_encoder("atms", config=ATMSConfig(**model_kw, **NO_DROPOUT))
    tcfg = ContrastiveTrainConfig(batch_size=batch, lr=lr, weight_decay=wd,
                                  alpha=0.99, seed=seed)
    state, _ = create_train_state(model, tcfg, jnp.asarray(train.eeg[:2]),
                                  jnp.asarray(train.subject_ids[:2]))
    return jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})


@functools.lru_cache(maxsize=None)
def _jax_fns(model_items, dropout, batch, lr, wd):
    """The optimiser and the jitted epoch and eval functions of one JAX
    configuration, built once: every seed of the band reuses the compiled
    epoch."""
    import optax

    from eeg_image_decode_tpu.core.config import (
        ATMSConfig,
        ContrastiveTrainConfig,
    )
    from eeg_image_decode_tpu.models import build_encoder
    from eeg_image_decode_tpu.train.contrastive import (
        make_epoch_fn,
        make_eval_features_fn,
    )

    rates = RATES if dropout else NO_DROPOUT
    model = build_encoder("atms", config=ATMSConfig(**dict(model_items),
                                                    **rates))
    tcfg = ContrastiveTrainConfig(batch_size=batch, lr=lr, weight_decay=wd,
                                  alpha=0.99)
    tx = optax.adamw(lr, weight_decay=wd)
    return tx, make_epoch_fn(model, tx, tcfg), make_eval_features_fn(model)


def run_jax(variables, model_kw, train, test, perms, batch, lr, wd, *,
            dropout=False, seed=0):
    """The JAX trainer from ``variables`` (numpy trees; the epoch function
    donates its state): (per-epoch losses, test features, logit scale,
    trained state)."""
    import jax
    import jax.numpy as jnp

    from eeg_image_decode_tpu.train.contrastive import DeviceData, TrainState

    tx, epoch_fn, eval_fn = _jax_fns(tuple(sorted(model_kw.items())),
                                     dropout, batch, lr, wd)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=tx.init(params))
    data = DeviceData(
        eeg=jnp.asarray(train.eeg), labels=jnp.asarray(train.labels),
        subject_ids=jnp.asarray(train.subject_ids),
        img_feat=jnp.asarray(train.img_features),
        text_feat=jnp.asarray(train.text_features),
        img_idx=jnp.asarray(train.img_idx),
        text_idx=jnp.asarray(train.text_idx),
        class_img_feat=jnp.asarray(train.class_img_features()))
    losses = []
    for epoch, perm in enumerate(perms):
        state, metrics = epoch_fn(state, data, jnp.asarray(perm),
                                  jax.random.key(seed + 7919 * epoch))
        losses.append(float(metrics["loss"]))
    feats, scale = eval_fn(state.params, state.batch_stats,
                           jnp.asarray(test.eeg),
                           jnp.asarray(test.subject_ids))
    return losses, np.asarray(feats), float(scale), state


def port_model(model_kw, variables, *, dropout=False):
    """The port's ATM-S on the CPU with ``variables`` (the JAX tree) loaded
    strictly."""
    from eeg_image_decode_tpu_torch.core.config import ATMSConfig
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.utils.convert import params_from_flax

    rates = RATES if dropout else NO_DROPOUT
    model = build_encoder("atms", config=ATMSConfig(**model_kw, **rates),
                          device="cpu")
    model.load_state_dict(params_from_flax(variables), strict=True)
    return model


def run_port(variables, model_kw, train, test, perms, batch, lr, wd, *,
             dropout=False, seed=0):
    """The port's trainer from ``variables``: (per-epoch losses, test
    features, logit scale, trained model). Each epoch's generator is seeded
    (seed + 7919 · epoch), as ``ContrastiveTrainer.train_epoch`` seeds it;
    with dropout on, the attention sites draw the seed mode's Philox bits."""
    import torch

    from eeg_image_decode_tpu_torch.core.config import ContrastiveTrainConfig
    from eeg_image_decode_tpu_torch.train.contrastive import (
        DeviceData,
        create_train_state,
        make_epoch_fn,
        make_eval_features_fn,
    )

    model = port_model(model_kw, variables, dropout=dropout)
    cfg = ContrastiveTrainConfig(batch_size=batch, lr=lr, weight_decay=wd,
                                 alpha=0.99)
    state = create_train_state(model, cfg)
    data = DeviceData.from_host(train, "cpu")
    epoch_fn = make_epoch_fn(cfg)
    losses = []
    for epoch, perm in enumerate(perms):
        gen = torch.Generator().manual_seed(seed + 7919 * epoch)
        out = epoch_fn(state, data, torch.as_tensor(perm), gen)
        losses.append(float(out["loss"]))
    feats, scale = make_eval_features_fn(model)(
        torch.as_tensor(test.eeg), torch.as_tensor(test.subject_ids).long())
    return losses, feats.numpy(), float(scale.detach()), model


def keep_rates(model_kw, batch, seed=0):
    """The port's keep rate at each dropout site of one training step at
    ATM-S's rates, drawn as the model draws it: the attention layer's four
    sites in the seed mode's Philox bits (``ops/attention.py::
    draw_keep_masks`` on a seed from the step's generator), the embedding,
    conv and projection sites through ``models/layers.py::dropout``.
    Returns {site: (kept fraction, expected keep, binomial se, kept value,
    1/keep)}."""
    import torch

    from eeg_image_decode_tpu_torch.core.config import ATMSConfig
    from eeg_image_decode_tpu_torch.models.layers import dropout
    from eeg_image_decode_tpu_torch.ops.attention import draw_keep_masks

    cfg = ATMSConfig(**model_kw)
    gen = torch.Generator().manual_seed(seed)
    # the channel tokens and the subject token, each d_model wide
    length, d = cfg.n_channels + 1, cfg.d_model
    n_pos = (cfg.d_model - (cfg.temporal_kernel + cfg.pool_size - 1)) \
        // cfg.pool_stride + 1
    step_seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen,
                                  dtype=torch.int32))
    p_attn, p_conv, p_proj = (RATES[k] for k in RATES)
    sites = {k: (m, p_attn) for k, m in draw_keep_masks(
        step_seed, batch, cfg.n_heads, length, d, cfg.d_ff, p_attn).items()}
    for site, shape, p in (
            ("emb", (batch, length, d), p_attn),
            ("tsconv", (batch, 1, n_pos, cfg.conv_filters), p_conv),
            ("proj", (batch, cfg.proj_dim), p_proj)):
        sites[site] = (dropout(torch.ones(shape), p, train=True,
                               generator=gen), p)
    out = {}
    for site, (m, p) in sites.items():
        keep = 1.0 - p
        values = m[m != 0].unique()
        out[site] = (float((m != 0).float().mean()), keep,
                     float(np.sqrt(keep * (1 - keep) / m.numel())),
                     float(values[0]) if len(values) == 1 else float("nan"),
                     1.0 / keep)
    return out


def hardest_k(table):
    return "top1_k" + str(max(int(k.split("top1_k")[1]) for k in table
                              if k.startswith("top1_k")))


def stochastic_band(variables, model_kw, train, test, perms, batch, lr, wd,
                    noise, n_seeds, log=print):
    """N dropout-on seeds per side, each side's final top-1 at the hardest
    k scored through the port's evaluator under the shared ``noise``; the
    JAX seeds' band widened by the binomial se, as
    ``scripts/parity_trajectory.py:385-424`` widens it.

    At the hardest k the top-1 sits a few hits above chance, where dropout
    on and off score alike, so that band cannot tell them apart. The last
    epoch's training loss can: the port's mean must also fall inside the
    JAX seeds' loss band, and one port run with dropout off (the control)
    must fall outside it, or the band has shown nothing."""
    j_acc, t_acc, j_loss, t_loss, key = [], [], [], [], None
    tables = {"jax": [], "port": []}
    for s in range(n_seeds):
        jl, jf, js, _ = run_jax(variables, model_kw, train, test, perms,
                                batch, lr, wd, dropout=True, seed=s)
        tl, tf, ts, _ = run_port(variables, model_kw, train, test, perms,
                                 batch, lr, wd, dropout=True, seed=s)
        jt = port_table(jf, test, js, noise)
        tt = port_table(tf, test, ts, noise)
        tables["jax"].append(jt)
        tables["port"].append(tt)
        key = key or hardest_k(jt)
        j_acc.append(jt[key])
        t_acc.append(tt[key])
        j_loss.append(jl[-1])
        t_loss.append(tl[-1])
        log(f"seed {s}: jax {key}={j_acc[-1]:.4f} loss {jl[-1]:.4f}; port "
            f"{key}={t_acc[-1]:.4f} loss {tl[-1]:.4f}")
    cl, cf, cs, _ = run_port(variables, model_kw, train, test, perms, batch,
                             lr, wd, dropout=False, seed=0)
    control = {"loss": cl[-1], "table": port_table(cf, test, cs, noise)}
    log(f"control (port, dropout off): {key}={control['table'][key]:.4f} "
        f"loss {cl[-1]:.4f}")
    n_t = int(test.eeg.shape[0])
    # the band must include binomial sampling noise: with n_test samples a
    # single accuracy has se = sqrt(p(1-p)/n), which at small n dwarfs the
    # seed-to-seed spread (that can quantize to zero over a few seeds)
    p = max(float(np.mean(t_acc + j_acc)), 1.0 / n_t)
    se = float(np.sqrt(p * (1.0 - p) / n_t))
    lo = min(j_acc) - 2 * (float(np.std(j_acc)) + se)
    hi = max(j_acc) + 2 * (float(np.std(j_acc)) + se)
    mean_t = float(np.mean(t_acc))
    sd_l = float(np.std(j_loss))
    loss_band = (min(j_loss) - 2 * sd_l, max(j_loss) + 2 * sd_l)
    mean_tl = float(np.mean(t_loss))
    # two-sided F test of the sides' top-1 variances at every k (seeds
    # share the init, the split, the batch order and the distractors, so
    # only the masks differ between them); at least 3 seeds a side
    var_p = {k: float("nan") for k in tables["jax"][0]}
    if n_seeds >= 3:
        from scipy import stats

        for k in var_p:
            vj = np.var([t[k] for t in tables["jax"]], ddof=1)
            vt = np.var([t[k] for t in tables["port"]], ddof=1)
            if vj > 0 and vt > 0:
                cdf = stats.f.cdf(vj / vt, n_seeds - 1, n_seeds - 1)
                var_p[k] = float(2 * min(cdf, 1 - cdf))
    return {"key": key, "jax_acc": j_acc, "port_acc": t_acc,
            "jax_mean": float(np.mean(j_acc)), "jax_sd": float(np.std(j_acc)),
            "port_mean": mean_t, "port_sd": float(np.std(t_acc)),
            "jax_loss": j_loss, "port_loss": t_loss,
            "mean_tables": {side: {k: float(np.mean([t[k] for t in ts]))
                                   for k in ts[0]}
                            for side, ts in tables.items()},
            "sd_tables": {side: {k: float(np.std([t[k] for t in ts]))
                                 for k in ts[0]}
                          for side, ts in tables.items()},
            "var_ratio_p": var_p,
            "se": se, "band": (lo, hi), "inside": lo <= mean_t <= hi,
            "loss_band": loss_band,
            "loss_inside": loss_band[0] <= mean_tl <= loss_band[1],
            "control": control,
            "control_outside": not (loss_band[0] <= cl[-1] <= loss_band[1]),
            "epochs": len(perms)}


def trajectory_parity_torch(n_classes=100, ipc=1, reps=4, epochs=30,
                            batch=64, lr=3e-4, wd=1e-2, seed=0, *,
                            model_kw=None, deterministic=True, stochastic=0,
                            stochastic_epochs=None, log=print):
    """The comparison; returns a dict of curves, tables, agreement, scales,
    BatchNorm deviations and (``stochastic`` > 0) the band and the keep
    rates. Shared by the script and ``tests/test_torch_trajectory.py``.
    ``model_kw``: ``ATMSConfig`` fields on both sides (default: the full
    ``ATMSConfig()`` width); the split takes its channels, samples and
    feature width from them."""
    import jax
    import torch

    from eeg_image_decode_tpu_torch.core.config import ATMSConfig
    from eeg_image_decode_tpu_torch.train.contrastive import (
        epoch_permutation,
    )
    from eeg_image_decode_tpu_torch.utils.convert import params_from_flax

    model_kw = dict(model_kw or {})
    cfg = ATMSConfig(**model_kw)
    train, test = build_data(n_classes, ipc, reps, seed,
                             n_channels=cfg.n_channels,
                             n_timepoints=cfg.seq_len, clip_dim=cfg.proj_dim)
    perms = [epoch_permutation(train.n, batch, seed, e)
             for e in range(epochs)]
    noise = shared_noise(int(test.eeg.shape[0]), n_classes)
    variables = jax_init(model_kw, train, batch, lr, wd, seed)
    res = {"n_test": int(test.eeg.shape[0]), "epochs": epochs,
           "batch": batch, "n_train": train.n}

    if deterministic:
        t0 = time.perf_counter()
        j_losses, j_feats, j_scale, state = run_jax(
            variables, model_kw, train, test, perms, batch, lr, wd)
        res["jax_time_s"] = time.perf_counter() - t0
        log(f"jax: {epochs} epochs in {res['jax_time_s']:.1f} s, final "
            f"loss {j_losses[-1]:.4f}")
        t0 = time.perf_counter()
        t_losses, t_feats, t_scale, model = run_port(
            variables, model_kw, train, test, perms, batch, lr, wd)
        res["port_time_s"] = time.perf_counter() - t0
        log(f"port: {epochs} epochs in {res['port_time_s']:.1f} s, final "
            f"loss {t_losses[-1]:.4f}")

        gal = np.asarray(test.class_img_features())
        want_bn = params_from_flax({"batch_stats": jax.tree_util.tree_map(
            np.asarray, state.batch_stats)})
        buffers = dict(model.named_buffers())
        bn = {}
        for k, v in want_bn.items():
            got = buffers[k].detach().double()
            bn[k] = float(torch.linalg.norm(got - v.double())
                          / max(float(torch.linalg.norm(v.double())),
                                1e-12))
        res.update({
            "jax_losses": j_losses, "torch_losses": t_losses,
            "rel_loss_dev": [abs(a - b) / max(abs(b), 1e-6)
                             for a, b in zip(j_losses, t_losses)],
            # the port's evaluator, one numpy draw of distractors
            "jax_table": port_table(j_feats, test, j_scale, noise),
            "torch_table": port_table(t_feats, test, t_scale, noise),
            # JAX's evaluator under one key
            "jax_table_jaxeval": jax_table(j_feats, test, j_scale),
            "torch_table_jaxeval": jax_table(t_feats, test, t_scale),
            "decision_agreement": float(np.mean(
                np.argmax(j_feats @ gal.T, 1)
                == np.argmax(t_feats @ gal.T, 1))),
            "jax_logit_scale": j_scale, "torch_logit_scale": t_scale,
            "bn_rel_l2": bn,
            "feat_max_abs_diff": float(np.max(np.abs(j_feats - t_feats))),
        })

    if stochastic:
        n_ep = stochastic_epochs or max(10, epochs // 3)
        res["keep_rates"] = keep_rates(model_kw, batch, seed)
        t0 = time.perf_counter()
        res["stochastic"] = stochastic_band(
            variables, model_kw, train, test, perms[:n_ep], batch, lr, wd,
            noise, stochastic, log=log)
        res["stochastic"]["time_s"] = time.perf_counter() - t0
    return res


def print_report(res, args):
    print(f"\n### Port trainer against JAX's ({args.classes} classes × "
          f"{args.ipc} × {args.reps} reps, bs {args.batch}, {args.epochs} "
          "epochs, dropout off, full ATMSConfig() width, fp32 CPU)\n")
    print("| epoch | jax loss | port loss | rel dev |")
    print("|---|---|---|---|")
    idxs = sorted(set([0, 1, 2] + list(range(4, args.epochs, 5))
                      + [args.epochs - 1]))
    for e in idxs:
        if e < len(res["jax_losses"]):
            print(f"| {e} | {res['jax_losses'][e]:.6f} | "
                  f"{res['torch_losses'][e]:.6f} | "
                  f"{res['rel_loss_dev'][e]:.2e} |")
    print(f"\nmax relative loss deviation: {max(res['rel_loss_dev']):.2e}")
    print("\n| k-way | jax top-1 | port top-1 | equal | jax (JAX eval) | "
          "port (JAX eval) | equal |")
    print("|---|---|---|---|---|---|---|")
    for k in sorted(res["jax_table"], key=lambda s: (s[:4], int(
            s.split("_k")[1]))):
        a, b = res["jax_table"][k], res["torch_table"][k]
        c = res["jax_table_jaxeval"][k]
        d = res["torch_table_jaxeval"][k]
        print(f"| {k} | {a:.4f} | {b:.4f} | {'✓' if a == b else '✗'} | "
              f"{c:.4f} | {d:.4f} | {'✓' if c == d else '✗'} |")
    n = res["n_test"]
    print(f"\nper-sample decision agreement (full gallery): "
          f"{res['decision_agreement']:.4f} "
          f"({round(res['decision_agreement'] * n)}/{n})")
    print(f"test features max |Δ|: {res['feat_max_abs_diff']:.3e}")
    print(f"trained logit scale: jax {res['jax_logit_scale']:.6f}, port "
          f"{res['torch_logit_scale']:.6f}")
    print("BatchNorm running stats, relative L2: " + ", ".join(
        f"{k} {v:.2e}" for k, v in res["bn_rel_l2"].items()))
    print(f"seconds: jax {res['jax_time_s']:.1f}, port "
          f"{res['port_time_s']:.1f}")


def check_deterministic(res, max_rel=0.05):
    """The limits of ``scripts/parity_trajectory.py``: a near-tie whose
    drifted logits flip one sample moves a table row by 1/n_test — one flip
    a row is tolerated, nothing more; per-sample decisions agree on all but
    two test samples. Returns the list of failures."""
    n = res["n_test"]
    tol = 1.5 / n
    bad = []
    if max(res["rel_loss_dev"]) >= max_rel:
        bad.append(f"relative loss deviation {max(res['rel_loss_dev'])}")
    if not res["jax_losses"][-1] < 0.5 * res["jax_losses"][0]:
        bad.append("the learnable set did not train")
    for which in ("", "_jaxeval"):
        for k, a in res["jax_table" + which].items():
            if abs(a - res["torch_table" + which][k]) > tol:
                bad.append(f"table{which} {k}")
    if res["decision_agreement"] < 1.0 - 2.0 / n:
        bad.append(f"decision agreement {res['decision_agreement']}")
    return bad


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--classes", type=int, default=100)
    ap.add_argument("--ipc", type=int, default=1)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stochastic", type=int, default=0, metavar="N",
                    help="also run N dropout-on seeds per side and hold the "
                         "port's mean final top-1 to the JAX seeds' band")
    ap.add_argument("--no-deterministic", action="store_true",
                    help="only the stochastic band")
    args = ap.parse_args()

    res = trajectory_parity_torch(
        n_classes=args.classes, ipc=args.ipc, reps=args.reps,
        epochs=args.epochs, batch=args.batch, seed=args.seed,
        deterministic=not args.no_deterministic, stochastic=args.stochastic)
    failures = []
    if not args.no_deterministic:
        print_report(res, args)
        failures = check_deterministic(res)
        print("\ntrajectory parity " + ("PASS" if not failures
                                        else f"FAIL: {failures}"))
    if args.stochastic:
        st = res["stochastic"]
        print(f"\n### Seeded dropout ({args.stochastic} seeds a side, "
              f"{st['epochs']} epochs, ATM-S's rates)\n")
        print(f"| seed | jax {st['key']} | port {st['key']} | jax last "
              "loss | port last loss |")
        print("|---|---|---|---|---|")
        for s, row in enumerate(zip(st["jax_acc"], st["port_acc"],
                                    st["jax_loss"], st["port_loss"])):
            print(f"| {s} | " + " | ".join(f"{v:.4f}" for v in row) + " |")
        print(f"\njax mean ± sd: {st['jax_mean']:.4f} ± {st['jax_sd']:.4f}, "
              f"last loss {np.mean(st['jax_loss']):.4f} ± "
              f"{np.std(st['jax_loss']):.4f}")
        print(f"port mean ± sd: {st['port_mean']:.4f} ± {st['port_sd']:.4f}, "
              f"last loss {np.mean(st['port_loss']):.4f} ± "
              f"{np.std(st['port_loss']):.4f}")
        print("mean over seeds: " + ", ".join(
            f"{k} jax {st['mean_tables']['jax'][k]:.4f} port "
            f"{st['mean_tables']['port'][k]:.4f}"
            for k in st["mean_tables"]["jax"]))
        print("sd over seeds: " + ", ".join(
            f"{k} jax {st['sd_tables']['jax'][k]:.4f} port "
            f"{st['sd_tables']['port'][k]:.4f} (F test p "
            f"{st['var_ratio_p'][k]:.3g})" for k in st["sd_tables"]["jax"]))
        lo, hi = st["band"]
        print(f"top-1 band [{lo:.4f}, {hi:.4f}] (binomial se {st['se']:.4f}):"
              f" port mean {'inside' if st['inside'] else 'OUTSIDE'}")
        lo, hi = st["loss_band"]
        print(f"last-loss band [{lo:.4f}, {hi:.4f}]: port mean "
              f"{np.mean(st['port_loss']):.4f} "
              f"{'inside' if st['loss_inside'] else 'OUTSIDE'}; control "
              f"(port, dropout off) {st['control']['loss']:.4f} "
              f"{'outside' if st['control_outside'] else 'INSIDE'}, "
              f"{st['key']} {st['control']['table'][st['key']]:.4f}")
        print("\n| site | kept fraction | keep | se | kept value | 1/keep |")
        print("|---|---|---|---|---|---|")
        for site, (f, keep, se, v, inv) in res["keep_rates"].items():
            print(f"| {site} | {f:.5f} | {keep} | {se:.5f} | {v:.6f} | "
                  f"{inv:.6f} |")
        print(f"seconds: {st['time_s']:.1f}")
        failures += [name for name, ok in (
            ("top-1 band", st["inside"]), ("loss band", st["loss_inside"]),
            ("control inside the loss band", st["control_outside"])) if not ok]
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
