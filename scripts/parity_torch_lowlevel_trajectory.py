"""Multi-epoch training trajectory of the port's low-level (EEG → VAE
latent) trainer against the JAX package's, on the CPU.

The port's counterpart of ``scripts/parity_lowlevel_trajectory.py``: there
the JAX ``LowLevelTrainer`` is held against the reference's own
``train_model``; here the port's ``train/lowlevel.py::LowLevelTrainer`` is
held against the JAX one. Both start from one initialisation (the JAX
trainer's ``init``, carried into the port strictly by
``utils/convert.py::params_from_flax``) and run their own ``train()`` on
one learnable synthetic set. The loop draws nothing: both trainers take
the same epoch-keyed permutation (``default_rng(seed·7907 + epoch)``) and
the reference's per-epoch ``CosineAnnealingLR`` staircase (JAX's
``init(..., steps_per_epoch=)``, the schedule its ``train()`` builds, not
the per-step fallback of its ``init()`` without it), AdamW with weight
decay 0.01, L1 to the latents, train-mode BatchNorm.

It reports:

1. the per-epoch L1 of each side and their relative deviation;
2. the final parameters' max |Δ| and BatchNorm's running statistics as
   the largest relative Δ per buffer (both packages keep flax's biased
   variance, so the n/(n−1) factor that relates them to torch's own
   BatchNorm scales both sides alike and leaves the relative Δ as it is);
3. the trained predictors on 32 held-out trials: the cross PSNR of their
   latents and each one's L1 to the targets;
4. the first batch's gradients of each side (fp32) against the port's
   model in float64, as the largest relative L2 over the parameters: as
   they are, and against the float64 gradient taken along that side's own
   branches (the side of every ReLU and the sign of every L1 residual),
   with the count of branches each side takes apart from float64's. A
   BatchNorm output within rounding of 0 may fall on either side of its
   ReLU, and the choice moves every gradient ahead of it by up to ~1e-2;
   along its own branches each side's gradient is its rounding of the one
   float64 function (bands: the port's 5e-5, JAX's 5e-4), so the check
   holds the port's function to JAX's at any seed; beside them, each
   BatchNorm output's relative L2 against float64's (band 1e-5), which
   shows where in the forward each side's rounding stands;
5. the port's trainer in float64 from the same init (the exact
   trajectory, to the rounding of float64), and each fp32 side's
   per-epoch L1 deviation from it: how far fp32 rounding alone carries
   each trainer.

The bands are the JAX package's own against the reference
(``tests/test_lowlevel_trajectory_parity.py``): the first epoch's relative
L1 deviation < 1e-4, every epoch's < 1e-3, cross PSNR > 30 dB, the L1s to
the targets within 5e-3 of each other, relative. They are not met at
every seed (at the defaults the first epoch deviates 1.92e-4), and each
fp32 side drifts as far from the float64 trajectory: a ReLU or a gradient
at the rounding level takes either sign, and Adam turns a sign into a
step of the rate's size. The first-batch check above holds at any seed.

Needs JAX and the JAX package, so it does not run on the card host; the
port-side functions (:func:`make_data`, :func:`port_model`,
:func:`run_port`, :func:`predict_port`, :func:`prediction_agreement`,
:func:`state_failures`, and ``deviations`` from
``parity_torch_prior_trajectory.py``) import no JAX, and
``chip_smoke.py`` phase 19 runs them on the card against the card host's
CPU.

    python3 scripts/parity_torch_lowlevel_trajectory.py [--epochs 15]
        [--n 128 --batch 16] [--stages 32,16,8,8,8,8 --time-proj 8]
        [--seed 0]

At its defaults it trains the full-size ``EncoderLowLevel`` (143 M
parameters). ``tests/test_torch_lowlevel_trajectory.py`` runs narrow stages
through :func:`lowlevel_trajectory_parity_torch`.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from parity_torch_prior_trajectory import deviations  # noqa: E402

#: the published widths (``EncoderLowLevel``'s defaults)
FULL_STAGES, FULL_TIME_PROJ = (1024, 512, 256, 128, 64, 32), 128
#: the bands of the JAX package against the reference
FIRST_EPOCH_BAND, EPOCH_BAND, PSNR_BAND, L1_BAND = 1e-4, 1e-3, 30.0, 5e-3
#: the first gradients along their own branches against float64's
#: (relative L2): the port's and JAX's
GRAD_BANDS = {"port": 5e-5, "jax": 5e-4}
#: each side's BatchNorm outputs against float64's (relative L2)
FORWARD_BAND = 1e-5
#: the rank of the synthetic set's EEG → latent map
RANK = 64


def make_data(n, seed, n_channels=63, seq_len=250, latent=(4, 64, 64)):
    """(EEG (n, C, T), latents (n, 4, 64, 64) NCHW, the cached layout) with
    a learnable rank-64 linear map from one to the other plus 5% noise."""
    rng = np.random.default_rng(seed)
    eeg = (0.5 * rng.normal(size=(n, n_channels, seq_len))).astype(
        np.float32)
    a = rng.normal(size=(n_channels * seq_len, RANK)).astype(np.float32)
    b = rng.normal(size=(RANK, int(np.prod(latent)))).astype(np.float32)
    lat = ((eeg.reshape(n, -1) @ a) @ b
           / np.sqrt(n_channels * seq_len * RANK)).reshape(n, *latent)
    lat += 0.05 * rng.normal(size=lat.shape).astype(np.float32)
    return eeg, lat.astype(np.float32)


def prediction_agreement(got, want, target):
    """Cross PSNR of two predictions (the peak: ``want``'s range) and each
    one's L1 to ``target``; all NHWC numpy."""
    span = float(np.max(want) - np.min(want))
    mse = float(np.mean((got - want) ** 2))
    l1_got = float(np.mean(np.abs(got - target)))
    l1_want = float(np.mean(np.abs(want - target)))
    return {"psnr": 10.0 * np.log10(span ** 2 / max(mse, 1e-20)),
            "l1_got": l1_got, "l1_want": l1_want,
            "l1_rel": abs(l1_got - l1_want) / l1_want}


def failures(rel, agree, grads=None):
    """The bands over per-epoch deviations ``rel``, the predictors'
    agreement and (given) the first gradients along their branches."""
    bad = []
    for side, band in GRAD_BANDS.items() if grads is not None else ():
        g = grads[side]
        if not g["branched"] < band:
            bad.append(f"{side}'s first gradients along their branches "
                       f"{g['branched']:.3e} (band {band})")
        if not max(g["bn_error"]) < FORWARD_BAND:
            bad.append(f"{side}'s BatchNorm outputs {max(g['bn_error']):.3e}"
                       f" (band {FORWARD_BAND})")
    if not rel[0] < FIRST_EPOCH_BAND:
        bad.append(f"first epoch {rel[0]:.3e} (band {FIRST_EPOCH_BAND})")
    if not max(rel) < EPOCH_BAND:
        bad.append(f"epoch deviation {max(rel):.3e} (band {EPOCH_BAND})")
    if not agree["psnr"] > PSNR_BAND:
        bad.append(f"cross PSNR {agree['psnr']:.2f} dB (band {PSNR_BAND})")
    if not agree["l1_rel"] < L1_BAND:
        bad.append(f"L1 to target {agree['l1_rel']:.3e} (band {L1_BAND})")
    return bad


# ——— the port's side (no JAX) ———


def port_model(stages, time_proj):
    from eeg_image_decode_tpu_torch.models.lowlevel import EncoderLowLevel

    return EncoderLowLevel(stage_channels=tuple(stages),
                           time_proj_dim=time_proj)


def run_port(state_dict, eeg, lat, *, epochs, batch, lr, seed, stages,
             time_proj, device="cpu", dtype=None):
    """The port's trainer from ``state_dict`` (a ``state_dict`` of
    :func:`port_model`), its model in ``dtype`` (default fp32): (per-epoch
    L1, per-step L1 of the last epoch, the trainer)."""
    from eeg_image_decode_tpu_torch.core.config import LowLevelConfig
    from eeg_image_decode_tpu_torch.train.lowlevel import LowLevelTrainer

    trainer = LowLevelTrainer(LowLevelConfig(lr=lr, time_proj_dim=time_proj),
                              model=port_model(stages, time_proj),
                              device=device)
    n_steps = max(len(eeg) // batch, 1)
    trainer.init(total_steps=n_steps * epochs, steps_per_epoch=n_steps,
                 seed=seed)
    trainer.model.load_state_dict(state_dict, strict=True)
    if dtype is not None:
        trainer.model.to(dtype)
    hist = trainer.train(eeg, lat, epochs=epochs, batch_size=batch,
                         seed=seed, log_fn=None)
    return ([r["loss"] for r in hist],
            trainer.last_steps["step_loss"].cpu().numpy(), trainer)


def predict_port(trainer, eeg):
    """Predicted latents, NHWC numpy."""
    return trainer.predict(eeg).cpu().numpy()


#: the conv biases ahead of a train-mode BatchNorm: their exact gradient
#: is 0, so their relative error is not defined
_BN_CANCELS = ("up_", "proj_16")


def grad_error(got, want):
    """The largest relative L2 of ``got`` against ``want`` over the
    parameters, the conv biases ahead of a BatchNorm left out."""
    return max(float((got[k].double() - w).norm() / w.norm())
               for k, w in want.items()
               if not (k.endswith(".bias") and k.startswith(_BN_CANCELS)))


def branch_flips(got, want):
    """(ReLUs, L1 residual signs) on which two runs' branches differ."""
    return (sum(int((a != b).sum()) for a, b in zip(got["relu"],
                                                    want["relu"])),
            int((got["sign"] != want["sign"]).sum()))


def port_gradients(state_dict, x, y, stages, time_proj, dtype,
                   branches=None):
    """The port model's train-mode L1 gradients on one batch (CPU) by
    parameter name, and its branches: every BatchNorm output (NCHW, in
    order, float64), the side of its ReLU and the sign of every residual.
    Given ``branches``, the run takes those instead of its own:
    ReLU(z) = z·side, |r| = r·sign."""
    from unittest import mock

    import torch
    import torch.nn.functional as F

    from eeg_image_decode_tpu_torch.models import lowlevel

    model = port_model(stages, time_proj).to(dtype)
    model.load_state_dict({k: v.to(dtype) for k, v in state_dict.items()},
                          strict=True)
    taken, given = [], list(branches["relu"]) if branches else None
    plain = F.relu

    def relu(z):
        if given is not None:
            return z * given.pop(0).to(z.dtype)
        taken.append(z.detach().double())
        return plain(z)

    with mock.patch.object(lowlevel.F, "relu", relu):
        r = model(torch.from_numpy(x).to(dtype), train=True) \
            - torch.from_numpy(y).to(dtype)
    loss = (torch.mean(branches["sign"].to(dtype) * r) if branches
            else torch.mean(torch.abs(r)))
    loss.backward()
    return ({k: p.grad for k, p in model.named_parameters()},
            {"bn": taken, "relu": [z > 0 for z in taken],
             "sign": torch.sign(r.detach())})


def state_failures(state_dict, want):
    """(max |Δ| over the parameters, the largest relative Δ over
    BatchNorm's running statistics) of two port ``state_dict``s."""
    params, stats = [], []
    for k, w in want.items():
        d = (state_dict[k].detach().cpu().double() - w.double()).abs().max()
        if k.endswith((".mean", ".var")):
            stats.append(float(d) / max(float(w.abs().max()), 1e-12))
        else:
            params.append(float(d))
    return max(params), max(stats)


# ——— the JAX side ———


def jax_trainer(stages, time_proj, lr, n_steps, epochs, seed):
    """The JAX trainer at the per-epoch staircase, freshly ``init``ed."""
    from eeg_image_decode_tpu.core.config import LowLevelConfig
    from eeg_image_decode_tpu.models.lowlevel import EncoderLowLevel
    from eeg_image_decode_tpu.train.lowlevel import LowLevelTrainer

    trainer = LowLevelTrainer(
        LowLevelConfig(lr=lr, time_proj_dim=time_proj),
        model=EncoderLowLevel(stage_channels=tuple(stages),
                              time_proj_dim=time_proj))
    trainer.init(total_steps=n_steps * epochs, seed=seed,
                 steps_per_epoch=n_steps)
    return trainer


def jax_variables(trainer):
    import jax

    return jax.tree_util.tree_map(np.asarray, {
        "params": trainer.state.params,
        "batch_stats": trainer.state.batch_stats})


def jax_gradients(trainer, variables, x, y, n_stages):
    """JAX's train-mode L1 gradients on one batch (one jitted step) as the
    port's ``state_dict`` names, and the branches that step took."""
    import jax
    import jax.numpy as jnp
    import torch

    from eeg_image_decode_tpu_torch.utils.convert import params_from_flax

    target = jnp.asarray(np.moveaxis(y, 1, -1))

    def loss(params):
        pred, out = trainer.model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), deterministic=False,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda m, _: (m.name or "").startswith(
                "bn_"))
        return jnp.mean(jnp.abs(pred - target)), (out["intermediates"], pred)

    g, (inter, pred) = jax.jit(jax.grad(loss, has_aux=True))(
        variables["params"])

    def nchw(a):
        return torch.from_numpy(np.moveaxis(np.asarray(a), -1, 1).copy())

    bn = [nchw(inter[k]["__call__"][0]).double()
          for k in [f"bn_{i}" for i in range(n_stages)] + ["bn_proj"]]
    sd = params_from_flax({"params": jax.tree_util.tree_map(np.asarray, g),
                           "batch_stats": variables["batch_stats"]})
    return ({k: v for k, v in sd.items() if not k.endswith((".mean", ".var"))},
            {"bn": bn, "relu": [z > 0 for z in bn],
             "sign": torch.sign(nchw(pred).double()
                                - torch.from_numpy(y).double())})


def first_gradients(trainer, init, eeg, lat, batch, seed, stages,
                    time_proj):
    """The first batch's gradients (the first epoch's permutation) of the
    port (fp32) and of JAX (fp32) from JAX's init, against the port's model
    in float64: per side ``free`` (as they are), ``branched`` (against the
    float64 run along that side's own branches), the ReLUs and residual
    signs on which its branches differ from float64's, and ``bn_error``,
    each BatchNorm output's relative L2 against float64's, in order."""
    import torch

    idx = np.random.default_rng(seed * 7907).permutation(len(eeg))[:batch]
    x, y = eeg[idx], lat[idx]
    runs = {"port": port_gradients(init, x, y, stages, time_proj,
                                   torch.float32),
            "jax": jax_gradients(trainer, jax_variables(trainer), x, y,
                                 len(stages))}
    exact, exact_branches = port_gradients(init, x, y, stages, time_proj,
                                           torch.float64)
    out = {}
    for side, (g, branches) in runs.items():
        relu, sign = branch_flips(branches, exact_branches)
        out[side] = {"free": grad_error(g, exact), "relu_flips": relu,
                     "sign_flips": sign, "bn_error": [
                         float((a - b).norm() / b.norm()) for a, b in zip(
                             branches["bn"], exact_branches["bn"])]}
    del exact
    for side, (g, branches) in runs.items():
        along = port_gradients(init, x, y, stages, time_proj, torch.float64,
                               branches)[0]
        out[side]["branched"] = grad_error(g, along)
    return out


def lowlevel_trajectory_parity_torch(n=128, batch=16, epochs=15, lr=1e-3,
                                     seed=0, *, stages=FULL_STAGES,
                                     time_proj=FULL_TIME_PROJ, log=print):
    """The comparison; returns a dict of curves, deviations, the
    predictors' agreement, the first gradients and both sides' deviation
    from the port's float64 trajectory. Shared by the script and
    ``tests/test_torch_lowlevel_trajectory.py``."""
    import jax.numpy as jnp
    import torch

    from eeg_image_decode_tpu_torch.utils.convert import params_from_flax

    eeg, lat = make_data(n, seed)
    n_steps = max(n // batch, 1)
    jt = jax_trainer(stages, time_proj, lr, n_steps, epochs, seed)
    init = params_from_flax(jax_variables(jt))
    grads = first_gradients(jt, init, eeg, lat, batch, seed, stages,
                            time_proj)
    t0 = time.perf_counter()
    j_hist = jt.train(eeg, lat, epochs=epochs, batch_size=batch, seed=seed,
                      log_fn=None)
    jax_s = time.perf_counter() - t0
    j_losses = [r["loss"] for r in j_hist]
    log(f"jax: {epochs} epochs in {jax_s:.1f} s, final L1 "
        f"{j_losses[-1]:.6f}")
    kw = dict(epochs=epochs, batch=batch, lr=lr, seed=seed, stages=stages,
              time_proj=time_proj)
    t0 = time.perf_counter()
    p_losses, _, pt = run_port(init, eeg, lat, **kw)
    port_s = time.perf_counter() - t0
    log(f"port: {epochs} epochs in {port_s:.1f} s, final L1 "
        f"{p_losses[-1]:.6f}")
    param_diff, stat_diff = state_failures(
        pt.model.state_dict(), params_from_flax(jax_variables(jt)))
    eval_eeg, eval_lat = make_data(32, seed + 99)
    target = np.moveaxis(eval_lat, 1, -1)
    agree = prediction_agreement(
        predict_port(pt, eval_eeg),
        np.asarray(jt.predict(jnp.asarray(eval_eeg))), target)
    res = {"n": n, "batch": batch, "epochs": epochs, "seed": seed,
           "steps_per_epoch": n_steps, "stages": list(stages),
           "time_proj": time_proj,
           "params": sum(p.numel() for p in pt.model.parameters()),
           "jax_losses": j_losses, "port_losses": p_losses,
           "rel_loss_dev": deviations(p_losses, j_losses),
           "max_param_diff": param_diff, "max_stat_rel_diff": stat_diff,
           "agreement": agree, "first_gradients": grads,
           "jax_time_s": jax_s, "port_time_s": port_s}
    del pt, jt
    t0 = time.perf_counter()
    exact = run_port(init, eeg, lat, dtype=torch.float64, **kw)[0]
    log(f"port in float64: {epochs} epochs in "
        f"{time.perf_counter() - t0:.1f} s, final L1 {exact[-1]:.6f}")
    res.update(float64_losses=exact,
               port_from_float64=deviations(p_losses, exact),
               jax_from_float64=deviations(j_losses, exact))
    return res


def print_report(res):
    print(f"\n### Port low-level trainer against JAX's ({res['epochs']} "
          f"epochs × {res['steps_per_epoch']} steps, B {res['batch']}, "
          f"stages {res['stages']}, time_proj {res['time_proj']}, "
          f"{res['params']:,} parameters, seed {res['seed']}, fp32 CPU)\n")
    print("| epoch | jax L1 | port L1 | rel dev | port from float64 | jax "
          "from float64 |")
    print("|---|---|---|---|---|---|")
    for e, row in enumerate(zip(res["jax_losses"], res["port_losses"],
                                res["rel_loss_dev"], res["port_from_float64"],
                                res["jax_from_float64"])):
        print(f"| {e} | {row[0]:.6f} | {row[1]:.6f} | "
              + " | ".join(f"{v:.2e}" for v in row[2:]) + " |")
    a = res["agreement"]
    print(f"\nmax relative L1 deviation: {max(res['rel_loss_dev']):.2e}; "
          f"from the float64 trajectory: port "
          f"{max(res['port_from_float64']):.2e}, jax "
          f"{max(res['jax_from_float64']):.2e}")
    print(f"final-parameter max |Δ|: {res['max_param_diff']:.2e}; BatchNorm "
          f"running statistics, largest relative Δ: "
          f"{res['max_stat_rel_diff']:.2e}")
    print(f"held-out predictions: cross PSNR {a['psnr']:.2f} dB; L1 to "
          f"target port {a['l1_got']:.6f}, jax {a['l1_want']:.6f} (relative "
          f"{a['l1_rel']:.2e})")
    print("first batch against float64 (relative L2: the gradients' "
          "largest, as they are and along their own branches; branches "
          "apart from float64's: ReLUs, residual signs; each BatchNorm "
          "output):")
    for side, g in res["first_gradients"].items():
        print(f"  {side}: {g['free']:.2e}, {g['branched']:.2e} (band "
              f"{GRAD_BANDS[side]}); {g['relu_flips']}, {g['sign_flips']}; "
              + " ".join(f"{v:.1e}" for v in g["bn_error"]))
    print(f"seconds: jax {res['jax_time_s']:.1f}, port "
          f"{res['port_time_s']:.1f}")


def main(argv=None):
    import jax

    jax.config.update("jax_platforms", "cpu")

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stages", default=",".join(map(str, FULL_STAGES)),
                    help="the upsampler's channels (default: the published "
                         "widths)")
    ap.add_argument("--time-proj", type=int, default=FULL_TIME_PROJ)
    args = ap.parse_args(argv)

    res = lowlevel_trajectory_parity_torch(
        n=args.n, batch=args.batch, epochs=args.epochs, lr=args.lr,
        seed=args.seed, stages=tuple(int(s) for s in args.stages.split(",")),
        time_proj=args.time_proj)
    print_report(res)
    bad = failures(res["rel_loss_dev"], res["agreement"],
                   res["first_gradients"])
    print("\nlow-level trajectory parity " + ("PASS" if not bad
                                              else f"FAIL: {bad}"))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
