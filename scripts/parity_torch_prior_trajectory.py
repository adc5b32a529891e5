"""Multi-epoch training trajectory of the port's diffusion prior against the
JAX package's, on the CPU.

The port's counterpart of ``scripts/parity_prior_trajectory.py``: there the
JAX ``PriorPipe`` is held against the reference's own ``Pipe.train``; here
the port's ``train/prior.py::PriorPipe`` is held against the JAX one. Both
start from one initialisation (the JAX pipe's ``init``, carried into the
port strictly by ``utils/convert.py::params_from_flax``) and read one set of
pre-drawn inputs, made with numpy from ``--seed``:

- the batch order of every epoch;
- ε and t of every row of every step;
- the per-batch cond-keep flags (the condition dropped with p = 0.1).

Each side takes them through its ``train_epoch_injected``. Both run the JAX
trainer's schedule (Adam in optax's arithmetic, the global norm clipped to
1.0, the rate read at count + 1): a linear warmup over the published share
of the run (500 of 9,600 steps), then a cosine to 0 over the rest, so the
run leaves the warmup early and spends most of its steps in the cosine.

Deterministic mode reports:

1. the per-epoch ε-MSE of each side and their relative deviation;
2. the final parameters' max |Δ| (the port's ``state_dict`` against
   ``params_from_flax`` of JAX's state) and the count of steps whose
   gradient the clip scaled;
3. the CFG samples of the two *trained* pipes, each with its own weights,
   under one shared ``init_noise`` / ``step_noises`` at guidance 5.0 and 0
   (the port's ``PriorPipe.generate`` against JAX's ``make_cfg_sampler``);
   beside them the same samplers on JAX's trained weights alone, which
   leaves the parameter drift out.

The bands are the JAX package's own against the reference
(``docs/PARITY.md``): relative ε-MSE < 1e-4 through epoch 30 and < 5e-4 to
the end; samples within 1e-3 of their scale. The parameter Δ gets none:
Adam's scale-free steps turn rounding-level gradient differences into
steps of the rate's size.

``--stochastic N`` trains N seeds a side, each through its own ``train()``
and its own random draws (JAX keys on one side, the port's
``torch.Generator`` on the other; the bits differ by construction). It
holds the port's mean last-epoch ε-MSE to the JAX seeds' band (their
extremes widened by two sd), the port's share of batches whose condition
was dropped to within 3 binomial SE of 0.1, and its t's spread over
``[0, num_train_timesteps)`` to a χ² over 10 bins at p > 1e-3. Two port
runs that must fall outside the loss band check that it can tell: the
condition never dropped (``cond_dropout_prob=0``), and t cut to the first
half of its range.

Needs JAX and the JAX package, so it does not run on the card host; the
port-side functions (:func:`make_data`, :func:`draw_shared`,
:func:`full_widths`, :func:`port_init`, :func:`run_port_injected`,
:func:`port_samples` and the band checks) import no JAX, and
``chip_smoke.py`` phase 19 runs them on the card against the card host's
CPU.

    python3 scripts/parity_torch_prior_trajectory.py [--full-width]
        [--epochs 50] [--stochastic 10]

``tests/test_torch_prior_trajectory.py`` runs a shortened configuration
through :func:`prior_trajectory_parity_torch`, and the rate checks
(:func:`draw_rates`) on the port's own draws without the band, which
needs the script's 10 seeds a side.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the JAX script's narrow widths (``scripts/parity_prior_trajectory.py``)
NARROW = dict(embed_dim=64, cond_dim=48, hidden_dims=(64, 48, 32),
              time_embed_dim=32)
#: the published run: 500 warmup steps of 9,600 (150 epochs × 64 steps)
WARMUP_SHARE = 500 / 9600
#: the bands of the JAX package against the reference (docs/PARITY.md)
LOSS_BAND_EARLY, EARLY_EPOCHS, LOSS_BAND = 1e-4, 30, 5e-4
SAMPLE_BAND = 1e-3
#: shared-trajectory sampling: rows, steps, guidance scales
SAMPLE_ROWS, SAMPLE_STEPS, SCALES = 8, 10, (5.0, 0.0)


def make_data(n, embed_dim, cond_dim, seed):
    """Correlated (EEG feature, CLIP image embedding) pairs: unit-norm h,
    c a noisy linear view of h, so the ε-MSE objective has signal to
    descend (the JAX script's draws)."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, embed_dim)).astype(np.float32)
    h /= np.linalg.norm(h, axis=1, keepdims=True)
    mix = rng.normal(size=(embed_dim, cond_dim)).astype(np.float32)
    c = h @ mix / np.sqrt(embed_dim)
    c += 0.1 * rng.normal(size=c.shape).astype(np.float32)
    return c.astype(np.float32), h


def full_widths() -> dict:
    """``PriorConfig()``'s architecture fields: embed and cond 1024, hidden
    (1024, 512, 256, 128, 64), time 512."""
    from eeg_image_decode_tpu_torch.core.config import PriorConfig

    return {k: getattr(PriorConfig(), k) for k in NARROW}


def warmup_steps(total_steps: int) -> int:
    """The published warmup share of a run of ``total_steps``."""
    return max(1, round(total_steps * WARMUP_SHARE))


def prior_config(widths: dict, total_steps: int, seed: int = 0, **kw):
    """The port's ``PriorConfig`` at ``widths`` with the run's warmup."""
    from eeg_image_decode_tpu_torch.core.config import PriorConfig

    return PriorConfig(**widths, warmup_steps=warmup_steps(total_steps),
                       seed=seed, **kw)


def draw_shared(n, batch, epochs, embed_dim, num_train_timesteps,
                cond_dropout_prob, seed):
    """Every stochastic input of the run: ``perms`` (epochs, steps, B),
    ``keep`` (epochs, steps), ``noises`` (epochs, steps, B, D), ``tsteps``
    (epochs, steps, B)."""
    rng = np.random.default_rng(seed + 1)
    n_steps = n // batch
    perms = np.stack([rng.permutation(n)[: n_steps * batch].reshape(
        n_steps, batch) for _ in range(epochs)]).astype(np.int64)
    keep = (rng.uniform(size=(epochs, n_steps))
            >= cond_dropout_prob).astype(np.float32)
    noises = rng.normal(size=(epochs, n_steps, batch, embed_dim)).astype(
        np.float32)
    tsteps = rng.integers(0, num_train_timesteps,
                          size=(epochs, n_steps, batch)).astype(np.int64)
    return {"perms": perms, "keep": keep, "noises": noises,
            "tsteps": tsteps}


def sample_noise(rows, embed_dim, steps, seed):
    """(init_noise (rows, D), step_noises (steps, rows, D)), shared by the
    samplers."""
    rng = np.random.default_rng(seed + 2)
    return (rng.normal(size=(rows, embed_dim)).astype(np.float32),
            rng.normal(size=(steps, rows, embed_dim)).astype(np.float32))


# ——— the port's side (no JAX) ———


def port_init(cfg, seed):
    """The port's own initialisation (flax's defaults from ``seed``) as a
    ``state_dict`` on the CPU: the shared init where no JAX is at hand."""
    from eeg_image_decode_tpu_torch.train.prior import PriorPipe

    pipe = PriorPipe(cfg, device="cpu")
    pipe.init(total_steps=1, seed=seed)
    return {k: v.clone() for k, v in pipe.model.state_dict().items()}


def run_port_injected(state_dict, cfg, c, h, draws, device="cpu"):
    """The port's pipe from ``state_dict`` over the injected epochs:
    {"losses" (per epoch), "clip_steps", "norm_max", "step_ms" (CUDA
    events, on a card), "pipe"}."""
    from eeg_image_decode_tpu_torch.train.prior import PriorPipe

    perms = draws["perms"]
    epochs, n_steps = perms.shape[:2]
    pipe = PriorPipe(cfg, device=device)
    pipe.init(total_steps=epochs * n_steps)
    pipe.model.load_state_dict(state_dict, strict=True)
    losses, clip, norm_max, step_ms = [], 0, 0.0, []
    for e in range(epochs):
        step = pipe.train_epoch_injected(c, h, perms[e], draws["noises"][e],
                                         draws["tsteps"][e],
                                         draws["keep"][e])
        losses.append(float(np.mean(step)))
        norms = pipe.last_steps["grad_norm"].cpu().numpy()
        clip += int((norms >= cfg.grad_clip_norm).sum())
        norm_max = max(norm_max, float(norms.max()))
        step_ms += pipe.last_steps["step_ms"] or []
    return {"losses": losses, "clip_steps": clip, "norm_max": norm_max,
            "step_ms": step_ms, "pipe": pipe}


def port_samples(pipe, cond, noise, scales=SCALES, steps=SAMPLE_STEPS):
    """The port pipe's CFG samples of ``cond`` under the shared ``noise``,
    by guidance scale, as numpy."""
    import torch

    init, step_noises = noise
    return {s: pipe.generate(
        cond, num_inference_steps=steps, guidance_scale=s,
        init_noise=torch.from_numpy(init),
        step_noises=torch.from_numpy(step_noises)).cpu().numpy()
        for s in scales}


def deviations(got, want):
    """Per-epoch relative deviation of the loss curve ``got`` from
    ``want``."""
    return [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got, want)]


def loss_failures(rel):
    """The ε-MSE bands over the per-epoch relative deviations ``rel``."""
    bad = []
    early = rel[:EARLY_EPOCHS]
    if max(early) >= LOSS_BAND_EARLY:
        bad.append(f"relative ε-MSE {max(early):.3e} through epoch "
                   f"{len(early) - 1} (band {LOSS_BAND_EARLY})")
    if max(rel) >= LOSS_BAND:
        bad.append(f"relative ε-MSE {max(rel):.3e} (band {LOSS_BAND})")
    return bad


def sample_failures(samples):
    """``samples``: {name: {"max_abs": Δ, "scale": s}}; the band is
    relative to max(s, 1)."""
    return [f"samples {k}: {v['max_abs']:.3e} on scale {v['scale']:.3f}"
            for k, v in samples.items()
            if not v["max_abs"] < SAMPLE_BAND * max(v["scale"], 1.0)]


def compare_samples(got, want):
    return {f"g{s}": {"max_abs": float(np.max(np.abs(got[s] - want[s]))),
                      "scale": float(np.max(np.abs(want[s])))}
            for s in want}


def max_param_diff(state_dict, want):
    """Max |Δ| over the parameters of two ``state_dict``s."""
    return max(float((state_dict[k].detach().cpu() - v).abs().max())
               for k, v in want.items())


# ——— the JAX side ———


def jax_init(widths, seed):
    """The JAX pipe's initial params at ``widths`` (numpy tree)."""
    import jax

    from eeg_image_decode_tpu.core.config import PriorConfig
    from eeg_image_decode_tpu.train.prior import PriorPipe

    pipe = PriorPipe(PriorConfig(**widths))
    pipe.init(total_steps=1, seed=seed)
    return jax.tree_util.tree_map(np.asarray, pipe.state.params)


def jax_pipe(params, cfg, total_steps):
    """A JAX pipe at the port config ``cfg`` holding ``params``."""
    import jax
    import jax.numpy as jnp

    from eeg_image_decode_tpu.core.config import PriorConfig
    from eeg_image_decode_tpu.train.prior import PriorPipe

    pipe = PriorPipe(PriorConfig(**dataclasses.asdict(cfg)))
    pipe.init(total_steps=total_steps)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    pipe.state = pipe.state.replace(params=p, opt_state=pipe.tx.init(p))
    return pipe


def run_jax_injected(params, cfg, c, h, draws):
    perms = draws["perms"]
    epochs, n_steps = perms.shape[:2]
    pipe = jax_pipe(params, cfg, epochs * n_steps)
    losses = []
    for e in range(epochs):
        step = pipe.train_epoch_injected(c, h, perms[e], draws["noises"][e],
                                         draws["tsteps"][e],
                                         draws["keep"][e])
        losses.append(float(np.mean(step)))
    return losses, pipe


def jax_samples(pipe, params, cond, noise, scales=SCALES,
                steps=SAMPLE_STEPS):
    """JAX's ``make_cfg_sampler`` on ``params`` under the shared noise."""
    import jax
    import jax.numpy as jnp

    from eeg_image_decode_tpu.ops.ddpm import make_cfg_sampler

    def denoise(x, t, c, m):
        return pipe.model.apply({"params": params}, x, t, c, m,
                                deterministic=True)

    init, step_noises = noise
    out = {}
    for s in scales:
        sampler = make_cfg_sampler(denoise, pipe.schedule,
                                   num_inference_steps=steps,
                                   guidance_scale=s)
        out[s] = np.asarray(sampler(
            jax.random.key(0), jnp.asarray(cond), init.shape,
            jnp.asarray(init), jnp.asarray(step_noises)))
    return out


# ——— the seeded band ———


def port_train(state_dict, cfg, c, h, epochs, batch, *, t_half=False):
    """The port's ``train()`` from ``state_dict`` with its own draws:
    (last-epoch ε-MSE, the cond-keep flag of every batch, every t). With
    ``t_half`` each batch's t is halved before the loss (a control)."""
    import torch

    from eeg_image_decode_tpu_torch.train.prior import PriorPipe

    pipe = PriorPipe(cfg, device="cpu")
    pipe.init(total_steps=(len(c) // batch) * epochs)
    pipe.model.load_state_dict(state_dict, strict=True)
    keep, ts = [], []
    loss_fn = pipe._loss

    def spy(h_, c_, t, noise, cond_mask, **kw):
        if t_half:
            t = torch.div(t, 2, rounding_mode="floor")
        keep.append(float(cond_mask[0]))
        ts.append(t.cpu().numpy())
        return loss_fn(h_, c_, t, noise, cond_mask, **kw)

    pipe._loss = spy
    hist = pipe.train(c, h, epochs=epochs, batch_size=batch, log_fn=None)
    return hist[-1]["loss"], np.asarray(keep), np.concatenate(ts)


def jax_train(params, cfg, c, h, epochs, batch):
    """The JAX pipe's ``train()`` from ``params`` with its own keys: the
    last epoch's ε-MSE."""
    pipe = jax_pipe(params, cfg, (len(c) // batch) * epochs)
    return pipe.train(c, h, epochs=epochs, batch_size=batch,
                      log_fn=None)[-1]["loss"]


def stochastic_band(params, state_dict, cfg, c, h, epochs, batch, n_seeds,
                    log=print):
    """N seeds a side (``cfg.seed`` = 0 … N−1: the same batch orders on
    both sides, each side's own draws), the port's rates of its draws, and
    the two controls."""
    j_loss, p_loss, keep, ts = [], [], [], []
    for s in range(n_seeds):
        cfg_s = dataclasses.replace(cfg, seed=s)
        j_loss.append(jax_train(params, cfg_s, c, h, epochs, batch))
        pl, k, t = port_train(state_dict, cfg_s, c, h, epochs, batch)
        p_loss.append(pl)
        keep.append(k)
        ts.append(t)
        log(f"seed {s}: last-epoch ε-MSE jax {j_loss[-1]:.6f}, port "
            f"{pl:.6f}")
    sd = float(np.std(j_loss))
    band = (min(j_loss) - 2 * sd, max(j_loss) + 2 * sd)
    mean_p = float(np.mean(p_loss))
    controls = {}
    for name, kw in (("cond_dropout_prob=0", {"cond": 0.0}),
                     ("t in the first half", {"t_half": True})):
        cfg_c = dataclasses.replace(cfg, cond_dropout_prob=kw.get(
            "cond", cfg.cond_dropout_prob))
        loss = port_train(state_dict, cfg_c, c, h, epochs, batch,
                          t_half=kw.get("t_half", False))[0]
        controls[name] = {"loss": loss,
                          "outside": not band[0] <= loss <= band[1]}
        log(f"control ({name}): last-epoch ε-MSE {loss:.6f} "
            f"{'outside' if controls[name]['outside'] else 'INSIDE'}")
    return {"jax_loss": j_loss, "port_loss": p_loss, "band": band,
            "port_mean": mean_p, "inside": band[0] <= mean_p <= band[1],
            "controls": controls, "epochs": epochs,
            **draw_rates(keep, ts, cfg)}


def draw_rates(keep, ts, cfg):
    """The port's own draws against their laws: the share of batches whose
    condition was dropped within 3 binomial SE of ``cond_dropout_prob``,
    and t over ``[0, num_train_timesteps)`` by a χ² over 10 bins at
    p > 1e-3. ``keep``, ``ts``: per-seed lists of :func:`port_train`'s."""
    from scipy import stats

    keep, ts = np.concatenate(keep), np.concatenate(ts)
    p = cfg.cond_dropout_prob
    drop_share = float(1.0 - keep.mean())
    drop_se = float(np.sqrt(p * (1 - p) / len(keep)))
    counts = np.histogram(ts, bins=10, range=(0, cfg.num_train_timesteps))[0]
    chi2 = stats.chisquare(counts)
    return {"batches": len(keep), "drop_share": drop_share,
            "drop_se": drop_se,
            "drop_ok": abs(drop_share - p) <= 3 * drop_se,
            "t_counts": counts.tolist(), "t_chi2": float(chi2.statistic),
            "t_p": float(chi2.pvalue), "t_ok": float(chi2.pvalue) > 1e-3,
            "t_range": [int(ts.min()), int(ts.max())]}


# ——— the comparison ———


def prior_trajectory_parity_torch(n=512, batch=64, epochs=50, seed=0, *,
                                  widths=None, deterministic=True,
                                  stochastic=0, stochastic_epochs=None,
                                  log=print):
    """The comparison; returns a dict of curves, deviations, samples and
    (``stochastic`` > 0) the seeded band. ``widths``: ``PriorConfig``'s
    architecture fields (default: the JAX script's narrow ones). Shared by
    the script and ``tests/test_torch_prior_trajectory.py``."""
    from eeg_image_decode_tpu_torch.utils.convert import params_from_flax

    widths = dict(widths or NARROW)
    n_steps = n // batch
    total = n_steps * epochs
    cfg = prior_config(widths, total)
    c, h = make_data(n, cfg.embed_dim, cfg.cond_dim, seed)
    params = jax_init(widths, seed)
    state_dict = params_from_flax({"params": params})
    res = {"n": n, "batch": batch, "epochs": epochs, "total_steps": total,
           "warmup_steps": cfg.warmup_steps, "widths": widths}

    if deterministic:
        draws = draw_shared(n, batch, epochs, cfg.embed_dim,
                            cfg.num_train_timesteps, cfg.cond_dropout_prob,
                            seed)
        t0 = time.perf_counter()
        j_losses, jp = run_jax_injected(params, cfg, c, h, draws)
        res["jax_time_s"] = time.perf_counter() - t0
        log(f"jax: {epochs} epochs in {res['jax_time_s']:.1f} s, final "
            f"ε-MSE {j_losses[-1]:.6f}")
        t0 = time.perf_counter()
        port = run_port_injected(state_dict, cfg, c, h, draws)
        res["port_time_s"] = time.perf_counter() - t0
        log(f"port: {epochs} epochs in {res['port_time_s']:.1f} s, final "
            f"ε-MSE {port['losses'][-1]:.6f}")
        import jax

        j_sd = params_from_flax({"params": jax.tree_util.tree_map(
            np.asarray, jp.state.params)})
        pp = port["pipe"]
        cond = c[:SAMPLE_ROWS]
        noise = sample_noise(SAMPLE_ROWS, cfg.embed_dim, SAMPLE_STEPS, seed)
        want = jax_samples(jp, jp.state.params, cond, noise)
        res["max_param_diff"] = max_param_diff(pp.model.state_dict(), j_sd)
        res["samples_trained"] = compare_samples(
            port_samples(pp, cond, noise), want)
        # the same samplers on JAX's trained weights: the drift left out
        pp.model.load_state_dict(j_sd, strict=True)
        res["samples_shared_weights"] = compare_samples(
            port_samples(pp, cond, noise), want)
        res.update({
            "jax_losses": j_losses, "port_losses": port["losses"],
            "rel_loss_dev": deviations(port["losses"], j_losses),
            "clip_steps": port["clip_steps"], "norm_max": port["norm_max"],
            "steps_per_epoch": n_steps,
            "drop_share": float(1.0 - draws["keep"].mean()),
        })

    if stochastic:
        n_ep = stochastic_epochs or epochs
        t0 = time.perf_counter()
        res["stochastic"] = stochastic_band(
            params, state_dict, prior_config(widths, n_steps * n_ep), c, h,
            n_ep, batch, stochastic, log=log)
        res["stochastic"]["time_s"] = time.perf_counter() - t0
    return res


def failures(res):
    """Every band the result misses (deterministic part)."""
    return (loss_failures(res["rel_loss_dev"])
            + sample_failures(res["samples_trained"])
            + sample_failures(res["samples_shared_weights"]))


def stochastic_failures(st):
    bad = [name for name, ok in (
        ("port mean outside the JAX seeds' loss band", st["inside"]),
        ("dropped-condition share", st["drop_ok"]),
        ("t coverage", st["t_ok"])) if not ok]
    if not any(v["outside"] for v in st["controls"].values()):
        bad.append("no control falls outside the loss band")
    return bad


def print_report(res):
    print(f"\n### Port prior against JAX's ({res['epochs']} epochs × "
          f"{res['steps_per_epoch']} steps, B {res['batch']}, warmup "
          f"{res['warmup_steps']} of {res['total_steps']} steps, widths "
          f"{res['widths']}, fp32 CPU)\n")
    print("| epoch | jax ε-MSE | port ε-MSE | rel dev |")
    print("|---|---|---|---|")
    ep = res["epochs"]
    for e in sorted({0, 1, 2, *range(4, ep, 5), ep - 1}):
        if e < ep:
            print(f"| {e} | {res['jax_losses'][e]:.6f} | "
                  f"{res['port_losses'][e]:.6f} | "
                  f"{res['rel_loss_dev'][e]:.2e} |")
    rel = res["rel_loss_dev"]
    print(f"\nmax relative ε-MSE deviation: through epoch "
          f"{min(EARLY_EPOCHS, ep) - 1} {max(rel[:EARLY_EPOCHS]):.2e}, all "
          f"{max(rel):.2e}")
    print(f"final-parameter max |Δ|: {res['max_param_diff']:.2e}")
    print(f"clipped steps (port): {res['clip_steps']} of "
          f"{res['total_steps']}, largest norm {res['norm_max']:.3f}; "
          f"dropped-condition batches {res['drop_share']:.3f}")
    for name in ("samples_trained", "samples_shared_weights"):
        print(f"CFG samples ({SAMPLE_ROWS} rows, {SAMPLE_STEPS} steps), "
              f"{name}: " + ", ".join(
                  f"{k} max |Δ| {v['max_abs']:.2e} on {v['scale']:.3f}"
                  for k, v in res[name].items()))
    print(f"seconds: jax {res['jax_time_s']:.1f}, port "
          f"{res['port_time_s']:.1f}")


def print_stochastic(st, n_seeds):
    print(f"\n### Seeded draws ({n_seeds} seeds a side, {st['epochs']} "
          "epochs, each side's own RNG)\n")
    print("| seed | jax last ε-MSE | port last ε-MSE |")
    print("|---|---|---|")
    for s, (a, b) in enumerate(zip(st["jax_loss"], st["port_loss"])):
        print(f"| {s} | {a:.6f} | {b:.6f} |")
    lo, hi = st["band"]
    print(f"\nJAX band [{lo:.6f}, {hi:.6f}]: port mean {st['port_mean']:.6f} "
          f"{'inside' if st['inside'] else 'OUTSIDE'}")
    for name, v in st["controls"].items():
        print(f"control ({name}): {v['loss']:.6f} "
              f"{'outside' if v['outside'] else 'inside'}")
    print(f"dropped-condition share {st['drop_share']:.4f} over "
          f"{st['batches']} batches (0.1 ± 3 × {st['drop_se']:.4f})")
    print(f"t over 10 bins: χ² {st['t_chi2']:.2f}, p {st['t_p']:.3g}, range "
          f"{st['t_range']}")
    print(f"seconds: {st['time_s']:.1f}")


def main(argv=None):
    import jax

    jax.config.update("jax_platforms", "cpu")

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full-width", action="store_true",
                    help="PriorConfig()'s widths (default: the JAX "
                         "script's narrow ones)")
    ap.add_argument("--stochastic", type=int, default=0, metavar="N",
                    help="also train N seeds a side, each with its own "
                         "draws, and hold the port to the JAX seeds' band")
    ap.add_argument("--no-deterministic", action="store_true",
                    help="only the seeded band")
    args = ap.parse_args(argv)

    widths = full_widths() if args.full_width else NARROW
    res = prior_trajectory_parity_torch(
        n=args.n, batch=args.batch, epochs=args.epochs, seed=args.seed,
        widths=widths, deterministic=not args.no_deterministic,
        stochastic=args.stochastic)
    bad = []
    if not args.no_deterministic:
        print_report(res)
        bad = failures(res)
    if args.stochastic:
        print_stochastic(res["stochastic"], args.stochastic)
        bad += stochastic_failures(res["stochastic"])
    print("\nprior trajectory parity " + ("PASS" if not bad
                                          else f"FAIL: {bad}"))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
