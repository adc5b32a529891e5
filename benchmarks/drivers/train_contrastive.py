"""Contrastive training of an EEG encoder (``train/contrastive.py``'s
``ContrastiveTrainer``), resident on the card or streamed from host RAM.

Set-up builds the split and the weights on the device from the seed, the
trainer, and drives it over the first three batches of epoch 0's
permutation through the window's own entry, ``train_epoch``: step 1 as
epoch 0, steps 2-3 as epoch 1 (``perm=`` those rows, or for a streamed mix
the trainer's loader narrowed to them): these are the steps the reference
follows, and they warm every shape of the window. One evaluation warms
the evaluation's shapes. The window then runs ``train_epoch`` then
``evaluate`` from epoch 2, epoch after epoch as ``fit`` does, until
``--seconds`` have passed at the end of an epoch. With ``--trace 1`` the
mix's ``trace_epoch`` and its evaluation are traced.

The check, after the window: the reference (float32, TF32 off) runs the
same three steps from the same weights, rows and dropout draws; the three
losses, each leaf's gradient norm at step 1 (the program's from its AdamW
first moment, m = (1 − β1)·g) and each leaf's change after step 3 are
compared (|‖p‖ − ‖r‖| over the larger of the reference leaf's norm and the
median leaf's), by the worst leaf and, for the gradient, by the median
leaf too (:func:`compare`). A leaf whose step-1 gradient in the reference
is under a thousandth of the median leaf's moves by round-off alone under
Adam, and is left out of the change.
"""

from __future__ import annotations

import contextlib
import math
import time
from itertools import islice

import numpy as np
import torch

from benchmarks.harness import eegdata, guard, weights
from benchmarks.harness.runner import Outcome
from benchmarks.harness.trace import Slice
from benchmarks.reference import atms
from benchmarks.reference.precision import fp8

#: steps of epoch 0's rows that the reference follows
CHECK_STEPS = 3
#: ``train_epoch`` calls of set-up: step 1 alone (as epoch 0), then steps
#: 2-3 (as epoch 1); the optimizer's state is read between
CHECK_CALLS = (1, 2)
#: a leaf with a reference gradient under this share of the median's
#: is left out of the change (it moves by round-off under Adam)
STILL_LEAF = 1e-3


def run_seed(seed: int) -> int:
    """The trainer's own 31-bit seed (batch order, dropout generators)."""
    return weights.derive_seed(seed, "trainer") % (2**31 - 1)


def epoch_rows(n: int, batch: int, seed: int, epoch: int) -> np.ndarray:
    """The (steps, B) batch rows of an epoch: ``default_rng(seed·100003 +
    epoch)``'s permutation, the order the trainer documents."""
    rng = np.random.default_rng(seed * 100003 + epoch)
    steps = n // batch
    return rng.permutation(n)[: steps * batch].reshape(steps, batch)


def _program(cell, split, seed, device, streamed):
    from eeg_image_decode_tpu_torch.core.config import (
        ATMSConfig,
        ContrastiveTrainConfig,
    )
    from eeg_image_decode_tpu_torch.data.things_eeg import EEGRetrievalData
    from eeg_image_decode_tpu_torch.models.atm_s import ATMS
    from eeg_image_decode_tpu_torch.models.registry import ContrastiveModel
    from eeg_image_decode_tpu_torch.train.contrastive import (
        ContrastiveTrainer,
    )

    cfg, mix = cell.config, cell.mix
    m, tr, d = cfg["model"], cfg["train"], cfg["data"]
    model = ContrastiveModel(ATMS(ATMSConfig(**m),
                                  dtype=getattr(torch, cfg["compute_dtype"])))
    model = model.to(device)
    state = model.state_dict()
    shapes = atms.param_shapes(m)
    weights.check_names(shapes, state, cell.config_entry["name"])
    weights.fill_([(n, state[n]) for n, _ in shapes], seed, "encoder")

    def split_of(prefix, host):
        def a(k):
            t = split[prefix + k]
            return t.cpu() if host else t
        n_cls = d["n_classes"] if not prefix else d["n_test_classes"]
        return EEGRetrievalData(
            eeg=a("eeg"), labels=a("labels"), subject_ids=a("subject_ids"),
            img_idx=a("img_idx"), text_idx=a("text_idx"),
            img_features=a("img_features"), text_features=a("text_features"),
            n_classes=n_cls,
            images_per_class=d["images_per_class"] if not prefix else 1)

    tcfg = ContrastiveTrainConfig(
        batch_size=tr["batch_size"], lr=tr["lr"],
        weight_decay=tr["weight_decay"], alpha=tr["alpha"],
        seed=run_seed(seed), eval_ks=tuple(tr["eval_ks"]),
        host_dtype=mix.get("host_dtype"))
    trainer = ContrastiveTrainer(model, tcfg, split_of("", streamed),
                                 split_of("test_", False), device=device,
                                 streaming=streamed)
    return trainer


def _leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tensors.items()}


class _Batches:
    """The trainer's streaming loader narrowed to batches [lo, hi) of its
    epoch 0, whatever epoch is asked for: the loader's own gather and copy,
    a shorter epoch."""

    def __init__(self, loader, lo: int, hi: int):
        self.loader, self.lo, self.hi = loader, lo, hi

    def __len__(self) -> int:
        return self.hi - self.lo

    def epoch(self, epoch: int):
        it = self.loader.epoch(0)
        try:
            yield from islice(it, self.lo, self.hi)
        finally:
            it.close()


def _check_steps(trainer, streamed: bool) -> dict:
    """The first CHECK_STEPS batches of epoch 0 through the window's own
    entry, ``train_epoch``: CHECK_CALLS[i] steps as epoch i (its dropout
    generator), rows of epoch 0's permutation (``perm``, or the loader
    narrowed to them); returns the losses, the step-1 gradient norms and
    the parameters after them."""
    state = trainer.state
    named = dict(trainer.model.named_parameters())
    losses, g1 = [], None
    rows = trainer.epoch_perm(0)
    loader = trainer.loader
    lo = 0
    try:
        for epoch, n in enumerate(CHECK_CALLS):
            if streamed:
                trainer.loader = _Batches(loader, lo, lo + n)
                trainer.train_epoch(epoch)
            else:
                trainer.train_epoch(epoch, perm=rows[lo:lo + n])
            losses += trainer.last_steps["step_loss"]
            lo += n
            if g1 is None:
                b1 = state.optimizer.defaults["betas"][0]
                st = state.optimizer.state
                # a leaf the optimizer holds no moment of has taken no step
                g1 = _leaf_norms({k: st.get(p, {}).get(
                    "exp_avg", torch.zeros_like(p)) / (1 - b1)
                    for k, p in named.items()})
    finally:
        trainer.loader = loader
    theta = {k: p.detach().clone() for k, p in named.items()}
    return {"losses": losses, "g1": g1, "theta": theta}


def reference_steps(cell, split, seed: int, device, *,
                    control: bool = False, half_batch: bool = False) -> dict:
    """The reference's CHECK_STEPS steps from the seed's weights over the
    rows of epoch 0, with the program's dropout draws (a generator for
    each of the program's CHECK_CALLS, seeded as its epoch's); ``control``: its
    products in fp8; ``half_batch`` (a planted fault): the loss over the
    batch's first half only."""
    cfg = cell.config
    m, tr = cfg["model"], cfg["train"]
    shapes = atms.param_shapes(m)
    prm = {n: torch.empty(s, device=device) for n, s in shapes}
    weights.fill_(list(prm.items()), seed, "encoder")
    theta0 = {k: v.clone() for k, v in prm.items()}
    leaves = {k: v.requires_grad_() for k, v in prm.items()
              if not atms.is_statistic(k)}
    opt = atms.AdamW(leaves, tr["lr"], tr["weight_decay"])
    tseed = run_seed(seed)
    rows = epoch_rows(split["eeg"].shape[0], tr["batch_size"], tseed, 0)
    # the program's call i is epoch i, with a generator of its own
    starts = {int(s): i for i, s in
              enumerate(np.cumsum((0,) + CHECK_CALLS[:-1]))}
    losses, g1 = [], None
    for s in range(CHECK_STEPS):
        if s in starts:
            gen = torch.Generator(device=device).manual_seed(
                tseed + 7919 * starts[s])
        idx = torch.as_tensor(rows[s])

        def take(k):
            t = split[k]
            return t[idx.to(t.device)].to(device)

        x, sids = take("eeg"), take("subject_ids")
        img = split["img_features"][take("img_idx").long()]
        text = split["text_features"][take("text_idx").long()]
        with fp8() if control else contextlib.nullcontext():
            feats, scale = atms.forward(prm, m, x, sids, train=True, gen=gen)
            keep = slice(0, feats.shape[0] // 2 if half_batch else None)
            loss = atms.retrieval_loss(feats[keep], img[keep], text[keep],
                                       scale, tr["alpha"])
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        if g1 is None:
            g1 = _leaf_norms(grads)
        opt.step(leaves, grads)
        losses.append(float(loss.detach()))
    delta = _leaf_norms({k: leaves[k].detach() - theta0[k] for k in leaves})
    return {"losses": losses, "g1": g1, "delta": delta}


def leaf_gaps(p: dict, r: dict, keys) -> dict:
    """Each leaf's |‖p‖ − ‖r‖| over the larger of its reference norm and
    the median leaf's."""
    med = float(np.median([r[k] for k in keys]))
    return {k: abs(p[k] - r[k]) / max(r[k], med) for k in keys}


def moving_leaves(ref: dict) -> list:
    keys = sorted(ref["g1"])
    med_g = float(np.median([ref["g1"][k] for k in keys]))
    return [k for k in keys if ref["g1"][k] >= STILL_LEAF * med_g]


def compare(prog: dict, ref: dict) -> list:
    """(name, reading) of the compared numbers: the worst step's loss, the
    worst leaf's step-1 gradient and change after three steps, and the
    median leaf's step-1 gradient. The worst leaves are the LayerNorm and
    FFN biases, whose gradients are cancelling sums over every token, and
    read alike in bfloat16 and in fp8; the median leaf separates them."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                   ref["losses"]))
    grad = leaf_gaps(prog["g1"], ref["g1"], sorted(ref["g1"]))
    change = leaf_gaps(prog["delta"], ref["delta"], moving_leaves(ref))
    return [("loss", loss), ("grad", max(grad.values())),
            ("change", max(change.values())),
            ("grad_median", float(np.median(list(grad.values()))))]


def leaf_report(prog: dict, ref: dict, top: int = 4) -> dict:
    """The largest leaves' gaps and the median leaf's, for the look at
    what a worst-leaf reading is made of."""
    out = {}
    for name, p, r, keys in (
            ("grad", prog["g1"], ref["g1"], sorted(ref["g1"])),
            ("change", prog["delta"], ref["delta"], moving_leaves(ref))):
        gaps = leaf_gaps(p, r, keys)
        worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        out[name + "_worst"] = [[k.replace("encoder.", ""), v, r[k]]
                                for k, v in worst]
        out[name + "_median"] = float(np.median(list(gaps.values())))
    return out


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, control: bool = False) -> Outcome:
    """One run; ``control`` also reads the control (the reference in fp8)
    and the half-batch fault against the reference, into the notes."""
    cfg, mix = cell.config, cell.mix
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    streamed = mix["feed"] == "streamed"
    phases = Phases(t_start, dev)
    split = eegdata.make_split(cfg["data"], seed, dev)
    if streamed:  # the split lives in host RAM only
        split["eeg"] = split["eeg"].cpu()
        if cuda:
            # the peak is the streamed job's, not the split's on the card
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
    phases.mark("data")
    trainer = _program(cell, split, seed, dev, streamed)
    phases.mark("program")
    theta0 = {k: p.detach().clone()
              for k, p in trainer.model.named_parameters()}
    prog = _check_steps(trainer, streamed)
    prog["delta"] = _leaf_norms({k: prog["theta"][k] - theta0[k]
                                 for k in theta0})
    del prog["theta"], theta0
    phases.mark("check_steps")
    trainer.evaluate(0)
    phases.mark("evaluation")
    guard.check("after set-up")
    setup_s = time.perf_counter() - t_start

    batch = cfg["train"]["batch_size"]
    rec = {"setup_s": setup_s, "chips": cell.chips, "samples": 0,
           "step_ms": [], "loader_wait_s": [], "loader_gather_s": [],
           "steps": 0, "epoch_s": [], "config": cfg,
           "peak_dtype": cfg["compute_dtype"]}
    sl, failed = None, 0
    t0 = t_end = time.perf_counter()
    epoch = len(CHECK_CALLS)
    while True:
        # a traced run traces its trace_epoch, or its last epoch if the
        # window closes before that one
        tracing = trace and sl is None and epoch >= mix["trace_epoch"]
        if tracing:
            sl = Slice()
            sl.start()
        t_epoch = t_end
        met = trainer.train_epoch(epoch)
        t_end = time.perf_counter()
        rec["epoch_s"].append(t_end - t_epoch)
        steps = len(trainer.last_steps["step_loss"])
        rec["samples"] += steps * batch
        rec["steps"] += steps
        if not math.isfinite(met["loss"]):
            failed += steps
        # the program's own spans, outside the traced epoch (the profiler
        # slows the launching thread)
        if trainer.last_steps.get("step_ms") and not tracing:
            rec["step_ms"] += trainer.last_steps["step_ms"]
        if streamed and not tracing:
            rec["loader_wait_s"] += list(trainer.loader.wait_s)
            rec["loader_gather_s"] += list(trainer.loader.gather_s)
        done = t_end - t0 >= seconds
        if not done or tracing:
            trainer.evaluate(epoch)
        if tracing:
            if cuda:
                torch.cuda.synchronize(dev)
            sl.stop()
            rec["traced_steps"] = steps
            rec["traced_eval_rows"] = int(split["test_eeg"].shape[0])
        if done and (sl is not None or not trace):
            break
        epoch += 1
    rec["window_s"] = t_end - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    rec["memory_peak_bytes"] = peak
    guard.check("once the window had closed")
    out_trace = None
    if sl is not None:
        out_trace = sl.reduce()
        rec.update(out_trace)
    attempted = rec["steps"] + CHECK_STEPS
    trainer.close()
    del trainer
    if cuda:
        torch.cuda.empty_cache()

    rec["flops_per_step"] = step_flops(cell)
    with no_tf32():
        ref = reference_steps(cell, split, seed, dev)
    readings = compare(prog, ref)
    limits = cfg["limits"]
    checks = [(n, v, limits[n]) for n, v in readings]
    notes = {"program_losses": prog["losses"],
             "reference_losses": ref["losses"], "setup_phases": phases.s,
             "epoch_ms": [round(1e3 * s) for s in rec["epoch_s"]],
             "samples_per_s": rec["samples"] / rec["window_s"],
             "step_ms_p50": float(np.median(rec["step_ms"]))
             if rec["step_ms"] else None}
    if control:
        with no_tf32():
            for name, kw in (("control", {"control": True}),
                             ("half_batch", {"half_batch": True})):
                other = reference_steps(cell, split, seed, dev, **kw)
                notes[name] = dict(compare(other, ref))
                notes[name + "_leaves"] = leaf_report(other, ref)
        notes["program"] = dict(readings)
        notes["program_leaves"] = leaf_report(prog, ref)
    return Outcome(rec=rec, checks=checks, attempted=attempted,
                   failed=failed, memory_peak_bytes=peak, trace=out_trace,
                   notes=notes)


def step_flops(cell) -> float:
    """Operations of one training step (forward, loss and backward) from
    the reference at the cell's batch, counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = cell.config
    m = dict(cfg["model"], dropout=0.0, conv_dropout=0.0, proj_dropout=0.0)
    b = cfg["train"]["batch_size"] * cell.chips
    d = cfg["data"]
    meta = torch.device("meta")
    prm = {n: torch.empty(s, device=meta, requires_grad=not
                          atms.is_statistic(n))
           for n, s in atms.param_shapes(m)}
    x = torch.empty(b, d["n_channels"], d["n_timepoints"], device=meta)
    sids = torch.zeros(b, dtype=torch.int64, device=meta)
    feat = torch.empty(b, d["clip_dim"], device=meta)
    counter = FlopCounterMode(display=False)
    with counter:
        feats, scale = atms.forward(prm, m, x, sids, train=True)
        atms.retrieval_loss(feats, feat, feat, scale,
                            cfg["train"]["alpha"]).backward()
    return float(counter.get_total_flops())


class Phases:
    """Seconds from the process's start to the end of each set-up phase."""

    def __init__(self, t_start: float, device):
        self.t_start, self.device, self.s = t_start, device, {}

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.s[name] = round(time.perf_counter() - self.t_start, 3)


class no_tf32:
    """float32 products in matmuls and cuDNN inside the block."""

    def __enter__(self):
        self.flags = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.flags
