"""EEG → image serving (``serve.py``'s ``ReconstructionService`` behind
``server.py``'s ``EEGDecodeServer``: the coalescer and the one device
thread, without the HTTP socket).

Set-up makes the encoder's, the prior's and the generator's weights on the
card from the seed, builds the service, hands the daemon a thin proxy of
it (which counts each call's rows and reads the service's ``stage_ms``),
and warms the one chunk shape on the device thread. The window is an
open loop: requests drawn from the seed are sent at the mix's fixed rate
(:func:`schedule`), each on a thread of its own that waits for its answer,
until ``--seconds`` have passed; every request due in the window is waited
for, up to ``grace_s`` past the close, and timed from when it was due.
With ``--trace 1`` a slice of the mix's ``trace_seconds`` that ends
``trace_before_close_s`` before the close is traced, and the per-layer
metrics read the calls that ended before it.

The check, after the window: a sample of the finished requests drawn from
the seed is recomputed by the float32 reference chain (TF32 off) from the
same weights, EEG and (seed, row) pairs; each image's RMS gap to the
reference's, over the reference image's standard deviation, is compared
by its worst image.
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmarks.drivers.train_contrastive import Phases, no_tf32
from benchmarks.harness import eegdata, guard, weights
from benchmarks.harness.runner import Outcome
from benchmarks.harness.trace import Slice
from benchmarks.reference import atms, sdxl
from benchmarks.reference.precision import fp8, round_modules_fp8


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def serving_dtypes(cfg: dict) -> dict:
    """name → dtype of the generator's leaves as the configuration serves
    them (the reference's modules built in that dtype)."""
    net = sdxl.build_generator(cfg, dtype=_dtype(cfg["generator_dtype"]))
    return {n: t.dtype for n, t in net.state_dict().items()}


class Proxy:
    """The service as the daemon sees it: each ``reconstruct`` call's rows,
    start and end time and the service's ``stage_ms`` are recorded."""

    def __init__(self, svc):
        self.svc = svc
        self.calls: list[dict] = []

    def warmup(self, eeg_shape):
        self.svc.warmup(eeg_shape)

    def reconstruct(self, eeg, subject_ids, *, row_seeds=None, seed=0):
        t0 = time.perf_counter()
        out = self.svc.reconstruct(eeg, subject_ids, row_seeds=row_seeds,
                                   seed=seed)
        self.calls.append({"rows": int(eeg.shape[0]), "t0": t0,
                           "t1": time.perf_counter(),
                           "stage_ms": dict(self.svc.stage_ms)})
        return out


def _program(cfg, seed, device):
    from eeg_image_decode_tpu_torch.core.config import ATMSConfig, PriorConfig
    from eeg_image_decode_tpu_torch.gen.sdxl import (
        Generator4Embeds,
        GeneratorConfig,
    )
    from eeg_image_decode_tpu_torch.gen.unet import SDXLUNetConfig
    from eeg_image_decode_tpu_torch.gen.vae import VAEConfig
    from eeg_image_decode_tpu_torch.models.atm_s import ATMS
    from eeg_image_decode_tpu_torch.models.registry import ContrastiveModel
    from eeg_image_decode_tpu_torch.serve import ReconstructionService
    from eeg_image_decode_tpu_torch.train.prior import PriorPipe

    m = cfg["encoder"]
    model = ContrastiveModel(ATMS(ATMSConfig(**m),
                                  dtype=_dtype(cfg["encoder_dtype"])))
    model = model.to(device).eval()
    state = model.state_dict()
    shapes = atms.param_shapes(m)
    weights.check_names(shapes, state, "encoder")
    weights.fill_([(n, state[n]) for n, _ in shapes], seed, "encoder")

    p = cfg["prior"]
    pipe = PriorPipe(PriorConfig(
        embed_dim=p["embed_dim"], cond_dim=p["cond_dim"],
        hidden_dims=tuple(p["hidden_dims"]),
        time_embed_dim=p["time_embed_dim"],
        num_inference_steps=p["num_inference_steps"],
        guidance_scale=p["guidance_scale"]), device=device)
    pipe.init(total_steps=1)
    pstate = pipe.model.state_dict()
    pnames = [(n, t.shape) for n, t in
              sdxl.build_prior(cfg).state_dict().items()]
    weights.check_names(pnames, pstate, "prior")
    weights.fill_([(n, pstate[n]) for n, _ in pnames], seed, "prior")

    g = cfg["generation"]
    gen = Generator4Embeds(GeneratorConfig(
        unet=sdxl.as_config(SDXLUNetConfig, cfg["unet"]),
        vae=sdxl.as_config(VAEConfig, cfg["vae"]),
        num_inference_steps=g["num_inference_steps"],
        guidance_scale=g["guidance_scale"],
        latent_size=tuple(g["latent_size"]), text_len=g["text_len"]),
        dtype=_dtype(cfg["generator_dtype"]), device=device)
    gen.load_state_dicts()  # the modules on the card, uninitialised
    gstate = gen.net.state_dict()
    names = [(n, t.shape) for n, t in sdxl.build_generator(
        cfg, dtype=_dtype(cfg["generator_dtype"])).state_dict().items()]
    weights.check_names(names, gstate, "generator")
    weights.fill_([(n, gstate[n]) for n, _ in names], seed, "generator")
    return ReconstructionService(model, pipe, gen,
                                 max_batch=cfg["max_batch"], device=device)


def reference_chain(cfg: dict, seed: int, device, *, control=False):
    """The float32 chain from the seed's weights (the generator's rounded
    through the dtype it is served in); ``control``: its products in
    fp8."""
    m = cfg["encoder"]
    enc = {n: torch.empty(s, device=device) for n, s in atms.param_shapes(m)}
    weights.fill_(list(enc.items()), seed, "encoder")
    prior = sdxl.build_prior(cfg, device)
    weights.fill_(list(prior.state_dict().items()), seed, "prior")
    net = sdxl.build_generator(cfg, device)
    weights.fill_(list(net.state_dict().items()), seed, "generator",
                  round_to=serving_dtypes(cfg))
    if control:
        round_modules_fp8(net)
    return sdxl.Chain(cfg, enc, prior, net)


def reference_images(chain, reqs: list, device, *, control=False,
                     block: int = 16) -> list:
    out = []
    for lo in range(0, len(reqs), block):
        part = reqs[lo:lo + block]
        eeg = torch.as_tensor(np.concatenate([r["eeg"] for r in part]),
                              device=device)
        sids = torch.as_tensor(np.concatenate([r["sids"] for r in part]),
                               device=device)
        seeds = np.concatenate([r["row_seeds"] for r in part])
        with fp8() if control else contextlib.nullcontext():
            imgs = chain.images(eeg, sids, seeds)
        out += list(imgs.cpu().numpy())
    return out


def image_gap(got: np.ndarray, want: np.ndarray) -> float:
    """RMS of got − want over want's standard deviation."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / want.std())


def schedule(mix: dict, seconds: float, seed: int) -> np.ndarray:
    """The due times (s into the window) of an open loop at the mix's
    ``rate_per_s``: a Poisson process given its count in the window,
    round(rate × seconds) arrivals whose exponential gaps are scaled to
    span the window; the same set of gaps for every seed, in an order drawn
    from the seed."""
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    gaps = np.random.default_rng(0).exponential(1.0, n)
    gaps *= seconds / gaps.sum()
    np.random.default_rng(weights.derive_seed(seed, "arrivals")).shuffle(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def requests(mix: dict, seed: int, n: int, pool: np.ndarray) -> list:
    """``n`` requests drawn from the seed: rows of the EEG pool, subject
    ids and per-row (seed, row) pairs."""
    rng = np.random.default_rng(weights.derive_seed(seed, "requests"))
    rows, (lo, hi) = mix["rows_per_request"], mix["subjects"]
    return [{"id": i, "eeg": pool[rng.integers(0, len(pool), rows)],
             "sids": rng.integers(lo, hi + 1, rows).astype(np.int32),
             "row_seeds": np.stack(
                 [np.full(rows, rng.integers(0, 2**32), np.uint32),
                  np.arange(rows, dtype=np.uint32)], axis=1)}
            for i in range(n)]


class Serving:
    """The daemon as set-up leaves it: the service behind the proxy behind
    ``EEGDecodeServer``, warmed on its device thread, and the EEG pool."""

    def __init__(self, cfg: dict, seed: int, dev, pool_rows: int,
                 phases: "Phases"):
        from eeg_image_decode_tpu_torch.server import EEGDecodeServer

        m = cfg["encoder"]
        self.shape = (m["n_channels"], m["seq_len"])
        self.pool = eegdata.eeg_pool(pool_rows, *self.shape, seed,
                                     dev).cpu().numpy()
        phases.mark("data")
        self.svc = _program(cfg, seed, dev)
        phases.mark("program")
        self.proxy = Proxy(self.svc)
        self.server = EEGDecodeServer(reconstruction=self.proxy)
        self.server.warmup(self.shape)
        phases.mark("warmup")

    def close(self) -> None:
        self.server._device.shutdown(wait=True)
        del self.svc, self.proxy, self.server


def window(srv: Serving, mix: dict, seconds: float, seed: int,
           trace: bool) -> dict:
    """One window of the open loop; every request due in it is waited for,
    up to ``grace_s`` past the close. ``trace``: a slice of
    ``trace_seconds`` that ends ``trace_before_close_s`` before the close,
    so that no call read for the per-layer metrics comes after it."""
    due = schedule(mix, seconds, seed)
    reqs = requests(mix, seed, len(due), srv.pool)
    done: list[dict] = []
    lock = threading.Lock()
    senders = ThreadPoolExecutor(mix["senders"],
                                 thread_name_prefix="client")
    srv.proxy.calls.clear()

    def send(req: dict, t_due: float) -> None:
        try:
            (img,) = srv.server._dispatch(
                "reconstruction", {"eeg": req["eeg"], "sids": req["sids"],
                                   "row_seeds": req["row_seeds"]})
            err = None
        except Exception as e:  # a failed request is counted
            img, err = None, repr(e)
        with lock:
            done.append({**req, "t_due": t_due,
                         "t_done": time.perf_counter(), "image": img,
                         "error": err})

    late = []

    def generate() -> None:
        for req, d in zip(reqs, due):
            t_due = t0 + d
            wait = t_due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late.append(time.perf_counter() - t_due)
            senders.submit(send, req, t_due)

    t0 = time.perf_counter()
    stop_at = t0 + seconds
    gen_thread = threading.Thread(target=generate, name="arrivals")
    gen_thread.start()
    sl = None
    if trace:  # on the daemon's device thread, which launches the work
        begin = max(0.0, seconds - mix["trace_before_close_s"]
                    - mix["trace_seconds"])
        time.sleep(max(0.0, t0 + begin - time.perf_counter()))
        sl = Slice()
        srv.server._device.submit(sl.start).result()
        time.sleep(mix["trace_seconds"])
        srv.server._device.submit(sl.stop).result()
    gen_thread.join()
    deadline = time.perf_counter() + mix["grace_s"]
    while len(done) < len(reqs) and time.perf_counter() < deadline:
        time.sleep(0.05)
    stuck = len(reqs) - len(done)
    senders.shutdown(wait=stuck == 0)
    # the calls that ended in the window, before any traced slice (the
    # profiler slows the launching thread, and a backlog builds behind it)
    end = sl.t0 if sl is not None else stop_at
    calls = [c for c in srv.proxy.calls if c["t1"] <= end]
    return {"reqs": reqs, "done": done, "stuck": stuck, "calls": calls,
            "stop_at": stop_at, "late": late, "slice": sl}


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, control: bool = False) -> Outcome:
    """One run; ``control`` also reads the control (the reference chain in
    fp8) against the reference, into the notes."""
    cfg, mix = cell.config, cell.mix
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    phases = Phases(t_start, dev)
    srv = Serving(cfg, seed, dev, mix["eeg_pool"], phases)
    guard.check("after set-up")
    setup_s = time.perf_counter() - t_start

    win = window(srv, mix, seconds, seed, trace)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    guard.check("once the window had closed")

    done, calls = win["done"], win["calls"]
    in_window = [r for r in done if r["t_done"] <= win["stop_at"]
                 and r["error"] is None]
    finished = sorted((r for r in done if r["error"] is None),
                      key=lambda r: r["id"])
    rec = {"setup_s": setup_s, "window_s": seconds, "chips": cell.chips,
           "images_in_window": sum(len(r["sids"]) for r in in_window),
           # every request due in the window, from when it was due
           "latencies_ms": [1e3 * (r["t_done"] - r["t_due"])
                            for r in finished],
           "call_ms": [1e3 * (c["t1"] - c["t0"]) for c in calls],
           "rows_in_calls": sum(c["rows"] for c in calls),
           "rows_per_call": [c["rows"] for c in calls],
           "stage_ms": [c["stage_ms"] for c in calls],
           "chunks": [-(-c["rows"] // cfg["max_batch"]) for c in calls],
           # counted once the window has closed, from the reference
           "flops_per_image": image_flops(cfg),
           "peak_dtype": cfg["generator_dtype"]}
    out_trace = None
    if win["slice"] is not None:
        out_trace = win["slice"].reduce()
        rec.update(out_trace)
    failed = sum(r["error"] is not None for r in done) + win["stuck"]
    attempted = len(win["reqs"])
    late = win["late"]
    rec["generator_late_ms_max"] = 1e3 * max(late) if late else 0.0
    srv.close()
    rng = np.random.default_rng(weights.derive_seed(seed, "sample"))
    sample = [finished[i] for i in sorted(rng.choice(
        len(finished), size=min(mix["sample_requests"], len(finished)),
        replace=False))]
    del srv, win
    if cuda:
        torch.cuda.empty_cache()

    with no_tf32():
        chain = reference_chain(cfg, seed, dev)
        want = reference_images(chain, sample, dev)
    gaps = [image_gap(r["image"], w) for r, w in zip(sample, want)]
    checks = [("image", max(gaps) if gaps else float("inf"),
               cfg["limits"]["image"])]
    notes = {"image_gaps": gaps, "requests": len(done),
             "call_ms": [round(c) for c in rec["call_ms"]],
             "rows_per_call": rec["rows_per_call"],
             "generator_late_ms_max": rec["generator_late_ms_max"],
             "setup_phases": phases.s,
             "saturated_share": float(np.mean(
                 [np.mean((w <= 0) | (w >= 1)) for w in want]))
             if want else None}
    if control:
        del chain
        if cuda:
            torch.cuda.empty_cache()
        with no_tf32():
            chain = reference_chain(cfg, seed, dev, control=True)
            ctl = reference_images(chain, sample, dev, control=True)
        notes["control"] = {"image": max(image_gap(c, w)
                                         for c, w in zip(ctl, want))}
        notes["program"] = {"image": checks[0][1]}
    return Outcome(rec=rec, checks=checks, attempted=attempted,
                   failed=failed, memory_peak_bytes=peak, trace=out_trace,
                   notes=notes)


def image_flops(cfg: dict) -> float:
    """Operations of one image through the chain, counted on the meta
    device from the reference: the encoder's forward, the prior's steps
    (both guidance branches), the UNet's steps and the VAE's decode; one
    step of each loop is counted and multiplied by its steps."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = torch.device("meta")
    m = cfg["encoder"]
    enc = {n: torch.empty(s, device=meta) for n, s in atms.param_shapes(m)}
    prior = sdxl.build_prior(cfg)
    net = sdxl.build_generator(cfg)
    p, g = cfg["prior"], cfg["generation"]
    unet = net["unet"]
    h, w = g["latent_size"]
    lat = torch.empty(1, unet.config.in_channels, h, w, device=meta)

    def count(fn) -> float:
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            fn()
        return float(counter.get_total_flops())

    return (count(lambda: atms.forward(
        enc, m, torch.empty(1, m["n_channels"], m["seq_len"], device=meta),
        torch.zeros(1, dtype=torch.int64, device=meta), train=False))
        + p["num_inference_steps"] * count(lambda: prior(
            torch.empty(2, p["embed_dim"], device=meta),
            torch.zeros(2, dtype=torch.int64, device=meta),
            torch.empty(2, p["cond_dim"], device=meta),
            torch.ones(2, device=meta)))
        + g["num_inference_steps"] * count(lambda: unet(
            lat, torch.zeros(1, dtype=torch.int64, device=meta),
            torch.empty(1, g["text_len"], unet.config.cross_attention_dim,
                        device=meta),
            None, torch.empty(1, 6, device=meta),
            torch.empty(1, p["embed_dim"], device=meta)))
        + count(lambda: net["vae"].decode(lat)))
