"""The references against the port on the CPU at small sizes, float32:
the same function from the same weights, rows and seeds."""

import numpy as np
import torch

from benchmarks.drivers import reconstruct as rc
from benchmarks.drivers import train_contrastive as tc
from benchmarks.harness import eegdata
from benchmarks.tests import small


def test_training_steps_match_the_port_in_float32():
    cell = small.training_cell(classes=8, batch=16)
    cell.config["compute_dtype"] = "float32"
    seed = 2**31 + 21
    split = eegdata.make_split(cell.config["data"], seed, "cpu")
    trainer = tc._program(cell, split, seed, torch.device("cpu"), False)
    theta0 = {k: p.detach().clone()
              for k, p in trainer.model.named_parameters()}
    prog = tc._check_steps(trainer, False)
    prog["delta"] = tc._leaf_norms({k: prog["theta"][k] - theta0[k]
                                    for k in theta0})
    ref = tc.reference_steps(cell, split, seed, "cpu")
    readings = dict(tc.compare(prog, ref))
    assert readings["loss"] < 1e-5, readings
    assert readings["grad"] < 1e-3 and readings["change"] < 1e-3, readings


def test_streamed_steps_gather_the_permutations_rows():
    cell = small.training_cell("atms_train_streamed", classes=8, batch=16)
    cell.config["compute_dtype"] = "float32"
    seed = 2**31 + 22
    split = eegdata.make_split(cell.config["data"], seed, "cpu")
    trainer = tc._program(cell, split, seed, torch.device("cpu"), True)
    try:
        prog = tc._check_steps(trainer, True)
    finally:
        trainer.close()
    ref = tc.reference_steps(cell, split, seed, "cpu")
    assert max(abs(p - r) / r for p, r in zip(prog["losses"],
                                              ref["losses"])) < 1e-5


def test_reconstruction_chain_matches_the_port_in_float32():
    cell = small.recon_cell()
    cfg = dict(cell.config, encoder_dtype="float32",
               generator_dtype="float32")
    seed = 2**31 + 23
    svc = rc._program(cfg, seed, torch.device("cpu"))
    pool = eegdata.eeg_pool(8, 63, 250, seed, "cpu").numpy()
    reqs = rc.requests(cell.mix, seed, 5, pool)
    got = svc.reconstruct(np.concatenate([r["eeg"] for r in reqs]),
                          np.concatenate([r["sids"] for r in reqs]),
                          row_seeds=np.concatenate([r["row_seeds"]
                                                    for r in reqs]))
    chain = rc.reference_chain(cfg, seed, "cpu")
    want = rc.reference_images(chain, reqs, "cpu", block=3)
    for g, w in zip(got, want):
        assert rc.image_gap(g, w) < 1e-4
