"""The port's host-streamed training, its loader, and the logger and
profiler utilities, on the CPU.

- ``data/loader.py::PrefetchLoader`` against the JAX package's loader on the
  JAX CPU device: equal batches in the same order, float32 and bfloat16
  hosts (both round to nearest even), several buffer sizes, a ragged last
  batch, through the shared native pool, a private one
  (``gather_threads=3``) and the plain ``index_select`` gather; an
  abandoned epoch; a gather's error raised to the consumer; the length
  check; the card by default.
- ``ContrastiveTrainer(streaming=True)`` at the small ATM-S of
  ``tests/torch_port_case.py``, 3 epochs: losses, metrics and parameters
  bit-equal to the resident trainer; with ``host_dtype="bfloat16"``,
  bit-equal to the resident trainer fed the same bf16-rounded EEG; the
  same with the trainer's loader swapped for the plain gather's; a
  streamed ``fit`` killed after epoch 1 and resumed: bit-equal; the zero
  batch error; ``export_features`` equal to the resident one.
- ``cli train-retrieval --streaming [--host-dtype bfloat16] --device cpu``
  alone (bit-equal to the resident run), with ``--sweep``, with
  ``--joint`` and under ``--mesh`` (one CPU rank, bit-equal to the streamed
  run); ``--host-dtype`` without ``--streaming`` is ignored.
- ``utils/logging.py::MetricsLogger``'s CSV and stdout rows equal the JAX
  logger's byte for byte, and a missing wandb raises;
  ``utils/profiling.py``'s ``assert_finite`` and ``trace`` (its Chrome
  trace holds a program span).
"""

import dataclasses
import io
import json
import sys

import numpy as np
import pytest
import torch

from eeg_image_decode_tpu.data.loader import PrefetchLoader as JaxLoader
from eeg_image_decode_tpu.utils import logging as jax_logging
from eeg_image_decode_tpu.utils import profiling as jax_profiling
from eeg_image_decode_tpu_torch import cli
from eeg_image_decode_tpu_torch.core.checkpoint import Checkpointer
from eeg_image_decode_tpu_torch.core.config import (
    ATMSConfig,
    ContrastiveTrainConfig,
)
from eeg_image_decode_tpu_torch.data.loader import PrefetchLoader
from eeg_image_decode_tpu_torch.data.synthetic import (
    make_synthetic_retrieval_data,
    write_synthetic_things_tree,
)
from eeg_image_decode_tpu_torch.models.registry import build_encoder
from eeg_image_decode_tpu_torch.train.contrastive import ContrastiveTrainer
from eeg_image_decode_tpu_torch.utils import logging as port_logging
from eeg_image_decode_tpu_torch.utils import profiling
from torch_port_case import SMALL, run_cli_child

C, T = SMALL["n_channels"], SMALL["seq_len"]
TIMING = ("epoch_time_s", "samples_per_s")


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _arrays(rng, n=37):
    return {"eeg": rng.normal(size=(n, 3, 5)).astype(np.float32),
            "subject_ids": rng.integers(0, 9, n).astype(np.int32),
            "labels": np.arange(n, dtype=np.int32)}


@pytest.mark.parametrize("host_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("buffer_size,drop,gather", [
    pytest.param(1, True, {}, id="1-True"),
    pytest.param(2, False, {}, id="2-False"),
    pytest.param(3, True, {}, id="3-True"),
    pytest.param(2, False, {"gather_threads": 3}, id="2-False-threads3"),
    pytest.param(2, False, {"gather": "index_select"},
                 id="2-False-index_select")])
def test_loader_batches_equal_jax(rng, host_dtype, buffer_size, drop,
                                  gather):
    arrays = _arrays(rng)
    kw = dict(seed=7, drop_remainder=drop, buffer_size=buffer_size,
              host_dtype=host_dtype)
    mine = PrefetchLoader(arrays, 5, device="cpu", **kw, **gather)
    assert mine.is_native == (gather.get("gather") != "index_select")
    theirs = JaxLoader(arrays, 5, **kw)
    assert len(mine) == len(theirs) == (7 if drop else 8)
    for epoch in (2, 3):
        got = [{k: (v.float() if k == "eeg" else v).numpy().copy()
                for k, v in b.items()} for b in mine.epoch(epoch)]
        # copies: a JAX CPU array may alias the loader's staging slot
        want = [{k: np.array(v, np.float32 if k == "eeg" else v.dtype)
                 for k, v in b.items()} for b in theirs.epoch(epoch)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if host_dtype:
        assert mine.arrays["eeg"].dtype == torch.bfloat16
        assert mine.arrays["labels"].dtype == torch.int32
    mine.close()
    theirs.close()


def test_loader_abandoned_epoch_and_checks(rng):
    arrays = _arrays(rng)
    loader = PrefetchLoader(arrays, 4, seed=1, buffer_size=3, device="cpu")
    it = loader.epoch(0)
    next(it)
    it.close()  # abandoned with gathers in flight
    perm = np.random.default_rng(1 * 100003 + 1).permutation(37)
    for i, b in enumerate(loader.epoch(1)):
        np.testing.assert_array_equal(b["labels"].numpy(),
                                      perm[i * 4:(i + 1) * 4])
    loader.close()
    with pytest.raises(ValueError, match="disagree on length"):
        PrefetchLoader({"a": np.zeros(4), "b": np.zeros(5)}, 2, device="cpu")
    # a gather's error reaches the consumer, not only the loader's thread
    loader = PrefetchLoader(arrays, 4, device="cpu")
    loader.arrays["eeg"] = loader.arrays["eeg"][:3]  # rows it cannot gather
    with pytest.raises(IndexError):
        list(loader.epoch(0))
    with pytest.raises(IndexError):  # and again from close: not swallowed
        loader.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PrefetchLoader(arrays, 4)


def _data(seed=46):
    return make_synthetic_retrieval_data(
        n_classes=12, images_per_class=2, train_reps=2, n_channels=C,
        n_timepoints=T, clip_dim=SMALL["proj_dim"], seed=seed, device="cpu")


def _trainer(train, test, *, streaming, host_dtype=None, out=None,
             ckpt=None):
    cfg = ContrastiveTrainConfig(batch_size=8, eval_ks=(2, 4, 12), seed=5,
                                 host_dtype=host_dtype, ckpt_every_epochs=1)
    model = build_encoder("atms", config=ATMSConfig(**SMALL), device="cpu",
                          seed=5)
    return ContrastiveTrainer(model, cfg, train, test, device="cpu",
                              streaming=streaming, output_dir=out,
                              checkpointer=ckpt)


def _same_run(a, b):
    """Histories (timings aside), last per-step losses and every parameter
    and buffer, bit for bit."""
    for ra, rb in zip(a.history, b.history, strict=True):
        assert {k: v for k, v in ra.items() if k not in TIMING} == {
            k: v for k, v in rb.items() if k not in TIMING}
    assert a.last_steps["step_loss"] == b.last_steps["step_loss"]
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("host_dtype,plain", [
    pytest.param(None, False, id="None"),
    pytest.param("bfloat16", False, id="bfloat16"),
    pytest.param(None, True, id="None-index_select"),
    pytest.param("bfloat16", True, id="bfloat16-index_select")])
def test_streamed_trainer_is_bit_equal_to_resident(host_dtype, plain):
    train, test = _data()
    streamed = _trainer(train, test, streaming=True, host_dtype=host_dtype)
    assert streamed.data is None and streamed.loader.is_native
    if plain:
        streamed.loader = streamed.loader.rerouted(gather="index_select")
    streamed.fit(3, log_fn=None)
    streamed.close()
    if host_dtype:  # the resident trainer fed the same bf16-rounded EEG
        train = dataclasses.replace(train,
                                    eeg=train.eeg.bfloat16().float())
    resident = _trainer(train, test, streaming=False, host_dtype=host_dtype)
    resident.fit(3, log_fn=None)
    _same_run(streamed, resident)
    assert len(streamed.last_steps["step_loss"]) == 48 // 8
    if host_dtype is None:
        np.testing.assert_array_equal(
            streamed.extract_features(train.eeg, train.subject_ids),
            resident.extract_features(train.eeg, train.subject_ids))


def test_streamed_fit_killed_and_resumed_is_bit_equal(tmp_path):
    train, test = _data(seed=47)
    full = _trainer(train, test, streaming=True)
    full.fit(3, log_fn=None)
    full.close()
    d = str(tmp_path / "run")
    first = _trainer(train, test, streaming=True, out=d,
                     ckpt=Checkpointer(d + "/ckpt"))
    first.fit(1, log_fn=None)   # "killed" after epoch 1
    first.close()
    again = _trainer(train, test, streaming=True, out=d,
                     ckpt=Checkpointer(d + "/ckpt"))
    assert again.resume() == 1
    again.fit(3, log_fn=None)
    again.close()
    _same_run(again, full)
    path = str(tmp_path / "pairs.npz")
    again.export_features(path)
    with np.load(path) as z:
        np.testing.assert_array_equal(
            z["eeg_features"],
            again.extract_features(train.eeg, train.subject_ids))


def test_streaming_needs_one_batch():
    train, test = _data()
    small = dataclasses.replace(
        train, **{f: getattr(train, f)[:5] for f in (
            "eeg", "labels", "subject_ids", "img_idx", "text_idx")})
    with pytest.raises(ValueError, match="ZERO batches"):
        _trainer(small, test, streaming=True)
    if not torch.cuda.is_available():
        model = build_encoder("atms", config=ATMSConfig(**SMALL),
                              device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ContrastiveTrainer(model, ContrastiveTrainConfig(batch_size=8),
                               train, test, streaming=True)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("things")
    feats = write_synthetic_things_tree(
        str(root), ("sub-01", "sub-02"), n_classes=4, n_test_classes=3,
        train_reps=1, test_reps=3, seed=81)
    return str(root), feats


def _train(tree, tmp_path, capsys, name, *extra):
    root, feats = tree
    cli.main(["train-retrieval", "--data-path", root, "--features", feats,
              "--device", "cpu", "--dtype", "float32", "--eval-ks", "2,3",
              "--batch-size", "8", "--train-reps", "1", "--epochs", "1",
              "--output-dir", str(tmp_path / name), *extra])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_streaming_matches_resident(tree, tmp_path, capsys):
    resident = _train(tree, tmp_path, capsys, "resident")
    streamed = _train(tree, tmp_path, capsys, "streamed", "--streaming")
    ignored = _train(tree, tmp_path, capsys, "ignored", "--host-dtype",
                     "bfloat16")  # without --streaming: ignored, as in JAX
    for row in (streamed, ignored):
        assert {k: v for k, v in row.items() if k not in TIMING} == {
            k: v for k, v in resident.items() if k not in TIMING}


def test_cli_streaming_sweep_and_joint(tree, tmp_path, capsys):
    rows = _train(tree, tmp_path, capsys, "sweep", "--streaming",
                  "--host-dtype", "bfloat16", "--sweep", "--subjects",
                  "sub-01,sub-02")
    assert [r["subject"] for r in rows] == ["sub-01", "sub-02"]
    assert all(np.isfinite(r["loss"]) for r in rows)
    joint = _train(tree, tmp_path, capsys, "joint", "--streaming", "--joint",
                   "--subjects", "sub-01,sub-02", "--test-subject", "sub-01")
    assert joint["epoch"] == 0 and np.isfinite(joint["loss"])
    # --streaming under --mesh (one CPU rank) against the streamed run,
    # both in child processes (the group outlives the call)
    root, feats = tree
    rows = []
    for name, extra in (("streamed", []), ("mesh", ["--mesh"])):
        row = json.loads(run_cli_child(
            ["train-retrieval", "--data-path", root, "--features", feats,
             "--device", "cpu", "--dtype", "float32", "--eval-ks", "2,3",
             "--batch-size", "8", "--train-reps", "1", "--epochs", "1",
             "--output-dir", str(tmp_path / name), "--streaming",
             *extra])[-1])
        rows.append({k: v for k, v in row.items() if k not in TIMING})
    assert rows[0] == rows[1]


def test_metrics_logger_rows_equal_jax(tmp_path, monkeypatch):
    rows = [{"epoch": 0, "loss": 1.23456789, "top1_k200": 0.1, "time": 5.0},
            {"epoch": 1, "loss": 0.5, "train_acc": 0.25, "time": 6.0}]
    outs = []
    for mod, name in ((port_logging, "port"), (jax_logging, "jax")):
        stream = io.StringIO()
        log = mod.MetricsLogger(str(tmp_path / name), stream=stream)
        for r in rows:
            log.log(r, step=r["epoch"])
            log.print(r)
        log.finish()
        with open(tmp_path / name / "results.csv", "rb") as f:
            outs.append((f.read(), stream.getvalue()))
    assert outs[0] == outs[1]
    log = port_logging.MetricsLogger(None)
    log.log({"a": 1})
    assert log.write_csv() is None and "time" in log.rows[0]
    monkeypatch.setitem(sys.modules, "wandb", None)  # wandb absent
    with pytest.raises(ImportError):
        port_logging.MetricsLogger(str(tmp_path), use_wandb=True)


def test_step_timer_assert_finite_and_trace(tmp_path):
    x = torch.tensor([1.0, 2.0])
    assert profiling.assert_finite(x) is x
    bad = [1.0, float("nan")]
    with pytest.raises(FloatingPointError) as got:
        profiling.assert_finite(torch.tensor(bad))
    import jax.numpy as jnp

    with pytest.raises(FloatingPointError) as want:
        jax_profiling.assert_finite(jnp.asarray(bad))
    assert str(got.value) == str(want.value)
    with pytest.raises(FloatingPointError, match="non-finite eeg"):
        profiling.assert_finite(torch.tensor([float("inf")]).bfloat16(),
                                "eeg")
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("program.step"):
            torch.ones(4).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert "program.step" in {e.get("name") for e in events}
