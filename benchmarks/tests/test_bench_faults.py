"""A run driven on the CPU at a small size, past the look for a card, with
the timed path broken underneath: ``correct`` comes out false for each
fault the cell can have; and the sound run comes out correct."""

import time

import pytest
import torch

from benchmarks.harness import runner
from benchmarks.tests import small


def _run(cell, seconds=1.0):
    line, _ = runner.run(cell, seed=2**31 + 77, seconds=seconds, trace=False,
                         device="cpu", t_start=time.perf_counter())
    return line


@pytest.fixture
def training():
    return small.training_cell()


def test_sound_training_run_is_correct(training):
    assert _run(training)["correct"] is True


def test_a_step_that_leaves_its_state_unchanged(training, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    line = _run(training)
    assert line["correct"] is False
    assert line["checks"]["change"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["atms_train_resident",
                                  "atms_train_streamed"])
def test_an_epoch_that_leaves_its_state_unchanged(name, monkeypatch):
    """A fault in the window's entry alone: ``train_epoch`` runs its steps
    and then puts the parameters back."""
    from eeg_image_decode_tpu_torch.train.contrastive import (
        ContrastiveTrainer,
    )

    epoch = ContrastiveTrainer.train_epoch

    def undone(self, *a, **k):
        before = {n: p.detach().clone()
                  for n, p in self.model.named_parameters()}
        out = epoch(self, *a, **k)
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(before[n])
        return out

    monkeypatch.setattr(ContrastiveTrainer, "train_epoch", undone)
    line = _run(small.training_cell(name))
    assert line["correct"] is False
    assert line["checks"]["change"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(training, monkeypatch):
    from eeg_image_decode_tpu_torch.train import contrastive

    full = contrastive.retrieval_loss

    def half(feats, img, text, scale, alpha=0.99):
        h = feats.shape[0] // 2
        return full(feats[:h], img[:h], text[:h], scale, alpha=alpha)

    monkeypatch.setattr(contrastive, "retrieval_loss", half)
    assert _run(training)["correct"] is False


def test_features_altered_where_they_are_produced(training, monkeypatch):
    from eeg_image_decode_tpu_torch.models import layers

    head = layers.ProjectionHead.forward
    monkeypatch.setattr(layers.ProjectionHead, "forward",
                        lambda self, *a, **k: 1.05 * head(self, *a, **k))
    assert _run(training)["correct"] is False


@pytest.fixture
def recon():
    cell = small.recon_cell()
    # calls of whole chunks, every finished request compared
    cell.mix = dict(cell.mix, rate_per_s=40.0, sample_requests=10**6)
    return cell


def test_sound_reconstruction_run_is_correct(recon):
    assert _run(recon, 2.0)["correct"] is True


def test_an_image_altered_where_it_is_produced(recon, monkeypatch):
    from eeg_image_decode_tpu_torch.gen.sdxl import Generator4Embeds

    decode = Generator4Embeds.decode
    monkeypatch.setattr(Generator4Embeds, "decode", lambda self, x: torch.clamp(
        decode(self, x) + 0.05, 0.0, 1.0))
    assert _run(recon, 2.0)["correct"] is False


def test_half_the_chunk_left_out(recon, monkeypatch):
    from eeg_image_decode_tpu_torch.gen.sdxl import Generator4Embeds

    decode = Generator4Embeds.decode

    def half(self, x):
        img = decode(self, x)
        h = img.shape[0] // 2
        return torch.cat([img[:h], img[:h].mean(0, keepdim=True).expand(
            img.shape[0] - h, *img.shape[1:])])

    monkeypatch.setattr(Generator4Embeds, "decode", half)
    assert _run(recon, 2.0)["correct"] is False


def test_per_layer_reads_end_before_the_traced_slice(recon):
    """The profiler slows the device thread and a backlog builds behind
    the slice: no call read for the per-layer metrics comes after it."""
    from benchmarks.drivers import reconstruct as rc
    from benchmarks.drivers.train_contrastive import Phases

    dev = torch.device("cpu")
    srv = rc.Serving(recon.config, 5, dev, recon.mix["eeg_pool"],
                     Phases(time.perf_counter(), dev))
    try:
        w = rc.window(srv, recon.mix, 2.0, 2**31 + 78, trace=True)
        sl = w["slice"]
        assert sl is not None and w["calls"]
        assert all(c["t1"] <= sl.t0 for c in w["calls"])
        assert len(w["calls"]) < len(srv.proxy.calls)
        begin = w["stop_at"] - 2.0 + (2.0 - recon.mix["trace_before_close_s"]
                                      - recon.mix["trace_seconds"])
        assert sl.t0 >= begin
    finally:
        srv.close()
