"""The readers of the program's spans (``harness/spans.py`` and the eight
metrics on it), run on recorder contents made here: the window's records
read, the warm-up's, set-up's and a profiler's left out, None for an empty
recorder, for a window part of which the bound dropped, and for a program
without the recorder."""

import statistics

import pytest

from benchmarks.harness import spec, stats
from eeg_image_decode_tpu_torch.utils import profiling

RECON = ("server.queue_ms_p95", "server.return_wait_ms_p95",
         "recon.prior_host_ms_per_chunk", "recon.readback_ms_per_call")
TRAIN = ("train.forward_host_ms_p50", "train.backward_host_ms_p50",
         "train.optimizer_host_ms_p50", "train.eval_ms_p50")
MS = 1_000_000


def _read(name, rec=None):
    cell = "recon_poisson_rows1" if name in RECON else "atms_train_resident"
    c = spec.load_cell(cell)
    entry = next(m for m in c.per_layer if m["name"] == name)
    return spec.reader(c, entry).read(rec or {})


@pytest.fixture(autouse=True)
def _fresh():
    profiling.clear(profiling.MAX_RECORDS)
    yield
    profiling.clear(profiling.MAX_RECORDS)


def _rec(name, t0_ms, t1_ms, profiled=False, **attrs):
    """A record under the thread's current span, at the given times."""
    return profiling.record(name, int(t0_ms * MS), int(t1_ms * MS),
                            profiled=profiled, **attrs)


def _at(sp, t0_ms, t1_ms, profiled=False):
    """A span kept by its ``with`` block, moved to the given times."""
    sp.t0, sp.t1, sp.profiled = int(t0_ms * MS), int(t1_ms * MS), profiled


def _serving_run(cut_ms=None):
    """Warm-up, then calls of one request each at 100 ms apart: queue
    i + 1 ms, the prior 10 + i ms, readback 2 ms, return wait i ms; from
    ``cut_ms`` on, a profiler sees what begins. The records are kept in
    the order the program keeps them: a span after those it holds."""
    _rec("recon.prior", 0, 500)  # the warm-up's, under no call
    _rec("recon.readback", 500, 510)
    for i in range(20):
        t = 1000 + 100 * i
        p = cut_ms is not None and t >= cut_ms
        with profiling.span("server.request", rows=1) as req:
            with profiling.span("server.call", rows=1,
                                requests=[req.id]) as call:
                _rec("server.queue", t, t + i + 1, profiled=p, parent=req,
                     call=call.id)
                _rec("recon.prior", t + 30, t + 40 + i, profiled=p)
                _rec("recon.readback", t + 50, t + 52, profiled=p)
            _at(call, t + 20, t + 60, p)
            _rec("server.return_wait", t + 60, t + 60 + i, profiled=p)
        _at(req, t, t + 61 + i, p)


def test_serving_readers_take_the_calls_before_the_slice():
    _serving_run(cut_ms=2500)  # requests 0-14 before the profiler
    n = 15
    assert _read("server.queue_ms_p95") == stats.p95(
        [i + 1.0 for i in range(n)])
    assert _read("server.return_wait_ms_p95") == stats.p95(
        [float(i) for i in range(n)])
    # the warm-up's 500 ms prior is left out
    assert _read("recon.prior_host_ms_per_chunk") == pytest.approx(
        statistics.mean(10.0 + i for i in range(n)))
    assert _read("recon.readback_ms_per_call") == pytest.approx(2.0)


def test_serving_readers_without_a_profiler_take_every_call():
    _serving_run()
    assert _read("recon.prior_host_ms_per_chunk") == pytest.approx(
        statistics.mean(10.0 + i for i in range(20)))


def _training_run(traced_epoch=3):
    """Set-up's two short epochs and evaluation, then epochs 2-5 of 4
    steps each, an evaluation after each; the traced epoch and its
    evaluation seen by a profiler. Step s of epoch e: forward e + s ms,
    backward 2·(e + s), optimizer 0.5; an evaluation 30 + e ms (set-up's
    500)."""
    t = 0.0
    for e, steps in ((0, 1), (1, 2), *((e, 4) for e in range(2, 6))):
        p = e == traced_epoch
        t_epoch = t
        with profiling.span("train.epoch", epoch=e) as ep:
            for s in range(steps):
                f, b = e + s, 2.0 * (e + s)
                with profiling.span("train.step") as st:
                    _rec("train.forward", t, t + f, p)
                    _rec("train.backward", t + f, t + f + b, p)
                    _rec("train.optimizer", t + f + b, t + f + b + 0.5, p)
                _at(st, t, t + f + b + 1, p)
                t += f + b + 1
        _at(ep, t_epoch, t, p)
        if e == 1:  # set-up's evaluation
            _rec("train.evaluate", t, t + 500)
            t += 500
        elif e >= 2:
            _rec("train.evaluate", t, t + 30 + e, p, epoch=e)
            t += 30 + e
    return {"epoch_s": [1.0] * 4}


def test_training_readers_take_the_window_outside_the_traced_epoch():
    rec = _training_run()
    plain = (2, 4, 5)
    fwd = [float(e + s) for e in plain for s in range(4)]
    assert _read("train.forward_host_ms_p50", rec) == statistics.median(fwd)
    assert _read("train.backward_host_ms_p50", rec) == statistics.median(
        [2 * f for f in fwd])
    assert _read("train.optimizer_host_ms_p50", rec) == 0.5
    assert _read("train.eval_ms_p50", rec) == statistics.median(
        [30.0 + e for e in plain])


def test_every_reader_reads_nothing_from_an_empty_recorder():
    for name in RECON + TRAIN:
        assert _read(name, {"epoch_s": [1.0]}) is None, name


def test_a_window_the_bound_cut_reads_nothing():
    """Whole where a record older than the window is still kept; the
    set-up's are 15 of training's 87 records, the warm-up's 2 of
    serving's 122."""
    for bound, whole in ((87 - 14, True), (87 - 15, False)):
        profiling.clear(bound=bound)
        rec = _training_run()
        assert profiling.counts()[profiling.DROPPED] == 87 - bound
        for name in TRAIN:
            assert (_read(name, rec) is not None) == whole, (bound, name)
    for bound, whole in ((122 - 1, True), (122 - 2, False)):
        profiling.clear(bound=bound)
        _serving_run()
        assert profiling.counts()[profiling.DROPPED] == 122 - bound
        for name in RECON:
            assert (_read(name) is not None) == whole, (bound, name)


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    rec = _training_run()
    _serving_run()
    monkeypatch.delattr(profiling, "spans")
    for name in RECON + TRAIN:
        assert _read(name, rec) is None, name
