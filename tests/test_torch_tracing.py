"""The port's recorder of spans and counters (``utils/profiling.py``) and
the spans of its three measured paths, on the CPU.

- The recorder: the bound and the ``profiling.dropped`` counter, nothing
  lost by many threads at once, no drop read while appends are under way,
  a span recorded across threads, parents within a thread and handed
  across one (``current``/``under``), counters, the ``profiled`` flag,
  and a ``torch.profiler`` trace that holds a span under its name; the
  cost of a span with no profiler recording.
- The coalescer (``server.py::_Coalescer``) driven from several threads by
  a fake service: one ``server.request`` a request whose ``server.queue``,
  ``server.call`` and ``server.return_wait`` add up to it, the calls'
  ``rows`` to the rows submitted; a served request's wait for the device
  lock in its ``server.return_wait``; the device thread's spans under the
  call through ``EEGDecodeServer``.
- ``ReconstructionService``'s stage spans a chunk and its readback; the
  trainer's ``train.step`` → forward / backward / optimizer once a step,
  ``train.epoch`` and ``train.evaluate``; the loader's ``loader.gather`` /
  ``loader.wait``, whose readings ``gather_s`` / ``wait_s`` are.
"""

import concurrent.futures
import sys
import threading
import time
import timeit

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from eeg_image_decode_tpu_torch.core.config import (
    ATMSConfig,
    ContrastiveTrainConfig,
    PriorConfig,
)
from eeg_image_decode_tpu_torch.data.loader import PrefetchLoader
from eeg_image_decode_tpu_torch.data.synthetic import (
    make_synthetic_retrieval_data,
)
from eeg_image_decode_tpu_torch.gen.sdxl import (
    Generator4Embeds,
    GeneratorConfig,
)
from eeg_image_decode_tpu_torch.models.registry import build_encoder
from eeg_image_decode_tpu_torch.serve import ReconstructionService
from eeg_image_decode_tpu_torch.server import EEGDecodeServer, _Coalescer
from eeg_image_decode_tpu_torch.train.contrastive import ContrastiveTrainer
from eeg_image_decode_tpu_torch.train.prior import PriorPipe
from eeg_image_decode_tpu_torch.utils import profiling
from torch_port_case import SMALL, two_threads  # noqa: F401

MS = 1_000_000  # ns


@pytest.fixture(autouse=True)
def _fresh():
    profiling.clear(profiling.MAX_RECORDS)
    yield
    profiling.clear(profiling.MAX_RECORDS)


def _by_id():
    return {r.id: r for r in profiling.spans()}


def test_bound_drops_the_oldest_and_counts_them():
    profiling.clear(bound=4)
    for i in range(10):
        with profiling.span("s", i=i):
            pass
    kept = profiling.spans()
    assert [r.attrs["i"] for r in kept] == [6, 7, 8, 9]
    assert profiling.counts() == {profiling.DROPPED: 6}
    profiling.count("c")
    profiling.count("c", 4)
    assert profiling.counts() == {profiling.DROPPED: 6, "c": 5}
    profiling.clear()
    assert profiling.spans() == [] and profiling.counts() == {}
    with profiling.span("s"):
        pass
    assert profiling.counts() == {}  # the bound kept, nothing dropped


def test_threads_lose_no_record_and_no_count():
    """More threads than cores, switching every microsecond: every span
    and count is kept, and the bound's drop counter is exact."""
    n_threads, each = 16, 500
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for bound in (profiling.MAX_RECORDS, 1000):
            profiling.clear(bound)

            def work(i):
                for _ in range(each):
                    with profiling.span("outer", i=i):
                        with profiling.span("inner"):
                            profiling.count("n")

            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            total = 2 * n_threads * each
            kept = profiling.spans()
            assert len(kept) == min(total, bound)
            want = {"n": n_threads * each}
            if total > bound:
                want[profiling.DROPPED] = total - bound
            assert profiling.counts() == want
            if total <= bound:
                by_id = {r.id: r for r in kept}
                assert len(by_id) == total
                for r in kept:
                    if r.name == "inner":
                        outer = by_id[r.parent]
                        assert outer.name == "outer"
                        assert outer.thread == r.thread
    finally:
        sys.setswitchinterval(switch)


def test_a_read_while_threads_record_reads_no_drop():
    """``counts()`` read while other threads append, below the bound,
    never reports a dropped record."""
    n_threads, each = 8, 4000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    stop = threading.Event()
    seen = []

    def work():
        for _ in range(each):
            with profiling.span("s"):
                pass

    def read():
        while not stop.is_set():
            seen.append(profiling.counts().get(profiling.DROPPED, 0))

    try:
        reader = threading.Thread(target=read)
        reader.start()
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        reader.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert len(profiling.spans()) == n_threads * each
    assert len(seen) > 100 and max(seen) == 0
    assert profiling.counts() == {}


def test_parents_within_a_thread_and_across_threads():
    with profiling.span("outer", k=1) as outer:
        with profiling.span("inner") as inner:
            assert profiling.current() is inner
        assert profiling.current() is outer
        handed = profiling.current()
        t0 = time.perf_counter_ns()

        def other():
            with profiling.under(handed):
                with profiling.span("on_other"):
                    pass
            with profiling.span("alone"):
                pass
            # begun on the first thread, ended on this one
            profiling.record("crossing", t0, time.perf_counter_ns(),
                             parent=handed, rows=2)

        th = threading.Thread(target=other, name="other-thread")
        th.start()
        th.join()
    assert profiling.current() is None
    recs = {r.name: r for r in profiling.spans()}
    assert recs["outer"].parent is None and recs["outer"].attrs == {"k": 1}
    assert recs["inner"].parent == outer.id
    assert recs["inner"].attrs == {}
    assert recs["on_other"].parent == outer.id
    assert recs["alone"].parent is None
    assert recs["crossing"].parent == outer.id
    assert recs["crossing"].attrs == {"rows": 2}
    assert recs["crossing"].t0 == t0 <= recs["crossing"].t1
    for name in ("on_other", "alone", "crossing"):
        assert recs[name].thread == "other-thread"
    assert recs["outer"].thread == threading.current_thread().name
    assert len({r.id for r in recs.values()}) == len(recs)
    for r in recs.values():
        assert r.t0 <= r.t1 and not r.profiled
    # the order they ended in
    assert [r.name for r in profiling.spans()] == [
        "inner", "on_other", "alone", "crossing", "outer"]
    assert profiling.spans("inner") == [recs["inner"]]


def test_profiled_flag_and_the_profilers_trace(tmp_path):
    with profiling.span("before"):
        pass
    assert not profiling.recording()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.recording()
        with profiling.span("program.phase"):
            torch.ones(8).sum()
        profiling.record("kept.only", 1, 2)
    names = [e.name for e in prof.events()]
    assert "program.phase" in names and "kept.only" not in names
    recs = {r.name: r for r in profiling.spans()}
    assert recs["program.phase"].profiled and recs["kept.only"].profiled
    assert not recs["before"].profiled
    assert profiling.record("late", 1, 2, profiled=True).profiled
    # trace(): the exported Chrome trace carries the span
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("program.traced"):
            torch.ones(4).sum()
    assert "program.traced" in (tmp_path / "tr" / "trace.json").read_text()


def test_a_span_costs_little_with_no_profiler():
    """The recorder's price on every untraced run: well under the 2 µs a
    span asked of it on a quiet host (``PERF.md`` §6 has the readings);
    the check leaves room for a host shared with other tests."""
    profiling.clear(bound=1000)
    per = min(timeit.repeat("with span('x'): pass", number=20_000, repeat=5,
                            globals={"span": profiling.span})) / 20_000
    assert per < 10e-6, per


def _fake_fn(calls, delay=0.02):
    def fn(rows):
        calls.append(len(rows["eeg"]))
        time.sleep(delay)  # the device's time: lets a backlog form
        return (rows["eeg"] * 2,)
    return fn


def test_coalescer_spans_add_up_from_several_threads():
    calls = []
    co = _Coalescer(_fake_fn(calls), threading.Lock())
    sizes = [1 + i % 3 for i in range(16)]

    def one(i, n):
        out, = co.submit({"eeg": np.full((n, 2), float(i), np.float32)})
        assert (out == 2 * i).all() and len(out) == n
        return n

    with concurrent.futures.ThreadPoolExecutor(16) as ex:
        assert sum(ex.map(lambda a: one(*a), enumerate(sizes))) == sum(sizes)
    reqs = profiling.spans("server.request")
    queues = {r.parent: r for r in profiling.spans("server.queue")}
    waits = {r.parent: r for r in profiling.spans("server.return_wait")}
    cs = {r.id: r for r in profiling.spans("server.call")}
    assert len(reqs) == len(sizes) == len(queues) == len(waits)
    assert sorted(r.attrs["rows"] for r in reqs) == sorted(sizes)
    assert len(cs) == len(calls) < len(sizes)
    assert sum(c.attrs["rows"] for c in cs.values()) == sum(sizes)
    assert sorted(c.attrs["rows"] for c in cs.values()) == sorted(calls)
    for r in reqs:
        q, w = queues[r.id], waits[r.id]
        call = cs[q.attrs["call"]]
        assert r.id in call.attrs["requests"]
        assert q.t0 == r.t0 <= q.t1 <= call.t0 <= call.t1 <= w.t0 <= w.t1
        assert w.t1 <= r.t1
        parts = (q.t1 - q.t0) + (call.t1 - call.t0) + (w.t1 - w.t0)
        assert abs((r.t1 - r.t0) - parts) < 1 * MS, (r, q, call, w)


def test_a_served_requests_wait_for_the_device_lock_is_its_return_wait():
    """A request whose rows another leader served still takes the device
    lock before it returns; a call that wins the lock first (here the
    test's own hold of it, 50 ms) lands in that request's
    ``server.return_wait``, not in its queue or its call."""
    lock = threading.Lock()
    calls = []
    co = _Coalescer(_fake_fn(calls, delay=0), lock)
    done = []
    with lock:
        th = threading.Thread(target=lambda: done.append(co.submit(
            {"eeg": np.ones((1, 2), np.float32)})))
        th.start()
        while not co._pending:
            time.sleep(0.001)
        co._drain_as_leader()  # serves the request; it waits on the lock
        time.sleep(0.05)
    th.join()
    assert calls == [1] and (done[0][0] == 2).all()
    (req,) = profiling.spans("server.request")
    (wait,) = profiling.spans("server.return_wait")
    (queue,) = profiling.spans("server.queue")
    (call,) = profiling.spans("server.call")
    assert wait.parent == req.id and wait.t1 - wait.t0 >= 45 * MS
    assert call.t1 - call.t0 < 45 * MS and call.thread != req.thread
    assert abs((req.t1 - req.t0) - (queue.t1 - queue.t0)
               - (call.t1 - call.t0) - (wait.t1 - wait.t0)) < 1 * MS


class _FakeReconstruction:
    def warmup(self, eeg_shape):
        with profiling.span("recon.prior"):
            pass

    def reconstruct(self, eeg, sids, *, row_seeds=None):
        with profiling.span("recon.prior"):
            time.sleep(0.005)
        return eeg[:, :1, :1] * 0


def test_device_thread_spans_are_under_the_call():
    server = EEGDecodeServer(reconstruction=_FakeReconstruction())
    server.warmup((2, 3))
    eeg = np.ones((1, 2, 3), np.float32)

    def one(i):
        server._dispatch("reconstruction", {
            "eeg": eeg, "sids": np.zeros(1, np.int32),
            "row_seeds": np.zeros((1, 2), np.uint32)})

    with concurrent.futures.ThreadPoolExecutor(6) as ex:
        list(ex.map(one, range(6)))
    server._device.shutdown(wait=True)
    by_id = _by_id()
    priors = profiling.spans("recon.prior")
    warm = [p for p in priors if p.parent is None]
    served = [p for p in priors if p.parent is not None]
    assert len(warm) == 1 and warm[0].thread.startswith("device")
    cs = profiling.spans("server.call")
    assert len(served) == len(cs)
    for p in served:
        call = by_id[p.parent]
        assert call.name == "server.call"
        assert p.thread.startswith("device") and call.thread != p.thread
        assert call.t0 <= p.t0 <= p.t1 <= call.t1


def test_reconstruction_stage_spans_a_chunk_and_the_readback():
    model = build_encoder("atms", config=ATMSConfig(), device="cpu", seed=0)
    pipe = PriorPipe(PriorConfig(embed_dim=64, cond_dim=1024,
                                 hidden_dims=(64, 32), time_embed_dim=32,
                                 num_inference_steps=2), device="cpu")
    pipe.init(total_steps=1, seed=3)
    gen = Generator4Embeds(GeneratorConfig.tiny(), dtype=torch.float32,
                           device="cpu")
    gen.init_random(seed=1)
    svc = ReconstructionService(model, pipe, gen, max_batch=2, device="cpu")
    rng = np.random.default_rng(0)
    eeg = rng.normal(size=(3, 63, 250)).astype(np.float32)
    with profiling.span("caller") as caller:
        images = svc.reconstruct(eeg, np.zeros(3, np.int32), seed=1)
    assert images.shape[0] == 3
    stages = ("recon.encoder", "recon.prior", "recon.unet", "recon.vae")
    for name in stages:
        assert len(profiling.spans(name)) == 2, name
    (readback,) = profiling.spans("recon.readback")
    recs = [r for r in profiling.spans() if r.name != "caller"]
    assert {r.parent for r in recs} == {caller.id}
    # a chunk's stages in order, the readback after the last
    for chunk in (recs[:4], recs[4:8]):
        assert [r.name for r in chunk] == list(stages)
        assert all(a.t1 <= b.t0 for a, b in zip(chunk, chunk[1:]))
    assert recs[7].t1 <= readback.t0 and recs[8] is readback


def _trainer(streaming):
    train, test = make_synthetic_retrieval_data(
        n_classes=12, images_per_class=2, train_reps=2,
        n_channels=SMALL["n_channels"], n_timepoints=SMALL["seq_len"],
        clip_dim=SMALL["proj_dim"], seed=46, device="cpu")
    cfg = ContrastiveTrainConfig(batch_size=8, eval_ks=(2, 4, 12), seed=5)
    model = build_encoder("atms", config=ATMSConfig(**SMALL), device="cpu",
                          seed=5)
    return ContrastiveTrainer(model, cfg, train, test, device="cpu",
                              streaming=streaming)


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["resident", "streamed"])
def test_trainer_spans_a_step(streaming):
    trainer = _trainer(streaming)
    try:
        for epoch in (0, 1):
            trainer.train_epoch(epoch)
            trainer.evaluate(epoch)
        steps = len(trainer.last_steps["step_loss"])
        by_id = _by_id()
        epochs = profiling.spans("train.epoch")
        assert [e.attrs["epoch"] for e in epochs] == [0, 1]
        assert [e.attrs["epoch"] for e in profiling.spans(
            "train.evaluate")] == [0, 1]
        step_spans = profiling.spans("train.step")
        assert len(step_spans) == 2 * steps
        assert {by_id[s.parent].name for s in step_spans} == {"train.epoch"}
        for name in ("train.forward", "train.backward", "train.optimizer"):
            got = profiling.spans(name)
            assert len(got) == len(step_spans), name
            assert sorted(by_id[r.parent].id for r in got) == sorted(
                s.id for s in step_spans)
        for s in step_spans:
            kids = sorted((r for r in profiling.spans() if r.parent == s.id),
                          key=lambda r: r.t0)
            assert [k.name for k in kids] == [
                "train.forward", "train.backward", "train.optimizer"]
            assert s.t0 <= kids[0].t0 and kids[-1].t1 <= s.t1
        waits = profiling.spans("loader.wait")
        gathers = profiling.spans("loader.gather")
        if streaming:
            # the last epoch's readings are its spans' (gather_s is the
            # sequencing thread's, in its order)
            assert len(waits) == len(gathers) == 2 * steps
            assert trainer.loader.wait_s == [
                (w.t1 - w.t0) / 1e9 for w in waits[steps:]]
            assert sorted(trainer.loader.gather_s) == sorted(
                (g.t1 - g.t0) / 1e9 for g in gathers[steps:])
            assert {by_id[w.parent].name for w in waits} == {"train.epoch"}
        else:
            assert waits == gathers == []
    finally:
        trainer.close()


def test_loader_readings_are_its_spans():
    arrays = {"eeg": np.arange(40, dtype=np.float32).reshape(20, 2),
              "labels": np.arange(20)}
    loader = PrefetchLoader(arrays, 4, seed=3, device="cpu",
                            gather="index_select")
    try:
        n = sum(1 for _ in loader.epoch(0))
    finally:
        loader.close()
    assert n == 5 == len(loader.gather_s) == len(loader.wait_s)
    assert loader.wait_s == [(w.t1 - w.t0) / 1e9
                             for w in profiling.spans("loader.wait")]
    assert loader.gather_s == [(g.t1 - g.t0) / 1e9
                               for g in profiling.spans("loader.gather")]
