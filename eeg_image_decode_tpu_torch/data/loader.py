"""Host-side prefetching batch loader (counterpart of
``eeg_image_decode_tpu/data/loader.py``).

The default trainer keeps a subject's split on the card (4.2 GB). For data
that does not fit, or that should not take the card's memory (joint training
over ten subjects is ≈ 42 GB in fp32), this loader streams batches from
host RAM in two stages:

1. **Gather** into a pinned staging slot, ``buffer_size`` batches ahead, on
   the native C++ pool (``data/native_loader.py::GatherPool``, as the JAX
   loader): a sequencing thread waits until the slot may be rewritten,
   submits each array's rows to the pool and waits on the tickets. The
   pool's threads copy without the GIL, so the gather overlaps the device's
   work and the launching thread's Python. ``gather="index_select"`` keeps
   the plain version: ``torch.index_select(src, 0, idx, out=slot)`` on the
   same thread, which runs on PyTorch's intra-op threads.
2. **Copy**: a ``non_blocking`` host-to-device copy of the slot on a side
   CUDA stream into that slot's own device buffer, and an event the compute
   stream waits on before it reads the batch.

A pinned slot is rewritten only after the copy out of it has finished (the
sequencing thread waits on that copy's event before it submits the slot's
next gather), and a device buffer only after the step that read it has
finished (the side stream waits on an event recorded on the compute stream
when the next batch is requested). So a yielded batch is valid until the
next one is requested. On the CPU the same code yields the slots
themselves, with no stream.

The batch order is the JAX loader's: ``default_rng(seed·100003 + epoch)``,
the formula of ``train/contrastive.py::epoch_permutation``. A
data-parallel rank (``shard=(rank, dp)``) streams its B/dp rows of each
global batch: block ``rank`` of the batch's indices, as the JAX loader's
batch sharding hands a process its rows.
"""

from __future__ import annotations

import time
from collections.abc import Iterator
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from eeg_image_decode_tpu_torch.data.native_loader import (
    GatherPool,
    shared_pool,
)
from eeg_image_decode_tpu_torch.utils.device import resolve_device

#: the loader's gather routes: the native pool, and the plain version
GATHERS = ("pool", "index_select")


class PrefetchLoader:
    """Shuffled batches of a dict of host arrays (numpy or CPU tensors, one
    row per sample), ``buffer_size`` batches gathered ahead, on ``device``
    (the CUDA card by default, raising without one; ``"cpu"`` yields CPU
    tensors).

    ``host_dtype="bfloat16"`` stores the floating arrays on the host as
    ``torch.bfloat16`` (rounded to nearest even), halving the bytes gathered
    and copied per batch; integer arrays stay as they are. The consumer
    upcasts on the device. Call :meth:`close` when done.

    Gathers run on the process's shared native pool
    (``native_loader.shared_pool()``); ``gather_threads > 0`` builds a
    private pool of that many threads, which :meth:`close` releases (the
    JAX loader's semantics). ``gather="index_select"`` gathers with the
    plain ``torch.index_select`` instead (``is_native`` is then false).

    ``gather_s`` and ``wait_s`` hold, for the last epoch, each batch's
    gather time on the sequencing thread and the time the consumer's thread
    waited for it.

    ``shard=(rank, dp)``: each yielded batch is block ``rank`` of ``dp``
    equal blocks of the global batch of ``batch_size`` rows (which dp must
    divide); the global batches and their count are the same on every
    rank."""

    def __init__(
        self,
        arrays: dict,
        batch_size: int,
        *,
        seed: int = 0,
        drop_remainder: bool = True,
        buffer_size: int = 2,
        host_dtype: str | None = None,
        device=None,
        shard: tuple[int, int] = (0, 1),
        gather_threads: int = 0,
        gather: str = "pool",
    ):
        if gather not in GATHERS:
            raise ValueError(f"gather {gather!r}: one of {GATHERS}")
        self.device = resolve_device(device)
        rank, dp = shard
        if batch_size % dp or not 0 <= rank < dp:
            raise ValueError(f"shard {shard}: batch_size {batch_size} must "
                             f"split into {dp} equal blocks")
        if dp > 1 and not drop_remainder:
            raise ValueError("a sharded loader drops the ragged last batch")
        self.shard = (rank, dp)
        self.local_batch = batch_size // dp
        cast = None if host_dtype is None else getattr(torch, host_dtype)
        self.arrays = {}
        for k, v in arrays.items():
            t = torch.as_tensor(v)
            if t.device.type != "cpu":
                raise ValueError(f"array '{k}' must be on the host, not "
                                 f"{t.device}")
            if cast is not None and t.is_floating_point():
                t = t.to(cast)
            self.arrays[k] = t.contiguous()
        n = {int(v.shape[0]) for v in self.arrays.values()}
        if len(n) != 1:
            raise ValueError("arrays disagree on length: "
                             f"{ {k: len(v) for k, v in self.arrays.items()} }")
        self.n = n.pop()
        self.batch_size = batch_size
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.buffer_size = max(1, buffer_size)
        self._cuda = self.device.type == "cuda"
        # slot s holds batch i where i % n_slots == s
        self._n_slots = self.buffer_size + 1
        self._slots = [
            {k: torch.empty((self.local_batch, *v.shape[1:]), dtype=v.dtype,
                            pin_memory=self._cuda)
             for k, v in self.arrays.items()}
            for _ in range(self._n_slots)
        ]
        if self._cuda:
            self._dev = [{k: torch.empty_like(v, device=self.device)
                          for k, v in slot.items()} for slot in self._slots]
            self._stream = torch.cuda.Stream(self.device)
            # per slot: the last copy out of the pinned slot, and the compute
            # stream's position after the last step that read the buffer
            self._copied: list = [None] * self._n_slots
            self._consumed: list = [None] * self._n_slots
        self._own_pool = gather == "pool" and gather_threads > 0
        self.pool: GatherPool | None = None  # None: the plain gather
        if self._own_pool:
            self.pool = GatherPool(gather_threads)
        elif gather == "pool":
            self.pool = shared_pool()
        self._sequencer = ThreadPoolExecutor(1, thread_name_prefix="prefetch")
        self._pending: dict[int, Future] = {}
        self.gather_s: list[float] = []
        self.wait_s: list[float] = []

    @property
    def is_native(self) -> bool:
        """Whether batches are gathered on the native pool."""
        return self.pool is not None

    def __len__(self) -> int:
        if self.drop_remainder:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def _quiesce(self) -> None:
        """Wait out every outstanding gather (raising its error, if any)
        and every copy, so the slots are safe to rewrite: at the start of
        each epoch and in :meth:`close`."""
        pending, self._pending = self._pending, {}
        for fut in pending.values():
            fut.result()
        if self._cuda:
            for ev in self._copied:
                if ev is not None:
                    ev.synchronize()
            # every step enqueued so far, an abandoned epoch's too, comes
            # before the next copy into any device buffer
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._consumed = [ev] * self._n_slots

    def close(self) -> None:
        try:
            self._quiesce()
        finally:
            self._sequencer.shutdown(wait=True)
            if self._own_pool:
                self.pool.close()

    def rerouted(self, **gather) -> "PrefetchLoader":
        """This loader's twin over the same host arrays with another gather
        route (``gather_threads=`` or ``gather=``, as the constructor takes
        them), for comparing routes on one trainer; this one is closed."""
        self.close()
        return PrefetchLoader(self.arrays, self.batch_size, seed=self.seed,
                              drop_remainder=self.drop_remainder,
                              buffer_size=self.buffer_size,
                              device=self.device, shard=self.shard, **gather)

    def _gather(self, idx: torch.Tensor, slot: dict, copied) -> None:
        """On the sequencing thread: event-wait, then submit, then wait."""
        if copied is not None:
            copied.synchronize()  # the last copy out of this pinned slot
        t0 = time.perf_counter()
        pool = self.pool
        if pool is None:
            rows = len(idx)
            for k, src in self.arrays.items():
                torch.index_select(src, 0, idx, out=slot[k][:rows])
        else:
            tickets = []
            try:
                for k, src in self.arrays.items():
                    tickets.append(pool.submit(src, idx, slot[k]))
            finally:  # a refused submit: the others still write the slot
                for t in tickets:
                    pool.wait(t)
        self.gather_s.append(time.perf_counter() - t0)

    def epoch(self, epoch: int) -> Iterator[dict[str, torch.Tensor]]:
        self._quiesce()
        perm = torch.from_numpy(
            np.random.default_rng(self.seed * 100003 + epoch)
            .permutation(self.n))
        n_batches, bs = len(self), self.batch_size
        # this rank's block of each global batch
        lo = self.shard[0] * self.local_batch
        self.gather_s, self.wait_s = [], []

        def submit(i: int) -> None:
            s = i % self._n_slots
            rows = perm[i * bs + lo:i * bs + lo + self.local_batch]
            self._pending[i] = self._sequencer.submit(
                self._gather, rows, self._slots[s],
                self._copied[s] if self._cuda else None)

        for i in range(min(self.buffer_size, n_batches)):
            submit(i)
        for i in range(n_batches):
            t0 = time.perf_counter()
            self._pending.pop(i).result()
            self.wait_s.append(time.perf_counter() - t0)
            s = i % self._n_slots
            rows = min(self.local_batch, self.n - i * bs)
            if self._cuda:
                batch = self._copy_in(s, rows)
            else:
                batch = {k: v[:rows] for k, v in self._slots[s].items()}
            if i + self.buffer_size < n_batches:
                submit(i + self.buffer_size)  # runs during the step
            try:
                yield batch
            finally:
                if self._cuda:  # the step that read buffer s is enqueued
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(self.device))
                    self._consumed[s] = ev

    def _copy_in(self, s: int, rows: int) -> dict[str, torch.Tensor]:
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            if self._consumed[s] is not None:
                self._stream.wait_event(self._consumed[s])
            for k, v in self._slots[s].items():
                self._dev[s][k][:rows].copy_(v[:rows], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        self._copied[s] = ev
        compute.wait_event(ev)
        return {k: v[:rows] for k, v in self._dev[s].items()}
