"""The port's host loading engine (``data/native_loader.py`` over
``native/eid_loader.cpp``) against the JAX package's and numpy, on the CPU.

- ``GatherPool``: seeded fp32, bf16 (compared as ``uint16``) and int64
  sources gathered by the port's pool, by JAX's ``GatherPool`` and by
  numpy indexing, bit for bit; tensors and numpy arrays; several tickets
  in flight; JAX's cases (``tests/test_loader.py``): a zero-length gather,
  a ``dst`` longer than ``idx``, a non-contiguous source, the shared pool
  across loaders, an epoch restart that quiesces its slots, many threads
  submitting and waiting out of order on one pool; and the port's own
  refusals: an index out of range, negative or too large, raises
  ``IndexError`` before any row is copied, and a ``dst`` of another dtype,
  row shape, too few rows or no contiguity raises.
- ``NpyMmap`` against JAX's ``NpyMmap`` and ``np.load``: several dtypes and
  ranks, ``willneed`` over a range, a truncated file refused, a
  Fortran-order file read through numpy's path, a view that outlives its
  map's owner; the subject sidecar read through it, its cache and its
  fallback for a damaged sidecar.
- The build: the library lands in ``_build/`` under a name keyed by the
  source, and a failed build raises with the compiler's output.
"""

import gc
import os
import sys
import threading
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from eeg_image_decode_tpu.data import native_loader as jax_native
from eeg_image_decode_tpu_torch.data import native_loader as nl
from eeg_image_decode_tpu_torch.data import things_eeg
from eeg_image_decode_tpu_torch.data.loader import PrefetchLoader
from torch_port_case import two_threads  # noqa: F401 (autouse)

BF16 = np.dtype(ml_dtypes.bfloat16)


@pytest.fixture(scope="module")
def pool():
    p = nl.GatherPool(3)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jax_pool():
    p = jax_native.GatherPool(3)
    assert p.is_native, jax_native.build_error()
    yield p
    p.close()


def _source(rng, dtype, shape=(211, 7, 5)):
    if dtype == "int64":
        return rng.integers(-2**40, 2**40, shape, dtype=np.int64)
    return rng.normal(size=shape).astype(BF16 if dtype == "bfloat16"
                                         else np.float32)


def _bits(a) -> np.ndarray:
    """Raw element bits, so bf16 compares as uint16."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    return a.view(np.uint16) if a.dtype in (BF16, np.int16) else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int64"])
def test_gather_equals_jax_and_numpy(rng, pool, jax_pool, dtype):
    src = _source(rng, dtype)
    src_t = nl._host_tensor(src, "src").clone()  # the tensor path's own copy
    for n in (1, 64, 300):  # one row; fewer than the pool's claims; repeats
        idx = rng.integers(0, len(src), n)
        want = _bits(src[idx])
        np.testing.assert_array_equal(_bits(jax_pool.gather(src, idx)), want)
        np.testing.assert_array_equal(_bits(pool.gather(src, idx)), want)
        got = pool.gather(src_t, torch.from_numpy(idx))
        assert isinstance(got, torch.Tensor) and got.dtype == src_t.dtype
        np.testing.assert_array_equal(_bits(got), want)
    # several tickets in flight, into pinned-like preallocated slots
    idxs = [rng.integers(0, len(src), 40) for _ in range(5)]
    dsts = [torch.empty((40, *src_t.shape[1:]), dtype=src_t.dtype)
            for _ in idxs]
    tickets = [pool.submit(src_t, i, d) for i, d in zip(idxs, dsts)]
    assert len(set(tickets)) == len(tickets)
    for t, i, d in zip(tickets, idxs, dsts):
        pool.wait(t)
        np.testing.assert_array_equal(_bits(d), _bits(src[i]))


def test_gather_edge_cases(rng, pool):
    """JAX's ``test_native_gather_edge_cases``."""
    src = torch.from_numpy(rng.normal(size=(50, 9)).astype(np.float32))
    # zero-length gather: the ticket completes at once
    dst = torch.full((4, 9), -1.0)
    pool.wait(pool.submit(src, np.asarray([], np.int64), dst))
    assert bool((dst == -1).all())
    # dst longer than idx: only the first len(idx) rows are written
    idx = np.asarray([3, 7], np.int64)
    pool.wait(pool.submit(src, idx, dst))
    assert torch.equal(dst[:2], src[idx])
    assert bool((dst[2:] == -1).all())
    # a non-contiguous source is copied to a contiguous one, tensor or array
    for nc in (src[:, ::3], src.numpy()[:, ::3]):
        got = pool.gather(nc, [0, 5, 5])
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(nc)[[0, 5, 5]])
    # a waited ticket is no longer pending
    t = pool.submit(src, [1], dst)
    pool.wait(t)
    with pytest.raises(ValueError, match="not pending"):
        pool.wait(t)


def test_gather_refusals_copy_nothing(rng, pool):
    src = torch.from_numpy(rng.normal(size=(20, 4)).astype(np.float32))
    dst = torch.full((4, 4), 7.0)
    for bad in ([0, 1, 20, 2], [3, -1], [2**40]):
        with pytest.raises(IndexError, match="out of range"):
            pool.submit(src, bad, dst)
        assert bool((dst == 7).all())  # no row of the good indices either
    with pytest.raises(TypeError, match="dtype"):
        pool.submit(src, [0], torch.empty((4, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        pool.submit(src, [0], torch.empty((4, 5)))
    with pytest.raises(ValueError, match="shape"):
        pool.submit(src, [0, 1, 2], torch.empty((2, 4)))
    with pytest.raises(ValueError, match="contiguous"):
        pool.submit(src, [0], torch.empty((4, 8))[:, ::2])
    with pytest.raises(TypeError, match="integer"):
        pool.submit(src, np.asarray([0.0]), dst)
    assert bool((dst == 7).all())
    p = nl.GatherPool(1)
    p.close()
    assert not p.is_native
    with pytest.raises(RuntimeError, match="closed"):
        p.submit(src, [0], dst)


def test_concurrent_submitters_on_one_pool(rng):
    """JAX's ``test_gather_pool_concurrent_submitters``: more Python threads
    than cores, with a short switch interval, submit bursts to one pool and
    wait in reverse; every result equals numpy's gather."""
    src = rng.normal(size=(512, 7, 11)).astype(np.float32)
    p = nl.GatherPool(4)
    errors = []

    def worker(seed):
        r = np.random.default_rng(seed)
        try:
            for _ in range(25):
                batch = [r.integers(0, len(src), int(r.integers(1, 64)))
                         for _ in range(4)]
                dsts = [np.empty((len(ix), 7, 11), np.float32)
                        for ix in batch]
                tickets = [p.submit(src, ix, d) for ix, d in zip(batch, dsts)]
                for t in reversed(tickets):
                    p.wait(t)
                for ix, d in zip(batch, dsts):
                    np.testing.assert_array_equal(d, src[ix])
        except Exception as e:  # surface across the thread boundary
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    p.close()
    assert not errors, errors[0]


def test_shared_pool_reused_across_loaders():
    """JAX's ``test_shared_pool_reused_across_loaders``; a private pool is
    the loader's own and ``close`` releases it."""
    arrays = {"x": np.arange(40, dtype=np.float32).reshape(10, 4)}
    l1 = PrefetchLoader(arrays, 5, device="cpu")
    l2 = PrefetchLoader(arrays, 5, device="cpu")
    assert l1.pool is l2.pool is nl.shared_pool()
    assert l1.is_native and l1.pool.n_threads == nl.default_threads() >= 1
    l1.close()
    l2.close()  # must not close the shared pool
    l3 = PrefetchLoader(arrays, 5, device="cpu")
    assert l3.pool.is_native
    assert next(iter(l3.epoch(0)))["x"].shape == (5, 4)
    l3.close()
    own = PrefetchLoader(arrays, 5, device="cpu", gather_threads=2)
    assert own.pool is not nl.shared_pool() and own.pool.n_threads == 2
    own.close()
    assert not own.pool.is_native and nl.shared_pool().is_native
    plain = PrefetchLoader(arrays, 5, device="cpu", gather="index_select")
    assert plain.pool is None and not plain.is_native
    plain.close()
    with pytest.raises(ValueError, match="gather"):
        PrefetchLoader(arrays, 5, device="cpu", gather="numpy")


@pytest.mark.parametrize("gather", ["pool", "index_select"])
def test_epoch_restart_quiesces_slots(rng, gather):
    """JAX's ``test_epoch_restart_quiesces_slots``: an epoch abandoned with
    gathers in flight, then a whole epoch equal to numpy's indexing."""
    arrays = {"x": rng.normal(size=(64, 8)).astype(np.float32),
              "y": np.arange(64, dtype=np.int32)}
    loader = PrefetchLoader(arrays, 8, seed=5, device="cpu", gather=gather)
    it = loader.epoch(0)
    next(it)
    next(it)
    perm = np.random.default_rng(5 * 100003 + 1).permutation(64)
    for i, batch in enumerate(loader.epoch(1)):
        idx = perm[i * 8:(i + 1) * 8]
        np.testing.assert_array_equal(batch["y"].numpy(), arrays["y"][idx])
        np.testing.assert_array_equal(batch["x"].numpy(), arrays["x"][idx])
    assert i == 7 and len(loader.gather_s) == 8
    loader.close()


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, BF16,
                                   np.bool_, "<U3"])
def test_npy_mmap_equals_jax_and_numpy(rng, tmp_path, dtype):
    shapes = [(11, 6, 4), (5,), (), (0, 3)]
    for k, shape in enumerate(shapes):
        arr = (rng.normal(size=shape) * 100).astype(dtype)
        p = str(tmp_path / f"a{k}.npy")
        np.save(p, arr)
        m, jm = nl.NpyMmap(p), jax_native.NpyMmap(p)
        want = np.load(p)
        assert m.is_native and jm.is_native
        assert m.array.shape == want.shape == jm.array.shape
        assert m.array.dtype == want.dtype
        assert not m.array.flags.writeable
        np.testing.assert_array_equal(m.array, want)
        if arr.dtype.kind != "U":  # JAX's reader sizes U by its digits
            np.testing.assert_array_equal(m.array, jm.array)
        m.willneed()
        if shape and shape[0] > 3:
            m.willneed(2, 3)
            m.willneed(shape[0] - 1, 1)
            with pytest.raises(IndexError):
                m.willneed(shape[0] - 1, 2)
        m.close()
        jm.close()
        assert m.array is None and not m.is_native


def test_npy_mmap_refusals_and_numpy_path(rng, tmp_path):
    arr = rng.normal(size=(100, 64)).astype(np.float32)
    p = str(tmp_path / "full.npy")
    np.save(p, arr)
    blob = Path(p).read_bytes()
    # a file shorter than its header promises: refused before any page is
    # touched (JAX's reader refuses it too, then numpy raises)
    t = str(tmp_path / "truncated.npy")
    Path(t).write_bytes(blob[:len(blob) // 2])
    with pytest.raises(ValueError, match="truncated"):
        nl.NpyMmap(t)
    with pytest.raises(ValueError):
        jax_native.NpyMmap(t)
    bad = str(tmp_path / "bad.npy")
    Path(bad).write_bytes(b"not a numpy file at all")
    with pytest.raises(ValueError, match="not a .npy"):
        nl.NpyMmap(bad)
    with pytest.raises(FileNotFoundError):
        nl.NpyMmap(str(tmp_path / "missing.npy"))
    # layouts the engine does not map take numpy's path, as in JAX
    for name, other in (("f", np.asfortranarray(arr[:6, :8])),
                        ("be", arr[:6].astype(">f4"))):
        q = str(tmp_path / f"{name}.npy")
        np.save(q, other)
        m = nl.NpyMmap(q)
        assert not m.is_native
        np.testing.assert_array_equal(np.asarray(m.array), other)
        m.willneed()  # no-op on numpy's path
        m.close()
    # a view keeps its map alive after the NpyMmap is dropped
    view = nl.NpyMmap(p).array[10:20]
    gc.collect()
    np.testing.assert_array_equal(view, arr[10:20])


def test_sidecar_reads_through_npy_mmap(rng, tmp_path):
    """The subject sidecar read maps through ``NpyMmap``, once per file;
    a rewritten sidecar is mapped anew; a damaged one falls back to the
    pickle and is rewritten."""
    sub = tmp_path / "sub-01"
    sub.mkdir()
    eeg = rng.normal(size=(6, 3, 8)).astype(np.float32)
    path = sub / "preprocessed_eeg_training.npy"
    np.save(path, {"preprocessed_eeg_data": eeg, "ch_names": ["a", "b", "c"],
                   "times": np.arange(8) / 8.0}, allow_pickle=True)
    sidecar = str(path) + ".raw.npy"
    first = things_eeg._load_subject_file(str(tmp_path), "sub-01", True)
    np.testing.assert_array_equal(first["preprocessed_eeg_data"], eeg)
    mapped = things_eeg._load_subject_file(str(tmp_path), "sub-01", True)
    data = mapped["preprocessed_eeg_data"]
    np.testing.assert_array_equal(data, eeg)
    assert mapped["ch_names"] == ["a", "b", "c"]
    m = things_eeg._OPEN_MMAPS[sidecar][1]
    assert m.is_native and data is m.array
    again = things_eeg._load_subject_file(str(tmp_path), "sub-01", True)
    assert again["preprocessed_eeg_data"] is data  # the same map
    # a truncated sidecar: the pickle is read and the sidecar rewritten
    blob = Path(sidecar).read_bytes()
    Path(sidecar + ".cut").write_bytes(blob[:len(blob) - 40])
    os.replace(sidecar + ".cut", sidecar)  # the old map keeps its file
    back = things_eeg._load_subject_file(str(tmp_path), "sub-01", True)
    np.testing.assert_array_equal(back["preprocessed_eeg_data"], eeg)
    assert sidecar not in things_eeg._OPEN_MMAPS
    np.testing.assert_array_equal(data[:1], eeg[:1])  # the old map's view
    fresh = things_eeg._load_subject_file(str(tmp_path), "sub-01", True)
    np.testing.assert_array_equal(fresh["preprocessed_eeg_data"], eeg)
    assert things_eeg._OPEN_MMAPS[sidecar][1] is not m


def test_build_into_build_dir_and_failure_raises(tmp_path, monkeypatch):
    so = nl.library_path()
    assert so.parent == nl.BUILD_DIR and so.name.startswith("libeid_loader_")
    assert nl.native_available() and nl.build_error() is None
    assert nl.build().exists()
    broken = tmp_path / "eid_loader.cpp"
    broken.write_text("int broken( {\n")
    monkeypatch.setattr(nl, "SOURCE", broken)
    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path / "_build")
    assert nl.library_path() != so
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        nl.build()
    assert "error" in str(e.value)
