"""ctypes binding of the port's host loading engine (``native/eid_loader.cpp``;
counterpart of ``eeg_image_decode_tpu/data/native_loader.py``).

- :class:`GatherPool`: a persistent pool of C++ threads that gathers rows,
  ``dst[:len(idx)] = src[idx]`` along the first axis, from CPU tensors (or
  numpy arrays) into a caller's buffer, typically a pinned staging slot.
  ``submit`` returns a ticket at once and ``wait`` blocks until the rows are
  written. ctypes releases the GIL for each call, so the copy and a wait
  hold up no other Python thread: :class:`~eeg_image_decode_tpu_torch.data.
  loader.PrefetchLoader` gathers on it while the training thread launches
  the device's work.
- :class:`NpyMmap`: a ``.npy`` file mapped read-only, as a zero-copy numpy
  view, with ``willneed`` readahead (``madvise(MADV_WILLNEED)``) over a row
  range. ``data/things_eeg.py`` reads the subject sidecars through it.

The library is built at first use with ``g++`` from that one source into
``eeg_image_decode_tpu_torch/_build/`` (git-ignored), under a name keyed by
a hash of the source and the flags. Unlike the JAX module, which falls back
to numpy when the build fails, a failed build raises with the compiler's
output: the port has no second gather path that would hide it. Every index
is checked against the source's length before any row is copied (the JAX
module does not check, so its threads read outside the array for a bad
index); an index out of range raises ``IndexError``, as ``index_select``
does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "eid_loader.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

# eid_npy_map's status codes (NpyStatus in the source)
_NPY_OK, _NPY_IO, _NPY_NOT_NPY, _NPY_OTHER_LAYOUT, _NPY_TRUNCATED = range(5)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
#: name → (argument types, result type)
_SIGNATURES = {
    "eid_pool_create": ([_INT], _P),
    "eid_pool_destroy": ([_P], None),
    "eid_pool_threads": ([_P], _INT),
    # pool, src, dst, idx, rows, row bytes, src rows → ticket, or -1 - r
    # for the first index r out of range
    "eid_gather_submit": ([_P, _P, _P, _P, _I64, _I64, _I64], _I64),
    "eid_gather_wait": ([_P, _I64], _INT),
    # path, status, errno → handle or null
    "eid_npy_map": ([ctypes.c_char_p, ctypes.POINTER(_INT),
                     ctypes.POINTER(_INT)], _P),
    "eid_npy_ndim": ([_P], _INT),
    "eid_npy_shape": ([_P, _P], None),
    "eid_npy_descr": ([_P], ctypes.c_char_p),
    "eid_npy_data": ([_P], _P),
    "eid_npy_data_bytes": ([_P], _I64),
    # handle, payload byte offset, bytes → 0 or errno
    "eid_npy_willneed": ([_P, _I64, _I64], _INT),
    "eid_npy_unmap": ([_P], None),
}

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()
_build_error: str | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libeid_loader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the engine with ``g++`` unless a library of the same source
    and flags is there; returns its path. Raises ``RuntimeError`` with the
    compiler's output if the build fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_so = Path(tmp) / so.name
        try:
            proc = subprocess.run(
                ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp_so)],
                capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"g++ could not build {SOURCE.name}: {e}") \
                from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name} (rc "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp_so, so)  # atomic: a concurrent loader sees all or none
    return so


def lib() -> ctypes.CDLL:
    """The loaded engine, built first if needed."""
    global _lib, _build_error
    with _lib_lock:
        if _lib is None:
            try:
                handle = ctypes.CDLL(str(build()))
            except (RuntimeError, OSError) as e:
                _build_error = str(e)
                raise
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib, _build_error = handle, None
        return _lib


def native_available() -> bool:
    """Whether the engine builds and loads here."""
    try:
        lib()
    except (RuntimeError, OSError):
        return False
    return True


def build_error() -> str | None:
    """The error of the last failed build or load, if any."""
    native_available()
    return _build_error


def _host_tensor(x, what: str) -> torch.Tensor:
    """A CPU tensor over ``x``'s memory (numpy arrays are wrapped without a
    copy; an ``ml_dtypes`` bfloat16 array becomes a ``torch.bfloat16``
    tensor)."""
    if isinstance(x, np.ndarray):
        with warnings.catch_warnings():  # a read-only map is only read
            warnings.simplefilter("ignore", UserWarning)
            if x.dtype.name == "bfloat16":
                return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
            return torch.from_numpy(x)
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"gather {what}: a tensor or numpy array, not "
                        f"{type(x).__name__}")
    if x.device.type != "cpu":
        raise ValueError(f"gather {what} must be on the host, not {x.device}")
    return x


def default_threads() -> int:
    """The pool's default size: the cores this process may run on, less
    two, at least one. JAX's pool takes a thread a hardware thread, which
    leaves no core to the thread that launches the device's work or to the
    loader's sequencing thread; on an 8-core H100 host a pool of 8 made the
    streamed training step the slowest of pools of 4, 6 and 8 and
    ``index_select``, and 6 gathered a batch as fast as 8 (``PERF.md`` §6,
    ``scripts/profile_torch_streaming.py``)."""
    return max(1, len(os.sched_getaffinity(0)) - 2)


class GatherPool:
    """Row gather on a persistent pool of ``n_threads`` C++ threads (0:
    :func:`default_threads`) with asynchronous ``submit`` and ``wait``.
    Several Python threads may submit and wait on one pool. ``close``
    waits out every ticket and stops the threads."""

    def __init__(self, n_threads: int = 0):
        self._lib = lib()
        self._pool = self._lib.eid_pool_create(int(n_threads)
                                               or default_threads())
        self.n_threads = self._lib.eid_pool_threads(self._pool)
        # (src, idx, dst) of each ticket, alive until it is waited on: the
        # C++ threads read and write them without a reference of their own
        self._live: dict[int, tuple] = {}
        self._lock = threading.Lock()

    @property
    def is_native(self) -> bool:
        """Always true while open: the port has no numpy fallback (the name
        is the JAX module's)."""
        return self._pool is not None

    def submit(self, src, idx, dst) -> int:
        """Start ``dst[:len(idx)] = src[idx]`` (first-axis gather) and
        return its ticket. ``src`` and ``dst`` are CPU tensors or numpy
        arrays of one dtype and row shape, ``dst`` contiguous with at least
        ``len(idx)`` rows (a non-contiguous ``src`` is copied first). Every
        index is checked before any row is copied: one outside
        ``[0, len(src))`` raises ``IndexError``."""
        if self._pool is None:
            raise RuntimeError("the gather pool is closed")
        if isinstance(src, np.ndarray):
            src = np.ascontiguousarray(src)
        src_t = _host_tensor(src, "src").contiguous()
        dst_t = _host_tensor(dst, "dst")
        idx_t = torch.as_tensor(idx)
        if idx_t.dim() != 1 or idx_t.is_floating_point() or idx_t.is_complex():
            raise TypeError(f"gather idx must be a 1-d integer array, not "
                            f"{tuple(idx_t.shape)} {idx_t.dtype}")
        idx_t = idx_t.to("cpu", torch.int64).contiguous()
        n = len(idx_t)
        # explicit checks, not asserts: they guard a raw memcpy
        if src_t.dim() == 0:
            raise ValueError("gather src must have a first axis")
        if not dst_t.is_contiguous():
            raise ValueError("gather dst must be contiguous")
        if dst_t.dtype != src_t.dtype:
            raise TypeError(f"gather dst dtype {dst_t.dtype} != src dtype "
                            f"{src_t.dtype}")
        if dst_t.shape[1:] != src_t.shape[1:] or len(dst_t) < n:
            raise ValueError(f"gather dst shape {tuple(dst_t.shape)} does not "
                             f"take {n} rows of src {tuple(src_t.shape)}")
        row_bytes = src_t[0].numel() * src_t.element_size() if len(src_t) \
            else 0
        ticket = self._lib.eid_gather_submit(
            self._pool, src_t.data_ptr(), dst_t.data_ptr(), idx_t.data_ptr(),
            n, row_bytes, len(src_t))
        if ticket < 0:
            r = -1 - ticket
            raise IndexError(f"gather index {int(idx_t[r])} at position {r} "
                             f"is out of range for {len(src_t)} rows")
        with self._lock:
            self._live[ticket] = (src_t, idx_t, dst_t)
        return ticket

    def wait(self, ticket: int) -> None:
        """Block until ``ticket``'s rows are written."""
        if self._pool is None:
            raise RuntimeError("the gather pool is closed")
        if self._lib.eid_gather_wait(self._pool, ticket) != 0:
            raise ValueError(f"ticket {ticket} is not pending on this pool")
        with self._lock:
            del self._live[ticket]

    def gather(self, src, idx):
        """``src[idx]`` as a new array of ``src``'s kind (tensor or numpy)."""
        n = len(idx)
        if isinstance(src, np.ndarray):
            dst = np.empty((n, *src.shape[1:]), src.dtype)
        else:
            dst = torch.empty((n, *src.shape[1:]), dtype=src.dtype)
        self.wait(self.submit(src, idx, dst))
        return dst

    def close(self) -> None:
        if self._pool is None:
            return
        with self._lock:
            pending = list(self._live)
        for ticket in pending:
            self.wait(ticket)
        self._lib.eid_pool_destroy(self._pool)
        self._pool = None

    def __del__(self):  # close() is the real API
        if getattr(self, "_pool", None) is not None:
            self.close()


_shared_pool: GatherPool | None = None
_shared_pool_lock = threading.Lock()


def shared_pool() -> GatherPool:
    """The process's one gather pool (:func:`default_threads` threads):
    loaders take it by default, so N loaders do not start N pools. Never
    closed."""
    global _shared_pool
    with _shared_pool_lock:
        if _shared_pool is None:
            _shared_pool = GatherPool()
        return _shared_pool


class NpyMmap:
    """A ``.npy`` file mapped read-only as a zero-copy numpy view
    (``.array``, not writable).

    The engine maps C-order little-endian files of plain dtypes, which is
    what ``np.save`` writes for the sidecars, and refuses a file shorter
    than its header promises (``ValueError``; touching the missing pages
    would raise SIGBUS instead). A file of a layout it does not map
    (Fortran order, big-endian, a structured or object dtype) is opened
    with ``np.load(mmap_mode="r")`` instead, and ``is_native`` is false.

    The view keeps its map alive; ``close`` unmaps at once, after which
    views taken from ``.array`` must not be read."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self._lib = lib()
        self._handle = None
        status, err = _INT(), _INT()
        h = self._lib.eid_npy_map(os.fsencode(self.path), ctypes.byref(status),
                                  ctypes.byref(err))
        if h:
            self._handle = h
            self.array = self._view()
        elif status.value == _NPY_OTHER_LAYOUT:
            self.array = np.load(self.path, mmap_mode="r")
        elif status.value == _NPY_IO:
            raise OSError(err.value, os.strerror(err.value), self.path)
        elif status.value == _NPY_TRUNCATED:
            raise ValueError(f"{self.path}: shorter than its .npy header "
                             f"promises (truncated)")
        else:
            raise ValueError(f"{self.path}: not a .npy file this reader "
                             f"parses")

    def _view(self) -> np.ndarray:
        ndim = self._lib.eid_npy_ndim(self._handle)
        shape = (ctypes.c_int64 * max(ndim, 1))()
        self._lib.eid_npy_shape(self._handle, shape)
        shape = tuple(shape[:ndim])
        dtype = np.dtype(self._lib.eid_npy_descr(self._handle).decode())
        nbytes = self._lib.eid_npy_data_bytes(self._handle)
        buf = (ctypes.c_char * nbytes).from_address(
            self._lib.eid_npy_data(self._handle))
        buf.owner = self  # a view keeps the map alive until it is dropped
        array = np.frombuffer(buf, dtype=dtype, count=nbytes // dtype.itemsize
                              ).reshape(shape)
        # the map is PROT_READ: a write through the view would segfault
        array.flags.writeable = False
        return array

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    def willneed(self, row0: int = 0, n_rows: int | None = None) -> None:
        """Ask the kernel to read rows ``[row0, row0 + n_rows)`` of the
        first axis ahead (all rows from ``row0`` by default); returns at
        once. No-op on numpy's path."""
        if self._handle is None:
            return
        a = self.array
        rows = a.shape[0] if a.ndim else 1
        if n_rows is None:
            n_rows = rows - row0
        if row0 < 0 or n_rows < 0 or row0 + n_rows > rows:
            raise IndexError(f"rows [{row0}, {row0 + n_rows}) out of range "
                             f"for {rows}")
        row_bytes = a.itemsize * (int(np.prod(a.shape[1:], dtype=np.int64))
                                  if a.ndim else 1)
        rc = self._lib.eid_npy_willneed(self._handle, row0 * row_bytes,
                                        n_rows * row_bytes)
        if rc:
            raise OSError(rc, os.strerror(rc), self.path)

    def close(self) -> None:
        if self._handle is not None:
            self.array = None
            self._lib.eid_npy_unmap(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()
