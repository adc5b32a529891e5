"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The library lands
in ``eeg_image_decode_tpu_torch/_build/`` (git-ignored) under a name keyed by
a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. The compiler's ``-Xptxas -v`` report
(registers, shared memory, spills per kernel) is kept beside the library.

Nothing here runs at import: this module is imported on hosts without a GPU
or ``nvcc``, where only the kernels' plain PyTorch versions run.

``LAUNCHES`` counts the launches of each kernel: every wrapper adds one
where it launches its kernel, and nowhere else, so a run can show that its
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: dict[str, int] = {
    "attention_fwd": 0, "attention_fwd_masks": 0, "attention_fwd_seed": 0,
    "attention_bwd": 0, "tsconv_fwd": 0, "tsconv_fwd_epilogue": 0,
    "tsconv_bwd": 0,
    "projection_fwd": 0, "projection_fwd_masks": 0, "projection_fwd_seed": 0,
    "projection_bwd": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_LL = ctypes.c_longlong
#: name → (argument types, result type)
_SIGNATURES = {
    # dtype, x, w[16], out, ws, B, L, D, inner, FF, H, drop mode,
    # masks[4], seed (device), thresh, keep value, sample0, stream
    "eid_attention_fwd": ([_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _P, _P, _U, _F, _U, _P], _I),
    # dtype, L, D, inner, FF, H → workspace bytes, or -1 for shapes the
    # dtype's design does not take
    "eid_attention_fwd_workspace": ([_I, _I, _I, _I, _I, _I], _LL),
    # dtype, B, L, D, inner, FF, H → workspace bytes
    "eid_attention_bwd_workspace": ([_I, _I, _I, _I, _I, _I, _I], _LL),
    # dtype, x, g, w[16], wt[6] (float32 only), dx, out[5], ws, B, L, D,
    # inner, FF, H, drop mode, masks[4], seed (device), thresh, keep value,
    # sample0, stream
    "eid_attention_bwd": ([_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _P, _P, _U, _F, _U, _P], _I),
    # dtype, x, w, scale, shift (fp32 (F,) or null), elu, out, rows, T, M,
    # F, P, stride, stream
    "eid_tsconv_fwd": ([_I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                        _P], _I),
    # dtype, rows, T, M, F, P, stride → 1 if the dtype's design takes the
    # shape, else 0
    "eid_tsconv_fwd_takes": ([_I, _I, _I, _I, _I, _I, _I], _I),
    # dtype, rows, T, M, F, P, stride → workspace bytes, or -1 for shapes
    # the dtype's design does not take
    "eid_tsconv_bwd_workspace": ([_I, _I, _I, _I, _I, _I, _I], _LL),
    # dtype → the design it takes ("mma_bf16" or "fma_fp32")
    "eid_attention_fwd_design": ([_I], ctypes.c_char_p),
    "eid_attention_bwd_design": ([_I], ctypes.c_char_p),
    "eid_tsconv_fwd_design": ([_I], ctypes.c_char_p),
    "eid_tsconv_bwd_design": ([_I], ctypes.c_char_p),
    "eid_projection_fwd_design": ([_I], ctypes.c_char_p),
    "eid_projection_bwd_design": ([_I], ctypes.c_char_p),
    # dtype, x, g, w, dx, dw, ws, rows, T, M, F, P, stride, stream
    "eid_tsconv_bwd": ([_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P], _I),
    # dtype, B, Din, Dout → workspace bytes, or -1 for shapes the dtype's
    # design does not take
    "eid_projection_fwd_workspace": ([_I, _I, _I, _I], _LL),
    # dtype, x, w[6], out, ws, B, Din, Dout, drop mode, mask, seed
    # (device), thresh, keep value, sample0, stream
    "eid_projection_fwd": ([_I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _U,
                            _F, _U, _P], _I),
    # dtype, B, Din, Dout → workspace bytes
    "eid_projection_bwd_workspace": ([_I, _I, _I, _I], _LL),
    # dtype, x, g (fp32), w[6], wi^T, wr^T (null for bfloat16), dx, out[3],
    # ws, B, Din, Dout, drop mode, mask, seed (device), thresh, keep value,
    # sample0, stream
    "eid_projection_bwd": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _P, _P, _U, _F, _U, _P], _I),
}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built on a machine with the CUDA toolkit"
        )
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libeid_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link the library;
    returns its path. A library already built from the same sources is
    reused."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas=-v", "-I", str(CSRC),
                   "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name} (rc {p.returncode})\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_so),
             *[str(o) for _, o, _ in procs]],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        so.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp_so, so)  # atomic: a concurrent loader sees all or none
    return so


def count_sass(opcodes: tuple[str, ...],
               kernels: tuple[str, ...]) -> dict[str, int]:
    """How many SASS instructions whose opcode starts with one of
    ``opcodes`` (e.g. ``("HMMA", "HGMMA")``, the tensor cores') the built
    library holds in the kernels whose names contain each of ``kernels``,
    read from ``cuobjdump -sass`` (it ships with the toolkit beside
    ``nvcc``)."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build())], check=True,
                          capture_output=True, text=True).stdout
    counts = dict.fromkeys(kernels, 0)
    inside: list[str] = []
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            inside = [k for k in kernels if k in line]
        elif inside and line.startswith("/*"):
            # "/*0040*/   HMMA.16816.F32.BF16 R4, ... ;" (maybe predicated)
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words and words[0].startswith(opcodes):
                for k in inside:
                    counts[k] += 1
    return counts


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            handle.eid_error_string.argtypes = [ctypes.c_int]
            handle.eid_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib().eid_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cuda {rc})")


def pointer_array(tensors) -> ctypes.Array:
    """Host array of device pointers (the kernels' weight lists)."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_args(name: str, x: torch.Tensor, tensors: dict) -> None:
    """Device/dtype checks shared by the wrappers: everything on x's CUDA
    device, in one of the kernels' two dtypes, contiguous."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    for k, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name}: {k} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: {k} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} is not contiguous")
