"""Multi-process runtime (counterpart of
``eeg_image_decode_tpu/parallel/multihost.py``): joining the
``torch.distributed`` world, and feeding a rank its part of the data.

1. :func:`initialize` joins the process group. Under a launcher
   (``torchrun`` sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
   ``MASTER_ADDR`` and ``MASTER_PORT``) it reads that environment; an
   explicit ``init_method`` (``tcp://…``, ``file://…``) with ``rank`` and
   ``world_size`` joins that rendezvous; with neither, the process makes a
   group of one, the degenerate mesh. NCCL serves CUDA ranks and gloo CPU
   ranks (``backend`` overrides: two ranks sharing one card take gloo,
   since NCCL refuses two ranks on one device). Calling it again returns
   the group it joined.
2. A failed bootstrap is never turned into one process quietly: when the
   environment says the process belongs to a larger job (SLURM, Open MPI,
   PMI or ``torchrun``'s ``WORLD_SIZE``) and the launcher's variables do
   not let it join, it raises and names what is missing; an error of
   ``init_process_group`` itself propagates.
3. :func:`process_local_slice`, :func:`shard_global_batch` and
   :func:`replicate_global` place a rank's rows, or identical host copies,
   on its device.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

#: the variables a launcher sets for init_method "env://"
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
#: how long a rank waits for the others at a rendezvous or a collective
TIMEOUT = datetime.timedelta(minutes=10)


def _cluster_env_hint() -> str | None:
    """The variable, if any, that says this process was launched as part of
    a multi-process job; a bootstrap that cannot join it must raise."""
    for var in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE",
                "PMI_SIZE"):
        value = os.environ.get(var)
        if value is None:
            continue
        try:
            if int(value) > 1:
                return f"{var}={value}"
        except ValueError:
            return f"{var}={value!r}"  # mangled: fail safe, surface it
    return None


def missing_launcher_vars() -> list[str]:
    """The launcher variables (``torchrun``'s) that are not set."""
    return [v for v in LAUNCHER_VARS if not os.environ.get(v)]


def local_device(device=None) -> torch.device:
    """This rank's device: an explicit ``device`` with an index as given;
    ``"cuda"`` (the default) → ``cuda:LOCAL_RANK`` (the launcher's local
    rank, 0 without one); ``"cpu"`` → the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def initialize(*, device=None, backend: str | None = None,
               init_method: str | None = None, rank: int | None = None,
               world_size: int | None = None) -> tuple[int, int]:
    """Join (or create) the process group; returns ``(rank, world_size)``.

    ``device`` picks the backend (NCCL for CUDA, gloo for the CPU) unless
    ``backend`` is given; a CUDA rank's device is set to
    :func:`local_device`. Idempotent: a second call returns the group the
    first joined."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    dev = local_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    missing = missing_launcher_vars()
    if init_method is not None:
        if rank is None or world_size is None:
            raise ValueError(f"init_method {init_method!r} needs rank and "
                             "world_size")
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=TIMEOUT)
    elif not missing:
        dist.init_process_group(backend, init_method="env://",
                                timeout=TIMEOUT)
    else:
        hint = _cluster_env_hint()
        if hint is not None:
            raise RuntimeError(
                f"{hint} says this process is one of a multi-process job, "
                f"but {', '.join(missing)} not set, so it cannot join the "
                "group; launch it with torchrun (or export the launcher's "
                "variables) rather than letting it train alone")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)
    return dist.get_rank(), dist.get_world_size()


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_local_slice(n_global: int, mesh) -> slice:
    """The rows of a ``(n_global, …)`` batch-sharded array this rank owns:
    block ``dp_rank`` of the dp axis (ranks along mp share it)."""
    return mesh.rows(n_global)


def shard_global_batch(mesh, tree: dict, *, global_rows: int) -> dict:
    """This rank's rows of a global batch, on its device. Each rank passes
    only its own rows (:func:`process_local_slice` says which), as many as
    ``global_rows // dp``."""
    want = global_rows // mesh.dp
    out = {}
    for k, v in tree.items():
        if int(v.shape[0]) != want or global_rows % mesh.dp:
            raise ValueError(
                f"{k}: {int(v.shape[0])} rows, but rank {mesh.rank} owns "
                f"{global_rows}/{mesh.dp} of the global batch")
        out[k] = torch.as_tensor(v).to(mesh.device)
    return out


def replicate_global(mesh, tree: dict) -> dict:
    """Identical host copies, one on every rank's device. Every rank must
    hold the same value (the same seed and config, or a broadcast the
    caller made)."""
    return {k: torch.as_tensor(v).to(mesh.device) for k, v in tree.items()}
