"""The process mesh (counterpart of ``eeg_image_decode_tpu/core/mesh.py``).

JAX lays its devices out as a (dp, mp) grid and lets GSPMD insert the
collectives. Here every rank of the ``torch.distributed`` world is one cell
of that grid: rank r sits at (r // mp, r % mp), as JAX reshapes its device
list. The ``dp`` group holds the ranks of one ``mp`` column (they split the
batch); the ``mp`` group the ranks of one ``dp`` row (they split a layer's
output features, ``gen/sharding.py``). The trainers then compute the step
of the global batch: each rank takes its rows of it and the collectives of
``parallel/collectives.py`` make every reduction global.

One rank is the degenerate 1 × 1 mesh: the same code and the same
collectives, over a group of one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (dp, mp) grid of ranks, with its two process
    groups and its device."""

    dp: int
    mp: int
    rank: int
    dp_rank: int
    mp_rank: int
    dp_group: object
    mp_group: object
    device: torch.device

    def rows(self, n_global: int) -> slice:
        """This rank's rows of ``n_global`` rows (a global batch, or a
        split to shard): block ``dp_rank`` of ``dp`` equal blocks."""
        n = local_batch_size(n_global, self)
        return slice(self.dp_rank * n, (self.dp_rank + 1) * n)


def create_mesh(data_parallel: int = -1, model_parallel: int = 1, *,
                device=None) -> Mesh:
    """The (dp, mp) mesh over the ranks of the initialised
    ``torch.distributed`` world (``parallel/multihost.py::initialize``).

    ``data_parallel=-1`` takes every rank the ``mp`` axis leaves. The grid
    must cover the world: a rank outside it would have no rows to train.
    ``device``: this rank's device (default: ``cuda:LOCAL_RANK`` under a
    launcher, else the current CUDA device). Every rank must call this in
    the same order: it creates the process groups."""
    if not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs the torch.distributed world: call "
            "eeg_image_decode_tpu_torch.parallel.multihost.initialize() "
            "first (it joins torchrun's group, or makes a one-rank one)")
    from eeg_image_decode_tpu_torch.parallel.multihost import local_device

    world, rank = dist.get_world_size(), dist.get_rank()
    mp = model_parallel if model_parallel > 0 else 1
    dp = world // mp if data_parallel == -1 else data_parallel
    if dp * mp != world:
        raise ValueError(
            f"mesh {dp}x{mp} needs {dp * mp} ranks; the world has {world}")
    dp_group = mp_group = None
    for j in range(mp):  # every rank creates every group, in one order
        g = (dist.group.WORLD if mp == 1
             else dist.new_group([i * mp + j for i in range(dp)]))
        if rank % mp == j:
            dp_group = g
    for i in range(dp):
        g = dist.new_group([i * mp + j for j in range(mp)])
        if rank // mp == i:
            mp_group = g
    return Mesh(dp=dp, mp=mp, rank=rank, dp_rank=rank // mp,
                mp_rank=rank % mp, dp_group=dp_group, mp_group=mp_group,
                device=local_device(device))


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    """A rank's share of ``global_batch`` rows."""
    if global_batch % mesh.dp:
        raise ValueError(f"{global_batch} rows do not split into dp="
                         f"{mesh.dp} equal blocks; drop "
                         f"{global_batch % mesh.dp} or change the mesh")
    return global_batch // mesh.dp


def validate_dp_batch(mesh: Mesh | None, batch_size: int) -> None:
    """Fail fast, with a readable message, on a batch that does not divide
    the data-parallel axis."""
    if mesh is None:
        return
    if batch_size % mesh.dp != 0:
        raise ValueError(
            f"batch_size={batch_size} must divide the data-parallel axis "
            f"(dp={mesh.dp}) — pick a multiple of {mesh.dp}")
