"""The collectives of a data-parallel step (counterpart of
``eeg_image_decode_tpu/parallel/collectives.py``), and the scope that tells
the models which rows of the global batch this rank holds.

Under a mesh the JAX trainers are GSPMD programs over the global batch, so
every reduction (the InfoNCE logits, BatchNorm's statistics, the loss mean)
and every random draw covers the whole batch. A rank here holds rows
``dp_rank·B … dp_rank·B + B − 1`` of it; inside :func:`data_parallel` the
models make the same reductions global with these collectives and draw
their masks for the global batch (:func:`draw_rows`, :func:`sample_offset`).

The gradient convention is that of PyTorch's data parallelism: each rank
back-propagates its own copy of the loss, so the gradient reaching a rank's
local rows is dp times its share of the global gradient, and
:func:`pmean_tree` (the mean over the dp group) divides it back out:

- :func:`gather_features` is an all-gather along rows whose backward
  all-reduces (SUM) the whole gathered gradient and keeps the rank's own
  block (gloo has no reduce-scatter; this is the same sum on any backend);
- :func:`global_batch_stats` all-reduces E[x] and E[x²] of the rank's rows
  and divides by dp (equal shards, so that is the global mean), and its
  backward all-reduces the gradient the same way.

Nothing here is a local stand-in: over a group of one rank the same
collectives run. ``COUNTS`` counts the collectives launched, by kind.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

COUNTS: dict[str, int] = {"all_gather": 0, "all_reduce": 0}

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("data_parallel",
                                                          default=None)


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


@contextlib.contextmanager
def data_parallel(mesh):
    """Within this scope the models compute the step of the global batch
    over ``mesh``'s dp group (``None``: the plain one-device step)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh():
    """The mesh of the enclosing :func:`data_parallel` scope, or None."""
    return _ACTIVE.get()


def sample_offset(n_local: int) -> int:
    """The global index of this rank's first row of a batch of ``n_local``
    rows a rank (0 outside a data-parallel scope)."""
    mesh = active_mesh()
    return 0 if mesh is None else mesh.dp_rank * n_local


def draw_rows(draw, shape) -> torch.Tensor:
    """``draw(shape)`` for this rank's rows: inside a data-parallel scope
    the draw covers the global batch (dp · shape[0] rows, so a generator
    advances as on one device) and the rank keeps its block."""
    mesh = active_mesh()
    if mesh is None:
        return draw(tuple(shape))
    n = shape[0]
    full = draw((mesh.dp * n, *shape[1:]))
    return full[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``, counted."""
    COUNTS["all_reduce"] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order, counted
    (not differentiable: :func:`gather_features` is)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    COUNTS["all_gather"] += 1
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        ctx.n = x.shape[0]
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce (SUM); its backward all-reduces too."""
    return _AllReduceSum.apply(x, group)


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Differentiable tiled all-gather of ``x`` (rows) over the dp group."""
    return _GatherRows.apply(x, mesh.dp_group)


def gather_features(feat_a: torch.Tensor, feat_b: torch.Tensor, mesh
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both towers gathered over the dp group, (N_global, D) each on every
    rank, gradient-preserving (ref ``models/loss.py:52-58``): one all-gather
    of the two side by side."""
    if feat_a.shape != feat_b.shape or feat_a.dtype != feat_b.dtype:
        return gather_rows(feat_a, mesh), gather_rows(feat_b, mesh)
    d = feat_a.shape[1]
    both = gather_rows(torch.cat([feat_a, feat_b], dim=1), mesh)
    return both[:, :d], both[:, d:]


def global_mean(x: torch.Tensor, mesh, dims=(0,)) -> torch.Tensor:
    """E[x] over ``dims`` of the global batch (each rank's rows a dp-th of
    it): the local mean all-reduced and divided by dp. Differentiable."""
    return all_reduce_sum(x.mean(dims), mesh.dp_group) / mesh.dp


def global_batch_stats(x: torch.Tensor, mesh
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The global batch's mean and variance E[x²] − E[x]² along dim 0,
    E[x] and E[x²] in one all-reduce; differentiable (sync BatchNorm)."""
    both = torch.stack([x.mean(0), (x * x).mean(0)])
    both = all_reduce_sum(both, mesh.dp_group) / mesh.dp
    # one node for the mean, as the one-device BatchNorm's: its gradient
    # sums its uses in the same order, so one rank matches it bit for bit
    mean, sq = both[0], both[1]
    return mean, sq - mean * mean


def global_any(flag: torch.Tensor, mesh) -> torch.Tensor:
    """True where any rank's ``flag`` is (a one-element all-reduce)."""
    n = all_reduce_(flag.reshape(1).to(torch.int32), mesh.dp_group)
    return n.reshape(flag.shape) > 0


def pmean_tree(params, mesh) -> None:
    """Replace every gradient of ``params`` by its mean over the dp group,
    in place: one all-reduce of the gradients laid end to end (fp32)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    all_reduce_(flat, mesh.dp_group)
    flat.div_(mesh.dp)
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n


def mean_over_ranks(x: torch.Tensor, mesh) -> torch.Tensor:
    """The dp group's mean of a metric (not differentiated)."""
    return all_reduce_(x.detach().float().clone(), mesh.dp_group) / mesh.dp
