"""Spatial partitioning: the port of ``tqdne_tpu/parallel/spatial.py``.

The JAX package lays activations out over a 2D ``("data", "model")`` mesh,
the batch on ``data`` and the leading spatial axis (H in 2D, T in 1D) on
``model``, and lets GSPMD partition every convolution with halo exchanges,
insert the cross-shard sums of GroupNorm's statistics and reshard around
attention.  PyTorch has no counterpart of GSPMD, so here each rank holds its
rows of every activation and the layers exchange what they need, under
``spatial_scope(mesh)``:

- a k-wide convolution takes k // 2 rows from each neighbouring shard
  (``halo_rows``, zeros at the global edges) and runs without padding along
  the rows; a stride-2 one takes only the rows above;
- ``Norm32`` normalises with statistics over every shard
  (``ops.group_norm.group_norm_silu_sharded``: each shard's count, mean and
  M2, gathered and merged);
- attention gathers q, k and v of every shard, attends over all tokens and
  keeps this shard's rows;
- where a level's extent does not split evenly over the shards (or a
  stride-2 layer would meet an odd local extent) the models gather the rows
  and run that level replicated, and cut them again where the extent splits
  (``SpatialScope.enter``).

In the port's ``(B, C, H[, W])`` activations the rows are dim 2; in a
channels-last batch ``(B, H[, W], C)`` they are dim 1.  Every collective is
an ``all_gather`` or an ``all_reduce`` over the model (or the whole) group,
which gloo also takes on CUDA tensors, and each is a
``torch.autograd.Function`` whose backward returns each rank's share of the
gradient to the rank that owns the rows.

Randomness: every draw under the scope is taken at the global shape (all of
the batch's rows and all of the spatial rows) and cut to this rank's block
(``parallel.draw_rows`` reads the scope), so K ranks reproduce one.
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch
import torch.distributed as dist

from tqdne_tpu_torch.parallel.mesh import _mesh_device_type, _mesh_size

_SCOPE: contextvars.ContextVar = contextvars.ContextVar("tqdne_spatial_scope", default=None)


def spatial_mesh(model: int, n_devices: int | None = None):
    """The 2D ``("data", "model")`` mesh over the launched ranks with ``model``-way
    spatial sharding.  ``model`` is innermost, so the ranks that exchange halos and
    statistics are neighbours (a node's local ranks are consecutive under torchrun),
    while ``data`` (the gradient all-reduce, once a step) spans the farther hops.
    ``ValueError`` when ``model`` does not divide the world."""
    from torch.distributed.device_mesh import init_device_mesh

    n = _mesh_size(n_devices)
    if model < 1 or n % model:
        raise ValueError(f"{n} devices not divisible by model={model}")
    return init_device_mesh(_mesh_device_type(), (n // model, model),
                            mesh_dim_names=("data", "model"))


def signal_spec(ndim: int) -> tuple[str, ...]:
    """The mesh axes of a signal batch's leading dims: the batch on ``data``, the
    leading spatial axis (T in 1D, H in 2D) on ``model``."""
    if ndim < 3:
        raise ValueError("signal arrays are (B, T, C) or (B, H, W, C)")
    return ("data", "model")


def batch_shardings(mesh, batch: dict) -> dict:
    """The mesh axes of each leaf of a loader batch: signal-like leaves (ndim >= 3)
    are spatially sharded, per-sample vectors (cond, labels) ride ``data``."""
    return {k: signal_spec(np.ndim(v)) if np.ndim(v) >= 3 else ("data",)
            for k, v in batch.items()}


def _coordinate(mesh) -> tuple[int, int, int, int]:
    """(data size, data rank, model size, model rank) of this process on ``mesh``."""
    return (mesh.size(0), mesh.get_local_rank("data"), mesh.size(1),
            mesh.get_local_rank("model"))


def _per(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} of {n} does not split into {parts} equal shards")
    return n // parts


def _block(n: int, parts: int, index: int, what: str) -> slice:
    per = _per(n, parts, what)
    return slice(index * per, (index + 1) * per)


def shard(mesh, v, name: str = "a leaf"):
    """This rank's block of one global leaf (a tensor or an array): its data rank's
    rows, and of a signal-like leaf (ndim >= 3, channels-last) its model rank's rows
    of the leading spatial axis (dim 1)."""
    nd, rd, nm, rm = _coordinate(mesh)
    v = v[_block(len(v), nd, rd, f"{name}'s batch")]
    if np.ndim(v) >= 3:
        v = v[:, _block(v.shape[1], nm, rm, f"{name}'s leading spatial axis")]
    return v


def shard_batch(mesh, batch: dict) -> dict:
    """This rank's block of a global batch: ``shard`` of each leaf."""
    return {k: shard(mesh, v, k) for k, v in batch.items()}


def gather_signal(mesh, x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``shard_batch`` for one signal-like tensor (B_local,
    H_local, ..., C): the whole batch with all its rows, on every rank."""
    x = _AllGather.apply(x, 1, mesh.get_group("model"), mesh.get_local_rank("model"))
    return _AllGather.apply(x, 0, mesh.get_group("data"), mesh.get_local_rank("data"))


class SpatialScope:
    """The mesh the layers read, and whether the activation in flight is this
    rank's shard of the rows (``sharded``) or every row of its data rank's
    batch (a level run replicated)."""

    def __init__(self, mesh, sharded: bool = True):
        self.mesh = mesh
        self.sharded = sharded
        self.data_size, self.data_rank, self.k, self.model_rank = _coordinate(mesh)
        self.model_group = mesh.get_group("model")

    def extent(self, x: torch.Tensor, sharded: bool) -> int:
        """The global row count of a (B, C, rows, ...) activation."""
        return x.shape[2] * (self.k if sharded else 1)

    def splits(self, extent: int, halo: int, downsample: bool = False) -> bool:
        """Whether a level of ``extent`` rows runs sharded: the rows split evenly,
        each shard holds at least the ``halo`` a convolution takes from it, and
        before a stride-2 layer (``downsample``) each shard's rows are even."""
        rows, rest = divmod(extent, self.k)
        return not rest and rows >= max(halo, 1) and not (downsample and rows % 2)

    def place(self, x: torch.Tensor, sharded: bool, want: bool) -> torch.Tensor:
        """``x`` (B, C, rows, ...) moved from sharded rows to all of them (a
        gather) or back (this rank's rows), as ``want`` says."""
        if sharded == want:
            return x
        if sharded:
            return gather_rows(x, self)
        rows = _block(x.shape[2], self.k, self.model_rank, "the rows")
        return x.narrow(2, rows.start, rows.stop - rows.start)

    def enter(self, x: torch.Tensor, sharded: bool, halo: int,
              downsample: bool = False) -> tuple[torch.Tensor, bool]:
        """(x placed for a step at its extent, whether it is sharded there)."""
        want = self.splits(self.extent(x, sharded), halo, downsample)
        return self.place(x, sharded, want), want

    @contextlib.contextmanager
    def at(self, sharded: bool):
        """The layers inside see this scope with ``sharded`` as given."""
        token = _SCOPE.set(self if sharded == self.sharded else SpatialScope(self.mesh, sharded))
        try:
            yield
        finally:
            _SCOPE.reset(token)

    def gather_stats(self, stats: torch.Tensor) -> torch.Tensor:
        """Every shard's (B, G, 3) GroupNorm statistics as (K, B, G, 3), in rank
        order, differentiably."""
        return _AllGather.apply(stats.unsqueeze(0), 0, self.model_group, self.model_rank)


@contextlib.contextmanager
def spatial_scope(mesh):
    """Run the layers inside on this rank's shard of ``mesh``'s spatial axis
    (nothing changes for ``mesh`` None)."""
    if mesh is None:
        yield None
        return
    scope = SpatialScope(mesh)
    token = _SCOPE.set(scope)
    try:
        yield scope
    finally:
        _SCOPE.reset(token)


def current() -> SpatialScope | None:
    """The scope the layers run under, or None outside ``spatial_scope``."""
    return _SCOPE.get()


def local_shape(scope: SpatialScope, shape) -> tuple[int, ...]:
    """This rank's block of a global channels-last ``shape`` (B, rows, ..., C)."""
    b, rows, *rest = shape
    return (_per(b, scope.data_size, "the batch"),
            _per(rows, scope.k, "the leading spatial axis"), *rest)


def draw_block(draw, *args, **kwargs) -> torch.Tensor:
    """``draw(*args, **kwargs)`` with the shape (the last positional argument) this
    rank's block, taken at the global shape and cut: the batch's rows by the data
    rank, and of a shape of 3 or more dims (channels-last) the rows of dim 1 by the
    model rank."""
    scope = current()
    *lead, shape = args
    b = shape[0]
    if len(shape) < 3:
        full = draw(*lead, (b * scope.data_size, *shape[1:]), **kwargs)
        return full[scope.data_rank * b:(scope.data_rank + 1) * b]
    rows = shape[1]
    full = draw(*lead, (b * scope.data_size, rows * scope.k, *shape[2:]), **kwargs)
    return full[scope.data_rank * b:(scope.data_rank + 1) * b,
                scope.model_rank * rows:(scope.model_rank + 1) * rows]


def mean_over_model(loss: torch.Tensor) -> torch.Tensor:
    """A shard's mean ``loss`` as the mean over the model group: its value is that
    mean on every rank, its gradient 1 / K of the shard's, so the gradients summed
    over the model group are the gradient of the mean.  ``loss`` itself outside the
    scope."""
    scope = current()
    if scope is None:
        return loss
    total = loss.detach().clone()
    dist.all_reduce(total, group=scope.model_group)
    return loss / scope.k + (total / scope.k - loss.detach() / scope.k)


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """``t`` set in place to its maximum over every rank of the scope's mesh (``t`` as
    it is outside the scope)."""
    if current() is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def _rows_view(x: torch.Tensor) -> torch.Tensor:
    """(B, C, rows, ...) as the channels-last (B, rows, ..., C) view, contiguous (free
    for a channels-last tensor)."""
    return x.movedim(1, -1).contiguous()


class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in rank order; the
    backward sums the gradient over the group and keeps this rank's part."""

    @staticmethod
    def forward(ctx, x, dim, group, rank):
        ctx.dim, ctx.group, ctx.rank, ctx.size = dim, group, rank, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None, None


def gather_rows(x: torch.Tensor, scope: SpatialScope) -> torch.Tensor:
    """(B, C, rows, ...) shards to all the rows, in the channels-last layout the
    layers keep; differentiable."""
    full = _AllGather.apply(_rows_view(x), 1, scope.model_group, scope.model_rank)
    return full.movedim(-1, 1)


class _HaloRows(torch.autograd.Function):
    """A shard's rows with ``top`` rows of the shard above and ``bottom`` of the shard
    below around them (zeros past the global edges), over the channels-last view;
    the backward sends each halo's gradient to the rank that owns its rows and adds
    it there."""

    @staticmethod
    def forward(ctx, v, top, bottom, group, rank, k):
        ctx.config = (top, bottom, group, rank, k)
        rows = v.shape[1]
        edges = torch.cat([v[:, :bottom], v[:, rows - top:]], 1).contiguous()
        parts = [torch.empty_like(edges) for _ in range(k)]
        dist.all_gather(parts, edges, group=group)
        above = parts[rank - 1][:, bottom:] if rank > 0 else v.new_zeros(edges[:, bottom:].shape)
        below = parts[rank + 1][:, :bottom] if rank < k - 1 else \
            v.new_zeros(edges[:, :bottom].shape)
        return torch.cat([above, v, below], 1)

    @staticmethod
    def backward(ctx, grad):
        top, bottom, group, rank, k = ctx.config
        rows = grad.shape[1] - top - bottom
        g = grad[:, top:top + rows].contiguous()
        halos = torch.cat([grad[:, :top], grad[:, top + rows:]], 1).contiguous()
        parts = [torch.empty_like(halos) for _ in range(k)]
        dist.all_gather(parts, halos, group=group)
        if rank > 0 and bottom:  # the shard above took my first rows as its bottom halo
            g[:, :bottom] += parts[rank - 1][:, top:]
        if rank < k - 1 and top:  # the shard below took my last rows as its top halo
            g[:, rows - top:] += parts[rank + 1][:, :top]
        return g, None, None, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int, scope: SpatialScope) -> torch.Tensor:
    """(B, C, rows, ...) with ``top`` rows from the shard above and ``bottom`` from the
    shard below (zeros at the global edges) around its own, channels-last."""
    if x.shape[2] < max(top, bottom):
        raise ValueError(f"a shard of {x.shape[2]} rows cannot give a halo of "
                         f"{max(top, bottom)}")
    v = _HaloRows.apply(_rows_view(x), top, bottom, scope.model_group, scope.model_rank,
                        scope.k)
    return v.movedim(-1, 1)
