"""FSDP parameter sharding: the port of ``tqdne_tpu/parallel/fsdp.py`` to
FSDP2 (``torch.distributed.fsdp.fully_shard``).

The JAX package annotates each parameter of at least ``min_size`` elements
with a sharding over ``data`` and lets GSPMD insert the all-gathers and
reduce-scatters; smaller ones stay replicated.  Here ``shard_model`` gives
each submodule that owns such a parameter an FSDP unit of its own (gathered
just before it runs, its gradients reduce-scattered just after), then wraps
the root, whose unit takes every remaining, smaller parameter: FSDP2 stores
those sharded too, but gathers them once at the start of the forward and
holds them whole through the backward, which is the JAX layout's
replication at compute time.  Two differences of layout, not of result:
FSDP2 shards dim 0 (padding a dim that does not divide), where JAX shards
the largest axis that divides the mesh and replicates a parameter with none.

Over the 2D ``("replica", "data")`` mesh of ``make_hybrid_mesh`` this is
HSDP: parameters are sharded over ``data`` and replicated over ``replica``,
and FSDP2 all-reduces the gradient shards across ``replica`` after the
reduce-scatter, so nothing crosses ``replica`` but that all-reduce.

FSDP2 refuses ``copy.deepcopy`` of a sharded module, so the EMA copy of a
``TrainState`` is made before sharding and sharded alike
(``shard_with_ema``).  ``apply_updates`` leaves the DTensor gradients to
FSDP (its reduce-scatter has averaged them), and the non-finite guard reads
the local shards and agrees over the world.  As in the JAX package no CLI
shards; checkpoints of a sharded state are not supported.
"""

from __future__ import annotations

import copy

import torch


def _placements(mesh, sharded: bool) -> tuple:
    from torch.distributed.tensor import Replicate, Shard

    last = Shard(0) if sharded else Replicate()
    if mesh.ndim == 2:  # ("replica", "data"): replicated across slices
        return (Replicate(), last)
    return (last,)


def fsdp_shardings(model, mesh, *, min_size: int = 2**16) -> dict:
    """``{name: placements over mesh}`` for every parameter of ``model`` (a
    module, or a mapping of names to tensors): ``Shard(0)`` over ``data`` for
    those of at least ``min_size`` elements, replicated otherwise; on the
    hybrid mesh ``Replicate()`` over ``replica`` first.  The JAX
    ``fsdp_shardings`` with dim 0 for the sharded axis."""
    params = dict(model.named_parameters()) if isinstance(model, torch.nn.Module) else model
    return {name: _placements(mesh, p.numel() >= min_size) for name, p in params.items()}


def shard_model(model: torch.nn.Module, mesh, *, min_size: int = 2**16) -> torch.nn.Module:
    """``fully_shard`` each submodule of ``model`` that directly owns a
    parameter of at least ``min_size`` elements, innermost first, then the
    root (in place; also returned).  Call before building the optimizer, whose
    parameters are then the DTensors.  FSDP2 shards contiguous parameters
    only, so a ``channels_last`` weight (as the train CLI places models on the
    card) is made contiguous first, its values kept: the convolutions then
    take gathered weights in the standard layout."""
    from torch.distributed.fsdp import fully_shard

    with torch.no_grad():
        for p in model.parameters():
            if not p.is_contiguous():
                p.data = p.data.contiguous()
    owners = [m for m in model.modules() if m is not model and any(
        p.numel() >= min_size for p in m.parameters(recurse=False))]
    for m in reversed(owners):  # modules() is pre-order: children after parents
        fully_shard(m, mesh=mesh)
    fully_shard(model, mesh=mesh)
    return model


def shard_with_ema(model: torch.nn.Module, mesh, *,
                   min_size: int = 2**16) -> tuple[torch.nn.Module, torch.nn.Module]:
    """(``model`` sharded, its EMA copy sharded alike): the copy is taken
    before sharding, frozen and in eval mode, as ``TrainState`` makes it;
    pass it as ``TrainState(..., ema=)``."""
    ema = copy.deepcopy(model).eval().requires_grad_(False)
    return shard_model(model, mesh, min_size=min_size), shard_model(ema, mesh,
                                                                    min_size=min_size)
