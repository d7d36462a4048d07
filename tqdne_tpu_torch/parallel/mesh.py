"""Process groups, device meshes and the data-parallel helpers: the port of
``tqdne_tpu/parallel/mesh.py`` to ``torch.distributed``.

The JAX package keeps one program over a mesh of devices: batches sharded on
``data``, parameters replicated, and XLA inserting the gradient all-reduce
because the jitted step computes a global mean loss.  Here one process
drives one device (torchrun's model, and the reference's Lightning DDP):
each rank holds its own rows of every global batch, computes the mean loss
over them, and ``all_reduce_gradients_`` averages the gradients over the
world, which is the gradient of the global mean when every rank holds as
many rows.  The JAX ``batch_sharding``, ``replicated`` and ``shard_batch``
therefore have no counterpart: a process never holds another device's rows,
and its parameters are replicated because every rank starts from the same
seed or checkpoint (``replicate_`` makes sure).

Randomness that is per row is drawn at the global batch's shape on every
rank from the step's shared generator, and each rank keeps its own rows
(``draw_rows``), so an N-rank step draws what the 1-rank step at the same
global batch draws.

At world size 1 (no process group, or a group of one) nothing here issues a
collective.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from datetime import timedelta

import torch
import torch.distributed as dist

_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
_WHOLE = contextvars.ContextVar("tqdne_whole_batch", default=False)


def maybe_initialize_distributed(device: str | torch.device = "cuda",
                                 timeout: timedelta | None = None) -> bool:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): ``nccl`` for a CUDA ``device``, ``gloo`` for the CPU;
    on CUDA the process's device becomes ``cuda:LOCAL_RANK``.  Returns True
    when a group exists afterwards.

    A no-op without that environment, and when a group already exists.  A
    launch that sets it and fails to initialise raises ``SystemExit``: going
    on would train N independent runs."""
    if dist.is_available() and dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    missing = [k for k in _LAUNCH_ENV if k not in os.environ]
    kind = torch.device(device).type
    try:
        if missing:
            raise RuntimeError(f"{', '.join(missing)} not set")
        if kind == "cuda":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        kwargs = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group("nccl" if kind == "cuda" else "gloo", init_method="env://",
                                **kwargs)
    except Exception as e:  # noqa: BLE001 - any failure ends the launch, loudly
        raise SystemExit(
            f"torch.distributed init failed for RANK={os.environ.get('RANK')} "
            f"WORLD_SIZE={os.environ.get('WORLD_SIZE')} MASTER_ADDR="
            f"{os.environ.get('MASTER_ADDR')} MASTER_PORT={os.environ.get('MASTER_PORT')}: {e} "
            "(launch with torchrun, or unset RANK/WORLD_SIZE for one process)") from e
    return True


@contextlib.contextmanager
def process_group(device: str | torch.device = "cuda"):
    """``maybe_initialize_distributed(device)`` for a block, and the group it
    made destroyed on leaving (a group that existed before is left as it
    is)."""
    existed = dist.is_available() and dist.is_initialized()
    maybe_initialize_distributed(device)
    try:
        yield
    finally:
        if not existed and dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


@contextlib.contextmanager
def whole_batch():
    """Every rank holds the whole batch inside (as after a spatial sampler's
    gather): ``draw_rows`` draws it as one process would."""
    token = _WHOLE.set(True)
    try:
        yield
    finally:
        _WHOLE.reset(token)


def world_size() -> int:
    """Ranks in the default group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_device(device: str | torch.device = "cuda") -> torch.device:
    """The device this rank drives: ``cuda:LOCAL_RANK`` for a CUDA ``device``
    under a launch (``cuda`` otherwise), and the CPU as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def make_mesh(n_devices: int | None = None):
    """The 1D ``("data",)`` mesh over the world (``n_devices``, when given,
    must be the world size: one process drives one device)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = _mesh_size(n_devices)
    return init_device_mesh(_mesh_device_type(), (n,), mesh_dim_names=("data",))


def make_hybrid_mesh(num_slices: int, n_devices: int | None = None):
    """The 2D ``("replica", "data")`` mesh: ``num_slices`` groups of
    consecutive ranks (a node's local ranks are consecutive under torchrun,
    so ``data`` stays inside a node and ``replica`` crosses nodes).  Data
    parallelism all-reduces over both axes; FSDP over this mesh is HSDP,
    which shards parameters over ``data`` and replicates them over
    ``replica``.  ``ValueError`` when ``num_slices`` does not divide the
    world."""
    from torch.distributed.device_mesh import init_device_mesh

    n = _mesh_size(n_devices)
    if num_slices < 1 or n % num_slices:
        raise ValueError(f"num_slices={num_slices} must divide the device count {n}")
    return init_device_mesh(_mesh_device_type(), (num_slices, n // num_slices),
                            mesh_dim_names=("replica", "data"))


def _mesh_size(n_devices: int | None) -> int:
    n = world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} devices over a world of {n} ranks: one "
                         "process drives one device")
    return n


def _mesh_device_type() -> str:
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return "cuda"
    return "cpu"


def local_batch_slice(global_batch: int) -> slice:
    """The rows of a global batch that this rank owns.

    Raises when the global batch does not divide evenly across the ranks:
    flooring ``global_batch // n`` would drop the remainder rows on every
    rank."""
    n, r = world_size(), rank()
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} is not divisible by the {n} participating hosts; "
            f"{global_batch % n} rows would be silently dropped. Use a divisible batch size "
            "(or drop_last=True in the loader).")
    per = global_batch // n
    return slice(r * per, (r + 1) * per)


def draw_rows(draw, *args, **kwargs) -> torch.Tensor:
    """``draw(*args, **kwargs)`` (``torch.randn``, ``torch.rand``,
    ``torch.randint``; the shape is the last positional argument, its first
    axis this rank's rows) drawn at the global batch's shape and cut to this
    rank's rows: with one generator state on every rank, the ranks' rows
    together are the 1-rank draw at the global batch.  The plain draw at
    world size 1.  Under ``spatial.spatial_scope`` the draw is cut to this
    rank's block of the mesh (``spatial.draw_block``); under ``whole_batch``
    it is the plain draw."""
    from tqdne_tpu_torch.parallel import spatial  # which imports this module

    if spatial.current() is not None:
        return spatial.draw_block(draw, *args, **kwargs)
    n = world_size()
    if n == 1 or _WHOLE.get():
        return draw(*args, **kwargs)
    *lead, shape = args
    rows = shape[0]
    full = draw(*lead, (rows * n, *shape[1:]), **kwargs)
    r = rank()
    return full[r * rows:(r + 1) * rows]


@torch.no_grad()
def replicate_(module: torch.nn.Module, src: int = 0) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank ``src``, so
    every rank starts from the same values (the JAX ``replicate``)."""
    if world_size() > 1:
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src)
    return module


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


@torch.no_grad()
def all_reduce_gradients_(params, replicas: int | None = None) -> None:
    """Sum the gradients of ``params`` over the world and divide them by
    ``replicas`` (default: the world size, which averages them), one flat
    bucket per dtype and device (one collective each, not one per tensor).
    Under spatial partitioning ``replicas`` is the mesh's data size: the sum
    over the model group is the gradient of a sample, then the data ranks
    average.  Gradients FSDP manages (DTensors) are skipped: its
    reduce-scatter has averaged them already.  Nothing happens at world size
    1."""
    n = world_size()
    if n == 1:
        return
    buckets: dict = {}
    for p in params:
        if p.grad is not None and not _is_dtensor(p.grad):
            buckets.setdefault((p.grad.dtype, p.grad.device), []).append(p.grad)
    for grads in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat.div_(replicas or n)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the world, on ``t``'s device (a new tensor,
    without gradient; ``t`` itself at world size 1)."""
    if world_size() == 1:
        return t
    out = _on_collective_device(t.detach().clone())
    dist.all_reduce(out)
    return out.to(t.device)


def _on_collective_device(t: torch.Tensor) -> torch.Tensor:
    """``t``, moved to the card when it is on the host and the backend is
    ``nccl``, which reduces only there."""
    if t.device.type == "cpu" and dist.get_backend() == "nccl":
        return t.cuda()
    return t


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``t`` set in place to rank ``src``'s (through the card for ``nccl``)."""
    if world_size() > 1:
        moved = _on_collective_device(t)
        dist.broadcast(moved, src)
        if moved is not t:
            t.copy_(moved)
    return t


def all_reduce_max_(t: torch.Tensor) -> torch.Tensor:
    """``t`` set in place to its maximum over the world."""
    if world_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated on the first
    axis in rank order; ``t`` at world size 1."""
    n = world_size()
    if n == 1:
        return t
    src = _on_collective_device(t.contiguous())
    out = src.new_empty((n * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, src)
    return out.to(t.device)


def barrier() -> None:
    """Wait for every rank (nothing at world size 1)."""
    if world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
