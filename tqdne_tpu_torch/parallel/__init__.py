"""Parallelism over ``torch.distributed``: the port of ``tqdne_tpu/parallel/``
(``mesh``: data parallelism and the meshes; ``fsdp``; ``spatial``: spatial
partitioning of one sample's rows over a ``("data", "model")`` mesh)."""

from tqdne_tpu_torch.parallel.mesh import (  # noqa: F401
    all_gather_rows,
    all_reduce_gradients_,
    all_reduce_max_,
    all_reduce_sum,
    barrier,
    broadcast_,
    draw_rows,
    local_batch_slice,
    local_device,
    make_hybrid_mesh,
    make_mesh,
    maybe_initialize_distributed,
    process_group,
    rank,
    replicate_,
    whole_batch,
    world_size,
)
