"""Data parallelism over ``torch.distributed``: the port of
``tqdne_tpu/parallel/`` (``mesh`` and ``fsdp``).  Spatial partitioning
(``parallel/spatial.py``) is not ported yet."""

from tqdne_tpu_torch.parallel.mesh import (  # noqa: F401
    all_gather_rows,
    all_reduce_gradients_,
    all_reduce_max_,
    all_reduce_sum,
    barrier,
    draw_rows,
    local_batch_slice,
    local_device,
    make_hybrid_mesh,
    make_mesh,
    maybe_initialize_distributed,
    process_group,
    rank,
    replicate_,
    world_size,
)
