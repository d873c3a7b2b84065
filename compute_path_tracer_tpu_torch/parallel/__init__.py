"""Distribution over ``torch.distributed`` (JAX package: ``parallel/``):
row-band and sample sharding, gradient collectives, multi-process
bring-up and checkpoint recovery."""

from .distributed import (
    initialize_distributed,
    local_device_info,
    run_with_checkpoint_recovery,
)
from .mesh import (
    TILE_AXIS,
    make_mesh,
    make_fused_sharded_train_step,
    make_sharded_frame_fn,
    make_sharded_train_step,
    render_frame_sharded,
    render_samples_sharded,
)

__all__ = [
    "initialize_distributed",
    "local_device_info",
    "run_with_checkpoint_recovery",
    "TILE_AXIS",
    "make_mesh",
    "make_fused_sharded_train_step",
    "make_sharded_frame_fn",
    "make_sharded_train_step",
    "render_frame_sharded",
    "render_samples_sharded",
]
