"""Sharded execution over a ``(data, space, disp)`` mesh of devices."""

from gpu_stereo_matching_tpu_torch.parallel.mesh import (  # noqa: F401
    DeviceMesh,
    build_mesh,
    process_mesh,
    virtual_cpu_mesh,
    virtual_mesh,
)
from gpu_stereo_matching_tpu_torch.parallel.stereo import (  # noqa: F401
    ShardedBatch,
    make_sharded_block_matching,
    make_sharded_block_matching_full,
    own_pieces,
    shard_batch,
    unshard,
)
