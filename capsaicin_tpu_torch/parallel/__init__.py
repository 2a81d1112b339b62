from .sharding import (  # noqa: F401
    ROWS,
    build_sharded_step,
    halo_map,
    make_mesh,
    replicated,
    row_sharding,
    shard_frame_state,
    shard_scene,
    shard_trace,
)
