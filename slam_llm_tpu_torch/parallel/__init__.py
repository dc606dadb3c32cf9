from slam_llm_tpu_torch.parallel.sharding import (  # noqa: F401
    MESH_AXES,
    make_mesh,
    replicated,
    shard_batch,
    shard_params,
)
