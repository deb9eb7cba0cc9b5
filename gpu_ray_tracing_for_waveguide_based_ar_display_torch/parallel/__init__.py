from .shard import (  # noqa: F401
    make_mesh, make_sharded_trace_fn, pad_rays_to, shard_ray_batch,
)
