"""Sharded rendering over torch.distributed (port of
`cpupathtrace_tpu/parallel/`): (dp, sp) meshes, sharded and adaptive
renders, geometry-parallel shards, the sharded training step and elastic
resume. Not imported by the package's top level, as the JAX package's is
not."""
from .geometry import make_gp_mesh, render_chunk_gp, render_gp, shard_scene_geometry
from .failover import ping_mesh, render_resumable_elastic
from .mesh import make_render_mesh
from .render import (
    adaptive_sample_axis,
    render_chunk_batched_sharded,
    render_chunk_sharded,
    render_sharded,
    render_sharded_adaptive,
)
