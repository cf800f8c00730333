"""Multi-device face of the port: batches split over a list of devices.

Public surface (the JAX package's names):
- make_mesh / make_mesh_2d: device meshes (every CUDA device by default)
- ShardedScanPipeline (via ScanPipeline.sharded(mesh)): the planar
  projection kernel on each device's shard
- shard_frames: leading-axis split helper
- sharded_pipeline: the packet-layout pipeline over a sharded batch
- sharded_multi_sensor_step: (sensor, frame) 2-D mesh step with per-sensor
  LUTs and a global centroid
- fuse_multi_sensor_clouds: extrinsics fan-in, gathered
"""

from .sharding import (  # noqa: F401
    Mesh,
    Sharded,
    ShardedScanPipeline,
    fuse_multi_sensor_clouds,
    make_mesh,
    make_mesh_2d,
    shard_frames,
    sharded_multi_sensor_step,
    sharded_pipeline,
)

__all__ = [
    "Mesh",
    "Sharded",
    "ShardedScanPipeline",
    "fuse_multi_sensor_clouds",
    "make_mesh",
    "make_mesh_2d",
    "shard_frames",
    "sharded_multi_sensor_step",
    "sharded_pipeline",
]
