"""Batching and multi-device segmentation (port of `gseg_tpu/parallel/`).

  - `batching`: `segment_batch` / `segment_batch_flagged` (one image after
    another on one device) and `segment_batch_sharded` over a
    `data_parallel_mesh`;
  - `spatial`: the atomic path on one image row-sharded over a
    `spatial_mesh` (`segment_spatial`), and `multichip_step` over a 2-D
    (data x space) mesh;
  - `turbo_spatial`: the turbo path row-sharded with explicit halo
    exchange (`segment_turbo_spatial`);
  - `mesh`: the meshes and the rank threads with their collectives.

A mesh is a list of devices (a device may repeat), driven by one process,
as the reference's single-controller meshes are.
"""

from .batching import (data_parallel_mesh, segment_batch,
                       segment_batch_flagged, segment_batch_sharded)
from .mesh import Mesh
from .spatial import multichip_step, segment_spatial, spatial_mesh
from .turbo_spatial import segment_turbo_spatial

__all__ = ["Mesh", "data_parallel_mesh", "multichip_step", "segment_batch",
           "segment_batch_flagged", "segment_batch_sharded",
           "segment_spatial", "segment_turbo_spatial", "spatial_mesh"]
