"""Meshes: row-sharded and rows x dim datasets over several devices.

Port of sqlite_vector_tpu/parallel/. One process drives every device of a
mesh (FAISS's IndexShards design, and the JAX package's single-controller
API): shard i of a dataset's rows lives on the mesh's i-th device, each
scan runs K1 or K2 on every shard back to back, and one merge of the
shards' [B, k] candidates on the first device picks the result. A 2-D
(rows x dim) mesh also splits the features, summing partial components
over the dim axis. See mesh.py, shards.py, ops.py; audit.py counts the
bytes each merge gathers (the JAX package's HLO audits have no
counterpart: there is no compiled HLO to read).
"""

from sqlite_vector_tpu_torch.parallel.audit import (
    GATHERED,
    collective_bytes_per_query,
)
from sqlite_vector_tpu_torch.parallel.mesh import (
    DIM_AXIS,
    ROWS_AXIS,
    Mesh,
    Placement,
    block_sharding_2d,
    dim_sharding_2d,
    make_mesh,
    make_mesh_2d,
    replicated_sharding,
    row_sharding,
)
from sqlite_vector_tpu_torch.parallel.ops import (
    sharded_int4_scan_distances,
    sharded_int4_scan_topk,
    sharded_scan_distances,
    sharded_scan_distances_2d,
    sharded_scan_topk,
    sharded_scan_topk_2d,
)
from sqlite_vector_tpu_torch.parallel.shards import RowShards

__all__ = [
    "DIM_AXIS",
    "GATHERED",
    "Mesh",
    "Placement",
    "ROWS_AXIS",
    "RowShards",
    "block_sharding_2d",
    "collective_bytes_per_query",
    "dim_sharding_2d",
    "make_mesh",
    "make_mesh_2d",
    "replicated_sharding",
    "row_sharding",
    "sharded_int4_scan_distances",
    "sharded_int4_scan_topk",
    "sharded_scan_distances",
    "sharded_scan_distances_2d",
    "sharded_scan_topk",
    "sharded_scan_topk_2d",
]
