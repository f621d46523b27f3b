"""Cross-device traffic of the sharded scans.

Port of sqlite_vector_tpu/parallel/audit.py's accounting. The JAX package
proves its traffic from the compiled HLO (parse_collectives,
audit_sharded_*); the port has no HLO to read, so it counts what its merge
gathers instead, call by call, in GATHERED:

  merge    each sharded top-k ships every shard's [B, k] float32 values
           and int32 global positions to the mesh's first device: 8 * D *
           B * k bytes, the output of the JAX package's two all-gathers
           (collective_bytes_per_query);
  dim_sum  a 2-D (rows x dim) top-k also sums [B, rows] partial components
           over the dim axis; it is counted as the JAX package's analytic
           figure, 4 * B * ceil(valid / R) bytes a scan (its QueryStats
           term: one row group's float32 block under an even split of the
           valid rows), so the two packages' counts compare.
"""

from __future__ import annotations


def collective_bytes_per_query(n_devices: int, batch: int, k: int) -> int:
    """The candidate merge of one 1-D sharded top-k: every device's [B, k]
    float32 values and int32 positions, 8 * D * B * k bytes."""
    return 8 * n_devices * batch * k


class GatherCounter:
    """Bytes the sharded scans gathered for their merges since reset()."""

    def __init__(self) -> None:
        self.merge = 0
        self.dim_sum = 0

    def reset(self) -> None:
        self.merge = 0
        self.dim_sum = 0

    @property
    def total(self) -> int:
        return self.merge + self.dim_sum


GATHERED = GatherCounter()
