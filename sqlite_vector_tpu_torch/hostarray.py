"""Lazy row-concatenated view over host-resident (mmap) shard arrays.

A copy of sqlite_vector_tpu/hostarray.py (importing that module loads jax
through its package __init__) without its `astype` and `iter_tiles`, which
nothing in the port calls, plus `read_into`, which the streaming scan
(ops/streaming.py) uses to copy a tile's rows straight into its pinned
staging buffer.

The analogue of the reference's chunked `vector0_*` blobs staying on disk
until a scan touches them (src/sqlite-vector.c:1967-1997): a sharded,
memory-mapped dataset must be scannable WITHOUT materializing the full
matrix in RAM. `ShardedRows` presents a read-only `[N, dim]` array-like
whose row slices copy only the touched rows, so peak RAM is one tile
regardless of dataset size.
"""

from __future__ import annotations

import numpy as np


class ShardedRows:
    """Read-only row-wise concatenation of 2-D arrays (e.g. np.memmap shards).

    Supports the operations the streaming scan and persistence paths use:
    `.shape`, `.dtype`, `.ndim`, `len()`, integer-row and row-slice indexing
    (`a[i]`, `a[start:stop]`, `a[rows_array]`). Slices return materialized
    np.ndarray copies of just the touched rows.
    """

    def __init__(self, parts: list[np.ndarray]):
        if not parts:
            raise ValueError("ShardedRows needs at least one shard")
        if parts[0].ndim != 2:
            raise ValueError("shards must be 2-D [rows, dim] arrays")
        dim = parts[0].shape[1]
        dtype = parts[0].dtype
        for p in parts:
            if p.ndim != 2 or p.shape[1] != dim or p.dtype != dtype:
                raise ValueError("shards must share dtype and row width")
        self._parts = parts
        self._starts = np.cumsum([0] + [p.shape[0] for p in parts])
        self.shape = (int(self._starts[-1]), int(dim))
        self.dtype = dtype
        self.ndim = 2

    def __len__(self) -> int:
        return self.shape[0]

    def view(self, dtype) -> "ShardedRows":
        """Row-preserving dtype reinterpret (the bf16-bits-as-uint16 load)."""
        return ShardedRows([p.view(dtype) for p in self._parts])

    def _pieces(self, start: int, stop: int):
        """(shard, lo, hi) row ranges covering rows [start, stop)."""
        start = max(0, min(start, self.shape[0]))
        stop = max(start, min(stop, self.shape[0]))
        i = int(np.searchsorted(self._starts, start, side="right") - 1)
        while i < len(self._parts) and self._starts[i] < stop:
            lo = max(start - self._starts[i], 0)
            hi = min(stop - self._starts[i], self._parts[i].shape[0])
            yield self._parts[i], lo, hi
            i += 1

    def _slice_rows(self, start: int, stop: int) -> np.ndarray:
        out_parts = [p[lo:hi] for p, lo, hi in self._pieces(start, stop)]
        if len(out_parts) == 1:
            # np.array(copy=True): the documented contract is a materialized
            # COPY — a within-one-shard view would alias the backing mmap
            return np.array(out_parts[0])
        if not out_parts:
            return np.zeros((0, self.shape[1]), self.dtype)
        return np.concatenate(out_parts)

    def read_into(self, start: int, out: np.ndarray) -> None:
        """Copy rows [start, start + len(out)) into `out`, shard by shard,
        with no intermediate copy."""
        at = 0
        for p, lo, hi in self._pieces(start, start + len(out)):
            np.copyto(out[at : at + hi - lo], p[lo:hi])
            at += hi - lo
        if at != len(out):
            raise IndexError(
                f"ShardedRows.read_into: rows [{start}, {start + len(out)}) "
                f"past {self.shape[0]} rows"
            )

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self.shape[0])
            if step != 1:
                raise IndexError("ShardedRows supports step-1 slices only")
            return self._slice_rows(start, stop)
        if isinstance(key, (int, np.integer)):
            if key < 0:
                key += self.shape[0]
            return self._slice_rows(int(key), int(key) + 1)[0]
        if isinstance(key, tuple):
            # v[i, j] would silently gather rows i and j — reject numpy
            # idioms this substitute doesn't implement rather than return
            # wrong data
            raise IndexError(
                "ShardedRows supports row indexing only (no multi-axis keys)"
            )
        # fancy row indexing (rerank candidate gathers): gather per shard
        idx = np.asarray(key)
        if idx.ndim != 1:
            raise IndexError("ShardedRows supports 1-D fancy indexing only")
        if idx.dtype == bool or not np.issubdtype(idx.dtype, np.integer):
            # bool masks would cast True/False to rows 1/0 and float arrays
            # would truncate — both silently wrong vs the np.ndarray
            # contract; fail loudly instead
            raise IndexError(
                "ShardedRows fancy indexing takes integer row arrays "
                "(boolean masks and float indices are not supported)"
            )
        # normalize negatives like np.ndarray (the substitute contract)
        idx = np.where(idx < 0, idx + self.shape[0], idx).astype(np.int64)
        if len(idx) and (idx.min() < 0 or idx.max() >= self.shape[0]):
            raise IndexError(
                f"index out of bounds for ShardedRows of {self.shape[0]} rows"
            )
        part_of = np.searchsorted(self._starts, idx, side="right") - 1
        out = np.empty((len(idx), self.shape[1]), self.dtype)
        for pi in np.unique(part_of):
            sel = part_of == pi
            out[sel] = self._parts[pi][idx[sel] - self._starts[pi]]
        return out
