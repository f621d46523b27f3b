"""Row-sharded arrays over a mesh (what jax.Array's sharding gives the JAX
package).

RowShards holds a [rows, ...] array split by rows over R devices: shard i
is a tensor on its device holding global rows [i * shard_rows, (i + 1) *
shard_rows), the JAX layout position for position (rows = capacity, a
multiple of R). A 2-D mesh's matrices are also split by columns: shard i
is then C column blocks, block c on the device (i, c) of the grid, each of
the same width, the columns past `width` zero (distance-neutral for every
metric; quantized pad columns are zeroed again after quantizing).

The operations are the few the Dataset needs: build from host rows or a
device tensor, write rows in place (an append moves only the new rows),
gather rows by global position, scatter rows into a copy, re-lay the rows
out at another capacity (compaction, growth), read a row range back to the
host. Writers never touch a block a concurrent search may hold, except
append's rows past the count that search snapshotted; scatter and take
build new blocks and share the untouched ones.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from sqlite_vector_tpu_torch.device import from_numpy


def split_rows(t: torch.Tensor, shard_rows: int, devices: Sequence[torch.device], fill=0) -> list[torch.Tensor]:
    """A [L, ...] tensor as len(devices) shards of shard_rows rows, shard i
    on devices[i]: rows past L read `fill`, rows past the shards are cut
    (a row mask built before a concurrent add() is shorter than the rows
    scanned; those rows stay excluded)."""
    total = shard_rows * len(devices)
    if t.shape[0] < total:
        t = torch.cat([t, t.new_full((total - t.shape[0], *t.shape[1:]), fill)])
    return [t[i * shard_rows : (i + 1) * shard_rows].to(d, non_blocking=True) for i, d in enumerate(devices)]


class RowShards:
    """A row-sharded (and on a 2-D mesh also column-blocked) array.

    blocks[i][c] is shard i's column block c; every shard has shard_rows
    rows and every column block one width. `width` is the array's true
    column count (the blocks' widths sum to it rounded up to C), None for
    a 1-D array (per-row vectors and masks, which are never column-split)."""

    def __init__(self, blocks: list[list[torch.Tensor]], width: int | None = None):
        self.blocks = blocks
        self.width = width
        first = blocks[0][0]
        self.shard_rows = int(first.shape[0])
        self.dtype = first.dtype
        self.n_shards = len(blocks)
        cols = sum(int(b.shape[1]) for b in blocks[0]) if first.dim() > 1 else None
        self.shape = (self.shard_rows * self.n_shards,) + (() if cols is None else (cols,))
        # bumped by every in-place write, after its rows are queued: a value
        # derived from the rows (a 2-D mesh's cached norms) is current only
        # if it was derived at this version
        self.version = 0

    # -- construction -------------------------------------------------------

    @classmethod
    def zeros(
        cls, grid: list[list[torch.device]], rows: int, width: int | None, dtype: torch.dtype
    ) -> "RowShards":
        """rows (a multiple of len(grid)) zero rows of `width` columns
        (None: a 1-D array) on a grid of R x C devices."""
        r, c = len(grid), len(grid[0])
        if rows % r:
            raise ValueError(f"RowShards: {rows} rows do not split over {r} shards")
        sr = rows // r
        bw = None if width is None else -(-width // c)
        shape = (sr,) if width is None else (sr, bw)
        return cls([[torch.zeros(shape, dtype=dtype, device=d) for d in row] for row in grid], width)

    @classmethod
    def from_host(
        cls, arr: Any, count: int, rows: int, grid: list[list[torch.device]], first: int = 0
    ) -> "RowShards":
        """Rows [first, first + count) of a host array (numpy, np.memmap or
        ShardedRows; bfloat16 as uint16 bits) as `rows` rows (zero past
        count) on the grid; each shard's rows travel straight to its
        device through the streamed scans' tiles (ops.streaming.upload_rows)."""
        from sqlite_vector_tpu_torch.ops.streaming import upload_rows

        r = len(grid)
        if rows % r:
            raise ValueError(f"RowShards: {rows} rows do not split over {r} shards")
        sr = rows // r
        width = int(arr.shape[1]) if len(arr.shape) > 1 else None
        blocks = []
        for i, row in enumerate(grid):
            n = min(max(count - i * sr, 0), sr)
            whole = upload_rows(arr, n, row[0], sr, first=first + i * sr)
            blocks.append(_column_blocks(whole, row))
        return cls(blocks, width)

    @classmethod
    def from_tensor(cls, t: torch.Tensor, grid: list[list[torch.device]]) -> "RowShards":
        """A [rows, ...] tensor (rows a multiple of len(grid)) on the grid."""
        r = len(grid)
        if t.shape[0] % r:
            raise ValueError(f"RowShards: {t.shape[0]} rows do not split over {r} shards")
        sr = t.shape[0] // r
        width = int(t.shape[1]) if t.dim() > 1 else None
        return cls([_column_blocks(t[i * sr : (i + 1) * sr], row) for i, row in enumerate(grid)], width)

    # -- properties ---------------------------------------------------------

    @property
    def grid(self) -> list[list[torch.device]]:
        return [[b.device for b in row] for row in self.blocks]

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for row in self.blocks for b in row)

    def part(self, i: int) -> torch.Tensor:
        """Shard i of an array with one column block."""
        (block,) = self.blocks[i]
        return block

    def parts(self) -> list[torch.Tensor]:
        return [self.part(i) for i in range(self.n_shards)]

    # -- rows ---------------------------------------------------------------

    def _pieces(self, start: int, end: int):
        """(shard, lo, hi, at): the local rows [lo, hi) of each shard that
        global rows [start, end) cover, `at` their offset in the range."""
        sr = self.shard_rows
        for i in range(start // sr, min(-(-end // sr), self.n_shards)):
            lo, hi = max(start - i * sr, 0), min(end - i * sr, sr)
            if hi > lo:
                yield i, lo, hi, i * sr + lo - start

    def write(self, start: int, rows: torch.Tensor) -> None:
        """Rows [start, start + len(rows)) written IN PLACE (append: the
        rows past every snapshotted count); only these rows move."""
        for i, lo, hi, at in self._pieces(start, start + rows.shape[0]):
            piece = _pad_columns(rows[at : at + hi - lo], self.blocks[i])
            for blk, part in zip(self.blocks[i], _split_columns(piece, self.blocks[i])):
                blk[lo:hi].copy_(part, non_blocking=True)
        self.version += 1

    def read(self, start: int, end: int) -> torch.Tensor:
        """Rows [start, end) on the CPU, at the true width."""
        out = [
            torch.cat([b[lo:hi].cpu() for b in self.blocks[i]], dim=1)
            if self.width is not None else self.blocks[i][0][lo:hi].cpu()
            for i, lo, hi, _ in self._pieces(start, end)
        ]
        if not out:
            shape = (0,) if self.width is None else (0, self.width)
            return torch.zeros(shape, dtype=self.dtype)
        t = torch.cat(out)
        return t if self.width is None else t[:, : self.width]

    def _gather_column(self, pos: np.ndarray, c: int, device: torch.device) -> torch.Tensor:
        """Column block c of global rows `pos` on `device`."""
        ref = self.blocks[0][c]
        out = torch.empty((len(pos), *ref.shape[1:]), dtype=ref.dtype, device=device)
        sr = self.shard_rows
        for i in np.unique(pos // sr):
            sel = np.flatnonzero(pos // sr == i)
            blk = self.blocks[int(i)][c]
            rows = blk.index_select(0, from_numpy(pos[sel] - int(i) * sr, blk.device)).to(device)
            if len(sel) == len(pos):
                return rows
            out[from_numpy(sel, device)] = rows
        return out

    def gather(self, pos: np.ndarray, device: torch.device | None = None) -> torch.Tensor:
        """Global rows `pos` (int64, each below the rows) on `device`
        (default: the first shard's), at the true width."""
        pos = np.asarray(pos, np.int64)
        device = self.blocks[0][0].device if device is None else device
        cols = [self._gather_column(pos, c, device) for c in range(len(self.blocks[0]))]
        if self.width is None:
            return cols[0]
        return torch.cat(cols, dim=1)[:, : self.width]

    def scatter(self, pos: np.ndarray, rows: torch.Tensor) -> "RowShards":
        """A copy with global rows `pos` (unique) replaced by `rows` (on the
        CPU): the touched shards are cloned and written, the rest shared."""
        pos = np.asarray(pos, np.int64)
        sr = self.shard_rows
        blocks = list(self.blocks)
        for i in np.unique(pos // sr):
            i = int(i)
            sel = np.flatnonzero(pos // sr == i)
            new = []
            piece = _pad_columns(rows[from_numpy(sel)], self.blocks[i])
            for blk, part in zip(self.blocks[i], _split_columns(piece, self.blocks[i])):
                blk = blk.clone()
                blk[from_numpy(pos[sel] - i * sr, blk.device)] = part.to(blk.device)
                new.append(blk)
            blocks[i] = new
        return RowShards(blocks, self.width)

    def take(self, index: np.ndarray, rows: int) -> "RowShards":
        """A new layout of `rows` rows (a multiple of the shard count) whose
        row j is this array's row index[j] for j < len(index), zero past
        it: compaction (the kept rows) and growth (every row, at a larger
        capacity, whose shard boundaries move)."""
        index = np.asarray(index, np.int64)
        r = self.n_shards
        if rows % r:
            raise ValueError(f"RowShards: {rows} rows do not split over {r} shards")
        sr = rows // r
        blocks = []
        for j, row in enumerate(self.grid):
            src = index[j * sr : (j + 1) * sr]
            new = []
            for c, dev in enumerate(row):
                ref = self.blocks[0][c]
                blk = torch.zeros((sr, *ref.shape[1:]), dtype=ref.dtype, device=dev)
                if len(src):
                    blk[: len(src)] = self._gather_column(src, c, dev)
                new.append(blk)
            blocks.append(new)
        return RowShards(blocks, self.width)


def _column_blocks(t: torch.Tensor, row: list[torch.device]) -> list[torch.Tensor]:
    """One shard's rows split into len(row) column blocks (zero-padded to a
    multiple of it), block c on row[c]; a 1-D array stays whole."""
    if t.dim() == 1 or len(row) == 1:
        return [t.to(row[0])]
    c = len(row)
    bw = -(-t.shape[1] // c)
    if bw * c != t.shape[1]:
        t = torch.cat([t, t.new_zeros((t.shape[0], bw * c - t.shape[1]))], dim=1)
    return [t[:, j * bw : (j + 1) * bw].contiguous().to(d) for j, d in enumerate(row)]


def _pad_columns(rows: torch.Tensor, shard: list[torch.Tensor]) -> torch.Tensor:
    """Rows zero-padded to a shard's column count."""
    if rows.dim() == 1:
        return rows
    cols = sum(int(b.shape[1]) for b in shard)
    if rows.shape[1] == cols:
        return rows
    return torch.cat([rows, rows.new_zeros((rows.shape[0], cols - rows.shape[1]))], dim=1)


def _split_columns(rows: torch.Tensor, shard: list[torch.Tensor]) -> list[torch.Tensor]:
    """Full-width rows cut into a shard's column blocks, each on its device."""
    if rows.dim() == 1:
        return [rows.to(shard[0].device)]
    out, at = [], 0
    for b in shard:
        w = int(b.shape[1])
        out.append(rows[:, at : at + w].to(b.device))
        at += w
    return out
