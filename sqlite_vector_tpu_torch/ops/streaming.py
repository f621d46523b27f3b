"""Host -> device streaming scans for host-storage datasets.

Port of sqlite_vector_tpu/ops/streaming.py (streaming_scan_topk,
streaming_scan_distances) and of sqlite_vector_tpu/ops/quantize4.py:441
int4_streaming_scan_topk: the rows (or the codes) live in host RAM or in
memory-mapped files, and each scan walks them in row tiles through the
device with a running top-k, the analogue of the reference's disk-chunk
path (src/sqlite-vector.c:1967-1997). Each tile is scanned by the same
routers as device-resident rows (ops.scan.fused_scan_topk: K1 on CUDA
tensors; ops.quantize4.int4_scan_topk: K2), and tiles merge through
ops.topk.merge_topk, whose running (earlier-scanned) set wins ties, so
the earliest row wins equal distances as in one scan.

The pipeline (_Tiles) is built for the card, not copied from the JAX loop
(which relied on jax.device_put being asynchronous). A copy from pageable
or memory-mapped memory is synchronous, so each tile is first staged by
the host into one of two pinned buffers (np.copyto into the buffer's
numpy view, straight from the memmap or the ShardedRows shards, split
over STAGING_THREADS threads), then
copied with non_blocking=True on a side stream into one of two device
buffers; an event makes the scan on the current stream wait for its
tile's copy. The host stages tile i+1 while the device scans tile i. A
pinned buffer is refilled only after the copy that read it has completed,
and a device buffer is overwritten only after the scan that read it has
completed (events both), so no tile in flight is ever overwritten. The
device buffers come from the caching allocator on the current stream, so
the side stream first waits for the work queued there (a freed block may
still be in use by it), and the current stream waits for the side stream
before the buffers go back. The
last tile is not padded: the kernels take any row count. A row mask goes
to the device with its tile. On CPU tensors the same loop stages each tile
and scans it with the kernels' plain twins.

With a 1-D mesh (mesh=; the JAX package's _placement,
sqlite_vector_tpu/ops/streaming.py:44) the rows split into one contiguous run
a shard, and each run streams through its own pipeline (its own side
stream, pinned buffers and events) to its shard's device, one tile of
each run in turn; the shards' running top-k merge as the resident mesh
scan's do (parallel.ops.merge_candidates).

bfloat16 rows are held on the host as their uint16 bits (the port's host
form, device.bf16_bits) and reinterpreted on the device.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Sequence

import numpy as np
import torch

from sqlite_vector_tpu_torch.hostarray import ShardedRows
from sqlite_vector_tpu_torch.ops.quantize4 import int4_scan_distances, int4_scan_topk
from sqlite_vector_tpu_torch.ops.scan import fused_scan_topk, scan_distances
from sqlite_vector_tpu_torch.ops.topk import merge_topk
from sqlite_vector_tpu_torch.types import DistanceMetric, VectorType
from sqlite_vector_tpu_torch.utils.profiling import count

# Bytes per streamed tile (of all the streamed arrays' rows) when
# tile_rows is not given. Each tile costs the host a few ms of launches
# beside its staging, so larger tiles stream faster: on an H100 80GB HBM3
# (700 W, 8-core host) a 6.1 GB pass took 0.446 / 0.297 / 0.293, 0.392 /
# 0.270 / 0.243 and 0.367 / 0.262 / 0.210 s at 256 MiB / 512 MiB / 1 GiB
# tiles in three runs (PERF.md, chip_smoke.py phase 9). Two pinned and two
# device buffers of this size live for the scan: 2 GiB of the card's 80.
DEFAULT_TILE_BYTES = 1 << 30


def _usable_cpus() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity call on this platform
        return os.cpu_count() or 1


# Host threads that stage one tile, each copying a slice of its rows
# (np.copyto releases the GIL): one thread copies a page-cached memory map
# at ~6-8 GB/s, far below the ~40-50 GB/s pinned link. On the 8-core host
# above the same pass took 0.963 / 0.345 / 0.237 s with 1 / 4 / 8 threads
# (PERF.md, phase 9): one thread per usable core, up to the 8 measured.
# Tiles under _SPLIT_BYTES stage on one thread.
STAGING_THREADS = min(8, _usable_cpus())
_SPLIT_BYTES = 8 << 20

# Streamed global positions are int32 in the JAX package (matching its scan
# kernels); the port keeps the bound so both accept the same datasets.
_MAX_STREAM_ROWS = 2**31 - 1

# numpy dtype name of a host array -> torch dtype of its staging buffer;
# uint16 is bfloat16 bits (as is an ml_dtypes bfloat16 array, read as bits)
_TORCH_DTYPE = {
    "float32": torch.float32,
    "float16": torch.float16,
    "uint16": torch.int16,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int32": torch.int32,
}


def _check_stream_bounds(n: int) -> None:
    if n > _MAX_STREAM_ROWS:
        raise ValueError(
            f"streaming scan: {n} rows exceeds the int32 position space "
            f"({_MAX_STREAM_ROWS}); shard the dataset (multiple Datasets / "
            "a mesh) instead"
        )


def default_tile_rows(arrays: Sequence[Any]) -> int:
    """Rows per tile: DEFAULT_TILE_BYTES of all the streamed arrays' rows."""
    row_bytes = sum(a.dtype.itemsize * int(np.prod(a.shape[1:])) for a in arrays)
    return max(1, DEFAULT_TILE_BYTES // max(row_bytes, 1))


def _bits(a):
    """bfloat16 (ml_dtypes) rows read as their uint16 bits."""
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _read_rows(src, start: int, out: np.ndarray) -> None:
    """Rows [start, start + len(out)) of a host array into `out`."""
    if isinstance(src, ShardedRows):
        src.read_into(start, out)
    else:
        np.copyto(out, src[start : start + len(out)])


class _Tiles:
    """Iterate (start, rows, tensors, mask) over the row tiles of rows
    [first, first + n) of host arrays sharing their leading dimension:
    `tensors` holds each array's rows [start, start + rows) on `device`
    (uint16 bits as bfloat16), and `mask` the row mask's slice as a bool
    tensor (rows past the given mask are False), or None without a mask.
    A tile's tensors stay valid until the loop advances; the work the
    caller enqueues on the current stream in between is ordered after the
    tile's copy. Each instance has its own side stream, buffers and
    events, so instances on different devices never share one."""

    def __init__(self, arrays, n: int, tile_rows: int, device: torch.device, row_mask=None, first: int = 0):
        self.arrays = [_bits(a) for a in arrays]
        self.first = first
        self.n = n
        self.tile = max(1, min(int(tile_rows), n))
        self.ntiles = -(-n // self.tile)
        self.mask = row_mask
        self.device = device
        self.cuda = device.type == "cuda"
        shapes = [(self.tile, *a.shape[1:]) for a in self.arrays]
        dtypes = [_TORCH_DTYPE[a.dtype.name] for a in self.arrays]
        self.bf16 = [a.dtype.name == "uint16" for a in self.arrays]
        if row_mask is not None:
            shapes.append((self.tile,))
            dtypes.append(torch.bool)
        slots = 2 if self.ntiles > 1 else 1
        row_bytes = sum(a.dtype.itemsize * int(np.prod(a.shape[1:])) for a in self.arrays)
        split = STAGING_THREADS > 1 and self.tile * row_bytes >= _SPLIT_BYTES
        self.pool = ThreadPoolExecutor(STAGING_THREADS) if split else None
        # a failed pin raises: there is no pageable fallback
        self.host = [
            [torch.empty(s, dtype=t, pin_memory=self.cuda) for s, t in zip(shapes, dtypes)]
            for _ in range(slots)
        ]
        if self.cuda:
            self.dev = [
                [torch.empty(s, dtype=t, device=device) for s, t in zip(shapes, dtypes)]
                for _ in range(slots)
            ]
            self.copy_stream = torch.cuda.Stream(device)
            # the buffers' blocks may have been freed by work still queued
            # on the current stream: copy into them only after it
            self.copy_stream.wait_stream(torch.cuda.current_stream(device))
            self.copied = [torch.cuda.Event() for _ in range(slots)]
            self.consumed = [torch.cuda.Event() for _ in range(slots)]
        else:
            self.dev = self.host  # the CPU scans read the staged buffers

    def _stage(self, i: int) -> int:
        """Stage tile i on the host and, on CUDA, start its copy; returns
        its row count."""
        slot = i % len(self.host)
        start = self.first + i * self.tile
        rows = min(self.tile, self.first + self.n - start)
        reuse = i >= len(self.host)
        if self.cuda and reuse:
            self.copied[slot].synchronize()  # the last copy out of this buffer
        bufs = self.host[slot]
        for src, buf in zip(self.arrays, bufs):
            out = buf.numpy()[:rows].view(src.dtype)
            if self.pool is None:
                _read_rows(src, start, out)
            else:
                cuts = np.linspace(0, rows, STAGING_THREADS + 1).astype(int)
                # list(): every copy finished, and a failed one raises here
                list(self.pool.map(
                    lambda lo, hi: _read_rows(src, start + lo, out[lo:hi]), cuts[:-1], cuts[1:]
                ))
        if self.mask is not None:
            m = bufs[-1].numpy()[:rows]
            m[:] = False
            # clamp to the mask actually captured: a concurrent add() can
            # grow the scanned count past it; those rows stay excluded
            e = min(start + rows, len(self.mask))
            if e > start:
                m[: e - start] = self.mask[start:e]
        if self.cuda:
            with torch.cuda.stream(self.copy_stream):
                if reuse:  # the scan that last read this device buffer
                    self.copy_stream.wait_event(self.consumed[slot])
                for h, d in zip(bufs, self.dev[slot]):
                    d[:rows].copy_(h[:rows], non_blocking=True)
                    count("h2d_bytes", h[:rows].nbytes)
                self.copied[slot].record(self.copy_stream)
        return rows

    def __iter__(self):
        compute = torch.cuda.current_stream(self.device) if self.cuda else None
        try:
            rows = self._stage(0)
            for i in range(self.ntiles):
                slot = i % len(self.host)
                if self.cuda:
                    compute.wait_event(self.copied[slot])
                tensors = [d[:rows] for d in self.dev[slot]]
                mask = tensors.pop() if self.mask is not None else None
                tensors = [t.view(torch.bfloat16) if bf else t for t, bf in zip(tensors, self.bf16)]
                yield self.first + i * self.tile, rows, tensors, mask
                if self.cuda:
                    self.consumed[slot].record(compute)
                if i + 1 < self.ntiles:
                    # staged while the device scans tile i
                    rows = self._stage(i + 1)
        finally:
            if self.cuda:
                # a copy may still be in flight (the loop was left early):
                # the buffers go back to the allocator on the current stream
                compute.wait_stream(self.copy_stream)
            if self.pool is not None:
                self.pool.shutdown()


def upload_rows(
    arr, count: int, device: torch.device, cap: int | None = None, first: int = 0
) -> torch.Tensor:
    """Rows [first, first + count) of a host array (numpy, np.memmap or
    ShardedRows; bfloat16 as uint16 bits, which arrive as bfloat16) as a
    [cap, ...] tensor on `device`, zero past count (cap defaults to count),
    carried through the streamed scans' tiles: a memory map is never read
    whole into RAM, and on CUDA the rows travel through pinned buffers."""
    dtype = _TORCH_DTYPE[_bits(arr).dtype.name]
    dtype = torch.bfloat16 if dtype is torch.int16 else dtype
    shape = (count if cap is None else cap, *arr.shape[1:])
    out = (torch.empty if cap is None else torch.zeros)(shape, dtype=dtype, device=device)
    if count:
        tiles = _Tiles([arr], count, default_tile_rows([arr]), device, first=first)
        for start, rows, (t,), _ in tiles:
            out[start - first : start - first + rows].copy_(t)
    return out


def _runs(n: int, tile_rows: int, device: torch.device, mesh) -> tuple[list, int]:
    """(device, first row, row count) of each pipeline and the rows per
    tile: one pipeline over every row on `device`, or with a mesh one per
    row shard, shard i over the i-th ceil(n / D) rows on its device, with
    tiles of ceil(tile_rows / D) rows (the same bytes in flight)."""
    if mesh is None:
        return [(device, 0, n)], tile_rows
    from sqlite_vector_tpu_torch.parallel.ops import row_devices

    devices = row_devices(mesh)
    per = -(-n // len(devices))
    runs = [(d, i * per, min(per, max(n - i * per, 0))) for i, d in enumerate(devices)]
    return runs, -(-tile_rows // len(devices))


def _round_robin(arrays, runs, tile: int, row_mask, visit) -> None:
    """Walk every run's tiles, one tile of each run in turn, calling
    visit(run index, start, rows, tensors, mask): each pipeline has its
    own side stream and buffers, and the host stages one run's next tile
    while the devices scan the others'."""
    iters = [
        iter(_Tiles(arrays, cnt, tile, dev, row_mask, first=lo)) if cnt else iter(())
        for dev, lo, cnt in runs
    ]
    try:
        active = list(range(len(iters)))
        while active:
            for j in list(active):
                step = next(iters[j], None)
                if step is None:
                    active.remove(j)
                else:
                    visit(j, *step)
    finally:
        for it in iters:
            close = getattr(it, "close", None)
            if close is not None:
                close()


def _streamed_topk(
    scan, queries: torch.Tensor, arrays, n: int, k: int, row_mask, tile_rows, mesh=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """scan(queries, tensors, kk, mask) over the tiles of every run, a
    running top-k a run (the earlier rows win ties), then with a mesh the
    shards' merge (parallel.ops.merge_candidates) on the first device."""
    b = queries.shape[0]
    runs, tile = _runs(n, tile_rows or default_tile_rows(arrays), queries.device, mesh)
    vals = [torch.full((b, k), torch.inf, device=dev) for dev, _, _ in runs]
    idx = [torch.full((b, k), -1, dtype=torch.int64, device=dev) for dev, _, _ in runs]
    if n and k:
        _check_stream_bounds(n)
        qs = {dev: queries.to(dev, non_blocking=True) for dev, _, _ in runs}

        def visit(j, start, rows, tensors, mask):
            v, i = scan(qs[runs[j][0]], tensors, min(k, rows), mask)
            vals[j], idx[j] = merge_topk(vals[j], idx[j], v, torch.where(i >= 0, i + start, -1), k)

        _round_robin(arrays, runs, tile, row_mask, visit)
    if mesh is None:
        return vals[0], torch.where(torch.isposinf(vals[0]), -1, idx[0])
    from sqlite_vector_tpu_torch.parallel.ops import merge_candidates

    return merge_candidates(
        [(v, torch.where(torch.isposinf(v), -1, i).to(torch.int32)) for v, i in zip(vals, idx)],
        k, runs[0][0],
    )


def streaming_scan_topk(
    queries: torch.Tensor,
    host_vectors,
    metric: DistanceMetric,
    k: int,
    *,
    valid_count: int | None = None,
    row_mask: np.ndarray | None = None,
    tile_rows: int | None = None,
    policy_vtype: VectorType | None = None,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k over the first valid_count rows of a host [N, dim] array
    (numpy, np.memmap or ShardedRows; bfloat16 as uint16 bits), streamed
    by tiles to the device the queries [B, dim] lie on (their dtype is the
    rows'). Same contract as ops.scan.fused_scan_topk: (distances [B, k]
    float32, positions [B, k] int64) ascending, +inf / -1 padding. row_mask
    ([N] bool host array, optional) excludes rows where False; rows past
    its length are excluded. policy_vtype scans each tile under the
    non-finite policies (ops.scan.fused_scan_topk). With a 1-D `mesh`
    the rows split into one contiguous run a shard, each streamed to its
    shard's device and scanned there, and the shards' candidates merge on
    the first (sqlite_vector_tpu/ops/streaming.py:_placement)."""
    n = host_vectors.shape[0] if valid_count is None else int(valid_count)
    return _streamed_topk(
        lambda q, t, kk, m: fused_scan_topk(q, t[0], metric, kk, row_mask=m, policy_vtype=policy_vtype),
        queries, [host_vectors], n, k, row_mask, tile_rows, mesh,
    )


def int4_streaming_scan_topk(
    queries: torch.Tensor,
    packed_host,
    alpha_host,
    csq_host,
    metric: DistanceMetric,
    k: int,
    *,
    dim: int,
    valid_count: int | None = None,
    row_mask: np.ndarray | None = None,
    tile_rows: int | None = None,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The int4 scan over host-resident packed codes [N, ceil(dim/2)] u8
    with their alpha [N] f32 and csq [N] i32, streamed like
    streaming_scan_topk (each tile through ops.quantize4.int4_scan_topk:
    K2 on CUDA). queries: float32 [B, dim] on the target device; `mesh` as
    in streaming_scan_topk."""
    n = packed_host.shape[0] if valid_count is None else int(valid_count)
    return _streamed_topk(
        lambda q, t, kk, m: int4_scan_topk(q, *t, metric, kk, dim=dim, row_mask=m),
        queries, [packed_host, alpha_host, csq_host], n, k, row_mask, tile_rows, mesh,
    )


def _streamed_distances(dists, queries: torch.Tensor, arrays, n: int, tile_rows, mesh=None) -> np.ndarray:
    out = np.empty((queries.shape[0], n), np.float32)
    if n == 0:
        return out
    _check_stream_bounds(n)
    runs, tile = _runs(n, tile_rows or default_tile_rows(arrays), queries.device, mesh)
    qs = {dev: queries.to(dev, non_blocking=True) for dev, _, _ in runs}

    def visit(j, start, rows, tensors, mask):
        out[:, start : start + rows] = dists(qs[runs[j][0]], tensors).cpu().numpy()

    _round_robin(arrays, runs, tile, None, visit)
    return out


def streaming_scan_distances(
    queries: torch.Tensor,
    host_vectors,
    metric: DistanceMetric,
    *,
    valid_count: int | None = None,
    tile_rows: int | None = None,
    policy_vtype: VectorType | None = None,
    mesh=None,
) -> np.ndarray:
    """Full [B, N] float32 distances over the first valid_count rows of a
    host array, computed tile by tile on the queries' device, or with a
    mesh on each shard's (the *_stream virtual tables for host-storage
    datasets); policy_vtype as in ops.scan.scan_distances."""
    n = host_vectors.shape[0] if valid_count is None else int(valid_count)
    return _streamed_distances(
        lambda q, t: scan_distances(q, t[0], metric, policy_vtype=policy_vtype),
        queries, [host_vectors], n, tile_rows, mesh,
    )


def int4_streaming_scan_distances(
    queries: torch.Tensor,
    packed_host,
    alpha_host,
    csq_host,
    metric: DistanceMetric,
    *,
    dim: int,
    valid_count: int | None = None,
    tile_rows: int | None = None,
    mesh=None,
) -> np.ndarray:
    """Full [B, N] approximate int4 distances over host-resident codes,
    tile by tile (ops.quantize4.int4_scan_distances on each)."""
    n = packed_host.shape[0] if valid_count is None else int(valid_count)
    return _streamed_distances(
        lambda q, t: int4_scan_distances(q, *t, metric, dim=dim),
        queries, [packed_host, alpha_host, csq_host], n, tile_rows, mesh,
    )
