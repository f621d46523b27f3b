"""Dataset and VectorStore on PyTorch, on one device.

Port of sqlite_vector_tpu/dataset.py with device storage: create, add,
remove (tombstones), update, compact, get; search in its five modes
(exact, approx, quantized over int8 or packed int4 codes, rerank, refine)
with ids_filter; distances; quantize() (int8, or int4 with the int8 refine
sidecar) and its lifecycle (is_quantized, quantize_memory, preload,
drop_quantization). The matrix lives on the device as a [capacity, dim]
tensor that doubles as rows are appended; searches snapshot (count,
matrix) and scan the first `count` rows through ops.scan.fused_scan_topk
(K1 on CUDA tensors); int4 scans go through ops.quantize4.int4_scan_topk
(K2), refine through ops.refine.int4_refine_topk, rerank through
ops.rerank. Row masks (ids_filter, tombstones) are [N] torch.bool tensors
built on the device and ride into the kernels.

storage="host" keeps the rows in host RAM (a numpy mirror that doubles as
rows are appended, or memory-mapped shards after load(mmap=True)) and
streams them through the device per scan (ops/streaming.py: K1 per tile,
K2 for int4 codes); its codes stay on the host until preload(). save,
save_stream and load write and read the JAX package's on-disk format
(manifest.json version 2 + npy shards), so a directory saved by either
package loads in the other.

Meshes and the non-finite float16/bfloat16 policy paths raise
VectorConfigError naming the ROADMAP item that will port them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from sqlite_vector_tpu_torch.codec import blob_to_array, vector_from_json
from sqlite_vector_tpu_torch.device import (
    bf16_bits,
    bits_to_device,
    bits_to_f32,
    from_numpy,
    resolve_device,
)
from sqlite_vector_tpu_torch.errors import (
    VectorCodecError,
    VectorConfigError,
    VectorStateError,
)
from sqlite_vector_tpu_torch.hostarray import ShardedRows
from sqlite_vector_tpu_torch.ops.distance import NEARLY_ZERO
from sqlite_vector_tpu_torch.ops.quantize import (
    QUANT_TORCH_DTYPE,
    fold_stats,
    minmax_and_negative,
    quantize_device,
    resolve_quant_params,
)
from sqlite_vector_tpu_torch.ops.quantize4 import (
    int4_scan_distances,
    int4_scan_topk,
    packed_width,
    quantize4_device,
)
from sqlite_vector_tpu_torch.ops.refine import int4_refine_topk
from sqlite_vector_tpu_torch.ops.rerank import rerank_topk, rescore_live_rows
from sqlite_vector_tpu_torch.ops.scan import fused_scan_topk, scan_distances
from sqlite_vector_tpu_torch.ops.streaming import (
    int4_streaming_scan_distances,
    int4_streaming_scan_topk,
    streaming_scan_distances,
    streaming_scan_topk,
    upload_rows,
)
from sqlite_vector_tpu_torch.types import (
    DistanceMetric,
    QuantType,
    VectorOptions,
    VectorType,
    parse_options,
)

MIN_CAPACITY = 1024
# elements per chunk of the host passes (non-finite scan, host quantize
# build, save) and of the device quantize pass; the JAX package's value,
# so quantize checkpoints' chunk_rows agree between the two packages
HOST_CHUNK_ELEMS = 64 << 20

_FLOAT_TYPES = (VectorType.F32, VectorType.F16, VectorType.BF16)
TORCH_DTYPE = {
    VectorType.F32: torch.float32,
    VectorType.F16: torch.float16,
    VectorType.BF16: torch.bfloat16,
    VectorType.U8: torch.uint8,
    VectorType.I8: torch.int8,
}
# numpy dtype names of the dataset types (bfloat16 is ml_dtypes')
_DTYPE_NAME = {
    VectorType.F32: "float32",
    VectorType.F16: "float16",
    VectorType.BF16: "bfloat16",
    VectorType.U8: "uint8",
    VectorType.I8: "int8",
}

# What the slice leaves out, by the ROADMAP.md queue-1 item that ports it.
_ROADMAP_ITEM = {
    "nonfinite": "3 (nonfinite.py policy twins)",
    "mesh": "8 (parallel/ -> torch.distributed)",
}


def _unported(what: str, item: str) -> VectorConfigError:
    return VectorConfigError(
        f"{what} is not ported to sqlite_vector_tpu_torch yet "
        f"(ROADMAP.md queue 1, item {_ROADMAP_ITEM[item]})."
    )


def _next_capacity(n: int) -> int:
    cap = MIN_CAPACITY
    while cap < n:
        cap *= 2
    return cap


def _unit_rows(q: np.ndarray) -> np.ndarray:
    """L2-normalize query rows host-side for the normalized-cosine fast
    path; zero-norm rows stay zero (their dot is 0 -> distance exactly 1.0,
    the reference's zero-norm rule)."""
    qf = q.astype(np.float32)
    n = np.linalg.norm(qf, axis=-1, keepdims=True)
    out = np.where(n > 0, qf / np.where(n > 0, n, 1.0), 0.0)
    return out.astype(q.dtype)


def _finite(a: np.ndarray) -> bool:
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return bool(np.isfinite(a).all())


def _rows_to_host(t: torch.Tensor, vtype: VectorType) -> np.ndarray:
    """Device rows in the host storage form (bfloat16 as uint16 bits)."""
    if vtype is VectorType.BF16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _user_rows(rows: np.ndarray, vtype: VectorType) -> np.ndarray:
    """Host-form rows as the JAX package returns them (bfloat16 through
    ml_dtypes)."""
    return rows.view(vtype.np_dtype) if vtype is VectorType.BF16 else rows


def _host_f32(rows: np.ndarray, vtype: VectorType) -> np.ndarray:
    """float32 values of host-form rows."""
    if vtype is VectorType.BF16:
        return bits_to_f32(rows)
    return np.asarray(rows).astype(np.float32, copy=False)


def _on_device(x) -> bool:
    return isinstance(x, torch.Tensor)


def _to_numpy(x, count: int) -> np.ndarray:
    """The first `count` rows of a device tensor or host array, on the host."""
    return x[:count].cpu().numpy() if _on_device(x) else np.asarray(x[:count])


def _scan_nonfinite(vectors: Any, vtype: VectorType, count: int) -> bool:
    """Chunked host scan for non-finite values over any row-sliceable
    host-form array (numpy, memmap, ShardedRows); integer types never scan."""
    if vtype not in _FLOAT_TYPES or count == 0:
        return False
    chunk = max(1, HOST_CHUNK_ELEMS // max(int(vectors.shape[1]), 1))
    for s in range(0, count, chunk):
        if not np.isfinite(_host_f32(vectors[s : min(s + chunk, count)], vtype)).all():
            return True
    return False


def _atomic_npy_save(path: str, arr) -> None:
    """np.save through a temp file + os.replace: a dataset saved onto the
    directory it was loaded from may read `arr` through a memmap of the
    destination, which a plain np.save would truncate first; a crash never
    leaves a half-written .npy under its name. (The file object keeps
    np.save from appending ".npy" to the temp name.)"""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, arr)
    os.replace(tmp, path)


def _atomic_npy_chunks(path: str, shape: tuple, dtype, chunks) -> None:
    """_atomic_npy_save of an array given as row chunks, written into a
    memmap of the temp file: the array is never whole in RAM."""
    if shape[0] == 0:
        _atomic_npy_save(path, np.zeros(shape, dtype))
        return
    tmp = path + ".tmp"
    out = np.lib.format.open_memmap(tmp, mode="w+", dtype=dtype, shape=shape)
    at = 0
    for c in chunks:
        out[at : at + len(c)] = c
        at += len(c)
    if at != shape[0]:
        raise RuntimeError(f"save: wrote {at} of {shape[0]} rows")
    out.flush()
    del out
    os.replace(tmp, path)


def _write_json_atomic(path: str, obj: dict, indent: int | None = None) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f, indent=indent)
    os.replace(path + ".tmp", path)


def _fit_mask(mask: torch.Tensor | None, n: int) -> torch.Tensor | None:
    """A row mask cut or padded to n rows. A mask built before a concurrent
    add() is shorter than the rows scanned: the rows past it stay excluded
    for this query (transient skew, never an index error)."""
    if mask is None or mask.shape[0] == n:
        return mask
    if mask.shape[0] > n:
        return mask[:n]
    return torch.cat([mask, mask.new_zeros(n - mask.shape[0])])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class _QuantState:
    qtype: QuantType
    scale: np.float32
    offset: np.float32
    codes: torch.Tensor | np.ndarray | None  # [count, dim] u8/i8 on the
    # device, or on the host (host storage before preload(): numpy or a
    # memmap, as are row_scale, sq_norms and codes8 then); for INT4 the
    # PACKED [count, ceil(dim/2)] uint8 codes (ops/quantize4.py)
    count: int  # rows quantized
    ids: np.ndarray  # row ids AT QUANTIZE TIME (the codes go stale on add,
    # remove and update, and keep serving with these ids)
    stale: bool = False
    # -- INT4 only: per-row dequant scale alpha (f32 [count]) and the int32
    # code square-sums csq; scale/offset stay 1.0/0.0
    row_scale: torch.Tensor | None = None
    sq_norms: torch.Tensor | None = None
    # -- the int8 refine sidecar (quantize(qtype="int4", refine=True)): codes
    # of the SAME row snapshot, positionally aligned with the packed rows
    codes8: torch.Tensor | None = None
    qtype8: QuantType | None = None
    scale8: np.float32 | None = None
    offset8: np.float32 | None = None


def _params_pass(chunk, starts, qtype: QuantType) -> tuple[QuantType, np.float32, np.float32]:
    """Pass 1 of a chunked build: the quant params of every chunk's rows."""
    stats = None
    for s in starts:
        stats = fold_stats(stats, chunk(s))
    stats = fold_stats(stats, torch.empty((0,)))
    return resolve_quant_params(stats["min_val"], stats["max_val"], stats["neg"], qtype)


def _empty_quant(qtype: QuantType) -> _QuantState:
    """Zero rows still record resolved params (src/sqlite-vector.c:1170-1178)."""
    resolved = QuantType.U8 if qtype is QuantType.AUTO else qtype
    return _QuantState(
        resolved, np.float32(1.0), np.float32(0.0), None, 0, np.zeros((0,), np.int64)
    )


class _HostBuild:
    """The arrays and checkpoint files of one host quantize build (the
    JAX package's files: <name>_checkpoint.json + .npy memmaps in the
    checkpoint directory). Without a directory the arrays are plain numpy
    and nothing persists. A checkpoint is trusted only when its meta
    records this build's data token, row counts, dim, chunk size and
    requested qtype and its files have the expected shapes."""

    def __init__(self, directory, count, out_count, dim, chunk_rows, requested, token):
        self.directory = directory
        self.count, self.out_count, self.dim = count, out_count, dim
        self.chunk_rows, self.requested, self.token = chunk_rows, requested, token
        self.arrays: list[np.ndarray] = []
        self.meta: dict = {}
        self.meta_path: str | None = None

    def sidecar(self) -> "_HostBuild":
        return _HostBuild(
            self.directory, self.count, self.out_count, self.dim,
            self.chunk_rows, self.requested, self.token,
        )

    def load(self, meta_name: str, shapes: dict, requested: bool = True) -> dict | None:
        """The checkpoint meta with its arrays opened (r+) if it matches
        this build, else None. A finished checkpoint resumes too: every
        chunk is then skipped."""
        if not self.directory:
            return None
        os.makedirs(self.directory, exist_ok=True)
        self.meta_path = os.path.join(self.directory, meta_name)
        paths = [os.path.join(self.directory, name) for name in shapes]
        try:
            with open(self.meta_path) as f:
                m = json.load(f)
            if not (
                m["count"] == self.count
                and m.get("live_count", m["count"]) == self.out_count
                and m.get("data_token") == self.token
                and m["dim"] == self.dim
                and m["chunk_rows"] == self.chunk_rows
                and (not requested or m["requested_qtype"] == self.requested.value)
            ):
                return None
            arrays = [np.lib.format.open_memmap(p, mode="r+") for p in paths]
        except (OSError, ValueError, KeyError, TypeError):
            return None
        if [a.shape for a in arrays] != list(shapes.values()):
            return None
        m["done"] = int(m["done"])
        self.arrays, self.meta = arrays, m
        return m

    def start(self, meta_name, qtype, scale, offset, files: dict, requested: bool = True) -> dict:
        """A fresh build: new arrays (fresh files: an earlier build may
        still serve searches through a mapping of the old ones, so they
        are unlinked, never truncated) and its meta at done = 0."""
        meta = {
            "qtype": qtype.value, "scale": float(scale), "offset": float(offset),
            "count": self.count, "live_count": self.out_count, "dim": self.dim,
            "chunk_rows": self.chunk_rows,
        }
        if requested:
            meta["requested_qtype"] = self.requested.value
        meta.update(data_token=self.token, done=0)
        self.meta = meta
        if not self.directory:
            self.arrays = [np.empty(shape, dtype) for dtype, shape in files.values()]
            return meta
        os.makedirs(self.directory, exist_ok=True)
        self.meta_path = os.path.join(self.directory, meta_name)
        self.arrays = []
        for name, (dtype, shape) in files.items():
            path = os.path.join(self.directory, name)
            if os.path.exists(path):
                os.unlink(path)
            self.arrays.append(np.lib.format.open_memmap(path, mode="w+", dtype=dtype, shape=shape))
        _write_json_atomic(self.meta_path, meta)
        return meta

    def done(self, chunks: int) -> None:
        """Record `chunks` chunks as built (after their codes are flushed)."""
        self.meta["done"] = chunks
        if self.directory:
            for a in self.arrays:
                a.flush()
            _write_json_atomic(self.meta_path, self.meta)


class Dataset:
    """A named collection of fixed-dimension vectors with one distance
    metric, on one torch device: resident there (storage="hbm") or held in
    host RAM and streamed through it per scan (storage="host")."""

    def __init__(
        self,
        name: str,
        options: VectorOptions,
        *,
        device: Any = None,
        storage: str = "hbm",
        sharding: Any = None,
        mesh: Any = None,
    ):
        if options.dimension <= 0:
            raise VectorConfigError(
                "Required 'dimension' option is missing (it must be specified "
                "in vector_init)."
            )
        if storage not in ("hbm", "host"):
            raise VectorConfigError(
                f"storage must be 'hbm' or 'host', got '{storage}'"
            )
        if mesh is not None or sharding is not None:
            raise _unported("Meshes and shardings", "mesh")
        self.name = name
        self.options = options
        self.device = resolve_device(device)
        # "hbm" keeps the matrix on the device; "host" keeps it in host RAM
        # (in the host form: bfloat16 as uint16 bits) and streams tiles per
        # scan, for datasets larger than device memory
        self._storage = storage
        self._host_vectors: Any = (
            np.zeros((0, options.dimension), options.type.host_dtype)
            if storage == "host" else None
        )
        # opaque content token, new on every row mutation and persisted by
        # save()/load(): a save resume or a quantize checkpoint is trusted
        # only under the token of the rows it was written from (counts
        # alone cannot prove the rows unchanged: update() keeps them)
        self._data_token = os.urandom(16).hex()
        # serializes mutators; searches are lock-free and snapshot
        self._mutate_lock = threading.RLock()
        self._count = 0
        self._ids = np.zeros((0,), dtype=np.int64)
        self._id_pos_cache: dict[int, int] | None = None
        self._next_rowid = 1
        self._vectors: torch.Tensor | None = None  # [capacity, dim]
        self._quant: _QuantState | None = None
        # sticky: some ingested row held NaN/Inf
        self._has_nonfinite = False
        # remove() tombstones rows in place: every scan of the live rows
        # masks them, and compaction runs only past a threshold. Each
        # mutation publishes a NEW _dead array (never written in place), so
        # a mask built from an old one stays what it was
        self._dead = np.zeros((0,), dtype=bool)
        self._n_dead = 0
        # cached (dead array, ~dead[:count]) and (that mask, its device
        # copy): keyed by the arrays themselves, so a search that built a
        # mask from an older _dead can never install it as current
        self._live_np: tuple | None = None
        self._live_dev: tuple | None = None
        # device copies of id arrays for filter masks: [(array, tensor)]
        self._ids_dev: list[tuple[np.ndarray, torch.Tensor]] = []
        # bumped (under the lock) by every row mutation; quantize() snapshots
        # it so a mutation landing during its build marks the codes stale
        self._mutation_gen = 0
        # bumped only when row POSITIONS move (compaction): a search that
        # raced one re-runs (see search)
        self._layout_gen = 0
        # per-stage timing of the most recent mode="rerank" call
        self.last_rerank_decomposition: dict | None = None

    # -- properties ---------------------------------------------------------

    def __len__(self) -> int:
        return self._count - self._n_dead

    @property
    def dimension(self) -> int:
        return self.options.dimension

    @property
    def dtype(self) -> VectorType:
        return self.options.type

    @property
    def metric(self) -> DistanceMetric:
        return self.options.distance

    @property
    def is_quantized(self) -> bool:
        return self._quant is not None

    @property
    def quant_params(self) -> tuple[QuantType, float, float] | None:
        q = self._quant
        return (q.qtype, float(q.scale), float(q.offset)) if q else None

    @property
    def quant_stale(self) -> bool:
        """True when rows changed after the last quantize(): quantized
        scans still run on the old codes, as in the reference, until
        quantize() runs again."""
        return bool(self._quant and self._quant.stale)

    @property
    def ids(self) -> np.ndarray:
        """The live row ids, in row order."""
        # under the lock: compaction swaps _ids and _dead one after the other
        with self._mutate_lock:
            if self._n_dead:
                return self._ids[: self._count][~self._dead[: self._count]]
            return self._ids[: self._count]

    @property
    def tombstones(self) -> int:
        """Rows removed but not yet compacted (still holding matrix rows,
        masked out of every scan of the live rows)."""
        return self._n_dead

    def memory_bytes(self) -> int:
        """Device bytes held by the matrix (at its padded capacity; none
        with host storage) and by the codes when they are on the device
        (packed bytes for int4; alpha, csq and the refine sidecar are not
        counted). This is the port's own layout, not the JAX package's
        figure: the port keeps the codes at quant.count rows, where JAX
        pads them to the matrix capacity, so JAX reports (capacity -
        count) x code width bytes more."""
        total = 0
        vecs, quant = self._vectors, self._quant
        if vecs is not None:
            total += vecs.numel() * vecs.element_size()
        if quant is not None and _on_device(quant.codes):
            total += quant.codes.numel()
        return total

    # -- ingestion -----------------------------------------------------------

    def add(
        self,
        vectors: np.ndarray | Sequence[Any],
        ids: Sequence[int] | np.ndarray | None = None,
    ) -> np.ndarray:
        """Append vectors; returns the assigned int64 row ids.

        Accepts a [N, dim] array (any castable dtype), a single [dim] vector,
        JSON array strings, or raw little-endian blobs. The quantized codes
        are marked stale, not rebuilt (reference contract: API.md:242). A
        removed row's id may be used again.
        """
        with self._mutate_lock:
            return self._add_locked(vectors, ids)

    def _add_locked(self, vectors, ids) -> np.ndarray:
        arr = self._coerce_batch(vectors)
        n_new = arr.shape[0]
        if n_new == 0:
            return np.zeros((0,), np.int64)
        if ids is None:
            new_ids = np.arange(
                self._next_rowid, self._next_rowid + n_new, dtype=np.int64
            )
        else:
            new_ids = np.asarray(ids, dtype=np.int64)
            if new_ids.shape != (n_new,):
                raise VectorConfigError("ids must have one entry per vector")
            if len(np.unique(new_ids)) != n_new:
                raise VectorConfigError("add: duplicate ids within the batch")
            live_ids = self._ids[: self._count]
            if self._n_dead:
                live_ids = live_ids[~self._dead[: self._count]]
            if len(live_ids) and np.isin(new_ids, live_ids).any():
                raise VectorConfigError(
                    "add: id(s) already exist — use update() to replace rows"
                )
        self._next_rowid = max(self._next_rowid, int(new_ids.max()) + 1)

        start, end = self._count, self._count + n_new
        if self._storage == "host":
            self._note_nonfinite_host(arr)
            self._host_append(arr)
        else:
            rows = self._rows_to_device(arr)
            self._note_nonfinite(rows)
            cap = 0 if self._vectors is None else self._vectors.shape[0]
            if end > cap:
                # amortized capacity doubling: one copy of the live rows per
                # doubling, installed with ONE reference assignment
                grown = torch.zeros(
                    (_next_capacity(end), self.dimension),
                    dtype=TORCH_DTYPE[self.dtype],
                    device=self.device,
                )
                if start:
                    grown[:start] = self._vectors[:start]
                self._vectors = grown
            # in place: a search reads only the rows below the count it
            # snapshotted (it scans matrix[:count]), so writing rows >= count
            # cannot disturb one; the count is published after the rows land
            self._vectors[start:end] = rows
        self._ids = np.concatenate([self._ids[:start], new_ids])
        self._dead = np.concatenate([self._dead[:start], np.zeros(n_new, bool)])
        self._invalidate_row_caches()
        self._count = end
        self._rows_changed()
        return new_ids

    def _rows_changed(self) -> None:
        """Bookkeeping of every row mutation (under the lock)."""
        self._mutation_gen += 1
        self._data_token = os.urandom(16).hex()
        if self._quant is not None:
            self._quant.stale = True

    def _rows_to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Host-form rows as a device tensor of the dataset dtype."""
        if self.dtype is VectorType.BF16:
            return bits_to_device(arr, self.device)
        return from_numpy(arr, self.device)

    def _query_to_device(self, q: np.ndarray) -> torch.Tensor:
        """Coerced queries (float32 values for bfloat16) as a device tensor
        of the dataset dtype."""
        return from_numpy(q, self.device).to(TORCH_DTYPE[self.dtype])

    def _note_nonfinite(self, rows: torch.Tensor) -> None:
        if self.dtype in _FLOAT_TYPES and not self._has_nonfinite:
            self._has_nonfinite = not bool(torch.isfinite(rows).all())

    def _note_nonfinite_host(self, arr: np.ndarray) -> None:
        if not self._has_nonfinite:
            self._has_nonfinite = _scan_nonfinite(arr, self.dtype, arr.shape[0])

    def _host_writable(self) -> bool:
        hv = self._host_vectors
        return isinstance(hv, np.ndarray) and hv.flags.writeable

    def _can_compact(self) -> bool:
        """Read-only host mirrors (memory maps, ShardedRows) never compact:
        that would copy the whole matrix into RAM. Their tombstones stay,
        and quantize and save filter them chunk by chunk."""
        return self._storage != "host" or self._host_writable()

    def _host_append(self, arr: np.ndarray) -> None:
        """Amortized host-mirror append (capacity doubling). A read-only
        mirror is first copied into a writable one (O(matrix))."""
        need = self._count + arr.shape[0]
        cap = self._host_vectors.shape[0] if self._host_writable() else -1
        if need > cap:
            grown = np.zeros(
                (max(_next_capacity(need), cap * 2), self.dimension),
                self.dtype.host_dtype,
            )
            grown[: self._count] = self._host_vectors[: self._count]
            self._host_vectors = grown
        self._host_vectors[self._count : need] = arr

    def _attach_host(self, vecs: Any, ids: np.ndarray) -> None:
        """Adopt a host-form array (numpy, memmap, ShardedRows) as the
        host mirror, without a copy."""
        self._host_vectors = vecs
        self._ids = np.asarray(ids, np.int64)
        self._dead = np.zeros((len(self._ids),), bool)
        self._n_dead = 0
        self._invalidate_row_caches()
        self._count = len(self._ids)
        self._next_rowid = int(self._ids.max()) + 1 if len(self._ids) else 1

    def _invalidate_row_caches(self) -> None:
        self._id_pos_cache = None
        self._live_np = None
        self._live_dev = None

    @classmethod
    def from_arrays(
        cls,
        name: str,
        vectors: np.ndarray,
        ids: np.ndarray | Sequence[int] | None = None,
        *,
        options: str | VectorOptions | None = None,
        **kwargs: Any,
    ) -> "Dataset":
        """Bulk construction from a [N, dim] host array of the dataset
        dtype: uploaded to the device (storage="hbm"), or with
        storage="host" ADOPTED as the host mirror without a copy (numpy,
        memmap or ShardedRows; bfloat16 read as its bits)."""
        dim = int(vectors.shape[1])
        if isinstance(options, VectorOptions):
            opts = dataclasses.replace(options)
        else:
            opts = parse_options(options)
        if opts.dimension <= 0:
            opts.dimension = dim
        if opts.dimension != dim:
            raise VectorConfigError(
                f"Invalid vector dimension: expected {opts.dimension} but "
                f"found {dim}."
            )
        if vectors.dtype.name != _DTYPE_NAME[opts.type]:
            raise VectorConfigError(
                f"from_arrays: array dtype {vectors.dtype} does not match "
                f"the dataset type {opts.type.value}; cast first or use add()."
            )
        ds = cls(name, opts, **kwargs)
        n = vectors.shape[0]
        ids = np.arange(1, n + 1, dtype=np.int64) if ids is None else np.asarray(ids, np.int64)
        if ids.shape != (n,):
            raise VectorConfigError("ids must have one entry per vector")
        if ds._storage == "host":
            if len(np.unique(ids)) != n:
                raise VectorConfigError("from_arrays: duplicate ids")
            if opts.type is VectorType.BF16:
                vectors = vectors.view(np.uint16)
            ds._has_nonfinite = _scan_nonfinite(vectors, opts.type, n)
            ds._attach_host(vectors, ids)
        elif n:
            ds.add(vectors, ids)
        return ds

    def _adopt_rows(self, vectors: np.ndarray, ids: np.ndarray, dead: np.ndarray) -> None:
        """Install rows, their ids and their tombstones built elsewhere
        (interop) into an empty dataset. A tombstoned id may recur among
        the rows, as after remove() and add() of that id; live ids are
        unique."""
        ids = np.asarray(ids, np.int64)
        dead = np.asarray(dead, bool)
        if dead.shape != ids.shape or ids.shape != (len(vectors),):
            raise VectorConfigError("ids and dead must have one entry per vector")
        live = ids[~dead]
        if len(np.unique(live)) != len(live):
            raise VectorConfigError("live row ids must be unique")
        with self._mutate_lock:
            if self._count:
                raise VectorStateError("_adopt_rows needs an empty dataset")
            self._add_locked(vectors, None)
            self._ids = ids.copy()
            self._next_rowid = int(ids.max()) + 1 if len(ids) else 1
            self._dead = dead.copy()
            self._n_dead = int(dead.sum())
            self._invalidate_row_caches()

    def get(self, ids: Sequence[int] | np.ndarray) -> np.ndarray:
        """Fetch stored vectors by row id. Unknown and removed ids raise."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        with self._mutate_lock:
            id_to_pos = self._id_to_pos()
            try:
                pos = [id_to_pos[int(i)] for i in ids]
            except KeyError as e:
                raise VectorStateError(
                    f"get: unknown row id {e.args[0]}"
                ) from None
            if self._storage == "host":
                rows = np.array(self._host_vectors[np.asarray(pos, np.int64)])
            else:
                index = torch.tensor(pos, dtype=torch.int64, device=self.device)
                rows = _rows_to_host(self._vectors[index], self.dtype)
            return _user_rows(rows, self.dtype)

    def _id_to_pos(self) -> dict[int, int]:
        """Lazy id -> row position map over the LIVE rows, invalidated on
        mutation (tombstoned rows are not addressable)."""
        if self._id_pos_cache is None:
            count = self._count
            live = np.flatnonzero(~self._dead[:count])
            self._id_pos_cache = dict(zip(self._ids[live].tolist(), live.tolist()))
        return self._id_pos_cache

    # -- mutation ------------------------------------------------------------

    def remove(self, ids: Sequence[int] | np.ndarray) -> int:
        """Delete rows by id; returns the number removed.

        Rows are tombstoned in place: the device matrix is untouched and
        every scan of the live rows masks them, until the tombstones reach
        max(1024, count // 4) (or every row), when the matrix is compacted.
        Quantized codes go stale and keep serving the quantize-time
        snapshot until quantize() runs again (the reference's contract)."""
        with self._mutate_lock:
            return self._remove_locked(ids)

    def _remove_locked(self, ids) -> int:
        ids = np.asarray(ids, np.int64)
        cnt = self._count
        if ids.size == 0 or cnt == 0:
            return 0
        hit = np.isin(self._ids[:cnt], ids) & ~self._dead[:cnt]
        removed = int(hit.sum())
        if removed == 0:
            return 0
        dead = self._dead.copy()
        dead[:cnt] |= hit
        self._dead = dead
        self._n_dead += removed
        self._invalidate_row_caches()
        self._rows_changed()
        # the JAX package's threshold, so positions (and with them the order
        # among equal distances) agree with it after any sequence of calls
        if self._can_compact() and (self._n_dead >= max(1024, cnt // 4) or self._n_dead == cnt):
            self._compact_locked()
        return removed

    def compact(self) -> int:
        """Physically drop tombstoned rows now (instead of waiting for the
        threshold). Returns the number of rows dropped; no-op without
        tombstones. Raises on a read-only host mirror (memory maps), whose
        tombstones quantize and save filter instead."""
        with self._mutate_lock:
            dropped = self._n_dead
            if dropped and not self._can_compact():
                raise VectorStateError(
                    "compact: this dataset's host mirror is a read-only "
                    "mmap/shard view — compaction would materialize the "
                    "matrix. save() to a new directory instead (it filters "
                    "tombstones shard-wise)."
                )
            self._compact_locked()
            return dropped

    def _compact_locked(self) -> None:
        """Drop the tombstoned rows: on the device, gather the live rows of
        the matrix into a fresh one (one upload of the row index, no
        re-upload of rows); with host storage, compact the host mirror. A
        concurrent search keeps the matrix it snapshotted; the layout
        generation, bumped last, makes one that raced this re-run."""
        if self._n_dead == 0:
            return
        cnt = self._count
        keep = ~self._dead[:cnt]
        kept = np.flatnonzero(keep)
        n = len(kept)
        cap = _next_capacity(n)
        if self._storage == "host":
            rows = np.zeros((cap, self.dimension), self.dtype.host_dtype)
            rows[:n] = self._host_vectors[kept]
            self._host_vectors = rows
        elif n:
            index = np.zeros((cap,), np.int64)  # rows past n: copies of row 0
            index[:n] = kept
            self._vectors = self._vectors.index_select(0, from_numpy(index, self.device))
        else:
            self._vectors = torch.zeros(
                (cap, self.dimension), dtype=TORCH_DTYPE[self.dtype], device=self.device
            )
        self._ids = self._ids[:cnt][keep]
        self._dead = np.zeros((n,), bool)
        self._n_dead = 0
        self._invalidate_row_caches()
        self._count = n
        self._mutation_gen += 1
        self._data_token = os.urandom(16).hex()
        self._layout_gen += 1  # positions moved

    def update(
        self, ids: Sequence[int] | np.ndarray, vectors: np.ndarray | Sequence[Any]
    ) -> int:
        """Replace the vectors of existing rows; returns the count.

        Unknown (and removed) ids raise. Duplicate ids in one batch keep
        their last vector. The rows are written into a copy of the matrix,
        installed with one reference assignment, as the JAX package's
        out-of-place scatter does: a concurrent search keeps the matrix it
        snapshotted and sees old rows or new, never a half-written one."""
        with self._mutate_lock:
            return self._update_locked(ids, vectors)

    def _update_locked(self, ids, vectors) -> int:
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        arr = self._coerce_batch(vectors)
        if arr.shape[0] != ids.size:
            raise VectorConfigError("ids must have one entry per vector")
        if ids.size == 0:
            return 0
        id_to_pos = self._id_to_pos()
        try:
            pos = np.asarray([id_to_pos[int(i)] for i in ids], np.int64)
        except KeyError as e:
            raise VectorStateError(f"update: unknown row id {e.args[0]}") from None
        # duplicate ids: the last occurrence wins (a scatter with repeated
        # indices has no defined order)
        last = {int(p): i for i, p in enumerate(pos)}
        sel = np.fromiter(last.values(), np.int64, count=len(last))
        if self._storage == "host":
            if not self._host_writable():
                # memory-mapped / shard view: materialize a writable copy
                self._host_vectors = np.array(self._host_vectors[0 : self._host_vectors.shape[0]])
            self._note_nonfinite_host(arr[sel])
            self._host_vectors[pos[sel]] = arr[sel]
        else:
            rows = self._rows_to_device(arr[sel])
            self._note_nonfinite(rows)
            matrix = self._vectors.clone()
            matrix[from_numpy(pos[sel], self.device)] = rows
            self._vectors = matrix
        self._rows_changed()
        return int(ids.size)

    def _coerce_batch(self, vectors: Any) -> np.ndarray:
        """Rows [N, dim] in the host form of the dataset dtype (bfloat16
        as uint16 bits, rounded to nearest even)."""
        dim = self.dimension
        if self.dtype is VectorType.BF16:
            cast = bf16_bits
        else:
            np_dtype = self.dtype.np_dtype
            def cast(a):
                return a.astype(np_dtype, copy=False)
        if isinstance(vectors, (str, bytes, bytearray, memoryview)):
            vectors = [vectors]
        if isinstance(vectors, np.ndarray) and vectors.ndim in (1, 2):
            arr = np.atleast_2d(vectors)
            if arr.shape[1] != dim:
                raise VectorCodecError(
                    f"Invalid vector dimension: expected {dim} but found {arr.shape[1]}."
                )
            return np.ascontiguousarray(cast(arr))
        rows = []
        for v in vectors:
            if isinstance(v, str):
                rows.append(vector_from_json(v, self.dtype, dim))
            elif isinstance(v, (bytes, bytearray, memoryview)):
                rows.append(blob_to_array(bytes(v), self.dtype, dim))
            else:
                a = np.asarray(v)
                if a.shape != (dim,):
                    raise VectorCodecError(
                        f"Invalid vector dimension: expected {dim} but found "
                        f"{a.shape[-1] if a.ndim else 'a scalar'}."
                    )
                rows.append(a)
        if not rows:
            return np.zeros((0, dim), self.dtype.host_dtype)
        return np.stack([cast(r) for r in rows])

    # -- row masks -----------------------------------------------------------

    def _live_row_mask(self) -> np.ndarray | None:
        """Cached [count]-bool mask of the non-tombstoned rows; None when
        every row is live."""
        if self._n_dead == 0:
            return None
        count = self._count
        dead = self._dead
        cached = self._live_np
        if cached is not None and cached[0] is dead and len(cached[1]) == count:
            return cached[1]
        live = ~dead[:count]
        self._live_np = (dead, live)
        return live

    def _live_mask_dev(self) -> torch.Tensor | None:
        """The live-row mask on the device, uploaded once per mutation and
        keyed by the host mask OBJECT: a racing search never re-installs a
        copy made before an invalidation."""
        live = self._live_row_mask()
        if live is None:
            return None
        cached = self._live_dev
        if cached is not None and cached[0] is live:
            return cached[1]
        dev = from_numpy(live, self.device)
        self._live_dev = (live, dev)
        return dev

    def _ids_on_device(self, ids: np.ndarray) -> torch.Tensor:
        """Device copy of an id array, cached by the array OBJECT (the live
        ids and a quantization's snapshot ids are replaced, never written
        in place), two entries: the live ids and one snapshot's."""
        for arr, dev in self._ids_dev:
            if arr is ids:
                return dev
        dev = from_numpy(ids, self.device)
        self._ids_dev = [(ids, dev)] + self._ids_dev[:1]
        return dev

    def _quant_id_map(self, quant: _QuantState | None) -> np.ndarray:
        if quant is None:
            return self._ids
        # pad so indexing with clipped positions stays in bounds
        return quant.ids if len(quant.ids) else np.full((1,), -1, np.int64)

    def _streams(self, mode: str, quant: _QuantState | None) -> bool:
        """Whether the search's scan streams from the host: exact and
        approx on host storage, the code scans while the codes are on the
        host (before preload())."""
        if mode in ("exact", "approx"):
            return self._storage == "host"
        return quant is not None and quant.codes is not None and not _on_device(quant.codes)

    def _search_mask(
        self, mode: str, quant: _QuantState | None, ids_filter: Any, on_host: bool = False
    ) -> torch.Tensor | np.ndarray | None:
        """The search's row mask on the device (a numpy array with
        on_host, for the streamed scans, which send it tile by tile), or
        None.

        ids_filter has two index spaces: exact and approx scan the live
        rows, quantized, refine and rerank stage 1 the quantize-time
        snapshot (quant.ids). Tombstones mask exact and approx only:
        quantized scans serve the stale snapshot unfiltered (the reference's
        staleness contract) and rerank drops removed rows through its live
        id remap. The filter is matched with torch.isin against a cached
        device copy of the ids: the same mask as np.isin."""
        live_space = mode in ("exact", "approx")
        if on_host:
            mask = None
            if ids_filter is not None:
                flt = np.asarray(ids_filter, np.int64).reshape(-1)
                if live_space:
                    mask = np.isin(self._ids[: self._count], flt)
                else:
                    count = quant.count if quant else 0
                    mask = np.isin(self._quant_id_map(quant)[:count], flt)
            live = self._live_row_mask() if live_space else None
            if live is not None:
                if mask is None:
                    return live
                m = min(len(mask), len(live))
                mask = mask[:m] & live[:m]
            return mask
        mask = None
        if ids_filter is not None:
            flt = from_numpy(np.asarray(ids_filter, np.int64).reshape(-1), self.device)
            if live_space:
                count, ids = self._count, self._ids
            else:
                count, ids = (quant.count if quant else 0), self._quant_id_map(quant)
            mask = torch.isin(self._ids_on_device(ids)[:count], flt)
        if live_space:
            live = self._live_mask_dev()
            if live is not None:
                if mask is None:
                    mask = live
                else:
                    # a concurrent add() may have grown one of the two since
                    # it was built: combine over the common prefix
                    m = min(len(mask), len(live))
                    mask = mask[:m] & live[:m]
        return mask

    # -- queries --------------------------------------------------------------

    def _coerce_queries(self, queries: Any) -> tuple[np.ndarray, bool]:
        """Returns (queries [B, dim] in the dataset dtype, was_single);
        bfloat16 queries are rounded to it and held as float32 values."""
        dim = self.dimension
        if isinstance(queries, str):
            arr, single = vector_from_json(queries, self.dtype, dim)[None, :], True
        elif isinstance(queries, (bytes, bytearray, memoryview)):
            arr, single = blob_to_array(bytes(queries), self.dtype, dim)[None, :], True
        else:
            arr = np.asarray(queries)
            single = arr.ndim == 1
            arr = np.atleast_2d(arr)
            if arr.shape[1] != dim:
                raise VectorCodecError(
                    f"Invalid vector dimension: expected {dim} but found {arr.shape[1]}."
                )
        if self.dtype is VectorType.BF16:
            return bits_to_f32(bf16_bits(arr)), single
        return arr.astype(self.dtype.np_dtype), single

    def search(
        self,
        queries: Any,
        k: int,
        *,
        exact: bool = True,
        mode: str | None = None,
        expand: int = 4,
        recall_target: float = 0.95,
        ids_filter: Sequence[int] | np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k nearest neighbors.

        Returns (ids [B, k] int64, distances [B, k] float32), both sorted by
        ascending distance; slots beyond the available rows hold id -1 /
        distance +inf. Single-vector queries return [k]-shaped results with
        unfilled slots trimmed. ids_filter restricts the search to the given
        row ids.

        mode "exact" (the default, vector_full_scan) scans the live
        full-precision rows; "approx" (with recall_target in (0, 1]) runs
        the exact scan, as the JAX package does off the TPU (recall 1.0);
        "quantized" (exact=False, vector_quantize_scan) scans the codes:
        int8 codes return integer-domain distances, packed int4 codes
        approximate original-domain ones; "rerank" scans the codes for
        k*expand candidates and rescores them against the live
        full-precision rows; "refine" scans the int4 codes for k*expand
        candidates and rescores them against the int8 sidecar (requires
        quantize(qtype="int4", refine=True)). Positions of the quantized
        and refine modes index the quantize-time snapshot.

        With host storage the exact and approx scans stream the rows
        through the device, and the code scans stream the codes until
        preload(); refine needs preload(), and rerank gathers its
        candidates' rows from the host mirror.
        """
        if k < 0:
            raise VectorConfigError("k must be >= 0")
        if mode is None:
            mode = "exact" if exact else "quantized"
        if mode not in ("exact", "quantized", "rerank", "refine", "approx"):
            raise VectorConfigError(
                "mode must be exact|quantized|rerank|refine|approx, "
                f"got '{mode}'"
            )
        q, single = self._coerce_queries(queries)
        if k == 0 or self._count == 0:
            if single:
                return np.zeros((0,), np.int64), np.zeros((0,), np.float32)
            return (
                np.full((q.shape[0], k), -1, np.int64),
                np.full((q.shape[0], k), np.inf, np.float32),
            )
        if mode != "quantized" and self.dtype in (VectorType.F16, VectorType.BF16):
            # lane-skip dtypes need the reference's non-finite policy
            # kernels; the JAX package routes rerank and refine over such
            # data to them too (their rescores cannot honor the semantics)
            if self._has_nonfinite or not _finite(q):
                raise _unported(
                    "Exact search over non-finite float16/bfloat16 data", "nonfinite"
                )

        def attempt():
            # ONE quant snapshot: the mask's index space, the scanned codes
            # and the id map agree
            quant = self._quant
            mask = self._search_mask(mode, quant, ids_filter, self._streams(mode, quant))
            cosine_fast = mode in ("exact", "approx") and self._cosine_dot_fast(q)
            if mode in ("exact", "approx"):
                if mode == "approx" and not 0.0 < recall_target <= 1.0:
                    raise VectorConfigError(
                        f"recall_target must be in (0, 1], got {recall_target}"
                    )
                vals, idx = self._search_exact(q, k, mask, cosine_fast)
            elif mode == "refine":
                vals, idx = self._search_refine(q, k, mask, expand, quant)
            elif mode == "rerank":
                vals, idx = self._search_rerank(q, k, mask, expand, quant)
            else:
                vals, idx = self._search_quantized(q, k, mask, quant)
            # one device->host copy for both outputs: float32 values and int
            # positions (< 2^53) are both exact in float64
            host = torch.stack([vals.double(), idx.double()]).cpu().numpy()
            vals = host[0].astype(np.float32)
            idx = host[1].astype(np.int64)
            if cosine_fast:
                # the fast path scanned -dot: shift to 1 - dot (monotonic),
                # clamp into the reference's cosine range and re-snap
                vals = np.where(np.isposinf(vals), vals, np.clip(vals + 1.0, 0.0, 2.0))
                vals = np.where(np.abs(vals) <= NEARLY_ZERO, 0.0, vals).astype(np.float32)
            # quantized and refine positions index the codes AT QUANTIZE
            # TIME; exact, approx and rerank positions the live layout
            id_map = self._quant_id_map(quant) if mode in ("quantized", "refine") else self._ids
            n_map = len(id_map)
            valid = (idx >= 0) & (idx < n_map)
            if n_map == 0:
                out_ids = np.full(idx.shape, -1, np.int64)
            else:
                out_ids = np.where(valid, id_map[np.clip(idx, 0, n_map - 1)], -1)
            return out_ids, vals, valid

        # positions mean something only in the row layout they were scanned
        # in; compaction moves rows, so a search that raced one re-runs (the
        # last attempt under the mutation lock)
        layout0 = self._layout_gen
        out_ids, vals, valid = attempt()
        if self._layout_gen != layout0:
            layout0 = self._layout_gen
            out_ids, vals, valid = attempt()
            if self._layout_gen != layout0:
                with self._mutate_lock:
                    out_ids, vals, valid = attempt()
        if single:
            keep = valid[0]
            return out_ids[0][keep], vals[0][keep]
        return out_ids, vals

    def _cosine_dot_fast(self, q: np.ndarray) -> bool:
        """normalized=1 + COSINE over clean f32 rows: scan a pure dot over
        unit-normalized queries; search() applies 1 + (-dot) on the host (a
        monotonic shift, so the top-k order is already right). Non-finite
        rows or queries take the plain cosine path, whose NaN handling the
        dot scan cannot reproduce; 16-bit floats do too, because their cast
        error is what the plain path's divide cancels."""
        return (
            self.metric is DistanceMetric.COSINE
            and bool(self.options.normalized)
            and self.dtype is VectorType.F32
            and not self._has_nonfinite
            and _finite(q)
        )

    def _search_exact(self, q: np.ndarray, k: int, mask, cosine_fast: bool):
        metric = self.metric
        if cosine_fast:
            metric = DistanceMetric.DOT
            q = _unit_rows(q)
        # count BEFORE the matrix: add() publishes the count only after its
        # rows landed in the matrix it installed, so every matrix read after
        # the count holds those rows (a compaction that shrank the matrix
        # meanwhile is caught by the layout generation)
        count = self._count
        qd = self._query_to_device(q)
        if self._storage == "host":
            return streaming_scan_topk(
                qd, self._host_vectors, metric, k, valid_count=count, row_mask=mask
            )
        base = self._vectors[:count]
        return fused_scan_topk(
            qd, base, metric, k, row_mask=_fit_mask(mask, base.shape[0])
        )

    def _search_quantized(self, q: np.ndarray, k: int, mask, quant: _QuantState | None):
        quant = self._require_quant("vector_quantize_scan", quant)
        qf = from_numpy(q.astype(np.float32), self.device)
        if not _on_device(quant.codes):
            # host codes stream per query until preload() (the reference's
            # preloaded-vs-disk split)
            if quant.qtype is QuantType.I4:
                return int4_streaming_scan_topk(
                    qf, quant.codes, quant.row_scale, quant.sq_norms, self.metric, k,
                    dim=self.dimension, valid_count=quant.count, row_mask=mask,
                )
            qq = quantize_device(qf, quant.scale, quant.offset, quant.qtype)
            return streaming_scan_topk(
                qq, quant.codes, self.metric, k, valid_count=quant.count, row_mask=mask
            )
        row_mask = _fit_mask(mask, quant.count)
        if quant.qtype is QuantType.I4:
            # per-query int8 codes are built inside the int4 scan
            return int4_scan_topk(
                qf, quant.codes, quant.row_scale, quant.sq_norms, self.metric, k,
                dim=self.dimension, valid_count=quant.count, row_mask=row_mask,
            )
        # query quantization with the stored params (src/sqlite-vector.c:2162-2177)
        qq = quantize_device(qf, quant.scale, quant.offset, quant.qtype)
        return fused_scan_topk(qq, quant.codes, self.metric, k, row_mask=row_mask)

    def _search_refine(
        self, q: np.ndarray, k: int, mask, expand: int, quant: _QuantState | None
    ):
        """Two-stage search on the device: int4 prefilter of k*expand
        candidates, int8-sidecar rescore (ops/refine.py)."""
        quant = self._require_quant("refine", quant)
        if quant.qtype is not QuantType.I4 or quant.codes8 is None:
            raise VectorStateError(
                "refine: requires an int4 quantization with the int8 "
                "refine sidecar — run quantize(qtype='int4', refine=True) "
                "first."
            )
        if not (_on_device(quant.codes) and _on_device(quant.codes8)):
            raise VectorStateError(
                "refine: codes are host-resident — call preload() first "
                "(refine is a device-side two-stage search; streaming it "
                "through the host would defeat its no-round-trip contract)."
            )
        return int4_refine_topk(
            from_numpy(q.astype(np.float32), self.device),
            quant.codes, quant.row_scale, quant.sq_norms, quant.codes8,
            quant.scale8, quant.offset8, self.metric, k,
            dim=self.dimension, expand=expand, valid_count=quant.count,
            row_mask=_fit_mask(mask, quant.count),
        )

    def _search_rerank(
        self, q: np.ndarray, k: int, mask, expand: int, quant: _QuantState | None
    ):
        """Code prefilter + exact rescore against the live rows.

        Fused route (ops.rerank.rerank_topk): fresh int8/u8 codes of exactly
        the live rows, no mask; both stages on the device. Otherwise the
        id-remap route: stage 1 is the quantized scan at k*expand (masked,
        in snapshot space), its snapshot positions map to live positions
        through the ids under the mutation lock (removed rows drop out),
        and ops.rerank.rescore_live_rows rescores the gathered live rows on
        the device. With host storage the candidates' rows come from the
        host mirror in one sorted-unique gather, and are rescored on the
        device. last_rerank_decomposition records the stages' seconds
        (on the device the remap's gather runs inside its rescore, so
        host_gather_s is 0.0 there; the fused route reports everything
        under stage1_s)."""
        quant = self._require_quant("rerank", quant)
        count = self._count
        qf = from_numpy(q.astype(np.float32), self.device)
        b = q.shape[0]
        if (
            not quant.stale
            and mask is None
            and quant.qtype is not QuantType.I4
            and quant.count == count
            and self._vectors is not None
            and _on_device(quant.codes)
        ):
            t0 = time.perf_counter()
            qq = quantize_device(qf, quant.scale, quant.offset, quant.qtype)
            vals, idx = rerank_topk(
                qf, self._vectors[:count], qq, quant.codes, self.metric, k,
                expand=expand, valid_count=quant.count,
            )
            _sync(self.device)
            self.last_rerank_decomposition = {
                "batch": b, "k": k, "expand": expand,
                "stage1_s": time.perf_counter() - t0,
                "translate_s": 0.0, "host_gather_s": 0.0, "rescore_s": 0.0,
                "gathered_rows": 0,
            }
            return vals, idx

        ke = max(k * expand, k)
        t0 = time.perf_counter()
        _, idx = self._search_quantized(q, ke, mask, quant)
        idx = idx.cpu().numpy()
        t1 = time.perf_counter()
        # snapshot positions -> live positions through the ids; the id map
        # and the matrix it indexes come from one generation (under the lock)
        with self._mutate_lock:
            qids = self._quant_id_map(quant)
            live = self._id_to_pos()
            flat = idx.reshape(-1)
            ok = (flat >= 0) & (flat < len(qids))
            pos = np.full(flat.shape, -1, np.int64)
            if ok.any():
                pos[ok] = np.fromiter(
                    (live.get(int(i), -1) for i in qids[flat[ok]]),
                    np.int64, count=int(ok.sum()),
                )
            pos = pos.reshape(b, ke)
            t2 = time.perf_counter()
            if self._storage == "host":
                # the ONE host gather for the batch, sorted-unique (page
                # cache friendly on a memory map); positions become indices
                # into the gathered rows
                keep = pos >= 0
                uniq, inv = np.unique(pos[keep], return_inverse=True)
                rows = np.asarray(self._host_vectors[uniq if len(uniq) else np.zeros(1, np.int64)])
                vecs = self._rows_to_device(rows)
                local = np.full(pos.shape, -1, np.int64)
                local[keep] = inv.reshape(-1)
            else:
                uniq, vecs, local = None, self._vectors, pos
        t3 = time.perf_counter()
        vals, out = rescore_live_rows(qf, vecs, from_numpy(local, self.device), self.metric, k)
        if uniq is not None:
            uniq_dev = from_numpy(uniq if len(uniq) else np.zeros(1, np.int64), self.device)
            out = torch.where(out >= 0, uniq_dev[out.clamp(min=0)], -1)
        _sync(self.device)
        t4 = time.perf_counter()
        self.last_rerank_decomposition = {
            "batch": b, "k": k, "expand": expand,
            "stage1_s": t1 - t0, "translate_s": t2 - t1,
            "host_gather_s": t3 - t2 if uniq is not None else 0.0,
            "rescore_s": t4 - t3,
            "gathered_rows": int(np.unique(pos[pos >= 0]).size),
        }
        return vals, out

    def _require_quant(self, caller: str, quant: _QuantState | None) -> _QuantState:
        if quant is None or quant.codes is None:
            raise VectorStateError(
                f"{caller}: quantization not found — run quantize() first "
                "(reference requires vector_quantize before vector_quantize_scan)."
            )
        return quant

    def distances(self, queries: Any, *, exact: bool = True) -> np.ndarray:
        """Full distance vector(s), the *_stream virtual tables' analogue.

        Returns [B, N] (or [N] for one query) unordered distances: exact
        over the live rows (tombstoned columns dropped); exact=False over
        the quantize-time snapshot's codes ([:, :quant.count], int8
        integer-domain or int4 approximate values)."""
        q, single = self._coerce_queries(queries)
        if self._count == 0:
            out = np.zeros((q.shape[0], 0), np.float32)
            return out[0] if single else out
        if exact:
            raw_policy = self.dtype in (VectorType.F16, VectorType.BF16) or (
                self.dtype is VectorType.F32
                and self.metric in (DistanceMetric.L2, DistanceMetric.SQUARED_L2)
            )
            if raw_policy and (self._has_nonfinite or not _finite(q)):
                # the plain decomposition gives NaN where the reference's
                # direct kernels give +Inf
                raise _unported(
                    "Dataset.distances over non-finite rows or queries", "nonfinite"
                )
            count = self._count
            qd = self._query_to_device(q)
            if self._storage == "host":
                d = streaming_scan_distances(qd, self._host_vectors, self.metric, valid_count=count)
                live = self._live_row_mask()
                if live is not None and len(live) == count:
                    d = d[:, live]  # drop tombstoned columns
            else:
                base = self._vectors[:count]
                d = scan_distances(qd, base, self.metric)
                live = self._live_mask_dev()
                if live is not None and live.shape[0] == base.shape[0]:
                    d = d[:, live]  # drop tombstoned columns
        else:
            quant = self._require_quant("vector_quantize_scan_stream", self._quant)
            qf = from_numpy(q.astype(np.float32), self.device)
            host = not _on_device(quant.codes)
            if quant.qtype is QuantType.I4:
                args = (qf, quant.codes, quant.row_scale, quant.sq_norms, self.metric)
                if host:
                    d = int4_streaming_scan_distances(
                        *args, dim=self.dimension, valid_count=quant.count
                    )
                else:
                    d = int4_scan_distances(*args, dim=self.dimension)
            else:
                qq = quantize_device(qf, quant.scale, quant.offset, quant.qtype)
                if host:
                    d = streaming_scan_distances(qq, quant.codes, self.metric, valid_count=quant.count)
                else:
                    d = scan_distances(qq, quant.codes, self.metric)
        out = d if isinstance(d, np.ndarray) else d.cpu().numpy()
        return out[0] if single else out

    # -- quantization ---------------------------------------------------------

    def quantize(
        self,
        options: str | None = None,
        *,
        qtype: QuantType | str | None = None,
        checkpoint: str | None = None,
        refine: bool = False,
    ) -> int:
        """(Re)build the codes on the device; returns the row count.

        int8/uint8 mirror vector_quantize (src/sqlite-vector.c:1406-1459):
        the scale/offset formulas and AUTO resolution match the reference
        bit-for-bit. qtype="int4" builds packed 4-bit codes with per-row
        scales (ops/quantize4.py); refine=True (int4 only) adds an int8
        sidecar of the same rows, with AUTO-resolved params, for
        search(mode="refine"). Codes are bit-equal to the JAX package's.

        Tombstoned rows are compacted away first, so codes never cover a
        removed row (a read-only host mirror keeps its tombstones, and the
        host build filters them chunk by chunk). The build runs outside the
        mutation lock from one snapshot of the rows (no mutator writes rows
        below a snapshotted count in place); a mutation that lands during
        it marks the new codes stale.

        With host storage the codes are built in numpy over row chunks of
        HOST_CHUNK_ELEMS elements (one chunk of peak RAM, bit-equal to the
        device build) and stay on the host until preload(). `checkpoint`
        (host storage; ignored on the device, as in the JAX package) names
        a directory for a RESUMABLE build: params and per-chunk progress
        persist there and the codes go into on-disk memmaps, so a crashed
        build resumes at its first unfinished chunk; a build of other rows
        (another data token, count, dim, chunk size or requested qtype)
        starts over.
        """
        opts = parse_options(options, self.options)
        if qtype is not None:
            opts.qtype = (
                QuantType.from_name(qtype) if isinstance(qtype, str) else qtype
            )
        if refine and opts.qtype is not QuantType.I4:
            raise VectorConfigError(
                "refine=True requires qtype='int4' — the refine sidecar is "
                "the int8 rescore stage of the int4 two-stage search."
            )
        with self._mutate_lock:
            if self._can_compact():
                self._compact_locked()
            gen0 = self._mutation_gen
            count = self._count
            ids = self._ids[:count].copy()
            live = self._live_row_mask()
            host, token = self._host_vectors, self._data_token
            vecs = None if count == 0 or host is not None else self._vectors[:count]
        if host is not None:
            state = self._quantize_host(opts, checkpoint, refine, host, count, ids, live, token)
        elif count == 0:
            state = _empty_quant(opts.qtype)
        elif opts.qtype is QuantType.I4:
            packed, alpha, csq = quantize4_device(vecs)
            state = _QuantState(
                QuantType.I4, np.float32(1.0), np.float32(0.0), packed,
                count, ids, row_scale=alpha, sq_norms=csq,
            )
            if refine:
                # int8 sidecar of the SAME snapshot, AUTO-resolved params
                mn, mx, neg = minmax_and_negative(vecs)
                rq8, s8, o8 = resolve_quant_params(mn, mx, neg, QuantType.AUTO)
                state.codes8 = self._encode8(vecs, s8, o8, rq8)
                state.qtype8, state.scale8, state.offset8 = rq8, s8, o8
        else:
            mn, mx, neg = minmax_and_negative(vecs)
            rqtype, scale, offset = resolve_quant_params(mn, mx, neg, opts.qtype)
            codes = self._encode8(vecs, scale, offset, rqtype)
            state = _QuantState(rqtype, scale, offset, codes, count, ids)
        with self._mutate_lock:
            # a mutation landed during the build: the same staleness
            # contract as mutating after quantize()
            state.stale = self._mutation_gen != gen0
            self._quant = state
        return state.count

    def _encode8(self, vecs: torch.Tensor, scale, offset, qtype: QuantType) -> torch.Tensor:
        """int8/uint8 codes of `vecs`, in row chunks that bound the float32
        temporaries."""
        codes = torch.empty(
            vecs.shape, dtype=QUANT_TORCH_DTYPE[qtype], device=self.device
        )
        rows = max(1, HOST_CHUNK_ELEMS // self.dimension)
        for s in range(0, vecs.shape[0], rows):
            codes[s : s + rows] = quantize_device(vecs[s : s + rows], scale, offset, qtype)
        return codes

    # -- the host build (host storage) -----------------------------------------

    def _quantize_host(
        self, opts: VectorOptions, checkpoint: str | None, refine: bool,
        host: Any, count: int, ids: np.ndarray, live: np.ndarray | None, token: str,
    ) -> _QuantState:
        """The chunked build over one snapshot of the host mirror (the
        JAX package's _quantize_host, with the same checkpoint files): each
        chunk of rows goes to the device, is quantized there by the device
        build's functions (so the codes are the device build's, bit for
        bit) and comes back; pass 1 folds the global min/max, pass 2 writes
        the codes chunk by chunk, resuming after the chunks a matching
        checkpoint records as done. Tombstoned rows are dropped chunk by
        chunk, so the codes come out compacted."""
        dim = self.dimension
        chunk_rows = max(1, HOST_CHUNK_ELEMS // max(dim, 1))
        starts = range(0, count, chunk_rows)
        offs = None
        if live is not None:
            live = live[:count]
            offs = np.zeros(count + 1, np.int64)
            np.cumsum(live, out=offs[1:])
            ids = ids[live]
        out_count = len(ids)
        if out_count == 0:
            return _empty_quant(opts.qtype)

        def chunk(s: int) -> torch.Tensor:
            """Chunk s's live rows on the device, as float32."""
            c = np.asarray(host[s : min(s + chunk_rows, count)])
            return self._rows_to_device(c[live[s : s + len(c)]] if live is not None else c).float()

        def span(s: int) -> tuple[int, int]:
            """Where chunk s's codes go (compacted)."""
            e = min(s + chunk_rows, count)
            return (int(offs[s]), int(offs[e])) if offs is not None else (s, e)

        build = _HostBuild(checkpoint, count, out_count, dim, chunk_rows, opts.qtype, token)
        if opts.qtype is QuantType.I4:
            return self._quantize_host_i4(build, chunk, span, starts, ids, refine)
        meta = build.load("quant_checkpoint.json", {"qcodes.npy": (out_count, dim)})
        if meta is None:
            rqtype, scale, offset = _params_pass(chunk, starts, opts.qtype)
            meta = build.start(
                "quant_checkpoint.json", rqtype, scale, offset,
                {"qcodes.npy": (rqtype.np_dtype, (out_count, dim))},
            )
        else:
            rqtype = QuantType.from_name(meta["qtype"])
            scale, offset = np.float32(meta["scale"]), np.float32(meta["offset"])
        (codes,) = build.arrays
        for ci, s in enumerate(starts):
            if ci < meta["done"]:
                continue
            c = chunk(s)
            ws, we = span(s)
            if len(c):
                codes[ws:we] = quantize_device(c, scale, offset, rqtype).cpu().numpy()
            build.done(ci + 1)
        return _QuantState(rqtype, scale, offset, codes, out_count, ids)

    def _quantize_host_i4(self, build, chunk, span, starts, ids, refine: bool) -> _QuantState:
        """The int4 host build: packed codes, per-row alpha and csq in one
        pass (per-row params need no params pass). With refine, the int8
        sidecar's global min/max accumulate in the same loop and persist
        with each chunk's progress; stats cover every chunk only if the
        loop ran from chunk 0 or resumed them, else the sidecar makes its
        own params pass."""
        out_count, dim = build.out_count, build.dim
        p = packed_width(dim)
        files = {"qcodes.npy": (out_count, p), "qrow_scale.npy": (out_count,), "qcsq.npy": (out_count,)}
        meta = build.load("quant_checkpoint.json", files)
        if meta is None:
            meta = build.start(
                "quant_checkpoint.json", QuantType.I4, 1.0, 0.0,
                {"qcodes.npy": (np.uint8, (out_count, p)),
                 "qrow_scale.npy": (np.float32, (out_count,)),
                 "qcsq.npy": (np.int32, (out_count,))},
            )
        codes, rscale, csq = build.arrays
        done = meta["done"]
        stats = meta.get("refine_stats") if refine else None
        stats_valid = refine and (done == 0 or stats is not None)
        if not stats_valid:
            stats = None
            # partial stats of another build must never be trusted later
            meta.pop("refine_stats", None)
        for ci, s in enumerate(starts):
            if ci < done:
                continue
            c = chunk(s)
            ws, we = span(s)
            if len(c):
                pk, al, cs = quantize4_device(c)
                codes[ws:we], rscale[ws:we], csq[ws:we] = pk.cpu().numpy(), al.cpu().numpy(), cs.cpu().numpy()
            if stats_valid:
                stats = fold_stats(stats, c)
                meta["refine_stats"] = stats
            build.done(ci + 1)
        state = _QuantState(
            QuantType.I4, np.float32(1.0), np.float32(0.0), codes, out_count, ids,
            row_scale=rscale, sq_norms=csq,
        )
        if refine:
            if stats_valid and stats is None:
                stats = fold_stats(None, torch.empty((0,)))
            self._build_refine_sidecar_host(state, build, chunk, span, starts, stats if stats_valid else None)
        return state

    def _build_refine_sidecar_host(self, state, build, chunk, span, starts, stats) -> None:
        """The int8 sidecar of the host int4 build: one more chunked pass,
        positionally aligned with the packed rows, checkpointed in
        refine8.npy under the same rules. `stats` (the int4 loop's min/max)
        spares the params pass; None re-streams the chunks for it."""
        sub = build.sidecar()
        meta = sub.load("refine8_checkpoint.json", {"refine8.npy": (build.out_count, build.dim)}, requested=False)
        if meta is None:
            if stats is not None:
                rq8, s8, o8 = resolve_quant_params(
                    stats["min_val"], stats["max_val"], stats["neg"], QuantType.AUTO
                )
            else:
                rq8, s8, o8 = _params_pass(chunk, starts, QuantType.AUTO)
            meta = sub.start(
                "refine8_checkpoint.json", rq8, s8, o8,
                {"refine8.npy": (rq8.np_dtype, (build.out_count, build.dim))}, requested=False,
            )
        else:
            rq8 = QuantType.from_name(meta["qtype"])
            s8, o8 = np.float32(meta["scale"]), np.float32(meta["offset"])
        (codes8,) = sub.arrays
        for ci, s in enumerate(starts):
            if ci < meta["done"]:
                continue
            c = chunk(s)
            ws, we = span(s)
            if len(c):
                codes8[ws:we] = quantize_device(c, s8, o8, rq8).cpu().numpy()
            sub.done(ci + 1)
        state.codes8, state.qtype8 = codes8, rq8
        state.scale8, state.offset8 = np.float32(s8), np.float32(o8)

    def quantize_memory(self) -> int:
        """Bytes of the quantized representation, as the JAX package counts
        them: rows * (8-byte rowid + dim code bytes) for int8/uint8, the
        reference's SUM(LENGTH(data)) (src/sqlite-vector.c:1486-1499); for
        int4 the record stride 16 + ceil(dim/2) (rowid, alpha, csq, packed
        codes) plus dim bytes a row for the refine sidecar."""
        quant = self._require_quant("vector_quantize_memory", self._quant)
        if quant.qtype is QuantType.I4:
            total = quant.count * (16 + packed_width(self.dimension))
            if quant.codes8 is not None:
                total += quant.count * self.dimension
            return total
        return quant.count * (8 + self.dimension)

    def preload(self) -> None:
        """Pin the quantized codes on the device (vector_quantize_preload,
        src/sqlite-vector.c:1338-1404). Device-storage codes are built on
        the device, so there it only checks that a quantization exists.
        Host-resident codes (host storage) are uploaded through the
        streamed scans' pinned tiles, with alpha, csq and the refine
        sidecar; quantized scans then stop
        streaming, and refine becomes available."""
        quant = self._require_quant("vector_quantize_preload", self._quant)
        if _on_device(quant.codes):
            return
        n = quant.count
        pinned = dataclasses.replace(quant, codes=upload_rows(quant.codes, n, self.device))
        if quant.qtype is QuantType.I4:
            pinned.row_scale = from_numpy(np.asarray(quant.row_scale[:n], np.float32), self.device)
            pinned.sq_norms = from_numpy(np.asarray(quant.sq_norms[:n], np.int32), self.device)
        if quant.codes8 is not None:
            pinned.codes8 = upload_rows(quant.codes8, n, self.device)
        with self._mutate_lock:
            if self._quant is quant:  # not replaced meanwhile
                pinned.stale = quant.stale
                self._quant = pinned

    def drop_quantization(self) -> None:
        """Free the codes (vector_quantize_cleanup, src/sqlite-vector.c:
        1501-1524); a silent no-op without a quantization (:1510)."""
        self._quant = None

    def _install_quant(
        self,
        codes: np.ndarray,
        qtype: QuantType,
        scale: float,
        offset: float,
        ids: np.ndarray | None = None,
        stale: bool = False,
    ) -> None:
        """Adopt int8/uint8 codes built elsewhere (interop): of the current
        rows, or of the snapshot whose row ids are `ids`."""
        with self._mutate_lock:
            ids = self._snapshot_ids(ids)
            self._check_codes(codes, qtype, len(ids))
            self._quant = _QuantState(
                qtype, np.float32(scale), np.float32(offset),
                from_numpy(codes, self.device), len(ids), ids, stale=stale,
            )

    def _install_quant4(
        self,
        packed: np.ndarray,
        alpha: np.ndarray,
        csq: np.ndarray,
        sidecar: tuple[np.ndarray, QuantType, float, float] | None = None,
        ids: np.ndarray | None = None,
        stale: bool = False,
    ) -> None:
        """Adopt an int4 quantization built elsewhere (interop), with its
        refine sidecar (codes8, qtype8, scale8, offset8) when given: of the
        current rows, or of the snapshot whose row ids are `ids`."""
        with self._mutate_lock:
            ids = self._snapshot_ids(ids)
            count = len(ids)
            want = (count, packed_width(self.dimension))
            if packed.shape != want or packed.dtype != np.uint8:
                raise VectorConfigError(
                    f"packed codes must be uint8 {want}, got {packed.dtype} "
                    f"{packed.shape}"
                )
            if alpha.shape != (count,) or csq.shape != (count,):
                raise VectorConfigError("alpha and csq must have one entry per row")
            state = _QuantState(
                QuantType.I4, np.float32(1.0), np.float32(0.0),
                from_numpy(packed, self.device), count, ids, stale=stale,
                row_scale=from_numpy(alpha.astype(np.float32), self.device),
                sq_norms=from_numpy(csq.astype(np.int32), self.device),
            )
            if sidecar is not None:
                codes8, qtype8, scale8, offset8 = sidecar
                self._check_codes(codes8, qtype8, count)
                state.codes8 = from_numpy(codes8, self.device)
                state.qtype8 = qtype8
                state.scale8, state.offset8 = np.float32(scale8), np.float32(offset8)
            self._quant = state

    def _snapshot_ids(self, ids: np.ndarray | None) -> np.ndarray:
        if ids is None:
            return self._ids[: self._count].copy()
        return np.array(ids, np.int64)

    def _check_codes(self, codes: np.ndarray, qtype: QuantType, count: int) -> None:
        if codes.shape != (count, self.dimension):
            raise VectorConfigError(
                f"codes shape {codes.shape} != ({count}, {self.dimension})"
            )
        if codes.dtype != qtype.np_dtype:
            raise VectorConfigError(
                f"codes dtype {codes.dtype} does not match qtype {qtype.value}"
            )

    # -- persistence ------------------------------------------------------------

    def save(self, directory: str, *, shard_rows: int | None = None, resume: bool = False) -> None:
        """Persist to a directory in the JAX package's format: manifest.json
        (version 2), ids.npy, vectors.npy or vectors-NNNNN.npy shards of
        `shard_rows` rows, and with a quantization qcodes.npy, qids.npy,
        qrow_scale.npy and qcsq.npy (int4) and qcodes8.npy (the refine
        sidecar); the analogue of the reference's `_sqliteai_vector` table
        and vector0_* shadow tables (src/sqlite-vector.c:114, 1000-1026).

        Removed rows are compacted away first, or (read-only host mirror)
        filtered out shard by shard. bfloat16 rows are stored as their
        uint16 bits. Rows come to the host at most one shard or one
        HOST_CHUNK_ELEMS chunk at a time, never the whole matrix.

        Crash discipline: save_in_progress.json lands before any shard and
        records each shard as it commits; every file commits by temp file
        and rename; the marker goes after the manifest. `resume=True` skips
        a shard only when its provenance is proven under this dataset's
        current data token: by the marker of an interrupted save (a marker
        of another token disproves everything on disk) or else by the
        completed manifest. A file's mere existence proves nothing."""
        with self._mutate_lock:
            if self._n_dead and self._can_compact():
                self._compact_locked()  # never persist tombstoned rows
            # one same-generation snapshot of the row state
            count, n_dead, ids_arr = self._count, self._n_dead, self._ids
            live = self._live_row_mask()
            src = self._host_vectors if self._storage == "host" else self._vectors
            token, next_rowid, nonfinite = self._data_token, self._next_rowid, self._has_nonfinite
            quant = self._quant
        vtype, dim = self.dtype, self.dimension

        def read(start: int, end: int) -> np.ndarray:
            """Host-form live rows among [start, end)."""
            if end <= start:
                return np.zeros((0, dim), vtype.host_dtype)
            part = (
                np.asarray(src[start:end]) if self._storage == "host"
                else _rows_to_host(src[start:end], vtype)
            )
            return part[live[start:end]] if live is not None else part

        os.makedirs(directory, exist_ok=True)
        marker_path = os.path.join(directory, "save_in_progress.json")
        proven: dict[str, int] = {}
        if resume:
            try:
                with open(marker_path) as f:
                    marker = json.load(f)
            except (OSError, ValueError):
                marker = None
            if marker is not None:
                # an interrupted save proves ONLY the shards it recorded;
                # another token is disproof, with no fall-through to the
                # manifest (that save may have overwritten its shards)
                if marker.get("data_token") == token:
                    proven = {str(k): int(v) for k, v in (marker.get("done_shards") or {}).items()}
            else:
                try:
                    with open(os.path.join(directory, "manifest.json")) as f:
                        m = json.load(f)
                    if m.get("data_token") == token:
                        proven = {str(sh["file"]): int(sh["rows"]) for sh in m.get("vector_shards") or []}
                except (OSError, ValueError, KeyError, TypeError):
                    pass
        done_shards: dict[str, int] = {}

        def commit_marker() -> None:
            _write_json_atomic(marker_path, {"data_token": token, "done_shards": done_shards})

        commit_marker()
        manifest = {
            "name": self.name,
            "version": 2,
            "type": vtype.value,
            "dimension": dim,
            "distance": self.metric.value,
            "normalized": self.options.normalized,
            "max_memory": self.options.max_memory,
            "count": count - n_dead,
            "next_rowid": next_rowid,
            "has_nonfinite": nonfinite,
            "data_token": token,
            "quant": None,
        }
        ids_live = ids_arr[:count][live[:count]] if live is not None else ids_arr[:count]
        _atomic_npy_save(os.path.join(directory, "ids.npy"), ids_live)
        if shard_rows:
            shards = []
            for i, start in enumerate(range(0, max(count, 1), shard_rows)):
                name = f"vectors-{i:05d}.npy"
                part = read(start, min(start + shard_rows, count))
                path = os.path.join(directory, name)
                if not (proven.get(name) == len(part) and os.path.exists(path)):
                    _atomic_npy_save(path, part)
                done_shards[name] = len(part)
                commit_marker()  # a crash after this point proves the shard
                shards.append({"file": name, "rows": len(part)})
            manifest["vector_shards"] = shards
        else:
            step = max(1, HOST_CHUNK_ELEMS // max(dim, 1))
            _atomic_npy_chunks(
                os.path.join(directory, "vectors.npy"), (len(ids_live), dim), vtype.host_dtype,
                (read(s, min(s + step, count)) for s in range(0, count, step)),
            )
        if quant is not None:
            manifest["quant"] = {
                "qtype": quant.qtype.value,
                "scale": float(quant.scale),
                "offset": float(quant.offset),
                "count": quant.count,
                "stale": quant.stale,
            }
            n = quant.count
            files = {"qcodes.npy": quant.codes}
            if quant.qtype is QuantType.I4:
                files.update({"qrow_scale.npy": quant.row_scale, "qcsq.npy": quant.sq_norms})
            if quant.codes8 is not None:
                manifest["quant"]["refine"] = {
                    "qtype8": quant.qtype8.value,
                    "scale8": float(quant.scale8),
                    "offset8": float(quant.offset8),
                }
                files["qcodes8.npy"] = quant.codes8
            for name, arr in files.items():
                if arr is not None:
                    _atomic_npy_save(os.path.join(directory, name), _to_numpy(arr, n))
            _atomic_npy_save(os.path.join(directory, "qids.npy"), quant.ids)
        _write_json_atomic(os.path.join(directory, "manifest.json"), manifest, indent=2)
        try:
            os.unlink(marker_path)  # the manifest is now the provenance
        except OSError:
            pass

    @classmethod
    def save_stream(
        cls,
        directory: str,
        chunks,
        *,
        options: str | VectorOptions | None = None,
        name: str = "dataset",
        ids_start: int = 1,
    ) -> int:
        """Write a save()-compatible directory from an iterator of
        [rows, dim] chunks, one shard file per chunk, never holding the
        matrix whole (for datasets larger than RAM, opened afterwards with
        load(directory, storage="host", mmap=True)). Row ids run from
        `ids_start`. Returns the row count. The crash discipline is
        save()'s: a stream that dies over a completed directory leaves its
        marker, and load() refuses the mixed state."""
        opts = dataclasses.replace(options) if isinstance(options, VectorOptions) else parse_options(options)
        os.makedirs(directory, exist_ok=True)
        token = os.urandom(16).hex()
        marker_path = os.path.join(directory, "save_in_progress.json")
        _write_json_atomic(marker_path, {"data_token": token, "done_shards": {}})
        vtype = opts.type
        cast = bf16_bits if vtype is VectorType.BF16 else (lambda a: a.astype(vtype.np_dtype, copy=False))
        shards, count, dim, nonfinite = [], 0, opts.dimension, False
        for i, chunk in enumerate(chunks):
            arr = np.asarray(chunk)
            if arr.ndim != 2:
                raise VectorConfigError(f"save_stream: chunk {i} is not a [rows, dim] array")
            if dim <= 0:
                dim = int(arr.shape[1])
            if arr.shape[1] != dim:
                raise VectorConfigError(
                    f"Invalid vector dimension: expected {dim} but found {arr.shape[1]}."
                )
            arr = cast(arr)
            nonfinite = nonfinite or _scan_nonfinite(arr, vtype, len(arr))
            fname = f"vectors-{i:05d}.npy"
            _atomic_npy_save(os.path.join(directory, fname), arr)
            shards.append({"file": fname, "rows": int(len(arr))})
            count += len(arr)
        if dim <= 0:
            raise VectorConfigError(
                "Required 'dimension' option is missing (it must be "
                "specified in vector_init)."
            )
        if not shards:
            # load() reads an empty shard list as "no shards": write one
            # empty shard, as save() does
            _atomic_npy_save(os.path.join(directory, "vectors-00000.npy"), np.zeros((0, dim), vtype.host_dtype))
            shards.append({"file": "vectors-00000.npy", "rows": 0})
        _atomic_npy_save(
            os.path.join(directory, "ids.npy"), np.arange(ids_start, ids_start + count, dtype=np.int64)
        )
        manifest = {
            "name": name,
            "version": 2,
            "type": vtype.value,
            "dimension": dim,
            "distance": opts.distance.value,
            "normalized": opts.normalized,
            "max_memory": opts.max_memory,
            "count": count,
            "next_rowid": ids_start + count,
            "has_nonfinite": nonfinite,
            "data_token": token,  # the marker's: a leftover marker is this stream
            "quant": None,
            "vector_shards": shards,
        }
        _write_json_atomic(os.path.join(directory, "manifest.json"), manifest, indent=2)
        try:
            os.remove(marker_path)
        except OSError:
            pass
        return count

    @classmethod
    def load(
        cls,
        directory: str,
        *,
        device: Any = None,
        storage: str = "hbm",
        mmap: bool = False,
        sharding: Any = None,
        mesh: Any = None,
    ) -> "Dataset":
        """Open a directory written by save() or save_stream() (of either
        package). storage="hbm" uploads the rows and codes to the device,
        shard by shard; storage="host" keeps them on the host (the codes,
        with the refine sidecar, until preload()); mmap=True with host
        storage attaches the memory-mapped shards with no RAM copy (one
        shard as-is, several behind hostarray.ShardedRows). The row ids,
        next rowid, data token and non-finite flag come back as saved.
        Refuses (ValueError) a directory holding an interrupted save of
        other content than its manifest describes."""
        with open(os.path.join(directory, "manifest.json")) as f:
            manifest = json.load(f)
        marker_path = os.path.join(directory, "save_in_progress.json")
        if os.path.exists(marker_path):
            # an interrupted save of OTHER content may have replaced some
            # shards: the manifest would stitch two generations together
            try:
                with open(marker_path) as f:
                    marker_token = json.load(f).get("data_token")
            except (OSError, ValueError):
                marker_token = None
            if marker_token != manifest.get("data_token"):
                raise ValueError(
                    f"{directory!r} holds an interrupted save of different "
                    "content than its manifest describes (shard files may "
                    "be mixed-generation). Re-run Dataset.save() from the "
                    "source data, or delete save_in_progress.json only if "
                    "the directory is known consistent."
                )
        options = VectorOptions(
            type=VectorType.from_name(manifest["type"]),
            dimension=manifest["dimension"],
            normalized=manifest.get("normalized", False),
            max_memory=manifest.get("max_memory", 0) or 0,
            distance=DistanceMetric.from_name(manifest["distance"]),
        )
        ds = cls(manifest["name"], options, device=device, storage=storage, sharding=sharding, mesh=mesh)
        ids = np.load(os.path.join(directory, "ids.npy"))
        files = [sh["file"] for sh in manifest.get("vector_shards") or []] or ["vectors.npy"]
        parts = [
            np.load(os.path.join(directory, f), mmap_mode="r" if mmap or storage == "hbm" else None)
            for f in files
        ]
        if len(ids):
            vecs = parts[0] if len(parts) == 1 else (
                ShardedRows(parts) if mmap or storage == "hbm" else np.concatenate(parts)
            )
            if storage == "host":
                ds._attach_host(vecs, ids)
            else:
                ds._install_rows(vecs, ids)
        ds._next_rowid = manifest.get("next_rowid", ds._next_rowid)
        # the loaded rows ARE the saved content: a checkpointed quantize or
        # a save resume of that content stays valid across the round trip
        ds._data_token = manifest.get("data_token", ds._data_token)
        ds._has_nonfinite = bool(manifest.get("has_nonfinite", False))
        q = manifest.get("quant")
        if q:
            ds._quant = ds._load_quant(directory, q, ids)
        return ds

    def _install_rows(self, vecs: Any, ids: np.ndarray) -> None:
        """Upload host-form rows into an empty device-storage dataset."""
        n = len(ids)
        self._vectors = upload_rows(vecs, n, self.device, _next_capacity(n))
        self._ids = np.asarray(ids, np.int64)
        self._dead = np.zeros((n,), bool)
        self._invalidate_row_caches()
        self._count = n
        self._next_rowid = int(self._ids.max()) + 1 if n else 1

    def _load_quant(self, directory: str, q: dict, ids: np.ndarray) -> _QuantState:
        """The saved quantization: on the host (memory-mapped codes) with
        host storage, uploaded otherwise."""
        qtype = QuantType.from_name(q["qtype"])
        count = int(q["count"])

        def array(name: str, mmap: bool = True):
            path = os.path.join(directory, name)
            if not (count and os.path.exists(path)):
                return None
            arr = np.load(path, mmap_mode="r" if mmap else None)
            if self._storage == "host":
                return arr
            return upload_rows(arr, count, self.device)

        qids_path = os.path.join(directory, "qids.npy")
        qids = np.load(qids_path) if os.path.exists(qids_path) else ids[:count].copy()
        state = _QuantState(
            qtype, np.float32(q["scale"]), np.float32(q["offset"]), array("qcodes.npy"),
            count, qids, stale=q.get("stale", False),
        )
        if qtype is QuantType.I4 and state.codes is not None:
            state.row_scale = array("qrow_scale.npy", mmap=False)
            state.sq_norms = array("qcsq.npy", mmap=False)
        r8 = q.get("refine")
        if r8 and state.codes is not None:
            state.codes8 = array("qcodes8.npy")
            if state.codes8 is not None:
                state.qtype8 = QuantType.from_name(r8["qtype8"])
                state.scale8, state.offset8 = np.float32(r8["scale8"]), np.float32(r8["offset8"])
        return state


class VectorStore:
    """A named registry of Datasets on one device (the reference's
    per-connection vector_context). Lookups are case-insensitive.

    device=None means the first CUDA device; without one it raises
    VectorConfigError rather than run on the CPU. Pass device="cpu" to
    run on the CPU."""

    def __init__(self, *, device: Any = None, sharding: Any = None, mesh: Any = None):
        if mesh is not None or sharding is not None:
            raise _unported("Meshes and shardings", "mesh")
        self._device = resolve_device(device)
        self._datasets: dict[str, Dataset] = {}
        self._lock = threading.Lock()

    def create(
        self,
        name: str,
        options: str | VectorOptions | None = None,
        **kwargs: Any,
    ) -> Dataset:
        """Create (or idempotently re-open) a dataset.

        Mirrors vector_init (src/sqlite-vector.c:2491-2543): requires
        dimension; re-init with consistent options returns the existing
        dataset, inconsistent dim/type raises.
        kwargs: dimension=, type=, distance=, qtype= override the options.
        """
        if isinstance(options, VectorOptions):
            opts = dataclasses.replace(options)
        else:
            opts = parse_options(options)
        if "dimension" in kwargs:
            opts.dimension = int(kwargs["dimension"])
        if "type" in kwargs:
            t = kwargs["type"]
            opts.type = VectorType.from_name(t) if isinstance(t, str) else t
        if "distance" in kwargs:
            d = kwargs["distance"]
            opts.distance = (
                DistanceMetric.from_name(d) if isinstance(d, str) else d
            )
        if "qtype" in kwargs:
            qt = kwargs["qtype"]
            opts.qtype = QuantType.from_name(qt) if isinstance(qt, str) else qt

        key = name.lower()
        with self._lock:
            existing = self._datasets.get(key)
            if existing is not None:
                if existing.options.dimension != opts.dimension:
                    raise VectorConfigError(
                        "A vector dimension mismatch was detected: dataset was "
                        f"initialized with dimension {existing.options.dimension}."
                    )
                if existing.options.type is not opts.type:
                    raise VectorConfigError(
                        "A vector type mismatch was detected: dataset was "
                        f"initialized with type {existing.options.type.value}."
                    )
                # re-init keeps the existing context untouched
                return existing
            ds = Dataset(name, opts, device=self._device)
            self._datasets[key] = ds
            return ds

    def get(self, name: str) -> Dataset:
        ds = self._datasets.get(name.lower())
        if ds is None:
            raise VectorStateError(
                f"Dataset '{name}' not found — call create() first (reference "
                "requires vector_init before any vector operation)."
            )
        return ds

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._datasets

    def drop(self, name: str) -> None:
        with self._lock:
            self._datasets.pop(name.lower(), None)

    def names(self) -> list[str]:
        with self._lock:
            return [ds.name for ds in self._datasets.values()]
