"""Dataset and VectorStore on PyTorch: the exact, int8, int4 and refine
search slices.

Port of sqlite_vector_tpu/dataset.py for its main path: create -> add ->
search(exact) -> quantize() -> search(quantized), on one device, with int8
codes or packed int4 codes (quantize(qtype="int4")), and the two-stage
search(mode="refine") over an int4 quantization with its int8 sidecar
(quantize(qtype="int4", refine=True)). The matrix lives on the device as a
[capacity, dim] tensor that doubles as rows are appended; searches snapshot
(count, matrix) and scan the first `count` rows through
ops.scan.fused_scan_topk; int4 scans go through
ops.quantize4.int4_scan_topk and refine through ops.refine.int4_refine_topk.

Everything outside the slice raises VectorConfigError naming the ROADMAP
item that will port it.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Sequence

import numpy as np
import torch

from sqlite_vector_tpu_torch.codec import blob_to_array, vector_from_json
from sqlite_vector_tpu_torch.device import from_numpy, resolve_device
from sqlite_vector_tpu_torch.errors import (
    VectorCodecError,
    VectorConfigError,
    VectorStateError,
)
from sqlite_vector_tpu_torch.ops.distance import NEARLY_ZERO
from sqlite_vector_tpu_torch.ops.quantize import (
    QUANT_TORCH_DTYPE,
    minmax_and_negative,
    quantize_device,
    resolve_quant_params,
)
from sqlite_vector_tpu_torch.ops.quantize4 import int4_scan_topk, quantize4_device
from sqlite_vector_tpu_torch.ops.refine import int4_refine_topk
from sqlite_vector_tpu_torch.ops.scan import fused_scan_topk
from sqlite_vector_tpu_torch.types import (
    DistanceMetric,
    QuantType,
    VectorOptions,
    VectorType,
    parse_options,
)

MIN_CAPACITY = 1024
# rows per chunk of the quantize pass (bounds its float32 temporaries)
_QUANT_CHUNK_ELEMS = 1 << 26

_FLOAT_TYPES = (VectorType.F32, VectorType.F16, VectorType.BF16)
TORCH_DTYPE = {
    VectorType.F32: torch.float32,
    VectorType.F16: torch.float16,
    VectorType.BF16: torch.bfloat16,
    VectorType.U8: torch.uint8,
    VectorType.I8: torch.int8,
}

# What the slice leaves out, by the ROADMAP.md queue-1 item that ports it.
_ROADMAP_ITEM = {
    "search": "1 (rerank and approx modes, Dataset.distances)",
    "masks": "2 (remove/update/compact, ids_filter row masks)",
    "nonfinite": "3 (nonfinite.py policy twins)",
    "host": "5 (host-storage streaming)",
    "persistence": "6 (persistence)",
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


def _to_host(t: torch.Tensor, vtype: VectorType) -> np.ndarray:
    if vtype is VectorType.BF16:
        return t.float().cpu().numpy().astype(vtype.np_dtype)
    return t.cpu().numpy()


@dataclasses.dataclass
class _QuantState:
    qtype: QuantType
    scale: np.float32
    offset: np.float32
    codes: torch.Tensor | None  # [count, dim] u8/i8 on the device; for INT4
    # the PACKED [count, ceil(dim/2)] uint8 codes (ops/quantize4.py)
    count: int  # rows quantized
    ids: np.ndarray  # row ids AT QUANTIZE TIME (the codes go stale on add)
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


class Dataset:
    """A named collection of fixed-dimension vectors with one distance
    metric, resident on one torch device."""

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
        if storage == "host":
            raise _unported("storage='host'", "host")
        if mesh is not None or sharding is not None:
            raise _unported("Meshes and shardings", "mesh")
        self.name = name
        self.options = options
        self.device = resolve_device(device)
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

    # -- properties ---------------------------------------------------------

    def __len__(self) -> int:
        return self._count

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
    def quant_params(self) -> tuple[QuantType, float, float] | None:
        q = self._quant
        return (q.qtype, float(q.scale), float(q.offset)) if q else None

    @property
    def quant_stale(self) -> bool:
        """True when rows were added after the last quantize(): quantized
        scans still run on the old codes, as in the reference."""
        return bool(self._quant and self._quant.stale)

    @property
    def ids(self) -> np.ndarray:
        with self._mutate_lock:
            return self._ids[: self._count]

    def memory_bytes(self) -> int:
        """Device bytes held by the matrix (padded capacity) and the codes
        (packed bytes for int4; alpha, csq and the refine sidecar are not
        counted, as in the JAX package)."""
        total = 0
        vecs, quant = self._vectors, self._quant
        if vecs is not None:
            total += vecs.numel() * vecs.element_size()
        if quant is not None and quant.codes is not None:
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
        are marked stale, not rebuilt (reference contract: API.md:242).
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
            if self._count and np.isin(new_ids, self._ids[: self._count]).any():
                raise VectorConfigError(
                    "add: id(s) already exist — use update() to replace rows"
                )
        self._next_rowid = max(self._next_rowid, int(new_ids.max()) + 1)

        start, end = self._count, self._count + n_new
        rows = from_numpy(arr, self.device)
        if self.dtype in _FLOAT_TYPES and not self._has_nonfinite:
            self._has_nonfinite = not bool(torch.isfinite(rows).all())
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
        self._id_pos_cache = None
        self._count = end
        if self._quant is not None:
            self._quant.stale = True
        return new_ids

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
        dtype (the rows are uploaded to the device)."""
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
        if vectors.dtype != opts.type.np_dtype:
            raise VectorConfigError(
                f"from_arrays: array dtype {vectors.dtype} does not match "
                f"the dataset type {opts.type.value}; cast first or use add()."
            )
        ds = cls(name, opts, **kwargs)
        n = vectors.shape[0]
        ids = np.arange(1, n + 1, dtype=np.int64) if ids is None else ids
        if np.asarray(ids).shape != (n,):
            raise VectorConfigError("ids must have one entry per vector")
        if n:
            ds.add(vectors, ids)
        return ds

    def get(self, ids: Sequence[int] | np.ndarray) -> np.ndarray:
        """Fetch stored vectors by row id. Unknown ids raise."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        with self._mutate_lock:
            id_to_pos = self._id_to_pos()
            try:
                pos = [id_to_pos[int(i)] for i in ids]
            except KeyError as e:
                raise VectorStateError(
                    f"get: unknown row id {e.args[0]}"
                ) from None
            index = torch.tensor(pos, dtype=torch.int64, device=self.device)
            return _to_host(self._vectors[index], self.dtype)

    def _id_to_pos(self) -> dict[int, int]:
        if self._id_pos_cache is None:
            self._id_pos_cache = {
                int(v): i for i, v in enumerate(self._ids[: self._count])
            }
        return self._id_pos_cache

    def _coerce_batch(self, vectors: Any) -> np.ndarray:
        dim = self.dimension
        np_dtype = self.dtype.np_dtype
        if isinstance(vectors, (str, bytes, bytearray, memoryview)):
            vectors = [vectors]
        if isinstance(vectors, np.ndarray) and vectors.ndim in (1, 2):
            arr = np.atleast_2d(vectors)
            if arr.shape[1] != dim:
                raise VectorCodecError(
                    f"Invalid vector dimension: expected {dim} but found {arr.shape[1]}."
                )
            return np.ascontiguousarray(arr.astype(np_dtype, copy=False))
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
                rows.append(a.astype(np_dtype, copy=False))
        return np.stack(rows) if rows else np.zeros((0, dim), np_dtype)

    # -- queries --------------------------------------------------------------

    def _coerce_queries(self, queries: Any) -> tuple[np.ndarray, bool]:
        """Returns (queries [B, dim] in the dataset dtype, was_single)."""
        dim = self.dimension
        if isinstance(queries, str):
            return vector_from_json(queries, self.dtype, dim)[None, :], True
        if isinstance(queries, (bytes, bytearray, memoryview)):
            return blob_to_array(bytes(queries), self.dtype, dim)[None, :], True
        arr = np.asarray(queries)
        single = arr.ndim == 1
        arr = np.atleast_2d(arr)
        if arr.shape[1] != dim:
            raise VectorCodecError(
                f"Invalid vector dimension: expected {dim} but found {arr.shape[1]}."
            )
        return arr.astype(self.dtype.np_dtype), single

    def search(
        self,
        queries: Any,
        k: int,
        *,
        exact: bool = True,
        mode: str | None = None,
        expand: int = 4,
        ids_filter: Sequence[int] | np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k nearest neighbors.

        Returns (ids [B, k] int64, distances [B, k] float32), both sorted by
        ascending distance; slots beyond the available rows hold id -1 /
        distance +inf. Single-vector queries return [k]-shaped results with
        unfilled slots trimmed.

        mode "exact" (the default, vector_full_scan) scans the full-precision
        rows; "quantized" (exact=False, vector_quantize_scan) scans the
        codes: int8 codes return integer-domain distances, packed int4 codes
        approximate original-domain ones; "refine" scans the int4 codes for
        k*expand candidates and rescores them against the int8 sidecar
        (requires quantize(qtype="int4", refine=True)). Positions of the
        quantized and refine modes index the quantize-time snapshot. The JAX
        package's "rerank" and "approx" modes (with `recall_target`) and
        `ids_filter` are not ported yet and raise VectorConfigError.
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
        if mode in ("rerank", "approx"):
            raise _unported(f"search(mode='{mode}')", "search")
        if ids_filter is not None:
            raise _unported("search(ids_filter=...)", "masks")
        q, single = self._coerce_queries(queries)
        if k == 0 or self._count == 0:
            if single:
                return np.zeros((0,), np.int64), np.zeros((0,), np.float32)
            return (
                np.full((q.shape[0], k), -1, np.int64),
                np.full((q.shape[0], k), np.inf, np.float32),
            )
        if mode in ("exact", "refine") and self.dtype in (VectorType.F16, VectorType.BF16):
            # lane-skip dtypes need the reference's non-finite policy
            # kernels; the JAX package routes refine over such data to them
            # too (its int8 rescore cannot honor their semantics)
            if self._has_nonfinite or not _finite(q):
                raise _unported(
                    "Exact search over non-finite float16/bfloat16 data", "nonfinite"
                )

        # ONE quant snapshot: the scanned codes and the id map agree. Rows
        # never move in this slice (add() only appends), so positions map to
        # ids without the reference's layout-generation retry, which comes
        # with compaction (ROADMAP.md queue 1, item 2)
        quant = self._quant
        cosine_fast = mode == "exact" and self._cosine_dot_fast(q)
        if mode == "exact":
            vals, idx = self._search_exact(q, k, cosine_fast)
        elif mode == "refine":
            vals, idx = self._search_refine(q, k, expand, quant)
        else:
            vals, idx = self._search_quantized(q, k, quant)
        # one device->host copy for both outputs: float32 values and int
        # positions (< 2^53) are both exact in float64
        host = torch.stack([vals.double(), idx.double()]).cpu().numpy()
        vals = host[0].astype(np.float32)
        idx = host[1].astype(np.int64)
        if cosine_fast:
            # the fast path scanned -dot: shift to 1 - dot (monotonic), clamp
            # into the reference's cosine range and re-snap
            vals = np.where(np.isposinf(vals), vals, np.clip(vals + 1.0, 0.0, 2.0))
            vals = np.where(np.abs(vals) <= NEARLY_ZERO, 0.0, vals).astype(np.float32)
        # quantized and refine positions index the codes AT QUANTIZE TIME
        id_map = self._ids if mode == "exact" else quant.ids
        n_map = len(id_map)
        valid = (idx >= 0) & (idx < n_map)
        if n_map == 0:
            out_ids = np.full(idx.shape, -1, np.int64)
        else:
            out_ids = np.where(valid, id_map[np.clip(idx, 0, n_map - 1)], -1)
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

    def _search_exact(self, q: np.ndarray, k: int, cosine_fast: bool):
        metric = self.metric
        if cosine_fast:
            metric = DistanceMetric.DOT
            q = _unit_rows(q)
        # count BEFORE the matrix: add() publishes the count only after its
        # rows landed in the matrix it installed, so every matrix read after
        # the count holds those rows
        count = self._count
        vecs = self._vectors
        qd = from_numpy(q, self.device)
        return fused_scan_topk(qd, vecs[:count], metric, k)

    def _search_quantized(self, q: np.ndarray, k: int, quant: _QuantState | None):
        quant = self._require_quant("vector_quantize_scan", quant)
        qf = from_numpy(q.astype(np.float32), self.device)
        if quant.qtype is QuantType.I4:
            # per-query int8 codes are built inside the int4 scan
            return int4_scan_topk(
                qf, quant.codes, quant.row_scale, quant.sq_norms, self.metric, k,
                dim=self.dimension, valid_count=quant.count,
            )
        # query quantization with the stored params (src/sqlite-vector.c:2162-2177)
        qq = quantize_device(qf, quant.scale, quant.offset, quant.qtype)
        return fused_scan_topk(qq, quant.codes, self.metric, k)

    def _search_refine(
        self, q: np.ndarray, k: int, expand: int, quant: _QuantState | None
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
        return int4_refine_topk(
            from_numpy(q.astype(np.float32), self.device),
            quant.codes, quant.row_scale, quant.sq_norms, quant.codes8,
            quant.scale8, quant.offset8, self.metric, k,
            dim=self.dimension, expand=expand, valid_count=quant.count,
        )

    def _require_quant(self, caller: str, quant: _QuantState | None) -> _QuantState:
        if quant is None or quant.codes is None:
            raise VectorStateError(
                f"{caller}: quantization not found — run quantize() first "
                "(reference requires vector_quantize before vector_quantize_scan)."
            )
        return quant

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
        """
        if checkpoint is not None:
            raise _unported("quantize(checkpoint=...)", "persistence")
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
            count = self._count
            ids = self._ids[:count].copy()
            if count == 0:
                # reference: zero rows still records resolved params
                resolved = (
                    QuantType.U8 if opts.qtype is QuantType.AUTO else opts.qtype
                )
                self._quant = _QuantState(
                    resolved, np.float32(1.0), np.float32(0.0), None, 0, ids
                )
                return 0
            vecs = self._vectors[:count]
            if opts.qtype is QuantType.I4:
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
                self._quant = state
                return count
            mn, mx, neg = minmax_and_negative(vecs)
            rqtype, scale, offset = resolve_quant_params(mn, mx, neg, opts.qtype)
            codes = self._encode8(vecs, scale, offset, rqtype)
            self._quant = _QuantState(rqtype, scale, offset, codes, count, ids)
            return count

    def _encode8(self, vecs: torch.Tensor, scale, offset, qtype: QuantType) -> torch.Tensor:
        """int8/uint8 codes of `vecs`, in row chunks that bound the float32
        temporaries."""
        codes = torch.empty(
            vecs.shape, dtype=QUANT_TORCH_DTYPE[qtype], device=self.device
        )
        rows = max(1, _QUANT_CHUNK_ELEMS // self.dimension)
        for s in range(0, vecs.shape[0], rows):
            codes[s : s + rows] = quantize_device(vecs[s : s + rows], scale, offset, qtype)
        return codes

    def _install_quant(
        self, codes: np.ndarray, qtype: QuantType, scale: float, offset: float
    ) -> None:
        """Adopt int8/uint8 codes built elsewhere for the current rows
        (interop)."""
        with self._mutate_lock:
            self._check_codes(codes, qtype)
            self._quant = _QuantState(
                qtype,
                np.float32(scale),
                np.float32(offset),
                from_numpy(codes, self.device),
                self._count,
                self._ids[: self._count].copy(),
            )

    def _install_quant4(
        self,
        packed: np.ndarray,
        alpha: np.ndarray,
        csq: np.ndarray,
        sidecar: tuple[np.ndarray, QuantType, float, float] | None = None,
    ) -> None:
        """Adopt an int4 quantization built elsewhere for the current rows
        (interop), with its refine sidecar (codes8, qtype8, scale8, offset8)
        when given."""
        with self._mutate_lock:
            count = self._count
            want = (count, (self.dimension + 1) // 2)
            if packed.shape != want or packed.dtype != np.uint8:
                raise VectorConfigError(
                    f"packed codes must be uint8 {want}, got {packed.dtype} "
                    f"{packed.shape}"
                )
            if alpha.shape != (count,) or csq.shape != (count,):
                raise VectorConfigError("alpha and csq must have one entry per row")
            state = _QuantState(
                QuantType.I4, np.float32(1.0), np.float32(0.0),
                from_numpy(packed, self.device), count,
                self._ids[:count].copy(),
                row_scale=from_numpy(alpha.astype(np.float32), self.device),
                sq_norms=from_numpy(csq.astype(np.int32), self.device),
            )
            if sidecar is not None:
                codes8, qtype8, scale8, offset8 = sidecar
                self._check_codes(codes8, qtype8)
                state.codes8 = from_numpy(codes8, self.device)
                state.qtype8 = qtype8
                state.scale8, state.offset8 = np.float32(scale8), np.float32(offset8)
            self._quant = state

    def _check_codes(self, codes: np.ndarray, qtype: QuantType) -> None:
        if codes.shape != (self._count, self.dimension):
            raise VectorConfigError(
                f"codes shape {codes.shape} != ({self._count}, {self.dimension})"
            )
        if codes.dtype != qtype.np_dtype:
            raise VectorConfigError(
                f"codes dtype {codes.dtype} does not match qtype {qtype.value}"
            )


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
