"""SQLite surface: the reference's SQL API over the PyTorch engine.

Port of sqlite_vector_tpu/sqlite.py. The reference is a loadable SQLite
extension whose whole API is 14 scalar SQL functions and 4 table-valued
virtual tables; this module registers that surface on a stdlib sqlite3
connection, with the scans run by the port's Dataset on its device:

    import sqlite_vector_tpu_torch.sqlite as svs
    conn = svs.connect("embeddings.db")          # the card; device="cpu"
    conn.execute("SELECT vector_init('docs', 'embedding',"
                 " 'type=FLOAT32,dimension=384,distance=L2')")
    conn.execute("SELECT vector_quantize('docs', 'embedding')")
    rows = conn.execute("SELECT id, distance FROM "
                        "vector_full_scan('docs', 'embedding', ?, 20)", (q,))

The files are byte-compatible with the C extension's and the JAX
package's: the same typed little-endian blobs, the `_sqliteai_vector`
metadata rows and the `vector0_<tbl>_<col>` shadow tables of [int64 rowid]
[dim code bytes] records (`vector0i4_<tbl>_<col>` for the packed int4
extension), so either engine opens the other's files.

The table-valued scans are real virtual tables when the loadable vtab
extension builds (native.vtab_extension_path: csrc/svt_vtab.c, whose
xFilter calls back into this connection's svt_scan_blob); they are also
Python methods and `*_json` scalar functions composable with json_each:

    SELECT e.value ->> 'id', e.value ->> 'distance'
    FROM json_each(vector_full_scan_json('docs','embedding', :q, 20)) AS e;

Exact scans and the quantized scans of codes this connection built go
through the Dataset (K1, or K2 for int4, on CUDA tensors); codes loaded
from another connection's shadow table are scanned by the same routers
(ops.scan.fused_scan_topk, ops.quantize4.int4_scan_topk) with the same
arguments as the Dataset passes, so both return the same values.

connect(mesh=) lays every dataset of the connection out over the mesh
(Dataset(mesh=)); on a 1-D mesh the codes read from another connection's
shadow table are row-sharded too and scanned by parallel/ops.py (on a 2-D
mesh they stay whole on its first device, as the JAX package's do).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sqlite3
import struct
from typing import Any, Iterator

import numpy as np
import torch

from sqlite_vector_tpu_torch.codec import blob_to_array, vector_as_blob, vector_from_json
from sqlite_vector_tpu_torch.dataset import Dataset, _to_numpy, mesh_layout, place_rows
from sqlite_vector_tpu_torch.device import bits_to_f32, from_numpy, resolve_device
from sqlite_vector_tpu_torch.errors import (
    VectorCodecError,
    VectorConfigError,
    VectorStateError,
)
from sqlite_vector_tpu_torch.native import load_blobs as native_load_blobs
from sqlite_vector_tpu_torch.native import vtab_extension_path
from sqlite_vector_tpu_torch.ops.quantize import quantize_device
from sqlite_vector_tpu_torch.parallel.ops import (
    join_columns,
    sharded_int4_scan_distances,
    sharded_int4_scan_topk,
    sharded_scan_distances,
    sharded_scan_topk,
)
from sqlite_vector_tpu_torch.parallel.shards import RowShards
from sqlite_vector_tpu_torch.ops.quantize4 import (
    int4_scan_distances,
    int4_scan_topk,
    packed_width,
)
from sqlite_vector_tpu_torch.ops.scan import fused_scan_topk, scan_distances
from sqlite_vector_tpu_torch.types import QuantType, VectorOptions, VectorType, parse_options
from sqlite_vector_tpu_torch.version import backend as _backend
from sqlite_vector_tpu_torch.version import version as _version

# the reference's enum values (src/distance-cpu.h:46-48); 3 is the packed
# int4 extension, stored under its own shadow-table name (_shadow_name_i4)
_QTYPE_TO_INT = {
    QuantType.AUTO: 0, QuantType.U8: 1, QuantType.I8: 2, QuantType.I4: 3,
}
_INT_TO_QTYPE = {1: QuantType.U8, 2: QuantType.I8, 3: QuantType.I4}

_INTERNAL_TABLE_SQL = (
    "CREATE TABLE IF NOT EXISTS _sqliteai_vector (tblname TEXT, colname TEXT, "
    "key TEXT, value ANY, PRIMARY KEY(tblname, colname, key));"
)


def _quote(name: str) -> str:
    """SQLite identifier quoting (the %q analogue for identifiers)."""
    return '"' + name.replace('"', '""') + '"'


def _shadow_name(table: str, column: str) -> str:
    return f"vector0_{table}_{column}"


def _shadow_name_i4(table: str, column: str) -> str:
    """Packed-int4 shadow table name, deliberately not the reference's
    vector0_*: the C extension never validates the stored qtype and
    assumes records of 8 + dim bytes, so under the legacy name it would
    misread int4 records (16 + ceil(dim/2) bytes); under this one its
    preload fails cleanly ('quantization table not found')."""
    return f"vector0i4_{table}_{column}"


def _host_rows(data: bytes, vtype: VectorType, count: int, dim: int) -> np.ndarray:
    """Packed little-endian blobs as [count, dim] rows in the port's host
    form (bfloat16 as its uint16 bits)."""
    return np.frombuffer(data, dtype=vtype.host_dtype).reshape(count, dim)


@dataclasses.dataclass
class _QuantCache:
    qtype: QuantType
    scale: float
    offset: float
    codes: Any  # [count, dim] u8/i8 on the device ([count, P] packed u8
    # for INT4), or None without rows
    ids: np.ndarray | None  # row ids aligned with the code rows
    count: int
    sq_norms: Any = None  # INT4: per-row csq (i32)
    row_scale: Any = None  # INT4: per-row alpha (f32)


@dataclasses.dataclass
class _TableContext:
    table: str
    column: str
    pk: str
    options: VectorOptions
    dataset: Dataset | None = None
    stamp: tuple | None = None
    # table-wide MAX(pk) at the last load: the append fast path loads only
    # pk > max_pk
    max_pk: int | None = None
    quant: _QuantCache | None = None
    # quant was built inside a caller's open transaction: before serving it
    # outside one, check the shadow table survived (a ROLLBACK is invisible
    # to the change stamp)
    quant_provisional: bool = False
    # PRAGMA schema_version when `quant` was built or loaded: every
    # re-quantize (either engine's) DROP+CREATEs the shadow table, bumping
    # the cookie, and a ROLLBACK reverts it, so a moved cookie means the
    # cached codes are not the on-disk generation
    quant_schema_ver: int | None = None
    # quant params restored from _sqliteai_vector (sqlite_unserialize parity)
    stored_qtype: QuantType | None = None
    stored_scale: float | None = None
    stored_offset: float | None = None


class VectorConnection:
    """A sqlite3.Connection wrapper with the vector SQL surface registered.

    Mirrors one connection's `vector_context` in the reference
    (src/sqlite-vector.c:2555-2638): a per-connection registry, the
    metadata table and the scalar functions. Its datasets live on
    `device` (None: the first CUDA device; without one it raises, as
    VectorStore does; pass device="cpu" to run on the CPU), or over `mesh`
    (parallel.make_mesh), whose first device then plays `device`.
    """

    def __init__(self, conn: sqlite3.Connection, *, device: Any = None, mesh: Any = None):
        self._mesh = mesh_layout(mesh, None)
        self._conn = conn
        self._device = self._mesh.grid()[0][0] if self._mesh is not None else resolve_device(device)
        self._contexts: dict[tuple[str, str], _TableContext] = {}
        self.vtab_loaded = False
        # which loader filled the datasets last: "native" or "python"
        self.last_loader: str | None = None
        conn.execute(_INTERNAL_TABLE_SQL)
        self._register_functions()
        self._load_vtab_extension()

    # -- plumbing -------------------------------------------------------------

    def __getattr__(self, name: str) -> Any:
        return getattr(self._conn, name)

    def __enter__(self):
        self._conn.__enter__()
        return self

    def __exit__(self, *exc):
        return self._conn.__exit__(*exc)

    @property
    def connection(self) -> sqlite3.Connection:
        return self._conn

    @property
    def device(self) -> torch.device:
        return self._device

    def _register_functions(self) -> None:
        c = self._conn
        c.create_function("vector_version", 0, lambda: _version(), deterministic=True)
        c.create_function("vector_backend", 0, lambda: _backend(), deterministic=True)
        for name, vtype in (
            ("vector_as_f32", VectorType.F32),
            ("vector_as_f16", VectorType.F16),
            ("vector_as_bf16", VectorType.BF16),
            ("vector_as_i8", VectorType.I8),
            ("vector_as_u8", VectorType.U8),
        ):
            c.create_function(name, -1, _make_vector_as(vtype), deterministic=True)
        c.create_function("vector_init", 3, self.vector_init)
        c.create_function("vector_quantize", 2, self.vector_quantize)
        c.create_function("vector_quantize", 3, self.vector_quantize)
        c.create_function("vector_quantize_memory", 2, self.vector_quantize_memory)
        c.create_function("vector_quantize_preload", 2, self.vector_quantize_preload)
        c.create_function("vector_quantize_cleanup", 2, self.vector_quantize_cleanup)
        c.create_function("vector_full_scan_json", 4, self._full_scan_json)
        c.create_function("vector_quantize_scan_json", 4, self._quantize_scan_json)
        # internal bridge for the loadable vtab extension (csrc/svt_vtab.c)
        c.create_function("svt_scan_blob", 5, self._scan_blob)

    def _load_vtab_extension(self) -> None:
        """Register the real table-valued scan modules, so SQL written for
        the C reference runs verbatim:

            SELECT id, distance FROM vector_full_scan('t', 'c', ?, 20)

        stdlib sqlite3 has no virtual-table API, so the modules live in a
        small loadable C extension (csrc/svt_vtab.c) whose xFilter calls
        back into this connection's svt_scan_blob function. Without
        extension loading (or SVT_DISABLE_VTAB=1) vtab_loaded stays False
        and the json_each shims remain."""
        if os.environ.get("SVT_DISABLE_VTAB") == "1":
            return
        path = vtab_extension_path()
        if not path or not hasattr(self._conn, "enable_load_extension"):
            return
        try:
            self._conn.enable_load_extension(True)
            try:
                # the full path, suffix included: without it SQLite appends
                # the platform's suffix, which need not match the file
                self._conn.load_extension(path)
                self.vtab_loaded = True
            finally:
                self._conn.enable_load_extension(False)
        except sqlite3.Error:
            self.vtab_loaded = False

    def _scan_blob(self, fname: str, table: str, column: str, query: Any, k: int) -> bytes:
        """Internal vtab bridge: run a scan, return a packed little-endian
        blob [int64 n][n x (int64 id, float64 distance)]."""
        if fname == "full":
            rows = self.vector_full_scan(table, column, query, int(k))
        elif fname == "quant":
            rows = self.vector_quantize_scan(table, column, query, int(k))
        elif fname == "full_stream":
            rows = list(self.vector_full_scan_stream(table, column, query))
        elif fname == "quant_stream":
            rows = list(self.vector_quantize_scan_stream(table, column, query))
        else:
            raise VectorConfigError(f"unknown scan module tag '{fname}'")
        arr = np.zeros(len(rows), dtype=[("id", "<i8"), ("d", "<f8")])
        if rows:
            ids, dist = zip(*rows)
            arr["id"] = ids
            arr["d"] = dist
        return struct.pack("<q", len(rows)) + arr.tobytes()

    def _lookup(self, table: str, column: str, caller: str) -> _TableContext:
        # case-insensitive lookup (vector_context_lookup :1051)
        ctx = self._contexts.get((table.lower(), column.lower()))
        if ctx is None:
            raise VectorStateError(
                f"{caller}: table '{table}' column '{column}' was not "
                "initialized — call vector_init first."
            )
        return ctx

    def _table_columns(self, table: str) -> dict[str, str]:
        rows = self._conn.execute(f"PRAGMA table_info({_quote(table)})").fetchall()
        return {r[1].lower(): (r[2] or "") for r in rows}

    def _resolve_pk(self, table: str) -> str:
        """rowid, or the single INTEGER pk of a WITHOUT ROWID table
        (src/sqlite-vector.c:1081-1088, 307-348), told by
        pragma_table_list's `wr` column (SQLite >= 3.37); older libraries
        fall back to the reference's substring search of the CREATE
        statement."""
        try:
            row = self._conn.execute(
                "SELECT wr FROM pragma_table_list WHERE schema='main' "
                "AND lower(name)=lower(?)",
                (table,),
            ).fetchone()
            without_rowid = bool(row and row[0])
        except sqlite3.OperationalError:
            row = self._conn.execute(
                "SELECT sql FROM sqlite_master WHERE type='table' "
                "AND lower(name)=lower(?)",
                (table,),
            ).fetchone()
            sql = (row[0] or "") if row else ""
            without_rowid = "without rowid" in sql.lower()
        if not without_rowid:
            return "rowid"
        pks = [
            r
            for r in self._conn.execute(f"PRAGMA table_info({_quote(table)})").fetchall()
            if r[5] > 0
        ]
        if len(pks) == 1 and (pks[0][2] or "").upper().startswith("INT"):
            return pks[0][1]
        raise VectorConfigError(
            f"Table '{table}' is WITHOUT ROWID and has no single INTEGER "
            "primary key usable as a row identifier."
        )

    # -- SQL surface ------------------------------------------------------------

    def vector_init(self, table: str, column: str, options: str) -> None:
        """vector_init(t, c, opts) (src/sqlite-vector.c:2491-2543)."""
        cols = self._table_columns(table)
        if not cols:
            raise VectorConfigError(f"Table '{table}' does not exist.")
        if column.lower() not in cols:
            raise VectorConfigError(
                f"Column '{column}' does not exist in table '{table}'."
            )
        decl = cols[column.lower()].upper()
        if decl and "BLOB" not in decl:
            raise VectorConfigError(
                f"Column '{column}' must have BLOB affinity (declared '{decl}')."
            )
        opts = parse_options(options)
        if opts.dimension <= 0:
            raise VectorConfigError(
                "Required 'dimension' option is missing from vector_init."
            )
        key = (table.lower(), column.lower())
        existing = self._contexts.get(key)
        if existing is not None:
            # idempotent re-init with consistency checks (:2521-2536)
            if existing.options.dimension != opts.dimension:
                raise VectorConfigError(
                    "A vector dimension mismatch was detected: column was "
                    f"initialized with dimension {existing.options.dimension}."
                )
            if existing.options.type is not opts.type:
                raise VectorConfigError(
                    "A vector type mismatch was detected: column was "
                    f"initialized with type {existing.options.type.value}."
                )
            # the reference keeps the EXISTING context untouched: another
            # distance in the new option string is discarded (:2539-2541)
            return None
        ctx = _TableContext(table=table, column=column, pk=self._resolve_pk(table), options=opts)
        self._unserialize_quant_params(ctx)
        self._contexts[key] = ctx
        return None

    def _unserialize_quant_params(self, ctx: _TableContext) -> None:
        """Restore qtype/qscale/qoffset (sqlite_unserialize :451-491)."""
        for key, value in self._conn.execute(
            "SELECT key, value FROM _sqliteai_vector WHERE tblname=? AND colname=?",
            (ctx.table, ctx.column),
        ):
            if key == "qtype":
                ctx.stored_qtype = _INT_TO_QTYPE.get(int(value))
            elif key == "qscale":
                ctx.stored_scale = float(value)
            elif key == "qoffset":
                ctx.stored_offset = float(value)

    # -- data refresh -------------------------------------------------------------

    def _change_stamp(self) -> tuple:
        # schema_version catches DDL (DROP/CREATE/ALTER), which bumps neither
        # data_version (own connection) nor total_changes
        dv = self._conn.execute("PRAGMA data_version").fetchone()[0]
        sv = self._conn.execute("PRAGMA schema_version").fetchone()[0]
        return (dv, self._conn.total_changes, sv)

    def _refresh(self, ctx: _TableContext) -> Dataset:
        """(Re)load the table's vectors into the device dataset if the
        database changed. The reference re-walks the B-tree every scan
        (src/sqlite-vector.c:2071-2117); this reloads only on change, and
        when the change is provably append-only or delete-only
        (_refresh_incremental) touches only the changed rows.

        Inside an open transaction the loaded state is not cached (stamp
        None): total_changes does not go down on ROLLBACK, so a cached
        stamp would keep serving rows of a rolled-back transaction."""
        stamp = self._change_stamp()
        if ctx.dataset is not None and ctx.stamp == stamp:
            return ctx.dataset
        if self._refresh_incremental(ctx, stamp):
            return ctx.dataset
        id_arr, arr = self._load_rows(ctx, min_pk=None)
        ds = Dataset(
            f"{ctx.table}.{ctx.column}", dataclasses.replace(ctx.options), device=self._device,
            mesh=self._mesh,
        )
        if len(id_arr):
            ds._add_host_rows(arr, id_arr)
        ctx.dataset = ds
        ctx.max_pk = self._table_max_pk(ctx)
        ctx.stamp = None if self._conn.in_transaction else stamp
        return ds

    def _table_max_pk(self, ctx: _TableContext) -> int | None:
        """Table-wide MAX(pk), rows with a NULL vector included: the
        append-only proof needs 'pk > max_pk' to mean 'the row did not
        exist at load time'."""
        row = self._conn.execute(
            f"SELECT MAX({_quote(ctx.pk)}) FROM {_quote(ctx.table)}"
        ).fetchone()
        return int(row[0]) if row and row[0] is not None else None

    def _refresh_incremental(self, ctx: _TableContext, stamp: tuple) -> bool:
        """Append and delete fast paths. Sound because: an unchanged
        data_version means no OTHER connection committed; total_changes
        counts every row this connection inserted, updated or deleted; and
        max_pk is the table-wide MAX(pk) at the last load, so a delta equal
        to the number of rows now above max_pk proves every change was an
        insert of a new row (a pk UPDATE moving an old row above max_pk is
        caught by the population count). Any mismatch reloads in full."""
        if ctx.dataset is None or ctx.stamp is None or ctx.max_pk is None:
            return False
        old_dv, old_tc, old_sv = ctx.stamp
        new_dv, new_tc, new_sv = stamp
        if new_sv != old_sv or new_dv != old_dv:
            return False  # DDL, or another connection wrote
        delta = new_tc - old_tc
        if delta <= 0:
            return False
        tq, pq, cq = _quote(ctx.table), _quote(ctx.pk), _quote(ctx.column)
        n_above = self._conn.execute(
            f"SELECT COUNT(*) FROM {tq} WHERE {pq} > ?", (ctx.max_pk,)
        ).fetchone()[0]
        n_old = self._conn.execute(
            f"SELECT COUNT({cq}) FROM {tq} WHERE {pq} <= ?", (ctx.max_pk,)
        ).fetchone()[0]
        if n_above == delta and n_old == len(ctx.dataset):
            # append-only: every change an insert above max_pk
            id_arr, arr = self._load_rows(ctx, min_pk=ctx.max_pk)
            if len(id_arr):
                ctx.dataset._add_host_rows(arr, id_arr)
            ctx.max_pk = self._table_max_pk(ctx)
            ctx.stamp = None if self._conn.in_transaction else stamp
            return True
        if n_above == 0 and n_old == len(ctx.dataset) - delta:
            # delete-only: exactly delta loaded rows vanished (DELETEd, or
            # their vector set to NULL, which the reference's scan skips
            # too, :2093); tombstone them (Dataset.remove, O(delta))
            live = np.fromiter(
                (
                    r[0]
                    for r in self._conn.execute(
                        f"SELECT {pq} FROM {tq} WHERE {cq} IS NOT NULL AND {pq} <= ?",
                        (ctx.max_pk,),
                    )
                ),
                np.int64,
            )
            gone = np.setdiff1d(ctx.dataset.ids, live)
            if len(gone) == delta:
                ctx.dataset.remove(gone)
                ctx.stamp = None if self._conn.in_transaction else stamp
                return True
        return False

    def _load_rows(self, ctx: _TableContext, *, min_pk: int | None) -> tuple[np.ndarray, np.ndarray]:
        """Bulk-load (pk, blob) rows in pk order; min_pk loads only pk >
        min_pk (the append fast path). Returns (ids [N], rows [N, dim] in
        the host form). NULL vectors are skipped (:2093, :1214); a short
        blob raises."""
        dim = ctx.options.dimension
        vtype = ctx.options.type
        expected = dim * vtype.itemsize
        where = f" WHERE {_quote(ctx.pk)} > {int(min_pk)}" if min_pk is not None else ""
        query = (
            f"SELECT {_quote(ctx.pk)}, {_quote(ctx.column)} FROM "
            f"{_quote(ctx.table)}{where} ORDER BY {_quote(ctx.pk)}"
        )
        # the native loader (csrc/svt_native.cpp) reads the committed file:
        # not for :memory: databases or inside an open transaction
        path = self._db_path()
        if path is not None and not self._conn.in_transaction:
            loaded = native_load_blobs(path, query, expected)
            if loaded is not None:
                id_arr, data, count = loaded
                self.last_loader = "native"
                return id_arr, _host_rows(data, vtype, count, dim)
        ids: list[int] = []
        blobs: list[bytes] = []
        for rowid, blob in self._conn.execute(query):
            if blob is None:
                continue
            if len(blob) < expected:
                raise VectorCodecError(
                    f"Invalid vector size for rowid {rowid}: expected at "
                    f"least {expected} bytes but found {len(blob)}."
                )
            ids.append(rowid)
            blobs.append(blob[:expected])
        self.last_loader = "python"
        return np.asarray(ids, np.int64), _host_rows(b"".join(blobs), vtype, len(ids), dim)

    def _db_path(self) -> str | None:
        for _, name, path in self._conn.execute("PRAGMA database_list"):
            if name == "main":
                return path or None
        return None

    # -- quantization -------------------------------------------------------------

    def vector_quantize(self, table: str, column: str, options: str | None = None) -> int:
        """vector_quantize(t, c[, opts]) (src/sqlite-vector.c:1406-1459).

        Quantizes on the device, then writes the reference-format shadow
        table and metadata inside a SAVEPOINT. Returns the row count."""
        ctx = self._lookup(table, column, "vector_quantize")
        opts = parse_options(options, ctx.options)
        ds = self._refresh(ctx)
        ds.quantize(qtype=opts.qtype)
        # ONE snapshot: quantize builds outside the mutation lock, so codes,
        # ids and count must all come from the same quantization
        qsnap = ds._quant
        count = qsnap.count if qsnap is not None else 0
        # the effective qtype decides both the shadow name and the stored
        # qtype code (a zero-row INT4 quantize must not store 3 beside a
        # legacy-named shadow)
        eff_qtype = qsnap.qtype if count else (
            QuantType.U8 if opts.qtype is QuantType.AUTO else opts.qtype
        )
        is_i4 = eff_qtype is QuantType.I4
        shadow = _shadow_name_i4(ctx.table, ctx.column) if is_i4 else _shadow_name(ctx.table, ctx.column)
        cur = self._conn.cursor()
        # SAVEPOINT (not BEGIN): works standalone AND inside a caller's open
        # transaction, like the reference's quantize under SQLite's
        # statement journal (src/sqlite-vector.c:1418-1437)
        was_in_txn = self._conn.in_transaction
        cur.execute("SAVEPOINT svt_quantize")
        try:
            # drop BOTH generations: a re-quantize that flips int4 <-> int8
            # must not leave the other format's records behind
            cur.execute(f"DROP TABLE IF EXISTS {_quote(_shadow_name(ctx.table, ctx.column))}")
            cur.execute(f"DROP TABLE IF EXISTS {_quote(_shadow_name_i4(ctx.table, ctx.column))}")
            cur.execute(
                f"CREATE TABLE IF NOT EXISTS {_quote(shadow)} "
                "(rowid1 INTEGER, rowid2 INTEGER, counter INTEGER, data BLOB)"
            )
            if count:
                qtype, scale, offset = qsnap.qtype, float(qsnap.scale), float(qsnap.offset)
                codes = _to_numpy(qsnap.codes, count)
                rowids = qsnap.ids
                if qtype is QuantType.I4:
                    # the packed int4 record (this engine's extension):
                    # [int64-LE rowid][f32-LE alpha][i32-LE csq][P packed]
                    q_size = 16 + codes.shape[1]
                    alpha = _to_numpy(qsnap.row_scale, count)
                    csq = _to_numpy(qsnap.sq_norms, count)
                else:
                    q_size = 8 + ctx.options.dimension
                max_vectors = max(int(opts.max_memory) // q_size, 1)
                for start in range(0, count, max_vectors):
                    end = min(start + max_vectors, count)
                    chunk_ids = rowids[start:end]
                    recs = np.empty((end - start, q_size), np.uint8)
                    recs[:, :8] = np.ascontiguousarray(chunk_ids.astype("<i8")).view(np.uint8).reshape(-1, 8)
                    if qtype is QuantType.I4:
                        recs[:, 8:12] = np.ascontiguousarray(alpha[start:end], "<f4").view(np.uint8).reshape(-1, 4)
                        recs[:, 12:16] = np.ascontiguousarray(csq[start:end], "<i4").view(np.uint8).reshape(-1, 4)
                        recs[:, 16:] = codes[start:end]
                    else:
                        recs[:, 8:] = codes[start:end].view(np.uint8)
                    cur.execute(
                        f"INSERT INTO {_quote(shadow)} "
                        "(rowid1, rowid2, counter, data) VALUES (?, ?, ?, ?)",
                        (int(chunk_ids[0]), int(chunk_ids[-1]), end - start, recs.tobytes()),
                    )
            else:
                qtype = eff_qtype
                scale, offset = 1.0, 0.0
            for key, val in (
                ("qtype", _QTYPE_TO_INT[qtype]),
                ("qscale", float(scale)),
                ("qoffset", float(offset)),
            ):
                cur.execute(
                    "REPLACE INTO _sqliteai_vector (tblname, colname, key, value) "
                    "VALUES (?, ?, ?, ?)",
                    (ctx.table, ctx.column, key, val),
                )
            cur.execute("RELEASE svt_quantize")
            # commit ONLY the implicit transaction the SAVEPOINT started; a
            # caller's open transaction stays open
            if self._conn.in_transaction and not was_in_txn:
                self._conn.commit()
        except Exception:
            cur.execute("ROLLBACK TO svt_quantize")
            cur.execute("RELEASE svt_quantize")
            raise
        ctx.stored_qtype, ctx.stored_scale, ctx.stored_offset = qtype, float(scale), float(offset)
        # the fresh codes are cached directly (device residency is the
        # natural state here, as after vector_quantize_preload)
        if count:
            ctx.quant = _QuantCache(
                qtype=qtype, scale=float(scale), offset=float(offset), codes=qsnap.codes,
                ids=np.array(rowids, np.int64), count=count,
                sq_norms=qsnap.sq_norms if qtype is QuantType.I4 else None,
                row_scale=qsnap.row_scale if qtype is QuantType.I4 else None,
            )
        else:
            ctx.quant = _QuantCache(qtype, float(scale), float(offset), None, None, 0)
        # inside a caller's open transaction the cache is provisional: a
        # later ROLLBACK drops the shadow table unseen by the stamp
        ctx.quant_provisional = self._conn.in_transaction
        ctx.quant_schema_ver = self._schema_ver()
        ctx.stamp = None if self._conn.in_transaction else self._change_stamp()
        return count

    def _schema_ver(self) -> int:
        """The connection's schema cookie (its pending value inside an open
        transaction; reverted by ROLLBACK; bumped by every shadow
        DROP+CREATE of either engine)."""
        return int(self._conn.execute("PRAGMA schema_version").fetchone()[0])

    def _find_shadow(self, ctx: _TableContext) -> str | None:
        """Name of whichever shadow generation exists (the reference's or
        the packed int4 one), or None."""
        for name in (_shadow_name(ctx.table, ctx.column), _shadow_name_i4(ctx.table, ctx.column)):
            row = self._conn.execute(
                "SELECT 1 FROM sqlite_master WHERE type='table' AND name=?", (name,)
            ).fetchone()
            if row is not None:
                return name
        return None

    def _load_quant_from_shadow(self, ctx: _TableContext) -> _QuantCache:
        """Read the shadow table's records into device codes, the interop
        analogue of vector_quantize_preload (src/sqlite-vector.c:
        1338-1404). The codes stay at their row count on the device (the
        JAX package pads them to a power of two, for its compiled shapes)."""
        # the cookie BEFORE reading: a re-quantize by another connection
        # mid-load moves it, and the next _require_quant reloads
        schema_ver = self._schema_ver()
        if self._find_shadow(ctx) is None:
            raise VectorStateError(
                "vector_quantize_scan: quantization table not found — run "
                "vector_quantize first."
            )
        # ALWAYS re-read the params: codes and params must be one generation
        self._unserialize_quant_params(ctx)
        if ctx.stored_qtype is None or ctx.stored_scale is None:
            raise VectorStateError(
                "vector_quantize_scan: quantization parameters not found in "
                "_sqliteai_vector — run vector_quantize first."
            )
        dim = ctx.options.dimension
        is_i4 = ctx.stored_qtype is QuantType.I4
        width = packed_width(dim) if is_i4 else dim
        q_size = (16 if is_i4 else 8) + width
        shadow = _shadow_name_i4(ctx.table, ctx.column) if is_i4 else _shadow_name(ctx.table, ctx.column)
        row = self._conn.execute(
            "SELECT 1 FROM sqlite_master WHERE type='table' AND name=?", (shadow,)
        ).fetchone()
        if row is None:
            # params and records disagree on the format generation: never
            # parse records with the other format's stride
            raise VectorStateError(
                "vector_quantize_scan: quantization table does not match "
                "the stored qtype — run vector_quantize again."
            )
        recs = [
            np.frombuffer(data, np.uint8).reshape(counter, q_size)
            for counter, data in self._conn.execute(f"SELECT counter, data FROM {_quote(shadow)}")
        ]
        rec = np.concatenate(recs) if recs else np.zeros((0, q_size), np.uint8)
        ids = np.ascontiguousarray(rec[:, :8]).view("<i8").reshape(-1).astype(np.int64)
        count = len(ids)
        ctx.quant_schema_ver = schema_ver
        if is_i4:
            return _QuantCache(
                qtype=QuantType.I4, scale=1.0, offset=0.0,
                codes=self._place(np.ascontiguousarray(rec[:, 16:])), ids=ids, count=count,
                sq_norms=self._place(np.ascontiguousarray(rec[:, 12:16]).view("<i4").reshape(-1).astype(np.int32)),
                row_scale=self._place(np.ascontiguousarray(rec[:, 8:12]).view("<f4").reshape(-1).astype(np.float32)),
            )
        codes = np.ascontiguousarray(rec[:, 8:])
        if ctx.stored_qtype is QuantType.I8:
            codes = codes.view(np.int8)
        return _QuantCache(
            qtype=ctx.stored_qtype, scale=float(ctx.stored_scale),
            offset=float(ctx.stored_offset or 0.0), codes=self._place(codes),
            ids=ids, count=count,
        )

    def _place(self, arr: np.ndarray):
        """Shadow-table codes (or their per-row alpha/csq) on the device,
        or row-sharded over a 1-D mesh, at the JAX package's upload
        capacity."""
        one_d = self._mesh is not None and len(self._mesh.axis_names) == 1
        return place_rows(arr, len(arr), self._device, self._mesh.grid() if one_d else None)

    def _require_quant(self, ctx: _TableContext) -> _QuantCache:
        if ctx.quant is not None and ctx.quant_provisional and not self._conn.in_transaction:
            # the transaction that built this quant has ended: promote it
            # only if the schema cookie is still the one its shadow writes
            # produced (a ROLLBACK reverts the cookie with the shadow)
            if self._find_shadow(ctx) is not None and ctx.quant_schema_ver == self._schema_ver():
                ctx.quant_provisional = False
            else:
                # rolled back: drop the cache AND the params, so the next
                # scan reloads whatever generation survived on disk, or
                # errors as the reference does (:1780-1787)
                ctx.quant = None
                ctx.stored_qtype = ctx.stored_scale = ctx.stored_offset = None
        if ctx.quant is not None and (ctx.quant.codes is not None or ctx.quant.count == 0):
            # freshness: every re-quantize (either engine's, any connection's)
            # DROP+CREATEs the shadow and bumps the cookie
            if ctx.quant_schema_ver == self._schema_ver():
                return ctx.quant
            ctx.quant = None
        ctx.quant = self._load_quant_from_shadow(ctx)
        return ctx.quant

    def vector_quantize_memory(self, table: str, column: str) -> int:
        """SUM(LENGTH(data)) over the shadow table (:1486-1499)."""
        ctx = self._lookup(table, column, "vector_quantize_memory")
        shadow = self._find_shadow(ctx)
        if shadow is None:
            raise VectorStateError(
                "vector_quantize_memory: quantization table not found — run "
                "vector_quantize first."
            )
        row = self._conn.execute(f"SELECT SUM(LENGTH(data)) FROM {_quote(shadow)}").fetchone()
        return int(row[0] or 0)

    def vector_quantize_preload(self, table: str, column: str) -> None:
        """Pin the quantized codes on the device (:1338-1404)."""
        ctx = self._lookup(table, column, "vector_quantize_preload")
        self._require_quant(ctx)
        return None

    def vector_quantize_cleanup(self, table: str, column: str) -> None:
        """Free the cache and DROP the shadow table (:1501-1524)."""
        ctx = self._contexts.get((table.lower(), column.lower()))
        if ctx is not None:
            ctx.quant = None
            # the INIT casing: vector_quantize named the shadow from it
            table, column = ctx.table, ctx.column
        was_in_txn = self._conn.in_transaction
        self._conn.execute(f"DROP TABLE IF EXISTS {_quote(_shadow_name(table, column))}")
        self._conn.execute(f"DROP TABLE IF EXISTS {_quote(_shadow_name_i4(table, column))}")
        # commit only the transaction this DROP started
        if self._conn.in_transaction and not was_in_txn:
            self._conn.commit()
        return None

    # -- scans ---------------------------------------------------------------------

    def _coerce_query(self, ctx: _TableContext, value: Any) -> np.ndarray:
        """A query vector as Dataset.search takes it: the column's dtype,
        bfloat16 as its float32 values (which the Dataset rounds back to
        the same bfloat16), so no numpy bfloat16 is needed."""
        vtype, dim = ctx.options.type, ctx.options.dimension
        bf16 = vtype is VectorType.BF16
        if isinstance(value, str):
            # bfloat16: parsed to float32 first, as the codec does
            return vector_from_json(value, VectorType.F32 if bf16 else vtype, dim)
        if isinstance(value, (bytes, bytearray, memoryview)):
            blob = bytes(value)
            if not bf16:
                return blob_to_array(blob, vtype, dim)
            if len(blob) % 2:
                raise VectorCodecError(
                    f"Invalid BLOB size for format '{vtype.value}': size must be a "
                    "multiple of 2 bytes."
                )
            bits = np.frombuffer(blob, "<u2")
            if bits.size < dim:
                raise VectorCodecError("Invalid vector blob: too small for dimension.")
            return bits_to_f32(bits[:dim])
        arr = np.asarray(value)
        if arr.shape != (dim,):
            raise VectorCodecError(
                f"Invalid vector dimension: expected {dim} but found {arr.shape}."
            )
        return arr.astype(np.float32 if bf16 else vtype.np_dtype)

    def vector_full_scan(self, table: str, column: str, query: Any, k: int) -> list[tuple[int, float]]:
        """Exact top-k, the vector_full_scan virtual table
        (src/sqlite-vector.c:2071-2117). Returns [(rowid, distance)] asc."""
        ctx = self._lookup(table, column, "vector_full_scan")
        if k <= 0:
            return []  # k=0 -> empty (:1796)
        ds = self._refresh(ctx)
        q = self._coerce_query(ctx, query)
        ids, dist = ds.search(q, k)
        return list(zip(ids.tolist(), dist.astype(np.float64).tolist()))

    def _own_codes(self, ctx: _TableContext, quant: _QuantCache) -> bool:
        """True when `quant` holds the codes this connection's dataset built
        (the Dataset path serves them)."""
        ds = ctx.dataset
        return ds is not None and ds._quant is not None and quant.codes is ds._quant.codes

    def vector_quantize_scan(self, table: str, column: str, query: Any, k: int) -> list[tuple[int, float]]:
        """Approximate top-k over the quantized codes
        (src/sqlite-vector.c:2159-2236); distances in the quantized domain,
        as in the reference."""
        ctx = self._lookup(table, column, "vector_quantize_scan")
        if k <= 0:
            return []
        quant = self._require_quant(ctx)
        if quant.count == 0:
            return []
        q = self._coerce_query(ctx, query)
        if self._own_codes(ctx, quant):
            ids, vals = ctx.dataset.search(q, k, mode="quantized")
            return list(zip(ids.tolist(), vals.astype(np.float64).tolist()))
        # codes from the shadow table: the Dataset's own calls
        # (Dataset._search_quantized), on the same float32 query
        qf = from_numpy(q[None, :].astype(np.float32), self._device)
        metric = ctx.options.distance
        sharded = isinstance(quant.codes, RowShards)
        if quant.qtype is QuantType.I4:
            args = (qf, quant.codes, quant.row_scale, quant.sq_norms, metric, k)
            dim = ctx.options.dimension
            if sharded:
                vals, idx = sharded_int4_scan_topk(*args, self._mesh, dim=dim, valid_count=quant.count)
            else:
                vals, idx = int4_scan_topk(*args, dim=dim, valid_count=quant.count)
        else:
            qq = quantize_device(qf, quant.scale, quant.offset, quant.qtype)
            if sharded:
                vals, idx = sharded_scan_topk(qq, quant.codes, metric, k, self._mesh, valid_count=quant.count)
            else:
                vals, idx = fused_scan_topk(qq, quant.codes, metric, k)
        vals, idx = vals[0].cpu().numpy(), idx[0].cpu().numpy()
        keep = idx >= 0
        return list(zip(quant.ids[idx[keep]].tolist(), vals[keep].astype(np.float64).tolist()))

    def vector_full_scan_stream(self, table: str, column: str, query: Any) -> Iterator[tuple[int, float]]:
        """Every (rowid, distance), unordered: the *_stream virtual table
        (src/sqlite-vector.c:2243-2313)."""
        ctx = self._lookup(table, column, "vector_full_scan_stream")
        ds = self._refresh(ctx)
        q = self._coerce_query(ctx, query)
        dist = ds.distances(q)
        yield from zip(ds.ids.tolist(), dist.astype(np.float64).tolist())

    def vector_quantize_scan_stream(self, table: str, column: str, query: Any) -> Iterator[tuple[int, float]]:
        """Quantized-domain streaming distances (src/sqlite-vector.c:2315-2365)."""
        ctx = self._lookup(table, column, "vector_quantize_scan_stream")
        quant = self._require_quant(ctx)
        if quant.count == 0:
            return
        q = self._coerce_query(ctx, query)
        if self._own_codes(ctx, quant):
            dist = ctx.dataset.distances(q, exact=False)
        else:
            qf = from_numpy(q[None, :].astype(np.float32), self._device)
            metric = ctx.options.distance
            dim = ctx.options.dimension
            if quant.qtype is QuantType.I4:
                args = (qf, quant.codes, quant.row_scale, quant.sq_norms, metric)
                if isinstance(quant.codes, RowShards):
                    d = join_columns(sharded_int4_scan_distances(*args, dim=dim))
                else:
                    d = int4_scan_distances(*args, dim=dim)
            else:
                qq = quantize_device(qf, quant.scale, quant.offset, quant.qtype)
                if isinstance(quant.codes, RowShards):
                    d = join_columns(sharded_scan_distances(qq, quant.codes, metric, self._mesh))
                else:
                    d = scan_distances(qq, quant.codes, metric)
            dist = d[0, : quant.count].cpu().numpy()
        yield from zip(quant.ids.tolist(), np.asarray(dist, np.float64).tolist())

    # -- JSON TVF shims ---------------------------------------------------------

    def _full_scan_json(self, table: str, column: str, query: Any, k: int) -> str:
        return json.dumps(
            [{"id": i, "distance": d} for i, d in self.vector_full_scan(table, column, query, k)]
        )

    def _quantize_scan_json(self, table: str, column: str, query: Any, k: int) -> str:
        return json.dumps(
            [{"id": i, "distance": d} for i, d in self.vector_quantize_scan(table, column, query, k)]
        )


def _make_vector_as(vtype: VectorType):
    def fn(*args):
        if not 1 <= len(args) <= 2:
            raise VectorConfigError(
                f"vector_as_{vtype.value.lower()} expects 1 or 2 arguments."
            )
        dim = int(args[1]) if len(args) == 2 else 0
        return vector_as_blob(args[0], vtype, dim)

    return fn


def connect(database: str, *, device: Any = None, mesh: Any = None, **kwargs: Any) -> VectorConnection:
    """Open a SQLite database with the vector SQL surface registered, the
    analogue of `.load ./vector` + sqlite3_vector_init
    (src/sqlite-vector.c:2555-2638). device=None means the first CUDA
    device (it raises without one); device="cpu" runs on the CPU."""
    conn = sqlite3.connect(database, **kwargs)
    try:
        return VectorConnection(conn, device=device, mesh=mesh)
    except Exception:
        conn.close()
        raise


def wrap(conn: sqlite3.Connection, *, device: Any = None, mesh: Any = None) -> VectorConnection:
    """Register the vector SQL surface on an existing connection."""
    return VectorConnection(conn, device=device, mesh=mesh)
