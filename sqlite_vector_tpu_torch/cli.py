"""Command-line interface of the port: the sqlite3-shell workflow on the card.

Port of sqlite_vector_tpu/cli.py, with its subcommands and flags. It runs
on the first CUDA device and refuses to start without one; --cpu runs it
on the CPU (the JAX CLI's --cpu picks the JAX CPU backend).

- SQLite databases (the reference's storage): init, import, quantize and
  search on BLOB columns, the metadata in `_sqliteai_vector` as the C
  extension writes it (files interoperate both ways).
- Dataset directories (the package's own storage): sharded .npy and a JSON
  manifest, built, searched and served without SQLite.

    python -m sqlite_vector_tpu_torch version
    python -m sqlite_vector_tpu_torch init db.sqlite docs embedding \\
        "dimension=384,type=FLOAT32,distance=L2"
    python -m sqlite_vector_tpu_torch import db.sqlite docs embedding vecs.npy
    python -m sqlite_vector_tpu_torch quantize db.sqlite docs embedding
    python -m sqlite_vector_tpu_torch search db.sqlite docs embedding \\
        "[0.1, 0.2, ...]" -k 10 --mode quantized
    python -m sqlite_vector_tpu_torch ds-create /data/ds \\
        "dimension=384,type=FLOAT32" --npy vecs.npy
    python -m sqlite_vector_tpu_torch ds-search /data/ds query.npy -k 10
    python -m sqlite_vector_tpu_torch serve --dir /data/ds --port 8377
    python -m sqlite_vector_tpu_torch warm --n 1000000 --dim 384
    python -m sqlite_vector_tpu_torch recall --n 100000 --dim 384 -k 20
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load_query(spec: str) -> "np.ndarray | str":
    """A query argument is inline JSON (`[...]`) or a path to .npy/.json."""
    s = spec.strip()
    if s.startswith("["):
        return s  # JSON text: the engine's codec parses it
    if s.endswith(".npy"):
        return np.load(s)
    with open(s) as f:
        return f.read().strip()


def _print_results(ids, dist, as_json: bool) -> None:
    """One query: ids/dist are [k]. Batched .npy queries: [B, k]; JSON
    keeps the nesting, text output heads each query."""
    ids = np.asarray(ids)
    dist = np.asarray(dist)
    if as_json:
        print(json.dumps({"ids": ids.tolist(), "distances": dist.tolist()}))
    elif ids.ndim == 2:
        for qi in range(ids.shape[0]):
            print(f"# query {qi}")
            for i, d in zip(ids[qi], dist[qi]):
                print(f"{int(i)}\t{float(d):.6f}")
    else:
        for i, d in zip(ids.ravel(), dist.ravel()):
            print(f"{int(i)}\t{float(d):.6f}")


def _cmd_version(args) -> int:
    import sqlite_vector_tpu_torch as svt

    print(f"sqlite_vector_tpu_torch {svt.version()} ({svt.backend()})")
    return 0


def _cmd_init(args) -> int:
    from sqlite_vector_tpu_torch import sqlite as svs

    with svs.connect(args.db, device=args.device) as conn:
        conn.vector_init(args.table, args.column, args.options)
        conn.commit()
    print(f"initialized {args.table}.{args.column} ({args.options})")
    return 0


def _cmd_import(args) -> int:
    """Bulk-load an .npy matrix into a SQLite BLOB column."""
    from sqlite_vector_tpu_torch import sqlite as svs
    from sqlite_vector_tpu_torch.codec import array_to_blob
    from sqlite_vector_tpu_torch.device import bf16_bits
    from sqlite_vector_tpu_torch.types import VectorType, parse_options

    mat = np.load(args.npy)
    if mat.ndim != 2:
        print(f"error: {args.npy} must be 2-D, got {mat.shape}", file=sys.stderr)
        return 2
    with svs.connect(args.db, device=args.device) as conn:
        cur = conn.connection.cursor()
        if args.create:
            cur.execute(
                f'CREATE TABLE IF NOT EXISTS "{args.table}" '
                f'(id INTEGER PRIMARY KEY, "{args.column}" BLOB)'
            )
        if args.options:
            # after CREATE: vector_init checks that the table and column exist
            conn.vector_init(args.table, args.column, args.options)
        vtype = parse_options(args.options).type if args.options else VectorType.F32
        # the host form: bfloat16 as its bits (little-endian, as the codec writes)
        rows = bf16_bits(mat) if vtype is VectorType.BF16 else mat.astype(vtype.np_dtype)
        cur.executemany(
            f'INSERT INTO "{args.table}" ("{args.column}") VALUES (?)',
            [(array_to_blob(r),) for r in rows],
        )
        conn.commit()
    print(f"imported {mat.shape[0]} vectors into {args.table}.{args.column}")
    return 0


def _cmd_quantize(args) -> int:
    from sqlite_vector_tpu_torch import sqlite as svs

    with svs.connect(args.db, device=args.device) as conn:
        if args.options:
            conn.vector_init(args.table, args.column, args.options)
        n = conn.vector_quantize(args.table, args.column, args.qopts)
        conn.commit()
    print(f"quantized {n} rows")
    return 0


def _cmd_search(args) -> int:
    from sqlite_vector_tpu_torch import sqlite as svs

    q = _load_query(args.query)
    with svs.connect(args.db, device=args.device) as conn:
        if args.options:
            conn.vector_init(args.table, args.column, args.options)
        if args.mode == "quantized":
            rows = conn.vector_quantize_scan(args.table, args.column, q, args.k)
        else:
            rows = conn.vector_full_scan(args.table, args.column, q, args.k)
    _print_results([r[0] for r in rows], [r[1] for r in rows], args.json)
    return 0


def _cmd_ds_create(args) -> int:
    import sqlite_vector_tpu_torch as svt

    ds = svt.VectorStore(device=args.device).create(args.name, args.options)
    if args.npy:
        mat = np.load(args.npy)
        ids = np.load(args.ids) if args.ids else None
        ds.add(mat, ids=ids)
    ds.save(args.dir)
    print(f"saved {len(ds)} rows -> {args.dir}")
    return 0


def _cmd_ds_search(args) -> int:
    import sqlite_vector_tpu_torch as svt

    storage = "host" if args.host else "hbm"
    ds = svt.Dataset.load(args.dir, device=args.device, storage=storage, mmap=args.host)
    ids, dist = ds.search(_load_query(args.query), args.k, mode=args.mode)
    _print_results(ids, dist, args.json)
    return 0


def _cmd_ds_info(args) -> int:
    import sqlite_vector_tpu_torch as svt
    from sqlite_vector_tpu_torch.serving import _dataset_stats

    # host storage, memory-mapped: the manifest and the shards' shapes only
    ds = svt.Dataset.load(args.dir, device=args.device, storage="host", mmap=True)
    info = {"name": ds.name, **_dataset_stats(ds), "backend": svt.backend()}
    print(json.dumps(info, indent=2))
    return 0


def _cmd_serve(args) -> int:
    import sqlite_vector_tpu_torch as svt

    if args.dir:
        storage = "host" if args.mmap else "hbm"
        ds = svt.Dataset.load(args.dir, device=args.device, storage=storage, mmap=args.mmap)
    else:
        db, table, column = args.db
        from sqlite_vector_tpu_torch import sqlite as svs

        conn = svs.connect(db, device=args.device)
        if args.options:
            conn.vector_init(table, column, args.options)
        ds = conn._refresh(conn._lookup(table, column, "serve"))
    if args.quantize:
        ds.quantize()
    server = svt.serve(ds, args.host, args.port, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)
    # the SIGTERM handler goes in BEFORE the readiness line: a supervisor
    # may send it the moment that line appears
    import signal

    try:
        signal.signal(signal.SIGTERM, _raise_interrupt)
    except ValueError:  # not the main thread (embedded use): ctrl-C only
        pass
    try:
        host, port = server.server_address[:2]
        print(f"serving {len(ds)} x {ds.dimension} on http://{host}:{port}", flush=True)
        print("POST /search {'vector': [...], 'k': 10, 'mode': 'exact'}; ctrl-C to stop", flush=True)
        _serve_block(server)
    except KeyboardInterrupt:
        server.searcher.close()
        server.shutdown()
    return 0


def _raise_interrupt(signum, frame):
    """SIGTERM takes ctrl-C's clean shutdown: drain the coalescer, stop
    the server."""
    raise KeyboardInterrupt


def _serve_block(server) -> None:
    """Block until ctrl-C/SIGTERM (apart, so tests can drive the server)."""
    import threading

    threading.Event().wait()


def _cmd_warm(args) -> int:
    """Pay the card's first-use costs of a deployment shape before serving:
    build (or load) the kernel library and the native host modules, then
    search once per mode and batch size, unmasked and with a removed row's
    mask. The JAX CLI's warm compiles XLA executables instead; the kernels
    here take any shape, so what is left to pay is the build, the library
    load and the first launches (cuBLAS handles, allocator pools)."""
    import time

    import sqlite_vector_tpu_torch as svt
    from sqlite_vector_tpu_torch import native
    from sqlite_vector_tpu_torch.serving import _BUCKETS

    ds = svt.VectorStore(device=args.device).create(
        "warm", f"dimension={args.dim},type={args.dtype},distance={args.metric}"
    )
    t0 = time.perf_counter()
    if ds.device.type == "cuda":
        from sqlite_vector_tpu_torch.ops._build import library_path, load_library

        load_library()
        print(f"kernel library {library_path().name} ready in {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    vtab = native.vtab_extension_path()
    print(
        f"native module {'built' if native.available() else 'unavailable (Python fallback)'}, "
        f"vtab {'built' if vtab else 'unavailable'} in {time.perf_counter() - t0:.2f}s"
    )
    rng = np.random.default_rng(0)
    ids = ds.add(rng.standard_normal((args.n, args.dim)).astype(np.float32))
    modes = args.modes.split(",")
    if any(m in ("quantized", "rerank") for m in modes):
        ds.quantize()
    buckets = [b for b in _BUCKETS if b <= args.max_batch]
    q = rng.standard_normal((max(buckets), args.dim)).astype(np.float32)
    searched = 0
    for masked in (False, True):
        if masked:
            ds.remove(ids[:1])  # every later search carries the tombstone mask
        for mode in modes:
            for b in buckets:
                t0 = time.perf_counter()
                ds.search(q[:b], args.k, mode=mode)
                searched += 1
                tag = "masked " if masked else ""
                print(f"warm {tag}{mode:10s} B={b:<4d} {time.perf_counter() - t0:6.2f}s")
    print(f"warmed {searched} searches (n={args.n}, dim={args.dim}, k={args.k}) on {ds.device}")
    return 0


def _cmd_recall(args) -> int:
    from sqlite_vector_tpu_torch.tools import recall as rtool

    rtool.main(args.rest, device=args.device)
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sqlite_vector_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("version", help="print version and backend")

    p = sub.add_parser("init", help="vector_init on a SQLite table column")
    p.add_argument("db"); p.add_argument("table"); p.add_argument("column")
    p.add_argument("options", help='e.g. "dimension=384,type=FLOAT32,distance=L2"')

    p = sub.add_parser("import", help="bulk-load an .npy matrix into a BLOB column")
    p.add_argument("db"); p.add_argument("table"); p.add_argument("column")
    p.add_argument("npy")
    p.add_argument("--options", default=None, help="also run vector_init with these options")
    p.add_argument("--create", action="store_true", help="CREATE TABLE IF NOT EXISTS first")

    p = sub.add_parser("quantize", help="build int8 quantization for a column")
    p.add_argument("db"); p.add_argument("table"); p.add_argument("column")
    p.add_argument("--options", default=None, help="vector_init options if not yet initialized")
    p.add_argument("--qopts", default=None, help='quantize options, e.g. "qtype=INT8"')

    p = sub.add_parser("search", help="top-k scan of a SQLite column")
    p.add_argument("db"); p.add_argument("table"); p.add_argument("column")
    p.add_argument("query", help='JSON "[...]", .npy path, or text file')
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--mode", choices=("exact", "quantized"), default="exact")
    p.add_argument("--options", default=None)
    p.add_argument("--json", action="store_true", help="JSON output")

    p = sub.add_parser("ds-create", help="build + save a dataset directory")
    p.add_argument("dir")
    p.add_argument("options", help='e.g. "dimension=384,type=FLOAT32,distance=L2"')
    p.add_argument("--name", default="default")
    p.add_argument("--npy", default=None, help="initial vectors [N, dim] .npy")
    p.add_argument("--ids", default=None, help="optional row ids [N] .npy")

    p = sub.add_parser("ds-search", help="top-k search of a dataset directory")
    p.add_argument("dir")
    p.add_argument("query", help='JSON "[...]", .npy path, or text file')
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--mode", choices=("exact", "quantized", "rerank", "approx"), default="exact")
    p.add_argument("--host", action="store_true",
                   help="host-streaming storage (datasets larger than device memory)")
    p.add_argument("--json", action="store_true")

    p = sub.add_parser("ds-info", help="print a dataset directory's manifest")
    p.add_argument("dir")

    p = sub.add_parser("serve", help="HTTP serving with query coalescing")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--dir", default=None, help="dataset directory")
    src.add_argument("--db", nargs=3, metavar=("DB", "TABLE", "COLUMN"), default=None, help="SQLite source")
    p.add_argument("--options", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8377)
    p.add_argument("--quantize", action="store_true", help="quantize before serving")
    p.add_argument("--mmap", action="store_true")
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--max-wait-ms", type=float, default=2.0)

    p = sub.add_parser("warm", help="pay the card's first-use costs for a deployment shape")
    p.add_argument("--n", type=int, default=1_000_000, help="production row count")
    p.add_argument("--dim", type=int, default=384)
    p.add_argument("-k", type=int, default=20)
    p.add_argument("--dtype", default="FLOAT32")
    p.add_argument("--metric", default="L2")
    p.add_argument("--modes", default="exact,quantized,rerank")
    p.add_argument("--max-batch", type=int, default=64)

    sub.add_parser("recall", help="recall measurement (QUANTIZATION.md workflow); "
                   "remaining args go to tools.recall")

    # `recall` forwards every remaining argument to tools.recall's parser (a
    # REMAINDER positional never captures leading optionals like `--n`), so
    # parse leniently and re-tighten for every other command
    args, extra = ap.parse_known_args(argv)
    if args.cmd == "recall":
        args.rest = extra
    elif extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    args.device = "cpu" if args.cpu else None

    handlers = {
        "version": _cmd_version,
        "init": _cmd_init,
        "import": _cmd_import,
        "quantize": _cmd_quantize,
        "search": _cmd_search,
        "ds-create": _cmd_ds_create,
        "ds-search": _cmd_ds_search,
        "ds-info": _cmd_ds_info,
        "serve": _cmd_serve,
        "warm": _cmd_warm,
        "recall": _cmd_recall,
    }
    from sqlite_vector_tpu_torch.errors import VectorError

    try:
        return handlers[args.cmd](args)
    except VectorError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
