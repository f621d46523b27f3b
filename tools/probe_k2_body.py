#!/usr/bin/env python3
"""Where K2's tensor-core body spends a row tile, on one CUDA GPU.

Builds csrc/int4_minima_mma.cu as it stands and three copies of it, each
patched as text: `phases` reads clock64() around the ring wait, the MMA
loop, the epilogue and the group combine of every row tile, and the
prologue before the first one; `no_mma` replaces each mma.sync by two
integer operations and `no_epilogue` the surrogates and their minima by a
sum (both give wrong minima and are timed only). Then, over N x d packed
int4 codes of N(0, 1) rows from --seed, for each batch it checks the body
and `phases` bit for bit against the CUDA-core body (csrc/int4_minima.cu)
and times all of them and the CUDA-core body in turns (CUDA events), and
prints the phases in cycles per row tile (thread 0 of each block, summed
over blocks, over the tiles) and per block. Each batch takes the query tile
ops/int4_scan.py routes it to (resident in shared memory, or streamed
beside the codes: k2_streams_queries); --streamed takes the streamed tile
at every batch, so the split reads those instances at any d.

    python3 tools/probe_k2_body.py [--n 1000000] [--d 384] [--iters 30] [--streamed]

Run from the repository root, on a machine with a CUDA device and nvcc.
The patches match the source's text; the script stops if one no longer
does.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sqlite_vector_tpu_torch.ops import _build  # noqa: E402
from sqlite_vector_tpu_torch.ops.int4_scan import (  # noqa: E402
    _launch_k2,
    k2_query_planes,
    k2_query_tile,
    k2_streams_queries,
)
from sqlite_vector_tpu_torch.ops.quantize4 import quantize4_device, quantize_query_int8  # noqa: E402
from sqlite_vector_tpu_torch.types import DistanceMetric  # noqa: E402
from sqlite_vector_tpu_torch.utils.compile_cache import build_root  # noqa: E402

NCOUNTERS = 6  # ring wait, MMA loop, epilogue, combine (cycles), prologue (cycles), blocks

PHASES = [
    ("namespace {\n\nconstexpr int kGroup = 128;",
     "__device__ unsigned long long g_phase[6];\n"
     'extern "C" int svt_probe_read(unsigned long long* h) {\n'
     "  return (int)cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase));\n}\n"
     'extern "C" int svt_probe_reset() {\n'
     "  unsigned long long z[6] = {0, 0, 0, 0, 0, 0};\n"
     "  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(g_phase));\n}\n"
     "namespace {\n\nconstexpr int kGroup = 128;"),
    ("  extern __shared__ __align__(16) unsigned char smem[];\n",
     "  extern __shared__ __align__(16) unsigned char smem[];\n  const long long t_start = clock64();\n"),
    ("  int acc[2][NT][4];\n  for (int s = 0; s < steps; ++s) {\n    cp_async_wait<kStages - 2>();\n"
     "    __syncthreads();",
     "  int acc[2][NT][4];\n"
     "  unsigned long long p0 = 0, p1 = 0, p2 = 0, p3 = 0, p4 = clock64() - t_start;\n"
     "  for (int s = 0; s < steps; ++s) {\n    const long long c0 = clock64();\n"
     "    cp_async_wait<kStages - 2>();\n    __syncthreads();\n"
     "    const long long c1 = clock64();\n    p0 += c1 - c0;"),
    ("    if (ch != nchunks - 1) continue;",
     "    const long long c2 = clock64();\n    p1 += c2 - c1;\n    if (ch != nchunks - 1) continue;"),
    ("    if (tile + nslots < ntiles) load_aux(tile + nslots);",
     "    const long long c3 = clock64();\n    p2 += c3 - c2;\n"
     "    if (tile + nslots < ntiles) load_aux(tile + nslots);"),
    ("        out[static_cast<long long>(q0 + j) * groups + group] = mn;\n      }\n    }\n  }\n}",
     "        out[static_cast<long long>(q0 + j) * groups + group] = mn;\n      }\n    }\n"
     "    p3 += clock64() - c3;\n  }\n"
     "  if (tid == 0) {\n    atomicAdd(&g_phase[0], p0);\n    atomicAdd(&g_phase[1], p1);\n"
     "    atomicAdd(&g_phase[2], p2);\n    atomicAdd(&g_phase[3], p3);\n"
     "    atomicAdd(&g_phase[4], p4);\n    atomicAdd(&g_phase[5], 1ull);\n  }\n}"),
]
NO_MMA = [(
    '  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "\n'
    '      "{%8,%9}, {%0,%1,%2,%3};\\n"\n'
    '      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])\n'
    '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));',
    "  c[0] += a[0] ^ b0;\n  c[1] ^= b1;",
)]
NO_EPILOGUE = [
    ("    if (metric == kDot) {\n      warp_minima<kDot, NT, kSmallDot>",
     "    if (metric == -1) {\n      warp_minima<kDot, NT, kSmallDot>"),
    ("      warp_minima<kL2, NT, kSmallDot>(acc, pa, bsq, pos, ok, qs, wmin, warp, lane);\n    }",
     "      int sum = 0;\n#pragma unroll\n      for (int m = 0; m < 2; ++m)\n#pragma unroll\n"
     "        for (int n = 0; n < NT; ++n)\n#pragma unroll\n"
     "          for (int e = 0; e < 4; ++e) sum += acc[m][n][e];\n"
     "      if (lane < QT) wmin[warp * QT + lane] = static_cast<float>(sum) + bsq;\n    }"),
]
VARIANTS = {"kernel": [], "phases": PHASES, "no_mma": NO_MMA, "no_epilogue": NO_EPILOGUE}
EXACT = ("kernel", "phases")


def build(out: Path) -> dict:
    """Compile every variant (one nvcc each, all at once); returns name ->
    (library, ptxas registers and spills)."""
    src = (_build.CSRC / "int4_minima_mma.cu").read_text()
    nvcc = _build._nvcc()
    procs = {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the patch no longer matches: {old[:60]!r}")
            text = text.replace(old, new)
        d = out / name
        d.mkdir(parents=True)
        shutil.copy(_build.CSRC / "sm90_common.cuh", d)
        (d / "k.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(d / "k.so"), str(d / "k.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    libs = {}
    for name, p in procs.items():
        said = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{said}")
        lib = ctypes.CDLL(str(out / name / "k.so"))
        lib.svt_int4_block_minima_mma.argtypes = list(_build._SIGNATURES["svt_int4_block_minima_mma"])
        lib.svt_int4_block_minima_mma.restype = ctypes.c_int
        regs = [line.split(":", 1)[-1].strip() for line in said.splitlines() if "registers" in line]
        libs[name] = (lib, regs)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="rows")
    ap.add_argument("--d", type=int, default=384, help="columns")
    ap.add_argument("--batches", default="1,8,64,128")
    ap.add_argument("--iters", type=int, default=30, help="launches per timing")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--streamed", action="store_true", help="stream the query tile at every batch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k2_body: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    out = build_root() / "probe_k2_body"
    shutil.rmtree(out, ignore_errors=True)
    libs = build(out)
    for name, (_, regs) in libs.items():
        print(f"[probe] {name}: registers of each instance, as ptxas lists them: {regs}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    x = torch.randn((args.n, args.d), generator=gen, device="cuda")
    packed, alpha, csq = quantize4_device(x)
    del x
    n, d, L2 = args.n, args.d, DistanceMetric.L2
    groups = -(-n // 128)

    def run(lib, qc, qs, out_t, tile, planes):
        rc = lib.svt_int4_block_minima_mma(
            qc.data_ptr(), qs.data_ptr(), packed.data_ptr(), alpha.data_ptr(), csq.data_ptr(),
            None, out_t.data_ptr(), qc.shape[0], n, d, n, 0, tile,
            *((None, None) if planes is None else (planes[0].data_ptr(), planes[1].data_ptr())),
            torch.cuda.current_stream().cuda_stream,
        )
        if rc:
            raise RuntimeError(f"launch failed: cudaError {rc}")

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    for b in (int(v) for v in args.batches.split(",")):
        qc, qs, _ = quantize_query_int8(torch.randn((b, d), generator=gen, device="cuda"))
        streamed = args.streamed or k2_streams_queries(d, b)
        tile = k2_query_tile(d, b, streamed)
        # made once, outside the timed launches (the routed call makes them
        # at every call)
        planes = k2_query_planes(qc, tile) if streamed else None
        want = _launch_k2(qc, qs, packed, alpha, csq, L2, n, None, "simt")
        outs = {name: torch.empty((b, groups), device="cuda") for name in libs}
        fns = {name: (lambda lib=lib, o=outs[name]: run(lib, qc, qs, o, tile, planes))
               for name, (lib, _) in libs.items()}
        fns["cuda-core body"] = lambda: _launch_k2(qc, qs, packed, alpha, csq, L2, n, None, "simt")
        for name in EXACT:
            fns[name]()
            torch.cuda.synchronize()
            if not torch.equal(outs[name].view(torch.int32), want.view(torch.int32)):
                raise RuntimeError(f"{name} B={b}: minima differ from the CUDA-core body")
        first = {k: ms(f) for k, f in fns.items()}
        second = {k: ms(f) for k, f in reversed(list(fns.items()))}
        times = ", ".join(f"{k} {(first[k] + second[k]) / 2!r} ms" for k in fns)
        phases_lib = libs["phases"][0]
        buf = (ctypes.c_ulonglong * NCOUNTERS)()
        phases_lib.svt_probe_reset()
        fns["phases"]()
        torch.cuda.synchronize()
        phases_lib.svt_probe_read(buf)
        tiles = -(-n // 256)
        print(
            f"[probe] K2 {n}x{d} B={b} ({'streamed' if streamed else 'resident'} query tile {tile}; "
            f"kernel and phases == the CUDA-core "
            f"body bit for bit): {times}; cycles per row tile: ring wait {buf[0] / tiles:.0f}, "
            f"MMA loop {buf[1] / tiles:.0f}, epilogue {buf[2] / tiles:.0f}, combine "
            f"{buf[3] / tiles:.0f}; prologue {buf[4] / buf[5]:.0f} cycles per block over "
            f"{buf[5]} blocks | {card}",
            flush=True,
        )
    shutil.rmtree(out, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
