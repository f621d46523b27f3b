#!/usr/bin/env python3
"""Where K2's tensor-core bodies spend their time, on one CUDA GPU.

Builds a body's source as it stands and copies of it, each patched as
text: `phases` reads clock64() around each phase, `no_mma` replaces each
MMA by integer operations and `no_epilogue` the surrogates and their minima
by a sum (both give wrong minima and are timed only); for the wgmma body
`stages2` and `stages4` give each consumer's ring 2 or 4 stages (of 3)
and `static` hands the groups out in a fixed order (consumer c of C takes
groups c, c + C, ...) instead of at run time (all three exact). Then, over N x d
packed int4 codes of N(0, 1) rows from --seed, for each batch it checks the
body and `phases` bit for bit against K2's plain twin
(ops/int4_scan.py:int4_block_minima_reference), times all of them in turns
(CUDA events, one launch of the body alone a call, no host work beside it)
and prints the phases:

  --body mma (csrc/int4_minima_mma.cu): cycles per 256-row tile (thread 0 of
  each block, summed over blocks, over the tiles): the ring wait, the MMA
  loop, the epilogue and the group combine; the prologue per block. Each
  batch takes the query tile ops/int4_scan.py routes it to (resident, or
  streamed beside the codes: k2_streams_queries); --streamed streams it at
  every batch.

  --body wgmma (csrc/int4_minima_wgmma.cu): cycles per 128-row group of a
  consumer warpgroup (its thread 0, summed over consumers, over the
  groups): the full-barrier wait, the fragments' loads and the MMAs' issue,
  the wait for the MMAs, the epilogue (surrogates and warp minima) and the
  combine (barrier, group minimum, store); the prologue (to the first
  group) per consumer; a consumer's whole run on average and at most, in
  cycles and in ns (%globaltimer), and the SM clock they imply. The plan is k2_wgmma_plan's; --streamed streams the
  tile at every batch. The producer warp is not split: it only waits on the
  ring's empty barriers and issues copies.

    python3 tools/probe_k2_body.py [--body mma|wgmma] [--n 1000000] [--d 384]
                                   [--batches 1,8,64,128] [--iters 30] [--streamed]

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
from sqlite_vector_tpu_torch.ops.block_scan import tma_ready  # noqa: E402
from sqlite_vector_tpu_torch.ops.int4_scan import (  # noqa: E402
    int4_block_minima_reference,
    k2_query_planes,
    k2_query_tile,
    k2_streams_queries,
    k2_wgmma_plan,
    k2_wgmma_planes,
)
from sqlite_vector_tpu_torch.ops.quantize4 import quantize4_device, quantize_query_int8  # noqa: E402
from sqlite_vector_tpu_torch.types import DistanceMetric  # noqa: E402
from sqlite_vector_tpu_torch.utils.compile_cache import build_root  # noqa: E402

NCOUNTERS = 10


def counters(anchor: str) -> tuple[str, str]:
    """A patch that declares the probe's __device__ counters and the
    functions that read and reset them before `anchor`."""
    return (anchor,
            f"__device__ unsigned long long g_phase[{NCOUNTERS}];\n"
            'extern "C" int svt_probe_read(unsigned long long* h) {\n'
            "  return (int)cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase));\n}\n"
            'extern "C" int svt_probe_reset() {\n'
            f"  unsigned long long z[{NCOUNTERS}] = {{0}};\n"
            "  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(g_phase));\n}\n" + anchor)


# -- the mma.sync body: counters ring wait, MMA loop, epilogue, combine,
# prologue, blocks
MMA_PHASES = [
    counters("namespace {\n\nconstexpr int kTileRows = 256;"),
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
MMA_NO_MMA = [(
    '  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "\n'
    '      "{%8,%9}, {%0,%1,%2,%3};\\n"\n'
    '      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])\n'
    '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));',
    "  c[0] += a[0] ^ b0;\n  c[1] ^= b1;",
)]
MMA_NO_EPILOGUE = [(
    "    warp_surrogate_minima<NT, kSmallDot>(acc, metric, pa, pc, pin && pm != 0, qs, wmin, warp, lane);",
    "    {\n      int sum = 0;\n#pragma unroll\n      for (int m = 0; m < 2; ++m)\n#pragma unroll\n"
    "        for (int n = 0; n < NT; ++n)\n#pragma unroll\n"
    "          for (int e = 0; e < 4; ++e) sum += acc[m][n][e];\n"
    "      if (lane < QT) wmin[warp * QT + lane] = static_cast<float>(sum) + pa;\n    }",
)]

# -- the wgmma body: counters full wait, fragments + issue, MMA wait,
# epilogue, combine, prologue, consumers
WGMMA_PHASES = [
    counters("namespace {\n\nconstexpr int kChunk = 128;"),
    ("  chunk_fragments<KS>(lo, hi, st, w, lane >> 2, lane & 3);\n  chunk_mmas<NT, KS>(acc, lo, hi, qlo);\n",
     "  const long long c0 = clock64();\n"
     "  chunk_fragments<KS>(lo, hi, st, w, lane >> 2, lane & 3);\n  chunk_mmas<NT, KS>(acc, lo, hi, qlo);\n"
     "  const long long c1 = clock64();\n"),
    ("  wgmma_wait();\n  fence_acc(acc);\n  if constexpr (kStream) {",
     "  wgmma_wait();\n  fence_acc(acc);\n"
     "  if ((threadIdx.x & 127) == 0) {\n    atomicAdd(&g_phase[1], (unsigned long long)(c1 - c0));\n"
     "    atomicAdd(&g_phase[2], (unsigned long long)(clock64() - c1));\n  }\n"
     "  if constexpr (kStream) {"),
    ("  extern __shared__ __align__(1024) unsigned char smem_raw[];\n",
     "  extern __shared__ __align__(1024) unsigned char smem_raw[];\n  const long long t_start = clock64();\n"
     "  unsigned long long ns_start;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(ns_start));\n"),
    ("    int i = 0;  // ring step\n    for (int it = 0;; ++it) {\n"
     "      mbar_wait(full(wg, i % stages), (i / stages) & 1);\n",
     "    unsigned long long p0 = 0, p3 = 0, p4 = 0, p5 = clock64() - t_start;\n"
     "    int i = 0;  // ring step\n    for (int it = 0;; ++it) {\n"
     "      const long long cw0 = clock64();\n"
     "      mbar_wait(full(wg, i % stages), (i / stages) & 1);\n      p0 += clock64() - cw0;\n"),
    ("        if (ch > 0) mbar_wait(full(wg, s), (i / stages) & 1);\n",
     "        const long long cw = clock64();\n        if (ch > 0) mbar_wait(full(wg, s), (i / stages) & 1);\n"
     "        p0 += clock64() - cw;\n"),
    ("      float* wm = wmin + (it & 1) * 4 * QT;  // two buffers: one barrier a group\n",
     "      float* wm = wmin + (it & 1) * 4 * QT;  // two buffers: one barrier a group\n"
     "      const long long ce = clock64();\n"),
    ("      bar_sync(kBarConsumer + wg, 128);\n      if (ltid < QT && q0 + ltid < B) {",
     "      const long long cc = clock64();\n      p3 += cc - ce;\n"
     "      bar_sync(kBarConsumer + wg, 128);\n      if (ltid < QT && q0 + ltid < B) {"),
    ("        out[static_cast<long long>(q0 + ltid) * groups + group] = mn;\n      }\n    }\n  }\n}",
     "        out[static_cast<long long>(q0 + ltid) * groups + group] = mn;\n      }\n"
     "      p4 += clock64() - cc;\n    }\n"
     "    if (ltid == 0) {\n      atomicAdd(&g_phase[0], p0);\n      atomicAdd(&g_phase[3], p3);\n"
     "      atomicAdd(&g_phase[4], p4);\n      atomicAdd(&g_phase[5], p5);\n"
     "      atomicAdd(&g_phase[6], 1ull);\n"
     "      unsigned long long ns_end;\n      asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(ns_end));\n"
     "      atomicMax(&g_phase[7], (unsigned long long)(clock64() - t_start));\n"
     "      atomicMax(&g_phase[8], ns_end - ns_start);\n"
     "      atomicAdd(&g_phase[9], (unsigned long long)(clock64() - t_start));\n    }\n  }\n}"),
]
WGMMA_NO_MMA = [
    ("    for (int m = 0; m < 2; ++m) WgmmaU8S8<QT>::mma(flat(acc[m]), lo[ks][m], blo + 2 * ks);",
     "    for (int m = 0; m < 2; ++m) acc[m][0][0] += static_cast<int>(lo[ks][m][0] ^ static_cast<uint32_t>(blo));"),
    ("    for (int m = 0; m < 2; ++m) WgmmaU8S8<QT>::mma(flat(acc[m]), hi[ks][m], bhi + 2 * ks);",
     "    for (int m = 0; m < 2; ++m) acc[m][0][1] ^= static_cast<int>(hi[ks][m][1] ^ static_cast<uint32_t>(bhi));"),
]
WGMMA_NO_EPILOGUE = [(
    "      if (small) {\n        warp_surrogate_minima<NT, true>(acc, metric, pa, pc, ok, qs, wm, w, lane);\n"
    "      } else {\n        warp_surrogate_minima<NT, false>(acc, metric, pa, pc, ok, qs, wm, w, lane);\n      }\n",
    "      {\n        int sum = ok;\n#pragma unroll\n        for (int m = 0; m < 2; ++m)\n#pragma unroll\n"
    "          for (int n = 0; n < NT; ++n)\n#pragma unroll\n"
    "            for (int e = 0; e < 4; ++e) sum += acc[m][n][e];\n"
    "        if (lane < QT) wm[w * QT + lane] = static_cast<float>(sum) + pa;\n      }\n",
)]

BODIES = {
    "mma": ("int4_minima_mma.cu", "svt_int4_block_minima_mma",
            {"kernel": [], "phases": MMA_PHASES, "no_mma": MMA_NO_MMA, "no_epilogue": MMA_NO_EPILOGUE}),
    "wgmma": ("int4_minima_wgmma.cu", "svt_int4_block_minima_wgmma",
              {"kernel": [], "phases": WGMMA_PHASES, "no_mma": WGMMA_NO_MMA,
               "no_epilogue": WGMMA_NO_EPILOGUE,
               "stages2": [("constexpr int kMaxStages = 3;", "constexpr int kMaxStages = 2;")],
               "stages4": [("constexpr int kMaxStages = 3;", "constexpr int kMaxStages = 4;")],
               "static": [(
                   "      for (int i = 0;;) {\n        const int group = atomicAdd(next + qt, 1);",
                   "      int k_static = 0;\n      for (int i = 0;;) {\n"
                   "        const int group = 2 * (blockIdx.x / nqt) + w + 2 * (gridDim.x / nqt) * k_static++;")]}),
}
EXACT = ("kernel", "phases", "stages2", "stages4", "static")


def build(out: Path, body: str) -> dict:
    """Compile every variant of the body (one nvcc each, all at once);
    returns name -> (library, ptxas registers and spills)."""
    source, fn, variants = BODIES[body]
    src = (_build.CSRC / source).read_text()
    nvcc = _build._nvcc()
    procs = {}
    for name, patches in variants.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the patch no longer matches: {old[:60]!r}")
            text = text.replace(old, new)
        d = out / name
        d.mkdir(parents=True)
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, d)
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
        getattr(lib, fn).argtypes = list(_build._SIGNATURES[fn])
        getattr(lib, fn).restype = ctypes.c_int
        regs = [line.split(":", 1)[-1].strip() for line in said.splitlines() if "registers" in line]
        libs[name] = (lib, regs)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--body", choices=sorted(BODIES), default="wgmma")
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
    out = build_root() / f"probe_k2_body_{args.body}"
    shutil.rmtree(out, ignore_errors=True)
    libs = build(out, args.body)
    for name, (_, regs) in libs.items():
        print(f"[probe] {args.body} {name}: registers of each instance, as ptxas lists them: {regs}",
              flush=True)
    fn_name = BODIES[args.body][1]

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    x = torch.randn((args.n, args.d), generator=gen, device="cuda")
    packed, alpha, csq = quantize4_device(x)
    del x
    n, d, L2 = args.n, args.d, DistanceMetric.L2
    groups = -(-n // 128)
    counters = torch.zeros(1024, dtype=torch.int32, device="cuda")

    def run(lib, qc, qs, out_t, tile, planes):
        if args.body == "wgmma":
            # (the query planes, or None: qc itself; the sums; streamed;
            # the work counters, zero, which each launch leaves zero)
            tail = (None if planes[0] is None else planes[0].data_ptr(),
                    None if planes[1] is None else planes[1].data_ptr(), int(planes[1] is not None),
                    counters.data_ptr())
        else:
            tail = (None, None) if planes is None else (planes[0].data_ptr(), planes[1].data_ptr())
        rc = getattr(lib, fn_name)(
            qc.data_ptr(), qs.data_ptr(), packed.data_ptr(), alpha.data_ptr(), csq.data_ptr(),
            None, out_t.data_ptr(), qc.shape[0], n, d, n, 0, tile, *tail,
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
        # the planes of a streamed tile are made once, outside the timed
        # launches (the routed call makes them at every call)
        if args.body == "wgmma":
            tile, streamed = k2_wgmma_plan(d, b, True if args.streamed else None)
            planes = (None if d % 2 == 0 and tma_ready(qc) else k2_wgmma_planes(qc, tile),
                      qc.sum(1, dtype=torch.int32) if streamed else None)
        else:
            streamed = args.streamed or k2_streams_queries(d, b)
            tile = k2_query_tile(d, b, streamed)
            planes = k2_query_planes(qc, tile) if streamed else None
        want = int4_block_minima_reference(qc, qs, packed, alpha, csq, L2, n)
        outs = {name: torch.empty((b, groups), device="cuda") for name in libs}
        fns = {name: (lambda lib=lib, o=outs[name]: run(lib, qc, qs, o, tile, planes))
               for name, (lib, _) in libs.items()}
        for name in (e for e in EXACT if e in fns):
            fns[name]()
            torch.cuda.synchronize()
            if not torch.equal(outs[name].view(torch.int32), want.view(torch.int32)):
                raise RuntimeError(f"{name} B={b}: minima differ from the twin")
        first = {k: ms(f) for k, f in fns.items()}
        second = {k: ms(f) for k, f in reversed(list(fns.items()))}
        times = ", ".join(f"{k} {(first[k] + second[k]) / 2!r} ms" for k in fns)
        phases_lib = libs["phases"][0]
        buf = (ctypes.c_ulonglong * NCOUNTERS)()
        phases_lib.svt_probe_reset()
        fns["phases"]()
        torch.cuda.synchronize()
        phases_lib.svt_probe_read(buf)
        if args.body == "wgmma":
            split = (f"cycles per group of a consumer: full wait {buf[0] / groups:.0f}, fragments + "
                     f"issue {buf[1] / groups:.0f}, MMA wait {buf[2] / groups:.0f}, epilogue "
                     f"{buf[3] / groups:.0f}, combine {buf[4] / groups:.0f}; prologue "
                     f"{buf[5] / max(buf[6], 1):.0f} cycles per consumer over {buf[6]} consumers; a "
                     f"consumer's whole run {buf[9] / max(buf[6], 1):.0f} cycles on average, {buf[7]} at "
                     f"most, {buf[8]} ns at most (globaltimer), so {buf[7] / max(buf[8], 1):.3f} GHz")
        else:
            tiles = -(-n // 256)
            split = (f"cycles per row tile: ring wait {buf[0] / tiles:.0f}, MMA loop {buf[1] / tiles:.0f}, "
                     f"epilogue {buf[2] / tiles:.0f}, combine {buf[3] / tiles:.0f}; prologue "
                     f"{buf[4] / max(buf[5], 1):.0f} cycles per block over {buf[5]} blocks")
        print(
            f"[probe] K2 {args.body} body {n}x{d} B={b} ({'streamed' if streamed else 'resident'} "
            f"query tile {tile}; kernel and phases == the twin bit for bit): {times}; "
            f"{split} | {card}",
            flush=True,
        )
    shutil.rmtree(out, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
