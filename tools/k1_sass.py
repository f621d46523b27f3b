#!/usr/bin/env python3
"""Count selected SASS opcodes in each K1 kernel instance of the built
kernel library (csrc/block_minima*.cu), so one can see which instructions
the compiler chose for the inner loops: the tensor-core body's HMMA/IMMA,
and the L1 body's FADD, VABSDIFF4, IDP4A and integer adds.

Needs a CUDA toolkit (cuobjdump) and builds the library if it is not built:

    python3 tools/k1_sass.py [--dump PATH]

--dump writes the whole disassembly of the K1 kernels to PATH.
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

OPCODES = ("HMMA", "IMMA", "FADD", "FFMA", "VABSDIFF4", "IDP", "IADD3", "LDS", "LDGSTS")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dump", help="write the K1 kernels' disassembly here")
    args = ap.parse_args()
    from sqlite_vector_tpu_torch.ops._build import library_path, load_library

    load_library()
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [cuobjdump, "-sass", str(library_path())], capture_output=True, text=True, check=True
    ).stdout
    counts: dict[str, collections.Counter] = {}
    kept = []
    name = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if ("minima_kernel" in m.group(1) and "int4" not in m.group(1)) else None
            if name:
                counts[name] = collections.Counter()
        if name is None:
            continue
        kept.append(line)
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]+)?", line)
        if m:
            for op in OPCODES:
                if m.group(1).startswith(op):
                    counts[name][m.group(1) + (m.group(2) or "")] += 1
    for fn, c in counts.items():
        print(f"{fn}: " + ", ".join(f"{op} {n}" for op, n in sorted(c.items())))
    if args.dump:
        Path(args.dump).parent.mkdir(parents=True, exist_ok=True)
        Path(args.dump).write_text("\n".join(kept))
    return 0


if __name__ == "__main__":
    sys.exit(main())
