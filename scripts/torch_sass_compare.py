#!/usr/bin/env python3
"""Compare the machine code (SASS) of the port's CUDA kernels between two
source trees, function by function.

    python3 scripts/torch_sass_compare.py OLD_CSRC [NEW_CSRC]
                                          [--libs flash_fwd ring_fwd flash_bwd fwd_variants]

OLD_CSRC and NEW_CSRC are ``csrc`` directories (NEW_CSRC defaults to the
package's own). Each library is compiled from both with the flags the
package builds with (one nvcc per source, all at once, into
``build/sass_compare/``), disassembled with ``cuobjdump -sass``, and every
kernel instance is compared instruction by instruction. Prints one line per
library: instances identical, instances that differ (with their instruction
counts and the number of differing lines), and instances found on one side
only. A refactor of a shared kernel header that should leave a kernel as it
was is proven by "identical" here; its times then need no new measurement.
Needs nvcc and cuobjdump (the CUDA toolkit), not a card.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distributed_llm_training_benchmark_framework_tpu_torch.ops import _build  # noqa: E402

OUT = Path(__file__).resolve().parents[1] / "build" / "sass_compare"
INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/")


def functions(sass: str) -> dict:
    """{mangled kernel name: [instruction lines]} of a cuobjdump -sass listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m[1]
            out[name] = []
        elif name and INSTRUCTION.search(line):
            out[name].append(line.strip())
    return out


def compare(old: dict, new: dict) -> str:
    same = [f for f in old if f in new and old[f] == new[f]]
    differ = [f"{f} ({len(old[f])} -> {len(new[f])} instructions, "
              f"{sum(a != b for a, b in zip(old[f], new[f])) + abs(len(old[f]) - len(new[f]))}"
              " lines differ)" for f in sorted(old) if f in new and old[f] != new[f]]
    return (f"{len(same)} identical, {len(differ)} differ {differ}, "
            f"only old {sorted(set(old) - set(new))}, only new {sorted(set(new) - set(old))}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("old", type=Path)
    p.add_argument("new", type=Path, nargs="?", default=_build.CSRC)
    p.add_argument("--libs", nargs="+", default=list(_build.SIGNATURES))
    args = p.parse_args(argv)
    nvcc = _build.nvcc_path()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for side, src in (("old", args.old), ("new", args.new)):
        for lib in args.libs:
            so = OUT / f"{side}_{lib}.so"
            procs[side, lib] = (so, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-o", str(so), str(src / f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    sass = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {key}: exit {proc.returncode}\n{log}")
        sass[key] = functions(subprocess.run([cuobjdump, "-sass", str(so)], check=True,
                                             capture_output=True, text=True).stdout)
    for lib in args.libs:
        print(f"{lib}: {compare(sass['old', lib], sass['new', lib])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
