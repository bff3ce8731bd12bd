#!/usr/bin/env python3
"""What one process group per process costs the collective audit: the same
arms audited in this process (``destroy_process_group`` between arms, as
``analysis.static.collective_audit`` does) and in a child process each.

    python3 scripts/torch_audit_process_cost.py [--arms ddp-dp8 zero3-dp8 ...]

Runs on the CPU, one torch thread; prints both walls.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arms", nargs="*",
                   default=["ddp-dp8", "zero3-dp8", "llama-tp2-gqa", "zero2-ep2-moe"])
    args = p.parse_args()
    import torch

    from distributed_llm_training_benchmark_framework_tpu_torch.analysis.static import (
        collective_audit as audit,
    )

    torch.set_num_threads(1)
    audit.audit_arm(audit.ROSTER["zero2-dp8"])  # the imports, paid once
    t0 = time.perf_counter()
    for arm in args.arms:
        audit.audit_arm(audit.ROSTER[arm])
    t1 = time.perf_counter()
    for arm in args.arms:
        code = ("import torch; torch.set_num_threads(1); from distributed_llm_training_"
                "benchmark_framework_tpu_torch.analysis.static import collective_audit as a; "
                f"a.audit_arm(a.ROSTER[{arm!r}])")
        subprocess.run([sys.executable, "-c", code], check=True, capture_output=True, cwd=ROOT)
    t2 = time.perf_counter()
    n = len(args.arms)
    print(f"in process: {t1 - t0:.2f} s for {n} arms ({(t1 - t0) / n:.2f} s each); "
          f"a child per arm: {t2 - t1:.2f} s ({(t2 - t1) / n:.2f} s each)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
