"""Debug mode: fail-fast collectives and numerics (``--debug`` / ``BENCH_DEBUG=1``).

Port of ``distributed_llm_training_benchmark_framework_tpu/runtime/debug.py``.
JAX turns on its NaN check and its tracer-leak check; the reference it was
modelled on bakes strict NCCL settings into its image. The port is PyTorch
on NCCL again, so ``enable_debug`` sets those settings, before the process
group starts, and turns on autograd's anomaly mode as the counterpart of
JAX's NaN check:

- ``TORCH_DISTRIBUTED_DEBUG=DETAIL``: every collective is checked for a
  mismatch across the ranks (op, shapes, dtypes) before it runs;
- ``TORCH_NCCL_BLOCKING_WAIT=1``: a wait on a collective that times out
  raises in the waiting process instead of hanging it;
- ``TORCH_NCCL_ASYNC_ERROR_HANDLING=1``: a failed or timed-out NCCL
  collective tears the process down;
- ``torch.autograd.set_detect_anomaly(True)``: a backward that produces a
  NaN raises at the operation that made it, with its forward's traceback.
  JAX has no tracer leak to check in eager PyTorch.

The settings are left as the caller set them where it set them already.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

#: The environment ``enable_debug`` sets (where it is not set already).
DEBUG_ENV: Dict[str, str] = {
    "TORCH_DISTRIBUTED_DEBUG": "DETAIL",
    "TORCH_NCCL_BLOCKING_WAIT": "1",
    "TORCH_NCCL_ASYNC_ERROR_HANDLING": "1",
}


def debug_requested() -> bool:
    """``BENCH_DEBUG`` set to anything but "0", "" or "false" (JAX's test)."""
    return os.environ.get("BENCH_DEBUG", "0") not in ("0", "", "false")


def enable_debug() -> None:
    """Set ``DEBUG_ENV`` and turn on autograd's anomaly mode; call it before
    the process group starts (NCCL reads its settings there)."""
    for key, value in DEBUG_ENV.items():
        os.environ.setdefault(key, value)
    torch.autograd.set_detect_anomaly(True)
