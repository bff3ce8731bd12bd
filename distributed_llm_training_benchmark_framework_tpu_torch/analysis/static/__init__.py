"""graftcheck of the port: static analysis over its source and its
collectives, on the CPU.

The counterpart of ``distributed_llm_training_benchmark_framework_tpu/
analysis/static``. Two engines, one CLI (``python -m
distributed_llm_training_benchmark_framework_tpu_torch.analysis.static``):

- ``collective_audit`` (JAX's ``hlo_audit``): every (strategy x model
  family x mesh geometry) arm of the roster built on the CPU as one rank of
  a fake process group and stepped once, its ``c10d`` collectives counted
  at the dispatcher (all-gather / reduce-scatter / all-reduce / send / recv /
  all-to-all: count, bytes and group size; bf16->f32 casts; replication
  reshard suspects) against the frozen per-arm budgets in
  ``configs/collective_budgets_torch.json``; the pipeline arms' message and
  bubble laws; the memory audit (GC110); the world tiers of 16, 64 and 256
  ranks with their growth laws.
- ``lint``: JAX's rule ids re-aimed at the port's hot path (host syncs in
  the timed loop, unknown mesh axes, implicit dtypes, collectives without a
  mesh group, per-micro-batch syncs in the schedules, ...), with
  ``# graftcheck: disable=RULE`` suppression.

The port's bench runs it as its preflight (``bench.run_preflight``), as does
``scripts/torch_graftcheck.sh``; the tier-1 modules are
``tests/test_torch_static_lint.py`` and ``tests/test_torch_static_audit.py``.
"""

from .collective_audit import (  # noqa: F401
    ArmSpec,
    ArmReport,
    ROSTER,
    audit_arm,
    diff_against_budget,
    load_budgets,
    write_budgets,
    DEFAULT_BUDGETS_PATH,
)
from .lint import RULES, Violation, run_lint  # noqa: F401

__all__ = [
    "ArmSpec",
    "ArmReport",
    "ROSTER",
    "audit_arm",
    "diff_against_budget",
    "load_budgets",
    "write_budgets",
    "DEFAULT_BUDGETS_PATH",
    "RULES",
    "Violation",
    "run_lint",
]
