"""benchreg: persistent run registry + statistical regression gate.

Port of ``distributed_llm_training_benchmark_framework_tpu/regress`` over
the port's own registry root (``results/registry_torch``; see ``store``).

The framework's accumulation layer (docs/REGRESSION.md). Every completed
run's evidence — the result row, its telemetry JSONL windows, an
environment fingerprint — ingests into an append-only, content-addressed
registry under ``results/registry_torch/``; the statistics engine turns two
records (or two telemetry files) into a {regression, improvement,
neutral, insufficient-data} verdict with seeded-bootstrap confidence
intervals and a registry-derived noise floor; and the gate makes that
verdict an exit code the suite's finish path enforces.

    regress.store    the registry (schema-versioned records, partials
                     stored but never baseline-eligible, schema drift
                     refused loudly)
    regress.stats    seeded bootstrap CIs, Mann-Whitney/permutation
                     significance, noise floor, verdict classifier —
                     shared with telemetry_report --compare
    regress.compare  the CLI: ingest / compare / trend / gate
                     (python -m ...regress)
"""

from .store import (  # noqa: F401
    REGISTRY_ENV,
    REGISTRY_SCHEMA_VERSION,
    LegacyRefused,
    Registry,
    SchemaDrift,
    default_registry_root,
    ingest_legacy,
    ingest_results_dir,
    make_record,
    record_from_bench_row,
)
from .stats import (  # noqa: F401
    VERDICT_IMPROVEMENT,
    VERDICT_INSUFFICIENT,
    VERDICT_NEUTRAL,
    VERDICT_REGRESSION,
    MetricComparison,
)
