#!/usr/bin/env bash
# The port's run-registry regression gate, runnable standalone: the
# counterpart of scripts/regress_gate.sh over the port's registry
# (results/registry_torch, or $REGRESS_REGISTRY_TORCH).
#
# No args = gate every arm's latest run against its last known good; any
# args are passed through to the CLI, e.g.
#   scripts/torch_regress_gate.sh ingest --results-dir results
#   scripts/torch_regress_gate.sh trend bench_tinygpt_tierA_seq2048 --png t.png
#   scripts/torch_regress_gate.sh compare last-good latest --arm <arm>
# Exit codes: 0 clean, 1 regression, 2 operational (schema drift, unknown
# record).
set -euo pipefail
cd "$(dirname "$0")/.."
if [ $# -eq 0 ]; then set -- gate --all; fi
exec python -m distributed_llm_training_benchmark_framework_tpu_torch.regress "$@"
