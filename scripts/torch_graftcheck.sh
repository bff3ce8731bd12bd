#!/usr/bin/env bash
# graftcheck of the PyTorch port: its static preflight, runnable standalone.
# The port's bench runs `--lint --audit --arms llama-tp2-gqa` before any arm.
#
# No args = both engines over the full arm roster and the default world
# tiers; any args are passed through to the CLI (e.g.
# `scripts/torch_graftcheck.sh --lint`, `--audit --arms llama-tp2-gqa`,
# `--memory`). `--changed` is the cheap pre-commit path: lint only the files
# changed vs the merge-base with the default branch (no audits) — e.g. as a
# git hook:
#   echo 'scripts/torch_graftcheck.sh --changed' > .git/hooks/pre-commit
# The audit runs on the CPU as one rank of a fake process group and never
# initializes CUDA, so it is safe beside a process that trains on the card.
set -euo pipefail
cd "$(dirname "$0")/.."
exec python -m distributed_llm_training_benchmark_framework_tpu_torch.analysis.static "${@:---all}"
