#!/usr/bin/env bash
# Retry wrapper for one benchmark arm of the PyTorch port: a thin shim over
# the port's supervisor, the counterpart of scripts/with_retries.sh.
#
#   torch_with_retries.sh [--resume-flag FLAG] [--drop-on-retry FLAG] -- cmd args...
#
# The retry logic is the supervisor's
# (distributed_llm_training_benchmark_framework_tpu_torch/runtime/supervisor.py):
# exit classification against the EXIT_* codes, a declarative recovery
# policy (RECOVERY_POLICY=configs/recovery_policy.json; without one the env
# contract below maps onto an equivalent policy), exponential backoff with
# deterministic jitter, and, under a policy that allows it, a geometry
# shrink or regrow against the checkpoint's geometry sidecar when the
# device count changed between attempts. This file only keeps the call
# site stable; it must never grow a retry loop of its own.
#
# The exec hands this process to the supervisor, which forwards SIGTERM to
# the child (its preemption guard gets to write an emergency checkpoint)
# and exits 143 on a TERM between attempts. A multi-rank arm runs its ranks
# under `python -m distributed_llm_training_benchmark_framework_tpu_torch.runtime.launch
# --nproc N -- ...` (not torchrun, which exits 1 where its ranks exit 75).
#
# Env contract (the supervisor's legacy policy mapping):
#   MAX_ARM_RETRIES    retries after the first attempt (default 1; 0 = off)
#   RETRY_BACKOFF_SEC  base backoff, doubled each retry (default 5)
#   RECOVERY_POLICY    recovery-policy JSON path (optional; overrides the
#                      two knobs above with per-class actions and budgets)
#   PYTHON_BIN         the interpreter (default: python)
#
# Exit code: the final attempt's (a run that stays broken fails the suite
# with its real code, EXIT_PREEMPTED 75 included when every grace window
# was spent; EXIT_NOTHING_TO_RESUME 77 stays terminal).
set -uo pipefail

REPO_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
export PYTHONPATH="${REPO_DIR}${PYTHONPATH:+:$PYTHONPATH}"
exec "${PYTHON_BIN:-python}" -u -m \
  distributed_llm_training_benchmark_framework_tpu_torch.runtime.supervisor "$@"
