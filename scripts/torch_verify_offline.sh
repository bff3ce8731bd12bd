#!/usr/bin/env bash
# Offline verification of the PyTorch port: prove it imports, builds its
# models and data, reads its configs and passes its memory audit with no
# network access, on the CPU (no card is touched).
#
# The port's counterpart of scripts/verify_offline.sh, check for check (its
# local mode): [1/5] imports; [2/5] tiers S and A instantiated (tier B by
# shape, on the meta device) with their parameter counts, which
# tests/test_torch_offline_scripts.py holds to the JAX package's; [3/5] the
# synthetic dataset; [4/5] the bundled strategy configs, read by the port's
# loader; [5/5] the port's GC110 `--memory` audit. `--image <tag>` (the
# container form) waits for the port's image (ROADMAP Queue 1 item 19a) and
# is refused (exit 2).
set -euo pipefail
cd "$(dirname "$0")/.."

if [ "${1:-}" = "--image" ]; then
  echo "torch_verify_offline.sh: --image is not supported by the port yet: it needs the" \
       "port's container image, which cannot be built offline (ROADMAP Queue 1 item 19a)" >&2
  exit 2
fi
if [ $# -gt 0 ]; then
  echo "usage: scripts/torch_verify_offline.sh" >&2
  exit 2
fi

PY_TESTS=$(cat <<'PYEOF'
print("--- [1/5] imports ---")
import numpy, torch
import distributed_llm_training_benchmark_framework_tpu_torch as fw
from distributed_llm_training_benchmark_framework_tpu_torch import bench, bridge, train  # noqa
print(f"OK: torch {torch.__version__}, numpy {numpy.__version__}, port {fw.__name__}")

print("--- [2/5] model tiers instantiate on CPU ---")
from distributed_llm_training_benchmark_framework_tpu_torch.models import (
    TinyGPT, count_params, get_model_config)
for tier in ("S", "A"):
    model = TinyGPT(get_model_config(tier, 256)).init_weights(torch.Generator().manual_seed(0))
    print(f"OK: tier {tier}: {count_params(model)} params")
with torch.device("meta"):
    n = count_params(TinyGPT(get_model_config("B", 256)))
print(f"OK: tier B (meta device, shapes only): {n} params")

print("--- [3/5] synthetic dataset ---")
from distributed_llm_training_benchmark_framework_tpu_torch.data import SyntheticDataset, step_batch
table = SyntheticDataset(vocab_size=32000, seq_len=128, size=16).to_device("cpu")
assert step_batch(table, 0, 1, 4)[0].shape == (4, 128)
print("OK: dataset constructs and batches")

print("--- [4/5] bundled configs ---")
import glob
from distributed_llm_training_benchmark_framework_tpu_torch.parallel.strategies import (
    load_strategy_config)
files = sorted(glob.glob("configs/strategies/*.json"))
assert len(files) >= 4, files
for f in files:
    load_strategy_config(f)
print(f"OK: {len(files)} strategy configs parse")
print("PY CHECKS PASSED")
PYEOF
)

echo "=== Offline verification of the port (local checkout) ==="
python -c "$PY_TESTS"
echo "--- [5/5] graftcheck --memory (GC110 memory budgets) ---"
# The port's memory audit: every roster arm stepped on a fake process group
# on the CPU against the frozen memory_budgets section and the growth laws.
python -m distributed_llm_training_benchmark_framework_tpu_torch.analysis.static --memory
echo "ALL OFFLINE CHECKS (incl. GC110 memory audit) PASSED"
