#!/usr/bin/env bash
# Scaling suite of the PyTorch port: weak/strong scaling sweep -> registry ->
# curves -> gate -> report, the counterpart of scripts/scaling_suite.sh over
# the port's package, stage for stage.
#
# For each strategy the suite measures one FRESH run per geometry (the
# clean curve points), and between geometries rides the elastic resume
# (runtime/checkpoint.py: a checkpoint restores at another data width): a
# short continuation run at the NEXT geometry resumes the previous
# geometry's checkpoint (grow leg, -stitch), and the last geometry's
# checkpoint resumes at the first (shrink leg, -shrink). The stitch runs
# publish resumed=true / resume_geometry_changed=true and flow into the
# registry as flagged points: the curves show them stitched, the gate skips
# them, and parse_metrics never lets them anchor scaling efficiency.
#
# After the sweep: analysis.scaling --stamp-results-dir writes each clean
# row's scaling_efficiency (fraction of ideal per-chip throughput against
# the suite's smallest geometry) into its result JSON, the validator checks
# the rows, ingest records them in the port's registry ($RESULTS_DIR/registry
# unless --registry names another; never JAX's results/registry), the curves
# are drawn, `regress gate --all` verdicts an efficiency regression at any
# geometry, and parse_metrics / make_report write the report.
#
#   scripts/torch_scaling_suite.sh [--dryrun] [--results-dir DIR] [--registry DIR]
#
# Where the ranks run: a geometry above 1 runs its ranks as `python -m
# <port>.runtime.launch --nproc ws`, one process per rank. By default each
# rank takes its own card (NCCL) and the geometries are 1 and each of 2, 4,
# 8, 16 that torch.cuda.device_count() holds. DIST_BACKEND=gloo gives each
# run the harness's --backend gloo, which carries the collectives over gloo
# through the host instead and lets several ranks share a card (rank r on
# card r mod the count): on a one-card host the
# curves then prove the mechanics (fresh points, reshards, stamps, gate),
# not scaling across cards.
#
# --dryrun: the CPU smoke: tier S, fsdp, ws 1 -> 2 as gloo ranks with
# --device cpu (the 1 -> 2 resume is a real reshard of FSDP2's shards);
# wired into scripts/torch_run_all_benchmarks.sh behind SCALING_SUITE=1
# (SKIP_SCALING=1 bypasses). Knobs (env): SCALING_STRATEGIES,
# SCALING_GEOMETRIES, SCALING_MODE=weak|strong, SKIP_STITCH=1, SKIP_GATE=1,
# PROFILE=1, TIMEOUT_PER_RUN, DEVICE (cuda, or cpu), DIST_BACKEND, plus
# TIER/SEQ_LEN/STEPS/WARMUP_STEPS/PER_DEVICE_BATCH/GRAD_ACCUM/SYNC_EVERY/
# ATTENTION. Each stage prints "STAGE <name> wall <s>s".
set -euo pipefail
cd "$(dirname "$0")/.."
REPO_ROOT="$(pwd)"
export PYTHONPATH="${REPO_ROOT}${PYTHONPATH:+:$PYTHONPATH}"
PY="${PYTHON_BIN:-python}"
P=distributed_llm_training_benchmark_framework_tpu_torch

DRYRUN=0
RESULTS_DIR="${RESULTS_DIR:-}"
REGISTRY_DIR="${REGISTRY_DIR:-}"
while [ $# -gt 0 ]; do
  case "$1" in
    --dryrun) DRYRUN=1; shift ;;
    --results-dir) RESULTS_DIR="$2"; shift 2 ;;
    --registry) REGISTRY_DIR="$2"; shift 2 ;;
    *) echo "unknown flag $1"; exit 1 ;;
  esac
done

if [ "$DRYRUN" = "1" ]; then
  # The CPU smoke: tiny model, two gloo ranks, fsdp (the dp1 -> dp2 resume
  # is a real reshard, not a replicated no-op).
  DEVICE=cpu
  TIER="${TIER:-S}"; SEQ_LEN="${SEQ_LEN:-64}"; STEPS="${STEPS:-12}"
  WARMUP_STEPS="${WARMUP_STEPS:-2}"; SYNC_EVERY="${SYNC_EVERY:-2}"
  PER_DEVICE_BATCH="${PER_DEVICE_BATCH:-2}"; GRAD_ACCUM="${GRAD_ACCUM:-1}"
  SCALING_STRATEGIES="${SCALING_STRATEGIES:-fsdp}"
  SCALING_GEOMETRIES="${SCALING_GEOMETRIES:-1 2}"
  RESULTS_DIR="${RESULTS_DIR:-$(mktemp -d "${TMPDIR:-/tmp}/torch_scaling_dryrun.XXXXXX")}"
else
  TIER="${TIER:-A}"; SEQ_LEN="${SEQ_LEN:-2048}"; STEPS="${STEPS:-100}"
  WARMUP_STEPS="${WARMUP_STEPS:-5}"; SYNC_EVERY="${SYNC_EVERY:-10}"
  PER_DEVICE_BATCH="${PER_DEVICE_BATCH:-1}"; GRAD_ACCUM="${GRAD_ACCUM:-4}"
  SCALING_STRATEGIES="${SCALING_STRATEGIES:-ddp fsdp zero2}"
  RESULTS_DIR="${RESULTS_DIR:-$REPO_ROOT/results/torch_scaling}"
fi
# LAYER_LOOP=scan runs every point of every arm under the scan layer loop
# (the harness's default); the suite's own default stays unrolled, as JAX's.
LAYER_LOOP="${LAYER_LOOP:-unrolled}"
ATTENTION="${ATTENTION:-reference}"
# PROFILE=1 gives every point (fresh and stitch legs) a --profile-dir, so
# the rows carry step anatomy. Profile the whole sweep or none of it: a
# mixed sweep splits into two curves.
PROFILE="${PROFILE:-0}"
SCALING_MODE="${SCALING_MODE:-weak}"
SKIP_STITCH="${SKIP_STITCH:-0}"
SKIP_GATE="${SKIP_GATE:-0}"
TIMEOUT_PER_RUN="${TIMEOUT_PER_RUN:-1800}"
DEVICE="${DEVICE:-}"
DIST_BACKEND="${DIST_BACKEND:-}"
REGISTRY_DIR="${REGISTRY_DIR:-$RESULTS_DIR/registry}"
DEVICE_FLAGS=""
case "$DEVICE" in
  "" | cuda) ;;
  cpu) DEVICE_FLAGS="--device cpu" ;;
  *) echo "ERROR: DEVICE=$DEVICE (expected cuda or cpu)"; exit 1 ;;
esac
case "$DIST_BACKEND" in
  "") ;;
  gloo) DEVICE_FLAGS="$DEVICE_FLAGS --backend gloo" ;;
  *) echo "ERROR: DIST_BACKEND=$DIST_BACKEND (expected gloo, or empty)"; exit 1 ;;
esac

if [ -z "${SCALING_GEOMETRIES:-}" ]; then
  NCHIPS=$("$PY" -c "import torch; print(torch.cuda.device_count())" 2>/dev/null || echo 1)
  SCALING_GEOMETRIES="1"
  for ws in 2 4 8 16; do
    [ "$ws" -le "$NCHIPS" ] && SCALING_GEOMETRIES="$SCALING_GEOMETRIES $ws"
  done
fi
WS_MIN=""; WS_MAX=0
for ws in $SCALING_GEOMETRIES; do
  [ -z "$WS_MIN" ] && WS_MIN=$ws
  [ "$ws" -gt "$WS_MAX" ] && WS_MAX=$ws
done
CKPT_EVERY=$((STEPS / 4)); [ "$CKPT_EVERY" -lt 1 ] && CKPT_EVERY=1

echo "=== Scaling suite (PyTorch port) ==="
echo "strategies=[$SCALING_STRATEGIES] geometries=[$SCALING_GEOMETRIES]" \
     "mode=$SCALING_MODE tier=$TIER seq=$SEQ_LEN steps=$STEPS" \
     "device=${DEVICE:-cuda} backend=${DIST_BACKEND:-auto}"
echo "results=$RESULTS_DIR registry=$REGISTRY_DIR"
mkdir -p "$RESULTS_DIR"

FAIL=0

# Each stage's wall on the host clock, one "STAGE <name> wall <s>s" line.
stage_start() { STAGE_T0=$(date +%s%N); }
stage_end() {
  local ms=$(( ($(date +%s%N) - STAGE_T0) / 1000000 ))
  printf 'STAGE %s wall %d.%03ds\n' "$1" $((ms / 1000)) $((ms % 1000))
}

# point_batch <ws>: the per-device batch for one geometry. Weak scaling
# keeps it constant (global batch grows with the geometry); strong scaling
# pins the GLOBAL batch at the widest geometry's and shrinks per-device
# work as the geometry grows (skipping non-divisible points loudly).
point_batch() {
  local ws="$1"
  if [ "$SCALING_MODE" = "strong" ]; then
    local total=$((PER_DEVICE_BATCH * WS_MAX))
    if [ $((total % ws)) -ne 0 ]; then
      echo ""
    else
      echo $((total / ws))
    fi
  else
    echo "$PER_DEVICE_BATCH"
  fi
}

# run_point <strategy> <ws> <suffix> <ckpt_dir> <extra flags...>
run_point() {
  local strategy="$1" ws="$2" suffix="$3" ckpt_dir="$4"; shift 4
  local pdb; pdb=$(point_batch "$ws")
  if [ -z "$pdb" ]; then
    echo "--- scaling-$strategy-ws$ws$suffix SKIPPED (strong-mode global" \
         "batch $((PER_DEVICE_BATCH * WS_MAX)) not divisible by ws=$ws) ---"
    return 0
  fi
  local name="scaling-${strategy}-ws${ws}${suffix}"
  local log="$RESULTS_DIR/${name}.log"
  echo "--- $name ---"
  stage_start
  local prof_flags=""
  if [ "$PROFILE" = "1" ]; then
    rm -rf "$RESULTS_DIR/${name}_profile"
    prof_flags="--profile-dir $RESULTS_DIR/${name}_profile"
  fi
  local ranks=()
  [ "$ws" -gt 1 ] && ranks=("$PY" -u -m "$P.runtime.launch" --nproc "$ws" --)
  if timeout "$TIMEOUT_PER_RUN" "${ranks[@]}" "$PY" -u -m "$P.train.harness" \
      $DEVICE_FLAGS --strategy "$strategy" --world-size "$ws" \
      --tier "$TIER" --seq-len "$SEQ_LEN" --attention "$ATTENTION" \
      --steps "$STEPS" --warmup-steps "$WARMUP_STEPS" \
      --per-device-batch "$pdb" --grad-accum "$GRAD_ACCUM" \
      --sync-every "$SYNC_EVERY" --layer-loop "$LAYER_LOOP" \
      --results-dir "$RESULTS_DIR/${name}_results" \
      --checkpoint-dir "$ckpt_dir" --checkpoint-every "$CKPT_EVERY" \
      $prof_flags "$@" > "$log" 2>&1; then
    echo "OK"
  else
    echo "FAILED — last 20 log lines:"
    tail -20 "$log" || true
    scripts/collect_results.sh --log "$log" \
      "$RESULTS_DIR/${name}_results" || true
    FAIL=$((FAIL+1))
  fi
  stage_end "$name"
}

for strategy in $SCALING_STRATEGIES; do
  prev_ckpt=""
  for ws in $SCALING_GEOMETRIES; do
    ckpt="$RESULTS_DIR/scaling-${strategy}-ws${ws}_ckpt"
    rm -rf "$ckpt"
    run_point "$strategy" "$ws" "" "$ckpt"
    if [ -n "$prev_ckpt" ] && [ "$SKIP_STITCH" != "1" ]; then
      # Grow leg: continue the PREVIOUS geometry's training state at THIS
      # width (a reshard on restore). The source run's final save sits at
      # its last step, so the continuation gets CKPT_EVERY extra steps to
      # run; the scaling engine matches the stitched point back to the
      # clean curve modulo run length, flagged.
      run_point "$strategy" "$ws" "-stitch" "$prev_ckpt" --resume \
        --steps $((STEPS + CKPT_EVERY))
    fi
    prev_ckpt="$ckpt"
  done
  if [ "$SKIP_STITCH" != "1" ] && [ "$WS_MIN" != "$WS_MAX" ]; then
    # Shrink leg: the widest geometry's state back at the smallest width,
    # the preemption-recovery direction.
    run_point "$strategy" "$WS_MIN" "-shrink" "$prev_ckpt" --resume \
      --steps $((STEPS + CKPT_EVERY))
  fi
done

echo ""
echo "=== Efficiency stamp (clean rows only) ==="
stage_start
"$PY" -m "$P.analysis.scaling" --stamp-results-dir "$RESULTS_DIR" \
  || FAIL=$((FAIL+1))
stage_end stamp

echo ""
echo "=== Validation ==="
stage_start
"$PY" -m "$P.analysis.validate_results" \
  --results-dir "$RESULTS_DIR" --logs-dir "$RESULTS_DIR" \
  || { echo "VALIDATION FAILED"; FAIL=$((FAIL+1)); }
stage_end validate

echo ""
echo "=== Registry ingest + scaling curves (registry: $REGISTRY_DIR) ==="
stage_start
"$PY" -m "$P.regress" --registry "$REGISTRY_DIR" ingest \
  --results-dir "$RESULTS_DIR" \
  || { echo "REGISTRY INGEST FAILED"; FAIL=$((FAIL+1)); }
SUMMARY="$RESULTS_DIR/summary"
mkdir -p "$SUMMARY"
# The curves' picture needs matplotlib, which a card's host may not have.
PNG_FLAG="--png"
if ! "$PY" -c "import matplotlib" 2>/dev/null; then
  echo "NOTE: matplotlib is not installed; scaling_curves.png skipped"
  PNG_FLAG=""
fi
"$PY" -m "$P.analysis.scaling" --registry "$REGISTRY_DIR" \
  --out "$SUMMARY" $PNG_FLAG --json | tee "$SUMMARY/scaling_curves.txt" \
  || { echo "SCALING CURVES FAILED"; FAIL=$((FAIL+1)); }
stage_end registry

if [ "$SKIP_GATE" != "1" ]; then
  echo ""
  echo "=== Regression gate ==="
  stage_start
  "$PY" -m "$P.regress" --registry "$REGISTRY_DIR" gate --all \
    || { echo "REGRESSION GATE FAILED (SKIP_GATE=1 to override)"; \
         FAIL=$((FAIL+1)); }
  stage_end gate
fi

echo ""
echo "=== Report ==="
stage_start
"$PY" -m "$P.analysis.parse_metrics" \
  --results-dir "$RESULTS_DIR" --out "$SUMMARY" || FAIL=$((FAIL+1))
"$PY" -m "$P.analysis.make_report" \
  --csv "$SUMMARY/metrics.csv" --out "$SUMMARY" --plots-dir ../plots \
  --registry "$REGISTRY_DIR" || FAIL=$((FAIL+1))
stage_end report

echo ""
echo "=== Scaling suite complete: $FAIL failure(s) ==="
echo "curves: $SUMMARY/scaling_curves.txt (+ .json), report:" \
     "$SUMMARY/BENCHMARK_REPORT.md"
[ "$FAIL" -eq 0 ]
