#!/usr/bin/env bash
# Full benchmark suite of the PyTorch port, local mode: the strategy x world
# size matrix (plus the composition roster) -> results -> analysis ->
# validation -> the regression gate, the counterpart of
# scripts/run_all_benchmarks.sh over the port's package.
#
# Stages, in order (each knob below):
#   1. preflight: scripts/torch_graftcheck.sh (SKIP_PREFLIGHT=1 skips);
#   2. chaos smoke: scripts/torch_chaos_suite.sh --smoke --elastic
#      --supervisor --jobs 4 (CHAOS_JOBS) in a throwaway directory
#      (SKIP_CHAOS=1 skips);
#   3. the arms: each under scripts/torch_with_retries.sh (the supervisor;
#      retries resume from the arm's checkpoint), a ws > 1 arm as ws ranks
#      under `python -m <port>.runtime.launch --nproc ws`, then
#      scripts/collect_results.sh;
#   4. analysis: parse_metrics -> plot (where matplotlib is installed) ->
#      step anatomy -> make_report -> validate_results;
#   5. the registry: ingest and gate (SKIP_REGRESS=1 skips);
#   6. REMAT_SWEEP=1: `python -m <port>.bench --remat-sweep` and the report
#      refreshed with its frontier;
#   7. SCALING_SUITE=1: the scaling suite's CPU smoke,
#      scripts/torch_scaling_suite.sh --dryrun, in a throwaway directory
#      with its own registry (SKIP_SCALING=1 skips).
#
# Where it runs: on the card by default, one card per rank; the world sizes
# are 1 and each of 2, 4, 8 that torch.cuda.device_count() holds. DEVICE=cpu
# (the port's one addition) passes --device cpu to every arm: the ranks run
# as gloo processes on the host, and WORLD_SIZES must be given.
#
#   DEVICE=cpu WORLD_SIZES="1 2" TIER=S SEQ_LEN=32 STEPS=6 WARMUP_STEPS=1 \
#     STRATEGIES="ddp zero2" SKIP_CHAOS=1 scripts/torch_run_all_benchmarks.sh
#
# Not ported (ROADMAP item 19): --k8s (GPU Job templates and a container
# image for the port), refused with a message.
set -euo pipefail

cd "$(dirname "$0")/.."
REPO_ROOT="$(pwd)"
export PYTHONPATH="${REPO_ROOT}${PYTHONPATH:+:$PYTHONPATH}"
PY="${PYTHON_BIN:-python}"
P=distributed_llm_training_benchmark_framework_tpu_torch

MODE="local"
RESULTS_DIR="${RESULTS_DIR:-$REPO_ROOT/results/torch}"
TIER="${TIER:-A}"
SEQ_LEN="${SEQ_LEN:-2048}"
STEPS="${STEPS:-100}"
WARMUP_STEPS="${WARMUP_STEPS:-5}"
PER_DEVICE_BATCH="${PER_DEVICE_BATCH:-1}"
GRAD_ACCUM="${GRAD_ACCUM:-4}"
# Fence (block on the loss) every N steps, as the bench times.
SYNC_EVERY="${SYNC_EVERY:-10}"
# 'unrolled' (a module per layer, the suite's default, as JAX's suite's) or
# 'scan' (the block leaves stacked, the harness's default loop): scan runs
# every arm, the composition arms over 'pipe' and 'expert' included.
LAYER_LOOP="${LAYER_LOOP:-unrolled}"
STRATEGIES="${STRATEGIES:-ddp fsdp zero2 zero3}"
# 'reference' (the plain attention) or 'flash' (the hand-written kernels
# K1-K3 on the card); run names carry a -flash suffix, so both can share one
# RESULTS_DIR.
ATTENTION="${ATTENTION:-reference}"
WORLD_SIZES="${WORLD_SIZES:-}"
# cuda (empty, the default) or cpu.
DEVICE="${DEVICE:-}"
TIMEOUT_PER_RUN="${TIMEOUT_PER_RUN:-1800}"
# Extra harness flags appended to every arm (e.g. "--param-dtype bf16");
# run names get a slug of them (or RUN_SUFFIX) so they never overwrite the
# plain arms' results.
EXTRA_ARGS="${EXTRA_ARGS:-}"
RUN_SUFFIX="${RUN_SUFFIX:-}"
if [ -n "$EXTRA_ARGS" ] && [ -z "$RUN_SUFFIX" ]; then
  RUN_SUFFIX=$(echo "$EXTRA_ARGS" | tr -cs 'a-zA-Z0-9' '-' | sed 's/^-*//; s/-*$//')
fi
# Composition roster: when the widest world size holds a second axis (>= 4),
# one arm per extended axis at that world size (JAX's roster, arm for arm).
# COMPOSITIONS=off disables; =only skips the pure-strategy matrix.
COMPOSITIONS="${COMPOSITIONS:-auto}"
# SUITE_DRY_RUN=1: print the planned runs ("PLAN local <name> strategy=<s>
# ws=<n> flags=<...>") and execute nothing.
SUITE_DRY_RUN="${SUITE_DRY_RUN:-0}"
SKIP_PREFLIGHT="${SKIP_PREFLIGHT:-0}"
SKIP_REGRESS="${SKIP_REGRESS:-0}"
SKIP_CHAOS="${SKIP_CHAOS:-0}"
# Retries resume from the arm's checkpoint dir; ARM_CHECKPOINT_EVERY 'auto'
# = STEPS/4, 0 = no checkpoints (retries are cold).
MAX_ARM_RETRIES="${MAX_ARM_RETRIES:-1}"
RETRY_BACKOFF_SEC="${RETRY_BACKOFF_SEC:-5}"
export MAX_ARM_RETRIES RETRY_BACKOFF_SEC
ARM_CHECKPOINT_EVERY="${ARM_CHECKPOINT_EVERY:-auto}"
# PROFILE=1: every arm traces with --profile-dir ($RESULTS_DIR/<name>_profile)
# and the report gets the step-anatomy table.
PROFILE="${PROFILE:-0}"
# REMAT_SWEEP=1: after the matrix, the bench's --remat-sweep (the flagship
# configuration once per remat policy at the suite's TIER / SEQ_LEN and run
# length), one registry record per policy, and the report's frontier.
REMAT_SWEEP="${REMAT_SWEEP:-0}"
SCALING_SUITE="${SCALING_SUITE:-0}"
SKIP_SCALING="${SKIP_SCALING:-0}"

while [ $# -gt 0 ]; do
  case "$1" in
    --k8s)
      echo "ERROR: --k8s is not ported: the port has no GPU Job templates or container" \
           "image yet (ROADMAP item 19)"; exit 1 ;;
    --attention) ATTENTION="$2"; shift 2 ;;
    --tier) TIER="$2"; shift 2 ;;
    --seq-len) SEQ_LEN="$2"; shift 2 ;;
    --steps) STEPS="$2"; shift 2 ;;
    --results-dir) RESULTS_DIR="$2"; shift 2 ;;
    *) echo "unknown flag $1"; exit 1 ;;
  esac
done

if [ "$LAYER_LOOP" != "unrolled" ] && [ "$LAYER_LOOP" != "scan" ]; then
  echo "ERROR: LAYER_LOOP=$LAYER_LOOP: expected 'unrolled' or 'scan'"; exit 1
fi
DEVICE_FLAGS=""
case "$DEVICE" in
  "" | cuda) ;;
  cpu) DEVICE_FLAGS="--device cpu" ;;
  *) echo "ERROR: DEVICE=$DEVICE (expected cuda or cpu)"; exit 1 ;;
esac

REGISTRY_DIR="${REGISTRY_DIR:-$RESULTS_DIR/registry}"

mkdir -p "$RESULTS_DIR"

if [ -z "$WORLD_SIZES" ]; then
  if [ "$DEVICE" = "cpu" ]; then
    echo "ERROR: DEVICE=cpu needs WORLD_SIZES (the gloo ranks to run, e.g. \"1 2\")"; exit 1
  fi
  NCHIPS=$("$PY" -c "import torch; print(torch.cuda.device_count())" 2>/dev/null || echo 1)
  WORLD_SIZES="1"
  for ws in 2 4 8; do [ "$ws" -le "$NCHIPS" ] && WORLD_SIZES="$WORLD_SIZES $ws"; done
fi

echo "=== PyTorch port Benchmark Suite ==="
echo "mode=$MODE device=${DEVICE:-cuda} strategies=[$STRATEGIES] world_sizes=[$WORLD_SIZES] attention=$ATTENTION"
echo "tier=$TIER seq=$SEQ_LEN steps=$STEPS batch=$PER_DEVICE_BATCH accum=$GRAD_ACCUM"
echo ""

# Each stage's wall on the host clock, one "STAGE <name> wall <s>s" line.
stage_start() { STAGE_T0=$(date +%s%N); }
stage_end() {
  local ms=$(( ($(date +%s%N) - STAGE_T0) / 1000000 ))
  printf 'STAGE %s wall %d.%03ds\n' "$1" $((ms / 1000)) $((ms % 1000))
}

if [ "$SUITE_DRY_RUN" != "1" ] && [ "$SKIP_PREFLIGHT" != "1" ]; then
  echo "=== Preflight: graftcheck static analysis ==="
  stage_start
  scripts/torch_graftcheck.sh \
    || { echo "PREFLIGHT FAILED — no arms launched (SKIP_PREFLIGHT=1 to" \
              "override)"; exit 1; }
  stage_end preflight
  echo ""
fi

if [ "$SUITE_DRY_RUN" != "1" ] && [ "$SKIP_CHAOS" != "1" ]; then
  echo "=== Chaos smoke: recovery proof (sigkill + torn-checkpoint + bitflip-heal + corrupt-record stream heal + elastic + supervisor) ==="
  stage_start
  CHAOS_DIR=$(mktemp -d "${TMPDIR:-/tmp}/torch_chaos_smoke.XXXXXX")
  if scripts/torch_chaos_suite.sh --smoke --elastic --supervisor \
       --jobs "${CHAOS_JOBS:-4}" --results-dir "$CHAOS_DIR"; then
    rm -rf "$CHAOS_DIR"
  else
    echo "CHAOS SMOKE FAILED — the recovery machinery is broken, so a" \
         "preempted arm would be a total loss; not launching" \
         "(SKIP_CHAOS=1 to override). Artifacts: $CHAOS_DIR"
    exit 1
  fi
  stage_end chaos
  echo ""
fi

PASS=0; FAIL=0
SUITE_START=$(date +%s)

if [ "$ARM_CHECKPOINT_EVERY" = "auto" ]; then
  ARM_CHECKPOINT_EVERY=$((STEPS / 4))
  [ "$ARM_CHECKPOINT_EVERY" -lt 1 ] && ARM_CHECKPOINT_EVERY=1
fi

run_local() {
  local strategy="$1" ws="$2" extra="${3-$EXTRA_ARGS}" suffix="${4-$RUN_SUFFIX}"
  local name="bench-${strategy}-ws${ws}-seq${SEQ_LEN}"
  [ "$ATTENTION" != "reference" ] && name="${name}-${ATTENTION}"
  [ -n "$suffix" ] && name="${name}-${suffix}"
  local log="$RESULTS_DIR/${name}.log"
  if [ "$SUITE_DRY_RUN" = "1" ]; then
    echo "PLAN local $name strategy=$strategy ws=$ws flags=$extra"
    PASS=$((PASS+1)); return
  fi
  echo "--- $name ---"
  local t0=$(date +%s)
  local prof_flags=""
  if [ "$PROFILE" = "1" ]; then
    rm -rf "$RESULTS_DIR/${name}_profile"
    prof_flags="--profile-dir $RESULTS_DIR/${name}_profile"
  fi
  local ckpt_flags=""
  if [ "$ARM_CHECKPOINT_EVERY" != "0" ]; then
    # A fresh dir per invocation: the checkpoints only back this run's
    # retry-resume.
    rm -rf "$RESULTS_DIR/${name}_ckpt"
    ckpt_flags="--checkpoint-dir $RESULTS_DIR/${name}_ckpt"
    ckpt_flags="$ckpt_flags --checkpoint-every $ARM_CHECKPOINT_EVERY"
  fi
  # One process per rank: ws > 1 runs under the launcher, whose exit code
  # is the ranks' (the supervisor classifies it).
  local ranks=()
  [ "$ws" -gt 1 ] && ranks=("$PY" -u -m "$P.runtime.launch" --nproc "$ws" --)
  # Retries resume from the checkpoint and drop any injected fault, so a
  # deterministic fault cannot fire again on its own recovery attempt.
  if scripts/torch_with_retries.sh \
      ${ckpt_flags:+--resume-flag --resume} --drop-on-retry --inject-fault -- \
      timeout "$TIMEOUT_PER_RUN" "${ranks[@]}" "$PY" -u -m "$P.train.harness" \
      $DEVICE_FLAGS --strategy "$strategy" --world-size "$ws" \
      --tier "$TIER" --seq-len "$SEQ_LEN" --attention "$ATTENTION" \
      --steps "$STEPS" --warmup-steps "$WARMUP_STEPS" \
      --per-device-batch "$PER_DEVICE_BATCH" --grad-accum "$GRAD_ACCUM" \
      --sync-every "$SYNC_EVERY" --layer-loop "$LAYER_LOOP" \
      --results-dir "$RESULTS_DIR/${name}_results" \
      $extra $ckpt_flags $prof_flags \
      > "$log" 2>&1; then
    scripts/collect_results.sh --log "$log" "$RESULTS_DIR/${name}_results" \
      || true
    echo "OK ($(( $(date +%s) - t0 ))s)"
    PASS=$((PASS+1))
  else
    echo "FAILED — last 20 log lines:"
    tail -20 "$log" || true
    # Salvage the heartbeats as a partial row, so the failed arm shows in
    # the report instead of vanishing.
    scripts/collect_results.sh --log "$log" "$RESULTS_DIR/${name}_results" \
      || true
    FAIL=$((FAIL+1))
  fi
}

[ "$SUITE_DRY_RUN" != "1" ] && stage_start
if [ "$COMPOSITIONS" != "only" ]; then
  for strategy in $STRATEGIES; do
    for ws in $WORLD_SIZES; do
      run_local "$strategy" "$ws"
    done
  done
fi

# --- composition roster (see COMPOSITIONS above) ---
WS_MAX=0
for ws in $WORLD_SIZES; do [ "$ws" -gt "$WS_MAX" ] && WS_MAX=$ws; done
if [ "$COMPOSITIONS" != "off" ] && [ "$WS_MAX" -ge 4 ]; then
  # Interleaved needs n_layer % (pp * V) == 0: tier S has 2 layers -> V=1.
  VIRT=2; [ "$TIER" = "S" ] && VIRT=1
  # name|strategy|harness flags
  ROSTER="
tp2|ddp|--tensor-parallel 2
pp2-gpipe|ddp|--pipeline-parallel 2 --pipeline-schedule gpipe
pp2-1f1b|ddp|--pipeline-parallel 2 --pipeline-schedule 1f1b
pp2-interleaved|ddp|--pipeline-parallel 2 --pipeline-schedule interleaved --virtual-stages $VIRT
sp2-ring|zero2|--sequence-parallel 2 --attention ring
sp2-ring-causal|zero2|--sequence-parallel 2 --attention ring --causal
sp2-ring-causal-nozz|zero2|--sequence-parallel 2 --attention ring --causal --ring-zigzag off
sp2-ulysses|zero2|--sequence-parallel 2 --attention ulysses
moe-ep2|zero2|--num-experts 4 --expert-parallel 2
moe8-ep2|zero2|--num-experts 8 --expert-parallel 2
llama-tp2|fsdp|--model-family llama --tensor-parallel 2
llama-tp2-ddp|ddp|--model-family llama --tensor-parallel 2
llama-tp2-cmm|ddp|--model-family llama --tensor-parallel 2 --tp-collective-matmul
llama-flagship|zero2|--model-family llama --per-device-batch 2 --grad-accum 2 --layer-loop unrolled --attention flash
"
  echo ""
  echo "=== Composition arms (ws=$WS_MAX) ==="
  while IFS='|' read -r cname cstrat cflags; do
    [ -z "$cname" ] && continue
    run_local "$cstrat" "$WS_MAX" "$cflags $EXTRA_ARGS" "$cname${RUN_SUFFIX:+-$RUN_SUFFIX}"
  done <<EOF
$ROSTER
EOF
fi

if [ "$SUITE_DRY_RUN" = "1" ]; then
  echo ""
  echo "=== Dry run: $PASS runs planned, nothing executed ==="
  exit 0
fi
stage_end arms

echo ""
echo "=== Analysis ==="
stage_start
SUMMARY="$RESULTS_DIR/summary"
"$PY" -m "$P.analysis.parse_metrics" --results-dir "$RESULTS_DIR" --out "$SUMMARY"
# The plots need matplotlib, which a card's host may not have: the report
# renders without them.
if "$PY" -c "import matplotlib" 2>/dev/null; then
  "$PY" -m "$P.analysis.plot" --results "$SUMMARY/metrics.csv" --out "$RESULTS_DIR/plots"
else
  echo "NOTE: matplotlib is not installed; plots skipped"
fi

# Step anatomy of every arm that left a profile dir (PROFILE=1), into
# $SUMMARY/step_anatomy.txt and the report; an unreadable trace warns.
ANATOMY_TXT="$SUMMARY/step_anatomy.txt"
mkdir -p "$SUMMARY"
rm -f "$ANATOMY_TXT"
for prof in "$RESULTS_DIR"/*_profile; do
  [ -d "$prof" ] || continue
  base="${prof%_profile}"
  tfile=$(ls "${base}_results"/telemetry_*.jsonl 2>/dev/null | head -1 || true)
  "$PY" -m "$P.analysis.step_anatomy" \
    --profile-dir "$prof" ${tfile:+--telemetry "$tfile"} \
    >> "$ANATOMY_TXT" 2>/dev/null \
    && { echo "" >> "$ANATOMY_TXT"; } \
    || echo "WARNING: step-anatomy failed for $prof" >&2
done
if [ -s "$ANATOMY_TXT" ]; then
  echo "--- step anatomy ($(grep -c '^== Step anatomy' "$ANATOMY_TXT")" \
       "profiled arm(s)) -> $ANATOMY_TXT ---"
  STEP_ANATOMY_FLAG="--step-anatomy $ANATOMY_TXT"
else
  rm -f "$ANATOMY_TXT"
  STEP_ANATOMY_FLAG=""
fi

"$PY" -m "$P.analysis.make_report" \
  --csv "$SUMMARY/metrics.csv" --out "$SUMMARY" --plots-dir ../plots \
  $STEP_ANATOMY_FLAG

echo ""
echo "=== Validation (sanity envelopes) ==="
"$PY" -m "$P.analysis.validate_results" \
  --results-dir "$RESULTS_DIR" --logs-dir "$RESULTS_DIR" \
  || { echo "VALIDATION FAILED"; FAIL=$((FAIL+1)); }
stage_end analysis

if [ "$SKIP_REGRESS" != "1" ]; then
  echo ""
  echo "=== Regression gate (registry: $REGISTRY_DIR) ==="
  stage_start
  # Ingest (full rows as ok, heartbeat partials as partial), then gate each
  # arm's latest against its last known good (a first run gates clean).
  "$PY" -m "$P.regress" --registry "$REGISTRY_DIR" ingest --results-dir "$RESULTS_DIR" \
    || { echo "REGISTRY INGEST FAILED"; FAIL=$((FAIL+1)); }
  "$PY" -m "$P.regress" --registry "$REGISTRY_DIR" gate --all \
    || { echo "REGRESSION GATE FAILED (SKIP_REGRESS=1 to override)"; \
         FAIL=$((FAIL+1)); }
  # The report again, with the per-arm trend section from the registry.
  "$PY" -m "$P.analysis.make_report" \
    --csv "$SUMMARY/metrics.csv" --out "$SUMMARY" --plots-dir ../plots \
    --registry "$REGISTRY_DIR" $STEP_ANATOMY_FLAG || true
  stage_end regress
fi

if [ "$REMAT_SWEEP" = "1" ]; then
  echo ""
  echo "=== Remat/HBM frontier sweep (registry: $REGISTRY_DIR) ==="
  stage_start
  # --flagship off: the sweep's 'none' point is the flagship configuration.
  if "$PY" -m "$P.bench" --remat-sweep --flagship off --skip-preflight \
       $DEVICE_FLAGS --tier "$TIER" --seq-len "$SEQ_LEN" \
       --steps "$STEPS" --warmup-steps "$WARMUP_STEPS" \
       --sync-every "$SYNC_EVERY" \
       --regress on --registry "$REGISTRY_DIR" \
       > "$RESULTS_DIR/remat_sweep.json" 2> "$RESULTS_DIR/remat_sweep.log"
  then
    "$PY" -m "$P.analysis.make_report" \
      --csv "$SUMMARY/metrics.csv" --out "$SUMMARY" --plots-dir ../plots \
      --registry "$REGISTRY_DIR" $STEP_ANATOMY_FLAG || true
    echo "frontier records + report refreshed ($RESULTS_DIR/remat_sweep.json)"
  else
    echo "REMAT SWEEP FAILED — last 20 log lines:"
    tail -20 "$RESULTS_DIR/remat_sweep.log" || true
    FAIL=$((FAIL+1))
  fi
  stage_end remat_sweep
fi

if [ "$SCALING_SUITE" = "1" ] && [ "$SKIP_SCALING" != "1" ]; then
  echo ""
  echo "=== Scaling smoke (scripts/torch_scaling_suite.sh --dryrun) ==="
  stage_start
  SCALING_DIR=$(mktemp -d "${TMPDIR:-/tmp}/torch_scaling_smoke.XXXXXX")
  # --registry pinned inside the temporary directory: an exported
  # REGISTRY_DIR must not take the smoke's tiny CPU points for good.
  if scripts/torch_scaling_suite.sh --dryrun --results-dir "$SCALING_DIR" \
       --registry "$SCALING_DIR/registry"; then
    rm -rf "$SCALING_DIR"
  else
    echo "SCALING SMOKE FAILED (SKIP_SCALING=1 to override)." \
         "Artifacts: $SCALING_DIR"
    FAIL=$((FAIL+1))
  fi
  stage_end scaling
fi

echo ""
echo "=== Suite complete: $PASS passed, $FAIL failed, $(( $(date +%s) - SUITE_START ))s total ==="
[ "$FAIL" -eq 0 ]
