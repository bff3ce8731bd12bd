#!/usr/bin/env bash
# Chaos suite of the PyTorch port: drive the fault-injection matrix end to
# end through the port's harness, supervisor, validator and registry, and
# assert that EVERY fault class lands in one of the honest outcomes:
#
#   - a completed, validated result after a resume: sigkill, sigterm,
#     torn-checkpoint, enospc-on-save (degrades, no resume needed), hang
#     (the in-process watchdog exits 76, then the arm resumes) and
#     data-stall (exit 78, then the resume continues at the exact cursor);
#   - a completed, validated result with no restart: bitflip, grad-explode
#     and opt-moments trip the numerics sentinel (checksum, loss envelope
#     and grad-norm guards; opt-moments corrupts the AdamW moments so the
#     next step's grad norm explodes while its loss stays finite), which
#     rolls back in process and replays: the row has n_rollbacks 1 and its
#     registry record is never a gate baseline; data-corrupt-record heals
#     by quarantine and substitution (records_skipped 1); data-slow-reader
#     degrades with a measured data_stall_frac;
#   - a correctly classified failure: nan-loss completes and the validator
#     rejects the row (an unresolved anomaly); data-missing-shard is
#     refused, naming the shard, before any step; stall-rank proves the
#     hang abort coherent across ranks (the stuck rank's watchdog publishes
#     the hang flag on the group's store and every rank exits 76);
#     sigterm-rank proves the preemption coherent (SIGTERM on rank 1 only,
#     every rank exits 75 at one step behind one emergency checkpoint).
#
# Faults fire at exact sync-window boundaries (faults/injection.py), so the
# suite is reproducible: same spec, same abort step, every run.
#
#   torch_chaos_suite.sh                 # full matrix on the tier-S smoke config
#   torch_chaos_suite.sh --smoke         # 4-fault smoke (sigkill + torn-checkpoint
#                                        #   + bitflip sentinel rollback +
#                                        #   data-corrupt-record stream heal)
#   torch_chaos_suite.sh --faults "sigterm hang" --results-dir /tmp/chaos
#   torch_chaos_suite.sh --elastic       # + geometry-change resumes (save at
#                                        #   dp4 -> resume at dp2, fsdp; save at
#                                        #   tp2 -> resume at tp1), validated
#   torch_chaos_suite.sh --supervisor    # + the supervisor's proofs (below)
#   torch_chaos_suite.sh --keep          # keep the artifacts of a passing run
#   torch_chaos_suite.sh --jobs 4        # run up to 4 arms at once (each arm
#                                        #   has its own directory; the output
#                                        #   is printed arm by arm at the end)
#
# --k8s-chaos (the coordinator-pod arm of scripts/chaos_suite.sh) is refused:
# the port has no GPU Job templates or container image yet (ROADMAP item 19).
#
# Where it runs: the one-rank arms run on the host CPU (--device cpu) by
# default, as the recovery logic is host-level; CHAOS_ON_DEVICE=1 runs them
# on the card instead (no --device flag: cuda, and no fallback when no card
# is visible). The multi-rank arms (sigterm-rank, stall-rank, elastic,
# elastic-tp, supervisor-shrink) always run as gloo processes on the host:
# NCCL puts no two ranks on one card, and a one-card host has one card.
# Their ranks start under `python -m <port>.runtime.launch --nproc N`,
# never torchrun, which exits 1 where its ranks exit 75.
#
# Env: PYTHON_BIN (default python) runs every Python step; CHAOS_WATCHDOG_SEC
# (5) is the hang watchdog's and the data-stall timeout's seconds in the hang,
# stall-rank and data-stall arms; CHAOS_HANG_TIMEOUT (60) and
# CHAOS_MH_TIMEOUT (180) are backstop timeouts that must never fire.
set -uo pipefail

cd "$(dirname "$0")/.."
REPO_ROOT="$(pwd)"
export PYTHONPATH="${REPO_ROOT}${PYTHONPATH:+:$PYTHONPATH}"
PY="${PYTHON_BIN:-python}"
export PYTHON_BIN="$PY"
P=distributed_llm_training_benchmark_framework_tpu_torch

FAULTS="sigkill sigterm sigterm-rank nan-loss hang stall-rank bitflip grad-explode opt-moments torn-checkpoint enospc-on-save data-corrupt-record data-stall data-slow-reader data-missing-shard"
ROOT=""
KEEP=0
JOBS=1
ELASTIC=0
SUPERVISOR=0
while [ $# -gt 0 ]; do
  case "$1" in
    --smoke) FAULTS="sigkill torn-checkpoint bitflip data-corrupt-record"; shift ;;
    --faults) FAULTS="$2"; shift 2 ;;
    --elastic) ELASTIC=1; shift ;;
    --k8s-chaos)
      echo "torch_chaos_suite: --k8s-chaos is not ported: the coordinator-pod arm needs" \
           "GPU Job templates and a container image for the port (ROADMAP item 19)" >&2
      exit 2 ;;
    --supervisor) SUPERVISOR=1; shift ;;
    --results-dir) ROOT="$2"; shift 2 ;;
    --keep) KEEP=1; shift ;;
    --jobs) JOBS="$2"; shift 2 ;;
    *) echo "torch_chaos_suite: unknown flag $1" >&2; exit 2 ;;
  esac
done
[ "$ELASTIC" = "1" ] && FAULTS="$FAULTS elastic elastic-tp"
# --supervisor (runtime/supervisor.py):
#   supervisor-shrink: a dp4 arm is preempted; the supervisor's device probe
#       (capped by the lose-host@2 chaos spec) sees 2 devices, so it resumes
#       the checkpoint at the largest divisor-legal geometry (dp2) through
#       the elastic path; supervision.json records the 4->2 leg and the
#       validator passes the recovered row.
#   supervisor-storm: the injected SIGTERM stays armed through attempt 2
#       (preempt-storm@2): the supervisor spends its budget attempt by
#       attempt and lands a validated result on the third, clean attempt.
#   supervisor-stream-bitflip: a sentinel-armed streaming run heals a
#       bitflip in process by rolling back and rewinding the stream cursor
#       to the checkpoint's sidecar (records_consumed == steps).
[ "$SUPERVISOR" = "1" ] && \
  FAULTS="$FAULTS supervisor-shrink supervisor-storm supervisor-stream-bitflip"
if [ -z "$ROOT" ]; then
  ROOT="$(mktemp -d "${TMPDIR:-/tmp}/torch_chaos_suite.XXXXXX")"
  MADE_ROOT=1
else
  mkdir -p "$ROOT"
  MADE_ROOT=0
fi

DEV=(--device cpu)
[ "${CHAOS_ON_DEVICE:-0}" = "1" ] && DEV=()

# The tier-S smoke config: small enough that the whole matrix takes minutes
# on a host CPU, checkpoint cadence dense enough that every recovery fault
# has a committed step behind it. Faults are pinned mid-timed-loop (warmup
# 2, inject at 8/9) so the recovery proof covers the measured region.
STEPS=14; WARMUP=2; CKPT_EVERY=4
# sync-every 2: windowed timing, as the real suite, so a tiny run's per-step
# jitter does not trip the validator's CV envelope.
COMMON=(--tier S --seq-len 32 --steps "$STEPS" --warmup-steps "$WARMUP"
        --per-device-batch 1 --grad-accum 1 --dataset-size 64 --heartbeat-sec 0
        --sync-every 2)
HARNESS=("$PY" -u -m "$P.train.harness" "${DEV[@]}" --strategy ddp --world-size 1
         "${COMMON[@]}")
LAUNCH=("$PY" -u -m "$P.runtime.launch")
# A multi-rank arm: gloo ranks on the host (see above).
MH_HARNESS=("$PY" -u -m "$P.train.harness" --device cpu "${COMMON[@]}")
ROW=result_ddp_ws1_seq32_tierS.json

# Streaming-data fixtures (data/stream.py): the data-fault arms read
# tokenized shards, written fresh per run by the port's writer (a few KB).
SHARDS="$ROOT/shards"
"$PY" -m "$P.data.make_shards" --out "$SHARDS" \
  --num-shards 4 --records-per-shard 64 --seq-len 32 --vocab-size 512 > /dev/null

# Each arm's outcome lines, appended by ok / fail (from any job) and
# counted at the end.
OUTCOMES="$ROOT/outcomes.txt"
: > "$OUTCOMES"
fail() { echo "CHAOS FAIL $1: $2" >&2; echo "FAIL $1: $2" >> "$OUTCOMES"; }
ok()   { echo "CHAOS OK   $1: $2"; echo "ok   $1: $2" >> "$OUTCOMES"; }

run_arm() {  # run_arm <dir> <log> [extra flags...]
  local dir="$1" log="$2"; shift 2
  "${HARNESS[@]}" --results-dir "$dir/results" \
    --checkpoint-dir "$dir/ckpt" --checkpoint-every "$CKPT_EVERY" \
    "$@" > "$log" 2>&1
}

validate() {  # validate <dir> -> validator exit code
  "$PY" -m "$P.analysis.validate_results" \
    --results-dir "$1/results" > "$1/validate.log" 2>&1
}

has_step_ckpt() { ls "$1" 2>/dev/null | grep -q '^[0-9]*$'; }

check_row() {  # check_row <row json> <python asserts over r> -> exit code
  "$PY" - "$1" "$2" <<'EOF'
import json, sys
r = json.load(open(sys.argv[1]))
exec(sys.argv[2])
EOF
}

check_recovered() {  # check_recovered <fault> <dir> [extra harness flags...]
  local fault="$1" dir="$2"; shift 2
  if ! run_arm "$dir" "$dir/resume.log" --resume "$@"; then
    fail "$fault" "resume attempt did not complete (see $dir/resume.log)"
    return 1
  fi
  local row="$dir/results/$ROW"
  if [ ! -f "$row" ]; then fail "$fault" "no result row after resume"; return 1; fi
  if ! check_row "$row" '
assert r["resumed"] is True, ("resumed", r["resumed"])
assert r["n_restarts"] >= 1, ("n_restarts", r["n_restarts"])
assert r["resume_step"] >= 0, ("resume_step", r["resume_step"])'
  then fail "$fault" "resumed row missing honest accounting"; return 1; fi
  if ! validate "$dir"; then
    fail "$fault" "validate_results rejected the resumed row (see $dir/validate.log)"
    return 1
  fi
  ok "$fault" "resumed from checkpoint; result validated with resumed=true"
}

gate_skips_rolled_back() {  # gate_skips_rolled_back <dir> -> exit code
  "$PY" -m "$P.regress" --registry "$1/registry" ingest --results-dir "$1/results" \
    > "$1/regress.log" 2>&1 \
    && "$PY" -m "$P.regress" --registry "$1/registry" gate --all >> "$1/regress.log" 2>&1 \
    && grep -q "rolled-back (sentinel-healed)" "$1/regress.log"
}

run_fault() {  # run_fault <fault>: one arm, its outcome through ok / fail
  local fault="$1" dir="$ROOT/$1" rc row rc0 rc1 steps tp_flags what
  mkdir -p "$dir"
  case "$fault" in
    sigkill)
      run_arm "$dir" "$dir/phase1.log" --inject-fault "sigkill@9"
      rc=$?
      if [ "$rc" -eq 0 ]; then fail "$fault" "run survived its own SIGKILL (rc=0)"; return; fi
      if ! has_step_ckpt "$dir/ckpt"; then
        fail "$fault" "no checkpoint committed before the kill"; return
      fi
      check_recovered "$fault" "$dir"
      ;;
    sigterm)
      run_arm "$dir" "$dir/phase1.log" --inject-fault "sigterm@9"
      rc=$?
      if [ "$rc" -ne 75 ]; then
        fail "$fault" "expected EXIT_PREEMPTED (75), got rc=$rc"; return
      fi
      if ! grep -aq '"event": "run_aborted".*"reason": "preempted"' \
           "$dir/results"/telemetry_*.jsonl; then
        fail "$fault" "no run_aborted reason=preempted telemetry event"; return
      fi
      if ! grep -a '^BENCHMARK_HEARTBEAT ' "$dir/phase1.log" | tail -1 \
           | grep -aq '"reason": "preempted"'; then
        fail "$fault" "final heartbeat does not carry reason=preempted"; return
      fi
      check_recovered "$fault" "$dir"
      ;;
    torn-checkpoint)
      run_arm "$dir" "$dir/phase1.log" --inject-fault "torn-checkpoint"
      rc=$?
      if [ "$rc" -eq 0 ]; then fail "$fault" "run survived its own SIGKILL (rc=0)"; return; fi
      check_recovered "$fault" "$dir" || return
      if [ ! -d "$dir/ckpt/quarantine" ]; then
        fail "$fault" "torn step was not quarantined"
      elif ! grep -q "Resumed from checkpoint" "$dir/resume.log"; then
        fail "$fault" "resume log does not show the fallback restore"
      fi
      ;;
    nan-loss)
      run_arm "$dir" "$dir/phase1.log" --inject-fault "nan-loss@8"
      rc=$?
      if [ "$rc" -ne 0 ]; then
        fail "$fault" "run should complete (anomaly-screened), got rc=$rc"; return
      fi
      if validate "$dir"; then
        fail "$fault" "validate_results ACCEPTED a NaN-loss run"; return
      fi
      if ! grep -q "unresolved anomaly" "$dir/validate.log"; then
        fail "$fault" "rejection does not name the unresolved anomaly"; return
      fi
      ok "$fault" "run completed; validator correctly rejected the row"
      ;;
    hang)
      # The in-process watchdog catches the stall; the external timeout is
      # only a backstop that must never fire (124/137 here means the
      # watchdog is broken).
      timeout -k 5 "${CHAOS_HANG_TIMEOUT:-60}" \
        "${HARNESS[@]}" --results-dir "$dir/results" \
        --checkpoint-dir "$dir/ckpt" --checkpoint-every "$CKPT_EVERY" \
        --hang-timeout-sec "${CHAOS_WATCHDOG_SEC:-5}" \
        --inject-fault "hang@6:600" > "$dir/phase1.log" 2>&1
      rc=$?
      if [ "$rc" -ne 76 ]; then
        fail "$fault" "expected the watchdog's EXIT_HUNG (76), got rc=$rc"; return
      fi
      if ! grep -aq '"event": "hang_dump"' "$dir/results"/telemetry_*.jsonl; then
        fail "$fault" "no hang_dump stack-dump telemetry event"; return
      fi
      if ! grep -aq '"event": "run_aborted".*"reason": "hang"' \
           "$dir/results"/telemetry_*.jsonl; then
        fail "$fault" "no run_aborted reason=hang telemetry event"; return
      fi
      if ! scripts/collect_results.sh --log "$dir/phase1.log" \
           "$dir/salvage" > "$dir/collect.log" 2>&1; then
        fail "$fault" "heartbeat salvage failed (see $dir/collect.log)"; return
      fi
      if ! grep -q '"reason": "hang"' "$dir/salvage"/partial_*.json; then
        fail "$fault" "salvaged partial row not classified reason=hang"; return
      fi
      check_recovered "$fault" "$dir"
      ;;
    bitflip|grad-explode|opt-moments)
      # The sentinel's heal: the fault poisons the state mid-run, a guard
      # trips, the loop rolls back to the last validated checkpoint and
      # replays; the run completes in process (rc 0, no restart).
      run_arm "$dir" "$dir/phase1.log" \
        --sentinel on --sentinel-checksum-every "$CKPT_EVERY" \
        --inject-fault "$fault@9"
      rc=$?
      if [ "$rc" -ne 0 ]; then
        fail "$fault" "sentinel should heal in-process (rc=0), got rc=$rc"; return
      fi
      row="$dir/results/$ROW"
      if [ ! -f "$row" ]; then fail "$fault" "no result row"; return; fi
      if ! check_row "$row" '
assert r["n_rollbacks"] == 1, ("n_rollbacks", r["n_rollbacks"])
assert r["rollback_steps_replayed"] >= 1, r["rollback_steps_replayed"]
assert r["resumed"] is False, "heal must not be a restart"'
      then fail "$fault" "healed row missing honest rollback accounting"; return; fi
      if ! grep -aq '"event": "sentinel_trip"' "$dir/results"/telemetry_*.jsonl \
         || ! grep -aq '"event": "rollback"' "$dir/results"/telemetry_*.jsonl; then
        fail "$fault" "telemetry missing sentinel_trip/rollback events"; return
      fi
      if [ "$fault" = "opt-moments" ] && ! grep -aq \
           '"event": "sentinel_trip", .*"kind": "grad_explode"' \
           "$dir/results"/telemetry_*.jsonl; then
        fail "$fault" "opt-moments must trip the GRAD-NORM guard first"; return
      fi
      if ! validate "$dir"; then
        fail "$fault" "validate_results rejected the healed row (see $dir/validate.log)"
        return
      fi
      # Never a baseline: ingest into a throwaway registry; the gate must
      # SKIP the rolled-back candidate.
      if ! gate_skips_rolled_back "$dir"; then
        fail "$fault" "gate did not SKIP the rolled-back record as never-baseline"
        return
      fi
      ok "$fault" "sentinel tripped, rolled back + replayed in-process; row validated, never a baseline"
      ;;
    stall-rank)
      # Rank 1 stalls; its watchdog dumps and publishes the hang flag on the
      # group's store, and every rank exits 76.
      timeout -k 5 "${CHAOS_MH_TIMEOUT:-180}" \
        "${LAUNCH[@]}" --nproc 2 -- "${MH_HARNESS[@]}" --strategy ddp --world-size 2 \
        --hang-timeout-sec "${CHAOS_WATCHDOG_SEC:-5}" \
        --results-dir "$dir/results" \
        --checkpoint-dir "$dir/ckpt" --checkpoint-every "$CKPT_EVERY" \
        --inject-fault "stall-rank@6:1:600" > "$dir/phase1.log" 2>&1
      rc=$?
      if [ "$rc" -ne 76 ]; then
        fail "$fault" "expected EXIT_HUNG (76) from the launcher, got rc=$rc"; return
      fi
      # Each rank's own exit line (rank 1's watchdog; rank 0's watchdog or
      # its peer-flag abort) and each rank's run_aborted reason=hang.
      if ! grep -aq "HANG WATCHDOG (rank 1)" "$dir/phase1.log" \
         || ! grep -aqE "HANG WATCHDOG \(rank 0\)|^HUNG: .*exiting 76" "$dir/phase1.log"; then
        fail "$fault" "not every rank took the hang exit (see $dir/phase1.log)"; return
      fi
      if ! grep -aq '"event": "run_aborted".*"reason": "hang"' \
           "$dir"/results/telemetry_*tierS.jsonl \
         || ! grep -aq '"event": "run_aborted".*"reason": "hang"' \
           "$dir"/results/telemetry_*.rank1.jsonl; then
        fail "$fault" "a rank's telemetry has no run_aborted reason=hang"; return
      fi
      if ! grep -aq '"event": "hang_dump"' "$dir"/results/telemetry_*tierS.jsonl; then
        fail "$fault" "rank 0 has no hang_dump stack-dump event"; return
      fi
      ok "$fault" "rank-1 stall aborted BOTH ranks coherently at 76 with stack dumps"
      ;;
    sigterm-rank)
      # SIGTERM lands on rank 1 only; rank 0 learns of it from the store's
      # preemption flag, both agree one step, save one emergency checkpoint
      # (collectively) and exit 75.
      timeout -k 5 "${CHAOS_MH_TIMEOUT:-180}" \
        "${LAUNCH[@]}" --nproc 2 -- "${MH_HARNESS[@]}" --strategy ddp --world-size 2 \
        --results-dir "$dir/results" \
        --checkpoint-dir "$dir/ckpt" --checkpoint-every "$CKPT_EVERY" \
        --inject-fault "sigterm-rank@9:1" > "$dir/phase1.log" 2>&1
      rc=$?
      if [ "$rc" -ne 75 ]; then
        fail "$fault" "expected EXIT_PREEMPTED (75) from the launcher, got rc=$rc"; return
      fi
      steps=$(grep -a '^PREEMPTED: ' "$dir/phase1.log" | sed -n 's/.*preempted at step \([0-9]*\).*/\1/p' | sort -u)
      if [ "$(grep -ac '^PREEMPTED: .*exiting 75' "$dir/phase1.log")" -ne 2 ] \
         || [ "$(echo "$steps" | wc -w)" -ne 1 ]; then
        fail "$fault" "expected both ranks to exit 75 at one step (see $dir/phase1.log)"; return
      fi
      if [ ! -d "$dir/ckpt/$steps" ] || [ ! -f "$dir/ckpt/digest_$steps.json" ]; then
        fail "$fault" "no emergency checkpoint of both ranks at step $steps"; return
      fi
      if ! grep -aq '"event": "run_aborted".*"reason": "preempted"' \
           "$dir"/results/telemetry_*tierS.jsonl; then
        fail "$fault" "rank 0 has no run_aborted reason=preempted trail"; return
      fi
      if ! grep -aq '"fault": "sigterm-rank@9:1"' "$dir"/results/telemetry_*.rank1.jsonl; then
        fail "$fault" "rank 1's telemetry rank file missing the fault trail"; return
      fi
      ok "$fault" "rank-1 SIGTERM stopped BOTH ranks at 75 with one emergency checkpoint"
      ;;
    elastic|elastic-tp)
      # Geometry-change resume: killed under dp4 (elastic) or dp2 x tp2
      # (elastic-tp), resumed under dp2 at tp1. fsdp, so the parameters are
      # really resharded; the row publishes resume_geometry_changed=true.
      tp_flags=(); what="dp4"
      [ "$fault" = "elastic-tp" ] && { tp_flags=(--tensor-parallel 2); what="tp2"; }
      timeout -k 5 "${CHAOS_MH_TIMEOUT:-180}" \
        "${LAUNCH[@]}" --nproc 4 -- "${MH_HARNESS[@]}" --strategy fsdp --world-size 4 \
        "${tp_flags[@]}" --results-dir "$dir/results" \
        --checkpoint-dir "$dir/ckpt" --checkpoint-every "$CKPT_EVERY" \
        --inject-fault "sigkill@9" > "$dir/phase1.log" 2>&1
      rc=$?
      if [ "$rc" -eq 0 ]; then fail "$fault" "run survived its own SIGKILL (rc=0)"; return; fi
      if ! has_step_ckpt "$dir/ckpt"; then
        fail "$fault" "no $what checkpoint committed before the kill"; return
      fi
      if ! timeout -k 5 "${CHAOS_MH_TIMEOUT:-180}" \
           "${LAUNCH[@]}" --nproc 2 -- "${MH_HARNESS[@]}" --strategy fsdp --world-size 2 \
           --results-dir "$dir/results" \
           --checkpoint-dir "$dir/ckpt" --checkpoint-every "$CKPT_EVERY" \
           --resume > "$dir/resume.log" 2>&1; then
        fail "$fault" "dp2 resume did not complete (see $dir/resume.log)"; return
      fi
      if ! grep -q "Elastic resume" "$dir/resume.log"; then
        fail "$fault" "resume log does not show the reshard restore"; return
      fi
      row="$dir/results/result_fsdp_ws2_seq32_tierS.json"
      if [ ! -f "$row" ]; then fail "$fault" "no dp2 result row after resume"; return; fi
      if ! check_row "$row" '
assert r["resumed"] is True, ("resumed", r["resumed"])
assert r["resume_geometry_changed"] is True, "stitch not recorded"
assert r["n_restarts"] >= 1, ("n_restarts", r["n_restarts"])
assert r["world_size"] == 2, ("world_size", r["world_size"])
assert r["tensor_parallel"] == 1, ("tensor_parallel", r["tensor_parallel"])'
      then fail "$fault" "resharded row missing honest accounting"; return; fi
      if ! validate "$dir"; then
        fail "$fault" "validate_results rejected the resharded resume (see $dir/validate.log)"
        return
      fi
      ok "$fault" "$what checkpoint resumed under dp2 tp1; resume_geometry_changed=true validated"
      ;;
    data-corrupt-record)
      # One record's payload bit-rots in flight; the CRC check quarantines
      # it, the slot heals by substitution, and the run completes with
      # records_skipped=1, which the validator cross-checks against the
      # data_corrupt_record telemetry event.
      run_arm "$dir" "$dir/phase1.log" --data-path "$SHARDS" \
        --inject-fault "data-corrupt-record@9"
      rc=$?
      if [ "$rc" -ne 0 ]; then
        fail "$fault" "corrupt record must heal in-stream (rc=0), got rc=$rc"; return
      fi
      row="$dir/results/$ROW"
      if [ ! -f "$row" ]; then fail "$fault" "no result row"; return; fi
      if ! check_row "$row" '
assert r["data_mode"] == "stream", r["data_mode"]
assert r["records_skipped"] == 1, ("records_skipped", r["records_skipped"])
assert r["records_consumed"] == r["steps"], "cursor arithmetic broke"'
      then fail "$fault" "healed row missing honest skip ledger"; return; fi
      if ! grep -aq '"event": "data_corrupt_record"' "$dir/results"/telemetry_*.jsonl; then
        fail "$fault" "telemetry missing the data_corrupt_record event"; return
      fi
      if ! validate "$dir"; then
        fail "$fault" "validate_results rejected the healed row (see $dir/validate.log)"
        return
      fi
      ok "$fault" "corrupt record quarantined + substituted; ledger validated"
      ;;
    data-stall)
      # The producer goes silent before step 9's batch: the loop classifies
      # reason=data_stall (exit 78, not the watchdog's hang), leaves an
      # emergency checkpoint and stream sidecar, and the resume consumes
      # exactly the records not yet consumed.
      timeout -k 5 "${CHAOS_HANG_TIMEOUT:-60}" \
        "${HARNESS[@]}" --results-dir "$dir/results" \
        --checkpoint-dir "$dir/ckpt" --checkpoint-every "$CKPT_EVERY" \
        --data-path "$SHARDS" --data-stall-timeout-sec "${CHAOS_WATCHDOG_SEC:-5}" \
        --inject-fault "data-stall@9:600" > "$dir/phase1.log" 2>&1
      rc=$?
      if [ "$rc" -ne 78 ]; then
        fail "$fault" "expected EXIT_DATA_STALL (78), got rc=$rc"; return
      fi
      if ! grep -aq '"event": "run_aborted".*"reason": "data_stall"' \
           "$dir/results"/telemetry_*.jsonl; then
        fail "$fault" "no run_aborted reason=data_stall telemetry event"; return
      fi
      if ! scripts/collect_results.sh --log "$dir/phase1.log" \
           "$dir/salvage" > "$dir/collect.log" 2>&1; then
        fail "$fault" "heartbeat salvage failed (see $dir/collect.log)"; return
      fi
      if ! grep -q '"reason": "data_stall"' "$dir/salvage"/partial_*.json; then
        fail "$fault" "salvaged partial row not classified reason=data_stall"; return
      fi
      check_recovered "$fault" "$dir" --data-path "$SHARDS" || return
      if ! check_row "$dir/results/$ROW" '
assert r["data_mode"] == "stream", r["data_mode"]
expected = r["resume_step"] + 1  # one record per step at this geometry
assert r["stream_cursor_start"] == expected, (r["stream_cursor_start"], expected)'
      then fail "$fault" "resumed stream did not return at the exact cursor"; fi
      ;;
    data-slow-reader)
      # Every record read from record 4 on takes +40 ms: the run completes
      # (degrades, never dies) with a measured, elevated data_stall_frac.
      # No checkpoints here: a tier-S step of the port takes 15-45 ms on a
      # host CPU, and the prefetcher (depth 2) refills during each save, so
      # saves every 4 steps would hide the slow reader from the timed steps.
      "${HARNESS[@]}" --results-dir "$dir/results" --data-path "$SHARDS" \
        --inject-fault "data-slow-reader@4:40" > "$dir/phase1.log" 2>&1
      rc=$?
      if [ "$rc" -ne 0 ]; then
        fail "$fault" "slow reader must degrade, not kill (rc=$rc)"; return
      fi
      row="$dir/results/$ROW"
      if [ ! -f "$row" ]; then fail "$fault" "no result row"; return; fi
      if ! check_row "$row" '
assert r["data_mode"] == "stream", r["data_mode"]
assert r["data_stall_frac"] is not None and r["data_stall_frac"] > 0.02, \
    ("data_stall_frac", r["data_stall_frac"], "the degradation is invisible")'
      then fail "$fault" "row does not carry the measured input-boundedness"; return; fi
      if ! validate "$dir"; then
        fail "$fault" "validate_results rejected the degraded row"; return
      fi
      ok "$fault" "reader degraded; run completed with measured data_stall_frac"
      ;;
    data-missing-shard)
      # A hole in the corpus: the stream refuses, naming the shard, before
      # any step.
      run_arm "$dir" "$dir/phase1.log" --data-path "$SHARDS" \
        --inject-fault "data-missing-shard@2"
      rc=$?
      if [ "$rc" -eq 0 ]; then
        fail "$fault" "run trained on a truncated corpus (rc=0)"; return
      fi
      if ! grep -q "missing shard 2" "$dir/phase1.log"; then
        fail "$fault" "refusal does not name the missing shard"; return
      fi
      if ls "$dir/results"/result_*.json >/dev/null 2>&1; then
        fail "$fault" "a result row was published despite the refusal"; return
      fi
      ok "$fault" "incomplete shard set refused loudly, naming shard 2"
      ;;
    enospc-on-save)
      run_arm "$dir" "$dir/phase1.log" --inject-fault "enospc-on-save"
      rc=$?
      if [ "$rc" -ne 0 ]; then
        fail "$fault" "save failures must degrade, not kill (rc=$rc)"; return
      fi
      if ! grep -q "checkpoint save at step .* failed" "$dir/phase1.log"; then
        fail "$fault" "no save-degraded warning in the log"; return
      fi
      if ! validate "$dir"; then
        fail "$fault" "validate_results rejected the degraded-save run"; return
      fi
      ok "$fault" "saves degraded with warnings; run completed and validated"
      ;;
    supervisor-shrink)
      # Preempt a dp4 arm, cap the device probe at 2 from attempt 2
      # (lose-host@2): the supervisor resumes the checkpoint at dp2 through
      # the elastic path, over the launcher's 2 ranks.
      cat > "$dir/policy.json" <<'EOF'
{"schema_version": 1, "backoff_base_sec": 0, "backoff_max_sec": 0,
 "jitter_frac": 0,
 "classes": {"preempted": {"action": "resume-shrunk", "max_attempts": 3},
             "hung": {"action": "resume", "max_attempts": 2},
             "data_stall": {"action": "resume", "max_attempts": 2},
             "crash": {"action": "cold-retry", "max_attempts": 1},
             "nothing-to-resume": {"action": "give-up", "max_attempts": 0}}}
EOF
      env RECOVERY_POLICY="$dir/policy.json" timeout -k 5 "${CHAOS_MH_TIMEOUT:-180}" \
        scripts/torch_with_retries.sh --resume-flag --resume \
        --drop-on-retry --inject-fault --chaos "lose-host@2" -- \
        "${LAUNCH[@]}" --nproc 4 -- "${MH_HARNESS[@]}" --strategy fsdp --world-size 4 \
        --results-dir "$dir/results" \
        --checkpoint-dir "$dir/ckpt" --checkpoint-every "$CKPT_EVERY" \
        --inject-fault "sigterm@9" > "$dir/phase1.log" 2>&1
      rc=$?
      if [ "$rc" -ne 0 ]; then
        fail "$fault" "supervised arm did not recover (rc=$rc, see $dir/phase1.log)"
        return
      fi
      if [ ! -f "$dir/results/supervision.json" ]; then
        fail "$fault" "supervisor left no supervision.json ledger"; return
      fi
      row="$dir/results/result_fsdp_ws2_seq32_tierS.json"
      if [ ! -f "$row" ]; then
        fail "$fault" "no dp2 result row after the shrink-resume"; return
      fi
      if ! "$PY" - "$dir/results/supervision.json" "$row" <<'EOF'
import json, sys
led = json.load(open(sys.argv[1]))
r = json.load(open(sys.argv[2]))
assert led["shrink_legs"] == ["4->2"], f"shrink_legs={led['shrink_legs']}"
assert led["n_attempts"] == 2, f"n_attempts={led['n_attempts']}"
assert led["attempts"][0]["class"] == "preempted", led["attempts"][0]
assert led["attempts"][0]["action"] == "resume-shrunk", led["attempts"][0]
assert led["final_class"] == "ok" and not led["gave_up"], led
assert r["world_size"] == 2, f"world_size={r['world_size']}"
assert r["resumed"] is True and r["resume_geometry_changed"] is True, r
assert r["supervision"]["n_attempts"] == 2, r.get("supervision")
assert r["supervision"]["shrink_legs"] == ["4->2"], r.get("supervision")
EOF
      then fail "$fault" "ledger/row recovery accounting incoherent"; return; fi
      if ! validate "$dir"; then
        fail "$fault" "validate_results rejected the shrink-resumed row (see $dir/validate.log)"
        return
      fi
      ok "$fault" "preempt -> probe saw 2 devices -> dp4 checkpoint resumed at dp2; ledger + row validated"
      ;;
    supervisor-storm)
      # preempt-storm@2 keeps the injected SIGTERM armed through attempt 2:
      # 75 -> resume -> 75 -> resume -> a validated result.
      cat > "$dir/policy.json" <<'EOF'
{"schema_version": 1, "backoff_base_sec": 0, "backoff_max_sec": 0,
 "jitter_frac": 0,
 "classes": {"preempted": {"action": "resume", "max_attempts": 3},
             "nothing-to-resume": {"action": "give-up", "max_attempts": 0}}}
EOF
      env RECOVERY_POLICY="$dir/policy.json" \
        scripts/torch_with_retries.sh --resume-flag --resume \
        --drop-on-retry --inject-fault --chaos "preempt-storm@2" -- \
        "${HARNESS[@]}" --results-dir "$dir/results" \
        --checkpoint-dir "$dir/ckpt" --checkpoint-every "$CKPT_EVERY" \
        --inject-fault "sigterm@9" > "$dir/phase1.log" 2>&1
      rc=$?
      if [ "$rc" -ne 0 ]; then
        fail "$fault" "storm did not drain to a clean attempt (rc=$rc)"; return
      fi
      if ! "$PY" - "$dir/results/supervision.json" <<'EOF'
import json, sys
led = json.load(open(sys.argv[1]))
classes = [a["class"] for a in led["attempts"]]
assert classes == ["preempted", "preempted", "ok"], classes
# fault_kept rides the entry of the attempt whose failure planned the next
# (still faulted) command: attempt 1 plans the storm's attempt 2.
assert led["attempts"][0].get("fault_kept") is True, led["attempts"][0]
assert led["attempts"][1].get("fault_kept") is None, led["attempts"][1]
assert led["n_attempts"] == 3 and not led["gave_up"], led
assert led["shrink_legs"] == [], led["shrink_legs"]
EOF
      then fail "$fault" "storm ledger does not show 75 -> 75 -> ok"; return; fi
      if ! validate "$dir"; then
        fail "$fault" "validate_results rejected the storm-recovered row"; return
      fi
      ok "$fault" "fault stayed armed 2 attempts; budgeted resumes drained the storm to a validated row"
      ;;
    supervisor-stream-bitflip)
      # A sentinel-armed streaming run takes a bitflip, rolls back in
      # process and rewinds the stream cursor to the checkpoint's sidecar:
      # the same records replay, none lost or duplicated.
      run_arm "$dir" "$dir/phase1.log" --data-path "$SHARDS" \
        --sentinel on --sentinel-checksum-every "$CKPT_EVERY" \
        --inject-fault "bitflip@9"
      rc=$?
      if [ "$rc" -ne 0 ]; then
        fail "$fault" "sentinel should heal the streaming run in-process (rc=$rc)"
        return
      fi
      if ! grep -q "stream rewound to cursor" "$dir/phase1.log"; then
        fail "$fault" "rollback did not rewind the stream cursor"; return
      fi
      row="$dir/results/$ROW"
      if [ ! -f "$row" ]; then fail "$fault" "no result row"; return; fi
      if ! check_row "$row" '
assert r["data_mode"] == "stream", r["data_mode"]
assert r["n_rollbacks"] == 1, ("n_rollbacks", r["n_rollbacks"])
assert r["rollback_steps_replayed"] >= 1, r["rollback_steps_replayed"]
assert r["resumed"] is False, "heal must not be a restart"
assert r["records_consumed"] == r["steps"], (r["records_consumed"], r["steps"])
assert r["records_skipped"] == 0, ("records_skipped", r["records_skipped"])'
      then fail "$fault" "healed streaming row's cursor ledger broke"; return; fi
      if ! grep -aq '"event": "sentinel_trip"' "$dir/results"/telemetry_*.jsonl \
         || ! grep -aq '"event": "rollback"' "$dir/results"/telemetry_*.jsonl; then
        fail "$fault" "telemetry missing sentinel_trip/rollback events"; return
      fi
      if ! validate "$dir"; then
        fail "$fault" "validate_results rejected the healed streaming row (see $dir/validate.log)"
        return
      fi
      ok "$fault" "bitflip on stream healed in-process; cursor rewound exactly, no loss/duplication"
      ;;
    k8s-coordinator)
      fail "$fault" "not ported: needs GPU Job templates and a container image (ROADMAP item 19)"
      ;;
    *)
      fail "$fault" "unknown fault class"
      ;;
  esac
}

if [ "$JOBS" -le 1 ]; then
  for fault in $FAULTS; do
    echo "=== chaos: $fault ==="
    run_fault "$fault"
  done
else
  # Up to JOBS arms at once (each in its own directory and processes; the
  # multi-rank arms' launchers take free ports of their own), each arm's
  # output printed in order once all have ended.
  for fault in $FAULTS; do
    while [ "$(jobs -rp | wc -l)" -ge "$JOBS" ]; do wait -n; done
    mkdir -p "$ROOT/$fault"
    run_fault "$fault" > "$ROOT/$fault/console.log" 2>&1 &
  done
  wait
  for fault in $FAULTS; do
    echo "=== chaos: $fault ==="
    cat "$ROOT/$fault/console.log"
  done
fi

PASS=0; FAIL=0
declare -a SUMMARY
for fault in $FAULTS; do
  while IFS= read -r line; do
    case "$line" in
      "ok   $fault: "*) PASS=$((PASS+1)); SUMMARY+=("$line") ;;
      "FAIL $fault: "*) FAIL=$((FAIL+1)); SUMMARY+=("$line") ;;
    esac
  done < "$OUTCOMES"
done
echo ""
echo "=== chaos suite: $PASS ok, $FAIL failed ==="
for line in "${SUMMARY[@]}"; do echo "  $line"; done
if [ "$KEEP" = "0" ] && [ "$FAIL" -eq 0 ] && [ "$MADE_ROOT" = "1" ]; then
  rm -rf "$ROOT"
else
  echo "artifacts: $ROOT"
fi
[ "$FAIL" -eq 0 ]
