#!/usr/bin/env python
"""Executable result-sanity checks (the validation envelopes, enforced).

Port of ``distributed_llm_training_benchmark_framework_tpu/analysis/validate_results.py``:
every envelope and message is JAX's; the device capacity comes from the
port's ``utils/memory.device_hbm_bytes`` (H100: 80 GB), and the MFU floors
stay JAX's published-row floors, which apply only to TPU v5e rows.

The reference *documents* expected-result bands for operators to eyeball
(reference ``results/example_output/README.md:120-146``: loss range, <10%
step-time variance, plausible VRAM); this repo's
``results/example_output/README.md`` documents the TPU equivalents. This
module turns those prose envelopes into a suite step that fails loudly:

- **schema**: every ``result*.json`` carries the reference-contract keys with
  sane values (tokens_per_sec > 0, step time > 0);
- **markers**: every captured run log contains exactly one
  ``BENCHMARK_RESULT_JSON_START``/``_END`` pair whose payload parses — the
  contract the kubectl-logs collector scrapes (reference
  ``scripts/collect_results.sh:50-59``);
- **loss band**: mean_loss below the ~ln(V) random-init ceiling and above a
  degenerate floor — training happened and did not diverge/NaN;
- **step-time variance**: coefficient of variation < 10% over the timed
  steps (reference envelope "<10% variance"), checked only where
  ``sync_every == 1`` makes per-step times individually meaningful;
- **memory**: measured peak (when the platform reports one) and the
  analytic estimate agree within a stated tolerance, and neither exceeds
  the device's HBM capacity;
- **MFU floors** (round 5): published single-chip tier-A rows must not
  silently regress — per-seq-len floors a few points under the measured
  table (docs/PERFORMANCE.md §9/§12), applied only to the published-arm
  geometry (tier A, ws=1, v5e, dense, no offload) so experimental configs
  aren't blocked;
- **offload CV allowance**: ZeRO-Offload rows run the optimizer on the
  host CPU, whose load jitter legitimately exceeds the 10% device
  envelope (PERFORMANCE.md §13) — they get their own, looser CV limit
  instead of silently skipping the check.

Exit code 0 = all envelopes hold; 1 = any violation (listed on stdout).
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
from typing import List, Optional, Tuple

MARKER_START = "BENCHMARK_RESULT_JSON_START"
MARKER_END = "BENCHMARK_RESULT_JSON_END"

# mean_loss over the first ~100 steps must land inside (FLOOR, ln(V) + SLACK).
# A mean below FLOOR at benchmark step counts means the loss collapsed (data
# leak / targets bug); above the ceiling means it never trained or diverged.
LOSS_FLOOR = 0.05
LOSS_CEIL_SLACK = 0.5
STEP_CV_LIMIT_PCT = 10.0
# utils/memory.py's documented accuracy claim for the analytic model,
# validated here against the measured column whenever one exists. The band
# is asymmetric: an UNDERestimate is the dangerous direction (the
# pre-flight would wave through a config that OOMs), so it keeps the tight
# band; an OVERestimate is conservative (refuses early, never OOMs) and
# gets a wider one — at long sequences with full remat, XLA's scheduling
# lets the fp32 logits cotangent alias the logits buffer, landing the
# measured peak one logits-size below the model (32K row: est 15.9 GB vs
# measured 11.3 GB).
EST_VS_MEASURED_TOL = 0.35          # measured > est (underestimate)
EST_VS_MEASURED_TOL_OVER = 0.60     # est > measured (conservative)
# ...with an absolute-slack floor: at tiny footprints (tier-S smoke runs,
# heavily-sharded per-device peaks) the analytic model's ignored constants
# (runtime buffers, padding) dominate, so a pure relative band would flag
# noise. A violation requires BOTH the relative band and this many GB of
# absolute divergence. Tier-S smoke artifacts skip the check entirely.
EST_VS_MEASURED_ABS_SLACK_GB = 0.25
# Published-row MFU floors (% of v5e peak), a few points under the measured
# single-chip tier-A table so real regressions trip while run-to-run noise
# (±1.5% observed) does not: 2K 38.2%, 4K 33.6%, 8K 28.8%, 16K 24.6%
# measured (docs/PERFORMANCE.md §9/§12).
MFU_FLOORS_TIER_A = {2048: 36.0, 4096: 31.0, 8192: 26.0, 16384: 22.0,
                     32768: 15.5}
# The published MoE row (tier A base + E=8 top-2, bf16 params, measured
# 29.0% — MoE MFU counts only the top-k active experts' FLOPs).
MFU_FLOOR_MOE8 = 26.0
# The published causal 2K row (measured 34.2% against the causal FLOP
# count — attention work halves under the mask, so the denominator is not
# the bidirectional rows').
MFU_FLOOR_CAUSAL_2K = 31.0
# The published Llama-family rows (models.llama tier A: head_dim 128,
# GQA, SwiGLU, no dropout; measured 2K 45.2%, 8K 54.4%, 16K 42.0% — the
# wide-head shape clears the D=64 score-tile wall documented in
# PERFORMANCE.md §15/§16, and at long sequences holds ~2x the TinyGPT
# rows' MFU because the attention fraction grows on the family's more
# MXU-efficient kernel shape).
MFU_FLOORS_LLAMA = {2048: 42.0, 8192: 50.0, 16384: 38.0}
# Routing-health envelope for MoE rows: the capacity discipline drops SOME
# assignments (cf 1.25 < top-k worst case), but beyond this bound routing
# has collapsed onto a few experts (or capacity accounting broke).
EXPERT_OVERFLOW_MAX_PCT = 60.0
# Host-CPU AdamW step-time jitter under host load (PERFORMANCE.md §13
# documents p50 varying 3.6-6.2 s run-to-run; within-run CV stays well
# under this).
OFFLOAD_STEP_CV_LIMIT_PCT = 25.0
# Loss-descent envelope: rows long enough to have visibly trained
# (>= this many steps) must show loss_last_window <= loss_first_window -
# delta(family, steps). The mean-loss band alone cannot catch a FROZEN run
# (a flat line at 6.0 has a healthy-looking mean); this one does. Deltas
# are conservative fractions of the measured 100-step descents (tinygpt
# tier A descends ~5 nats in 100 steps; the llama family's measured slow
# trajectory still descends ~0.49 — see docs/PERFORMANCE.md §16), scaled
# linearly below 100 steps. Rows without the window keys (pre-round-6
# artifacts) skip the check.
LOSS_DESCENT_MIN_STEPS = 50
LOSS_DESCENT_DELTA = {"tinygpt": 0.25, "llama": 0.15}
# Resume-continuity envelope (chaos round, docs/FAULT_TOLERANCE.md): a
# resumed row records the loss its checkpoint was saved at
# (resume_baseline_loss); the post-resume first window must land near it.
# A cold restart POSING as a resume starts back at the ~ln(V) random-init
# ceiling — several nats above any mid-training checkpoint — so a modest
# absolute slack separates the two cleanly while tolerating the genuine
# wobble of an optimizer restart.
RESUME_LOSS_CONT_SLACK = 1.5
# Flight-recorder phase-attribution envelope (round 8): the recorder's
# phases are sequential and disjoint by construction, so the published
# time_in_* fields must be non-negative and their sum must not exceed the
# run's wall time (2% relative + 50 ms absolute slack for clock rounding).
# Rows from before the telemetry round carry no wall_time_total_sec and
# skip the check.
PHASE_TIME_FIELDS = (
    "time_in_init_sec", "time_in_compile_sec", "time_in_warmup_sec",
    "time_in_timed_sec", "time_in_checkpoint_sec", "time_in_trace_sec",
)
PHASE_SUM_REL_TOL = 1.02
PHASE_SUM_ABS_SLACK_SEC = 0.05
# Step-anatomy envelope (analysis/step_anatomy.py): the trace-derived
# fractions are each in [0, 1], and the three ADDITIVE step components
# (compute + exposed comms + idle) sum to the step — never beyond it
# (small slack for interval-arithmetic rounding). Roofline positions are
# percentages of a hardware peak: a value past ~110% means the cost or
# peak accounting broke, not that the chip beat its spec. Rows without
# the fields (no --profile-dir, pre-anatomy artifacts) skip the check.
ANATOMY_FRAC_FIELDS = (
    "anatomy_compute_frac", "comms_exposed_frac", "comms_overlap_frac",
    "anatomy_idle_frac", "bubble_frac",
)
ANATOMY_COMPONENT_SUM_TOL = 1.02
ROOFLINE_PCT_MAX = 110.0
# Streaming-data-path coherence envelope (data/stream.py, streaming
# round): rows with data_mode == "stream" must carry an internally
# coherent input ledger — data_stall_frac in [0, 1] (the waits happen
# inside the published step times, so the fraction is structural),
# cursor_end - cursor_start == records_consumed == steps_run x
# records/step (stream-position continuity: no replayed or skipped
# records across a stitch; the per-step record count is closed-form from
# the row's own batch geometry), and a same-geometry resume must start
# exactly where the restored checkpoint's sidecar left off. A
# geometry-change resume changes records/step, so only the within-run
# arithmetic is checkable there. records_skipped is additionally
# cross-checked against the telemetry quarantine events in
# validate_telemetry.
# Memory-anatomy envelope (analysis/memory_anatomy.py): rows carrying the
# reconciliation must be internally coherent — the persisted estimate and
# the measured column must COEXIST (hbm_measured may be null only with an
# explicit reason), every attribution class except the signed residual is
# non-negative, and the classes must close the books on the reference
# peak (that is the reconciliation's defining invariant; a gap means the
# engine and the stored row drifted). Rows without the fields
# (pre-memory-anatomy artifacts) skip every check.
HBM_BOOKS_CLOSE_TOL_GIB = 0.002


def _check(ok: bool, label: str, detail: str, failures: List[str]) -> None:
    if not ok:
        failures.append(f"{label}: {detail}")


def validate_result(r: dict, name: str) -> List[str]:
    """Envelope-check one result dict; returns a list of violations."""
    f: List[str] = []
    for key in (
        "strategy", "world_size", "seq_len", "tokens_per_sec",
        "mean_step_time_sec", "mean_loss", "peak_vram_gb", "h2d_gbps_per_gpu",
    ):
        _check(key in r, name, f"missing reference-schema key {key!r}", f)
    if f:
        return f

    _check(r["tokens_per_sec"] > 0, name,
           f"tokens_per_sec={r['tokens_per_sec']} (must be > 0)", f)
    _check(r["mean_step_time_sec"] > 0, name,
           f"mean_step_time_sec={r['mean_step_time_sec']} (must be > 0)", f)

    loss = r["mean_loss"]
    # Reference tiers A/B share the 32000 vocab; tier S (CPU smoke) is 512 —
    # its random-init ceiling is ~4.6 nats lower (tinygpt.get_model_config).
    vocab = 512 if r.get("tier") == "S" else 32000
    ceil = math.log(vocab) + LOSS_CEIL_SLACK
    _check(
        LOSS_FLOOR < loss < ceil, name,
        f"mean_loss={loss:.4f} outside ({LOSS_FLOOR}, ln({vocab})+"
        f"{LOSS_CEIL_SLACK}={ceil:.2f}) — not training or diverged", f,
    )
    _check(loss == loss, name, "mean_loss is NaN", f)

    # Descent envelope (see LOSS_DESCENT_DELTA): a non-training run must not
    # pass validation on a plausible mean alone. Resumed rows are exempt —
    # a run restored from a well-trained checkpoint legitimately starts
    # near its converged loss, with no from-scratch descent left to show.
    first_w = r.get("loss_first_window", 0.0) or 0.0
    last_w = r.get("loss_last_window", 0.0) or 0.0
    if (
        r.get("steps", 0) >= LOSS_DESCENT_MIN_STEPS
        and first_w > 0
        and last_w > 0
        and not r.get("resumed")
    ):
        fam = r.get("model_family", "tinygpt")
        base = LOSS_DESCENT_DELTA.get(fam, min(LOSS_DESCENT_DELTA.values()))
        delta = base * min(r["steps"], 100) / 100.0
        _check(
            last_w <= first_w - delta, name,
            f"loss_last_window={last_w:.4f} not below loss_first_window="
            f"{first_w:.4f} - {delta:.3f} ({fam} descent envelope at "
            f"{r['steps']} steps) — the run did not train", f,
        )

    # Resumed (stitched) rows: the first timed window after a restore
    # folds in the recompile (the loop's timed-first-step shape), so the
    # CV envelope is not a device-stability signal there. The stitch is
    # policed by its own continuity check below — and resumed rows are
    # never regression baselines anyway (regress.store).
    if (
        r.get("sync_every", 1) == 1 and r.get("step_time_cv_pct", 0) > 0
        and not r.get("resumed")
    ):
        cv = r["step_time_cv_pct"]
        cv_limit = (
            OFFLOAD_STEP_CV_LIMIT_PCT if r.get("offload_opt_state")
            else STEP_CV_LIMIT_PCT
        )
        _check(
            cv < cv_limit, name,
            f"step-time cv {cv:.1f}% >= {cv_limit}% envelope"
            + (" (offload allowance)" if r.get("offload_opt_state") else ""), f,
        )

    # Stitched-run honesty (chaos round): a row claiming resumed=true must
    # carry a coherent restart ledger, and its post-resume loss must be
    # CONTINUOUS with the checkpoint it claims to extend — a cold restart
    # mislabeled as a resume restarts at the random-init ceiling and is
    # rejected here.
    if r.get("resumed"):
        if "n_restarts" in r:
            _check(
                int(r.get("n_restarts") or 0) >= 1, name,
                f"resumed=true but n_restarts={r.get('n_restarts')} "
                "(the restart ledger must count at least the one resume)", f,
            )
        baseline = r.get("resume_baseline_loss", 0.0) or 0.0
        if baseline > 0 and first_w > 0:
            _check(
                first_w <= baseline + RESUME_LOSS_CONT_SLACK, name,
                f"loss_first_window={first_w:.4f} is discontinuous with "
                f"resume_baseline_loss={baseline:.4f} (+{RESUME_LOSS_CONT_SLACK} "
                "slack) — the run did not actually continue from its "
                "checkpoint", f,
            )
    elif int(r.get("n_restarts") or 0) > 0:
        f.append(
            f"{name}: n_restarts={r.get('n_restarts')} on a row with "
            "resumed=false — restart accounting is incoherent"
        )

    # Sentinel-rollback coherence (self-healing round, docs/
    # FAULT_TOLERANCE.md): a healed row's ledger must hang together —
    # every rollback replays at least the step its trip poisoned (the
    # checkpoint-save guard makes restore_step < trip_step structural),
    # and replayed steps without a rollback mean the accounting broke.
    n_rb = int(r.get("n_rollbacks") or 0)
    n_replayed = int(r.get("rollback_steps_replayed") or 0)
    if n_rb > 0:
        _check(
            n_replayed >= n_rb, name,
            f"n_rollbacks={n_rb} but rollback_steps_replayed={n_replayed} "
            "— every rollback replays at least one step; the sentinel "
            "ledger is incoherent", f,
        )
    elif n_replayed > 0:
        f.append(
            f"{name}: rollback_steps_replayed={n_replayed} on a row with "
            "n_rollbacks=0 — replayed steps without a rollback; the "
            "sentinel ledger is incoherent"
        )

    # Elastic-resume coherence: a geometry-changed stitch IS a resume —
    # the flag without resumed=true means the accounting (and therefore
    # the never-baseline exclusion downstream) is broken.
    if r.get("resume_geometry_changed") and not r.get("resumed"):
        f.append(
            f"{name}: resume_geometry_changed=true on a row with "
            "resumed=false — a resharded restore is a resume; the "
            "stitch accounting is incoherent"
        )

    # Supervision-stamp coherence (elastic fleet supervisor, runtime/
    # supervisor.py): the stamp exists only on RECOVERED rows, so
    # n_attempts must say so, and a recorded shrink leg means the final
    # attempt restored a checkpoint on a different geometry — the row
    # must carry the elastic-resume accounting too.
    sup = r.get("supervision")
    if sup is not None:
        n_att = int(sup.get("n_attempts") or 0)
        _check(
            n_att > 1, name,
            f"supervision stamp with n_attempts={n_att} — the supervisor "
            "stamps only recovered rows (attempt > 1); the recovery "
            "ledger is incoherent", f,
        )
        if sup.get("shrink_legs") and not r.get("resume_geometry_changed"):
            f.append(
                f"{name}: supervision.shrink_legs={sup.get('shrink_legs')} "
                "but resume_geometry_changed=false — a shrink leg IS a "
                "resharded resume; the recovery accounting is incoherent"
            )

    # MFU floors for the published-arm geometry only: tier A, single chip,
    # v5e, flash attention, dense model, device-resident optimizer, and
    # windowed timing (sync_every > 1 — the per-step block_until_ready
    # diagnostic runs legitimately sit ~11 points lower). Any other
    # geometry is exploratory and gets no floor.
    # Shared base: the published-arm geometry minus the causal/offload
    # axes (each floor below adds its own) — one predicate to update when
    # e.g. a v6 device kind joins the published set.
    family_geometry = (
        r.get("tier") == "A"
        and r.get("world_size") == 1
        and "v5" in str(r.get("device_kind", ""))
        and r.get("attention_impl") == "flash"
        and r.get("sync_every", 1) > 1
        and not r.get("offload_opt_state")
        and r.get("mfu_pct", 0) > 0
    )
    base_geometry = (
        family_geometry and r.get("model_family", "tinygpt") == "tinygpt"
    )
    llama_floor = MFU_FLOORS_LLAMA.get(r.get("seq_len"))
    if (
        family_geometry
        and r.get("model_family") == "llama"
        and llama_floor is not None
        and r.get("n_experts", 0) == 0
    ):
        _check(
            r["mfu_pct"] >= llama_floor, name,
            f"mfu_pct={r['mfu_pct']:.1f}% below the {llama_floor}% "
            "llama-family floor (published-row regression)", f,
        )
    published_geometry = base_geometry and not r.get("causal")
    floor = MFU_FLOORS_TIER_A.get(r.get("seq_len"))
    if floor is not None and published_geometry and r.get("n_experts", 0) == 0:
        _check(
            r["mfu_pct"] >= floor, name,
            f"mfu_pct={r['mfu_pct']:.1f}% below the {floor}% floor for "
            f"seq_len={r['seq_len']} (published-row regression)", f,
        )
    if (
        published_geometry
        and r.get("n_experts", 0) == 8
        and r.get("seq_len") == 2048
    ):
        _check(
            r["mfu_pct"] >= MFU_FLOOR_MOE8, name,
            f"mfu_pct={r['mfu_pct']:.1f}% below the {MFU_FLOOR_MOE8}% MoE "
            "floor (published-row regression)", f,
        )
    if (
        base_geometry
        and r.get("causal")
        and r.get("n_experts", 0) == 0
        and r.get("seq_len") == 2048
    ):
        _check(
            r["mfu_pct"] >= MFU_FLOOR_CAUSAL_2K, name,
            f"mfu_pct={r['mfu_pct']:.1f}% below the {MFU_FLOOR_CAUSAL_2K}% "
            "causal floor (published-row regression)", f,
        )
    ov = r.get("expert_overflow_pct")
    if ov is not None:
        _check(
            0.0 <= ov <= EXPERT_OVERFLOW_MAX_PCT, name,
            f"expert_overflow_pct={ov} outside [0, "
            f"{EXPERT_OVERFLOW_MAX_PCT}] — routing collapsed or capacity "
            "accounting broke", f,
        )

    est = r.get("est_hbm_gb", 0.0)
    measured = r.get("peak_hbm_gb", 0.0)
    method = r.get("peak_hbm_method", "unavailable")
    if (
        est > 0
        and measured > 0
        and r.get("tier") != "S"
        and method in ("allocator", "xla_buffer_assignment")
    ):
        rel = abs(measured - est) / measured
        tol = EST_VS_MEASURED_TOL_OVER if est > measured else EST_VS_MEASURED_TOL
        _check(
            rel <= tol
            or abs(measured - est) <= EST_VS_MEASURED_ABS_SLACK_GB, name,
            f"analytic est {est:.2f} GB vs measured {measured:.2f} GB "
            f"({method}) differ by {100*rel:.0f}% > "
            f"{100*tol:.0f}% tolerance", f,
        )
    cap = _hbm_capacity_gb(r.get("device_kind", ""))
    if cap is not None:
        for label, val in (("measured peak", measured), ("estimate", est)):
            _check(
                val <= cap, name,
                f"{label} {val:.2f} GB exceeds {cap:.1f} GB {r['device_kind']} HBM", f,
            )

    # Phase-time attribution envelope (PHASE_TIME_FIELDS above).
    wall = r.get("wall_time_total_sec", 0.0) or 0.0
    if wall > 0:
        phase_sum = 0.0
        for key in PHASE_TIME_FIELDS:
            val = r.get(key, 0.0) or 0.0
            _check(val >= 0, name, f"{key}={val} is negative", f)
            phase_sum += max(val, 0.0)
        _check(
            phase_sum <= wall * PHASE_SUM_REL_TOL + PHASE_SUM_ABS_SLACK_SEC,
            name,
            f"phase times sum to {phase_sum:.3f}s > wall_time_total_sec="
            f"{wall:.3f}s — phases must be disjoint", f,
        )
        _check(
            r.get("n_anomalies", 0) >= 0, name,
            f"n_anomalies={r.get('n_anomalies')} is negative", f,
        )

    # Step-anatomy envelope (ANATOMY_FRAC_FIELDS above).
    def _finite(key):
        v = r.get(key)
        return v if isinstance(v, (int, float)) and v == v else None

    for key in ANATOMY_FRAC_FIELDS:
        v = _finite(key)
        if v is not None:
            _check(
                -1e-6 <= v <= 1.0 + 1e-6, name,
                f"{key}={v} outside [0, 1] — the trace decomposition "
                "broke", f,
            )
    components = [_finite(k) for k in (
        "anatomy_compute_frac", "comms_exposed_frac", "anatomy_idle_frac",
    )]
    if all(v is not None for v in components):
        total = sum(components)
        _check(
            total <= ANATOMY_COMPONENT_SUM_TOL, name,
            f"step-anatomy components sum to {total:.4f} > 1 — compute + "
            "exposed comms + idle must not exceed the step time", f,
        )
    for key in ("roofline_flops_pct_of_peak", "roofline_hbm_pct_of_peak"):
        v = _finite(key)
        if v is not None:
            _check(
                0.0 <= v <= ROOFLINE_PCT_MAX, name,
                f"{key}={v} outside [0, {ROOFLINE_PCT_MAX}] — achieved "
                "past peak means the cost or peak table broke", f,
            )
    skew = _finite("straggler_skew_pct")
    if skew is not None:
        _check(skew >= 0.0, name,
               f"straggler_skew_pct={skew} is negative", f)

    # Streaming-data-path coherence envelope (see the constants note).
    if r.get("data_mode") == "stream":
        dsf = r.get("data_stall_frac")
        _check(
            isinstance(dsf, (int, float)) and dsf == dsf
            and -1e-9 <= dsf <= 1.0 + 1e-9, name,
            f"data_stall_frac={dsf} missing or outside [0, 1] on a "
            "stream row — the starvation accounting broke", f,
        )
        skipped = r.get("records_skipped")
        _check(
            isinstance(skipped, int) and skipped >= 0, name,
            f"records_skipped={skipped} must be a non-negative count", f,
        )
        consumed = int(r.get("records_consumed") or 0)
        cs = int(r.get("stream_cursor_start", -1))
        ce = int(r.get("stream_cursor_end", -1))
        _check(
            cs >= 0 and ce >= cs, name,
            f"stream cursors [{cs}, {ce}] incoherent on a stream row", f,
        )
        if cs >= 0 and ce >= cs:
            _check(
                ce - cs == consumed, name,
                f"stream_cursor_end - stream_cursor_start = {ce - cs} but "
                f"records_consumed={consumed} — the stream ledger is "
                "incoherent", f,
            )
            denom = max(
                int(r.get("tensor_parallel") or 1)
                * int(r.get("sequence_parallel") or 1)
                * int(r.get("pipeline_parallel") or 1)
                * int(r.get("expert_parallel") or 1), 1,
            )
            dp = max(int(r["world_size"]) // denom, 1)
            rps = (
                int(r["per_device_batch"]) * int(r["grad_accum"]) * dp
                * int(r.get("expert_parallel") or 1)
            )
            # NOT `or -1`: resume_step=0 is a legitimate restore (a run
            # stalled/preempted at step 1 checkpoints step 0) and must
            # not collapse to the falsy default.
            rs = r.get("resume_step")
            start = (int(rs) + 1
                     if r.get("resumed") and rs is not None else 0)
            expected = (int(r.get("steps") or 0) - start) * rps
            _check(
                consumed == expected, name,
                f"records_consumed={consumed} != (steps-{start}) x "
                f"{rps} records/step = {expected} — records were "
                "replayed or skipped across the run", f,
            )
            if (
                r.get("resumed")
                and not r.get("resume_geometry_changed")
                and int(r.get("n_restarts") or 0) == 1
            ):
                # Cross-run cursor continuity is closed-form only when
                # the WHOLE checkpoint lineage ran this geometry: on the
                # first resume, a same-geometry stitch means the prior
                # run was a cold start with this records/step. A later
                # restart (n_restarts > 1) may sit downstream of an
                # earlier geometry-change resume whose era consumed a
                # different records/step — there the sidecar cursor is
                # authoritative and only the within-run arithmetic above
                # is checkable.
                _check(
                    cs == start * rps, name,
                    f"stream_cursor_start={cs} but a same-geometry "
                    f"first resume from step {start - 1} must start at "
                    f"{start * rps} — the stitch replayed or skipped "
                    "records", f,
                )
            elif not r.get("resumed"):
                _check(
                    cs == 0, name,
                    f"stream_cursor_start={cs} on a non-resumed stream "
                    "row (must be 0)", f,
                )
    else:
        # Synthetic rows must stay inert: a stall fraction or skip count
        # on the zero-IO table means the accounting leaked across paths.
        if r.get("data_stall_frac") is not None:
            f.append(
                f"{name}: data_stall_frac={r['data_stall_frac']} on a "
                "non-stream row — the input accounting leaked"
            )
        if int(r.get("records_skipped") or 0) > 0:
            f.append(
                f"{name}: records_skipped={r['records_skipped']} on a "
                "non-stream row — the quarantine accounting leaked"
            )

    # Memory-anatomy envelope (HBM_BOOKS_CLOSE_TOL_GIB above).
    attr = r.get("hbm_attribution")
    if isinstance(attr, dict):
        _check(
            isinstance(r.get("hbm_estimate"), dict)
            and r["hbm_estimate"].get("total_gib") is not None, name,
            "hbm_attribution present without the hbm_estimate breakdown "
            "— the estimate and measurement must coexist so drift is "
            "computable offline", f,
        )
        _check(
            "hbm_measured" in r, name,
            "hbm_attribution present without an hbm_measured key (null "
            "is legal, absence is not)", f,
        )
        if r.get("hbm_measured") is None:
            _check(
                bool(r.get("hbm_measured_reason")), name,
                "hbm_measured is null without an hbm_measured_reason — "
                "an unmeasured peak must say why", f,
            )
        else:
            _check(
                r.get("hbm_model_drift_frac") is not None, name,
                "hbm_measured present but hbm_model_drift_frac is null "
                "— a measured peak beside an estimate must yield a "
                "drift", f,
            )
        for cls, val in attr.items():
            if cls == "unattributed":
                continue  # the signed book-closing residual
            _check(
                isinstance(val, (int, float)) and val >= 0, name,
                f"hbm_attribution[{cls}]={val} is negative — only the "
                "unattributed residual may be signed", f,
            )
        ref = r.get("hbm_reference_gib")
        if isinstance(ref, (int, float)):
            total = sum(
                v for v in attr.values() if isinstance(v, (int, float))
            )
            _check(
                abs(total - ref) <= HBM_BOOKS_CLOSE_TOL_GIB
                + 0.0005 * len(attr), name,
                f"hbm_attribution classes sum to {total:.4f} GiB but "
                f"hbm_reference_gib={ref:.4f} — the reconciliation must "
                "close the books exactly", f,
            )
        drift = _finite("hbm_model_drift_frac")
        if drift is not None:
            _check(drift >= 0.0, name,
                   f"hbm_model_drift_frac={drift} is negative", f)
    return f


def validate_telemetry(result_path: str, r: dict, name: str) -> List[str]:
    """Cross-check a result row against its flight-recorder JSONL.

    The harness writes ``telemetry_<arm>.jsonl`` beside
    ``result_<arm>.json``; when the sibling exists, a published row must
    come from a run whose recorder CLOSED cleanly (``run_end`` present —
    an aborted run's partial row belongs in partial_<arm>.json, not here)
    with no unresolved anomaly (NaN loss / open step-time spike) events.
    Log-scraped ``result.json`` copies have no sibling and skip the check.
    """
    f: List[str] = []
    base = os.path.basename(result_path)
    if not (base.startswith("result_") and base.endswith(".json")):
        return f
    arm = base[len("result_"):-len(".json")]
    tpath = os.path.join(os.path.dirname(result_path), f"telemetry_{arm}.jsonl")
    if not os.path.exists(tpath):
        return f
    try:
        from ..telemetry import read_events
    except ImportError:  # run as a standalone script
        from distributed_llm_training_benchmark_framework_tpu_torch.telemetry import (
            read_events,
        )
    try:
        events = read_events(tpath)
    except ValueError as e:
        return [f"{name}: telemetry JSONL corrupt ({e})"]
    end = [e for e in events if e.get("event") == "run_end"]
    _check(
        len(end) == 1, name,
        f"result row exists but telemetry has {len(end)} run_end events "
        "(crashed runs must not publish result rows)", f,
    )
    if end:
        unresolved = end[0].get("n_unresolved_anomalies", 0) or 0
        _check(
            unresolved == 0, name,
            f"telemetry shows {unresolved} unresolved anomaly event(s) "
            "(NaN loss / open step-time spike) — row rejected", f,
        )
    if r.get("data_mode") == "stream":
        # The quarantine ledger must match the telemetry trail exactly:
        # one data_corrupt_record event per healed record. A mismatch in
        # either direction means the skip accounting (or the event drain)
        # broke — the "honest records_skipped ledger" contract.
        n_events = sum(
            1 for e in events if e.get("event") == "data_corrupt_record"
        )
        row_skipped = int(r.get("records_skipped") or 0)
        _check(
            n_events == row_skipped, name,
            f"records_skipped={row_skipped} but telemetry holds "
            f"{n_events} data_corrupt_record event(s) — the quarantine "
            "ledger and the telemetry trail disagree", f,
        )
    return f


def _hbm_capacity_gb(device_kind: str) -> Optional[float]:
    if not device_kind:
        return None
    try:
        from ..utils.memory import device_hbm_bytes
    except ImportError:  # run as a standalone script
        from distributed_llm_training_benchmark_framework_tpu_torch.utils.memory import (
            device_hbm_bytes,
        )
    b = device_hbm_bytes(device_kind)
    return b / 1e9 if b else None


def validate_log(path: str) -> List[str]:
    """Check the stdout-marker contract in one captured run log."""
    name = os.path.basename(path)
    f: List[str] = []
    text = open(path, errors="replace").read()
    n_start, n_end = text.count(MARKER_START), text.count(MARKER_END)
    _check(
        n_start == 1 and n_end == 1, name,
        f"expected exactly one marker pair, found {n_start} start / {n_end} end", f,
    )
    if n_start >= 1 and n_end >= 1:
        payload = text.split(MARKER_START, 1)[1].split(MARKER_END, 1)[0]
        try:
            json.loads(payload)
        except json.JSONDecodeError as e:
            f.append(f"{name}: marker payload is not valid JSON ({e})")
    return f


def collect(results_dir: str, logs_dir: Optional[str]) -> Tuple[List[str], int]:
    failures: List[str] = []
    result_files = sorted(
        glob.glob(os.path.join(results_dir, "**", "result*.json"), recursive=True)
    )
    n = 0
    for path in result_files:
        name = os.path.relpath(path, results_dir)
        try:
            r = json.load(open(path))
        except json.JSONDecodeError as e:
            failures.append(f"{name}: invalid JSON ({e})")
            continue
        failures.extend(validate_result(r, name))
        failures.extend(validate_telemetry(path, r, name))
        n += 1
    if logs_dir and os.path.isdir(logs_dir):
        for path in sorted(glob.glob(os.path.join(logs_dir, "*.log"))):
            failures.extend(validate_log(path))
            n += 1
    return failures, n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--results-dir", required=True,
                   help="directory searched recursively for result*.json")
    p.add_argument("--logs-dir", default=None,
                   help="optional directory of captured run logs (marker check)")
    args = p.parse_args(argv)
    failures, n = collect(args.results_dir, args.logs_dir)
    if n == 0:
        print(f"VALIDATE: no results found under {args.results_dir}")
        return 1
    for msg in failures:
        print(f"VALIDATE FAIL {msg}")
    verdict = "FAIL" if failures else "PASS"
    print(f"VALIDATE {verdict}: {n} artifacts checked, {len(failures)} violations")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
