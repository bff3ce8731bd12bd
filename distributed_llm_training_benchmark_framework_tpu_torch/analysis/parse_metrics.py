#!/usr/bin/env python
"""Aggregate result.json files into metrics.csv with scaling efficiency.

Port of ``distributed_llm_training_benchmark_framework_tpu/analysis/parse_metrics.py``:
the same columns, cells and dedup, on the port's result rows.

Contract parity with the reference aggregator (``scripts/parse_metrics.py``):

- discovers results by recursive glob for ``result*.json`` under
  ``--results-dir`` (reference ``parse_metrics.py:21``);
- emits ``metrics.csv`` whose leading columns are exactly the reference's
  (sample: ``results/example_output/README.md:85-92``), with
  ``scaling_efficiency_pct`` last; TPU-additive columns sit in between and
  name-based consumers are unaffected;
- scaling efficiency uses the *same formula* (reference
  ``parse_metrics.py:50-63``): for each (strategy, seq_len) group the baseline
  is the row with minimum world_size, and

      efficiency_pct = tokens_per_sec / (baseline_tps * world_size) * 100

  which pins baseline-world-size rows at ``100/baseline_ws`` % — with the
  reference's 2-GPU-minimum data that produced the "50% at 2 GPU" quirk; our
  suites include world_size=1 rows so the baseline is a true single-chip run
  and the numbers become honest automatically.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import List

import pandas as pd

REFERENCE_COLUMNS = [
    "strategy", "world_size", "rank", "seq_len", "tier", "steps",
    "per_device_batch", "grad_accum", "tokens_per_sec", "mean_step_time_sec",
    "mean_loss", "peak_vram_gb", "h2d_gbps_per_gpu",
]


def _partial_row(p: dict) -> dict:
    """Map a salvaged heartbeat payload (collect_results.sh
    ``partial_<arm>.json``) onto the result-row column space.

    A dead arm's last heartbeat carries its run identity plus the
    progress metrics at its final sync window; mapping them here is what
    makes failed arms appear in metrics.csv/the report as visibly-partial
    rows instead of vanishing. Metrics the heartbeat cannot know (peak
    memory, MFU, ...) stay absent -> NaN in the frame.
    """
    row = {
        k: p[k] for k in (
            "strategy", "world_size", "rank", "seq_len", "tier",
            "model_family", "per_device_batch", "grad_accum",
            "tokens_per_sec",
            # Composition axes (in the heartbeat meta since round 8): keep
            # partial rows from colliding arms — e.g. the zigzag A/B pair —
            # distinct under the dedup key below.
            "attention_impl", "tensor_parallel", "sequence_parallel",
            "pipeline_parallel", "pipeline_schedule", "expert_parallel",
            "n_experts", "causal", "ring_zigzag",
            # Streaming-data progress (stream runs stamp these on every
            # heartbeat): a salvaged input-starved arm keeps its honest
            # stall/skip accounting AND its stream lineage identity in
            # the partial row (store.config_key reads data_mode — a dead
            # stream arm must not be misfiled into the synthetic lineage).
            "data_mode", "data_stall_frac", "records_skipped",
            # Collective-matmul identity (round 15): keeps a dead cmm
            # arm's partial row distinct from its plain-tp A/B partner
            # and in the cmm regress lineage.
            "tp_collective_matmul",
        ) if k in p
    }
    if "total_steps" in p:
        row["steps"] = p["total_steps"]
    if "window_mean_step_time_sec" in p:
        row["mean_step_time_sec"] = p["window_mean_step_time_sec"]
    if "loss" in p and p["loss"] is not None:
        # The LAST observed loss, not a run mean — close enough for a
        # partial row, and the partial flag warns every consumer.
        row["mean_loss"] = p["loss"]
    row["last_step"] = p.get("step")
    row["partial"] = True
    # Death classification + stitched-run accounting (chaos round): the
    # collect script stamps reason=preempted|crash, and a resumed arm's
    # heartbeats carry resumed/n_restarts — the report separates a
    # preempted pod (checkpointed, resumable) from a genuine crash.
    for k in ("reason", "resumed", "n_restarts", "resume_geometry_changed"):
        if k in p:
            row[k] = p[k]
    return row


def _flatten_memory_anatomy(row: dict) -> dict:
    """Expand the memory-anatomy dict fields into scalar CSV columns.

    ``hbm_attribution`` becomes one ``hbm_attr_<class>`` column per
    attribution class and ``hbm_estimate`` collapses to its total
    (``hbm_est_total_gib``) — metrics.csv is the plot/report substrate
    and dict-valued cells would stringify uselessly there; the full
    dicts stay in the result JSON (the registry records keep them too).
    """
    attr = row.pop("hbm_attribution", None)
    if isinstance(attr, dict):
        for cls, val in attr.items():
            row[f"hbm_attr_{cls}"] = val
    est = row.pop("hbm_estimate", None)
    if isinstance(est, dict):
        row["hbm_est_total_gib"] = est.get("total_gib")
    return row


def _flatten_supervision(row: dict) -> dict:
    """Expand the fleet supervisor's recovery-history stamp into scalar
    CSV columns.

    ``supervision`` is the summary the supervisor copies from its
    ``supervision.json`` ledger onto the final result row of a RECOVERED
    run (runtime/supervisor.py): attempt count, the actions taken, and
    any geometry shrink/regrow legs. Flattened beside the existing
    resumed/healed/partial accounting so the report (and a human
    grepping the CSV) sees the whole recovery history; unsupervised
    rows omit the columns entirely.
    """
    sup = row.pop("supervision", None)
    if isinstance(sup, dict):
        row["supervised_attempts"] = sup.get("n_attempts")
        row["supervised_actions"] = ",".join(sup.get("actions") or [])
        row["supervised_shrink_legs"] = ",".join(sup.get("shrink_legs") or [])
    return row


def _note_give_up_ledgers(results_dir: str) -> None:
    """Name every supervision ledger that ended in give-up: those arms
    published no result row (at most a salvaged partial), so the ledger
    on disk is their only first-class trace — surface it here rather
    than letting the aggregation silently read as 'arm never ran'."""
    for path in sorted(Path(results_dir).rglob("supervision*.json")):
        try:
            with open(path) as f:
                ledger = json.load(f)
        except (json.JSONDecodeError, OSError):
            continue
        if ledger.get("gave_up"):
            print(
                f"NOTE: supervisor gave up after "
                f"{ledger.get('n_attempts')} attempt(s) "
                f"(final class: {ledger.get('final_class')}) — see {path}"
            )


def load_results(results_dir: str) -> pd.DataFrame:
    rows = []
    for path in sorted(Path(results_dir).rglob("result*.json")):
        try:
            with open(path) as f:
                rows.append(
                    _flatten_supervision(_flatten_memory_anatomy(json.load(f)))
                )
        except (json.JSONDecodeError, OSError) as e:
            print(f"WARNING: skipping unreadable {path}: {e}")
    n_full = len(rows)
    _note_give_up_ledgers(results_dir)
    for path in sorted(Path(results_dir).rglob("partial_*.json")):
        try:
            with open(path) as f:
                rows.append(_partial_row(json.load(f)))
        except (json.JSONDecodeError, OSError) as e:
            print(f"WARNING: skipping unreadable {path}: {e}")
    if not rows:
        raise SystemExit(f"No result*.json files found under {results_dir}")
    if len(rows) > n_full:
        print(f"NOTE: {len(rows) - n_full} partial row(s) from heartbeat "
              "salvage (runs that died before their final result marker)")
        for r in rows[:n_full]:
            r.setdefault("partial", False)
    df = pd.DataFrame(rows)
    # The same run can surface twice: the harness writes result_<arm>.json and
    # the log scraper extracts result.json for the identical run. Dedupe on
    # the run identity key.
    key = [
        c for c in (
            "strategy", "world_size", "seq_len", "tier", "model_family",
            "rank", "per_device_batch", "grad_accum", "steps",
            "attention_impl",
            # Composition axes: a pipeline/TP/SP/MoE/bf16 arm is a DIFFERENT
            # run from the baseline with the same batch geometry — without
            # these in the key, a composition suite sharing RESULTS_DIR with
            # a baseline suite would dedupe one of them away.
            "tensor_parallel", "sequence_parallel", "pipeline_parallel",
            "pipeline_schedule", "virtual_stages", "expert_parallel",
            "n_experts", "remat_policy", "param_dtype", "offload_opt_state",
            "offload_delayed_update", "offload_dpu_start_step", "causal",
            "ring_zigzag", "tp_collective_matmul",
            # Stitched-run identity (scaling suite): a reshard-on-restore
            # continuation shares every config axis with the fresh point
            # at the same geometry — without these, one of the two honest
            # rows silently vanishes from metrics.csv.
            "resumed", "resume_geometry_changed",
        ) if c in df.columns
    ]
    df = df.drop_duplicates(subset=key, keep="first")
    return df.sort_values(["strategy", "seq_len", "world_size"]).reset_index(drop=True)


def add_scaling_efficiency(df: pd.DataFrame) -> pd.DataFrame:
    """Reference formula (parse_metrics.py:50-63), reproduced exactly.

    Grouping extends the reference's (strategy, seq_len) with every other
    config axis we preserve through dedup (attention_impl, batch shape, ...),
    so a row's baseline always ran the identical configuration at the smallest
    world size — never a different kernel's throughput.
    """
    group_cols = ["strategy", "seq_len"] + [
        c for c in (
            "tier", "model_family", "per_device_batch", "grad_accum",
            "attention_impl",
            "tensor_parallel", "sequence_parallel", "pipeline_parallel",
            "pipeline_schedule", "virtual_stages", "expert_parallel",
            "n_experts", "param_dtype", "offload_opt_state",
            "offload_delayed_update", "offload_dpu_start_step", "causal",
            "ring_zigzag", "tp_collective_matmul",
        )
        if c in df.columns
    ]
    df = df.copy()
    df["scaling_efficiency_pct"] = 0.0
    # Partial rows (heartbeat salvage): a truncated run's throughput must
    # neither serve as a group baseline nor mint an efficiency number of
    # its own — its last-window rate is not a run mean. NaN marks the cell
    # as not-measured (0.0 would read as a catastrophic measurement).
    if "partial" in df.columns:
        is_partial = df["partial"].fillna(False).astype(bool)
        df.loc[is_partial, "scaling_efficiency_pct"] = float("nan")
        eligible = df[~is_partial]
    else:
        eligible = df
    # Stitched (resumed) and sentinel-healed rows get their efficiency
    # computed — they are honest rows and the report flags them — but
    # never serve as a group BASELINE: a restore-folding first window is
    # not the per-chip ideal everything else should be normalized by
    # (the same posture the regress registry's _eligible chain takes).
    ineligible_base = pd.Series(False, index=eligible.index)
    for col in ("resumed", "resume_geometry_changed"):
        if col in eligible.columns:
            ineligible_base |= eligible[col].fillna(False).astype(bool)
    if "n_rollbacks" in eligible.columns:
        ineligible_base |= eligible["n_rollbacks"].fillna(0).astype(float) > 0
    if "supervised_attempts" in eligible.columns:
        # Supervisor-recovered rows (attempt > 1: the measurement spans a
        # restart, possibly a geometry shrink leg) never anchor the ideal.
        ineligible_base |= (
            eligible["supervised_attempts"].fillna(1).astype(float) > 1
        )
    # dropna=False: rows from before a schema addition carry NaN in the
    # newer axis columns and must still get their efficiency computed
    # (pandas silently drops NaN-keyed groups by default).
    for _, group in eligible.groupby(group_cols, dropna=False):
        base_pool = group[~ineligible_base.loc[group.index]]
        if not len(base_pool):
            # Only stitched/healed rows at this config: no honest ideal
            # to normalize by — leave their efficiency unmeasured.
            df.loc[group.index, "scaling_efficiency_pct"] = float("nan")
            continue
        base = base_pool.loc[base_pool["world_size"].idxmin()]
        for i in group.index:
            row = df.loc[i]
            denom = base["tokens_per_sec"] * row["world_size"]
            df.loc[i, "scaling_efficiency_pct"] = (
                row["tokens_per_sec"] / denom * 100.0 if denom > 0 else 0.0
            )
    return df


def to_csv(df: pd.DataFrame, out_path: str) -> None:
    extras = [
        c for c in df.columns
        if c not in REFERENCE_COLUMNS + ["scaling_efficiency_pct"]
    ]
    cols = [c for c in REFERENCE_COLUMNS if c in df.columns] + extras + [
        "scaling_efficiency_pct"
    ]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    df[cols].to_csv(out_path, index=False)


def main(argv: List[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--results-dir", required=True)
    p.add_argument("--out", required=True, help="output directory for metrics.csv")
    args = p.parse_args(argv)

    df = add_scaling_efficiency(load_results(args.results_dir))
    out_csv = os.path.join(args.out, "metrics.csv")
    to_csv(df, out_csv)

    print(f"Parsed {len(df)} results -> {out_csv}")
    summary_cols = [
        "strategy", "world_size", "seq_len", "tokens_per_sec",
        "mean_step_time_sec", "peak_vram_gb", "scaling_efficiency_pct",
    ]
    print(df[[c for c in summary_cols if c in df.columns]].to_string(index=False))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
