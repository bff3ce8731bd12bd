#!/usr/bin/env python
"""Generate BENCHMARK_REPORT.md from metrics.csv.

Structure parity with the reference report generator
(``scripts/make_report.py``): summary table, per-strategy tables, key findings
(best throughput / best scaling efficiency / lowest peak memory), strategy
trade-off prose, embedded plot links.

Port of ``distributed_llm_training_benchmark_framework_tpu/analysis/make_report.py``
over the port's ``regress`` and ``scaling``. The Markdown is JAX's line for
line except for these, which name the port's hardware and collectives:
the title (``TITLE``), the four ``TRADEOFFS`` blurbs (DDP, FSDP2 and the
hand-written ZeRO arms over NCCL, where JAX's XLA runs the collectives over
ICI) and the remat frontier's headroom note ("blank off the card"), to
which the port adds ``FRONTIER_WINDOW_NOTE``.
"""

from __future__ import annotations

import argparse
import os
from typing import List

import pandas as pd

# The memory-anatomy attribution classes, straight from the engine
# (parse_metrics flattens them into hbm_attr_<class> columns) — one
# list, so a class added there can never silently vanish from the
# report table.
from . import ATTRIBUTION_CLASSES as _HBM_CLASSES

#: The report's title (JAX: "# TPU Distributed Training Benchmark Report").
TITLE = "# GPU Distributed Training Benchmark Report (PyTorch port)"

#: What the frontier's tokens/sec can rank (the port's addition to the
#: headroom note): the rows of one sweep run one after another, each for
#: the run's few timed steps, and on the card the same policy measured
#: twice has differed by more than the gap between two policies.
FRONTIER_WINDOW_NOTE = (
    "Each row's tokens/sec is one window of the run's timed steps (`--steps` "
    "less `--warmup-steps`): a short run does not rank two policies whose "
    "tokens/sec differ by less than repeated runs of one policy spread; "
    "peak HBM does not spread so.")

TRADEOFFS = {
    "ddp": (
        "Data parallel (replicated)",
        "Params and optimizer state replicated on every card; DDP all-reduces "
        "gradients over NCCL. Lowest communication volume per step at small "
        "scale; highest memory per card.",
    ),
    "fsdp": (
        "Fully-sharded data parallel",
        "Params, gradients and optimizer state sharded across the 'data' mesh "
        "axis; FSDP2 all-gathers weights per use and reduce-scatters gradients. "
        "Lowest steady-state memory; more collective traffic per step.",
    ),
    "zero2": (
        "ZeRO-2 (sharded optimizer state)",
        "Params replicated, gradients reduce-scattered, Adam moments sharded. "
        "Cuts optimizer memory ~per-card by world size while keeping forward/"
        "backward free of weight gathers — often the throughput sweet spot.",
    ),
    "zero3": (
        "ZeRO-3 (fully sharded + remat)",
        "Fully-sharded like fsdp plus per-layer rematerialization (activation "
        "checkpointing): lowest memory of all arms at the cost of recompute "
        "in backward.",
    ),
}


def _fmt_params(n) -> str:
    try:
        n = float(n)
    except (TypeError, ValueError):
        return ""
    if n != n or n <= 0:  # NaN or absent
        return ""
    return f"{n/1e9:.2f}B" if n >= 1e9 else f"{n/1e6:.0f}M"


def _composition_label(r) -> str:
    """Slug of the non-default composition axes of one run row, so roster
    arms sharing (strategy, world_size) stay distinguishable in the tables
    (e.g. 'tp2', 'pp2-interleaved-v2', 'sp2', 'ep2x4e'); '-' for a pure
    data-parallel row."""

    def val(key, default=0):
        v = r.get(key, default)
        try:
            f = float(v)
        except (TypeError, ValueError):
            return default
        return default if f != f else int(f)  # NaN -> default

    bits = []
    if val("tensor_parallel", 1) > 1:
        bits.append(f"tp{val('tensor_parallel', 1)}")
    if val("sequence_parallel", 1) > 1:
        bits.append(f"sp{val('sequence_parallel', 1)}")
    if val("pipeline_parallel", 1) > 1:
        sched = r.get("pipeline_schedule") or "gpipe"
        pp = f"pp{val('pipeline_parallel', 1)}-{sched}"
        if sched == "interleaved" and val("virtual_stages", 0) > 0:
            pp += f"-v{val('virtual_stages', 0)}"
        bits.append(pp)
    if val("n_experts", 0) > 0:
        bits.append(f"ep{max(val('expert_parallel', 1), 1)}x{val('n_experts', 0)}e")
    if r.get("param_dtype") == "bf16":
        bits.append("bf16-params")
    if str(r.get("offload_opt_state")).lower() == "true":
        bits.append("opt-offload")
    return "+".join(bits) if bits else "-"


def fmt_table(df: pd.DataFrame, cols: List[str]) -> str:
    header = "| " + " | ".join(cols) + " |"
    sep = "|" + "|".join(["---"] * len(cols)) + "|"
    rows = []
    for _, r in df.iterrows():
        cells = []
        for c in cols:
            v = r[c]
            cells.append(f"{v:,.1f}" if isinstance(v, float) else str(v))
        rows.append("| " + " | ".join(cells) + " |")
    return "\n".join([header, sep] + rows)


def trend_section(registry_root: str, limit: int = 5) -> List[str]:
    """Per-arm run-over-run history from the regress registry.

    One table per arm: the newest ``limit`` records with delta vs the
    previous ok run. Partial (heartbeat-salvaged) records appear flagged
    but never anchor deltas or the best-run marker — the same exclusion
    the summary superlatives apply to partial rows.
    """
    from ..regress import compare as regress_compare
    from ..regress import store as regress_store

    # SchemaDrift can surface at open (newer registry meta) OR while
    # loading any single record ingested by a newer writer (mixed-version
    # fleet) — either way the report must degrade to an "unavailable"
    # note, never die with a traceback and take BENCHMARK_REPORT.md down
    # with it.
    try:
        reg = regress_store.Registry(registry_root)
        if not reg.exists():
            return []
        out = ["## Per-arm trend (registry)", "",
               f"Run-over-run history from "
               f"`{os.path.basename(registry_root)}` "
               f"(newest {limit}; delta vs previous ok run; `regress trend "
               "<arm>` for the full history and a PNG).", ""]
        for arm in reg.arms():
            rows = regress_compare.trend_rows(reg, arm, limit=limit)
            if not rows:
                continue
            out.append(f"### {arm}")
            out.append("")
            out.append("| record | value | metric | delta vs prev | status |")
            out.append("|---|---|---|---|---|")
            for r in rows:
                val = f"{r['value']:,.2f}" if r["value"] is not None else "-"
                delta = (f"{r['delta_pct_vs_prev']:+.2f}%"
                         if r["delta_pct_vs_prev"] is not None else "-")
                status = r["status"] + (" (best)" if r["best"] else "")
                out.append(
                    f"| `{r['record_id']}` | {val} "
                    f"| {r['metric_name'] or '-'} | {delta} | {status} |"
                )
            out.append("")
        return out
    except regress_store.SchemaDrift as e:
        return ["## Per-arm trend (registry)", "", f"_unavailable: {e}_", ""]


#: Frontier row order: zero recompute -> full recompute, the probe last.
_REMAT_ORDER = {"none": 0, "dots": 1, "full": 2, "auto": 3}


def remat_frontier_section(registry_root: str) -> List[str]:
    """The HBM-vs-recompute frontier from ``bench.py --remat-sweep`` records.

    One table per swept arm: the newest record per remat policy —
    tokens/sec/chip vs measured peak HBM (with the per-chip headroom the
    memory estimator prints), delta vs the no-remat point. Records are
    identified by a non-null ``remat_policy`` in their result row (the
    sweep stamps it; ordinary bench/flagship rows never carry it).

    The table only mixes records from ONE config lineage (the newest
    sweep record's ``store.config_key`` with the policy axis
    neutralized): a later ``--steps 12`` smoke sweep must not lend its
    'none' base to an older full-length sweep's rows — the exact
    cross-lineage comparison the config key exists to prevent. Omitted
    older-lineage sweep records are counted in a note, never silent.
    """
    from ..regress import store as regress_store

    def lineage(rec):
        # The config key with remat_policy neutralized: rows of one
        # sweep share it, sweeps at different run shapes do not.
        r = dict(rec.get("result") or {})
        r.pop("remat_policy", None)
        return regress_store.config_key({**rec, "result": r})

    try:
        reg = regress_store.Registry(registry_root)
        if not reg.exists():
            return []
        by_arm: dict = {}
        omitted = 0
        for arm in reg.arms():
            sweep = [rec for rec in reg.records(arm)  # oldest -> newest
                     if (rec.get("result") or {}).get("remat_policy")]
            if not sweep:
                continue
            lin = lineage(sweep[-1])
            for rec in sweep:
                if lineage(rec) == lin:  # newest wins within the lineage
                    by_arm.setdefault(arm, {})[
                        rec["result"]["remat_policy"]] = rec
                else:
                    omitted += 1
        if not by_arm:
            return []
        out = ["## Remat/HBM frontier (`bench.py --remat-sweep`)", "",
               "Tokens/sec vs peak HBM per rematerialization policy — the "
               "recompute-for-memory trade (docs/PERFORMANCE.md). Each "
               "policy is its own regress lineage (the policy is part of "
               "the registry config key); *headroom* is per-chip HBM "
               "capacity minus the measured peak (blank off the card). "
               + FRONTIER_WINDOW_NOTE, ""]
        if omitted:
            out.append(f"_{omitted} older-lineage sweep record(s) "
                       "(different run shape) omitted from the tables._")
            out.append("")
        for arm in sorted(by_arm):
            pols = by_arm[arm]
            out.append(f"### {arm}")
            out.append("")
            out.append("| policy | resolved | tokens/sec/chip | vs none "
                       "| peak HBM GB | headroom GB | MFU % | est GiB "
                       "| xla-temp GiB | drift % |")
            out.append("|---|---|---|---|---|---|---|---|---|---|")
            base = ((pols.get("none") or {}).get("metric") or {}).get("value")
            for pol in sorted(pols, key=lambda p: _REMAT_ORDER.get(p, 9)):
                rec = pols[pol]
                row = rec.get("result") or {}
                val = (rec.get("metric") or {}).get("value")
                delta = (f"{100.0 * (val - base) / base:+.1f}%"
                         if val is not None and base else "-")

                def num(key, fmt="{:,.2f}"):
                    v = row.get(key)
                    return fmt.format(v) if isinstance(v, (int, float)) else "-"

                # Memory-anatomy columns (memory round): the sweep's rows
                # now carry the measured+attributed HBM — the frontier
                # reads observed, not just estimated. Pre-anatomy records
                # render "-".
                attr = row.get("hbm_attribution") or {}
                drift_v = row.get("hbm_model_drift_frac")
                drift_s = (
                    f"{100.0 * drift_v:.1f}"
                    if isinstance(drift_v, (int, float)) else "-"
                )
                xt = attr.get("xla_temp")
                out.append(
                    f"| {pol} | {row.get('remat_policy_resolved') or '-'} "
                    f"| {f'{val:,.2f}' if val is not None else '-'} "
                    f"| {delta} | {num('peak_hbm_gb')} "
                    f"| {num('hbm_headroom_gb')} | {num('mfu_pct')} "
                    f"| {num('hbm_estimate_gib')} "
                    f"| {f'{xt:,.2f}' if isinstance(xt, (int, float)) else '-'} "
                    f"| {drift_s} |"
                )
            out.append("")
        return out
    except regress_store.SchemaDrift as e:
        return ["## Remat/HBM frontier (`bench.py --remat-sweep`)", "",
                f"_unavailable: {e}_", ""]


def anatomy_section(df: pd.DataFrame) -> List[str]:
    """Step-anatomy table for every row that carries the trace-derived
    attribution (arms run with --profile-dir; analysis/step_anatomy.py).

    The compute / exposed-comms / overlap / idle split plus the roofline
    position — the report's answer to "is this arm communication-bound,
    and is the communication hidden".
    """
    if "comms_exposed_frac" not in df.columns:
        return []
    rows = df[df["comms_exposed_frac"].notna()]
    if not len(rows):
        return []
    out = [
        "## Step anatomy (trace-derived)", "",
        "Per traced device step: compute vs collective time (exposed on "
        "the critical path vs overlapped under compute) vs idle/host gap, "
        "with the roofline position (% of peak FLOP/s and HBM bandwidth) "
        "and, for pipeline arms, the schedule's bubble fraction "
        "(`analysis/step_anatomy.py`, docs/OBSERVABILITY.md). The "
        "compute/exposed/idle columns are fractions OF THE STEP and sum "
        "to 100%; *overlap %comms* is the fraction OF COLLECTIVE TIME "
        "hidden under compute (overlapped time is already inside the "
        "compute column).", "",
        "| strategy | ws | seq | compute % | exposed comms % "
        "| overlap %comms | idle % | bubble % | FLOPs %peak | HBM %peak "
        "| skew % |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]

    def pct(row, key):
        v = row.get(key)
        try:
            v = float(v)
        except (TypeError, ValueError):
            return "-"
        return f"{100.0 * v:.1f}" if v == v else "-"

    def raw(row, key):
        v = row.get(key)
        try:
            v = float(v)
        except (TypeError, ValueError):
            return "-"
        return f"{v:.1f}" if v == v else "-"

    for _, r in rows.iterrows():
        out.append(
            f"| {r['strategy']} | {int(r['world_size'])} "
            f"| {int(r['seq_len'])} "
            f"| {pct(r, 'anatomy_compute_frac')} "
            f"| {pct(r, 'comms_exposed_frac')} "
            f"| {pct(r, 'comms_overlap_frac')} "
            f"| {pct(r, 'anatomy_idle_frac')} "
            f"| {pct(r, 'bubble_frac')} "
            f"| {raw(r, 'roofline_flops_pct_of_peak')} "
            f"| {raw(r, 'roofline_hbm_pct_of_peak')} "
            f"| {raw(r, 'straggler_skew_pct')} |"
        )
    out.append("")
    return out




def memory_section(df: pd.DataFrame) -> List[str]:
    """Per-arm HBM waterfall beside the time waterfall: the attributed
    peak (params/grads/opt/activations/dataset/XLA-temp + signed
    residual), the analytic estimate, the measured column (or its
    explicit unavailability reason) and the gated model drift —
    ``analysis/memory_anatomy.py``, docs/OBSERVABILITY.md."""
    cols = [f"hbm_attr_{c}" for c in _HBM_CLASSES]
    if not all(c in df.columns for c in cols):
        return []
    rows = df[df[cols[0]].notna()]
    if not len(rows):
        return []
    out = [
        "## Memory anatomy (HBM peak, attributed)", "",
        "Per-chip peak attribution from the three-source reconciliation "
        "(`analysis/memory_anatomy.py`): analytic estimate + XLA "
        "compile-time accounting + allocator measurement. *source* names "
        "which peak is being attributed (`allocator` measured > "
        "`xla_buffer_assignment` > `analytic`); *residual* is the signed "
        "book-closing remainder; *drift* = |reference − analytic| / "
        "analytic, gated as `hbm_model_drift_frac`.", "",
        "| strategy | ws | seq | source | peak GiB | est GiB | params "
        "| grads | opt | act | data | xla-temp | residual | drift % |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]

    def num(row, key, fmt="{:.2f}"):
        v = row.get(key)
        try:
            v = float(v)
        except (TypeError, ValueError):
            return "-"
        return fmt.format(v) if v == v else "-"

    for _, r in rows.iterrows():
        drift = r.get("hbm_model_drift_frac")
        try:
            drift = (f"{100.0 * float(drift):.1f}"
                     if drift is not None and float(drift) == float(drift)
                     else "-")
        except (TypeError, ValueError):
            drift = "-"
        out.append(
            f"| {r['strategy']} | {int(r['world_size'])} "
            f"| {int(r['seq_len'])} "
            f"| {r.get('hbm_attribution_source') or '-'} "
            f"| {num(r, 'hbm_reference_gib')} "
            f"| {num(r, 'hbm_est_total_gib')} "
            f"| {num(r, 'hbm_attr_params')} | {num(r, 'hbm_attr_grads')} "
            f"| {num(r, 'hbm_attr_opt_state')} "
            f"| {num(r, 'hbm_attr_activations')} "
            f"| {num(r, 'hbm_attr_dataset')} "
            f"| {num(r, 'hbm_attr_xla_temp')} "
            f"| {num(r, 'hbm_attr_unattributed', '{:+.2f}')} "
            f"| {drift} |"
        )
    out.append("")
    return out


def build_report(
    df: pd.DataFrame, plots_dir: str = "../plots", plots_root: str = "",
    registry_root: str = "", step_anatomy_txt: str = "",
) -> str:
    df = df.copy()
    cols = [
        "strategy", "world_size", "seq_len", "tokens_per_sec",
        "mean_step_time_sec", "peak_vram_gb", "scaling_efficiency_pct",
    ]
    # Tier + parameter count: without these the tier-B row is
    # indistinguishable from a catastrophically slow tier-A row.
    if "tier" in df.columns:
        cols.insert(1, "tier")
        if "n_params" in df.columns:
            df["params"] = df["n_params"].map(_fmt_params)
            cols.insert(2, "params")
    # Composition axes: roster arms share (strategy, world_size) with the
    # pure arms; a config slug keeps every row identifiable.
    comp = df.apply(_composition_label, axis=1)
    if (comp != "-").any():
        df["config"] = comp
        cols.insert(1, "config")
    # Additive columns (beyond the reference's), surfaced when the data carries them: attention
    # impl (reference vs flash rows share a table) and MFU.
    if "attention_impl" in df.columns and df["attention_impl"].nunique() > 1:
        cols.insert(cols.index("tokens_per_sec"), "attention_impl")
    if "mfu_pct" in df.columns and (df["mfu_pct"] > 0).any():
        cols.insert(cols.index("mean_step_time_sec") + 1, "mfu_pct")
    if "est_hbm_gb" in df.columns and (
        "peak_vram_gb" not in df.columns or (df["peak_vram_gb"] == 0).all()
    ):
        # Measurement unavailable on this platform; show the pre-flight
        # estimate instead of an all-zero measured column.
        cols = [c for c in cols if c != "peak_vram_gb"]
        cols.insert(-1, "est_hbm_gb")
    # Partial rows (heartbeat salvage from runs that died before their
    # final marker — scripts/collect_results.sh): kept in the tables with
    # an explicit flag column, excluded from the key-findings superlatives
    # (a truncated run's throughput is not a best-of anything).
    has_partial = "partial" in df.columns and df["partial"].fillna(False).any()
    if has_partial:
        cols.append("partial")
        full = df[~df["partial"].fillna(False).astype(bool)]
    else:
        full = df
    # Sentinel-healed rows (n_rollbacks > 0, self-healing round): complete
    # and validated, but the run hit a numerics incident and replayed
    # steps — show the column so the heal is visible in the table.
    if "n_rollbacks" in df.columns and (
        df["n_rollbacks"].fillna(0) > 0
    ).any():
        cols.append("n_rollbacks")
    # Supervisor-recovered rows (elastic fleet supervisor,
    # runtime/supervisor.py): the arm died and the supervisor restarted
    # it — possibly through a geometry shrink leg — until it finished.
    # Show the recovery history (attempt count, actions taken, shrink
    # legs) beside the healed/partial accounting; like those rows, they
    # are excluded from scaling-efficiency baselines upstream.
    has_supervised = "supervised_attempts" in df.columns and (
        df["supervised_attempts"].fillna(0).astype(float) > 1
    ).any()
    if has_supervised:
        df["supervised_attempts"] = (
            df["supervised_attempts"].fillna(1).astype(int)
        )
        cols.append("supervised_attempts")
        for c in ("supervised_actions", "supervised_shrink_legs"):
            if c in df.columns:
                df[c] = df[c].fillna("").replace("", "-")
                cols.append(c)
    cols = [c for c in cols if c in df.columns]
    out = [TITLE, ""]

    if "device_kind" in df.columns and df["device_kind"].notna().any():
        kinds = ", ".join(sorted(set(str(k) for k in df["device_kind"].dropna() if k)))
        out += [f"Hardware: {kinds}", ""]

    out += ["## Summary", "", fmt_table(df[cols], cols), ""]

    out += ["## Per-strategy results", ""]
    for strategy, g in sorted(df.groupby("strategy")):
        title, blurb = TRADEOFFS.get(strategy, (strategy, ""))
        out += [f"### {strategy} — {title}", "", blurb, "",
                fmt_table(g[cols], cols), ""]

    out += ["## Key findings", ""]
    if len(full):
        best_tps = full.loc[full["tokens_per_sec"].idxmax()]
        out.append(
            f"- **Best throughput:** {best_tps['strategy']} at "
            f"{best_tps['tokens_per_sec']:,.0f} tokens/sec "
            f"({int(best_tps['world_size'])} chips, seq {int(best_tps['seq_len'])})"
        )
    if "scaling_efficiency_pct" in full.columns and len(full) > 1:
        multi = full[full["world_size"] > full["world_size"].min()]
        if len(multi):
            best_eff = multi.loc[multi["scaling_efficiency_pct"].idxmax()]
            out.append(
                f"- **Best scaling efficiency:** {best_eff['strategy']} at "
                f"{best_eff['scaling_efficiency_pct']:.1f}% "
                f"({int(best_eff['world_size'])} chips)"
            )
    if "peak_vram_gb" in full.columns and full["peak_vram_gb"].max() > 0:
        low_mem = full.loc[full["peak_vram_gb"].idxmin()]
        out.append(
            f"- **Lowest peak HBM:** {low_mem['strategy']} at "
            f"{low_mem['peak_vram_gb']:.2f} GB/chip"
        )
    if "mfu_pct" in full.columns and (full["mfu_pct"] > 0).any():
        best_mfu = full.loc[full["mfu_pct"].idxmax()]
        impl = (
            f", {best_mfu['attention_impl']} attention"
            if "attention_impl" in full.columns else ""
        )
        out.append(
            f"- **Best MFU:** {best_mfu['strategy']} at "
            f"{best_mfu['mfu_pct']:.1f}% of bf16 peak"
            f" (seq {int(best_mfu['seq_len'])}{impl})"
        )
    if "tokens_per_dollar" in full.columns and (full["tokens_per_dollar"] > 0).any():
        # Cost-efficiency headline (reference README.md:270-276 analogue).
        best_cost = full.loc[full["tokens_per_dollar"].idxmax()]
        out.append(
            f"- **Best cost efficiency:** {best_cost['strategy']} at "
            f"{best_cost['tokens_per_dollar']/1e6:,.1f}M tokens/$ "
            f"(${best_cost['usd_per_chip_hour']:.2f}/chip-hr on-demand, "
            f"seq {int(best_cost['seq_len'])})"
        )
    if has_partial:
        is_partial = df["partial"].fillna(False).astype(bool)
        n_partial = int(is_partial.sum())
        # Death classification (chaos + self-healing rounds): a preempted
        # arm left an emergency checkpoint and resumes on retry; a hung
        # arm was aborted by the in-process watchdog (exit 76, stack dump
        # in its telemetry hang_dump event) and also resumes on retry; a
        # crashed one needs triage. An input-starved arm (streaming
        # round) was classified reason=data_stall by the loop itself
        # (exit 78, emergency checkpoint + stream sidecar — resumes on
        # retry like a preemption, but the triage target is the DATA
        # source, not the device). The collect script stamps `reason`
        # from the final heartbeat (emergency heartbeats carry
        # reason=preempted|hang|data_stall).
        death = ""
        if "reason" in df.columns:
            reasons = df.loc[is_partial, "reason"]
            n_pre = int((reasons == "preempted").sum())
            n_hang = int((reasons == "hang").sum())
            n_stall = int((reasons == "data_stall").sum())
            stall_txt = (
                f"{n_stall} input-starved (data_stall: checkpointed, "
                "triage the data source), " if n_stall else ""
            )
            death = (f" ({n_pre} preempted with an emergency checkpoint, "
                     f"{n_hang} hung (watchdog abort, stack dump in "
                     "telemetry), " + stall_txt +
                     f"{n_partial - n_pre - n_hang - n_stall} crashed)")
        out.append(
            f"- **Partial rows:** {n_partial} arm(s) died before their "
            "final result marker; their rows come from heartbeat salvage "
            f"(last sync window){death} — see the `partial` column."
        )
    if has_supervised:
        sup = df[df["supervised_attempts"] > 1]
        n_shrunk = int((sup["supervised_shrink_legs"] != "-").sum()) if (
            "supervised_shrink_legs" in sup.columns
        ) else 0
        shrink_txt = (
            f", {n_shrunk} via a geometry shrink leg "
            "(resumed on fewer chips from the checkpoint's geometry "
            "sidecar)" if n_shrunk else ""
        )
        out.append(
            f"- **Supervised recoveries:** {len(sup)} arm(s) finished "
            "only after the fleet supervisor restarted them"
            f"{shrink_txt} — attempt counts and actions in the "
            "`supervised_*` columns; full per-attempt ledger in each "
            "arm's `supervision.json`."
        )
    out.append("")

    out += anatomy_section(df)
    out += memory_section(df)
    if step_anatomy_txt and os.path.exists(step_anatomy_txt):
        # The suite's per-arm step-anatomy CLI tables (full component
        # breakdown incl. top collectives), shipped verbatim.
        body = open(step_anatomy_txt).read().strip()
        if body:
            out += ["### Per-arm anatomy tables", "", "```", body, "```",
                    ""]

    if registry_root:
        from .scaling import scaling_section

        out += scaling_section(registry_root)
        out += remat_frontier_section(registry_root)
        out += trend_section(registry_root)

    out += ["## Plots", ""]
    for name, caption in [
        ("tokens_per_sec_vs_gpu.png", "Throughput vs chip count"),
        ("step_time_vs_gpu.png", "Step time vs chip count"),
        ("scaling_efficiency.png", "Scaling efficiency vs chip count"),
        ("vram_vs_seqlen.png", "Peak HBM vs sequence length"),
        ("hbm_anatomy.png", "HBM peak attribution (memory anatomy)"),
        ("gbps_vs_gpu.png", "H2D transfer proxy"),
        ("tokens_per_sec_by_strategy.png",
         "Throughput by strategy and attention impl"),
        ("mfu_by_strategy.png", "MFU by strategy"),
        ("tokens_vs_seqlen.png", "Throughput vs sequence length"),
    ]:
        # Skip links to figures the plotter didn't render for this dataset
        # (when we can see the plots directory; embed unconditionally if not).
        if plots_root and not os.path.exists(os.path.join(plots_root, name)):
            continue
        out.append(f"![{caption}]({plots_dir}/{name})")
    out.append("")
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--csv", required=True, help="path to metrics.csv")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--plots-dir", default="../plots")
    p.add_argument("--registry", default=None,
                   help="regress registry root: adds the per-arm trend "
                        "section (run-over-run history)")
    p.add_argument("--step-anatomy", default=None,
                   help="step_anatomy CLI output file: embedded verbatim "
                        "under the step-anatomy section")
    args = p.parse_args(argv)
    df = pd.read_csv(args.csv)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "BENCHMARK_REPORT.md")
    plots_root = os.path.normpath(os.path.join(args.out, args.plots_dir))
    with open(path, "w") as f:
        f.write(build_report(df, args.plots_dir, plots_root=plots_root,
                             registry_root=args.registry or "",
                             step_anatomy_txt=args.step_anatomy or ""))
    print(f"Wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
