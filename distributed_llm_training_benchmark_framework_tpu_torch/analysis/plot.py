#!/usr/bin/env python
"""Plot metrics.csv into the reference's five benchmark figures.

Port of ``distributed_llm_training_benchmark_framework_tpu/analysis/plot.py``:
the same figures and file names.

Figure-for-figure parity with the reference plotter (``scripts/plot.py``):
tokens/sec vs chips, step-time vs chips, peak memory vs seq-len (only when
multiple seq-lens exist), scaling efficiency vs chips with the ideal line, and
the H2D-proxy vs chips — one line per strategy, 150-dpi PNGs, Agg backend.

Styling follows a validated colorblind-safe categorical palette (fixed slot
order per strategy, never cycled; worst adjacent CVD deltaE 9.1), thin marks,
recessive grid, direct axis labels.
"""

from __future__ import annotations

import argparse
import os
from typing import List

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import pandas as pd  # noqa: E402

# Fixed categorical slot order (validated palette; strategy -> slot, stable
# across filtered subsets so a missing arm never repaints the survivors).
STRATEGY_COLORS = {
    "ddp": "#2a78d6",    # blue
    "fsdp": "#eb6834",   # orange
    "zero2": "#1baf7a",  # aqua
    "zero3": "#eda100",  # yellow
}
FALLBACK_COLORS = ["#e87ba4", "#008300", "#4a3aa7", "#e34948"]

SURFACE = "#fcfcfb"
TEXT = "#0b0b0b"
TEXT_2 = "#52514e"
GRID = "#d9d8d4"


def _style_axes(ax, xlabel: str, ylabel: str, title: str) -> None:
    ax.set_facecolor(SURFACE)
    ax.set_xlabel(xlabel, color=TEXT)
    ax.set_ylabel(ylabel, color=TEXT)
    ax.set_title(title, color=TEXT, fontsize=12)
    ax.grid(True, color=GRID, linewidth=0.6, alpha=0.8)
    ax.tick_params(colors=TEXT_2)
    for s in ax.spines.values():
        s.set_color(GRID)


def _color_for(strategy: str, i: int) -> str:
    return STRATEGY_COLORS.get(strategy, FALLBACK_COLORS[i % len(FALLBACK_COLORS)])


def _seq_key_cols(df: pd.DataFrame) -> List[str]:
    """Line-grouping key for the vs-sequence-length figures: a mixed results
    dir holds several rows per (strategy, seq_len) — one per attention impl /
    world size / model family / composition arm — and merging them into one
    line would draw vertical zigzags. Every identity axis that actually
    varies in the frame joins the key (and the line label)."""
    return ["strategy"] + [
        c for c in (
            "attention_impl", "world_size", "tier", "model_family",
            "causal", "ring_zigzag", "tp_collective_matmul",
            "n_experts", "param_dtype",
            "offload_opt_state", "offload_delayed_update",
            "offload_dpu_start_step", "tensor_parallel", "sequence_parallel",
            "pipeline_parallel", "pipeline_schedule", "virtual_stages",
            "expert_parallel",
        )
        if c in df.columns and df[c].nunique(dropna=False) > 1
    ]


def _line_per_strategy(df: pd.DataFrame, x: str, y: str, ax) -> None:
    for i, (strategy, g) in enumerate(sorted(df.groupby("strategy"))):
        g = g.sort_values(x)
        ax.plot(
            g[x], g[y],
            label=strategy, color=_color_for(strategy, i),
            linewidth=2, marker="o", markersize=6,
        )
    ax.legend(frameon=False, labelcolor=TEXT)


def _save(fig, out_dir: str, name: str, names: List[str]) -> None:
    path = os.path.join(out_dir, name)
    fig.patch.set_facecolor(SURFACE)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    names.append(name)
    print(f"Wrote {path}")


def make_plots(df: pd.DataFrame, out_dir: str) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    written: List[str] = []

    fig, ax = plt.subplots(figsize=(7, 4.5))
    _line_per_strategy(df, "world_size", "tokens_per_sec", ax)
    _style_axes(ax, "Chips", "Tokens/sec", "Throughput vs chip count")
    _save(fig, out_dir, "tokens_per_sec_vs_gpu.png", written)

    fig, ax = plt.subplots(figsize=(7, 4.5))
    _line_per_strategy(df, "world_size", "mean_step_time_sec", ax)
    _style_axes(ax, "Chips", "Mean step time (s)", "Step time vs chip count")
    _save(fig, out_dir, "step_time_vs_gpu.png", written)

    if df["seq_len"].nunique() > 1:
        # Measured peak when the platform reports allocator stats; the
        # pre-flight analytic estimate otherwise (all-zero measured column).
        mem_col, mem_label = "peak_vram_gb", "Peak HBM (GB)"
        if df["peak_vram_gb"].max() == 0 and "est_hbm_gb" in df.columns:
            mem_col, mem_label = "est_hbm_gb", "Estimated HBM (GB)"
        fig, ax = plt.subplots(figsize=(7, 4.5))
        for i, (key, g) in enumerate(sorted(df.groupby(_seq_key_cols(df)))):
            key = key if isinstance(key, tuple) else (key,)
            g = g.sort_values("seq_len")
            ax.plot(
                g["seq_len"], g[mem_col],
                label=" ".join(str(k) for k in key),
                color=_color_for(key[0], i),
                linestyle="--" if "reference" in key else "-",
                linewidth=2, marker="o", markersize=6,
            )
        ax.legend(frameon=False, labelcolor=TEXT, fontsize=8)
        _style_axes(ax, "Sequence length", mem_label, "Memory vs sequence length")
        _save(fig, out_dir, "vram_vs_seqlen.png", written)

    fig, ax = plt.subplots(figsize=(7, 4.5))
    _line_per_strategy(df, "world_size", "scaling_efficiency_pct", ax)
    xs = sorted(df["world_size"].unique())
    ax.plot(xs, [100.0] * len(xs), linestyle="--", color=TEXT_2, linewidth=1.5,
            label="ideal (100%)")
    ax.legend(frameon=False, labelcolor=TEXT)
    _style_axes(ax, "Chips", "Scaling efficiency (%)", "Scaling efficiency vs chip count")
    _save(fig, out_dir, "scaling_efficiency.png", written)

    fig, ax = plt.subplots(figsize=(7, 4.5))
    _line_per_strategy(df, "world_size", "h2d_gbps_per_gpu", ax)
    _style_axes(ax, "Chips", "H2D GB/s per chip (proxy)", "Host-to-device transfer proxy")
    _save(fig, out_dir, "gbps_vs_gpu.png", written)

    # --- Beyond-reference figures (rendered when the data supports them) ---

    # Per-strategy throughput bars, grouped by attention impl: the natural
    # view for a single-chip (world_size-degenerate) suite.
    impls = (
        sorted(df["attention_impl"].dropna().unique())
        if "attention_impl" in df.columns else []
    )
    base_seq = df["seq_len"].min()
    base = df[df["seq_len"] == base_seq]
    if impls:
        strategies = sorted(base["strategy"].unique())
        fig, ax = plt.subplots(figsize=(7, 4.5))
        width = 0.8 / max(len(impls), 1)
        hatches = {impl: h for impl, h in zip(impls, ["", "//", "..", "xx"])}
        for i, strategy in enumerate(strategies):
            for j, impl in enumerate(impls):
                rows = base[(base["strategy"] == strategy)
                            & (base["attention_impl"] == impl)]
                if rows.empty:
                    continue
                val = rows["tokens_per_sec"].max()
                ax.bar(
                    i + (j - (len(impls) - 1) / 2) * width, val, width * 0.92,
                    color=_color_for(strategy, i), hatch=hatches.get(impl, ""),
                    edgecolor=SURFACE, linewidth=0.5,
                )
                ax.text(
                    i + (j - (len(impls) - 1) / 2) * width, val, impl,
                    ha="center", va="bottom", fontsize=8, color=TEXT_2,
                    rotation=0,
                )
        ax.set_xticks(range(len(strategies)))
        ax.set_xticklabels(strategies)
        _style_axes(
            ax, "Strategy", "Tokens/sec",
            f"Throughput by strategy and attention impl (seq {base_seq})",
        )
        ax.grid(axis="x", visible=False)
        _save(fig, out_dir, "tokens_per_sec_by_strategy.png", written)

    # MFU bars — the metric the reference never measured.
    if "mfu_pct" in df.columns and (base["mfu_pct"] > 0).any():
        fig, ax = plt.subplots(figsize=(7, 4.5))
        rows = (
            base[base["mfu_pct"] > 0]
            .sort_values("mfu_pct", ascending=False)
            .drop_duplicates(subset=[c for c in ("strategy", "attention_impl")
                                     if c in base.columns])
        )
        labels = [
            f"{r.strategy}\n({getattr(r, 'attention_impl', '')})"
            for r in rows.itertuples()
        ]
        ax.bar(
            range(len(rows)), rows["mfu_pct"],
            color=[_color_for(s, i) for i, s in enumerate(rows["strategy"])],
            edgecolor=SURFACE, linewidth=0.5,
        )
        ax.set_xticks(range(len(rows)))
        ax.set_xticklabels(labels, fontsize=8)
        _style_axes(
            ax, "Strategy (attention)", "Model FLOPs utilization (%)",
            f"MFU by strategy (seq {base_seq})",
        )
        ax.grid(axis="x", visible=False)
        _save(fig, out_dir, "mfu_by_strategy.png", written)

    # Memory waterfall (memory-anatomy round): per-arm stacked attribution
    # of the reference peak — params/grads/opt/activations/dataset/
    # XLA-temp — with the signed unattributed residual as a floating tail
    # and the analytic estimate as a tick. Rendered whenever parse_metrics
    # flattened hbm_attr_* columns into the frame (rows without the
    # reconciliation are skipped). The memory-domain sibling of the time
    # waterfall in the anatomy/scaling sections.
    from . import ATTRIBUTION_CLASSES

    class_colors = {
        "params": "#2a78d6", "grads": "#eb6834", "opt_state": "#eda100",
        "activations": "#1baf7a", "dataset": "#e87ba4",
        "xla_temp": "#4a3aa7",
    }
    attr_classes = [
        (c, class_colors.get(c, "#008300"))
        for c in ATTRIBUTION_CLASSES if c != "unattributed"
    ]
    attr_cols = [f"hbm_attr_{c}" for c, _ in attr_classes]
    if all(c in df.columns for c in attr_cols):
        rows = df[df[attr_cols[0]].notna()]
        if len(rows):
            fig, ax = plt.subplots(
                figsize=(7, max(2.5, 0.5 * len(rows) + 1.5))
            )
            labels = []
            for y, (_, r) in enumerate(rows.iterrows()):
                left = 0.0
                for (cls, color), col in zip(attr_classes, attr_cols):
                    w = float(r[col]) if r[col] == r[col] else 0.0
                    ax.barh(y, w, left=left, color=color,
                            edgecolor=SURFACE, linewidth=0.4,
                            label=cls if y == 0 else None)
                    left += max(w, 0.0)
                resid = r.get("hbm_attr_unattributed")
                if resid is not None and resid == resid:
                    ax.barh(y, float(resid), left=left, color="#52514e",
                            alpha=0.5, edgecolor=SURFACE, linewidth=0.4,
                            label="unattributed" if y == 0 else None)
                est = r.get("hbm_est_total_gib")
                if est is not None and est == est:
                    ax.plot([float(est)] * 2, [y - 0.4, y + 0.4],
                            color=TEXT, linewidth=1.2, linestyle="--",
                            label="analytic est" if y == 0 else None)
                labels.append(
                    f"{r['strategy']} ws{int(r['world_size'])} "
                    f"seq{int(r['seq_len'])}"
                )
            ax.set_yticks(range(len(rows)))
            ax.set_yticklabels(labels, fontsize=8)
            ax.legend(frameon=False, labelcolor=TEXT, fontsize=7, ncol=4)
            _style_axes(ax, "GiB per chip", "",
                        "HBM peak attribution (memory anatomy)")
            ax.grid(axis="y", visible=False)
            _save(fig, out_dir, "hbm_anatomy.png", written)

    # Long-context throughput: tokens/sec vs sequence length. One line per
    # (strategy, attention impl, world size) — a mixed results dir holds
    # several rows per (strategy, seq_len) and merging them into one line
    # would draw meaningless vertical zigzags.
    if df["seq_len"].nunique() > 1:
        fig, ax = plt.subplots(figsize=(7, 4.5))
        for i, (key, g) in enumerate(sorted(df.groupby(_seq_key_cols(df)))):
            key = key if isinstance(key, tuple) else (key,)
            g = g.sort_values("seq_len")
            ax.plot(
                g["seq_len"], g["tokens_per_sec"],
                label=" ".join(str(k) for k in key),
                color=_color_for(key[0], i),
                linestyle="--" if "reference" in key else "-",
                linewidth=2, marker="o", markersize=6,
            )
        ax.set_xscale("log", base=2)
        ax.legend(frameon=False, labelcolor=TEXT, fontsize=8)
        _style_axes(
            ax, "Sequence length", "Tokens/sec",
            "Throughput vs sequence length",
        )
        _save(fig, out_dir, "tokens_vs_seqlen.png", written)

    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--results", required=True, help="path to metrics.csv")
    p.add_argument("--out", required=True, help="output directory for PNGs")
    args = p.parse_args(argv)
    df = pd.read_csv(args.results)
    make_plots(df, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
