"""The scaling observatory: weak/strong scaling curves from the registry.

Port of ``distributed_llm_training_benchmark_framework_tpu/analysis/scaling.py``
over the port's own registry (``regress.store``); curves, efficiencies and
the waterfall are computed as in JAX. One difference: a lineage also
carries the row's device (``regress.store.device_of``), so CPU and H100
points of one configuration never share a curve.

The paper's core deliverable is a cross-strategy scaling comparison, and
without it the framework could *measure* single geometries but never
*relate* them: nothing assembled tokens/sec-vs-device-count curves, and
nothing said WHERE efficiency dies as the mesh grows. This module closes
both gaps from evidence the stack already records:

- **Curves** are assembled per *lineage* — one configuration scaled over
  its data axis. A lineage is ``regress.store.config_key`` with the
  geometry axes (world size, per-device batch, grad accum) factored out;
  the parallel-composition degrees (tp/sp/pp/ep) stay in the lineage
  identity, so "zero2 over dp" and "zero2 x pp2 over dp" are separate
  curves rather than colliding points. Within a lineage the points are
  the newest baseline-eligible record per geometry (the same
  ``Registry._eligible`` chain the gate trusts: ok-status, unbanked,
  non-resumed, non-healed). Stitched points — a resumed /
  geometry-changed run from the scaling suite's reshard-on-restore legs
  — and sentinel-healed points are *flagged* in the curve instead of
  silently mixed in; partial records are excluded with a visible count.

- **Weak vs strong** is classified from the points themselves: constant
  per-device batch while the data axis grows is weak scaling (global
  batch grows with the mesh); constant *global* batch is strong scaling
  (per-device work shrinks). Mixed sweeps are labeled mixed rather than
  guessed at.

- **Efficiency** is per-chip throughput retention vs the smallest-mesh
  clean point: ``eff = (tps/ws) / (tps_base/ws_base) * 100``. With a
  single-chip base this is exactly the reference formula
  ``parse_metrics.add_scaling_efficiency`` reproduces; unlike the
  reference's 2-GPU-minimum data it normalizes honestly when the
  smallest measured mesh is larger than one chip.

- **The efficiency-loss waterfall** attributes each point's loss
  (100 - eff, in percentage points) from the step-anatomy fields already
  riding every profiled record: the *growth vs the base point* of
  exposed-collective time (``comms_exposed_frac``), pipeline bubble
  (``bubble_frac``) and straggler skew (``straggler_skew_pct``), plus a
  residual for what the anatomy cannot see (dispatch overhead,
  composition effects, input). First-order accounting — an extra X pp of
  step time on exposed comms costs ~X pp of throughput — the same
  decomposition "Scale MLPerf-0.6 models on TPU-v3 Pods" (1909.09756)
  and "Exploring the limits of Concurrency in ML Training on Google
  TPUs" (2011.03641) apply to their pod-scale curves, automated per
  geometry. Points without anatomy render unattributed rather than
  pretending.

The gate integration rides a separate, run-time path:
:func:`stamp_results_dir` post-processes a suite results tree and writes
each clean row's ``scaling_efficiency`` (a 0-1 fraction of ideal) into
its ``result_*.json`` BEFORE registry ingest, computed against the
smallest-geometry row of its own suite — so the value is part of the
measurement record, and ``stats.SECONDARY_METRICS`` verdicts it per
geometry exactly like ``comms_exposed_frac`` (absolute
percentage-point scale; the arm slug names the geometry in the gate
line). See docs/SCALING.md for the full methodology.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from ..regress import store as rstore

#: Result-row axes that define one scaling lineage (a curve). Everything
#: ``regress.store.config_key`` pins EXCEPT the geometry axes below —
#: the composition degrees stay here so a tp2 sweep never collides with
#: a pure-dp sweep. Kept as an explicit list (not derived from
#: config_key's tuple positions) so either side can evolve loudly.
LINEAGE_KEYS = (
    "model_family", "strategy", "tier", "seq_len", "attention_impl",
    "sync_every", "tensor_parallel", "sequence_parallel",
    "pipeline_parallel", "pipeline_schedule", "expert_parallel",
    "n_experts", "param_dtype", "causal", "ring_zigzag",
    "steps", "warmup_steps", "remat_policy", "xla_scheduler_flags",
    "tp_collective_matmul",
)

#: Axes that vary along a curve: the mesh size and the per-device work.
GEOMETRY_KEYS = ("world_size", "per_device_batch", "grad_accum")


@dataclasses.dataclass
class ScalingPoint:
    """One measured geometry on a curve."""

    world_size: int
    per_device_batch: int
    grad_accum: int
    dp: int
    global_batch: int
    tokens_per_sec: float
    tokens_per_sec_per_chip: float
    mfu_pct: Optional[float]
    record_id: str
    flags: Tuple[str, ...] = ()
    # Anatomy inputs (fractions / pct as recorded; None when unprofiled).
    comms_exposed_frac: Optional[float] = None
    bubble_frac: Optional[float] = None
    straggler_skew_pct: Optional[float] = None
    # Derived vs the curve's base point (filled by build_curves).
    efficiency_pct: Optional[float] = None
    loss_pp: Optional[float] = None
    d_comms_pp: Optional[float] = None
    d_bubble_pp: Optional[float] = None
    d_skew_pp: Optional[float] = None
    residual_pp: Optional[float] = None


@dataclasses.dataclass
class ScalingCurve:
    lineage: Dict[str, Any]
    mode: str  # 'weak' | 'strong' | 'mixed' | 'single-point'
    points: List[ScalingPoint]
    base_world_size: Optional[int] = None

    def label(self) -> str:
        l = self.lineage
        comp = []
        for key, tag in (("tensor_parallel", "tp"),
                         ("sequence_parallel", "sp"),
                         ("pipeline_parallel", "pp"),
                         ("expert_parallel", "ep")):
            d = l.get(key) or 1
            if d and int(d) > 1:
                part = f"{tag}{int(d)}"
                if tag == "pp" and l.get("pipeline_schedule"):
                    part += f"-{l['pipeline_schedule']}"
                comp.append(part)
        comp_s = (" x " + "+".join(comp)) if comp else ""
        return (
            f"{l.get('strategy')}{comp_s} x {l.get('model_family')} "
            f"tier{l.get('tier')} seq{l.get('seq_len')}"
        )


def _num(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) and v == v else None


def _dp(row: Dict[str, Any]) -> int:
    denom = 1
    for k in ("tensor_parallel", "sequence_parallel", "pipeline_parallel",
              "expert_parallel"):
        denom *= int(row.get(k) or 1)
    return max(int(row.get("world_size") or 1) // max(denom, 1), 1)


def lineage_of(row: Dict[str, Any]) -> Tuple:
    # The trailing element mirrors regress.store.config_key's
    # profiled-ness axis: anatomy fields are non-null exactly when the
    # run profiled, and the trace bracket's overhead makes a PROFILE=1
    # sweep a different measurement lineage than an unprofiled one — a
    # profiled re-sweep must form its own curve (and its own stamp
    # group), never silently replace unprofiled points. The port adds the
    # row's device (regress.store.device_of): a CPU point and an H100
    # point of one configuration are never one curve.
    return tuple(row.get(k) for k in LINEAGE_KEYS) + (
        row.get("comms_exposed_frac") is not None,
        rstore.device_of({"result": row}),
    )


def _point_from_record(rec: Dict[str, Any], flags: Tuple[str, ...]) -> ScalingPoint:
    row = rec.get("result") or {}
    ws = int(row.get("world_size") or 1)
    tps = _num(row.get("tokens_per_sec")) or 0.0
    dp = _dp(row)
    pdb = int(row.get("per_device_batch") or 1)
    ga = int(row.get("grad_accum") or 1)
    mfu = _num(row.get("mfu_pct"))
    return ScalingPoint(
        world_size=ws,
        per_device_batch=pdb,
        grad_accum=ga,
        dp=dp,
        global_batch=pdb * ga * dp,
        tokens_per_sec=tps,
        tokens_per_sec_per_chip=tps / ws if ws else 0.0,
        mfu_pct=mfu if (mfu or 0) > 0 else None,
        record_id=rec.get("record_id", "?"),
        flags=flags,
        comms_exposed_frac=_num(row.get("comms_exposed_frac")),
        bubble_frac=_num(row.get("bubble_frac")),
        straggler_skew_pct=_num(row.get("straggler_skew_pct")),
    )


#: Lineage axes that describe run LENGTH rather than configuration. A
#: stitch leg (reshard-on-restore continuation) necessarily runs a few
#: extra steps past the source run's final checkpoint, so flagged points
#: match their clean curve modulo these axes (clean points never do —
#: mixing a 12-step smoke curve with a 100-step curve is exactly the
#: cross-lineage comparison the registry config key exists to prevent).
RUN_LENGTH_KEYS = ("steps", "warmup_steps")


def _sans_length(lineage_key: Tuple) -> Tuple:
    named = tuple(
        None if k in RUN_LENGTH_KEYS else v
        for k, v in zip(LINEAGE_KEYS, lineage_key)
    )
    # Derived trailing elements (the profiled-ness axis) are identity,
    # not run length — carry them through the relaxation.
    return named + tuple(lineage_key[len(LINEAGE_KEYS):])


def collect_points(
    reg: rstore.Registry,
) -> Tuple[
    Dict[Tuple, Dict[Tuple, ScalingPoint]],
    Dict[Tuple, Dict[Tuple, ScalingPoint]],
    int,
]:
    """(clean, flagged) lineage -> geometry -> newest point, + n partial.

    Ingest order is the registry's clock: for each (lineage, geometry)
    the newest record wins, with the gate's eligibility rules deciding
    whether it lands clean or flagged — a stitched (resumed /
    geometry-changed) or healed (sentinel-rollback) record is shown
    FLAGGED, never silently curve-worthy, and a banked regression is
    skipped entirely (it is a known-bad measurement, not a point).
    """
    clean: Dict[Tuple, Dict[Tuple, ScalingPoint]] = {}
    flagged: Dict[Tuple, Dict[Tuple, ScalingPoint]] = {}
    n_partial = 0
    banked = reg.banked_ids()
    for arm in reg.arms():
        for rec in reg.records(arm):
            row = rec.get("result") or {}
            if row.get("world_size") is None or row.get("strategy") is None:
                continue  # multichip dryruns / non-run records
            if rec.get("status") != "ok":
                n_partial += 1
                continue
            if rec.get("record_id") in banked:
                continue
            flags: Tuple[str, ...] = ()
            if row.get("resumed") or row.get("resume_geometry_changed"):
                flags = ("stitched",)
            elif row.get("n_rollbacks"):
                flags = ("healed",)
            geom = tuple(row.get(k) for k in GEOMETRY_KEYS)
            dest = flagged if flags else clean
            dest.setdefault(lineage_of(row), {})[geom] = _point_from_record(
                rec, flags
            )
    return clean, flagged, n_partial


def _classify_mode(points: List[ScalingPoint]) -> str:
    if len({p.world_size for p in points}) < 2:
        return "single-point"
    weak = (
        len({(p.per_device_batch, p.grad_accum) for p in points}) == 1
    )
    strong = len({p.global_batch for p in points}) == 1
    if weak and not strong:
        return "weak"
    if strong:
        return "strong"
    return "mixed"


def build_curves(reg: rstore.Registry) -> Tuple[List[ScalingCurve], int]:
    """Assemble every >=2-point curve, derived fields filled in.

    A curve needs at least one clean point (the base) and two points
    total. Flagged (stitched/healed) points attach to the clean curve
    whose lineage matches exactly, else — unique match only — modulo the
    run-length axes (see RUN_LENGTH_KEYS); an ambiguous or matchless
    flagged point is dropped rather than guessed onto a curve.
    """
    raw, flagged_raw, n_partial = collect_points(reg)
    # Attach flagged points to their clean lineage.
    sans = {}
    for lk in raw:
        sans.setdefault(_sans_length(lk), []).append(lk)
    for flk, by_geom in flagged_raw.items():
        if flk in raw:
            target = flk
        else:
            candidates = sans.get(_sans_length(flk), [])
            if len(candidates) != 1:
                continue
            target = candidates[0]
        for geom, point in by_geom.items():
            # Keyed beside (never over) the clean point at the same
            # geometry: both rows are honest and both must render.
            raw[target][geom + ("flagged",)] = point
    curves: List[ScalingCurve] = []
    for lineage_key, by_geom in raw.items():
        points = sorted(
            by_geom.values(),
            key=lambda p: (p.world_size, p.per_device_batch, p.grad_accum,
                           len(p.flags)),
        )
        if len(points) < 2:
            continue
        lineage = dict(zip(LINEAGE_KEYS, lineage_key))
        clean = [p for p in points if not p.flags]
        base = clean[0] if clean else None
        for p in points:
            if base is None:
                continue
            ideal_per_chip = base.tokens_per_sec_per_chip
            if ideal_per_chip <= 0:
                continue
            p.efficiency_pct = round(
                100.0 * p.tokens_per_sec_per_chip / ideal_per_chip, 2
            )
            p.loss_pp = round(100.0 - p.efficiency_pct, 2)
            if p is base:
                continue
            # The waterfall: anatomy GROWTH vs the base point, in pp.
            # First-order: +X pp of step time on exposed comms / bubble
            # costs ~X pp of throughput; skew is already a percent.
            attributed = 0.0
            any_attr = False
            if (p.comms_exposed_frac is not None
                    and base.comms_exposed_frac is not None):
                p.d_comms_pp = round(
                    100.0 * (p.comms_exposed_frac - base.comms_exposed_frac),
                    2,
                )
                attributed += p.d_comms_pp
                any_attr = True
            if p.bubble_frac is not None and base.bubble_frac is not None:
                p.d_bubble_pp = round(
                    100.0 * (p.bubble_frac - base.bubble_frac), 2
                )
                attributed += p.d_bubble_pp
                any_attr = True
            if (p.straggler_skew_pct is not None
                    and base.straggler_skew_pct is not None):
                p.d_skew_pp = round(
                    p.straggler_skew_pct - base.straggler_skew_pct, 2
                )
                attributed += p.d_skew_pp
                any_attr = True
            if any_attr:
                p.residual_pp = round(p.loss_pp - attributed, 2)
        curves.append(ScalingCurve(
            lineage=lineage,
            mode=_classify_mode(points),
            points=points,
            base_world_size=base.world_size if base else None,
        ))
    curves.sort(key=lambda c: c.label())
    return curves, n_partial


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------


def _cell(v, fmt="{:,.1f}", missing="--") -> str:
    return fmt.format(v) if v is not None else missing


def format_curve(curve: ScalingCurve) -> str:
    head = (
        f"-- {curve.label()} [{curve.mode} scaling, "
        f"{len(curve.points)} points"
        + (f", base ws={curve.base_world_size}" if curve.base_world_size
           else ", NO CLEAN BASE")
        + "] --"
    )
    lines = [
        head,
        "  ws  b/dev  acc    tokens/s  tok/s/chip   MFU%    eff%  "
        "dcomms  dbubble  dskew   resid  flags",
    ]
    for p in curve.points:
        flags = ",".join(f.upper() for f in p.flags)
        if p.world_size == curve.base_world_size and not p.flags:
            flags = "base"
        unattr = (
            p.efficiency_pct is not None
            and p.world_size != curve.base_world_size
            and p.residual_pp is None
        )
        lines.append(
            f"{p.world_size:>4}  {p.per_device_batch:>5}  {p.grad_accum:>3}"
            f"  {p.tokens_per_sec:>10,.0f}"
            f"  {p.tokens_per_sec_per_chip:>10,.0f}"
            f"  {_cell(p.mfu_pct, '{:.1f}', '-'):>5}"
            f"  {_cell(p.efficiency_pct):>6}"
            f"  {_cell(p.d_comms_pp, '{:+.1f}'):>6}"
            f"  {_cell(p.d_bubble_pp, '{:+.1f}'):>7}"
            f"  {_cell(p.d_skew_pp, '{:+.1f}'):>5}"
            f"  {_cell(p.residual_pp, '{:+.1f}'):>6}"
            + (f"  {flags}" if flags else "")
            + ("  [unattributed: no anatomy]" if unattr else "")
        )
    return "\n".join(lines)


def format_report(
    curves: List[ScalingCurve], n_partial: int, registry_root: str,
) -> str:
    out = [f"== Scaling curves (registry: {registry_root}) =="]
    if not curves:
        out.append(
            "  no lineage spans >= 2 geometries yet — run "
            "scripts/scaling_suite.sh (or ingest a multi-world-size suite) "
            "to grow curves"
        )
    for c in curves:
        out.append("")
        out.append(format_curve(c))
    out.append("")
    out.append(
        f"{len(curves)} curve(s); dcomms/dbubble/dskew = efficiency-loss "
        "attribution in pp vs the base point (step-anatomy growth; "
        "docs/SCALING.md); resid = loss the anatomy cannot see."
    )
    if n_partial:
        out.append(
            f"NOTE: {n_partial} partial (heartbeat-salvaged) record(s) "
            "excluded — a truncated run's rate is not a scaling point."
        )
    return "\n".join(out)


def curves_to_json(curves: List[ScalingCurve], n_partial: int) -> Dict[str, Any]:
    return {
        "curves": [
            {
                "lineage": c.lineage,
                "label": c.label(),
                "mode": c.mode,
                "base_world_size": c.base_world_size,
                "points": [dataclasses.asdict(p) for p in c.points],
            }
            for c in curves
        ],
        "excluded_partial_records": n_partial,
    }


def write_curves_png(curves: List[ScalingCurve], path: str) -> Optional[str]:
    """Throughput + efficiency panels, one line per curve. None when
    nothing is plottable (no curve with a base)."""
    plottable = [c for c in curves if c.base_world_size is not None]
    if not plottable:
        return None
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax_tps, ax_eff) = plt.subplots(1, 2, figsize=(10, 3.6), dpi=150)
    for c in plottable:
        xs = [p.world_size for p in c.points]
        ys = [p.tokens_per_sec for p in c.points]
        (line,) = ax_tps.plot(xs, ys, marker="o", linewidth=1.2,
                              label=f"{c.label()} ({c.mode})")
        base = next(
            p for p in c.points
            if p.world_size == c.base_world_size and not p.flags
        )
        ideal = [base.tokens_per_sec_per_chip * x for x in xs]
        ax_tps.plot(xs, ideal, linestyle="--", linewidth=0.8,
                    color=line.get_color(), alpha=0.5)
        effs = [(p.world_size, p.efficiency_pct) for p in c.points
                if p.efficiency_pct is not None]
        ax_eff.plot([e[0] for e in effs], [e[1] for e in effs],
                    marker="o", linewidth=1.2, color=line.get_color())
        for p in c.points:
            if p.flags and p.efficiency_pct is not None:
                ax_eff.scatter([p.world_size], [p.efficiency_pct],
                               marker="x", color="#c0392b", zorder=5)
    ax_tps.set_xscale("log", base=2)
    ax_tps.set_yscale("log", base=2)
    ax_tps.set_xlabel("devices")
    ax_tps.set_ylabel("tokens/sec (dashed = ideal)")
    ax_tps.legend(fontsize=6)
    ax_eff.set_xscale("log", base=2)
    ax_eff.set_xlabel("devices")
    ax_eff.set_ylabel("scaling efficiency % (x = stitched/healed)")
    ax_eff.axhline(100.0, color="#d9d8d4", linewidth=0.8)
    for ax in (ax_tps, ax_eff):
        ax.grid(color="#d9d8d4", linewidth=0.5)
        for spine in ("top", "right"):
            ax.spines[spine].set_visible(False)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)
    return path


def scaling_section(registry_root: str) -> List[str]:
    """The make_report section: one markdown table per curve.

    Mirrors the CLI table from the same engine, so the report and the
    console can never disagree about a curve. SchemaDrift degrades to an
    "unavailable" note, the posture every registry-fed section takes.
    """
    try:
        reg = rstore.Registry(registry_root)
        if not reg.exists():
            return []
        curves, n_partial = build_curves(reg)
    except rstore.SchemaDrift as e:
        return ["## Scaling curves", "", f"_unavailable: {e}_", ""]
    if not curves:
        return []
    out = ["## Scaling curves", "",
           "Per-lineage weak/strong scaling with the efficiency-loss "
           "waterfall attributed from step anatomy (pp vs the base "
           "geometry; `python -m ...analysis.scaling` for the full "
           "tables, docs/SCALING.md for semantics). Stitched "
           "(reshard-on-restore) and healed points are flagged and never "
           "anchor the curve.", ""]
    for c in curves:
        out.append(f"### {c.label()} — {c.mode} scaling")
        out.append("")
        out.append("| ws | tokens/s | tok/s/chip | MFU % | eff % "
                   "| Δcomms pp | Δbubble pp | Δskew pp | residual pp "
                   "| flags |")
        out.append("|---|---|---|---|---|---|---|---|---|---|")
        for p in c.points:
            flags = ",".join(p.flags) or (
                "base" if p.world_size == c.base_world_size else "-"
            )
            out.append(
                f"| {p.world_size} | {p.tokens_per_sec:,.0f} "
                f"| {p.tokens_per_sec_per_chip:,.0f} "
                f"| {_cell(p.mfu_pct, '{:.1f}', '-')} "
                f"| {_cell(p.efficiency_pct)} "
                f"| {_cell(p.d_comms_pp, '{:+.1f}')} "
                f"| {_cell(p.d_bubble_pp, '{:+.1f}')} "
                f"| {_cell(p.d_skew_pp, '{:+.1f}')} "
                f"| {_cell(p.residual_pp, '{:+.1f}')} "
                f"| {flags} |"
            )
        out.append("")
    if n_partial:
        out.append(f"_{n_partial} partial record(s) excluded from the "
                   "curves._")
        out.append("")
    return out


# ---------------------------------------------------------------------------
# Result-row stamping (the gate path)
# ---------------------------------------------------------------------------


def compute_efficiency_stamps(
    rows: List[Dict[str, Any]],
) -> Dict[int, float]:
    """index -> scaling_efficiency fraction for the stampable rows.

    Grouping matches the curve lineage (LINEAGE_KEYS); the base is the
    smallest-world-size CLEAN row of each group (never resumed / healed
    / partial — the `_eligible` posture applied at stamp time). Only
    clean rows are stamped: a stitched run's throughput folds the
    restore, so minting it an efficiency would gate the recovery
    machinery, not the scaling.
    """
    def clean(row):
        return not (
            row.get("partial")
            or row.get("resumed")
            or row.get("resume_geometry_changed")
            or row.get("n_rollbacks")
        )

    groups: Dict[Tuple, List[int]] = {}
    for i, row in enumerate(rows):
        if row.get("tokens_per_sec") is None or row.get("world_size") is None:
            continue
        groups.setdefault(lineage_of(row), []).append(i)
    stamps: Dict[int, float] = {}
    for idxs in groups.values():
        clean_idxs = [i for i in idxs if clean(rows[i])]
        if not clean_idxs:
            continue
        base = min(
            clean_idxs,
            key=lambda i: (int(rows[i].get("world_size") or 1),
                           int(rows[i].get("per_device_batch") or 1),
                           int(rows[i].get("grad_accum") or 1)),
        )
        base_row = rows[base]
        base_per_chip = (
            float(base_row["tokens_per_sec"])
            / max(int(base_row.get("world_size") or 1), 1)
        )
        if base_per_chip <= 0:
            continue
        for i in clean_idxs:
            row = rows[i]
            per_chip = (
                float(row["tokens_per_sec"])
                / max(int(row.get("world_size") or 1), 1)
            )
            stamps[i] = round(per_chip / base_per_chip, 6)
    return stamps


def stamp_results_dir(results_dir: str) -> List[Tuple[str, float]]:
    """Write ``scaling_efficiency`` into each clean ``result_*.json``.

    Runs BEFORE registry ingest (scripts/scaling_suite.sh order), so the
    fraction rides the ingested record's result row and the secondary-
    metric gate can verdict it per geometry. Returns the
    (path, fraction) stamps applied. Idempotent: re-stamping recomputes
    from the same rows and writes the same values.
    """
    paths = sorted(
        p for p in glob.glob(
            os.path.join(results_dir, "**", "result*.json"), recursive=True
        )
        if os.path.basename(p).startswith(("result_", "result."))
        or os.path.basename(p) == "result.json"
    )
    rows: List[Dict[str, Any]] = []
    keep: List[str] = []
    for path in paths:
        try:
            row = json.load(open(path))
        except (json.JSONDecodeError, OSError):
            continue
        if not isinstance(row, dict) or "tokens_per_sec" not in row:
            continue
        rows.append(row)
        keep.append(path)
    stamps = compute_efficiency_stamps(rows)
    out: List[Tuple[str, float]] = []
    for i, frac in sorted(stamps.items()):
        rows[i]["scaling_efficiency"] = frac
        with open(keep[i], "w") as f:
            json.dump(rows[i], f, indent=2)
            f.write("\n")
        out.append((keep[i], frac))
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m distributed_llm_training_benchmark_framework_tpu_torch"
             ".analysis.scaling",
        description="scaling observatory: weak/strong curves + "
                    "efficiency-loss waterfall from the run registry "
                    "(docs/SCALING.md)",
    )
    p.add_argument("--registry", default=None,
                   help="registry root (default: $REGRESS_REGISTRY_TORCH or "
                        "results/registry_torch)")
    p.add_argument("--out", default=None,
                   help="directory for scaling_curves.{png,json}")
    p.add_argument("--png", action="store_true",
                   help="write scaling_curves.png under --out (or cwd)")
    p.add_argument("--json", action="store_true",
                   help="write scaling_curves.json under --out (or cwd)")
    p.add_argument("--stamp-results-dir", default=None, metavar="DIR",
                   help="stamp mode: write scaling_efficiency into each "
                        "clean result_*.json under DIR (run before "
                        "registry ingest), then exit")
    args = p.parse_args(argv)

    if args.stamp_results_dir:
        if not os.path.isdir(args.stamp_results_dir):
            print(f"scaling: no such results dir "
                  f"{args.stamp_results_dir!r}", file=sys.stderr)
            return 2
        stamped = stamp_results_dir(args.stamp_results_dir)
        print(f"scaling stamp: {len(stamped)} row(s) stamped with "
              "scaling_efficiency")
        for path, frac in stamped:
            print(f"  {os.path.relpath(path, args.stamp_results_dir)}: "
                  f"{100.0 * frac:.1f}%")
        return 0

    try:
        reg = rstore.Registry(args.registry)
    except rstore.SchemaDrift as e:
        print(f"scaling: {e}", file=sys.stderr)
        return 2
    if not reg.exists():
        print(f"scaling: no registry at {reg.root} (run a suite, or "
              "`regress ingest` first)", file=sys.stderr)
        return 2
    curves, n_partial = build_curves(reg)
    print(format_report(curves, n_partial, reg.root))
    out_dir = args.out or "."
    if args.json:
        path = os.path.join(out_dir, "scaling_curves.json")
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(curves_to_json(curves, n_partial), f, indent=2,
                      sort_keys=True)
            f.write("\n")
        print(f"Wrote {path}")
    if args.png:
        path = write_curves_png(
            curves, os.path.join(out_dir, "scaling_curves.png")
        )
        if path:
            print(f"Wrote {path}")
        else:
            print("scaling: nothing plottable yet (no curve with a clean "
                  "base)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
