"""regress CLI: ingest / compare / trend / gate over the run registry.

    python -m distributed_llm_training_benchmark_framework_tpu_torch.regress \
        ingest --results-dir results [--registry results/registry_torch]
    ... regress compare <id-or-sel> <id-or-sel> [--arm ARM]
    ... regress trend <arm> [--png trend.png] [--limit N]
    ... regress gate --baseline last-good --candidate latest [--arm ARM|--all]
    ... regress bisect <good> <bad> [--arm ARM]   # first-bad git-sha boundary

Port of ``distributed_llm_training_benchmark_framework_tpu/regress/compare.py``:
the same subcommands, verdicts, texts and exit codes, over the port's own
registry (``store``: root ``results/registry_torch``, variable
``REGRESS_REGISTRY_TORCH``). ``ingest --legacy`` is refused (exit 2): the
repo-root snapshots it would seed from are TPU-era records.

Exit codes mirror JAX's graftcheck (the other standing gate): 0 clean, 1 a
significant regression (gate) or a failed comparison the caller asked to
enforce, 2 operational error (schema drift, unknown record, bad usage).

Selectors accepted wherever a record is named: a record-id prefix,
``latest`` (newest record for --arm), or ``last-good`` (newest ok,
non-partial record for --arm). The gate's contract — pinned by the
frozen-fixture proof in tests/test_regress.py — is that a regression
line names the arm, the metric, the delta and the confidence interval:

    regress gate: REGRESSION arm=<arm> metric=tokens_per_sec \
        delta=-10.12% CI95=[-10.80%, -9.45%] p=... baseline=<id> candidate=<id>
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from . import stats, store


# ---------------------------------------------------------------------------
# Record resolution
# ---------------------------------------------------------------------------


def resolve_selector(
    reg: store.Registry, selector: str, arm: Optional[str],
) -> Dict[str, Any]:
    if selector == "latest":
        if not arm:
            raise KeyError("selector 'latest' needs --arm")
        rec = reg.latest(arm)
        if rec is None:
            raise KeyError(f"no records for arm {arm!r}")
        return rec
    if selector == "last-good":
        if not arm:
            raise KeyError("selector 'last-good' needs --arm")
        rec = reg.baseline(arm)
        if rec is None:
            raise KeyError(f"no ok (non-partial) records for arm {arm!r}")
        return rec
    return reg.resolve(selector)


# ---------------------------------------------------------------------------
# Comparison / gate core
# ---------------------------------------------------------------------------


def compare_pair(
    reg: store.Registry,
    base_rec: Dict[str, Any],
    cand_rec: Dict[str, Any],
    *,
    min_effect_pct: float = stats.DEFAULT_MIN_EFFECT_PCT,
    alpha: float = stats.DEFAULT_ALPHA,
) -> Dict[str, Any]:
    """Compare two records with registry history as the noise floor.

    The report's ``verdict`` is REGRESSION when ANY comparison — primary
    throughput or a secondary metric (MFU / peak HBM /
    comms_exposed_frac, ``stats.SECONDARY_METRICS``) — verdicts one;
    otherwise it is the primary comparison's verdict.
    ``gate_comparison`` is the comparison the gate line should quote:
    the first regressed one, so a secondary-only regression fails CI
    naming ITS metric, not the healthy primary's.
    """
    arm = cand_rec.get("arm", base_rec.get("arm", "?"))
    metric_name = (cand_rec.get("metric") or {}).get("name", "tokens_per_sec")
    history = reg.history_values(
        arm, metric_name=metric_name,
        exclude_record_id=cand_rec.get("record_id"),
        match_config_of=cand_rec,
    )
    secondary_history = {
        key: reg.result_history_values(
            arm, result_key=key,
            exclude_record_id=cand_rec.get("record_id"),
            match_config_of=cand_rec,
        )
        for key, _, _, _ in stats.SECONDARY_METRICS
    }
    comparisons = stats.compare_records(
        base_rec, cand_rec, min_effect_pct=min_effect_pct, alpha=alpha,
        history=history, secondary_history=secondary_history,
    )
    regressed = [c for c in comparisons
                 if c.verdict == stats.VERDICT_REGRESSION]
    if regressed:
        verdict = stats.VERDICT_REGRESSION
        gate_comparison = regressed[0]
    else:
        verdict = (comparisons[0].verdict if comparisons
                   else stats.VERDICT_INSUFFICIENT)
        gate_comparison = comparisons[0] if comparisons else None
    return {
        "arm": arm,
        "baseline": base_rec.get("record_id"),
        "candidate": cand_rec.get("record_id"),
        "comparisons": comparisons,
        "verdict": verdict,
        "gate_comparison": gate_comparison,
    }


def format_comparison(rep: Dict[str, Any]) -> str:
    lines = [
        f"== regress compare: {rep['arm']} ==",
        f"  baseline : {rep['baseline']}",
        f"  candidate: {rep['candidate']}",
    ]
    for c in rep["comparisons"]:
        lines.append(
            f"  {c.metric}: base {c.base_mean:,.2f} -> cand "
            f"{c.cand_mean:,.2f} ({c.mode}, n={c.n_base}/{c.n_cand})"
        )
        lines.append(f"    {c.summary()}")
    lines.append(f"  VERDICT: {rep['verdict']}")
    return "\n".join(lines)


def gate_arm(
    reg: store.Registry, arm: str, *,
    baseline_sel: str = "last-good", candidate_sel: str = "latest",
    min_effect_pct: float = stats.DEFAULT_MIN_EFFECT_PCT,
    alpha: float = stats.DEFAULT_ALPHA,
    bank_regressions: bool = True,
) -> Tuple[str, str]:
    """Gate one arm; returns (verdict, human line).

    A partial candidate never verdicts (its last-window rate is not a
    run mean); a resumed (stitched) candidate never verdicts either —
    its first window folds in the restore recompile, so comparing it
    would gate the recovery machinery, not the code. A missing baseline
    is insufficient-data, not a failure — the first-ever suite run on a
    fresh registry must pass the gate.

    A REGRESSION verdict on the default last-good/latest path BANKS the
    candidate (store.Registry.bank): the next run's "last known good"
    skips the regressed record instead of adopting it, so one bad merge
    cannot silently ratchet the baseline down (ROADMAP benchreg (b)).
    """
    cand = resolve_selector(reg, candidate_sel, arm)
    if cand.get("status") != "ok":
        return (stats.VERDICT_INSUFFICIENT,
                f"regress gate: SKIP arm={arm} candidate "
                f"{cand.get('record_id')} has status="
                f"{cand.get('status')!r} (partial runs never verdict)")
    if (cand.get("result") or {}).get("resumed"):
        return (stats.VERDICT_INSUFFICIENT,
                f"regress gate: SKIP arm={arm} candidate "
                f"{cand.get('record_id')} is a resumed (stitched) run — "
                "not a clean measurement; rerun the arm for a verdict")
    if (cand.get("result") or {}).get("n_rollbacks"):
        return (stats.VERDICT_INSUFFICIENT,
                f"regress gate: SKIP arm={arm} candidate "
                f"{cand.get('record_id')} is a rolled-back (sentinel-"
                "healed) run — it hit a numerics incident and replayed "
                "steps; rerun the arm for a verdict")
    if baseline_sel == "last-good":
        base = reg.baseline(
            arm, exclude_record_id=cand.get("record_id"),
            match_config_of=cand,
        )
    else:
        base = resolve_selector(reg, baseline_sel, arm)
        if base.get("status") != "ok":
            return (stats.VERDICT_INSUFFICIENT,
                    f"regress gate: SKIP arm={arm} baseline "
                    f"{base.get('record_id')} has status="
                    f"{base.get('status')!r} (partial runs are never "
                    "baselines)")
    if base is None:
        return (stats.VERDICT_INSUFFICIENT,
                f"regress gate: SKIP arm={arm} — no prior ok record with "
                "matching config (first run on this arm)")
    rep = compare_pair(
        reg, base, cand, min_effect_pct=min_effect_pct, alpha=alpha,
    )
    # The quoted comparison is the first REGRESSED one (secondary metrics
    # included — an overlap regression fails CI by name just like a
    # tokens/sec one), falling back to the primary when nothing regressed.
    c = rep["gate_comparison"] or rep["comparisons"][0]
    line = (
        f"regress gate: {rep['verdict'].upper()} arm={arm} {c.summary()} "
        f"baseline={rep['baseline']} candidate={rep['candidate']}"
    )
    if (
        bank_regressions
        and rep["verdict"] == stats.VERDICT_REGRESSION
        and baseline_sel == "last-good" and candidate_sel == "latest"
    ):
        # Bank silently-idempotently; the bank note is its own (stable)
        # line so the REGRESSION line format stays byte-pinned.
        if reg.bank(cand.get("record_id"), reason=line):
            line += (
                f"\nregress gate: banked candidate {cand.get('record_id')} "
                "as a known regression — future last-good lookups skip it "
                "(`regress unbank` to lift)"
            )
    return rep["verdict"], line


def verdict_line_for_bench(
    reg: store.Registry, record: Dict[str, Any],
) -> str:
    """bench.py's one-line verdict vs last known good (stderr channel)."""
    arm = record["arm"]
    base = reg.baseline(
        arm, exclude_record_id=record.get("record_id"),
        match_config_of=record,
    )
    if base is None:
        return (f"regress: arm={arm} first record with this configuration "
                "— no baseline to compare against")
    rep = compare_pair(reg, base, record)
    c = rep["gate_comparison"] or rep["comparisons"][0]
    return (
        f"regress: {rep['verdict'].upper()} vs last-good arm={arm} "
        f"{c.summary()} (baseline={base.get('record_id')} from "
        f"{base.get('source', '?')})"
    )


# ---------------------------------------------------------------------------
# Bisect (benchreg follow-up (b))
# ---------------------------------------------------------------------------


def bisect_records(
    reg: store.Registry, good: Dict[str, Any], bad: Dict[str, Any],
) -> Dict[str, Any]:
    """Walk the registry between a known-good and a known-bad record and
    find the first-bad boundary, keyed by the env-fingerprint git shas.

    Both records must belong to one arm and sit in ``good`` -> ``bad``
    ingest order (the registry's ``seq`` clock). The threshold is the
    midpoint of the two endpoints' metric values (direction from the
    metric's ``higher_is_better``): each intermediate ok record is
    classified good/bad against it, and the first bad one — together
    with the last good one before it — names the git-sha boundary to
    diff. Records without the metric (partials) are listed but never
    classify.
    """
    arm = good.get("arm")
    if arm != bad.get("arm"):
        raise KeyError(
            f"bisect needs two records of one arm, got {arm!r} and "
            f"{bad.get('arm')!r}"
        )

    def _val(rec):
        m = rec.get("metric") or {}
        return m.get("value")

    g_val, b_val = _val(good), _val(bad)
    if g_val is None or b_val is None:
        raise KeyError("bisect endpoints must both carry a metric value")
    higher_better = bool(
        (good.get("metric") or {}).get("higher_is_better", True)
    )
    threshold = (float(g_val) + float(b_val)) / 2.0

    recs = reg.records(arm)
    ids = [r.get("record_id") for r in recs]
    try:
        i_good, i_bad = ids.index(good.get("record_id")), ids.index(
            bad.get("record_id")
        )
    except ValueError:
        raise KeyError("bisect endpoints must both be ingested records "
                       f"of arm {arm!r}")
    if i_good >= i_bad:
        raise KeyError(
            "bisect walks ingest order: the good record must precede the "
            f"bad one (got seq {i_good} -> {i_bad})"
        )

    rows: List[Dict[str, Any]] = []
    last_good = good
    first_bad: Optional[Dict[str, Any]] = None
    for rec in recs[i_good: i_bad + 1]:
        val = _val(rec)
        verdict = None
        if rec.get("status") == "ok" and val is not None:
            is_bad = (val < threshold) if higher_better else (val > threshold)
            verdict = "bad" if is_bad else "good"
        rows.append({
            "record_id": rec.get("record_id"),
            "git_sha": (rec.get("env") or {}).get("git_sha"),
            "value": val,
            "status": rec.get("status"),
            "verdict": verdict,
        })
        if verdict == "good" and first_bad is None:
            last_good = rec
        elif verdict == "bad" and first_bad is None:
            first_bad = rec
    return {
        "arm": arm,
        "metric": (good.get("metric") or {}).get("name"),
        "threshold": threshold,
        "rows": rows,
        "last_good": last_good,
        "first_bad": first_bad,
    }


def format_bisect(rep: Dict[str, Any]) -> str:
    lines = [
        f"== regress bisect: {rep['arm']} ({rep['metric']}, threshold "
        f"{rep['threshold']:,.2f}) ==",
    ]
    for r in rep["rows"]:
        val = f"{r['value']:,.2f}" if r["value"] is not None else "-"
        lines.append(
            f"  {r['record_id']}  sha={r['git_sha'] or '?':<10} "
            f"{val:>14}  {r['verdict'] or r['status']}"
        )
    fb = rep["first_bad"]
    lg = rep["last_good"]
    if fb is None:
        lines.append(
            "  no intermediate record classifies as bad — the regression "
            "is not reproduced between these endpoints (missing history, "
            "or a noise-level delta)"
        )
    else:
        lines.append(
            f"  FIRST BAD: {fb.get('record_id')} at git sha "
            f"{(fb.get('env') or {}).get('git_sha') or '?'} "
            f"(last good {lg.get('record_id')} at "
            f"{(lg.get('env') or {}).get('git_sha') or '?'}) — diff those "
            "shas"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Trend
# ---------------------------------------------------------------------------


def trend_rows(
    reg: store.Registry, arm: str, limit: int = 0,
) -> List[Dict[str, Any]]:
    """History table rows for one arm, oldest first.

    Delta is vs the previous OK row (partials are carried in the table —
    flagged — but neither anchor deltas nor count as best; the same
    exclusion parse_metrics applies to scaling efficiency).
    """
    recs = reg.records(arm)
    if limit:
        recs = recs[-limit:]
    banked = reg.banked_ids()
    rows: List[Dict[str, Any]] = []
    prev_ok: Optional[float] = None
    best = max(
        (r.get("metric", {}).get("value") for r in recs
         if r.get("status") == "ok"
         and r.get("metric", {}).get("value") is not None),
        default=None,
    )
    for rec in recs:
        val = rec.get("metric", {}).get("value")
        delta = None
        if rec.get("status") == "ok" and val is not None and prev_ok:
            delta = 100.0 * (val - prev_ok) / prev_ok
        rows.append({
            "record_id": rec.get("record_id"),
            "status": rec.get("status"),
            "source": rec.get("source", ""),
            "metric_name": rec.get("metric", {}).get("name"),
            "value": val,
            "delta_pct_vs_prev": delta,
            "best": (rec.get("status") == "ok" and val is not None
                     and best is not None and val == best),
            "banked": rec.get("record_id") in banked,
            "resumed": bool((rec.get("result") or {}).get("resumed")),
            "rolled_back": bool(
                (rec.get("result") or {}).get("n_rollbacks")
            ),
        })
        if rec.get("status") == "ok" and val is not None:
            prev_ok = val
    return rows


def format_trend(arm: str, rows: List[Dict[str, Any]]) -> str:
    out = [f"== regress trend: {arm} ({len(rows)} records) =="]
    for r in rows:
        val = f"{r['value']:,.2f}" if r["value"] is not None else "-"
        delta = (f"{r['delta_pct_vs_prev']:+.2f}%"
                 if r["delta_pct_vs_prev"] is not None else "      ")
        flags = ("PARTIAL" if r["status"] != "ok"
                 else "BANKED" if r.get("banked")
                 else "RESUMED" if r.get("resumed")
                 else "HEALED" if r.get("rolled_back")
                 else ("BEST" if r["best"] else ""))
        out.append(
            f"  {r['record_id']}  {val:>14} {r['metric_name'] or '':<24}"
            f" {delta:>8}  {flags:<7} {r['source']}"
        )
    return "\n".join(out)


def write_trend_png(arm: str, rows: List[Dict[str, Any]], path: str) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs = list(range(len(rows)))
    ys = [r["value"] for r in rows]
    ok = [i for i in xs if rows[i]["status"] == "ok" and ys[i] is not None]
    bad = [i for i in xs if rows[i]["status"] != "ok" and ys[i] is not None]
    fig, ax = plt.subplots(figsize=(6, 3.2), dpi=150)
    if ok:
        ax.plot([xs[i] for i in ok], [ys[i] for i in ok],
                marker="o", color="#2a78d6", linewidth=1.2, label="ok")
    if bad:
        ax.scatter([xs[i] for i in bad], [ys[i] for i in bad],
                   marker="x", color="#c0392b", label="partial")
        ax.legend(fontsize=7)
    ax.set_xlabel("ingest order")
    ax.set_ylabel(rows[0]["metric_name"] if rows else "value")
    ax.set_title(f"{arm} trend", fontsize=9)
    ax.grid(color="#d9d8d4", linewidth=0.5)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)
    return path


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m distributed_llm_training_benchmark_framework_tpu_torch"
             ".regress",
        description="benchreg: run registry + statistical regression gate "
                    "(docs/REGRESSION.md)",
    )
    p.add_argument("--registry", default=None,
                   help="registry root (default: $REGRESS_REGISTRY_TORCH or "
                        "results/registry_torch)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("ingest", help="ingest run artifacts into the registry")
    pi.add_argument("--results-dir", default=None,
                    help="suite results tree (result_<arm>.json + "
                         "partial_<arm>.json + telemetry JSONL siblings)")
    pi.add_argument("--legacy", action="store_true",
                    help="refused in the port: the repo-root BENCH_r*.json / "
                         "MULTICHIP_r*.json snapshots are TPU-era records")
    pi.add_argument("--root", default=None,
                    help="snapshot directory for --legacy (default: repo root)")

    pc = sub.add_parser("compare", help="compare two records")
    pc.add_argument("a", help="baseline: record-id prefix | latest | last-good")
    pc.add_argument("b", help="candidate: record-id prefix | latest | last-good")
    pc.add_argument("--arm", default=None,
                    help="required when a selector is latest/last-good")
    pc.add_argument("--min-effect-pct", type=float,
                    default=stats.DEFAULT_MIN_EFFECT_PCT)
    pc.add_argument("--alpha", type=float, default=stats.DEFAULT_ALPHA)

    pt = sub.add_parser("trend", help="history table (+PNG) for one arm")
    pt.add_argument("arm")
    pt.add_argument("--png", default=None, help="write a trend PNG here")
    pt.add_argument("--limit", type=int, default=0,
                    help="only the newest N records (0 = all)")

    pg = sub.add_parser("gate", help="fail (exit 1) on significant regression")
    pg.add_argument("--baseline", default="last-good",
                    help="baseline selector (default last-good)")
    pg.add_argument("--candidate", default="latest",
                    help="candidate selector (default latest)")
    pg.add_argument("--arm", default=None, help="gate one arm")
    pg.add_argument("--all", action="store_true",
                    help="gate every arm's latest vs its last-good")
    pg.add_argument("--min-effect-pct", type=float,
                    default=stats.DEFAULT_MIN_EFFECT_PCT)
    pg.add_argument("--alpha", type=float, default=stats.DEFAULT_ALPHA)

    pbi = sub.add_parser(
        "bisect",
        help="walk env fingerprints (git shas) between a good and a bad "
             "record and print the first-bad boundary",
    )
    pbi.add_argument("good", help="known-good: record-id prefix | last-good")
    pbi.add_argument("bad", help="known-bad: record-id prefix | latest")
    pbi.add_argument("--arm", default=None,
                     help="required when a selector is latest/last-good")

    sub.add_parser("list", help="list arms and record counts")

    pb = sub.add_parser(
        "bank",
        help="mark a record as a known regression (last-good skips it)",
    )
    pb.add_argument("record_id", help="record-id prefix")
    pb.add_argument("--reason", default="operator-banked")

    pu = sub.add_parser("unbank", help="lift a bank")
    pu.add_argument("record_id", help="record-id prefix")
    pu.add_argument("--reason", default="operator-unbanked")

    args = p.parse_args(argv)

    try:
        reg = store.Registry(args.registry)
    except store.SchemaDrift as e:
        print(f"regress: {e}", file=sys.stderr)
        return 2

    try:
        if args.cmd == "ingest":
            if not args.legacy and not args.results_dir:
                p.error("ingest needs --results-dir and/or --legacy")
            ingested: List[Tuple[Dict[str, Any], bool]] = []
            if args.legacy:
                ingested += store.ingest_legacy(reg, args.root)
            if args.results_dir:
                ingested += store.ingest_results_dir(reg, args.results_dir)
            created = sum(1 for _, c in ingested if c)
            print(f"regress ingest: {len(ingested)} artifact(s) scanned, "
                  f"{created} new record(s) -> {reg.root}")
            for rec, c in ingested:
                if c:
                    print(f"  + {rec['arm']} {rec['record_id']} "
                          f"[{rec['status']}] from {rec.get('source', '')}")
            return 0

        if args.cmd == "compare":
            a = resolve_selector(reg, args.a, args.arm)
            b = resolve_selector(reg, args.b, args.arm)
            rep = compare_pair(
                reg, a, b, min_effect_pct=args.min_effect_pct,
                alpha=args.alpha,
            )
            print(format_comparison(rep))
            return 1 if rep["verdict"] == stats.VERDICT_REGRESSION else 0

        if args.cmd == "bisect":
            good = resolve_selector(reg, args.good, args.arm)
            bad = resolve_selector(reg, args.bad, args.arm)
            rep = bisect_records(reg, good, bad)
            print(format_bisect(rep))
            return 0

        if args.cmd == "trend":
            rows = trend_rows(reg, args.arm, limit=args.limit)
            if not rows:
                print(f"regress trend: no records for arm {args.arm!r} "
                      f"in {reg.root}", file=sys.stderr)
                return 2
            print(format_trend(args.arm, rows))
            if args.png:
                print(f"Wrote {write_trend_png(args.arm, rows, args.png)}")
            return 0

        if args.cmd == "gate":
            if args.all:
                arms = [a for a in reg.arms()]
            elif args.arm:
                arms = [args.arm]
            else:
                p.error("gate needs --arm or --all")
            n_regressions = 0
            for arm in arms:
                verdict, line = gate_arm(
                    reg, arm, baseline_sel=args.baseline,
                    candidate_sel=args.candidate,
                    min_effect_pct=args.min_effect_pct, alpha=args.alpha,
                )
                print(line)
                if verdict == stats.VERDICT_REGRESSION:
                    n_regressions += 1
            # The summary names the secondary-metric roster so a gate
            # transcript is self-describing about WHAT was policed —
            # scripts/regress_gate.sh surfaces this line as its verdict.
            secondaries = ", ".join(
                key for key, _hib, _eff, _scale in stats.SECONDARY_METRICS
            )
            print(f"regress gate: {len(arms)} arm(s) checked, "
                  f"{n_regressions} regression(s) "
                  f"(secondaries gated: {secondaries})")
            return 1 if n_regressions else 0

        if args.cmd == "list":
            banked = reg.banked_ids()
            for arm in reg.arms():
                lines = [l for l in reg.index_lines() if l["arm"] == arm]
                n_ok = sum(1 for l in lines if l["status"] == "ok")
                n_banked = sum(1 for l in lines
                               if l["record_id"] in banked)
                extra = f", {n_banked} banked" if n_banked else ""
                print(f"{arm}: {len(lines)} record(s) ({n_ok} ok{extra})")
            return 0

        if args.cmd in ("bank", "unbank"):
            rec = reg.resolve(args.record_id)
            if args.cmd == "bank":
                changed = reg.bank(rec["record_id"], reason=args.reason)
                verb = "banked" if changed else "already banked"
            else:
                changed = reg.unbank(rec["record_id"], reason=args.reason)
                verb = "unbanked" if changed else "was not banked"
            print(f"regress {args.cmd}: {rec['arm']} {rec['record_id']} "
                  f"{verb}")
            return 0
    except store.SchemaDrift as e:
        print(f"regress: {e}", file=sys.stderr)
        return 2
    except store.LegacyRefused as e:
        print(f"regress: {e}", file=sys.stderr)
        return 2
    except KeyError as e:
        print(f"regress: {e.args[0] if e.args else e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
