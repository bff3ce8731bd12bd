#!/usr/bin/env python
"""Reconstruct a run timeline from its flight-recorder telemetry JSONL.

The write side is ``telemetry.TelemetryRecorder`` (threaded through
``train/loop.py``); this is the read side — everything an operator needs
to answer "where did the run's time go, and how was it doing when it
died" from the JSONL alone:

- **timeline**: the phase intervals (init/compile/warmup/timed/
  checkpoint/trace/finalize) in run order, with an ASCII gantt bar;
- **phase attribution**: per-phase totals as a fraction of wall time —
  the compile-vs-timed split that a single tokens/sec number hides;
- **trajectories**: loss / window step time / allocator HBM over the
  run's sync windows (``--plots-out`` renders PNGs; the text report
  always carries the endpoints and extrema);
- **anomalies**: NaN-loss and step-time-spike events, with whether they
  resolved;
- **profiler join** (``--profile-dir``): lines the JSONL's host-clock
  step windows up against the trace's device steps from
  ``profile_summary`` (the ``ProfilerStep#N`` windows on the card), so
  host-side overhead (dispatch, sync, python) is separable from device
  time, and names the op class that grew in each step-time spike the
  trace covered (``step_anatomy.per_step_op_classes``). ``--run`` picks a
  run when the profile dir holds several;
- **cross-run comparison** (``--compare A.jsonl B.jsonl``): per-phase
  wall-time deltas plus timed-window step-time/throughput distributions
  with significance verdicts, delegated to the ``regress.stats`` engine
  (the registry gate's statistics — one implementation, two views).

Works on aborted/truncated files: a run killed mid-write still renders a
partial timeline (that is the point of a flight recorder).

    python -m distributed_llm_training_benchmark_framework_tpu_torch.analysis.telemetry_report \
        --telemetry results/run_results/telemetry_zero2_ws4_seq2048_tierA.jsonl \
        [--profile-dir /tmp/prof [--run <name>]] [--plots-out plots/]

Port of ``distributed_llm_training_benchmark_framework_tpu/analysis/telemetry_report.py``
over the port's telemetry and ``torch.profiler`` traces: the same
timeline, report text, rank merge, comparison, plots and joins.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Any, Dict, List, Optional

from ..telemetry import (
    PHASES,
    is_rank_sibling,
    rank_telemetry_files,
    read_events,
)

# ---------------------------------------------------------------------------
# Timeline reconstruction
# ---------------------------------------------------------------------------


def build_timeline(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """-> {meta, intervals, phase_times, windows, anomalies, end, wall}.

    ``intervals`` is the ordered list of ``{phase, start_rel, end_rel}``
    (an interval left open by a crash is closed at the last event's
    ``rel``); ``phase_times`` sums them per phase; ``end`` is the
    ``run_end``/``run_aborted`` event when one exists.
    """
    meta: Dict[str, Any] = {}
    intervals: List[Dict[str, Any]] = []
    windows: List[Dict[str, Any]] = []
    anomalies: List[Dict[str, Any]] = []
    data_events: List[Dict[str, Any]] = []
    end: Optional[Dict[str, Any]] = None
    open_iv: Optional[Dict[str, Any]] = None
    last_rel = 0.0
    for e in events:
        last_rel = max(last_rel, float(e.get("rel", 0.0)))
        kind = e.get("event")
        if kind == "run_meta":
            meta = e
        elif kind == "phase_begin":
            if open_iv is not None:
                open_iv["end_rel"] = e["rel"]
            open_iv = {"phase": e["phase"], "start_rel": e["rel"],
                       "end_rel": None}
            intervals.append(open_iv)
        elif kind == "phase_end":
            if open_iv is not None and open_iv["phase"] == e["phase"]:
                open_iv["end_rel"] = e["rel"]
                open_iv = None
        elif kind == "step_window":
            windows.append(e)
        elif kind in ("anomaly", "anomaly_resolved"):
            anomalies.append(e)
        elif kind in ("data_stall", "data_corrupt_record"):
            data_events.append(e)
        elif kind in ("run_end", "run_aborted"):
            end = e
    for iv in intervals:
        if iv["end_rel"] is None:
            iv["end_rel"] = last_rel  # crash left the phase open
    phase_times: Dict[str, float] = {}
    for iv in intervals:
        phase_times[iv["phase"]] = (
            phase_times.get(iv["phase"], 0.0)
            + max(iv["end_rel"] - iv["start_rel"], 0.0)
        )
    wall = float(end.get("wall_time_total_sec", last_rel)) if end else last_rel
    return {
        "meta": meta, "intervals": intervals, "phase_times": phase_times,
        "windows": windows, "anomalies": anomalies,
        "data_events": data_events, "end": end,
        "wall": wall,
    }


def hbm_timeline_lines(
    windows: List[Dict[str, Any]], width: int = 44,
) -> List[str]:
    """The HBM high-water timeline across a run's sync windows.

    Memory-anatomy round: the recorder samples the allocator's peak (and
    live bytes-in-use) per window, so a run's memory trajectory — when
    the high-water mark was set, how close to it the steady state runs —
    is reconstructible from the heartbeat/JSONL channel alone, mid-run
    or post-mortem. Renders an ASCII sparkline scaled to the run's own
    maximum plus first/high-water/last figures; empty list when no
    window carried a sample (CPU backends).
    """
    pts = [(w.get("step"), w.get("peak_hbm_bytes"), w.get("hbm_bytes_in_use"))
           for w in windows if w.get("peak_hbm_bytes") is not None]
    if not pts:
        return []
    peaks = [p for _s, p, _c in pts]
    hi = max(peaks) or 1
    levels = " .:-=+*#%@"
    spark = "".join(
        levels[min(int(p / hi * (len(levels) - 1)), len(levels) - 1)]
        for _s, p, _c in pts[-width:]
    )
    hw_step = next(s for s, p, _c in pts if p == max(peaks))
    out = [
        f"  HBM high-water timeline ({len(pts)} sampled windows): "
        f"first {peaks[0] / 2**30:.2f} GiB -> high-water "
        f"{max(peaks) / 2**30:.2f} GiB @ step {hw_step} -> last "
        f"{peaks[-1] / 2**30:.2f} GiB",
        f"    |{spark}|",
    ]
    in_use = [c for _s, _p, c in pts if c is not None]
    if in_use:
        out.append(
            f"    live bytes-in-use: last {in_use[-1] / 2**30:.2f} GiB "
            f"({100.0 * in_use[-1] / hi:.0f}% of the high-water mark)"
        )
    return out


def data_stall_timeline_lines(
    events: List[Dict[str, Any]],
    windows: List[Dict[str, Any]],
    width: int = 44,
) -> List[str]:
    """The input-starvation timeline across a run's sync windows.

    Streaming round: stream runs stamp each ``step_window`` with
    ``data_wait_sec`` (the loop's measured wait for that window's
    batches), so the stall trajectory sits beside the HBM high-water line
    in the same JSONL-only report. Renders a sparkline of the per-window
    wait fraction plus the totals, the quarantine count, and any
    ``data_stall`` events (non-fatal window stalls and the fatal
    classification). Empty list for synthetic runs (no window carries the
    field).
    """
    pts = []
    for w in windows:
        wait = w.get("data_wait_sec")
        if wait is None:
            continue
        wall = (
            (w.get("window_mean_step_time_sec") or 0.0)
            * (w.get("steps_in_window") or 1)
        )
        pts.append((w.get("step"), float(wait), wall))
    if not pts:
        return []
    levels = " .:-=+*#%@"
    fracs = [min(wait / wall, 1.0) if wall > 0 else 0.0
             for _s, wait, wall in pts]
    spark = "".join(
        levels[min(int(fr * (len(levels) - 1)), len(levels) - 1)]
        for fr in fracs[-width:]
    )
    total_wait = sum(wait for _s, wait, _w in pts)
    total_wall = sum(wall for _s, _w2, wall in pts)
    frac = total_wait / total_wall if total_wall > 0 else 0.0
    out = [
        f"  Data-stall timeline ({len(pts)} sampled windows): "
        f"{total_wait:.2f}s waiting on input over {total_wall:.2f}s of "
        f"windows ({100.0 * frac:.1f}%)",
        f"    |{spark}|",
    ]
    stalls = [e for e in events if e.get("event") == "data_stall"]
    if stalls:
        fatal = [e for e in stalls if e.get("fatal")]
        out.append(
            f"    data_stall events: {len(stalls)}"
            + (f" (FATAL at step {fatal[-1].get('step')} — run classified "
               "reason=data_stall)" if fatal else " (all transient)")
        )
    skipped = [w.get("records_skipped") for w in windows
               if w.get("records_skipped") is not None]
    if skipped and skipped[-1]:
        out.append(
            f"    records skipped/quarantined: {skipped[-1]} "
            "(data_corrupt_record events carry the ledger)"
        )
    return out


def _gantt_bar(iv: Dict[str, Any], wall: float, width: int = 44) -> str:
    if wall <= 0:
        return ""
    a = int(round(iv["start_rel"] / wall * width))
    b = max(int(round(iv["end_rel"] / wall * width)), a + 1)
    return " " * a + "#" * min(b - a, width - a)


def format_report(tl: Dict[str, Any]) -> str:
    out: List[str] = []
    meta, end, wall = tl["meta"], tl["end"], tl["wall"]
    arm = meta.get("arm", "?")
    out.append(f"== Telemetry: {arm} ==")
    if meta:
        out.append(
            "  run: "
            + " ".join(
                f"{k}={meta[k]}" for k in (
                    "strategy", "world_size", "seq_len", "tier",
                    "model_family", "total_steps",
                ) if k in meta
            )
        )
    if end is None:
        out.append("  STATUS: no run_end/run_aborted event — process was "
                   "killed outright; timeline below ends at the last sync")
    elif end["event"] == "run_aborted":
        out.append(f"  STATUS: ABORTED in phase {end.get('phase')!r} at "
                   f"step {end.get('last_step')} — {end.get('reason')}")
    else:
        out.append(f"  STATUS: completed ({end.get('status')}), "
                   f"last step {end.get('last_step')}")

    out.append("")
    out.append(f"== Timeline (wall {wall:.2f}s) ==")
    for iv in tl["intervals"]:
        dur = iv["end_rel"] - iv["start_rel"]
        out.append(
            f"  {iv['phase']:>10}  {iv['start_rel']:8.2f}s ->"
            f" {iv['end_rel']:8.2f}s ({dur:7.2f}s)  |{_gantt_bar(iv, wall)}"
        )

    out.append("")
    out.append("== Phase attribution ==")
    total = sum(tl["phase_times"].values()) or 1.0
    for phase in PHASES:
        if phase not in tl["phase_times"]:
            continue
        sec = tl["phase_times"][phase]
        out.append(f"  {100.0 * sec / wall if wall else 0:5.1f}%  "
                   f"{sec:9.3f}s  {phase}")
    covered = 100.0 * total / wall if wall else 0.0
    out.append(f"  (phases cover {covered:.1f}% of wall time)")

    ws = tl["windows"]
    if ws:
        losses = [w["loss"] for w in ws if w.get("loss") is not None]
        dts = sorted(w["window_mean_step_time_sec"] for w in ws)
        hbm = [w["peak_hbm_bytes"] for w in ws
               if w.get("peak_hbm_bytes") is not None]
        out.append("")
        out.append(f"== Trajectories ({len(ws)} sync windows, last step "
                   f"{ws[-1]['step']}) ==")
        if losses:
            out.append(f"  loss: first {losses[0]:.4f} -> last "
                       f"{losses[-1]:.4f} (min {min(losses):.4f})")
        out.append(
            f"  window mean step time: median {dts[len(dts) // 2]:.4f}s, "
            f"max {dts[-1]:.4f}s"
        )
        out.append(f"  cumulative tokens/sec: {ws[-1]['tokens_per_sec']:,.0f}"
                   f" ({ws[-1]['cum_tokens']:,} tokens)")
        if hbm:
            out.append(f"  peak HBM (allocator): {max(hbm) / 1e9:.2f} GB")
        out.extend(hbm_timeline_lines(ws))
        out.extend(data_stall_timeline_lines(tl.get("data_events", []), ws))

    if tl["anomalies"]:
        out.append("")
        out.append(f"== Anomalies ({len(tl['anomalies'])} events) ==")
        # A spike's opening event must not read as OPEN when a later
        # anomaly_resolved event closed it.
        resolved_opens = {
            a.get("opened_at_step") for a in tl["anomalies"]
            if a["event"] == "anomaly_resolved"
        }
        for a in tl["anomalies"]:
            if a["event"] == "anomaly_resolved":
                tag = "resolved"
            elif a.get("kind") == "step_time_spike":
                tag = ("resolved later" if a.get("step") in resolved_opens
                       else "OPEN")
            else:
                tag = "UNRESOLVED"
            out.append(f"  step {a.get('step')}: {a.get('kind')} [{tag}] "
                       f"{a.get('detail', '')}")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Per-rank merge (multi-host runs)
# ---------------------------------------------------------------------------


def merge_rank_timelines(
    path: str, rank0_tl: Optional[Dict[str, Any]] = None
) -> Dict[int, Dict[str, Any]]:
    """{rank: timeline} for a rank-0 telemetry file and its rank siblings.

    Multi-host runs stream one ``telemetry_<arm>.rank<r>.jsonl`` per
    non-zero rank beside the canonical file (telemetry.telemetry_filename)
    — merging them is what makes a straggling or preempted NON-ZERO rank
    visible directly instead of only through rank 0's window times.
    Unreadable rank files are skipped (a SIGKILL'd rank's torn tail is
    already tolerated by read_events). ``rank0_tl`` lets a caller that
    already built the canonical file's timeline skip re-reading it.
    """
    out: Dict[int, Dict[str, Any]] = {}
    for rank, rpath in sorted(rank_telemetry_files(path).items()):
        if rank == 0 and rank0_tl is not None:
            out[0] = rank0_tl
            continue
        try:
            events = read_events(rpath)
        except (OSError, ValueError):
            continue
        if events:
            out[rank] = build_timeline(events)
    return out


def format_rank_merge(ranks: Dict[int, Dict[str, Any]]) -> str:
    """Straggler/preemption table across a run's per-rank streams."""
    out: List[str] = [f"== Per-rank telemetry ({len(ranks)} ranks) =="]
    max_step = max(
        (tl["windows"][-1]["step"] for tl in ranks.values() if tl["windows"]),
        default=None,
    )
    for rank, tl in sorted(ranks.items()):
        end = tl["end"]
        last_step = tl["windows"][-1]["step"] if tl["windows"] else None
        if end is None:
            status = "KILLED (no terminal event)"
        elif end["event"] == "run_aborted":
            status = f"aborted: {end.get('reason')}"
        else:
            status = f"completed ({end.get('status')})"
        straggle = ""
        if (
            max_step is not None and last_step is not None
            and last_step < max_step
        ):
            straggle = f"  <-- straggler ({max_step - last_step} steps behind)"
        out.append(
            f"  rank {rank}: last step "
            f"{'-' if last_step is None else last_step}, wall "
            f"{tl['wall']:.2f}s, {status}{straggle}"
        )
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Profiler join
# ---------------------------------------------------------------------------


def join_profile(
    tl: Dict[str, Any], profile_dir: str, run: Optional[str] = None
) -> str:
    """Line the JSONL host-clock windows up against the device step lane."""
    from . import profile_summary as ps

    trace = ps.find_trace_file(profile_dir, run=run)
    if trace is None:
        return f"== Profiler join ==\n  no trace under {profile_dir}"
    s = ps.summarize(ps.load_events(trace))
    dev = sorted(s["step_durs_us"])
    out = ["== Profiler join ==", f"  trace: {trace}"]
    if not dev:
        out.append("  trace has no device step lane (no device op inside a "
                   "ProfilerStep#N marker)")
        return "\n".join(out)
    dev_med = dev[len(dev) // 2] / 1e6
    # Only the timed windows are comparable: the trace starts after warmup
    # (train/loop.py starts it at the warmup boundary), so compile/warmup
    # windows would skew the host-side median.
    host = sorted(
        w["window_mean_step_time_sec"] for w in tl["windows"]
        if w.get("phase") == "timed"
    ) or sorted(w["window_mean_step_time_sec"] for w in tl["windows"])
    out.append(f"  device steps traced: {len(dev)}, median {dev_med:.4f}s")
    if not host:
        # JAX's join indexes an empty list here; a telemetry file with no
        # step window (a run killed before its first fence) has nothing
        # to line up.
        out.append("  telemetry windows:   0 (no step window to compare)")
        return "\n".join(out)
    host_med = host[len(host) // 2]
    overhead = host_med - dev_med
    out.append(f"  telemetry windows:   {len(host)}, median host step "
               f"{host_med:.4f}s")
    out.append(
        f"  host-side overhead:  {overhead:+.4f}s/step "
        f"({100.0 * overhead / host_med if host_med else 0:.1f}% of the "
        "host step — dispatch, sync RPCs, python)"
    )
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Anomaly <-> trace join (telemetry follow-up (b))
# ---------------------------------------------------------------------------


def _match_traced_step(
    anomaly: Dict[str, Any],
    window: Optional[Dict[str, Any]],
    traced: List[Dict[str, Any]],
) -> Optional[Dict[str, Any]]:
    """The traced step covering one spike anomaly, or None.

    Two rungs: the trace's step names ARE the loop's step numbers
    (``ProfilerStep#N``), so an exact name match wins; otherwise the spike
    window's wall-clock span (the ``step_window`` event's unix ``ts``,
    trace ``ts`` in epoch microseconds) catches traces whose step counter
    restarted.
    """
    step = anomaly.get("step")
    for t in traced:
        try:
            if int(t["step"]) == step:
                return t
        except (TypeError, ValueError):
            pass
    if window is not None and window.get("ts"):
        n = window.get("steps_in_window", 1) or 1
        dt = window.get("window_mean_step_time_sec", 0.0) or 0.0
        hi = float(window["ts"]) * 1e6
        lo = hi - n * dt * 1e6
        for t in traced:
            mid = (t["t0"] + t["t1"]) / 2.0
            if lo <= mid <= hi:
                return t
    return None


def join_anomaly_trace(
    tl: Dict[str, Any], profile_dir: str, run: Optional[str] = None
) -> Optional[str]:
    """Name the op class that grew in each spiked step vs the median step.

    Auto-joins the recorder's ``step_time_spike`` anomalies against the
    profiler trace whenever ``--profile-dir`` covered the spike window:
    the spiked step's per-op-class self time is compared against the
    per-class median over the other traced steps, and the class with the
    largest growth is named — the triage answer ("the all-reduce grew,
    not the matmuls") that used to require a by-hand trace read. Returns
    None when the run recorded no spikes.
    """
    spikes = [a for a in tl["anomalies"]
              if a.get("event") == "anomaly"
              and a.get("kind") == "step_time_spike"]
    if not spikes:
        return None
    from . import step_anatomy as sa

    out = ["== Anomaly <-> trace join =="]
    traces = sa.discover_traces(profile_dir, run=run)
    if 0 not in traces:
        out.append(f"  no trace under {profile_dir} — spikes not joinable")
        return "\n".join(out)
    from . import profile_summary as ps

    traced = sa.per_step_op_classes(ps.load_events(traces[0]))
    if len(traced) < 2:
        out.append("  trace holds < 2 device steps — no median to compare "
                   "a spike against")
        return "\n".join(out)
    windows_by_step = {w.get("step"): w for w in tl["windows"]}
    for a in spikes:
        target = _match_traced_step(a, windows_by_step.get(a.get("step")),
                                    traced)
        if target is None:
            out.append(
                f"  spike at step {a.get('step')}: outside the traced "
                "window (the profiler did not cover the spike)"
            )
            continue
        others = [t for t in traced if t is not target]
        growth: List[tuple] = []
        for cls, dur in target["classes"].items():
            meds = sorted(t["classes"].get(cls, 0.0) for t in others)
            med = meds[len(meds) // 2] if meds else 0.0
            growth.append((dur - med, med, dur, cls))
        if not growth:
            out.append(f"  spike at step {a.get('step')}: traced step has "
                       "no op self-time to attribute")
            continue
        delta, med, dur, cls = max(growth)
        ratio = f"{dur / med:.1f}x" if med > 0 else "new"
        out.append(
            f"  spike at step {a.get('step')}: '{cls}' grew {ratio} vs "
            f"the median step ({med / 1e3:.2f} ms -> {dur / 1e3:.2f} ms, "
            f"+{delta / 1e3:.2f} ms)"
        )
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Cross-run comparison (--compare A.jsonl B.jsonl)
# ---------------------------------------------------------------------------


def format_compare(rep: Dict[str, Any]) -> str:
    """Render the regress.stats.compare_telemetry report (regression
    triage across two runs — the ROADMAP telemetry follow-up (d)).

    The statistics are the regress engine's — the same seeded bootstrap
    / rank test / verdict rule the registry gate applies — so this view
    and `regress compare` can never disagree about the same two runs.
    """
    out: List[str] = ["== Telemetry compare =="]
    for tag in ("a", "b"):
        side = rep[tag]
        masked = (f" masked_windows={side['masked_windows']}"
                  if side.get("masked_windows") else "")
        out.append(
            f"  {tag.upper()}: arm={side['arm']} wall={side['wall']:.2f}s "
            f"timed_windows={side['n_timed_windows']}{masked}"
        )
    out.append("")
    out.append("== Phase delta (seconds) ==")
    out.append(f"  {'phase':>10}  {'A':>9}  {'B':>9}  {'delta':>9}  {'%':>8}")
    for row in rep["phases"]:
        a = f"{row['a_sec']:.3f}" if row["a_sec"] is not None else "-"
        b = f"{row['b_sec']:.3f}" if row["b_sec"] is not None else "-"
        d = (f"{row['delta_sec']:+.3f}" if row["delta_sec"] is not None
             else "-")
        pct = (f"{row['delta_pct']:+.1f}%" if row["delta_pct"] is not None
               else "-")
        out.append(f"  {row['phase']:>10}  {a:>9}  {b:>9}  {d:>9}  {pct:>8}")
    out.append("")
    out.append("== Timed-window distributions (regress.stats) ==")
    for c in rep["comparisons"]:
        out.append(
            f"  {c.metric}: A mean {c.base_mean:,.4f} -> B mean "
            f"{c.cand_mean:,.4f} (n={c.n_base}/{c.n_cand})"
        )
        out.append(f"    {c.summary()}")
    verdicts = [c.verdict for c in rep["comparisons"]]
    overall = verdicts[0] if verdicts else "insufficient-data"
    out.append(f"  VERDICT: {overall}")
    return "\n".join(out)


def run_compare(path_a: str, path_b: str) -> int:
    """Exit codes match `regress compare` (the same stats engine, so the
    two views must also agree as gates): 0 clean/neutral, 1 the primary
    comparison verdicts a regression, 2 unreadable input."""
    from ..regress import stats as regress_stats

    events = []
    for path in (path_a, path_b):
        try:
            evs = read_events(path)
        except (OSError, ValueError) as e:
            print(f"ERROR: cannot read {path}: {e}")
            return 2
        if not evs:
            print(f"ERROR: {path} holds no events")
            return 2
        events.append(evs)
    rep = regress_stats.compare_telemetry(events[0], events[1])
    print(f"A: {path_a}")
    print(f"B: {path_b}")
    print(format_compare(rep))
    comps = rep["comparisons"]
    primary = comps[0].verdict if comps else None
    return 1 if primary == regress_stats.VERDICT_REGRESSION else 0


# ---------------------------------------------------------------------------
# Plots (optional)
# ---------------------------------------------------------------------------


def write_plots(tl: Dict[str, Any], out_dir: str) -> List[str]:
    """Loss / step-time / HBM trajectory PNGs; returns written paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ws = tl["windows"]
    if not ws:
        return []
    os.makedirs(out_dir, exist_ok=True)
    steps = [w["step"] for w in ws]
    written: List[str] = []
    series = [
        ("loss", [w.get("loss") for w in ws], "loss",
         "telemetry_loss.png"),
        ("window mean step time (s)",
         [w["window_mean_step_time_sec"] for w in ws], "step time",
         "telemetry_step_time.png"),
        ("peak HBM (GB)",
         [None if w.get("peak_hbm_bytes") is None
          else w["peak_hbm_bytes"] / 1e9 for w in ws], "HBM",
         "telemetry_hbm.png"),
        ("HBM in use (GB)",
         [None if w.get("hbm_bytes_in_use") is None
          else w["hbm_bytes_in_use"] / 1e9 for w in ws], "HBM in use",
         "telemetry_hbm_in_use.png"),
        ("data wait (s/window)",
         [w.get("data_wait_sec") for w in ws], "input wait",
         "telemetry_data_wait.png"),
    ]
    for ylabel, ys, title, fname in series:
        pts = [(s, y) for s, y in zip(steps, ys) if y is not None]
        if not pts:
            continue
        fig, ax = plt.subplots(figsize=(6, 3.2), dpi=150)
        ax.plot([p[0] for p in pts], [p[1] for p in pts],
                color="#2a78d6", linewidth=1.2)
        ax.set_xlabel("step")
        ax.set_ylabel(ylabel)
        ax.set_title(f"{tl['meta'].get('arm', '')} {title}", fontsize=9)
        ax.grid(color="#d9d8d4", linewidth=0.5)
        for spine in ("top", "right"):
            ax.spines[spine].set_visible(False)
        fig.tight_layout()
        path = os.path.join(out_dir, fname)
        fig.savefig(path)
        plt.close(fig)
        written.append(path)
    return written


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _discover(results_dir: str) -> List[str]:
    return sorted(
        p for p in glob.glob(
            os.path.join(results_dir, "**", "telemetry_*.jsonl"),
            recursive=True,
        )
        # Rank siblings report under their rank-0 file's per-rank section,
        # not as standalone runs.
        if not is_rank_sibling(p)
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--telemetry", help="one telemetry_<arm>.jsonl file")
    src.add_argument("--results-dir",
                     help="directory searched recursively for "
                          "telemetry_*.jsonl (reports each)")
    src.add_argument("--compare", nargs=2, metavar=("A", "B"),
                     help="two telemetry JSONL files: per-phase + "
                          "per-window delta tables with significance "
                          "verdicts (regress.stats engine)")
    p.add_argument("--profile-dir", default=None,
                   help="the harness's --profile-dir: join the JSONL step "
                        "windows against the Chrome-trace device steps")
    p.add_argument("--run", default=None,
                   help="profile run to join when --profile-dir holds "
                        "several (see profile_summary --run)")
    p.add_argument("--plots-out", default=None,
                   help="directory for loss/step-time/HBM trajectory PNGs")
    args = p.parse_args(argv)

    if args.compare:
        return run_compare(args.compare[0], args.compare[1])

    paths = [args.telemetry] if args.telemetry else _discover(args.results_dir)
    if not paths:
        print(f"ERROR: no telemetry_*.jsonl under {args.results_dir}")
        return 1
    rc = 0
    for i, path in enumerate(paths):
        if i:
            print("\n" + "-" * 72 + "\n")
        try:
            events = read_events(path)
        except (OSError, ValueError) as e:
            print(f"ERROR: cannot read {path}: {e}")
            rc = 1
            continue
        if not events:
            print(f"ERROR: {path} holds no events")
            rc = 1
            continue
        tl = build_timeline(events)
        print(f"File: {path}")
        print(format_report(tl))
        ranks = merge_rank_timelines(path, rank0_tl=tl)
        if len(ranks) > 1:
            print()
            print(format_rank_merge(ranks))
        if args.profile_dir:
            print()
            try:
                print(join_profile(tl, args.profile_dir, run=args.run))
                # Spikes auto-join against the trace whenever the profile
                # dir covered them.
                anomaly_join = join_anomaly_trace(
                    tl, args.profile_dir, run=args.run
                )
                if anomaly_join:
                    print()
                    print(anomaly_join)
            except ValueError as e:
                # Bad/ambiguous --run: report and keep going — the JSONL
                # reports for the remaining files are still wanted.
                print(f"ERROR: {e}")
                rc = 1
        if args.plots_out:
            for out in write_plots(tl, args.plots_out):
                print(f"Wrote {out}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
