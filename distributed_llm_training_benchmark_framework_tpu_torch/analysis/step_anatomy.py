#!/usr/bin/env python
"""Step anatomy: trace-derived compute / comms / idle attribution.

Port of ``distributed_llm_training_benchmark_framework_tpu/analysis/step_anatomy.py``
over ``torch.profiler`` traces. ``profile_summary`` answers "which ops burned
the time"; this engine answers **how much of each device step is compute,
how much is collective time — split into the fraction exposed on the
critical path vs. overlapped under compute — and how much is idle/host
gap**, plus where the arm sits on the roofline (achieved vs. peak FLOP/s,
peaks from ``utils/flops.py`` and ``utils/platform.py``).

Inputs, all captured by ``run_benchmark(profile_dir=...)`` (the harness's
and the bench's ``--profile-dir``):

- the Chrome-trace export under the profile dir (``torch.profiler`` around
  the timed window in ``train/loop.py``, rank 0 only);
- ``cost_analysis.json`` beside the trace, in JAX's schema (``flops``,
  ``bytes_accessed``, ``device_kind``, ``world_size``, ``scope``). Eager
  PyTorch has no compiler cost analysis, so the loop writes the model's
  count (``cost_from_model``): ``flops`` = ``utils.flops.
  train_flops_per_token`` x the step's global tokens, ``scope``
  "model_flops" (XLA's count also holds remat's recompute; this one does
  not), and ``bytes_accessed`` 0, which leaves the HBM roofline null;
- the run's flight-recorder JSONL (auto-discovered when one
  ``telemetry_*.jsonl`` sits inside the profile dir): its ``timed``
  phase-wall intervals clip the analysis to the timed region (a step is
  in when its host marker's midpoint is, ``device_clip``), and its
  ``run_meta`` names the pipeline schedule for the bubble-fraction row.

The device timeline (``device_timelines``): a GPU process's ops are its
kernel, memcpy and memset events, on every stream; a collective is an NCCL
kernel (``ncclDevKernel_*`` / ``ncclKernel_*``), classed on JAX's names
(AllReduce -> all-reduce, AllGather -> all-gather, ReduceScatter ->
reduce-scatter, Broadcast -> collective-broadcast, SendRecv / Send / Recv
-> send/recv, send, recv; ``profile_summary.op_class``), and any other op
counts as compute, as in JAX. gloo's collectives never reach the card:
under gloo an exchange shows as device idle (the host moves the bytes)
plus the memcpys that stage it through the host, which count as compute.
The steps are the loop's ``ProfilerStep#N`` markers on the host (its
``prof.step()`` at each optimizer step, named by the loop's own step
numbers so the telemetry report's exact-name join matches): a step's
device window runs from its first device op (the first op launched inside
its host span) to the next step's first device op, and the last step ends
where kineto's mirror of its marker on the card ends (or, in an export
without mirrors, at its host span's end: ``profile_summary``). So the
steps tile the traced device span, a host-dispatch gap at a step boundary
counts as idle, and ``compute + exposed + idle == step`` holds exactly, as
in JAX.

Decomposition per traced device step (interval arithmetic over the device
ops, clipped to the step's bounds):

- ``compute``   = union length of non-collective op intervals;
- ``exposed``   = collective-op union length NOT covered by compute;
- ``overlapped``= collective ∩ compute length (hidden under compute);
- ``idle``      = step length − union(all ops) (device gaps: host dispatch,
  pipeline bubbles, stragglers).

``compute + exposed + idle == step`` exactly (overlapped is accounted
inside compute), so the fractions are additive. ``overlap_frac`` =
overlapped / total collective time. Per-rank sibling traces
(``*.rank<r>.trace.json[.gz]``, or several GPU pids inside one trace)
join into a straggler-skew column. For pipeline arms the device-idle
fraction inside the step IS the schedule's bubble, checked against
``parallel.pipeline.pipeline_bubble_bound``.

A CPU run's trace has no device events, so the engine raises "no device
step lane" there (the loop warns and leaves the row's fields null); the
frozen fixtures, rendered in torch's dialect by the tests, exercise it
without a card.

    python -m distributed_llm_training_benchmark_framework_tpu_torch.analysis.step_anatomy \\
        --profile-dir /tmp/prof [--run NAME] [--telemetry telemetry_<arm>.jsonl] \\
        [--cost-json cost_analysis.json] [--pipeline-schedule gpipe] [--json]
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import profile_summary as ps

COST_JSON_FILENAME = "cost_analysis.json"

#: Absolute slack (fraction of step time) the measured bubble may exceed
#: the schedule's structural bound before the anatomy/structure mismatch
#: finding fires: trace idle includes host dispatch gaps the schedule
#: grid does not model, so a tight-to-the-bound run is healthy.
BUBBLE_BOUND_SLACK = 0.10

is_collective_op = ps.is_collective_op


# ---------------------------------------------------------------------------
# Interval arithmetic (all times in trace microseconds)
# ---------------------------------------------------------------------------


def merge_intervals(ivs: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Union of (start, end) intervals as a sorted disjoint list."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv for iv in ivs if iv[1] > iv[0]):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def intervals_length(ivs: Sequence[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in ivs)


def intersect_intervals(
    a: Sequence[Tuple[float, float]], b: Sequence[Tuple[float, float]]
) -> List[Tuple[float, float]]:
    """Intersection of two DISJOINT-SORTED interval lists (two-pointer)."""
    out: List[Tuple[float, float]] = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


def clip_intervals(
    ivs: Sequence[Tuple[float, float]], lo: float, hi: float
) -> List[Tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in ivs if min(b, hi) > max(a, lo)]


# ---------------------------------------------------------------------------
# Trace extraction
# ---------------------------------------------------------------------------


def device_timelines(events: List[dict]) -> Dict[Any, Dict[str, Any]]:
    """{GPU pid: {"device", "ops": [(name, t0, t1)], "steps": [...],
    "host_steps": {name: (t0, t1)}}}.

    Only GPU processes (those holding kernel, memcpy or memset events)
    count; the host lanes never enter the attribution. Steps are
    ``profile_summary.device_steps``' windows (module docstring);
    ``host_steps`` are their ``ProfilerStep#N`` spans on the host clock.
    """
    pids, _ = ps._lane_names(events)
    ops_by_pid = ps.device_ops(events)
    steps = ps.device_steps(events, ops_by_pid)
    host = {str(n): (t0, t1) for n, t0, t1 in ps.host_steps(events)}
    out: Dict[Any, Dict[str, Any]] = {}
    for pid, ops in ops_by_pid.items():
        device = pids.get(pid) or f"GPU {(ops[0].get('args') or {}).get('device', pid)}"
        out[pid] = {
            "device": device,
            "ops": [(e["name"], *ps._span(e)) for e in ops],
            "steps": steps.get(pid, []),
            "host_steps": host,
        }
    return out


#: A clip no step's midpoint lies in (lo > hi).
_NO_STEP = [(0.0, -1.0)]


def device_clip(
    dev: Dict[str, Any], clip_wall_us: Optional[Sequence[Tuple[float, float]]],
) -> Optional[List[Tuple[float, float]]]:
    """The telemetry's timed intervals (host clock) as the device windows
    of the steps whose host marker's midpoint lies inside them, for
    ``analyze_steps``: the clip reads the clock the telemetry shares,
    whatever kineto's converted device clock reads (the windows tile, so
    no other step's midpoint falls in a kept window). None without a clip;
    a clip that keeps no step stays one (``_NO_STEP``), which the caller's
    clock-base fallback then handles as JAX's does."""
    if not clip_wall_us:
        return None
    kept = [(t0, t1) for name, t0, t1 in dev["steps"]
            if name in dev["host_steps"]
            and any(lo <= sum(dev["host_steps"][name]) / 2.0 <= hi for lo, hi in clip_wall_us)]
    return kept or _NO_STEP


def per_step_op_classes(events: List[dict]) -> List[Dict[str, Any]]:
    """Per traced step: op-class self-time breakdown (first device lane).

    The anomaly↔trace join (``telemetry_report``) compares a spiked step's
    class times against the median step's to name the class that grew.
    """
    devs = device_timelines(events)
    if not devs:
        return []
    dev = devs[sorted(devs)[0]]
    out: List[Dict[str, Any]] = []
    for name, t0, t1 in sorted(dev["steps"], key=lambda s: s[1]):
        classes: collections.Counter = collections.Counter()
        for op, a, b in dev["ops"]:
            lo, hi = max(a, t0), min(b, t1)
            if hi > lo:
                classes[ps.op_class(op)] += hi - lo
        out.append({"step": name, "t0": t0, "t1": t1, "classes": classes})
    return out


# ---------------------------------------------------------------------------
# Per-step decomposition
# ---------------------------------------------------------------------------


def analyze_steps(
    ops: Sequence[Tuple[str, float, float]],
    steps: Sequence[Tuple[str, float, float]],
    clip_wall_us: Optional[Sequence[Tuple[float, float]]] = None,
) -> List[Dict[str, Any]]:
    """Decompose each traced step into compute/exposed/overlapped/idle (us).

    ``clip_wall_us`` (the telemetry timed-phase wall intervals, in trace
    microseconds) drops steps whose midpoint falls outside the timed region
    — compile/warmup steps must not dilute the attribution.
    """
    out: List[Dict[str, Any]] = []
    for name, t0, t1 in sorted(steps, key=lambda s: s[1]):
        if clip_wall_us:
            mid = (t0 + t1) / 2.0
            if not any(lo <= mid <= hi for lo, hi in clip_wall_us):
                continue
        comp_iv: List[Tuple[float, float]] = []
        coll_iv: List[Tuple[float, float]] = []
        coll_by_class: collections.Counter = collections.Counter()
        class_iv: Dict[str, List[Tuple[float, float]]] = {}
        for op, a, b in ops:
            lo, hi = max(a, t0), min(b, t1)
            if hi <= lo:
                continue
            if is_collective_op(op):
                coll_iv.append((lo, hi))
                cls = ps.op_class(op)
                coll_by_class[cls] += hi - lo
                class_iv.setdefault(cls, []).append((lo, hi))
            else:
                comp_iv.append((lo, hi))
        comp_u = merge_intervals(comp_iv)
        coll_u = merge_intervals(coll_iv)
        busy = merge_intervals(list(comp_u) + list(coll_u))
        compute = intervals_length(comp_u)
        coll_total = intervals_length(coll_u)
        overlapped = intervals_length(intersect_intervals(coll_u, comp_u))
        exposed = coll_total - overlapped
        # Per-class EXPOSED time: the class's own interval union minus the
        # part hidden under compute — this is what names WHICH collective
        # to overlap first (round-8 satellite). Classes are exposed
        # independently, so two different-class collectives overlapping
        # each other (and not compute) each count their shared time: the
        # per-class sum may slightly exceed `exposed`, which is the
        # union-accurate total.
        exposed_by_class: collections.Counter = collections.Counter()
        for cls, ivs in class_iv.items():
            u = merge_intervals(ivs)
            exp_c = (intervals_length(u)
                     - intervals_length(intersect_intervals(u, comp_u)))
            if exp_c > 0:
                exposed_by_class[cls] = exp_c
        dur = t1 - t0
        idle = max(dur - intervals_length(busy), 0.0)
        out.append({
            "step": name,
            "dur_us": dur,
            "compute_us": compute,
            "exposed_us": exposed,
            "overlapped_us": overlapped,
            "idle_us": idle,
            "coll_by_class": coll_by_class,
            "exposed_by_class": exposed_by_class,
        })
    return out


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2] if s else 0.0


# ---------------------------------------------------------------------------
# Telemetry join (timed-region clip + run meta)
# ---------------------------------------------------------------------------


def timed_wall_intervals_us(
    events: Sequence[Dict[str, Any]],
) -> List[Tuple[float, float]]:
    """Wall-clock (ts) intervals of the ``timed`` phase, in microseconds.

    The recorder's phase events carry unix ``ts``; ``profile_summary.
    load_events`` puts the torch export's ``ts`` on the same epoch (its
    ``baseTimeNanoseconds`` added), so the two clocks join directly. A
    phase left open by a crash closes at the last event's ts.
    """
    out: List[Tuple[float, float]] = []
    open_t: Optional[float] = None
    last_ts = 0.0
    for e in events:
        ts = float(e.get("ts", 0.0) or 0.0)
        last_ts = max(last_ts, ts)
        if e.get("event") == "phase_begin" and e.get("phase") == "timed":
            open_t = ts
        elif e.get("event") == "phase_end" and e.get("phase") == "timed":
            if open_t is not None:
                out.append((open_t * 1e6, ts * 1e6))
                open_t = None
    if open_t is not None:
        out.append((open_t * 1e6, last_ts * 1e6))
    return out


def telemetry_run_meta(events: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    return next((e for e in events if e.get("event") == "run_meta"), {})


# ---------------------------------------------------------------------------
# Discovery (rank-sibling aware) + cost JSON
# ---------------------------------------------------------------------------


def discover_traces(
    profile_dir: str, run: Optional[str] = None
) -> Dict[int, str]:
    """{rank: trace path} under a profile dir.

    Every ``*.trace.json[.gz]`` at the top of the dir counts (the
    ``tensorboard_trace_handler`` layout and bare traces alike);
    ``*.rank<r>.trace.json[.gz]`` siblings (one per non-zero rank, mirroring
    the telemetry rank-file convention) key by their rank, everything else
    is rank 0 (newest wins). ``run`` filters every candidate by file name —
    rank siblings included, so a multi-run dir cannot mix another run's
    rank traces into the skew — and a filter that matches NOTHING raises
    (like ``profile_summary --run``) instead of silently analyzing the
    wrong run.
    """
    cands = ps.trace_files(profile_dir)
    if run is not None and cands:
        sel = [f for f in cands if run in os.path.basename(f)]
        if not sel:
            raise ValueError(
                f"--run {run!r} matches none of the "
                f"{len(cands)} trace(s) under {profile_dir}: "
                + ", ".join(os.path.basename(f) for f in cands[:8])
            )
        cands = sel
    ranks: Dict[int, str] = {}
    plain: List[str] = []
    for f in cands:
        m = ps.RANK_TRACE_RE.search(f)
        if m:
            ranks.setdefault(int(m.group(1)), f)
        else:
            plain.append(f)
    out: Dict[int, str] = {}
    if plain:
        out[0] = max(plain, key=os.path.getmtime)
    out.update(ranks)
    return out


def cost_from_model(
    flops_per_token: float, tokens_per_step: int, *, device_kind: str = "",
    world_size: int = 1,
) -> Optional[Dict[str, Any]]:
    """The cost JSON of one optimizer step from the model's FLOP count.

    Eager PyTorch has no compiler cost analysis (JAX's
    ``cost_from_compiled``): ``flops`` is the analytic train FLOPs per token
    (``utils.flops.train_flops_per_token``) times the step's global tokens,
    ``scope`` "model_flops", and ``bytes_accessed`` 0, so the HBM roofline
    stays null. As in JAX the count covers the whole group's step;
    consumers divide by ``world_size`` for per-chip numbers. None when
    there is nothing to count.
    """
    flops = float(flops_per_token) * float(tokens_per_step)
    if flops <= 0:
        return None
    return {
        "flops": flops,
        "bytes_accessed": 0.0,
        "device_kind": device_kind,
        "world_size": int(world_size),
        "scope": "model_flops",
    }


def write_cost_json(profile_dir: str, cost: Dict[str, Any]) -> Optional[str]:
    """Drop ``cost_analysis.json`` beside the trace (best-effort)."""
    try:
        path = os.path.join(profile_dir, COST_JSON_FILENAME)
        with open(path, "w") as f:
            json.dump(cost, f, indent=2, sort_keys=True)
            f.write("\n")
        return path
    except OSError:
        return None


def load_cost_json(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            cost = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return cost if isinstance(cost, dict) else None


# ---------------------------------------------------------------------------
# The full analysis
# ---------------------------------------------------------------------------


def analyze_profile_dir(
    profile_dir: str,
    *,
    run: Optional[str] = None,
    telemetry_path: Optional[str] = None,
    cost: Optional[Dict[str, Any]] = None,
    pipeline_schedule: Optional[str] = None,
) -> Dict[str, Any]:
    """Trace(s) + optional telemetry/cost -> the step-anatomy report dict.

    Raises ValueError when no trace exists. Auto-discovers
    ``cost_analysis.json`` and a single ``telemetry_*.jsonl`` inside the
    profile dir when not given explicitly.
    """
    traces = discover_traces(profile_dir, run=run)
    if not traces:
        raise ValueError(
            f"no *.trace.json[.gz] under {profile_dir} (did the run include "
            "--profile-dir and >= warmup steps?)"
        )
    if cost is None:
        cost = load_cost_json(os.path.join(profile_dir, COST_JSON_FILENAME))
    if telemetry_path is None:
        tcands = sorted(glob.glob(
            os.path.join(profile_dir, "telemetry_*.jsonl")
        ))
        if len(tcands) == 1:
            telemetry_path = tcands[0]

    clip: Optional[List[Tuple[float, float]]] = None
    meta: Dict[str, Any] = {}
    if telemetry_path and os.path.exists(telemetry_path):
        from ..telemetry import read_events

        try:
            tev = read_events(telemetry_path)
        except (OSError, ValueError):
            tev = []
        meta = telemetry_run_meta(tev)
        clip = timed_wall_intervals_us(tev) or None

    if pipeline_schedule is None:
        if int(meta.get("pipeline_parallel", 1) or 1) > 1:
            pipeline_schedule = meta.get("pipeline_schedule") or "gpipe"

    per_rank: Dict[int, Dict[str, Any]] = {}
    clipped = False
    clip_fallback_lanes = 0
    for rank, trace in sorted(traces.items()):
        events = ps.load_events(trace)
        devs = device_timelines(events)
        rank_steps: List[Dict[str, Any]] = []
        dev_medians: List[float] = []
        for pid in sorted(devs):
            dev = devs[pid]
            steps = analyze_steps(dev["ops"], dev["steps"], device_clip(dev, clip))
            if clip and not steps:
                # Clock bases disagree (some exports stamp ts relative to
                # trace start): clipping would silently drop everything —
                # fall back to the full trace and say so.
                steps = analyze_steps(dev["ops"], dev["steps"], None)
                if steps:
                    clip_fallback_lanes += 1
            elif clip and steps:
                clipped = True
            if steps:
                dev_medians.append(_median([s["dur_us"] for s in steps]))
            rank_steps.extend(steps)
        per_rank[rank] = {
            "trace": trace,
            "n_devices": len(devs),
            "steps": rank_steps,
            "device_median_step_us": dev_medians,
        }

    all_steps = [s for r in per_rank.values() for s in r["steps"]]
    if not all_steps:
        raise ValueError(
            f"trace(s) under {profile_dir} carry no device step lane "
            "(no kernel, memcpy or memset on a GPU process inside a "
            "ProfilerStep#N marker)"
        )
    totals = {
        k: sum(s[k] for s in all_steps)
        for k in ("dur_us", "compute_us", "exposed_us", "overlapped_us",
                  "idle_us")
    }
    coll_total = totals["exposed_us"] + totals["overlapped_us"]
    dur = totals["dur_us"] or 1.0
    coll_classes: collections.Counter = collections.Counter()
    exposed_classes: collections.Counter = collections.Counter()
    for s in all_steps:
        coll_classes.update(s["coll_by_class"])
        exposed_classes.update(s.get("exposed_by_class", {}))
    n_steps = len(all_steps)
    median_step_us = _median([s["dur_us"] for s in all_steps])

    # Straggler skew across rank/device step medians: how far the slowest
    # lane's median step sits above the fastest's.
    medians = [m for r in per_rank.values()
               for m in r["device_median_step_us"]]
    skew_pct = (
        100.0 * (max(medians) - min(medians)) / min(medians)
        if len(medians) > 1 and min(medians) > 0 else None
    )
    if clipped and clip_fallback_lanes:
        # Mixing clipped lanes with full-trace fallbacks (warmup/compile
        # steps included) would mint a phantom straggler.
        skew_pct = None

    agg: Dict[str, Any] = {
        "n_steps": n_steps,
        "n_ranks": len(per_rank),
        "n_devices": sum(r["n_devices"] for r in per_rank.values()),
        "clipped_to_timed": clipped,
        # Lanes whose clock base disagreed with the telemetry epoch and
        # fell back to the full (unclipped) trace. Non-zero alongside
        # clipped_to_timed means the sample mixes clipped and unclipped
        # lanes — straggler skew is then unreliable.
        "clip_fallback_lanes": clip_fallback_lanes,
        "median_step_us": median_step_us,
        "mean_step_us": dur / n_steps,
        "compute_frac": totals["compute_us"] / dur,
        "comms_exposed_frac": totals["exposed_us"] / dur,
        "comms_overlapped_frac_of_step": totals["overlapped_us"] / dur,
        "idle_frac": totals["idle_us"] / dur,
        # Overlap fraction OF COLLECTIVE TIME: the direction-2b lever.
        "comms_overlap_frac": (
            totals["overlapped_us"] / coll_total if coll_total > 0 else None
        ),
        "straggler_skew_pct": skew_pct,
        "top_collectives": coll_classes.most_common(6),
        # Exposed time split by collective class (all-gather /
        # reduce-scatter / all-reduce / collective-permute / ...), most
        # exposed first — the table that names which collective the next
        # overlap PR should chase. Per-class values are independent
        # unions minus compute cover, so their sum can slightly exceed
        # exposed_us when different-class collectives co-expose.
        "comms_exposed_by_class": exposed_classes.most_common(6),
        "pipeline_schedule": pipeline_schedule,
        # Device idle inside the step IS the pipeline bubble when the arm
        # runs a schedule; None for non-pipeline arms.
        "bubble_frac": (
            totals["idle_us"] / dur if pipeline_schedule else None
        ),
    }

    # Schedule-auditor cross-check: the measured bubble must not exceed
    # the schedule's STRUCTURAL bound (the closed forms / scheduler
    # tables — parallel.pipeline.pipeline_bubble_bound)
    # plus measurement slack. Exceeding it is not noise: the executed
    # overlap does not match the schedule's structure, which is exactly
    # the regression an unaudited schedule would hide. Only computed when
    # the run's telemetry carries the (S, M, V) inputs; old traces
    # without them keep bubble_frac un-verdicted.
    agg["bubble_frac_bound"] = None
    agg["bubble_structure_mismatch"] = False
    if agg["bubble_frac"] is not None:
        s_stages = int(meta.get("pipeline_parallel", 0) or 0)
        m_micro = int(meta.get("grad_accum", 0) or 0)
        v_chunks = int(meta.get("virtual_stages", 1) or 1)
        if (
            agg["pipeline_schedule"] == "interleaved"
            and "virtual_stages" not in meta
        ):
            # Interleaved bounds NEED the real V (interleaving shrinks
            # the bubble, so a defaulted V=1 bound would be silently
            # loose); pre-schedule-auditor traces never recorded it —
            # leave those un-verdicted rather than mis-bounded.
            s_stages = 0
        if s_stages > 1 and m_micro > 0:
            from ..parallel.pipeline import pipeline_bubble_bound

            try:
                bound = pipeline_bubble_bound(
                    agg["pipeline_schedule"], s_stages, m_micro, v_chunks
                )
            except ValueError:
                bound = None
            if bound is not None:
                agg["bubble_frac_bound"] = round(bound, 6)
                agg["bubble_structure_mismatch"] = bool(
                    agg["bubble_frac"] > bound + BUBBLE_BOUND_SLACK
                )

    roofline: Optional[Dict[str, Any]] = None
    if cost and agg["median_step_us"] > 0:
        from ..utils import flops as flops_mod
        from ..utils import platform as platform_mod

        ws = max(int(cost.get("world_size", 1) or 1), 1)
        step_sec = agg["median_step_us"] * 1e-6
        flops_chip = float(cost.get("flops", 0.0) or 0.0) / ws
        bytes_chip = float(cost.get("bytes_accessed", 0.0) or 0.0) / ws
        kind = cost.get("device_kind", "") or ""
        peak_tflops = flops_mod.device_peak_tflops(kind)
        peak_flops = peak_tflops * 1e12 if peak_tflops else None
        peak_bw = platform_mod.device_peak_hbm_gbps(kind)
        roofline = {
            "device_kind": kind,
            "achieved_tflops_per_sec": (
                flops_chip / step_sec / 1e12 if flops_chip > 0 else None
            ),
            "achieved_hbm_gbps": (
                bytes_chip / step_sec / 1e9 if bytes_chip > 0 else None
            ),
            "peak_tflops_per_sec": (
                peak_flops / 1e12 if peak_flops else None
            ),
            "peak_hbm_gbps": peak_bw,
            "flops_pct_of_peak": (
                100.0 * flops_chip / step_sec / peak_flops
                if peak_flops and flops_chip > 0 else None
            ),
            "hbm_pct_of_peak": (
                100.0 * (bytes_chip / step_sec / 1e9) / peak_bw
                if peak_bw and bytes_chip > 0 else None
            ),
        }

    return {
        "profile_dir": profile_dir,
        "trace": per_rank[sorted(per_rank)[0]]["trace"],
        "per_rank": per_rank,
        "agg": agg,
        "roofline": roofline,
        "arm": meta.get("arm"),
    }


def exposed_by_class_fracs(report: Dict[str, Any]) -> Dict[str, float]:
    """{collective class: exposed fraction OF THE STEP}, rounded.

    The per-class payload the telemetry ``step_anatomy`` event carries
    (train/loop.py) beside the scalar result fields — NOT a
    BenchmarkResult field (``compute_result`` pins that schema), but the
    flight-recorder record of which collective class the exposed time
    belongs to.
    """
    agg = report["agg"]
    dur = agg["mean_step_us"] * agg["n_steps"]
    if dur <= 0:
        return {}
    return {
        cls: round(us / dur, 4)
        for cls, us in agg.get("comms_exposed_by_class", [])
    }


def result_fields(report: Dict[str, Any]) -> Dict[str, Any]:
    """The additive BenchmarkResult fields this report feeds.

    Keys match ``utils.metrics.BenchmarkResult``; values rounded so result
    rows and registry records stay byte-stable across identical inputs.
    """

    def r4(v):
        return round(v, 4) if v is not None else None

    agg = report["agg"]
    roof = report.get("roofline") or {}
    return {
        "anatomy_compute_frac": r4(agg["compute_frac"]),
        "comms_exposed_frac": r4(agg["comms_exposed_frac"]),
        "comms_overlap_frac": r4(agg["comms_overlap_frac"]),
        "anatomy_idle_frac": r4(agg["idle_frac"]),
        "bubble_frac": r4(agg["bubble_frac"]),
        "roofline_flops_pct_of_peak": r4(roof.get("flops_pct_of_peak")),
        "roofline_hbm_pct_of_peak": r4(roof.get("hbm_pct_of_peak")),
        "straggler_skew_pct": r4(agg["straggler_skew_pct"]),
    }


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------


def format_report(report: Dict[str, Any]) -> str:
    agg = report["agg"]
    out: List[str] = []
    arm = f" [{report['arm']}]" if report.get("arm") else ""
    out.append(f"== Step anatomy: {report['profile_dir']}{arm} ==")
    out.append(f"  trace: {report['trace']}"
               + (f" (+{agg['n_ranks'] - 1} rank sibling(s))"
                  if agg["n_ranks"] > 1 else ""))
    clip_note = ""
    if agg["clipped_to_timed"]:
        clip_note = " [clipped to telemetry timed region]"
        if agg.get("clip_fallback_lanes"):
            clip_note = (
                f" [PARTIALLY clipped: {agg['clip_fallback_lanes']} "
                "lane(s) fell back to the full trace on a clock-base "
                "mismatch — skew unreliable]"
            )
    out.append(
        f"  traced steps: {agg['n_steps']} over {agg['n_devices']} "
        f"device lane(s){clip_note}"
    )
    out.append(f"  median step: {agg['median_step_us'] / 1e3:.3f} ms")
    out.append("")
    mean_us = agg["mean_step_us"]

    def row(label, frac):
        return (f"  {label:<18} {frac * mean_us / 1e3:9.3f} ms  "
                f"{100.0 * frac:5.1f}%")

    out.append(f"  {'component':<18} {'time/step':>12}   frac")
    out.append(row("compute", agg["compute_frac"]))
    out.append(row("comms (exposed)", agg["comms_exposed_frac"]))
    ov = agg["comms_overlap_frac"]
    out.append(
        f"  {'comms (overlapped)':<18} "
        f"{agg['comms_overlapped_frac_of_step'] * mean_us / 1e3:9.3f} ms  "
        + (f"[overlap_frac {100.0 * ov:.1f}% of collective time]"
           if ov is not None else "[no collectives traced]")
    )
    out.append(row("idle / host gap", agg["idle_frac"]))
    if agg["top_collectives"]:
        per_step = agg["n_steps"] or 1
        tops = ", ".join(
            f"{name} {dur / per_step / 1e3:.3f} ms"
            for name, dur in agg["top_collectives"]
        )
        out.append("")
        out.append(f"  top collectives (per step): {tops}")
    if agg.get("comms_exposed_by_class"):
        # The overlap worklist: which collective class owns the exposed
        # time (most exposed first — chase that one).
        per_step = agg["n_steps"] or 1
        exp_total = sum(us for _cls, us in agg["comms_exposed_by_class"])
        byc = ", ".join(
            f"{cls} {us / per_step / 1e3:.3f} ms"
            + (f" ({100.0 * us / exp_total:.0f}%)" if exp_total > 0 else "")
            for cls, us in agg["comms_exposed_by_class"]
        )
        out.append(f"  exposed by class (per step): {byc}")
    if agg["bubble_frac"] is not None:
        line = (
            f"  bubble fraction ({agg['pipeline_schedule']}): "
            f"{100.0 * agg['bubble_frac']:.1f}%"
        )
        if agg.get("bubble_frac_bound") is not None:
            line += (
                f" (structural bound "
                f"{100.0 * agg['bubble_frac_bound']:.1f}%)"
            )
        out.append(line)
        if agg.get("bubble_structure_mismatch"):
            out.append(
                "  ANATOMY/STRUCTURE MISMATCH: measured bubble "
                f"{100.0 * agg['bubble_frac']:.1f}% exceeds the "
                f"{agg['pipeline_schedule']} schedule's structural bound "
                f"{100.0 * agg['bubble_frac_bound']:.1f}% + "
                f"{100.0 * BUBBLE_BOUND_SLACK:.0f}pp slack — the executed "
                "overlap does not match the schedule (not noise; see "
                "parallel.pipeline.pipeline_bubble_bound)"
            )
    if agg["straggler_skew_pct"] is not None:
        out.append(
            f"  straggler skew: {agg['straggler_skew_pct']:.1f}% across "
            f"{agg['n_ranks']} rank(s) / {agg['n_devices']} device lane(s)"
        )
    roof = report.get("roofline")
    if roof:
        bits = []
        if roof["achieved_tflops_per_sec"] is not None:
            s = f"{roof['achieved_tflops_per_sec']:.2f} TFLOP/s"
            if roof["flops_pct_of_peak"] is not None:
                s += (f" = {roof['flops_pct_of_peak']:.1f}% of "
                      f"{roof['peak_tflops_per_sec']:.0f} peak")
            bits.append(s)
        if roof["achieved_hbm_gbps"] is not None:
            s = f"{roof['achieved_hbm_gbps']:.1f} GB/s HBM"
            if roof["hbm_pct_of_peak"] is not None:
                s += (f" = {roof['hbm_pct_of_peak']:.1f}% of "
                      f"{roof['peak_hbm_gbps']:.0f} GB/s peak")
            bits.append(s)
        if bits:
            out.append(f"  roofline ({roof['device_kind'] or 'unknown'}): "
                       + "; ".join(bits))
    return "\n".join(out)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile-dir", required=True,
                   help="the directory passed to the harness's --profile-dir")
    p.add_argument("--run", default=None,
                   help="profile run name filter when the dir holds several")
    p.add_argument("--telemetry", default=None,
                   help="the run's telemetry_<arm>.jsonl: clips the "
                        "analysis to the timed phase and names the "
                        "pipeline schedule (auto-discovered when a single "
                        "telemetry_*.jsonl sits inside the profile dir)")
    p.add_argument("--cost-json", default=None,
                   help=f"cost-analysis JSON (default: "
                        f"{COST_JSON_FILENAME} inside the profile dir, "
                        "written by the harness)")
    p.add_argument("--pipeline-schedule", default=None,
                   help="publish the idle fraction as this schedule's "
                        "bubble (auto from telemetry run_meta when "
                        "pipeline_parallel > 1)")
    p.add_argument("--json", action="store_true",
                   help="emit the result_fields dict as one JSON line "
                        "instead of the table")
    args = p.parse_args(argv)
    cost = None
    if args.cost_json:
        cost = load_cost_json(args.cost_json)
        if cost is None:
            # An explicit --cost-json that fails to load must not fall
            # through to the auto-discovered file from some other run.
            print(f"ERROR: --cost-json {args.cost_json} missing or "
                  "unreadable", file=sys.stderr)
            return 1
    try:
        report = analyze_profile_dir(
            args.profile_dir, run=args.run, telemetry_path=args.telemetry,
            cost=cost, pipeline_schedule=args.pipeline_schedule,
        )
    except ValueError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(result_fields(report), sort_keys=True))
    else:
        print(format_report(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
