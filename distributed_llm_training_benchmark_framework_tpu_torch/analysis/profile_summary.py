"""Summarize a ``--profile-dir`` trace: where device time actually goes.

Port of ``distributed_llm_training_benchmark_framework_tpu/analysis/profile_summary.py``
over ``torch.profiler``'s Chrome export (kineto) instead of XLA's: per-lane
totals (host threads and the card's streams), a device op-class breakdown
with launch counts, and the top individual device ops with the CPU op that
launched each. The trace reader here (discovery, loading on the unix clock,
lanes, device events, the step windows) is shared with ``step_anatomy``:

    python -m distributed_llm_training_benchmark_framework_tpu_torch.train.harness ... \\
        --profile-dir /tmp/prof
    python -m distributed_llm_training_benchmark_framework_tpu_torch.analysis.profile_summary \\
        --profile-dir /tmp/prof --top 20

What the reader takes from a kineto export:

- **Discovery.** Traces sit at the top of the profile dir:
  ``tensorboard_trace_handler``'s ``<worker>.<ts>.pt.trace.json[.gz]`` (what
  ``train/loop.py`` writes), any bare ``*.trace.json[.gz]``, and rank
  siblings ``*.rank<r>.trace.json[.gz]`` (the telemetry's rank-file
  convention, JAX's ``_RANK_TRACE_RE``). A run is one trace file, named by
  its stem.
- **Clock.** Event ``ts`` are microseconds after the export's
  ``baseTimeNanoseconds``; ``load_events`` adds that base, so every ``ts``
  is unix-epoch microseconds, the clock of the telemetry's ``ts`` (JAX's
  traces stamp the same epoch directly).
- **Lanes** come from the ``process_name`` / ``process_labels`` /
  ``thread_name`` metadata: a GPU process is labelled "GPU n" and its
  threads are streams.
- **Device events** are the ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
  categories. ``gpu_user_annotation`` spans only annotate the card's
  timeline (a ``record_function`` range mirrored onto it) and never count
  as busy.
- **Steps.** The loop opens a ``ProfilerStep#N`` ``user_annotation`` on the
  host at each optimizer step N (``torch.profiler.profile.step``). A
  device op belongs to the step whose host span holds its launch (the
  ``cuda_runtime`` / ``cuda_driver`` call with the same ``correlation``).
  A step's device window runs from its first device op to the next step's
  first device op, so the windows tile the traced device span and a host
  gap at a step boundary is idle inside the earlier step. On an H100
  (torch 2.11) kineto mirrors each marker onto the card as a
  ``gpu_user_annotation`` from the step's first device op to its last, so
  a window starts where its mirror starts (the host span opened 1.5-5.7 ms
  earlier), and the last step ends where its mirror ends. An export
  without mirrors ends the last step at its host marker's end (the loop
  fences before it stops the trace, so that end follows the step's last
  device op) or its last op's end, whichever is later. Windows read device
  times only and the op-to-step assignment host times only: kineto's
  converted device clock can disagree with the host's (one H100 trace had
  a step's first op 21 ms before its launch), so nothing here compares the
  two, and ``step_anatomy`` clips to the telemetry's timed phase by the
  host markers.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import glob
import gzip
import json
import os
import re
import sys
from typing import Any, Dict, List, Optional, Tuple

TRACE_GLOBS = ("*.trace.json", "*.trace.json.gz")
#: Rank-sibling trace naming, mirroring the telemetry rank-file contract
#: (telemetry_<arm>.rank<r>.jsonl): <stem>.rank<r>.trace.json[.gz].
RANK_TRACE_RE = re.compile(r"\.rank(\d+)\.trace\.json(?:\.gz)?$")
_SUFFIX_RE = re.compile(r"(?:\.pt)?\.trace\.json(?:\.gz)?$")

#: kineto categories of work that ran on the card.
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
#: kineto categories of the host calls that launch device work.
LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})
STEP_MARKER_RE = re.compile(r"^ProfilerStep#(\d+)$")

#: The port's hand-written kernels (``csrc/``), most specific name first.
HAND_KERNELS = (
    "flash_fwd_bhv_kernel", "flash_fwd_kernel", "flash_bwd_dq_kernel",
    "flash_bwd_dkv_kernel", "ring_fwd_block_kernel", "fwd_layout_kernel",
    "fwd_matmul_kernel", "fwd_qscaled_kernel",
)
#: Substrings of cuBLAS / CUTLASS GEMM kernel names.
GEMM_MARKERS = ("gemm", "xmma", "cutlass", "nvjet", "cublas")
_NCCL_RE = re.compile(r"(?:^|\W)nccl[A-Z]")
_NCCL_KIND_RE = re.compile(r"nccl(?:Dev)?Kernel_([A-Za-z]+)")
#: NCCL kernel kinds on JAX's collective class names (SendRecv is the one
#: point-to-point kernel of current NCCL; older releases named Send and
#: Recv apart).
NCCL_CLASSES = {
    "AllReduce": "all-reduce", "AllGather": "all-gather",
    "ReduceScatter": "reduce-scatter", "Broadcast": "collective-broadcast",
    "SendRecv": "send/recv", "Send": "send", "Recv": "recv",
}


# ---------------------------------------------------------------------------
# Discovery and loading
# ---------------------------------------------------------------------------


def trace_files(profile_dir: str) -> List[str]:
    """Every trace file at the top of a profile dir, sorted by name."""
    out: List[str] = []
    for pattern in TRACE_GLOBS:
        out += glob.glob(os.path.join(profile_dir, pattern))
    return sorted(set(out))


def run_name(trace_file: str) -> str:
    """A trace's run name: its file name less the trace suffix."""
    return _SUFFIX_RE.sub("", os.path.basename(trace_file))


def list_profile_runs(profile_dir: str) -> List[Tuple[str, str]]:
    """All (run name, trace file) pairs under a profile dir, oldest first.

    Each ``profile`` ... ``export_chrome_trace`` writes one file, so a
    profile dir reused across benchmark arms holds several runs. Rank
    siblings belong to their rank-0 trace and are not runs of their own.
    """
    runs = [(run_name(f), f) for f in trace_files(profile_dir)
            if not RANK_TRACE_RE.search(f)]
    return sorted(runs, key=lambda kv: os.path.getmtime(kv[1]))


def find_trace_file(profile_dir: str, run: Optional[str] = None) -> Optional[str]:
    """Chrome-trace file under a profile directory.

    With one run present (the common case) its trace is returned. ``run``
    selects by run name (exact, then unique substring; ValueError naming
    the candidates otherwise), and with no selector the newest run is
    returned with the ambiguity WARNED on stderr (JAX's rule).
    """
    runs = list_profile_runs(profile_dir)
    if not runs:
        return None
    if run is not None:
        exact = [f for name, f in runs if name == run]
        if exact:
            return exact[0]
        sub = [(name, f) for name, f in runs if run in name]
        if len(sub) == 1:
            return sub[0][1]
        raise ValueError(
            f"--run {run!r} matches {len(sub)} of the profile runs in "
            f"{profile_dir}; candidates: {[name for name, _ in runs]}"
        )
    if len(runs) > 1:
        print(
            f"WARNING: {profile_dir} holds {len(runs)} profile runs; "
            "summarizing the newest. Pass --run <name> to pick one of: "
            + ", ".join(name for name, _ in runs),
            file=sys.stderr,
        )
    return runs[-1][1]


def load_trace(trace_file: str) -> Dict[str, Any]:
    """The export's JSON object, gzip or plain."""
    opener = gzip.open if trace_file.endswith(".gz") else open
    with opener(trace_file, "rt") as f:
        return json.load(f)


def load_events(trace_file: str) -> List[dict]:
    """The trace's events with ``ts`` on the unix epoch, in microseconds
    (``ts + baseTimeNanoseconds / 1000``)."""
    trace = load_trace(trace_file)
    events = trace.get("traceEvents", [])
    base_us = float(trace.get("baseTimeNanoseconds", 0) or 0) / 1e3
    if base_us:
        for e in events:
            ts = e.get("ts")
            if isinstance(ts, (int, float)):
                e["ts"] = ts + base_us
    return events


# ---------------------------------------------------------------------------
# Lanes, device events, steps
# ---------------------------------------------------------------------------


def _lane_names(events) -> Tuple[Dict[Any, str], Dict[Tuple[Any, Any], str]]:
    """({pid: process name}, {(pid, tid): thread name}); a process's
    ``process_labels`` (kineto's "GPU n") wins over its ``process_name``."""
    pids: Dict[Any, str] = {}
    labels: Dict[Any, str] = {}
    tids: Dict[Tuple[Any, Any], str] = {}
    for e in events:
        if e.get("ph") != "M":
            continue
        args = e.get("args") or {}
        if e.get("name") == "process_name":
            pids[e.get("pid")] = str(args.get("name", ""))
        elif e.get("name") == "process_labels":
            labels[e.get("pid")] = str(args.get("labels", ""))
        elif e.get("name") == "thread_name":
            tids[(e.get("pid"), e.get("tid"))] = str(args.get("name", ""))
    pids.update({pid: label for pid, label in labels.items() if label})
    return pids, tids


def is_collective_op(name: str) -> bool:
    """An NCCL kernel. gloo's collectives never reach the card."""
    return bool(_NCCL_RE.search(name))


def op_class(name: str) -> str:
    """Collapse a device op's name to a class: a hand kernel's own name
    ('flash_fwd_kernel<...>' -> 'flash_fwd_kernel'), an NCCL kernel's JAX
    collective class ('ncclDevKernel_AllReduce_Sum_f32_RING_LL' ->
    'all-reduce'), 'memcpy', 'memset', 'gemm', or 'other'."""
    for k in HAND_KERNELS:
        if k in name:
            return k
    if is_collective_op(name):
        m = _NCCL_KIND_RE.search(name)
        return NCCL_CLASSES.get(m.group(1), "nccl") if m else "nccl"
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    low = name.lower()
    if any(m in low for m in GEMM_MARKERS):
        return "gemm"
    return "other"


def _span(e: dict) -> Tuple[float, float]:
    t0 = float(e["ts"])
    return t0, t0 + float(e.get("dur", 0.0))


def device_ops(events: List[dict]) -> Dict[Any, List[dict]]:
    """{GPU pid: its kernel, memcpy and memset events}."""
    out: Dict[Any, List[dict]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and "dur" in e:
            out.setdefault(e.get("pid"), []).append(e)
    return out


def host_steps(events: List[dict]) -> List[Tuple[int, float, float]]:
    """The loop's ``ProfilerStep#N`` host spans as (N, t0, t1), in time order."""
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "user_annotation" or "dur" not in e:
            continue
        m = STEP_MARKER_RE.match(e.get("name", ""))
        if m:
            out.append((int(m.group(1)), *_span(e)))
    return sorted(out, key=lambda s: s[1])


def device_steps(
    events: List[dict], ops_by_pid: Optional[Dict[Any, List[dict]]] = None,
) -> Dict[Any, List[Tuple[str, float, float]]]:
    """{GPU pid: [(step name, t0, t1)]}: each step's device window (module
    docstring), named by the loop's step number."""
    hsteps = host_steps(events)
    if not hsteps:
        return {}
    if ops_by_pid is None:
        ops_by_pid = device_ops(events)
    launched: Dict[Any, float] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launched[corr] = float(e["ts"])
    mirrors: Dict[Tuple[Any, str], float] = {}  # (pid, marker) -> its end on the card
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "gpu_user_annotation"
                and STEP_MARKER_RE.match(e.get("name", "")) and "dur" in e):
            mirrors[(e.get("pid"), e["name"])] = _span(e)[1]
    starts = [t0 for _, t0, _ in hsteps]
    out: Dict[Any, List[Tuple[str, float, float]]] = {}
    for pid, ops in ops_by_pid.items():
        first: Dict[int, float] = {}
        last: Dict[int, float] = {}
        for e in ops:
            t_launch = launched.get((e.get("args") or {}).get("correlation"))
            if t_launch is None:
                continue
            i = bisect.bisect_right(starts, t_launch) - 1
            if i < 0 or t_launch > hsteps[i][2]:
                continue
            t0, t1 = _span(e)
            first[i] = min(first.get(i, t0), t0)
            last[i] = max(last.get(i, t1), t1)
        order = sorted(first)
        wins = []
        for j, i in enumerate(order):
            if j + 1 < len(order):
                end = first[order[j + 1]]
            else:
                end = max(mirrors.get((pid, f"ProfilerStep#{hsteps[i][0]}"), hsteps[i][2]),
                          last[i])
            wins.append((str(hsteps[i][0]), first[i], end))
        if wins:
            out[pid] = wins
    return out


# ---------------------------------------------------------------------------
# The summary
# ---------------------------------------------------------------------------


def summarize(events: List[dict], top: int = 15) -> Dict[str, object]:
    """-> {lanes, op_classes, op_counts, top_ops, step_durs_us, categories,
    n_events} aggregates (durations in us, counts in launches)."""
    pids, tids = _lane_names(events)
    lanes: collections.Counter = collections.Counter()
    categories: collections.Counter = collections.Counter()
    cpu_ops: Dict[Any, str] = {}
    launches: Dict[Any, str] = {}
    for e in events:
        categories[e.get("cat") or f"ph:{e.get('ph')}"] += 1
        if e.get("ph") != "X" or "dur" not in e:
            continue
        lanes[(pids.get(e.get("pid"), str(e.get("pid"))),
               tids.get((e.get("pid"), e.get("tid")), str(e.get("tid"))))] += e["dur"]
        args = e.get("args") or {}
        if e.get("cat") == "cpu_op" and "External id" in args:
            cpu_ops[args["External id"]] = e["name"]
        elif e.get("cat") in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = e["name"]
    ops_by_pid = device_ops(events)
    classes: collections.Counter = collections.Counter()
    counts: collections.Counter = collections.Counter()
    ops: Dict[str, List] = {}
    for dev_ops in ops_by_pid.values():
        for e in dev_ops:
            cls = op_class(e["name"])
            classes[cls] += e["dur"]
            counts[cls] += 1
            rec = ops.setdefault(e["name"], [0.0, e.get("args") or {}])
            rec[0] += e["dur"]
    steps = device_steps(events, ops_by_pid)
    step_durs = ([t1 - t0 for _, t0, t1 in steps[sorted(steps)[0]]]
                 if steps else [])

    def provenance(args) -> str:
        return (cpu_ops.get(args.get("External id"))
                or launches.get(args.get("correlation")) or "")

    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "lanes": lanes,
        "op_classes": classes,
        "op_counts": counts,
        "top_ops": [(name, dur, provenance(args)) for name, (dur, args) in top_ops],
        "step_durs_us": step_durs,
        "categories": categories,
        "n_events": len(events),
    }


def format_summary(s: Dict[str, object], top: int = 15) -> str:
    out: List[str] = []
    lanes = s["lanes"]
    out.append("== Lanes (total time) ==")
    for (p, t), dur in lanes.most_common(8):
        out.append(f"  {dur/1e6:9.3f}s  {p} / {t}")
    cls_total = sum(s["op_classes"].values()) or 1
    steps = s["step_durs_us"]
    if steps:
        steps_s = sorted(steps)
        out.append(
            f"\n== Device steps: {len(steps)} traced, "
            f"median {steps_s[len(steps_s)//2]/1e3:.2f} ms, "
            f"max {steps_s[-1]/1e3:.2f} ms =="
        )
    out.append("\n== Op classes (device) ==")
    for name, dur in s["op_classes"].most_common(20):
        out.append(f"  {100*dur/cls_total:5.1f}%  {dur/1e6:8.3f}s  "
                   f"{s['op_counts'][name]:8d}x  {name}")
    out.append(f"\n== Top {top} ops (device) ==")
    for name, dur, prov in s["top_ops"]:
        line = f"  {100*dur/cls_total:5.1f}%  {dur/1e6:8.3f}s  {name[:48]}"
        if prov:
            line += f"\n             launched by {prov[:100]}"
        out.append(line)
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--profile-dir", required=True,
                   help="the directory passed to the harness's --profile-dir")
    p.add_argument("--top", type=int, default=15,
                   help="individual ops to list with provenance")
    p.add_argument("--run", default=None,
                   help="profile run name (or unique substring) "
                        "when --profile-dir holds several runs; default: "
                        "newest, with a warning listing the candidates")
    args = p.parse_args(argv)
    # ERROR lines go to STDERR: a scripted `summary=$(... profile_summary)`
    # capture must see the failure on the terminal (and in the exit code),
    # not swallow it into the captured variable.
    try:
        trace = find_trace_file(args.profile_dir, run=args.run)
    except ValueError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    if trace is None:
        print(f"ERROR: no *.trace.json[.gz] under {args.profile_dir} "
              "(did the run include --profile-dir and >= warmup steps?)",
              file=sys.stderr)
        return 1
    print(f"Trace: {trace}")
    print(format_summary(summarize(load_events(trace), args.top), args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
