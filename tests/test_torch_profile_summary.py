"""The port's profile summary over ``torch.profiler`` traces, and a real one.

- **The reader**: discovery of ``tensorboard_trace_handler`` files, bare
  traces and rank siblings (and JAX's ``--run`` rules), gzip and plain
  JSON on the unix clock (``baseTimeNanoseconds``), the lanes from
  kineto's metadata, the device events (``gpu_user_annotation`` spans
  never busy), ``op_class`` over the port's kernels, and the step windows
  (each from its first device op to the next step's, the last to its host
  marker's end).
- **The summary** of JAX's frozen fixture rendered in torch's dialect: the
  collective classes' time and the top ops equal JAX's summary of its own
  fixture; launch counts per class; each op's provenance is the CPU op that
  launched it.
- **A real trace on the CPU**: a tier-S run through the port's harness with
  ``--profile-dir`` writes a torch trace and ``cost_analysis.json``. The
  summary lists its lanes; the step anatomy warns "no device step lane"
  and leaves the row's fields null, as JAX's CPU dryrun may; the row
  carries the memory anatomy with source ``analytic`` and the port's
  validator accepts it; ``telemetry_report --profile-dir`` prints its join.
"""

import contextlib
import io
import json
import os
import sys

import pytest

from distributed_llm_training_benchmark_framework_tpu.analysis import (
    profile_summary as jps,
)
from distributed_llm_training_benchmark_framework_tpu_torch.analysis import (
    profile_summary as tps,
    step_anatomy as tsa,
    telemetry_report as ttrep,
    validate_results as tvalid,
)
from distributed_llm_training_benchmark_framework_tpu_torch.train import harness as tharness

sys.path.insert(0, os.path.dirname(__file__))
import torch_trace_render as render  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_FROZEN = os.path.join(REPO, "tests", "fixtures", "trace_frozen")
ARM = "zero2_ws1_seq64_tierS"


@pytest.fixture(scope="module")
def frozen(tmp_path_factory):
    return render.render_dir(TRACE_FROZEN, str(tmp_path_factory.mktemp("frozen")))


# ---------------------------------------------------------------------------
# The reader
# ---------------------------------------------------------------------------


def test_discovery_layouts_and_run_filter(tmp_path, capsys):
    empty = {"traceEvents": []}
    for name in ("a_1.100.pt.trace.json", "b_2.200.pt.trace.json.gz", "bare.trace.json",
                 "bare.rank1.trace.json.gz", "notes.json"):
        render.write_trace(str(tmp_path / name), empty)
    os.utime(tmp_path / "a_1.100.pt.trace.json", (1, 1))
    assert [os.path.basename(f) for f in tps.trace_files(str(tmp_path))] == [
        "a_1.100.pt.trace.json", "b_2.200.pt.trace.json.gz", "bare.rank1.trace.json.gz",
        "bare.trace.json"]
    runs = dict(tps.list_profile_runs(str(tmp_path)))
    assert sorted(runs) == ["a_1.100", "b_2.200", "bare"]
    assert tps.list_profile_runs(str(tmp_path))[0][0] == "a_1.100"  # oldest first
    assert tps.find_trace_file(str(tmp_path), run="a_1") == runs["a_1.100"]
    with pytest.raises(ValueError, match="matches 2 of the profile runs"):
        tps.find_trace_file(str(tmp_path), run="_")
    tps.find_trace_file(str(tmp_path))
    assert "holds 3 profile runs" in capsys.readouterr().err
    assert tps.find_trace_file(str(tmp_path / "none")) is None
    assert tsa.discover_traces(str(tmp_path), run="bare") == {
        0: str(tmp_path / "bare.trace.json"), 1: str(tmp_path / "bare.rank1.trace.json.gz")}


@pytest.mark.parametrize("name", ["x.pt.trace.json", "x.pt.trace.json.gz"])
def test_load_events_puts_ts_on_the_unix_clock(tmp_path, name):
    trace = {"baseTimeNanoseconds": 1_790_857_026_000_000_000,
             "traceEvents": [{"ph": "X", "name": "a", "ts": 1_441_945_644_837.5, "dur": 2},
                             {"ph": "M", "name": "process_name", "pid": 1, "args": {}}]}
    path = render.write_trace(str(tmp_path / name), trace)
    events = tps.load_events(path)
    assert events[0]["ts"] == 1_790_857_026_000_000 + 1_441_945_644_837.5
    assert "ts" not in events[1]


def test_lanes_from_kinetos_metadata(frozen):
    events = tps.load_events(tsa.discover_traces(frozen)[0])
    pids, tids = tps._lane_names(events)
    assert pids[render.GPU_PID] == "GPU 0" and pids[render.HOST_PID] == "CPU"
    assert tids[(render.GPU_PID, render.NCCL_STREAM)] == "stream 20 "


def test_op_classes_of_the_ports_kernels():
    cases = {
        "void flash_fwd_kernel<64, false, true>(FwdParams)": "flash_fwd_kernel",
        "void flash_fwd_bhv_kernel<64, false, true>(FwdParams)": "flash_fwd_bhv_kernel",
        "void flash_bwd_dq_kernel<128, true, false, float>(BwdParams)": "flash_bwd_dq_kernel",
        "void flash_bwd_dkv_kernel<64, false, true, __nv_bfloat16>(BwdParams)":
            "flash_bwd_dkv_kernel",
        "void ring_fwd_block_kernel<64, false, true>(RingParams)": "ring_fwd_block_kernel",
        "void fwd_layout_kernel<64, 1, 2>(FwdParams)": "fwd_layout_kernel",
        "void fwd_matmul_kernel<64>(FwdParams)": "fwd_matmul_kernel",
        "void fwd_qscaled_kernel<64>(FwdParams)": "fwd_qscaled_kernel",
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n": "gemm",
        "nvjet_tst_128x64_64x8_1x2_h_bz_coopA_NTT": "gemm",
        "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64>(Params)": "gemm",
        "ncclDevKernel_ReduceScatter_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)":
            "reduce-scatter",
        "ncclKernel_AllReduce_RING_LL_Sum_float(ncclDevComm*, unsigned long, ncclWork*)":
            "all-reduce",
        "ncclDevKernel_Broadcast_RING_LL(ncclDevKernelArgsStorage<4096ul>)":
            "collective-broadcast",
        "Memcpy HtoD (Pinned -> Device)": "memcpy",
        "Memset (Device)": "memset",
        "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>":
            "other",
    }
    assert {n: tps.op_class(n) for n in cases} == cases


def test_device_steps_tile_the_device_span():
    """Step 1's host gap before step 2's first op is idle inside step 1; an
    annotation on the card is never an op; the last step ends at its host
    marker's end."""
    base = render.BASE_US + 10_000_000
    steps = [("1", base, base + 1000), ("2", base + 1500, base + 2500)]
    ops = [("fusion.1", base, base + 600), ("fusion.2", base + 1500, base + 2000)]
    trace = render.render(steps, ops)
    trace["traceEvents"].append(render._x("gpu_user_annotation", "ProfilerStep#1",
                                          render.GPU_PID, render.COMPUTE_STREAM, base,
                                          2000))
    events = trace["traceEvents"]
    for e in events:
        if "ts" in e and e["ph"] == "X":
            e["ts"] += render.BASE_US
    assert tps.device_steps(events) == {render.GPU_PID: [("1", base, base + 1500),
                                                         ("2", base + 1500, base + 2500)]}
    assert sum(len(v) for v in tps.device_ops(events).values()) == 2
    s = tps.summarize(events)
    assert s["step_durs_us"] == [1500, 1000] and s["op_counts"]["other"] == 2
    assert s["categories"]["gpu_user_annotation"] == 1
    # With kineto's mirror of the last marker on the card, the last step ends
    # where the mirror ends: the device clock alone.
    mirror = render._x("gpu_user_annotation", "ProfilerStep#2", render.GPU_PID,
                       render.COMPUTE_STREAM, base + 1500, 600)
    mirror["ts"] += render.BASE_US
    assert tps.device_steps(events + [mirror])[render.GPU_PID][-1] == ("2", base + 1500,
                                                                       base + 2100)


# ---------------------------------------------------------------------------
# The summary
# ---------------------------------------------------------------------------


def test_summary_of_the_rendered_fixture_equals_jaxs(frozen):
    port = tps.summarize(tps.load_events(tsa.discover_traces(frozen)[0]), top=3)
    jax = jps.summarize(jps.load_events(os.path.join(TRACE_FROZEN, "trace_frozen.trace.json.gz")),
                        top=3)
    for cls in ("all-reduce", "all-gather"):
        assert port["op_classes"][cls] == jax["op_classes"][cls], cls
    assert port["op_classes"]["other"] == jax["op_classes"]["fusion"]
    assert port["op_counts"] == {"other": 5, "all-reduce": 4, "all-gather": 4}
    assert jax["top_ops"][0][0] == "fusion.0"
    assert [(render.kernel_name(n), d) for n, d, _ in jax["top_ops"]] == [
        (n, d) for n, d, _ in port["top_ops"]]
    # Provenance: the CPU op that launched each kernel.
    assert [p for _, _, p in port["top_ops"]] == [
        "aten::fusion_0", "aten::fusion_1", "aten::all_reduce_5"]
    assert port["step_durs_us"][1:] == jax["step_durs_us"][1:] == [10000.0] * 4
    text = tps.format_summary(port, top=3)
    assert "GPU 0 / stream 7" in text and "launched by aten::fusion_1" in text


def test_cli_prints_the_summary_and_errors_to_stderr(frozen, tmp_path, capsys):
    assert tps.main(["--profile-dir", frozen, "--top", "2"]) == 0
    out = capsys.readouterr().out
    assert "== Op classes (device) ==" in out and "all-reduce" in out
    assert "== Device steps: 5 traced, median 10.00 ms" in out
    assert tps.main(["--profile-dir", str(tmp_path)]) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "no *.trace.json[.gz]" in captured.err
    assert tps.main(["--profile-dir", frozen, "--run", "zzz"]) == 1
    assert "ERROR: --run 'zzz'" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# A real trace on the CPU, through the harness
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cpu_trace")
    results, prof = root / "results", root / "prof"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tharness.main(["--device", "cpu", "--strategy", "zero2", "--world-size", "1",
                            "--tier", "S", "--seq-len", "64", "--steps", "5",
                            "--warmup-steps", "2", "--per-device-batch", "1", "--grad-accum",
                            # One sync window for the timed steps: a CPU host's
                            # step-time spread is not the device stability the
                            # validator's cv envelope reads.
                            "2", "--sync-every", "10", "--results-dir", str(results),
                            "--profile-dir", str(prof)])
    return {"rc": rc, "out": out.getvalue(), "results": results, "prof": prof,
            "row": json.loads((results / f"result_{ARM}.json").read_text())}


def test_cpu_run_writes_a_torch_trace_and_its_cost(cpu_run):
    assert cpu_run["rc"] == 0
    (trace,) = tps.trace_files(str(cpu_run["prof"]))
    assert trace.endswith(".pt.trace.json")
    cost = tsa.load_cost_json(os.path.join(cpu_run["prof"], tsa.COST_JSON_FILENAME))
    assert cost["scope"] == "model_flops" and cost["device_kind"] == "cpu"
    assert cost["flops"] > 0 and cost["bytes_accessed"] == 0.0
    steps = tps.host_steps(tps.load_events(trace))
    assert [n for n, _, _ in steps] == [2, 3, 4]  # the timed steps, by the loop's numbers
    assert cpu_run["row"]["time_in_trace_sec"] > 0


def test_cpu_trace_summary_lists_its_lanes(cpu_run, capsys):
    assert tps.main(["--profile-dir", str(cpu_run["prof"])]) == 0
    out = capsys.readouterr().out
    assert "== Lanes (total time) ==" in out and "CPU / thread" in out
    s = tps.summarize(tps.load_events(tps.trace_files(str(cpu_run["prof"]))[0]))
    assert s["categories"]["cpu_op"] > 0 and not s["op_classes"] and not s["step_durs_us"]


def test_cpu_run_step_anatomy_warns_and_stays_null(cpu_run):
    assert "WARNING: step-anatomy attribution skipped" in cpu_run["out"]
    assert "no device step lane" in cpu_run["out"]
    row = cpu_run["row"]
    for key in ("anatomy_compute_frac", "comms_exposed_frac", "comms_overlap_frac",
                "anatomy_idle_frac", "bubble_frac", "roofline_flops_pct_of_peak",
                "straggler_skew_pct"):
        assert row[key] is None, key


def test_cpu_row_carries_the_memory_anatomy_and_validates(cpu_run):
    row = cpu_run["row"]
    assert row["hbm_attribution_source"] == "analytic"
    assert row["hbm_measured"] is None
    assert row["hbm_measured_reason"] == "backend exposes no memory_stats()"
    assert row["hbm_model_drift_frac"] is None
    assert row["hbm_attribution"]["xla_temp"] == 0.0
    assert abs(sum(row["hbm_attribution"].values()) - row["hbm_reference_gib"]) < 0.002
    assert "== Memory anatomy (per chip) ==" in cpu_run["out"]
    path = str(cpu_run["results"] / f"result_{ARM}.json")
    assert tvalid.validate_result(row, "cpu") + tvalid.validate_telemetry(path, row, "cpu") == []
    events = [json.loads(ln) for ln in
              (cpu_run["results"] / f"telemetry_{ARM}.jsonl").read_text().splitlines()]
    kinds = [e["event"] for e in events]
    assert "memory_anatomy" in kinds and "profile_trace" in kinds
    assert "step_anatomy" not in kinds


def test_cpu_telemetry_report_prints_its_join(cpu_run, capsys):
    tel = str(cpu_run["results"] / f"telemetry_{ARM}.jsonl")
    assert ttrep.main(["--telemetry", tel, "--profile-dir", str(cpu_run["prof"])]) == 0
    out = capsys.readouterr().out
    assert "== Profiler join ==" in out
    assert "trace has no device step lane" in out
    assert "trace " in out.split("== Phase attribution ==")[1]  # the 'trace' phase
