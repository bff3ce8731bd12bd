"""The port's step anatomy against JAX's.

- **Interval algebra and ``analyze_steps``**: seeded numpy timelines (ops,
  collectives, steps, the telemetry clip) through JAX's and the port's
  functions give equal results, exactly. The port's ops carry the NCCL
  kernels' names where JAX's carry XLA's; both sides class them alike.
- **JAX's frozen fixtures in torch's dialect**: ``tests/torch_trace_render``
  renders ``tests/fixtures/trace_frozen/`` (two ranks, overlap, the clip,
  the skew) and ``trace_frozen_pipeline/`` (gpipe) as kineto exports with
  ``ProfilerStep#N`` markers and ``baseTimeNanoseconds``, beside the same
  telemetry. The port's ``analyze_profile_dir`` gives JAX's pinned
  decomposition on them (JAX's ``tests/test_step_anatomy.py``), and equals
  JAX's engine on JAX's own fixtures to 1e-9; the roofline gets the same
  25% / 50% pins from JAX's cost JSON scaled to the H100's peaks. JAX's send
  and recv both become NCCL's one point-to-point kernel, so the pipeline
  fixture's exposed time by class is JAX's two classes summed under
  ``send/recv``.
- **Row plumbing**: ``compute_result`` maps the fields and refuses unknown
  keys, as JAX's; the validator envelopes them; the cost JSON round-trips;
  the loop's helpers name the steps by the loop's own numbers.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.analysis import (
    step_anatomy as jsa,
)
from distributed_llm_training_benchmark_framework_tpu.utils import metrics as jmetrics
from distributed_llm_training_benchmark_framework_tpu_torch.analysis import (
    profile_summary as tps,
    step_anatomy as tsa,
    telemetry_report as ttrep,
    validate_results as tvalid,
)
from distributed_llm_training_benchmark_framework_tpu_torch.train import loop as tloop
from distributed_llm_training_benchmark_framework_tpu_torch.utils import metrics as tmetrics

sys.path.insert(0, os.path.dirname(__file__))
import torch_trace_render as render  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_FROZEN = os.path.join(REPO, "tests", "fixtures", "trace_frozen")
TRACE_FROZEN_PP = os.path.join(REPO, "tests", "fixtures", "trace_frozen_pipeline")
TOL = 1e-9

#: JAX's pinned attribution of the frozen fixture (its tests/test_step_anatomy.py).
FROZEN_FIELDS = {
    "anatomy_compute_frac": 0.6897,
    "comms_exposed_frac": 0.197,
    "comms_overlap_frac": 0.3333,
    "anatomy_idle_frac": 0.1133,
    "bubble_frac": None,
    "roofline_flops_pct_of_peak": 25.0,
    "roofline_hbm_pct_of_peak": 50.0,
    "straggler_skew_pct": 3.0,
}

#: (JAX op name, the port's op name) pairs of one class on both sides.
OPS = [
    ("fusion.1", "void at::native::vectorized_elementwise_kernel<4>(int)"),
    ("convolution.7", "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"),
    ("jvp_jit_flash_attention__.3", "void flash_fwd_kernel<64, false, true>(Params)"),
    ("all-reduce.5", render.NCCL_KERNELS["all-reduce"]),
    ("all-gather.3", render.NCCL_KERNELS["all-gather"]),
    ("reduce-scatter.2", render.NCCL_KERNELS["reduce-scatter"]),
    ("collective-broadcast.4", render.NCCL_KERNELS["collective-broadcast"]),
]


def _close(a, b):
    if a is None or b is None:
        return a is b
    return abs(a - b) <= TOL


# ---------------------------------------------------------------------------
# (a) interval algebra and analyze_steps on seeded timelines
# ---------------------------------------------------------------------------


def _intervals(rng, n, span=100.0):
    a = rng.uniform(0, span, n)
    return [(float(x), float(x + d)) for x, d in zip(a, rng.uniform(-2, 15, n))]


@pytest.mark.parametrize("seed", range(4))
def test_interval_algebra_equals_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = _intervals(rng, 30), _intervals(rng, 20)
    assert tsa.merge_intervals(a) == jsa.merge_intervals(a)
    ma, mb = jsa.merge_intervals(a), jsa.merge_intervals(b)
    assert tsa.intersect_intervals(ma, mb) == jsa.intersect_intervals(ma, mb)
    assert tsa.intervals_length(ma) == jsa.intervals_length(ma)
    lo, hi = sorted(float(x) for x in rng.uniform(0, 100, 2))
    assert tsa.clip_intervals(a, lo, hi) == jsa.clip_intervals(a, lo, hi)


def _timeline(seed):
    """Seeded (jax ops, port ops, steps, clip): steps of random lengths back
    to back with gaps, ops of every class landing anywhere, across step
    boundaries too."""
    rng = np.random.default_rng(100 + seed)
    bounds = np.cumsum(rng.uniform(5.0, 20.0, 9))
    steps = [(str(i), float(bounds[i]), float(bounds[i + 1] - rng.uniform(0, 2)))
             for i in range(8)]
    j_ops, t_ops = [], []
    for k, t0, d in zip(rng.integers(0, len(OPS), 120), rng.uniform(0, bounds[-1], 120),
                        rng.uniform(0.05, 6.0, 120)):
        jname, tname = OPS[k]
        j_ops.append((jname, float(t0), float(t0 + d)))
        t_ops.append((tname, float(t0), float(t0 + d)))
    clip = [(float(bounds[2]), float(bounds[6]))]
    return j_ops, t_ops, steps, clip


@pytest.mark.parametrize("clipped", [False, True], ids=["full", "clipped"])
@pytest.mark.parametrize("seed", range(4))
def test_analyze_steps_equals_jax(seed, clipped):
    j_ops, t_ops, steps, clip = _timeline(seed)
    clip = clip if clipped else None
    jax_side = jsa.analyze_steps(j_ops, steps, clip)
    port_side = tsa.analyze_steps(t_ops, steps, clip)
    assert port_side == jax_side
    assert len(port_side) == (4 if clipped else 8)
    for s in port_side:
        assert s["compute_us"] + s["exposed_us"] + s["idle_us"] == pytest.approx(s["dur_us"],
                                                                                 abs=1e-9)


def test_collective_classes_are_jaxs():
    for jname, tname in OPS:
        assert tsa.is_collective_op(tname) == jsa.is_collective_op(jname), tname
        if jsa.is_collective_op(jname):
            assert tps.op_class(tname) == jsa.ps.op_class(jname)
    sendrecv = "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"
    assert tsa.is_collective_op(sendrecv) and tps.op_class(sendrecv) == "send/recv"
    for name in ("Memcpy HtoD (Pageable -> Device)", "void flash_bwd_dq_kernel<64>()",
                 "ampere_bf16_s16816gemm", "syncncclish_kernel"):
        assert not tsa.is_collective_op(name), name


# ---------------------------------------------------------------------------
# (b) JAX's frozen fixtures rendered in torch's dialect
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def frozen(tmp_path_factory):
    return render.render_dir(TRACE_FROZEN, str(tmp_path_factory.mktemp("frozen")))


@pytest.fixture(scope="module")
def frozen_pp(tmp_path_factory):
    return render.render_dir(TRACE_FROZEN_PP, str(tmp_path_factory.mktemp("frozen_pp")))


def test_rendered_fixture_is_a_kineto_export(frozen):
    names = sorted(os.listdir(frozen))
    assert names == ["cost_analysis.json", "host_4242.1754200000000.pt.trace.json",
                     "telemetry_anatomy_frozen.jsonl", "trace_frozen.rank1.trace.json.gz"]
    trace = tps.load_trace(os.path.join(frozen, names[1]))
    assert trace["baseTimeNanoseconds"] == render.BASE_NS
    cats = {e.get("cat") for e in trace["traceEvents"]}
    assert {"kernel", "cuda_runtime", "cpu_op", "user_annotation"} <= cats
    events = tps.load_events(os.path.join(frozen, names[1]))
    steps = tps.host_steps(events)
    assert [n for n, _, _ in steps] == [0, 1, 2, 3, 4]
    # The unix clock: step 1's first device op at the fixture's T0.
    (dev,) = tps.device_steps(events).values()
    assert dev[1][:2] == ("1", 1754200000 * 1e6)


def test_frozen_fixture_attribution_pinned(frozen):
    report = tsa.analyze_profile_dir(frozen)
    assert tsa.result_fields(report) == FROZEN_FIELDS
    agg = report["agg"]
    assert agg["n_steps"] == 8 and agg["n_ranks"] == 2
    assert agg["clipped_to_timed"] is True and agg["clip_fallback_lanes"] == 0
    assert agg["median_step_us"] == 10300.0
    assert agg["top_collectives"][0][0] == "all-reduce"
    roof = report["roofline"]
    assert roof["device_kind"] == render.H100
    assert roof["peak_tflops_per_sec"] == 989.0 and roof["peak_hbm_gbps"] == 3350.0


def test_frozen_fixture_equals_jax_engine(frozen):
    """Every aggregate of the port's report on the rendered fixture equals
    JAX's on its own, to 1e-9; the roofline shares too (JAX's against TPU
    v5e's peaks, the port's against the H100's)."""
    port, jax = tsa.analyze_profile_dir(frozen), jsa.analyze_profile_dir(TRACE_FROZEN)
    for key in ("compute_frac", "comms_exposed_frac", "comms_overlapped_frac_of_step",
                "idle_frac", "comms_overlap_frac", "straggler_skew_pct", "median_step_us",
                "mean_step_us"):
        assert _close(port["agg"][key], jax["agg"][key]), key
    for key in ("n_steps", "n_ranks", "n_devices", "clipped_to_timed", "pipeline_schedule",
                "bubble_frac", "comms_exposed_by_class", "top_collectives"):
        assert port["agg"][key] == jax["agg"][key], key
    for key in ("flops_pct_of_peak", "hbm_pct_of_peak"):
        assert _close(port["roofline"][key], jax["roofline"][key]), key
    assert port["arm"] == jax["arm"] == "anatomy_frozen"
    for p_steps, j_steps in zip((r["steps"] for r in port["per_rank"].values()),
                                (r["steps"] for r in jax["per_rank"].values())):
        assert [s["step"] for s in p_steps] == [s["step"] for s in j_steps]
        for p, j in zip(p_steps, j_steps):
            for k in ("dur_us", "compute_us", "exposed_us", "overlapped_us", "idle_us"):
                assert _close(p[k], j[k]), k


def test_frozen_fixture_clip_is_load_bearing(frozen, tmp_path):
    d = shutil.copytree(frozen, str(tmp_path / "prof"))
    os.remove(os.path.join(d, "telemetry_anatomy_frozen.jsonl"))
    agg = tsa.analyze_profile_dir(d)["agg"]
    assert agg["clipped_to_timed"] is False
    assert agg["n_steps"] == 9  # the compile step joins
    assert agg["compute_frac"] > FROZEN_FIELDS["anatomy_compute_frac"]
    assert agg["comms_exposed_frac"] < FROZEN_FIELDS["comms_exposed_frac"]


def test_frozen_fixture_exposed_by_class_pinned(frozen, frozen_pp):
    report = tsa.analyze_profile_dir(frozen)
    assert report["agg"]["comms_exposed_by_class"] == [
        ("all-reduce", 12000.0), ("all-gather", 4000.0)]
    assert tsa.exposed_by_class_fracs(report) == {"all-reduce": 0.1478, "all-gather": 0.0493}
    pp = tsa.analyze_profile_dir(frozen_pp)
    jax_pp = dict(jsa.analyze_profile_dir(TRACE_FROZEN_PP)["agg"]["comms_exposed_by_class"])
    assert jax_pp == {"send": 1500.0, "recv": 1500.0}
    assert pp["agg"]["comms_exposed_by_class"] == [("send/recv", sum(jax_pp.values()))]
    loop_src = open(tloop.__file__).read()
    assert "comms_exposed_by_class" in loop_src and "exposed_by_class_fracs" in loop_src


def test_frozen_pipeline_bubble_pinned(frozen_pp):
    report = tsa.analyze_profile_dir(frozen_pp)
    fields = tsa.result_fields(report)
    assert fields["bubble_frac"] == 0.3
    assert fields["anatomy_compute_frac"] == 0.6
    assert fields["comms_exposed_frac"] == 0.1
    assert fields["comms_overlap_frac"] == 0.0
    assert report["agg"]["pipeline_schedule"] == "gpipe"
    assert fields["roofline_flops_pct_of_peak"] is None
    assert fields == jsa.result_fields(jsa.analyze_profile_dir(TRACE_FROZEN_PP))


def test_pipeline_schedule_cli_override(frozen_pp):
    report = tsa.analyze_profile_dir(frozen_pp, pipeline_schedule="1f1b")
    assert report["agg"]["pipeline_schedule"] == "1f1b"
    assert report["agg"]["bubble_frac"] == 0.3


@pytest.mark.parametrize("grad_accum,bound,mismatch", [(2, 1 / 3, False), (8, 1 / 9, True)])
def test_bubble_bound_from_the_ports_pipeline(tmp_path, grad_accum, bound, mismatch):
    """gpipe S=2: bound (S-1)/(M+S-1), from ``parallel.pipeline``; the
    measured 30% sits under 1/3 and over 1/9 + slack, as in JAX."""
    d = render.render_dir(TRACE_FROZEN_PP, str(tmp_path / "pp"),
                          meta_over={"grad_accum": grad_accum})
    report = tsa.analyze_profile_dir(d)
    agg = report["agg"]
    assert agg["bubble_frac"] == 0.3
    assert agg["bubble_frac_bound"] == pytest.approx(bound, abs=1e-6)
    assert agg["bubble_structure_mismatch"] is mismatch
    text = tsa.format_report(report)
    assert ("ANATOMY/STRUCTURE MISMATCH" in text) is mismatch
    assert "structural bound" in text
    assert tsa.analyze_profile_dir(
        render.render_dir(TRACE_FROZEN_PP, str(tmp_path / "none")))["agg"][
            "bubble_frac_bound"] is None


def test_discover_traces_rank_siblings_and_run_filter(frozen):
    traces = tsa.discover_traces(frozen)
    assert sorted(traces) == [0, 1]
    assert traces[0].endswith(".pt.trace.json")
    assert traces[1].endswith("trace_frozen.rank1.trace.json.gz")
    assert sorted(tsa.discover_traces(frozen, run="trace")) == [0, 1]
    assert sorted(tsa.discover_traces(frozen, run="host_4242")) == [0]
    with pytest.raises(ValueError, match="matches none.*host_4242"):
        tsa.discover_traces(frozen, run="no_such_run")


def test_no_trace_raises_and_missing_step_lane_raises(tmp_path):
    with pytest.raises(ValueError, match=r"no \*.trace.json\[.gz\]"):
        tsa.analyze_profile_dir(str(tmp_path))
    render.write_trace(str(tmp_path / "x.pt.trace.json"), {"traceEvents": []})
    with pytest.raises(ValueError, match="no device step lane"):
        tsa.analyze_profile_dir(str(tmp_path))


def test_cli_table_on_frozen_fixture(frozen, capsys):
    assert tsa.main(["--profile-dir", frozen]) == 0
    out = capsys.readouterr().out
    assert "compute                7.000 ms   69.0%" in out
    assert "comms (exposed)        2.000 ms   19.7%" in out
    assert "[overlap_frac 33.3% of collective time]" in out
    assert "idle / host gap        1.150 ms   11.3%" in out
    assert ("exposed by class (per step): all-reduce 1.500 ms (75%), "
            "all-gather 0.500 ms (25%)") in out
    assert "[clipped to telemetry timed region]" in out
    assert "straggler skew: 3.0% across 2 rank(s)" in out
    assert "25.0% of 989 peak" in out and "50.0% of 3350 GB/s peak" in out


def test_cli_bubble_row_and_json_mode(frozen, frozen_pp, capsys):
    assert tsa.main(["--profile-dir", frozen_pp]) == 0
    assert "bubble fraction (gpipe): 30.0%" in capsys.readouterr().out
    assert tsa.main(["--profile-dir", frozen, "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == FROZEN_FIELDS


def test_cli_errors_go_to_stderr(frozen, tmp_path, capsys):
    assert tsa.main(["--profile-dir", str(tmp_path)]) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "ERROR" in captured.err
    assert tsa.main(["--profile-dir", frozen, "--cost-json", str(tmp_path / "typo.json")]) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "typo.json" in captured.err


def test_partial_clip_fallback_is_loud_and_voids_skew(frozen, tmp_path):
    """A rank whose export's clock base disagrees with the telemetry falls
    back to its full trace; the skew is voided, as in JAX."""
    d = shutil.copytree(frozen, str(tmp_path / "prof"))
    rank1 = os.path.join(d, "trace_frozen.rank1.trace.json.gz")
    trace = tps.load_trace(rank1)
    trace["baseTimeNanoseconds"] -= 10_000 * 10**9
    render.write_trace(rank1, trace)
    report = tsa.analyze_profile_dir(d)
    agg = report["agg"]
    assert agg["clipped_to_timed"] is True and agg["clip_fallback_lanes"] == 1
    assert agg["straggler_skew_pct"] is None
    txt = tsa.format_report(report)
    assert "PARTIALLY clipped" in txt and "straggler skew" not in txt


def test_clip_reads_the_host_clock_under_a_device_clock_skew(frozen, tmp_path):
    """kineto's converted device clock can run off the host's (one H100
    trace: a step's first op 21 ms before its launch). With every device
    event 200 ms early (the kernels and kineto's mirrors of the markers on
    the card, here spanning JAX's steps), the steps' device midpoints leave
    the telemetry's timed phase, but their host markers' do not: the
    decomposition stays JAX's pins, clipped, with no lane falling back."""
    d = shutil.copytree(frozen, str(tmp_path / "prof"))
    for name, jax_name in (("host_4242.1754200000000.pt.trace.json", "trace_frozen.trace.json.gz"),
                           ("trace_frozen.rank1.trace.json.gz",
                            "trace_frozen.rank1.trace.json.gz")):
        trace = tps.load_trace(os.path.join(d, name))
        steps, _ = render.jax_timeline(os.path.join(TRACE_FROZEN, jax_name))
        trace["traceEvents"] += [
            render._x("gpu_user_annotation", f"ProfilerStep#{n}", render.GPU_PID,
                      render.COMPUTE_STREAM, t0, t1 - t0) for n, t0, t1 in steps]
        for e in trace["traceEvents"]:
            if e.get("cat") in ("kernel", "gpu_user_annotation"):
                e["ts"] -= 200_000
        render.write_trace(os.path.join(d, name), trace)
    report = tsa.analyze_profile_dir(d)
    assert tsa.result_fields(report) == FROZEN_FIELDS
    assert report["agg"]["clipped_to_timed"] is True
    assert report["agg"]["clip_fallback_lanes"] == 0
    dev = tsa.device_timelines(tps.load_events(tsa.discover_traces(d)[0]))[render.GPU_PID]
    clip = [(1754200000 * 1e6, (1754200000 + 0.05) * 1e6)]
    assert tsa.device_clip(dev, clip) == [(t0, t1) for _, t0, t1 in dev["steps"][1:]]
    assert not jsa.analyze_steps(dev["ops"], dev["steps"], clip)  # device midpoints: none in


def test_per_step_op_classes_name_the_loops_steps(frozen):
    events = tps.load_events(tsa.discover_traces(frozen)[0])
    traced = tsa.per_step_op_classes(events)
    assert [t["step"] for t in traced] == ["0", "1", "2", "3", "4"]
    assert traced[1]["classes"] == {"other": 7000.0, "all-reduce": 2500.0, "all-gather": 500.0}


def _spiky(tmp_path):
    """Steps 25, 30, 35; step 30's all-reduce grew 5x (JAX's fixture)."""
    steps, ops = [], []
    for i, step in enumerate((25, 30, 35)):
        t0 = render.BASE_US + 5_000_000 + i * 100_000
        steps.append((str(step), t0, t0 + 90_000))
        ops += [("fusion.1", t0, t0 + 30_000),
                ("all-reduce.2", t0 + 30_000, t0 + 30_000 + (50_000 if step == 30 else 10_000))]
    render.write_trace(str(tmp_path / "host_1.1.pt.trace.json"), render.render(steps, ops))
    return str(tmp_path)


def test_anomaly_trace_join_names_grown_class(tmp_path):
    prof = _spiky(tmp_path)
    tl = ttrep.build_timeline([
        {"event": "run_meta", "ts": 0.0, "rel": 0.0, "arm": "x"},
        {"event": "step_window", "ts": 5.0, "rel": 5.0, "step": 30, "steps_in_window": 5,
         "loss": 5.0, "window_mean_step_time_sec": 0.7, "phase": "timed"},
        {"event": "anomaly", "kind": "step_time_spike", "ts": 5.0, "rel": 5.0, "step": 30,
         "detail": "spike"},
        {"event": "anomaly", "kind": "step_time_spike", "ts": 5.0, "rel": 5.0, "step": 999,
         "detail": "spike"},
    ])
    text = ttrep.join_anomaly_trace(tl, prof)
    assert "spike at step 30: 'all-reduce' grew 5.0x" in text
    assert "10.00 ms -> 50.00 ms" in text
    assert "spike at step 999: outside the traced window" in text
    assert ttrep.join_anomaly_trace(ttrep.build_timeline([]), prof) is None


def test_telemetry_report_cli_joins_the_profile(frozen, capsys):
    tel = os.path.join(frozen, "telemetry_anatomy_frozen.jsonl")
    assert ttrep.main(["--telemetry", tel, "--profile-dir", frozen]) == 0
    out = capsys.readouterr().out
    assert "== Profiler join ==" in out
    assert "device steps traced: 5, median 0.0100s" in out
    assert "telemetry windows:   0 (no step window to compare)" in out
    assert ttrep.main(["--telemetry", tel, "--profile-dir", frozen, "--run", "nope"]) == 1
    assert "ERROR: --run 'nope' matches 0" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Row plumbing
# ---------------------------------------------------------------------------


def _results(mod, **over):
    kw = dict(strategy="zero2", world_size=1, seq_len=128, tier="S", steps=10,
              per_device_batch=2, grad_accum=1, step_times=[0.1] * 8, losses=[5.0] * 8)
    kw.update(over)
    if mod is tmetrics:
        return mod.compute_result(peak_gb=0.0, peak_method="unavailable", **kw)
    return mod.compute_result(rank=0, **kw)


def test_compute_result_maps_anatomy_fields_as_jax():
    port = _results(tmetrics, step_anatomy=dict(FROZEN_FIELDS)).to_dict()
    jax = _results(jmetrics, step_anatomy=dict(FROZEN_FIELDS)).to_dict()
    for k in FROZEN_FIELDS:
        assert port[k] == jax[k] == FROZEN_FIELDS[k], k
    assert list(tmetrics.STEP_ANATOMY_FIELDS) == list(FROZEN_FIELDS)
    none = _results(tmetrics).to_dict()
    assert all(none[k] is None for k in FROZEN_FIELDS)
    with pytest.raises(ValueError, match="unknown step_anatomy keys"):
        _results(tmetrics, step_anatomy={"bogus_frac": 0.1})


def test_validator_accepts_good_anatomy_and_flags_broken():
    good = _results(tmetrics, step_anatomy=dict(FROZEN_FIELDS)).to_dict()
    assert not [f for f in tvalid.validate_result(good, "good") if "anatomy" in f]
    bad = dict(good, anatomy_compute_frac=0.9, comms_exposed_frac=0.5)
    assert any("step-anatomy components sum" in f for f in tvalid.validate_result(bad, "bad"))


def test_cost_json_round_trip_and_model_cost(tmp_path):
    cost = tsa.cost_from_model(3.0e9, 8192, device_kind=render.H100, world_size=2)
    assert cost == {"flops": 3.0e9 * 8192, "bytes_accessed": 0.0, "device_kind": render.H100,
                    "world_size": 2, "scope": "model_flops"}
    assert tsa.cost_from_model(0.0, 8192) is None
    path = tsa.write_cost_json(str(tmp_path), cost)
    assert os.path.basename(path) == tsa.COST_JSON_FILENAME == jsa.COST_JSON_FILENAME
    assert tsa.load_cost_json(path) == cost


def test_loop_trace_helpers_name_steps_by_the_loops_numbers(tmp_path):
    prof = tloop._start_trace(torch.device("cpu"), 5)
    for step in (6, 7, 6, 7):  # a rollback rewinds the loop to step 6
        torch.ones(4).sum()
        tloop._trace_step(prof, step)
    info = tloop._stop_trace(prof, str(tmp_path))
    assert info["bytes"] == os.path.getsize(info["path"]) > 0
    assert info["path"].endswith(".pt.trace.json")
    steps = tps.host_steps(tps.load_events(info["path"]))
    assert [n for n, _, _ in steps] == [5, 6, 7, 6, 7]
    assert tps.list_profile_runs(str(tmp_path)) == [(tps.run_name(info["path"]), info["path"])]
